"""Count-aggregated sharded engine: Lemma 1 applied to the engine's own wire.

The walk-routing engine (`distributed.py`) routes every cross-shard walk
as its own int32 position. Walks are anonymous (Lemma 1): only counts per
edge matter. This engine keeps per-vertex coupon counts as shard state and
exchanges (dst_vertex, count) pairs, so the all_to_all payload is bounded
by the cut edges that carry traffic this round, independent of how many
walks run.

Lane capacity per (src, dst) shard pair is fixed at shard time: the most
edges that cross any shard pair, capped at n_loc. An entry that does not
fit is counted in `overflow`, which must stay 0.

Per superstep, per shard:
  1. terminations ~ Binomial(counts, eps)                (paper lines 4-5)
  2. survivors split over out-edges by the conditional-binomial chain
     (the degree-bucketed sampler of `core/aggregate_sampler`, one launch
     of the `multinomial_rows` kernel's fused entry on the card)
  3. per-edge counts summed per destination vertex and exchanged with one
     all_to_all of (vertex, count) lanes                  (Lemma-1 wire)
  4. arrivals summed into counts and into the visit counters zeta
Every sum of counts by vertex runs through `segment_spmv`'s exact integer
entry.

Draws are a counter-based function of (round key, global padded vertex id,
slot), and the round key is the same on every shard, so the trajectory
does not depend on the shard count: the result equals the single-device
count engine's for the same key, and a snapshot resumes bit-exactly at any
shard count.

Packed lanes (`packed=True`) put a vertex's local id in 16 bits and its
count in 15, with counts above 32767 spilling into a second entry. Past
those limits the JAX package's lanes lose counts silently; here a run
raises instead, naming `packed=False` (8-byte (vertex, count) lanes with
no limit): at shard time when n_loc > 65536, and in any round whose
remote count for one vertex exceeds 2 * 32767.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import prng
from repro_torch.checkpoint import LayoutSpec
from repro_torch.core.aggregate_sampler import (BucketLayout,
                                                build_layout_sharded,
                                                bucketize_adjacency,
                                                stack_shard_perm)
from repro_torch.core.collectives import StackedMesh, in_program
from repro_torch.core.estimator import pagerank_from_visits
from repro_torch.core.graph import CSRGraph
from repro_torch.core.routing import (_offset_ids, entry_nbytes,
                                      exchange_stacked, lane_slots,
                                      pack_lanes)
from repro_torch.kernels.multinomial_rows import multinomial_buckets
from repro_torch.kernels.multinomial_rows._math import key_words
from repro_torch.kernels.segment_spmv import hot_list, segment_sum_int
from repro_torch.runtime import Stage, StagedState, StageSchedule, run_staged

_I32 = torch.int32
CMAX = 32767              # largest count of one packed lane entry
PACKED_VID_MAX = 1 << 16  # local vertex ids a packed lane entry can hold


@dataclasses.dataclass(frozen=True)
class ShardedPaddedGraph:
    """Per-shard padded adjacency with static cross-shard lane bounds and
    the degree-bucketed sampler layout."""

    n: int
    n_pad: int
    n_loc: int
    shards: int
    max_deg: int
    deg: torch.Tensor       # [S, n_loc] (S: the shards held here)
    lane_cap: int           # max distinct vertices over any shard pair
    layout: BucketLayout    # shard-uniform bucket caps and widths
    bperm: torch.Tensor     # [S, layout.total_rows] local rows, -1 = pad
    bnbr: torch.Tensor      # [S, layout.total_edges] flat bucketed dst
    stacked_layout: BucketLayout  # one sampler call for the S shards
    stacked_perm: torch.Tensor    # [sum(stacked caps)] rows of [S*n_loc]


def _lane_cap(src: np.ndarray, col: np.ndarray, n_loc: int,
              shards: int) -> int:
    """The static lane bound: the edges from shard p to shard q, at most
    n_loc distinct vertices."""
    cut = np.bincount((src // n_loc) * shards + col // n_loc,
                      minlength=shards * shards)
    return int(min(cut.max(initial=0), n_loc)) or 1


def shard_graph_padded(graph: CSRGraph, shards: int, *,
                       bucketed: bool = True, device=None,
                       mesh=None) -> ShardedPaddedGraph:
    """Shard `graph` for the count engine, on `device` (the graph's when
    None). With `mesh`, only the mesh's local shards are placed, on its
    device; the layout's caps stay the most over all shards."""
    n_loc = math.ceil(graph.n / shards)
    n_pad = n_loc * shards
    md = max(graph.max_out_deg, 1)
    rp, col, degs = graph.numpy()
    src = np.repeat(np.arange(graph.n), degs)
    slot = np.arange(len(src)) - rp[src]
    nbr = np.zeros((n_pad, md), np.int32)     # padding slots carry 0 counts
    nbr[src, slot] = col
    deg_pad = np.concatenate([degs, np.zeros(n_pad - graph.n, np.int32)])
    lane_cap = _lane_cap(src, col, n_loc, shards)
    deg_sh = deg_pad.reshape(shards, n_loc)
    nbr_sh = nbr.reshape(shards, n_loc, md)
    layout, bperm = build_layout_sharded(deg_sh, md, bucketed=bucketed)
    device = graph.device if device is None else device
    if mesh is not None:
        device = mesh.device
        deg_sh, nbr_sh, bperm = (mesh.local_rows(a)
                                 for a in (deg_sh, nbr_sh, bperm))
    bnbr = bucketize_adjacency(nbr_sh, bperm, layout)
    stacked_layout, stacked_perm = stack_shard_perm(bperm, layout)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return ShardedPaddedGraph(
        n=graph.n, n_pad=n_pad, n_loc=n_loc, shards=shards, max_deg=md,
        deg=dev(deg_sh), lane_cap=lane_cap, layout=layout, bperm=dev(bperm),
        bnbr=dev(bnbr), stacked_layout=stacked_layout,
        stacked_perm=dev(stacked_perm))


@in_program("counts", "sample")
def _sample_step(sg: ShardedPaddedGraph, counts: torch.Tensor,
                 key: torch.Tensor, *, eps: float, mesh: StackedMesh):
    """First half of the superstep: the degree-bucketed aggregate draw.

    Returns (flat_T [S, total_edges] per-edge counts aligned with
    `sg.bnbr`, the advanced [S, 2] keys, per-bucket occupancy summed over
    shards, the conservation residual, which must be 0)."""
    # compared across every shard, so that all processes raise together
    rows = key.to(torch.int64).to(counts.device)
    if not bool((mesh.pmax(rows) == -mesh.pmax(-rows)).all()):
        raise ValueError("the count engine's round key must be the same on "
                         "every shard")
    # the key is replicated: one split serves every shard
    k_next, k_sample = prng.split(key[0])
    n_loc, S = sg.n_loc, counts.shape[0]
    # draws are keyed by the global row id
    rid = (mesh.shard_ids().reshape(-1, 1) * n_loc
           + torch.arange(n_loc, dtype=_I32, device=counts.device)
           ).reshape(-1)
    lay = sg.stacked_layout
    flat_T, occ, residual = multinomial_buckets(
        counts.reshape(-1), sg.deg.reshape(-1), rid, key_words(k_sample),
        sg.stacked_perm, lay.widths, lay.caps, eps=eps, shards=S)
    return (flat_T.reshape(S, -1), k_next.repeat(S, 1),
            mesh.psum(occ[None]), mesh.psum(residual[None]))


def _segment_sum(values: torch.Tensor, ids: torch.Tensor, num_segments: int,
                 hot=None) -> torch.Tensor:
    """[S, num_segments] int32 sums of each shard's values by segment, at
    the ids of `routing._offset_ids` (-1 dropped); `hot` is their hot list,
    built here when None."""
    S = values.shape[0]
    return segment_sum_int(values.reshape(-1), ids.reshape(-1),
                           S * num_segments, hot=hot).reshape(S, num_segments)


@dataclasses.dataclass(frozen=True)
class SumPlan:
    """The segment ids of the two sums of each round's per-edge counts,
    which stay the same every round, with their hot lists: local
    destinations (slots that leave the shard dropped), and global
    destination vertices (slots that stay dropped)."""

    local_ids: torch.Tensor
    local_hot: Optional[torch.Tensor]
    remote_ids: torch.Tensor
    remote_hot: Optional[torch.Tensor]


def sum_plan(sg: ShardedPaddedGraph, mesh: StackedMesh) -> SumPlan:
    n_loc, S = sg.n_loc, sg.bnbr.shape[0]
    sid = mesh.shard_ids().reshape(-1, 1)
    local = torch.div(sg.bnbr, n_loc, rounding_mode="floor") == sid
    local_ids = _offset_ids(sg.bnbr - sid * n_loc, local, n_loc)
    remote_ids = _offset_ids(sg.bnbr, ~local, sg.n_pad)
    return SumPlan(local_ids=local_ids,
                   local_hot=hot_list(local_ids, S * n_loc),
                   remote_ids=remote_ids,
                   remote_hot=hot_list(remote_ids, S * sg.n_pad))


@in_program("counts", "exchange")
def _exchange_step(sg: ShardedPaddedGraph, plan: SumPlan,
                   flat_T: torch.Tensor, zeta: torch.Tensor, *,
                   mesh: StackedMesh, packed: bool):
    """Second half of the superstep: sum counts per destination vertex and
    run the Lemma-1 (vertex, count) lane exchange.

    Returns (new_counts, new_zeta, active, a2a_entries, a2a_bytes,
    overflow), the last four summed over shards."""
    n_loc, shards, lane_cap = sg.n_loc, mesh.shards, sg.lane_cap
    sid = mesh.shard_ids().reshape(-1, 1)
    S = flat_T.shape[0]
    # local arrivals: a direct segment sum
    arrive = _segment_sum(flat_T, plan.local_ids, n_loc, plan.local_hot)

    # cross-shard: counts per destination vertex first, so the lane bound is
    # the number of distinct vertices, not edges
    per_vertex = _segment_sum(flat_T, plan.remote_ids, sg.n_pad,
                              plan.remote_hot)
    vid = torch.arange(sg.n_pad, dtype=_I32, device=flat_T.device)
    if packed and shards > 1:
        # the most over every shard, so that all processes raise together
        most = int(mesh.pmax(per_vertex.amax(dim=1)))
        if most > 2 * CMAX:
            raise RuntimeError(
                f"a vertex receives {most} remote counts this round, more "
                f"than the packed lanes carry (2 x {CMAX}); pass "
                f"packed=False")
    if packed:
        # 4-B lanes: (local vid: 16 b | count: 15 b); the 15-bit count keeps
        # the packed int32 non-negative (-1 stays the empty sentinel), and
        # a larger count spills into a second entry for the same vertex
        spill = torch.clamp(per_vertex - CMAX, min=0)
        vid2 = torch.cat([vid, vid]).expand(S, -1)
        cnt2 = torch.cat([torch.clamp(per_vertex, max=CMAX),
                          torch.clamp(spill, max=CMAX)], dim=1)
    else:
        vid2 = vid.expand(S, -1)
        cnt2 = per_vertex
    has = cnt2 > 0
    v_owner = torch.div(vid2, n_loc, rounding_mode="floor")
    ok, lane_idx = lane_slots(v_owner, has, shards, lane_cap)
    overflow = mesh.psum(torch.where(has & ~ok, cnt2, 0).sum(dim=1))
    if packed:
        payload = (vid2 % n_loc) | (cnt2 << 16)
        lanes = pack_lanes(lane_idx, payload, ok, shards, lane_cap)
        recv = mesh.all_to_all(lanes)
        arrive = arrive + _segment_sum(
            recv >> 16, _offset_ids(recv & 0xFFFF, recv >= 0, n_loc), n_loc)
        wire_entries = (lanes >= 0).sum(dim=1)
        bytes_per = entry_nbytes(lanes)
    else:
        lanes_v = pack_lanes(lane_idx, vid2, ok, shards, lane_cap)
        lanes_c = pack_lanes(lane_idx, cnt2, ok, shards, lane_cap, fill=0)
        # one 8-B (vertex, count) entry a slot, as the audit spec declares;
        # the kernels take the received columns contiguous
        recv_v, recv_c = (r.contiguous() for r in
                          exchange_stacked([lanes_v, lanes_c], mesh))
        arrive = arrive + _segment_sum(
            recv_c, _offset_ids(recv_v - sid * n_loc, recv_v >= 0, n_loc),
            n_loc)
        wire_entries = (lanes_v >= 0).sum(dim=1)
        bytes_per = entry_nbytes(lanes_v, lanes_c)
    active = mesh.psum(arrive.sum(dim=1))
    a2a_entries = mesh.psum(wire_entries)
    return (arrive, zeta + arrive, active, a2a_entries,
            a2a_entries * bytes_per, overflow)


def count_layouts(n: int):
    """Elastic layout schema of the count engine's single stage."""
    return dict(counts=LayoutSpec(kind="vertex", n=n),
                zeta=LayoutSpec(kind="vertex", n=n),
                key=LayoutSpec(kind="replicated_key"),
                round=LayoutSpec(kind="replicated"))


@dataclasses.dataclass
class CountDistResult:
    zeta: torch.Tensor
    pi: np.ndarray
    rounds: int
    a2a_bytes_total: int
    overflow: int
    shards: int
    lane_cap: int
    a2a_entries_total: int = 0   # routed (vertex, count) lane entries
    restarts: int = 0            # supervisor recoveries
    checkpoints_written: int = 0
    sampler_us: float = 0.0      # host wall time inside the sample half
    occupancy: tuple = ()        # per-bucket rows holding coupons, summed
                                 # over rounds and shards
    residual: int = 0            # conservation leak: must stay 0


def distributed_pagerank_counts(graph: CSRGraph, eps: float,
                                walks_per_node: int, key: torch.Tensor, *,
                                mesh: Optional[StackedMesh] = None,
                                packed: bool = True,
                                max_rounds: int = 100_000,
                                checkpoint_dir: Optional[str] = None,
                                fail_at: Optional[Sequence[int]] = None,
                                checkpoint_every: int = 10,
                                max_restarts: int = 16,
                                resume: bool = False,
                                bucketed: bool = True,
                                device=None) -> CountDistResult:
    """Count-aggregated Algorithm 1 across the shards of `mesh` (one shard
    on `device`, the card when None, if no mesh is given).

    With `checkpoint_dir` or `fail_at`, the superstep loop runs under the
    checkpoint-restart supervisor: recovery from an injected failure
    replays the identical trajectory. `resume=True` continues from the
    latest snapshot in `checkpoint_dir`, written by this package or the
    JAX package, at this mesh's shard count or another (bit-exact either
    way)."""
    mesh = mesh or StackedMesh(1, device)
    shards, dev = mesh.shards, mesh.device
    sg = shard_graph_padded(graph, shards, bucketed=bucketed, mesh=mesh)
    if packed and shards > 1 and sg.n_loc > PACKED_VID_MAX:
        raise ValueError(
            f"n_loc = {sg.n_loc} vertices per shard exceeds the "
            f"{PACKED_VID_MAX} local ids of a packed lane entry; pass "
            f"packed=False")

    counts0 = np.zeros(shards * sg.n_loc, np.int32)
    counts0[: graph.n] = walks_per_node
    counts0 = torch.from_numpy(mesh.local_rows(
        counts0.reshape(shards, sg.n_loc)).copy()).to(dev)
    # the same round key on every shard: the trajectory depends on the
    # seed and the graph only, not on the shard count
    keys = key.reshape(1, 2).repeat(counts0.shape[0], 1)
    plan = sum_plan(sg, mesh)

    def _step(ms: StagedState):
        a = ms.arrays
        t0 = time.perf_counter()
        flat_T, key2, occ, residual = _sample_step(sg, a["counts"], a["key"],
                                                   eps=float(eps), mesh=mesh)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        counts, zeta, active, entries, nbytes, ovf = _exchange_step(
            sg, plan, flat_T, a["zeta"], mesh=mesh, packed=packed)
        a.update(counts=counts, zeta=zeta, key=key2,
                 round=a["round"] + 1)
        h = ms.host
        active_i, entries_i, bytes_i, ovf_i, res_i = (int(x) for x in (
            torch.stack([active, entries, nbytes, ovf,
                         residual.to(active.dtype)]).tolist()))
        h["rounds"] += 1
        h["a2a"] += bytes_i
        h["a2a_entries"] += entries_i
        h["overflow"] += ovf_i
        h["sampler_us"] += (t1 - t0) * 1e6
        h["occupancy"] = [x + y for x, y in zip(h["occupancy"],
                                                occ.tolist())]
        h["residual"] += res_i
        return ms, active_i == 0 or h["rounds"] >= max_rounds

    schedule = StageSchedule([Stage("counts", _step)])
    ms = StagedState(
        stage=schedule.first_stage,
        arrays=dict(counts=counts0, zeta=counts0.clone(), key=keys,
                    round=torch.zeros((), dtype=_I32)),
        host=dict(rounds=0, a2a=0, a2a_entries=0, overflow=0, sampler_us=0.0,
                  occupancy=[0] * len(sg.layout.caps), residual=0),
        layouts={"counts": count_layouts(graph.n)},
        shards=shards)

    def _put(name, arr):
        if name == "round":
            return torch.from_numpy(np.array(arr))
        t = torch.from_numpy(np.array(mesh.local_rows(arr)))
        return t if name == "key" else t.to(dev)

    ms, restarts, checkpoints_written = run_staged(
        schedule, ms, _put, checkpoint_dir=checkpoint_dir, fail_at=fail_at,
        checkpoint_every=checkpoint_every, max_restarts=max_restarts,
        resume=resume, max_rounds=max_rounds + 1,
        tmp_prefix="prcnt_ckpt_", mesh=mesh)

    zeta = mesh.gather_rows(ms.arrays["zeta"]).reshape(-1)[: graph.n]
    pi = pagerank_from_visits(zeta, graph.n, walks_per_node, eps)
    h = ms.host
    return CountDistResult(zeta=zeta, pi=pi, rounds=h["rounds"],
                           a2a_bytes_total=h["a2a"], overflow=h["overflow"],
                           shards=shards, lane_cap=sg.lane_cap,
                           a2a_entries_total=h["a2a_entries"],
                           restarts=restarts,
                           checkpoints_written=checkpoints_written,
                           sampler_us=float(h["sampler_us"]),
                           occupancy=tuple(h["occupancy"]),
                           residual=int(h["residual"]))


def audit_spec(graph: CSRGraph, mesh: StackedMesh, *, eps: float = 0.2,
               walks_per_node: int = 2, packed: bool = True):
    """CONGEST-auditor spec: the two programs of the engine's superstep,
    the declared wire budget of the single (vertex, count) all_to_all
    (4-B packed entries, or 8-B (vertex, count) pairs), and the elastic
    schema. `eps` shapes no lane."""
    from repro_torch.core.accounting import (EngineAuditSpec, ExchangeSite,
                                             StageProgram)
    shards = mesh.shards
    n_loc = math.ceil(graph.n / shards)
    _, col, degs = graph.numpy()
    lane_cap = _lane_cap(np.repeat(np.arange(graph.n), degs), col, n_loc,
                         shards)
    width = 4 if packed else 8
    site = ExchangeSite(
        site="counts", entry_nbytes=width,
        lane_entries=shards * lane_cap,
        budget_entries=shards * n_loc,
        budget_formula=("P * min(cut_max, n_loc) distinct (vertex, count) "
                        "cells <= P * n_loc"),
        wire_class="count",
        note="Lemma 1: lane bound counts distinct destination vertices, "
             "never walk multiplicity W")
    progs = [
        StageProgram(stage="counts", program="sample", sites=(),
                     count_bound=graph.n * walks_per_node),
        StageProgram(stage="counts", program="exchange", sites=(site,),
                     count_bound=graph.n * walks_per_node),
    ]
    return EngineAuditSpec(
        engine="counts", programs=progs,
        stage_arrays={"counts": ("counts", "zeta", "key", "round")},
        layouts={"counts": count_layouts(graph.n)},
        meta=dict(shards=shards, n=graph.n, lane_cap=lane_cap,
                  packed=packed, walks_per_node=walks_per_node))
