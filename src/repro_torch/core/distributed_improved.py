"""Sharded IMPROVED-PAGERANK engine: Algorithm 2 on the vertex-partitioned
graph, with every exchange count-aggregated (Lemma 1).

Vertices are split into contiguous shards; every per-shard tensor carries
a leading dimension of the shards the process holds (`core/collectives.py`:
all P on a `StackedMesh`, its own on a `ProcessGroupMesh`) and every
exchange is a fixed-capacity all_to_all built from the lane machinery of
`routing.py`. Every count that steers the phase machine (pending coupons,
active walks, the tail placement check) is a sum or a read over all
shards, so every process takes the same branch.
Walks are anonymous, so what moves between shards travels as (vertex,
count) pairs: the wire volume is bounded by the distinct (vertex, outcome)
pairs, not by how many walks move.

Phase 1 — short walks. Shard p owns the coupons of its vertices: vertex v
  gets pool_size(v) of them (`improved_pagerank.coupon_pool_sizes`), each a
  PageRank walk given lambda step opportunities. Coupons never migrate;
  slot s of shard p's pool table is its identity. A round is one
  count-aggregated round trip:
    request — each home shard counts its live coupons by current vertex
      and ships the counts to the owners (`route_counts(by_source=True)`);
    sample  — each owner draws, for every (home, vertex) row, a
      Binomial(c, eps) termination count (a dangling vertex terminates the
      whole row) and the conditional-binomial split of the survivors over
      the out-edges: one launch of `multinomial_rows`' fused entry in its
      dense-cell mode over the degree-bucketed rows of every owner, each
      owner under its own round key. The draws are counter-based on (key
      words, rid = owner * n_pad + home * n_loc + v, slot);
    reply   — the nonzero (vertex, class, count) cells go back to the home
      shard (class 0 = terminated, class 1 + j = moved along out-edge j);
    assign  — the home deals the returned outcomes out to its coupons at v
      by a uniform random permutation (random priorities, stable rank
      within the vertex). A multiset of iid outcomes dealt in uniform
      random order is an iid draw per coupon.
  Each coupon's move is recorded in the home's trajectory table
  traj[slot, t], which Phase 3 counts.

Phase 2 — stitching. The n*K long walks are per-vertex counts. Each
  superstep gives the walks at every owned vertex the next
  min(walks, pool left) unused coupons of its pool, retires the walks
  whose coupon ended in an eps-reset, and routes the rest as
  per-destination counts; walks at an exhausted pool go to a per-vertex
  tail count.

Phase 3 — counting. One histogram of the used coupons' trajectories and
  ONE `route_counts` exchange deliver every visit to its owner. The tail
  walks then finish naively through the Algorithm-1 superstep
  (`distributed.superstep`, which launches `walk_step`).

Every count of ids runs through the `histogram` kernel and every sum of
counts by vertex through `segment_spmv`, on the card.

Keys wider than the JAX package's: the outcome interval keys
vertex * (S_loc_pad + 1) + rank and the coupon queries are int64 here, so
the engine runs where the JAX package's int32 keys would overflow (it
refuses (n_pad + 1) * (S_loc_pad + 1) >= 2**31). Below that limit both
give the same result bit for bit. Slot ids stay int32.

Fault tolerance: the engine is a checkpointable phase machine (phase1,
phase2, phase3, tail), each a `runtime.Stage` whose snapshot holds the
stage's buffers and the host telemetry, in the JAX package's format, so a
JAX snapshot resumes here. Recovery is bit-exact. Every stage declares its
`checkpoint.LayoutSpec` schema, so a resume at another shard count
re-homes coupon slots, vertex shards and walk lanes: Phases 2 and 3 resume
bit-exactly, Phase 1 and the tail with re-derived keys (statistically).
"""
from __future__ import annotations

import dataclasses
import math
import time
from functools import partial
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import prng
from repro_torch.checkpoint import LayoutSpec
from repro_torch.core.accounting import (CongestReport, RoundTrace,
                                         default_bandwidth)
from repro_torch.core.aggregate_sampler import (BucketLayout,
                                                build_layout_sharded,
                                                stack_shard_perm)
from repro_torch.core.collectives import StackedMesh, in_program
from repro_torch.core.distributed import (DistState, ShardedGraph,
                                          shard_graph, superstep)
from repro_torch.core.estimator import pagerank_from_visits
from repro_torch.core.graph import CSRGraph
from repro_torch.core.improved_pagerank import coupon_pool_sizes, run_starts
from repro_torch.core.routing import (_rows, entry_nbytes,
                                      exchange_stacked, lane_slots,
                                      pack_lanes, route_counts,
                                      vertex_histogram)
from repro_torch.core.simple_pagerank import walks_per_node_for
from repro_torch.kernels.multinomial_rows import multinomial_buckets
from repro_torch.runtime import Stage, StagedState, StageSchedule, run_staged

_I32 = torch.int32
# sorts past the keys of real outcome intervals
_KEY_END = 2 ** 62


# ---------------------------------------------------------------------------
# Phase 1: count-aggregated short walks
# ---------------------------------------------------------------------------

@in_program("phase1", "request")
def _p1_request(pos, alive, *, mesh: StackedMesh, n_loc: int,
                count_bound: Optional[int] = None):
    """Per-vertex live-coupon counts to the owners. Returns (c [S, P*n_loc]
    with c[:, home * n_loc + v] the coupons of `home` at owned vertex v,
    entries, bytes), the last two summed over shards."""
    n_pad = mesh.shards * n_loc
    req = vertex_histogram(pos, alive > 0, n_pad)
    c_by_home, entries, nbytes = route_counts(
        req, mesh=mesh, n_loc=n_loc, by_source=True, count_bound=count_bound)
    return (c_by_home.reshape(pos.shape[0], -1), mesh.psum(entries),
            mesh.psum(nbytes))


def _phase1_rows(bperm: np.ndarray, layout: BucketLayout, shards: int,
                 n_loc: int):
    """The Phase-1 sampler's rows: each owner's bucket permutation (the
    rows of `bperm` [S owners, ...]) tiled over the P homes (bucket b
    holds every home's bucket-b rows, offset by home * n_loc, -1 padding
    kept: `layout.tile(P)`), then stacked over the owners for one launch
    (`stack_shard_perm`), as row ids of the flat [S owners * P homes *
    n_loc] rows. Returns (stacked layout, perm)."""
    offs = (np.arange(shards, dtype=np.int64) * n_loc)[None, :, None]
    parts = []
    for start, cap in zip(layout.row_starts, layout.caps):
        pb = bperm[:, None, start:start + cap].astype(np.int64)
        parts.append(np.where(pb < 0, -1, offs + pb).reshape(
            bperm.shape[0], -1))
    perm_t = np.concatenate(parts, axis=1).astype(np.int32)
    return stack_shard_perm(perm_t, layout.tile(shards))


@in_program("phase1", "sample")
def _p1_sample(rows_perm: torch.Tensor, rows_layout: BucketLayout,
               dg: torch.Tensor, c: torch.Tensor, key: torch.Tensor, *,
               eps: float, mesh: StackedMesh, md: int):
    """The owners' draws for every (home, vertex) row: one launch of the
    fused sampler in its dense-cell mode over the local owners, each under
    the sample key of `split(key[p], 3)`. Returns (f_cnt [S,
    P*n_loc*(md+1)], the advanced keys, the assignment keys, per-bucket
    occupancy and the conservation residual, both summed over shards)."""
    shards = mesh.shards
    keys = torch.stack([prng.split(k, 3) for k in key])      # [S, 3, 2]
    S, n_rows = c.shape
    deg_row = dg.repeat(1, shards).reshape(-1)
    # draws are keyed by the global row id, owner * n_pad + home * n_loc + v
    rid = (mesh.shard_ids().reshape(-1, 1) * n_rows
           + torch.arange(n_rows, dtype=_I32, device=c.device)).reshape(-1)
    f_cnt, occ, residual = multinomial_buckets(
        c.reshape(-1), deg_row, rid, keys[:, 1], rows_perm,
        rows_layout.widths, rows_layout.caps, eps=eps, shards=S, cells=md)
    return (f_cnt.reshape(S, -1), keys[:, 0].clone(), keys[:, 2].clone(),
            mesh.psum(occ[None]), mesh.psum(residual[None]))


def _assign_home(e_vid, e_dst, e_cnt, pos, alive, u, *, n_pad: int, C: int):
    """One home shard's assignment: the received outcome cells as
    intervals of ranks within each vertex (key v * C + first rank), the
    coupons ranked within their vertex by the random priorities `u`, each
    coupon taking the outcome whose interval holds its rank. Returns
    (new_pos, new_alive, the trajectory column: the destination, or -1)."""
    dev = pos.device
    evid = torch.where((e_cnt > 0) & (e_vid >= 0), e_vid, n_pad)
    evid_s, order = torch.sort(evid, stable=True)
    cnt_s = e_cnt.index_select(0, order).to(torch.int64)
    dst_s = e_dst.index_select(0, order)
    s = torch.cumsum(cnt_s, 0) - cnt_s      # exclusive running count
    is_start = torch.ones_like(evid_s, dtype=torch.bool)
    is_start[1:] = evid_s[1:] != evid_s[:-1]
    # s never decreases, so the running maximum of the runs' first values
    # is the first value of each element's own run
    sw = s - s.index_select(0, run_starts(is_start))
    keys_s = torch.where(evid_s < n_pad, evid_s.to(torch.int64) * C + sw,
                         _KEY_END)
    del evid, order, cnt_s, s, is_start, sw

    # a uniform random permutation of the coupons within each vertex: by
    # vertex, then by priority u (u >= 0, so its bits order as it does)
    elig = alive > 0
    gkey = torch.where(elig, pos, n_pad).to(torch.int64)
    gs, ord2 = torch.sort((gkey << 32) | u.view(_I32).to(torch.int64),
                          stable=True)
    gs = gs >> 32
    is_st2 = torch.ones_like(gs, dtype=torch.bool)
    is_st2[1:] = gs[1:] != gs[:-1]
    idx2 = torch.arange(gs.numel(), device=dev)
    rank = torch.empty_like(gs)
    rank[ord2] = idx2 - run_starts(is_st2)
    del gs, ord2, is_st2, idx2, gkey
    q = torch.where(elig, pos.to(torch.int64) * C + rank, 0)
    del rank
    loc = torch.clamp(torch.searchsorted(keys_s, q, right=True) - 1, 0,
                      keys_s.numel() - 1)
    del q
    out = dst_s.index_select(0, loc.reshape(-1))  # -2 reset, >= 0 a vertex
    survive = elig & (out >= 0)
    return (torch.where(survive, out, pos), survive.to(_I32),
            torch.where(survive, out, -1))


@in_program("phase1", "assign")
def _p1_assign(rp, ci, pos, alive, traj, f_cnt, k_perm, t: int, *,
               mesh: StackedMesh, n_loc: int, md: int, rep_cap: int,
               S_loc_pad: int):
    """Reply and assign: route the nonzero outcome cells back to the homes
    and deal them out to the coupons (see the module docstring). Writes
    column t of `traj` in place. Returns (new_pos, new_alive, [pending,
    overflow, reply entries, reply bytes]), the last summed over shards in
    one psum. The exchange runs over the leading shard dimension; each
    home's assignment, which involves no other shard, one home at a time,
    which bounds the sorts' memory to one shard's coupons."""
    shards = mesh.shards
    S = pos.shape[0]
    dev = pos.device
    sid = mesh.shard_ids()
    n_pad = shards * n_loc
    C = S_loc_pad + 1
    cells = n_loc * (md + 1)

    eidx = torch.clamp(rp[:, :n_loc, None] + torch.arange(md, device=dev),
                       0, ci.shape[1] - 1)
    edge_dst = torch.gather(ci, 1, eidx.reshape(S, -1)).reshape(S, n_loc, md)
    dst = torch.cat([torch.full((S, shards, n_loc, 1), -2, dtype=_I32,
                                device=dev),
                     edge_dst[:, None].expand(S, shards, n_loc, md)], dim=3)
    f_dst = dst.reshape(S, shards * cells)
    vid = (_rows(sid) * n_loc + torch.arange(n_loc, dtype=_I32, device=dev)
           ).repeat(1, shards)
    f_vid = vid.repeat_interleave(md + 1, dim=1)
    del eidx, edge_dst, dst, vid

    # ---- reply: the nonzero (vertex, class, count) cells to the home ----
    home = torch.div(torch.arange(shards * cells, dtype=_I32, device=dev),
                     cells, rounding_mode="floor").expand(S, -1)
    remote = (f_cnt > 0) & (home != _rows(sid))
    sendable, flat_idx = lane_slots(home, remote, shards, rep_cap)
    l_vid = pack_lanes(flat_idx, f_vid, sendable, shards, rep_cap, fill=-1)
    l_dst = pack_lanes(flat_idx, f_dst, sendable, shards, rep_cap, fill=0)
    l_cnt = pack_lanes(flat_idx, f_cnt, sendable, shards, rep_cap, fill=0)
    r_vid, r_dst, r_cnt = exchange_stacked([l_vid, l_dst, l_cnt], mesh)
    # rep_cap = min(n_loc*(md+1), S_loc_pad) bounds the distinct cells one
    # home can receive, so this stays 0
    overflow = (remote & ~sendable).sum(dim=1)
    rep_entries = (l_vid >= 0).sum(dim=1)
    rep_bytes = rep_entries * entry_nbytes(l_vid, l_dst, l_cnt)
    del home, remote, sendable, flat_idx, l_vid, l_dst, l_cnt

    rows = torch.arange(S, device=dev)
    own = sid.long()

    def own_block(x):                        # the own home's cells, no wire
        return x.reshape(S, shards, cells)[rows, own]

    e_vid = torch.cat([own_block(f_vid), r_vid], dim=1)
    e_dst = torch.cat([own_block(f_dst), r_dst], dim=1)
    e_cnt = torch.cat([own_block(f_cnt), torch.where(r_vid >= 0, r_cnt, 0)],
                      dim=1)
    del f_vid, f_dst, r_vid, r_dst, r_cnt

    new_pos = torch.empty_like(pos)
    new_alive = torch.empty_like(alive)
    for r in range(S):
        u = prng.uniform(k_perm[r], (S_loc_pad,), device=dev)
        new_pos[r], new_alive[r], traj[r, :, t] = _assign_home(
            e_vid[r], e_dst[r], e_cnt[r], pos[r], alive[r], u, n_pad=n_pad,
            C=C)
        del u
    stats = mesh.psum(torch.stack(
        [new_alive.sum(dim=1, dtype=torch.int64), overflow.to(torch.int64),
         rep_entries.to(torch.int64), rep_bytes.to(torch.int64)], dim=1))
    return new_pos, new_alive, stats


# ---------------------------------------------------------------------------
# Phase 2: count-aggregated coupon stitching
# ---------------------------------------------------------------------------

@in_program("phase2", "stitch")
def _p2_local(walks, next_c, used, tail_cnt, dest, cterm, psize, pstart,
              slot_v, *, mesh: StackedMesh, n_loc: int, S_loc_pad: int,
              count_bound: Optional[int] = None):
    """One stitch superstep: give the walks waiting at each owned vertex
    the next unused coupons of its pool, retire the walks whose coupon
    ended in an eps-reset, route the rest as per-destination counts, and
    bank the walks at an exhausted pool in `tail_cnt`. Returns the new
    (walks, next_c, used, tail_cnt) and the stats (active, stitched,
    terminated, exhausted, entries, bytes) summed over shards."""
    n_pad = mesh.shards * n_loc
    a = torch.minimum(walks, psize - next_c)        # coupons allocatable now
    exh = walks - a                                 # pool empty: naive tail
    sv = slot_v.long()
    off = (torch.arange(S_loc_pad, dtype=_I32, device=walks.device)
           - torch.gather(pstart, 1, sv))
    nc = torch.gather(next_c, 1, sv)
    alloc = (off >= nc) & (off < nc + torch.gather(a, 1, sv))
    del off, nc, sv
    used = torch.maximum(used, alloc.to(_I32))
    next_c = next_c + a
    term_now = alloc & (cterm > 0)      # the coupon's eps-reset fired
    go = alloc & (cterm == 0)           # the walk continues at its dest
    del alloc
    dcnt = vertex_histogram(dest, go, n_pad)
    arrivals, entries, nbytes = route_counts(
        dcnt, mesh=mesh, n_loc=n_loc, count_bound=count_bound)
    # one psum of the six per-shard counts
    stats = mesh.psum(torch.stack([
        x.sum(dim=1, dtype=torch.int64)
        for x in (arrivals, a, term_now, exh, entries[:, None],
                  nbytes[:, None])], dim=1))
    return arrivals, next_c, used, tail_cnt + exh, stats


# ---------------------------------------------------------------------------
# Phase 3: one aggregated counting round over the trajectory table
# ---------------------------------------------------------------------------

@in_program("phase3", "count")
def _p3_local(traj, used, zeta, *, mesh: StackedMesh, n_loc: int,
              count_bound: Optional[int] = None):
    """Histogram the used coupons' recorded moves and deliver the counts to
    the owners in ONE `route_counts` exchange. Each shard's histogram is
    its own call, which keeps the masked ids to one shard's table."""
    n_pad = mesh.shards * n_loc
    part = []
    for r in range(traj.shape[0]):
        ids = torch.where(used[r, :, None] > 0, traj[r], -1)[None]
        part.append(vertex_histogram(ids, ids >= 0, n_pad))
        del ids
    part = torch.cat(part)
    arrivals, entries, nbytes = route_counts(
        part, mesh=mesh, n_loc=n_loc, count_bound=count_bound)
    return zeta + arrivals, mesh.psum(entries), mesh.psum(nbytes)


def _shard_sums(x: torch.Tensor, mesh) -> torch.Tensor:
    """[P] int64 sum of each shard's rows of a per-shard x [S, ...], read
    between rounds (`gather_rows`), the same on every process."""
    return mesh.gather_rows(x.reshape(x.shape[0], -1).sum(
        dim=1, keepdim=True, dtype=torch.int64)).reshape(-1)


# ---------------------------------------------------------------------------
# static sizing
# ---------------------------------------------------------------------------

def _lane_cap(requested: Optional[int], load: int, shards: int,
              floor: int = 64) -> int:
    """The lane sizing rule `route_cap >= ceil(W/P)`: the default is
    max(ceil(W/P), floor), and an explicit cap must meet the rule."""
    need = -(-max(int(load), 0) // shards)          # ceil(W / P)
    cap = max(need, floor) if requested is None else int(requested)
    assert cap >= need, (
        f"lane cap {cap} violates route_cap >= ceil(W/P) = {need} "
        f"(W={load}, P={shards})")
    return cap


def tail_route_cap(walks: int, shards: int) -> int:
    """The tail's default walk lanes a shard pair: max(ceil(W/P), 64)."""
    return _lane_cap(None, walks, shards)


@dataclasses.dataclass(frozen=True)
class ThreePhasePlan:
    """Every static size the three-phase engine derives from (graph,
    shards, pool, K), as the JAX package's plan holds them, plus the
    Phase-1 sampler's stacked rows. The sizes and the host arrays
    (`psize_sh`, `pstart_sh`, `bperm_np`: [P, ...]) cover every shard;
    `sg` and `rows_perm` only the shards held here."""
    sg: ShardedGraph
    n_loc: int
    md: int
    S_loc_pad: int
    S_total: int
    rep_cap: int               # phase-1 reply lanes per shard pair
    route_cap2: int            # naive-tail walk lanes per shard pair
    cap2: int                  # naive-tail walk buffer per shard
    pool_pad: np.ndarray
    psize_sh: np.ndarray
    pstart_sh: np.ndarray
    layout: BucketLayout
    bperm_np: np.ndarray
    rows_layout: BucketLayout  # the Phase-1 rows of the local owners, stacked
    rows_perm: np.ndarray


def plan_three_phase(graph: CSRGraph, shards: int, pool_np: np.ndarray,
                     K: int, *, route_cap2: Optional[int] = None,
                     cap2: Optional[int] = None, bucketed: bool = True,
                     device=None, mesh=None) -> ThreePhasePlan:
    """The three-phase static sizing rules, on `device` (the graph's when
    None). With `mesh`, only its local shards' rows are placed, on its
    device; every size still comes from the whole graph, so that every
    process derives the same ones. Refuses a pool whose int32 slot ids
    would overflow; the outcome keys are int64 (see the module
    docstring)."""
    n = graph.n
    sg = shard_graph(graph, shards, device, mesh=mesh)
    n_loc = sg.n_loc
    deg_np = np.zeros(sg.n_pad, dtype=np.int32)
    deg_np[:n] = graph.numpy()[2]
    deg_np = deg_np.reshape(shards, n_loc)
    md = max(int(deg_np.max()), 1)

    # coupon pool layout: contiguous per shard, padded to S_loc_pad
    pool_pad = np.zeros(sg.n_pad, dtype=np.int64)
    pool_pad[:n] = pool_np
    psize_sh = pool_pad.reshape(shards, n_loc)
    pstart_sh = np.zeros_like(psize_sh)
    pstart_sh[:, 1:] = np.cumsum(psize_sh, axis=1)[:, :-1]
    S_loc = psize_sh.sum(axis=1)
    S_loc_pad = max(int(S_loc.max()), 1)
    S_total = int(pool_np.sum())
    if shards * S_loc_pad >= 2 ** 31:
        raise ValueError("coupon pool too large for int32 ids")
    if (shards * n_loc + 1) * (S_loc_pad + 1) >= _KEY_END:
        raise ValueError("vertex*rank outcome keys overflow int64")

    # Phase-1 reply lanes: a home receives at most one cell per
    # (owned vertex, outcome class) pair and at most one per coupon
    rep_cap = min(n_loc * (md + 1), S_loc_pad)
    # the naive tail keeps the Algorithm-1 sizing rule
    route_cap2 = _lane_cap(route_cap2, n * K, shards)
    if cap2 is None:
        cap2 = max(2 * n * K // shards, n_loc * K) + shards * 64

    layout, bperm_np = build_layout_sharded(deg_np, md, bucketed=bucketed)
    rows_layout, rows_perm = _phase1_rows(
        bperm_np if mesh is None else mesh.local_rows(bperm_np), layout,
        shards, n_loc)
    return ThreePhasePlan(sg=sg, n_loc=n_loc, md=md, S_loc_pad=S_loc_pad,
                          S_total=S_total, rep_cap=rep_cap,
                          route_cap2=int(route_cap2), cap2=int(cap2),
                          pool_pad=pool_pad, psize_sh=psize_sh,
                          pstart_sh=pstart_sh, layout=layout,
                          bperm_np=bperm_np, rows_layout=rows_layout,
                          rows_perm=rows_perm)


def _three_phase_layouts(n: int, pool_np: np.ndarray, cap2: int):
    """Elastic layout schema of each stage: coupon slots re-placed through
    the pool bijection, vertex shards re-split, walk lanes re-bucketed,
    per-shard keys re-derived (so a resume mid-Phase-1, or mid-tail with
    walks alive, at another shard count is statistical, not bit-exact)."""
    _slot = partial(LayoutSpec, kind="slot", n=n, pool=pool_np)
    _vert = LayoutSpec(kind="vertex", n=n)
    _rep = LayoutSpec(kind="replicated")
    return dict(
        phase1=dict(pos=_slot(fill=-1), alive=_slot(fill=0),
                    traj=_slot(fill=-1), key=LayoutSpec(kind="key")),
        phase2=dict(walks=_vert, next_c=_vert, used=_slot(fill=0),
                    tail_cnt=_vert, dest=_slot(fill=-1),
                    cterm=_slot(fill=1), traj=_slot(fill=-1), zeta=_vert),
        phase3=dict(traj=_slot(fill=-1), used=_slot(fill=0), zeta=_vert,
                    tail_cnt=_vert),
        tail=dict(pos=LayoutSpec(kind="walk", n=n, cap=cap2, fill=-1),
                  zeta=_vert, key=LayoutSpec(kind="key"),
                  round=_rep, dropped=_rep, waited=_rep),
    )


@dataclasses.dataclass
class ImprovedDistResult:
    zeta: torch.Tensor           # [n] global visit counts
    pi: np.ndarray
    shards: int
    walks_per_node: int
    eps: float
    lam: int
    eta: int
    ell: int
    rounds: int                  # supersteps over all phases
    phase1_rounds: int
    report_rounds: int           # 0: coupons stay home, no report phase
    phase2_rounds: int           # stitch supersteps
    phase3_rounds: int           # aggregated counting exchanges (== 1)
    tail_rounds: int             # naive-fallback supersteps
    stitch_iterations: int
    exhausted_walks: int
    terminated_by_coupon: int
    tail_walks: int
    coupons_created: int
    coupons_used: int
    dropped: int
    waited: int
    a2a_bytes_total: int
    a2a_bytes_by_phase: Dict[str, int] = dataclasses.field(
        default_factory=dict)
    a2a_entries_by_site: Dict[str, int] = dataclasses.field(
        default_factory=dict)   # lane entries per exchange site
    phase2_records: List[dict] = dataclasses.field(default_factory=list)
    report: Optional[CongestReport] = None
    total_visits: int = 0
    restarts: int = 0            # supervisor recoveries
    checkpoints_written: int = 0
    sampler_us: float = 0.0      # host wall time in the Phase-1 sampler
    p1_occupancy: tuple = ()     # per-bucket rows holding coupons, summed
                                 # over rounds and shards
    residual: int = 0            # sampler conservation leak: must stay 0


def distributed_improved_pagerank(
    graph: CSRGraph,
    eps: float,
    walks_per_node: Optional[int] = None,
    key: Optional[torch.Tensor] = None,
    *,
    mesh: Optional[StackedMesh] = None,
    lam: Optional[int] = None,
    eta: Optional[int] = None,
    eta_safety: float = 2.0,
    cap2: Optional[int] = None,
    route_cap2: Optional[int] = None,
    max_rounds: int = 100_000,
    bandwidth_bits: Optional[int] = None,
    checkpoint_dir: Optional[str] = None,
    fail_at: Optional[Sequence[int]] = None,
    checkpoint_every: int = 10,
    max_restarts: int = 16,
    resume: bool = False,
    bucketed: bool = True,
    device=None,
) -> ImprovedDistResult:
    """Algorithm 2 across the shards of `mesh` (one shard on `device`, the
    card when None, if no mesh is given), with Lemma-2 degree-proportional
    coupon pools.

    `cap2`/`route_cap2` size only the naive tail's buffers. With
    `checkpoint_dir` or `fail_at` the phase machine runs under the
    checkpoint-restart supervisor (see `_run_three_phase`)."""
    mesh = mesh or StackedMesh(1, device)
    key = key if key is not None else prng.PRNGKey(0)
    n = graph.n
    K = walks_per_node or walks_per_node_for(n, eps)
    log_n = math.log(max(n, 2))
    if lam is None:
        lam = max(1, int(math.ceil(math.sqrt(log_n))))
    ell = max(lam + 1, int(math.ceil(log_n / eps)))
    eta, pool_np = coupon_pool_sizes(graph, eps, K, lam, eta=eta,
                                     eta_safety=eta_safety)
    return _run_three_phase(
        graph, eps, K, key, mesh, pool_np=pool_np, eta=int(eta),
        lam=int(lam), ell=int(ell), cap2=cap2, route_cap2=route_cap2,
        max_rounds=max_rounds, bandwidth_bits=bandwidth_bits,
        checkpoint_dir=checkpoint_dir, fail_at=fail_at,
        checkpoint_every=checkpoint_every, max_restarts=max_restarts,
        resume=resume, bucketed=bucketed)


def _run_three_phase(
    graph: CSRGraph,
    eps: float,
    K: int,
    key: torch.Tensor,
    mesh: StackedMesh,
    *,
    pool_np: np.ndarray,
    eta: int,
    lam: int,
    ell: int,
    cap2: Optional[int] = None,
    route_cap2: Optional[int] = None,
    max_rounds: int = 100_000,
    bandwidth_bits: Optional[int] = None,
    checkpoint_dir: Optional[str] = None,
    fail_at: Optional[Sequence[int]] = None,
    checkpoint_every: int = 10,
    max_restarts: int = 16,
    resume: bool = False,
    bucketed: bool = True,
    result_cls: type = ImprovedDistResult,
    **extra_fields,
):
    """The three-phase engine loop, which sees only the per-node pool sizes
    `pool_np`, never the policy that made them: Lemma-2 pools
    (`distributed_improved_pagerank`) and Section-5 uniform pools
    (`distributed_directed.distributed_directed_pagerank`) share it.
    `result_cls`/`extra_fields` let a frontend return a subclass.

    Each phase is a `runtime.Stage` over a `StagedState`: `arrays` hold the
    phase's buffers, `host` the accumulators (round counters, wire volumes,
    traces, Phase-2 records). Without `checkpoint_dir`/`fail_at` the
    stages run in a plain loop; with either, the `runtime.Supervisor` runs
    them with stage-tagged snapshots and failures injected at the listed
    global rounds, which span all phases. Recovery replays the identical
    trajectory. `resume=True` continues from the latest snapshot in
    `checkpoint_dir`, written by this package or the JAX package, at this
    mesh's shard count or another (see the module docstring).

    On a mesh of several processes each holds its own shard's rows; the
    snapshots hold every shard's, gathered and written once (the stacked
    layout), and the results are read through `mesh.gather_rows`. Only
    `sampler_us`, a host clock, is each process's own."""
    shards, dev = mesh.shards, mesh.device
    n = graph.n
    plan = plan_three_phase(graph, shards, pool_np, K, route_cap2=route_cap2,
                            cap2=cap2, bucketed=bucketed, device=dev,
                            mesh=mesh)
    sg, n_loc, md = plan.sg, plan.n_loc, plan.md
    S_loc_pad, S_total = plan.S_loc_pad, plan.S_total
    rep_cap, route_cap2, cap2 = plan.rep_cap, plan.route_cap2, plan.cap2

    def put(a, dtype=_I32):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dtype).to(dev)

    # the global shard id of each local row
    ids = mesh.shard_ids().tolist()
    S = len(ids)
    # ---- Phase-1 placement: slot s of shard p is p's s-th coupon, at its
    # source vertex; slots past p's pool are padding (never allocated) ----
    psize_j = put(mesh.local_rows(plan.psize_sh))
    pstart_j = put(mesh.local_rows(plan.pstart_sh))
    slot_v = torch.zeros((S, S_loc_pad), dtype=_I32, device=dev)
    pos0 = torch.full((S, S_loc_pad), -1, dtype=_I32, device=dev)
    local = torch.arange(n_loc, dtype=_I32, device=dev)
    for row, p in enumerate(ids):
        src = torch.repeat_interleave(local, psize_j[row].long())
        slot_v[row, :src.numel()] = src
        pos0[row, :src.numel()] = src + p * n_loc
    # ---- Phase-2 placement: K long walks a real vertex (counts) ----
    real = (torch.tensor(ids, dtype=torch.int64, device=dev)[:, None] * n_loc
            + local) < n
    walks0 = torch.where(real, K, 0).to(_I32)
    del local

    key, k1, k_tail = prng.split(key, 3)
    rows_perm = put(plan.rows_perm)
    count_bound = S_total

    def _phase1(ms: StagedState):
        a = ms.arrays
        h = ms.host
        c, req_e, req_b = _p1_request(a["pos"], a["alive"], mesh=mesh,
                                      n_loc=n_loc, count_bound=count_bound)
        t0 = time.perf_counter()
        f_cnt, key1, k_perm, occ, residual = _p1_sample(
            rows_perm, plan.rows_layout, sg.out_deg, c, a["key"],
            eps=float(eps), mesh=mesh, md=md)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        del c
        pos, alive, stats = _p1_assign(
            sg.row_ptr, sg.col_idx, a["pos"], a["alive"], a["traj"], f_cnt,
            k_perm, h["phase1_rounds"], mesh=mesh, n_loc=n_loc, md=md,
            rep_cap=rep_cap, S_loc_pad=S_loc_pad)
        del f_cnt
        a.update(pos=pos, alive=alive, key=key1)
        # one read of the round's telemetry
        (pending, overflow, rep_e, rep_b, req_e, req_b,
         res) = torch.cat([stats, torch.stack([
             x.to(torch.int64).reshape(()) for x in (
                 req_e, req_b, residual)])]).tolist()
        h["phase1_rounds"] += 1
        h["dropped"] += overflow
        h["wire"]["phase1"] += req_b + rep_b
        h["wire_entries"]["phase1_req"] += req_e
        h["wire_entries"]["phase1_rep"] += rep_e
        h["sampler_us"] += (t1 - t0) * 1e6
        h["p1_occupancy"] = [x + y for x, y in zip(h["p1_occupancy"],
                                                   occ.tolist())]
        h["residual"] += res
        h["traces"].append([pending, req_e + rep_e])
        # each coupon gets exactly lam step opportunities, one a round
        return ms, pending == 0 or h["phase1_rounds"] >= lam

    def _after_phase1(ms: StagedState) -> StagedState:
        # coupons never moved buffers, so their summaries are home-local:
        # dest = the final vertex, cterm = the reset fired
        a = ms.arrays
        zeros = torch.zeros((S, n_loc), dtype=_I32, device=dev)
        ms.arrays = dict(
            walks=walks0.clone(), next_c=zeros, used=torch.zeros(
                (S, S_loc_pad), dtype=_I32, device=dev),
            tail_cnt=zeros.clone(), dest=a["pos"], cterm=1 - a["alive"],
            traj=a["traj"], zeta=walks0.clone())
        return ms

    def _phase2(ms: StagedState):
        a = ms.arrays
        walks, next_c, used, tail_cnt, stats = _p2_local(
            a["walks"], a["next_c"], a["used"], a["tail_cnt"], a["dest"],
            a["cterm"], psize_j, pstart_j, slot_v, mesh=mesh, n_loc=n_loc,
            S_loc_pad=S_loc_pad, count_bound=n * K)
        a.update(walks=walks, next_c=next_c, used=used, tail_cnt=tail_cnt)
        active, stitched, terminated, exhausted, entries, nbytes = \
            stats.tolist()
        h = ms.host
        h["phase2_rounds"] += 1
        h["stitches"] += stitched
        h["terminated"] += terminated
        h["exhausted"] += exhausted
        h["wire"]["phase2"] += nbytes
        h["wire_entries"]["phase2"] += entries
        h["phase2_records"].append(dict(
            active=active, stitched=stitched,
            terminated=terminated, exhausted=exhausted))
        h["traces"].append([active, entries])
        if active == 0:
            return ms, True
        if h["phase2_rounds"] >= max_rounds:
            raise RuntimeError("phase 2 did not converge within max_rounds")
        return ms, False

    def _after_phase2(ms: StagedState) -> StagedState:
        a = ms.arrays
        ms.host["coupons_used"] = int(_shard_sums(a["used"], mesh).sum())
        ms.arrays = dict(traj=a["traj"], used=a["used"], zeta=a["zeta"],
                         tail_cnt=a["tail_cnt"])
        return ms

    def _phase3(ms: StagedState):
        a = ms.arrays
        a["zeta"], entries, nbytes = _p3_local(
            a["traj"], a["used"], a["zeta"], mesh=mesh, n_loc=n_loc,
            count_bound=count_bound)
        entries, nbytes = torch.stack([entries, nbytes]).tolist()
        h = ms.host
        h["phase3_rounds"] += 1
        h["wire"]["phase3"] += nbytes
        h["wire_entries"]["phase3"] += entries
        h["traces"].append([0, entries])
        return ms, True          # the whole count lands in ONE exchange

    def _after_phase3(ms: StagedState) -> StagedState:
        a = ms.arrays
        h = ms.host
        tail = a["tail_cnt"]
        # every shard's tail walks, read on every process: all raise
        # together if one shard's do not fit its buffer
        per_shard = _shard_sums(tail, mesh)
        if int(per_shard.max()) > cap2:
            raise ValueError(
                f"cap2 = {cap2} slots a shard is too small for the tail "
                f"placement: the shards hold {per_shard.tolist()} tail "
                f"walks")
        pos_tail = torch.full((S, cap2), -1, dtype=_I32, device=dev)
        for row, p in enumerate(ids):
            vids = torch.repeat_interleave(
                torch.arange(p * n_loc, (p + 1) * n_loc, dtype=_I32,
                             device=dev), tail[row].long())
            pos_tail[row, :vids.numel()] = vids
        h["tail_walks"] = int(per_shard.sum())
        h["tail_active"] = h["tail_walks"]
        zero = torch.zeros((), dtype=_I32)
        ms.arrays = dict(pos=pos_tail, zeta=a["zeta"],
                         key=mesh.local_rows(prng.split(k_tail, shards)),
                         round=zero,
                         dropped=zero.clone(), waited=zero.clone())
        return ms

    def _tail(ms: StagedState):
        a = ms.arrays
        h = ms.host
        if h["tail_active"]:
            if h["tail_rounds"] >= max_rounds:
                raise RuntimeError(
                    "tail walks did not converge in max_rounds")
            state = DistState(pos=a["pos"], zeta=a["zeta"], key=a["key"],
                              round=int(a["round"]),
                              dropped=int(a["dropped"]),
                              waited=int(a["waited"]))
            state, active, entries, nbytes = superstep(
                sg, state, mesh=mesh, eps=float(eps), route_cap=route_cap2,
                stage="tail")
            a.update(pos=state.pos, zeta=state.zeta, key=state.key,
                     **{k: torch.tensor(getattr(state, k), dtype=_I32)
                        for k in ("round", "dropped", "waited")})
            h["tail_rounds"] += 1
            h["wire"]["tail"] += nbytes
            h["wire_entries"]["tail"] += entries
            h["traces"].append([active, entries])
            h["tail_active"] = active
        if h["tail_active"]:
            return ms, False
        h["dropped"] += int(a["dropped"])
        h["waited"] += int(a["waited"])
        return ms, True

    schedule = StageSchedule([
        Stage("phase1", _phase1, on_done=_after_phase1),
        Stage("phase2", _phase2, on_done=_after_phase2),
        Stage("phase3", _phase3, on_done=_after_phase3),
        Stage("tail", _tail),
    ])
    ms = StagedState(
        stage=schedule.first_stage,
        arrays=dict(
            pos=pos0, alive=(pos0 >= 0).to(_I32),
            traj=torch.full((S, S_loc_pad, lam), -1, dtype=_I32,
                            device=dev),
            key=mesh.local_rows(prng.split(k1, shards))),
        host=dict(phase1_rounds=0, report_rounds=0, phase2_rounds=0,
                  phase3_rounds=0, tail_rounds=0, dropped=0, waited=0,
                  stitches=0, terminated=0, exhausted=0, coupons_used=0,
                  tail_walks=0, tail_active=0,
                  wire=dict(phase1=0, report=0, phase2=0, phase3=0, tail=0),
                  wire_entries=dict(phase1_req=0, phase1_rep=0, phase2=0,
                                    phase3=0, tail=0),
                  sampler_us=0.0, p1_occupancy=[0] * len(plan.layout.caps),
                  residual=0, traces=[], phase2_records=[]),
        layouts=_three_phase_layouts(n, pool_np, cap2), shards=shards)
    del pos0

    def _put(name: str, arr: np.ndarray):
        if name in ("round", "dropped", "waited"):
            return torch.from_numpy(np.array(arr)).to(_I32)  # host scalars
        t = torch.from_numpy(np.array(mesh.local_rows(arr)))
        if name == "key":
            return t.to(torch.uint32)            # host keys
        return t.to(_I32).to(dev)

    # global rounds sum over the four stages, each bounded by max_rounds
    ms, restarts, checkpoints_written = run_staged(
        schedule, ms, _put, checkpoint_dir=checkpoint_dir, fail_at=fail_at,
        checkpoint_every=checkpoint_every, max_restarts=max_restarts,
        resume=resume,
        max_rounds=len(schedule.stages) * max_rounds + len(schedule.stages),
        tmp_prefix="pr3p_ckpt_", mesh=mesh)

    # ---------------- estimator: host float64 scaling ------------------
    zeta = mesh.gather_rows(ms.arrays["zeta"]).reshape(-1)[:n]
    pi = pagerank_from_visits(zeta, n, K, eps)
    total_visits = int(zeta.sum(dtype=torch.int64))

    h = ms.host
    wire = h["wire"]
    rounds = (h["phase1_rounds"] + h["report_rounds"] + h["phase2_rounds"]
              + h["phase3_rounds"] + h["tail_rounds"])
    traces = [RoundTrace(active_walks=a, messages=m, max_edge_count=1,
                         total_count=m) for a, m in h["traces"]]
    report = CongestReport(traces=traces, n=n,
                           bandwidth_bits=bandwidth_bits
                           or default_bandwidth(n))
    return result_cls(
        zeta=zeta, pi=pi, shards=shards, walks_per_node=K, eps=eps,
        lam=int(lam), eta=int(eta), ell=int(ell), rounds=rounds,
        phase1_rounds=h["phase1_rounds"], report_rounds=h["report_rounds"],
        phase2_rounds=h["phase2_rounds"], phase3_rounds=h["phase3_rounds"],
        tail_rounds=h["tail_rounds"], stitch_iterations=h["phase2_rounds"],
        exhausted_walks=h["exhausted"],
        terminated_by_coupon=h["terminated"], tail_walks=h["tail_walks"],
        coupons_created=S_total, coupons_used=h["coupons_used"],
        dropped=h["dropped"], waited=h["waited"],
        a2a_bytes_total=sum(wire.values()), a2a_bytes_by_phase=wire,
        a2a_entries_by_site=dict(h["wire_entries"]),
        phase2_records=h["phase2_records"], report=report,
        total_visits=total_visits, restarts=restarts,
        checkpoints_written=checkpoints_written,
        sampler_us=float(h["sampler_us"]),
        p1_occupancy=tuple(h["p1_occupancy"]),
        residual=int(h["residual"]), **extra_fields)


# ---------------------------------------------------------------------------
# CONGEST auditor spec
# ---------------------------------------------------------------------------

def three_phase_audit_spec(graph: CSRGraph, mesh: StackedMesh, *,
                           eps: float, K: int, pool_np: np.ndarray,
                           lam: int, engine: str = "improved"):
    """CONGEST-auditor spec for the three-phase engines (improved and
    directed frontends): the six stage programs with the statics the
    engine would use (via `plan_three_phase`), each exchange's declared
    per-round wire budget, and the elastic layout schema.

    The tail stage is a walk-class exchange whose runtime lane cap scales
    with W/P; overflow there waits rather than widening the lane, so the
    declaration pins route_cap = cap = n_loc, and the auditor runs one
    tail superstep at that cap. `eps` shapes no lane."""
    from repro_torch.core.accounting import (EngineAuditSpec, ExchangeSite,
                                             StageProgram)
    shards = mesh.shards
    n = graph.n
    plan = plan_three_phase(graph, shards, pool_np, K, mesh=mesh)
    n_loc, md = plan.n_loc, plan.md
    S_loc_pad, S_total = plan.S_loc_pad, plan.S_total
    rep_cap = plan.rep_cap
    tail_cap = n_loc                       # auditor-pinned (walk-class)

    count_budget = shards * n_loc          # Lemma-1 lanes: distinct vertices
    _count = dict(entry_nbytes=8, lane_entries=count_budget,
                  budget_entries=count_budget, wire_class="count",
                  budget_formula="P * n_loc distinct (vertex, count) pairs")
    rep_site = ExchangeSite(
        site="phase1_rep", entry_nbytes=12,
        lane_entries=shards * rep_cap,
        budget_entries=shards * n_loc * (md + 1),
        budget_formula=("P * min(n_loc*(max_deg+1), S_loc_pad) distinct "
                        "(vertex, class, count) cells <= P*n_loc*(md+1)"),
        wire_class="count",
        note="stacked F=3 lanes (vertex, outcome class, count)")
    tail_site = ExchangeSite(
        site="tail", entry_nbytes=4, lane_entries=shards * tail_cap,
        budget_entries=shards * n_loc,
        budget_formula="P * n_loc lane slots (auditor-pinned cap = n_loc)",
        wire_class="walk",
        note="naive-fallback walk routing; overflow waits, never widens")

    progs = [
        StageProgram(stage="phase1", program="request",
                     sites=(ExchangeSite(site="phase1_req", **_count),),
                     count_bound=S_total),
        StageProgram(stage="phase1", program="sample", sites=(),
                     count_bound=S_total),
        StageProgram(stage="phase1", program="assign", sites=(rep_site,),
                     count_bound=S_total),
        StageProgram(stage="phase2", program="stitch",
                     sites=(ExchangeSite(site="phase2", **_count),),
                     count_bound=n * K),
        StageProgram(stage="phase3", program="count",
                     sites=(ExchangeSite(site="phase3", **_count),),
                     count_bound=S_total),
        StageProgram(stage="tail", program="step", sites=(tail_site,),
                     count_bound=n * K),
    ]
    return EngineAuditSpec(
        engine=engine, programs=progs,
        stage_arrays={
            "phase1": ("pos", "alive", "traj", "key"),
            "phase2": ("walks", "next_c", "used", "tail_cnt", "dest",
                       "cterm", "traj", "zeta"),
            "phase3": ("traj", "used", "zeta", "tail_cnt"),
            "tail": ("pos", "zeta", "key", "round", "dropped", "waited"),
        },
        layouts=_three_phase_layouts(n, pool_np, plan.cap2),
        meta=dict(shards=shards, n=graph.n, K=K, lam=int(lam), md=md,
                  rep_cap=rep_cap, S_loc_pad=S_loc_pad, S_total=S_total))


def audit_spec(graph: CSRGraph, mesh: StackedMesh, *, eps: float = 0.2,
               walks_per_node: int = 2):
    """Lemma-2 (degree-proportional pools) frontend of the three-phase
    audit spec, sized as `distributed_improved_pagerank` sizes its run."""
    n = graph.n
    K = walks_per_node
    log_n = math.log(max(n, 2))
    lam = max(1, int(math.ceil(math.sqrt(log_n))))
    _, pool_np = coupon_pool_sizes(graph, eps, K, lam)
    return three_phase_audit_spec(graph, mesh, eps=eps, K=K,
                                  pool_np=pool_np, lam=lam,
                                  engine="improved")
