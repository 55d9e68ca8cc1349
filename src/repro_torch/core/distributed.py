"""Sharded walk-routing engine: Algorithm 1 over a mesh of vertex shards.

Vertices are split into contiguous shards, and a logical round is a
bulk-synchronous superstep:

    route  — walks whose current vertex another shard owns are exchanged
             through fixed-capacity all_to_all lanes (anonymous walk
             positions, Lemma 1: never identities);
    step   — each shard advances its owned walks one PageRank step
             (terminate w.p. eps, else a uniform out-edge) through the
             `walk_step` kernel.

Shapes are static: per-shard walk buffers of capacity `cap`, per
(shard, shard) lanes of capacity `route_cap`. A walk that does not fit its
lane waits a round. Buffer overflow beyond `cap` is counted in `dropped`
and must be 0 for an exact run.

Visit counting: the owner shard counts a walk's arrival once —
immediately for a move within the shard, at receive time for a routed
walk. The per-shard tensors carry a leading dimension of the shards the
process holds (`core/collectives.py`: all P on a `StackedMesh`, its own
on a `ProcessGroupMesh`); PRNG keys stay on the host, one per shard.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core.collectives import StackedMesh
from repro_torch.core.estimator import pagerank_from_visits
from repro_torch.core.graph import CSRGraph
from repro_torch.core.routing import (advance_owned, count_owned_arrivals,
                                      merge_walks, rank_within, route_walks)


@dataclasses.dataclass(frozen=True)
class ShardedGraph:
    """Vertex-partitioned CSR: shard p owns [p*n_loc, (p+1)*n_loc)."""

    n: int
    n_pad: int
    n_loc: int
    shards: int
    row_ptr: torch.Tensor   # [S, n_loc+1] rebased per shard
    col_idx: torch.Tensor   # [S, m_loc_pad] global vertex ids
    out_deg: torch.Tensor   # [S, n_loc]


def shard_graph(graph: CSRGraph, shards: int, device=None, *,
                mesh=None) -> ShardedGraph:
    """Cut `graph` into `shards` contiguous vertex ranges, on `device`
    (the graph's when None). With `mesh`, only the mesh's local shards
    are placed, on its device; `m_pad` stays the most over all shards."""
    n_loc = math.ceil(graph.n / shards)
    row_ptr, col, deg = graph.numpy()
    lo = np.minimum(np.arange(shards) * n_loc, graph.n)
    hi = np.minimum(lo + n_loc, graph.n)
    m_loc = row_ptr[hi] - row_ptr[lo]
    m_pad = max(int(m_loc.max()), 1)
    rp = np.zeros((shards, n_loc + 1), dtype=np.int32)
    ci = np.zeros((shards, m_pad), dtype=np.int32)
    dg = np.zeros((shards, n_loc), dtype=np.int32)
    for p in range(shards):
        local_rp = row_ptr[lo[p]:hi[p] + 1] - row_ptr[lo[p]]
        rp[p, : hi[p] - lo[p] + 1] = local_rp
        rp[p, hi[p] - lo[p] + 1:] = local_rp[-1]
        ci[p, : m_loc[p]] = col[row_ptr[lo[p]]:row_ptr[hi[p]]]
        dg[p, : hi[p] - lo[p]] = deg[lo[p]:hi[p]]
    device = graph.device if device is None else device
    if mesh is not None:
        device = mesh.device
        rp, ci, dg = (mesh.local_rows(a) for a in (rp, ci, dg))

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return ShardedGraph(n=graph.n, n_pad=n_loc * shards, n_loc=n_loc,
                        shards=shards, row_ptr=dev(rp), col_idx=dev(ci),
                        out_deg=dev(dg))


@dataclasses.dataclass
class DistState:
    pos: torch.Tensor    # [S, cap] global vertex id, -1 = empty slot
    zeta: torch.Tensor   # [S, n_loc] int32 visit counters
    key: torch.Tensor    # [S, 2] per-shard PRNG keys (uint32, host)
    round: int
    dropped: int         # must stay 0 for an exact run
    waited: int          # routing-lane carry-overs (stat)


def superstep(sg: ShardedGraph, state: DistState, *, mesh: StackedMesh,
              eps: float, route_cap: int, work_cap: int = 0,
              stage: str = "walks"):
    """One superstep on every shard. Returns (state, active, a2a_entries,
    a2a_bytes), the three counts summed over shards.

    `work_cap` > 0 bounds the steps a shard takes in a round (a straggler
    bound): only its first `work_cap` owned walks in buffer order step,
    the rest keep their place for a later round. The superstep runs as the
    program `stage/step` of the mesh (the three-phase tail passes
    "tail")."""
    with mesh.program(stage, "step"):
        return _superstep(sg, state, mesh=mesh, eps=eps,
                          route_cap=route_cap, work_cap=work_cap)


def _superstep(sg: ShardedGraph, state: DistState, *, mesh: StackedMesh,
               eps: float, route_cap: int, work_cap: int):
    n_loc, shards = sg.n_loc, mesh.shards
    sid = mesh.shard_ids()
    pos, zeta = state.pos, state.zeta
    cap = pos.shape[1]

    # ---- route: send non-owned walks, up to route_cap per target ----
    kept, _, recv, _, waited, sent_entries, sent_bytes = route_walks(
        pos, {}, mesh=mesh, n_loc=n_loc, route_cap=route_cap)
    # arrivals are owned by the receiving shard by construction
    zeta = zeta + count_owned_arrivals(recv >= 0, recv, sid, n_loc)

    # ---- merge buffer: kept walks + arrivals, compact into cap slots ----
    pos, _, dropped = merge_walks(kept, {}, recv, {}, cap)

    # ---- step: advance the walks each shard owns (straggler-bounded) ----
    keys = torch.stack([prng.split(k, 3) for k in state.key])  # [P, 3, 2]
    owned = (pos >= 0) & (torch.div(pos, n_loc, rounding_mode="floor")
                          == sid[:, None])
    stepped = owned
    if work_cap:
        owned_rank, _ = rank_within(torch.where(owned, 0, 1).to(torch.int32))
        stepped = owned & (owned_rank < work_cap)
    survive, dst = advance_owned(sg.row_ptr, sg.col_idx, sg.out_deg, pos,
                                 stepped, keys[:, 1], keys[:, 2], eps, sid,
                                 n_loc)
    new_pos = torch.where(survive, dst, torch.where(stepped, -1, pos))
    # arrivals within the shard are counted at once
    local_arrival = survive & (torch.div(dst, n_loc, rounding_mode="floor")
                               == sid[:, None])
    zeta = zeta + count_owned_arrivals(local_arrival, dst, sid, n_loc)

    stats = torch.stack([mesh.psum((new_pos >= 0).sum(dim=1)),
                         mesh.psum(dropped), mesh.psum(waited),
                         mesh.psum(sent_entries), mesh.psum(sent_bytes)])
    active, dropped, waited, entries, nbytes = (int(x) for x in
                                                stats.tolist())
    new_state = DistState(pos=new_pos, zeta=zeta, key=keys[:, 0].clone(),
                          round=state.round + 1,
                          dropped=state.dropped + dropped,
                          waited=state.waited + waited)
    return new_state, active, entries, nbytes


def init_state(sg: ShardedGraph, walks_per_node: int, key: torch.Tensor,
               cap: int, device, *, mesh=None) -> DistState:
    """Walks start at their own vertex, K per real vertex, packed at the
    front of their owner's buffer; zeta starts at K per real vertex; the
    shard keys are `split(key, P)`. With `mesh`, only its local shards'
    rows are built, on its device."""
    shards, n_loc = sg.shards, sg.n_loc
    ids = list(range(shards)) if mesh is None else \
        mesh.shard_ids().tolist()
    device = device if mesh is None else mesh.device
    if min(sg.n, n_loc) * walks_per_node > cap:
        raise ValueError("cap too small for the initial placement")
    pos = torch.full((len(ids), cap), -1, dtype=torch.int32, device=device)
    zeta = torch.zeros((len(ids), n_loc), dtype=torch.int32, device=device)
    for row, p in enumerate(ids):
        lo, hi = min(p * n_loc, sg.n), min((p + 1) * n_loc, sg.n)
        locs = torch.arange(lo, hi, dtype=torch.int32, device=device)
        pos[row, : (hi - lo) * walks_per_node] = locs.repeat_interleave(
            walks_per_node)
        zeta[row, : hi - lo] = walks_per_node
    keys = prng.split(key, shards)
    return DistState(pos=pos, zeta=zeta,
                     key=keys if mesh is None else mesh.local_rows(keys),
                     round=0, dropped=0, waited=0)


@dataclasses.dataclass
class DistributedResult:
    zeta: torch.Tensor        # [n] global visit counts
    pi: np.ndarray
    rounds: int
    dropped: int
    waited: int
    a2a_entries_total: int    # routed lane entries (4 B each, int32 pos)
    a2a_bytes_total: int
    shards: int
    # walks alive after each superstep: walks only terminate, so this
    # never increases in a conserving run
    round_active: List[int] = dataclasses.field(default_factory=list)


def default_route_cap(walks: int, shards: int) -> int:
    """The lanes a shard pair of a run of `walks` walks when the caller
    gives none: max(W // P, 64)."""
    return max(walks // shards, 64)


def distributed_pagerank(graph: CSRGraph, eps: float, walks_per_node: int,
                         key: torch.Tensor, *,
                         mesh: Optional[StackedMesh] = None,
                         cap: Optional[int] = None,
                         route_cap: Optional[int] = None,
                         work_cap: int = 0,
                         max_rounds: int = 100_000,
                         device=None) -> DistributedResult:
    """Algorithm 1 with walk routing across the shards of `mesh` (one shard
    on `device`, the card when None, if no mesh is given). `work_cap` > 0
    steps at most that many owned walks a shard in a round."""
    mesh = mesh or StackedMesh(1, device)
    shards = mesh.shards
    sg = shard_graph(graph, shards, mesh=mesh)
    W = graph.n * walks_per_node
    if cap is None:
        cap = max(2 * W // shards + shards * 64, 256)
    if route_cap is None:
        route_cap = default_route_cap(W, shards)
    state = init_state(sg, walks_per_node, key, cap, mesh.device, mesh=mesh)
    a2a_total = entries_total = 0
    round_active: List[int] = []
    while state.round < max_rounds:
        state, active, entries, nbytes = superstep(
            sg, state, mesh=mesh, eps=float(eps), route_cap=int(route_cap),
            work_cap=int(work_cap))
        a2a_total += nbytes
        entries_total += entries
        round_active.append(active)
        if active == 0:
            break
    zeta = mesh.gather_rows(state.zeta).reshape(-1)[: graph.n]
    pi = pagerank_from_visits(zeta, graph.n, walks_per_node, eps)
    return DistributedResult(
        zeta=zeta, pi=pi, rounds=state.round, dropped=state.dropped,
        waited=state.waited, a2a_entries_total=entries_total,
        a2a_bytes_total=a2a_total, shards=shards, round_active=round_active)


# --------------------------------------------------------------------------
# checkpoint/restart hooks (used by runtime.fault_tolerance)
# --------------------------------------------------------------------------

def state_to_host(state: DistState, mesh=None) -> dict:
    """The state in the stacked [P, ...] host layout; with `mesh`, every
    shard's rows gathered over it (a collective: every process calls
    it)."""
    def rows(t):
        return t.cpu().numpy() if mesh is None else mesh.host_rows(t)

    return dict(pos=rows(state.pos), zeta=rows(state.zeta),
                key=rows(state.key), round=int(state.round),
                dropped=int(state.dropped), waited=int(state.waited))


def state_from_host(d: dict, mesh: StackedMesh) -> DistState:
    """The mesh's local rows of a stacked [P, ...] host state."""
    def rows(name, dtype):
        return torch.from_numpy(np.array(mesh.local_rows(d[name]), dtype))

    return DistState(
        pos=rows("pos", np.int32).to(mesh.device),
        zeta=rows("zeta", np.int32).to(mesh.device),
        key=rows("key", np.uint32),
        round=int(d["round"]), dropped=int(d["dropped"]),
        waited=int(d["waited"]))


# --------------------------------------------------------------------------
# static wire-budget declaration (consumed by `analysis.congest`)
# --------------------------------------------------------------------------

def audit_spec(graph: CSRGraph, mesh: StackedMesh, *, eps: float = 0.2,
               walks_per_node: int = 2):
    """The walk engine's `EngineAuditSpec` for the CONGEST auditor.

    The runtime `route_cap` scales with W/P, so this engine's lanes are
    walk-class wire: the declaration PINS `route_cap` at n_loc (legal:
    overflowing walks wait and retry, any cap is correct), which makes the
    checked capacity a W-free function of the partition; the auditor runs
    one superstep at that cap to hold it. The walk-buffer `cap` never
    touches the wire and is pinned too. `eps` shapes no lane."""
    from repro_torch.checkpoint import pagerank_state_specs
    from repro_torch.core.accounting import (EngineAuditSpec, ExchangeSite,
                                             StageProgram)
    shards = mesh.shards
    n_loc = math.ceil(graph.n / shards)
    route_cap = cap = n_loc
    site = ExchangeSite(
        site="route", entry_nbytes=4, lane_entries=shards * route_cap,
        budget_entries=shards * n_loc,
        budget_formula="P * n_loc lane slots (auditor-pinned "
                       "route_cap = n_loc)",
        wire_class="walk",
        note="runtime route_cap scales with W/P; overflow waits rather "
             "than widening the lane, so any pinned cap is correct")
    prog = StageProgram(stage="walks", program="step", sites=(site,),
                        count_bound=graph.n * walks_per_node)
    return EngineAuditSpec(
        engine="walks", programs=[prog],
        stage_arrays={"walks": ("pos", "zeta", "key", "round", "dropped",
                                "waited")},
        layouts={"walks": pagerank_state_specs(graph.n, cap=cap)},
        meta=dict(shards=shards, n=graph.n, walks_per_node=walks_per_node))
