"""Batched multi-source Personalized PageRank: the query-serving engine.

Walk buffers carry a query-id lane: every walk slot is a (position, qid)
pair, so one superstep advances every query in flight. Movement between
shards rides the Lemma-1 count wire (`routing.route_counts`) unchanged,
over a virtual vertex space that folds the query id into the vertex:

    u = v * Q + q          owner(u) = u // (n_loc * Q) = v // n_loc

so the all_to_all payload of a superstep is bounded by the number of
distinct (vertex, query) pairs with traffic, whatever the number of walks
moving, and the receiving shard deals walks back out from the delivered
counts. That is sound because walks are anonymous within a query (Lemma 1
of the paper, with one more lane).

The kernels: each walk's step through `walk_step` (its keyed entry, which
draws the uniforms itself; `routing.advance_owned`), the (vertex, query)
counts and the admitted starts through `histogram`
(`routing.vertex_histogram`, `routing.count_owned_arrivals`), and the
received lanes' sum through `segment_spmv` (`routing.route_counts`).

The engine is resident: the sharded graph and the walk and visit buffers
stay on the device across queries. `admit(slot, sources, ...)` installs a
query in a free slot (start walks and start visits; the start counts come
from `personalized.source_start_counts`, as the single-query engine draws
them), `superstep()` advances everything one round and reports the live
walks of each query, and `extract(slot)` reads one query's PPR vector.
`serve/ppr_service.py` adds admission, a result cache and traffic
statistics; `batched_personalized_pagerank` below runs one batch to the
end for the launch CLI and the tests.

Shards are the leading dimension of every buffer ([S, ...], see
`core/collectives.py`): all P of them on a `StackedMesh`, this process's
one on a `ProcessGroupMesh`; the per-shard PRNG keys stay on the host.
Every count the host reads to steer (the live walks of each query, the
round's wire, `dropped`, `admit_dropped`) comes out of `mesh.psum`, and
a query's vector out of `mesh.gather_rows`, so every process of a group
takes the same branch. A superstep's psum is one [Q + 3] int64 vector:
8 (Q + 3) bytes, within the auditor's 256-byte control bound up to
Q = 29 query slots.

Buffer sizing: walks only terminate after admission, so a per-shard `cap`
of num_slots * walks_per_query + 64 cannot overflow even if every live
walk lands on one shard (the default). A tighter cap trades memory for a
nonzero `dropped`, which must stay 0 for an exact run.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import prng
from repro_torch.checkpoint import LayoutSpec, relayout_arrays
from repro_torch.core.collectives import StackedMesh, in_program
from repro_torch.core.distributed import ShardedGraph, shard_graph
from repro_torch.core.graph import CSRGraph
from repro_torch.core.personalized import (DEFAULT_MAX_ROUNDS,
                                           normalize_query,
                                           source_start_counts)
from repro_torch.core.routing import (advance_owned, count_owned_arrivals,
                                      rank_small, route_counts, row_cumsum,
                                      vertex_histogram)

_I32 = torch.int32


@dataclasses.dataclass
class BatchPPRState:
    pos: torch.Tensor    # [P, cap] global padded vertex id, -1 = empty slot
    qid: torch.Tensor    # [P, cap] query slot of each walk (0 where empty)
    zeta: torch.Tensor   # [P, n_loc, Q] visits per (owned vertex, query)
    key: torch.Tensor    # [P, 2] per-shard PRNG keys (uint32, host)


def ppr_state_specs(n: int, cap: int):
    """The elastic layout schema of the resident engine's buffers."""
    return dict(
        pos=LayoutSpec(kind="walk", n=n, cap=cap, fill=-1, aux=("qid",)),
        qid=LayoutSpec(kind="walk_aux", fill=0),
        zeta=LayoutSpec(kind="vertex", n=n),
        key=LayoutSpec(kind="key"))


@in_program("serve", "superstep")
def _ppr_superstep(sg: ShardedGraph, st: BatchPPRState, *, mesh, eps: float,
                   Q: int, count_bound: Optional[int] = None):
    """One batched PPR round on every local shard. Every buffered walk is
    owned by its shard (arrivals are dealt out owner-side), so every valid
    slot steps. Returns (state, stats): `stats` is the [Q + 3] int64 psum
    over all shards of the live walks of each query, then the round's
    lane entries, wire bytes and dropped walks."""
    n_loc, shards = sg.n_loc, mesh.shards
    sid = mesh.shard_ids()
    pos, qid = st.pos, st.qid
    S, cap = pos.shape
    keys = torch.stack([prng.split(k, 3) for k in st.key])  # [S, 3, 2]

    valid = pos >= 0
    survive, dst = advance_owned(sg.row_ptr, sg.col_idx, sg.out_deg, pos,
                                 valid, keys[:, 1], keys[:, 2], eps, sid,
                                 n_loc)

    # Lemma-1 aggregation with a query lane: movers collapse to counts per
    # virtual (vertex, query) id and ride one route_counts exchange
    u = dst * Q + qid
    per_virtual = vertex_histogram(u, survive, shards * n_loc * Q)
    arrivals, sent_entries, sent_bytes = route_counts(
        per_virtual, mesh=mesh, n_loc=n_loc * Q, count_bound=count_bound)

    # every arrival is a visit to an owned vertex
    zeta = st.zeta + arrivals.reshape(S, n_loc, Q)

    # deal the buffer out from the arrival counts (anonymity within qid)
    cum = row_cumsum(arrivals)
    total = cum[:, -1:]
    slot = torch.arange(cap, dtype=_I32, device=pos.device)
    u_loc = torch.clamp(torch.searchsorted(
        cum, slot.expand(S, cap).contiguous(), right=True),
        max=n_loc * Q - 1).to(_I32)
    take = slot < total
    new_pos = torch.where(take, sid[:, None] * n_loc + u_loc // Q, -1)
    new_qid = torch.where(take, u_loc % Q, 0)

    # the walks each query keeps: the dealt slots below cap, counted per
    # virtual id from the running sums (exact, without a pass over cap)
    kept = (torch.clamp(cum, max=cap)
            - torch.clamp(cum - arrivals, max=cap)).to(torch.int64)
    dropped = torch.clamp(total[:, 0] - cap, min=0)
    stats = mesh.psum(torch.cat([
        kept.reshape(S, n_loc, Q).sum(dim=1),
        torch.stack([sent_entries, sent_bytes, dropped], dim=1).to(
            torch.int64)], dim=1))
    return (BatchPPRState(pos=new_pos, qid=new_qid, zeta=zeta,
                          key=keys[:, 0].clone()), stats)


@in_program("serve", "admit")
def _ppr_admit(st: BatchPPRState, starts: torch.Tensor, slot: int, *,
               mesh, n_loc: int):
    """Install a query in slot `slot`: place its start walks in free buffer
    slots of the shards that own the start vertices, and set the slot's
    visit column to the start visits (a start counts as a visit, as in
    `engine_walks.init_state`). `starts` is [walks_per_query] global
    vertex ids. Updates `st.zeta` in place; returns (state,
    admit_dropped), the latter the [1] psum over all shards."""
    sid = mesh.shard_ids()
    S = st.pos.shape[0]
    # a freed slot leaves no walks behind, but a re-admitted slot must
    # never inherit strays
    pos = torch.where((st.pos >= 0) & (st.qid == slot), -1, st.pos)

    starts = starts.expand(S, -1)
    mine = (starts >= 0) & (torch.div(starts, n_loc, rounding_mode="floor")
                            == sid[:, None])
    st.zeta[:, :, slot] = count_owned_arrivals(mine, starts, sid, n_loc)

    # pack each shard's starts, in order, into its free slots in order
    order = torch.sort(torch.where(mine, 0, 1).to(_I32), dim=1,
                       stable=True).indices
    vals = torch.gather(starts, 1, order)          # the first n_mine: mine
    n_mine = mine.sum(dim=1, keepdim=True)
    free = pos < 0
    free_rank = rank_small(torch.where(free, 0, 1), 1)
    take = free & (free_rank < n_mine)
    pick = torch.gather(vals, 1, torch.clamp(
        free_rank, max=starts.shape[1] - 1).long())
    pos = torch.where(take, pick, pos)
    qid = torch.where(take, slot, st.qid)
    admit_dropped = mesh.psum(
        (n_mine - take.sum(dim=1, keepdim=True)).to(torch.int64))
    return (BatchPPRState(pos=pos, qid=qid, zeta=st.zeta, key=st.key),
            admit_dropped)


def check_virtual_ids(n_pad: int, Q: int, local_shards: int) -> None:
    """Raise unless the int32 ids of a superstep hold: the virtual ids
    u = v * Q + q (n_pad * Q of them), and the histogram's segment ids,
    which offset them once more by local row (all P shards stacked on
    one device, one row per process of a group)."""
    if n_pad * Q >= 2 ** 31:
        raise ValueError(f"n_pad {n_pad} x {Q} query slots exceeds the "
                         f"int32 virtual vertex ids")
    if local_shards * n_pad * Q >= 2 ** 31:
        raise ValueError(f"{local_shards} local shards x n_pad {n_pad} x "
                         f"{Q} query slots exceeds the int32 segment ids "
                         f"of one device")


class BatchedPPREngine:
    """A resident sharded graph and Q walk-slot batch of PPR queries, on
    `mesh`: a `StackedMesh` or a `ProcessGroupMesh` (one shard on
    `device`, the card when None, if no mesh is given). Over a process
    group every process makes every call, in the same order.

    Telemetry (host counters, cumulative, the same on every process):
    `rounds`, `a2a_entries`, `a2a_bytes`, `dropped` (buffer overflow, must
    stay 0), `admit_dropped` (admission overflow, must stay 0), and
    `active`, the [Q] live walks of each query after the last superstep.
    """

    def __init__(self, graph: CSRGraph, eps: float, *, num_slots: int,
                 walks_per_query: int, mesh=None,
                 cap: Optional[int] = None, device=None):
        self.mesh = mesh or StackedMesh(1, device)
        self.graph = graph
        self.eps = float(eps)
        self.Q = int(num_slots)
        self.walks_per_query = int(walks_per_query)
        self.shards = self.mesh.shards
        self.sg: ShardedGraph = shard_graph(graph, self.shards,
                                            mesh=self.mesh)
        # the rows this process holds: all P stacked, one per process
        self.local_shards = int(self.sg.row_ptr.shape[0])
        check_virtual_ids(self.sg.n_pad, self.Q, self.local_shards)
        if cap is None:
            # worst case: every live walk of every slot on one shard
            cap = self.Q * self.walks_per_query + 64
        self.cap = int(cap)
        self.reset(prng.PRNGKey(0))

    @property
    def device(self) -> torch.device:
        return self.mesh.device

    # ------------------------------------------------------------ lifecycle
    def reset(self, key: torch.Tensor) -> None:
        """Clear every slot and re-seed the per-shard PRNG streams."""
        shape, dev = (self.local_shards, self.cap), self.device
        self.state = BatchPPRState(
            pos=torch.full(shape, -1, dtype=_I32, device=dev),
            qid=torch.zeros(shape, dtype=_I32, device=dev),
            zeta=torch.zeros((self.local_shards, self.sg.n_loc, self.Q),
                             dtype=_I32, device=dev),
            key=self.mesh.local_rows(prng.split(key, self.shards)))
        self.active = np.zeros(self.Q, dtype=np.int64)
        self.rounds = 0
        self.a2a_entries = 0
        self.a2a_bytes = 0
        self.dropped = 0
        self.admit_dropped = 0

    # ------------------------------------------------------------ admission
    def admit(self, slot: int, sources, weights=None,
              key: Optional[torch.Tensor] = None) -> None:
        """Start `walks_per_query` walks from the query's source
        distribution in slot `slot`, which must be idle."""
        if not 0 <= slot < self.Q:
            raise ValueError(f"slot {slot} out of range [0, {self.Q})")
        if self.active[slot] != 0:
            raise ValueError(f"slot {slot} still has live walks")
        key = key if key is not None else prng.PRNGKey(slot)
        sources, weights = normalize_query(sources, weights, self.graph.n)
        counts = source_start_counts(key, weights, self.walks_per_query)
        starts = torch.from_numpy(np.repeat(sources, counts).astype(
            np.int32)).to(self.device)
        self.state, admit_dropped = _ppr_admit(
            self.state, starts, int(slot), mesh=self.mesh,
            n_loc=self.sg.n_loc)
        admit_dropped = int(admit_dropped)
        self.admit_dropped += admit_dropped
        self.active[slot] = self.walks_per_query - admit_dropped

    # ------------------------------------------------------------- stepping
    def superstep(self) -> np.ndarray:
        """Advance every live walk of every query one round; returns the
        [Q] live walks of each query (0 = the query is complete)."""
        self.state, stats = _ppr_superstep(
            self.sg, self.state, mesh=self.mesh, eps=self.eps, Q=self.Q,
            count_bound=self.walks_per_query)
        # one read of the card for the round's telemetry
        stats = stats.tolist()
        self.active = np.asarray(stats[:self.Q], dtype=np.int64)
        entries, sent, dropped = stats[self.Q:]
        self.rounds += 1
        self.a2a_entries += int(entries)
        self.a2a_bytes += int(sent)
        self.dropped += int(dropped)
        return self.active

    # ------------------------------------------------------------- elastic
    TELEMETRY = ("rounds", "a2a_entries", "a2a_bytes", "dropped",
                 "admit_dropped")

    def host_state(self) -> dict:
        """Every shard's serving state as host arrays ([P, ...]) with the
        telemetry: what `adopt` re-lays out onto another mesh. Over a
        process group every process of this engine's mesh calls it, and
        each gets the whole."""
        arrays = {name: self.mesh.host_rows(getattr(self.state, name))
                  for name in ("pos", "qid", "zeta", "key")}
        return dict(arrays=arrays, n=self.graph.n, Q=self.Q,
                    walks_per_query=self.walks_per_query,
                    active=self.active.copy(),
                    **{name: getattr(self, name) for name in self.TELEMETRY})

    def adopt(self, host: dict) -> None:
        """Take over a `host_state` of an engine on any mesh: its arrays
        re-laid out onto this engine's shards by
        `checkpoint.relayout_arrays`, this process's rows placed. Local:
        every process of this engine's mesh calls it with the same
        `host`, so `cap`, grown under walk skew, is the same on each."""
        got = (host["n"], host["Q"], host["walks_per_query"])
        if got != (self.graph.n, self.Q, self.walks_per_query):
            raise ValueError(
                f"engine mismatch: (n, Q, walks_per_query) {got} vs "
                f"{(self.graph.n, self.Q, self.walks_per_query)}")
        specs = ppr_state_specs(self.graph.n, self.cap)
        out = relayout_arrays(host["arrays"], specs, self.shards)
        self.cap = int(out["pos"].shape[1])    # grown under walk skew

        def mine(name):
            return torch.from_numpy(np.ascontiguousarray(
                self.mesh.local_rows(out[name])))

        dev = self.device
        self.state = BatchPPRState(
            pos=mine("pos").to(dev), qid=mine("qid").to(dev),
            zeta=mine("zeta").to(dev), key=mine("key"))
        self.active = np.array(host["active"], dtype=np.int64)
        for name in self.TELEMETRY:
            setattr(self, name, host[name])

    def relayout_from(self, other: "BatchedPPREngine") -> None:
        """Adopt `other`'s live serving state onto this engine's mesh.

        The walk buffer with its query-id lane, the per-(vertex, query)
        visit shards and the telemetry carry over through
        `checkpoint.relayout_arrays`: queries in flight keep their walks
        and visit counts bit for bit. The per-shard keys are re-derived,
        so the remaining steps of live walks are statistically, not
        bitwise, the ones the old mesh would have taken. Every process of
        both meshes calls it (`other.host_state` is collective)."""
        self.adopt(other.host_state())

    # -------------------------------------------------------------- results
    def extract(self, slot: int) -> np.ndarray:
        """The PPR estimator vector of slot `slot`:
        zeta * eps / walks_per_query, scaled in float64 on the host. Every
        process of the mesh calls it and gets the whole vector."""
        zeta = self.mesh.gather_rows(self.state.zeta[:, :, slot])
        zeta = zeta.cpu().numpy().astype(np.int64).reshape(-1)[: self.graph.n]
        return zeta.astype(np.float64) * (self.eps / self.walks_per_query)


@dataclasses.dataclass
class BatchPPRResult:
    ppr: np.ndarray          # [num_queries, n] estimator vectors
    rounds: int
    a2a_bytes: int
    dropped: int             # walk-buffer overflow, 0 for an exact run
    admit_dropped: int       # admission overflow, 0 for an exact run
    shards: int
    active_trace: List[int]  # total live walks after each superstep
    a2a_entries: int = 0     # routed (virtual vertex, count) lane entries


def batched_personalized_pagerank(
        graph: CSRGraph, eps: float,
        queries: Sequence[Tuple[Sequence[int], Optional[Sequence[float]]]],
        walks_per_query: int, key: torch.Tensor, *,
        mesh=None, cap: Optional[int] = None,
        max_rounds: int = DEFAULT_MAX_ROUNDS,
        device=None) -> BatchPPRResult:
    """One batch to the end: admit every query up front, run every walk to
    termination in shared supersteps, extract every result. `mesh` is a
    `StackedMesh` or a `ProcessGroupMesh` (every process calls it, and
    each gets the whole result).

    `queries` is a sequence of (sources, weights or None). Query i's walk
    starts come from fold_in(key, i), so a batch is reproducible for a key
    and each query resamples under a new one."""
    engine = BatchedPPREngine(graph, eps, num_slots=len(queries),
                              walks_per_query=walks_per_query, mesh=mesh,
                              cap=cap, device=device)
    engine.reset(prng.fold_in(key, 0xBA7C))
    for i, (sources, weights) in enumerate(queries):
        engine.admit(i, sources, weights, key=prng.fold_in(key, i))
    trace: List[int] = []
    while engine.active.sum() > 0 and engine.rounds < max_rounds:
        active = engine.superstep()
        trace.append(int(active.sum()))
    ppr = np.stack([engine.extract(i) for i in range(len(queries))])
    return BatchPPRResult(ppr=ppr, rounds=engine.rounds,
                          a2a_bytes=engine.a2a_bytes,
                          a2a_entries=engine.a2a_entries,
                          dropped=engine.dropped,
                          admit_dropped=engine.admit_dropped,
                          shards=engine.shards, active_trace=trace)


def audit_spec(graph: CSRGraph, mesh, *, eps: float = 0.2,
               num_slots: int = 2, walks_per_query: int = 8):
    """CONGEST-auditor spec for the batched PPR engine: the resident
    engine's superstep program, its declared (vertex, query)-lane budget,
    the admission program (no all_to_all: its one psum is the admission
    overflow, as JAX's admit psums it), and the elastic schema of an
    engine with an auditor-pinned walk cap of 64 (the virtual-lane wire
    bound does not depend on the buffer size). `eps` shapes no lane."""
    from repro_torch.core.accounting import (EngineAuditSpec, ExchangeSite,
                                             StageProgram)
    shards, Q, cap = mesh.shards, int(num_slots), 64
    n_loc = math.ceil(graph.n / shards)
    site = ExchangeSite(
        site="ppr", entry_nbytes=8, lane_entries=shards * n_loc * Q,
        budget_entries=shards * n_loc * Q,
        budget_formula=("P * n_loc * Q distinct (vertex, query) virtual "
                        "lanes — Lemma 1 extended by the query-id lane"),
        wire_class="count",
        note="bounded by distinct (vertex, query) pairs, never walk count")
    prog = StageProgram(stage="serve", program="superstep", sites=(site,),
                        count_bound=walks_per_query)
    admit = StageProgram(stage="serve", program="admit", sites=(),
                         count_bound=walks_per_query)
    return EngineAuditSpec(
        engine="ppr", programs=[prog, admit],
        stage_arrays={"serve": ("pos", "qid", "zeta", "key")},
        layouts={"serve": ppr_state_specs(graph.n, cap)},
        meta=dict(shards=shards, n=graph.n, Q=Q,
                  walks_per_query=walks_per_query))
