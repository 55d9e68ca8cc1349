"""IMPROVED-PAGERANK-ALGORITHM (Algorithm 2) and the Section-5
directed/LOCAL variant, on one device.

Three phases, as in the paper:

  Phase 1 — every node v pre-computes short PageRank walks of length
    lambda = ceil(sqrt(log n)): d(v)*eta of them in the undirected/CONGEST
    setting (Lemma 2: visits grow with degree), or a uniform per-node pool
    in the directed/LOCAL setting (Section 5). Trajectories and the edge
    ids taken are recorded; a short walk may terminate early when its
    eps-reset fires.

  Phase 2 — each of the n*K long walks stitches unused coupons at connector
    nodes (O(1) rounds per stitch). Coupons are consumed in natural order,
    which is distributionally the same as uniform-without-replacement
    because coupons are iid and the order of consumption does not depend on
    their outcomes. A walk whose connector's pool ran dry (eta too small)
    falls back to naive walking, counted in `exhausted_walks`.

  Phase 3 — visits of the used coupons are counted from the recorded
    trajectories (the edge ids make the reverse-trace accounting exact);
    unfinished walks complete naively to their own eps-reset, so the
    estimator stays unbiased.

Estimator: pi_v = zeta_v * eps / (n*K), as in Algorithm 1.

The draws are the JAX package's, bit for bit: Phase 1 and the tail draw
their threefry uniforms inside the keyed `walk_step` launch of each step,
and every count of ids (the per-edge traces, the Phase-2 requests, the
Phase-3 visits) runs through the `histogram` kernel on the card.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core.accounting import (CongestReport, RoundTrace,
                                         default_bandwidth)
from repro_torch.core.engine_walks import WalkState, _step_traced
from repro_torch.core.estimator import pagerank_from_visits
from repro_torch.core.graph import CSRGraph
from repro_torch.core.simple_pagerank import (PageRankResult,
                                              walks_per_node_for)
from repro_torch.device import resolve_device
from repro_torch.kernels.histogram import histogram
from repro_torch.kernels.walk_step import walk_step_keyed_

_I32 = torch.int32


@dataclasses.dataclass
class ImprovedResult(PageRankResult):
    lam: int = 0
    eta: int = 0
    stitch_iterations: int = 0
    phase1_rounds: int = 0
    phase2_rounds: int = 0
    phase3_rounds: int = 0
    tail_rounds: int = 0
    exhausted_walks: int = 0
    coupons_created: int = 0
    coupons_used: int = 0


def coupon_pool_sizes(graph: CSRGraph, eps: float, walks_per_node: int,
                      lam: int, *, eta: Optional[int] = None,
                      eta_safety: float = 2.0,
                      degree_proportional: bool = True,
                      ell: Optional[int] = None) -> Tuple[int, np.ndarray]:
    """Phase-1 coupon pool sizes, shared by every Algorithm-2 engine
    (host numpy). Returns (eta, pool_size[n] int64).

    Degree-proportional (undirected/CONGEST, Lemma 2): d(v)*eta coupons a
    node, eta sized from the expected stitches a node: a long walk has
    expected length 1/eps, so ~1/(eps*lam) + 1 stitches, whose connectors
    land in proportion to d(v)/sum(d); times `eta_safety`. Isolated
    vertices get one coupon, so every request resolves.

    Uniform (directed/LOCAL, Section 5, `degree_proportional=False`): every
    node gets eta*ceil(log n) coupons with eta = ceil(eta_safety * K * ell
    / lam); needs `ell` (the walk length cap) unless `eta` is given.
    """
    deg_np = graph.numpy()[2]
    n = graph.n
    if degree_proportional:
        if eta is None:
            exp_stitches = n * walks_per_node * (1.0 / (eps * lam) + 1.0)
            eta = max(1, int(math.ceil(
                eta_safety * exp_stitches / max(deg_np.sum(), 1))))
        return int(eta), np.maximum(deg_np.astype(np.int64) * eta, 1)
    if eta is None:
        if ell is None:
            raise ValueError("uniform pool sizing needs ell (or explicit eta)")
        eta = max(1, int(math.ceil(eta_safety * walks_per_node * ell / lam)))
    log_n = math.log(max(n, 2))
    per_node = int(eta) * max(1, int(math.ceil(log_n)))
    return int(eta), np.full(n, per_node, dtype=np.int64)


# ---------------------------------------------------------------------------
# Phase 1: short walks with trajectory and edge-id recording
# ---------------------------------------------------------------------------

def _phase1_scan(row_ptr, col_idx, out_deg, src: torch.Tensor,
                 key: torch.Tensor, eps: float, lam: int) -> dict:
    """`lam` steps of every coupon from `src` [S]. Step i draws with the
    i-th key of `split(key, lam)`, split again into the termination and
    edge keys, one uniform of each a coupon: one keyed `walk_step_`
    launch, in place on a copy of `src` (the caller keeps `src`), which
    draws them where it consumes them and writes its edge ids straight
    into the step's row of the edge table."""
    S, dev = src.shape[0], src.device
    traj = torch.empty((lam, S), dtype=_I32, device=dev)
    edges = torch.empty((lam, S), dtype=_I32, device=dev)
    moved = torch.empty((lam, S), dtype=torch.bool, device=dev)
    pos = src.clone()
    alive = torch.ones(S, dtype=torch.bool, device=dev)
    for i, k in enumerate(prng.split(key, lam)):
        k_term, k_edge = prng.split(k)
        walk_step_keyed_(pos, alive, k_term, k_edge, row_ptr, col_idx,
                         out_deg, eps=eps, edge=edges[i])
        traj[i] = pos
        moved[i] = alive
    return dict(traj=traj, edges=edges, moved=moved, dest=pos,
                valid_arrivals=moved.sum(dim=0, dtype=_I32),
                terminated=~moved[-1])


def _edge_traces(edges: torch.Tensor, moved: torch.Tensor, m: int,
                 mask: Optional[torch.Tensor] = None) -> List[RoundTrace]:
    """Per-step CONGEST accounting from the recorded edge ids ([lam, S]):
    the walks that moved on each edge, counted by the `histogram` kernel."""
    traces = []
    for i in range(edges.shape[0]):
        mv = moved[i] if mask is None else (moved[i] & mask)
        counts = histogram(torch.where(mv, edges[i], -1), m)
        traces.append(RoundTrace(
            active_walks=int(mv.sum()),
            messages=int((counts > 0).sum()),
            max_edge_count=int(counts.max()) if m else 0,
            total_count=int(counts.sum(dtype=torch.int64))))
    return traces


# ---------------------------------------------------------------------------
# Phase 2: stitching
# ---------------------------------------------------------------------------

def run_starts(is_start: torch.Tensor) -> torch.Tensor:
    """For a flat 1-D flag of run starts (element 0 a start), the index of
    the start of each element's run: the running maximum of the start
    indices, built from a running count and a gather, since torch scans a
    running maximum of a long 1-D tensor in one block."""
    run = torch.cumsum(is_start, 0) - 1
    return torch.nonzero(is_start).reshape(-1).index_select(0, run)


def _allocate_coupons(cur, active, next_coupon, pool_start, pool_size):
    """Give each active walk a distinct next-unused coupon of its connector.

    Returns (coupon_id [-1 if exhausted or inactive], ok, new_next_coupon).
    Walks at the same connector take consecutive offsets in walk order: a
    stable sort by connector and the rank within its run.
    """
    W = cur.shape[0]
    n = next_coupon.shape[0]
    dev = cur.device
    vid = torch.where(active, cur, n)      # inactive walks sort to the end
    sorted_v, order = torch.sort(vid, stable=True)
    idx = torch.arange(W, device=dev)
    is_start = torch.ones(W, dtype=torch.bool, device=dev)
    is_start[1:] = sorted_v[1:] != sorted_v[:-1]
    rank = torch.empty(W, dtype=_I32, device=dev)
    rank[order] = (idx - run_starts(is_start)).to(_I32)
    c = torch.clamp(cur, 0, n - 1).long()
    offset = next_coupon.index_select(0, c) + rank
    ok = active & (offset < pool_size.index_select(0, c))
    coupon_id = torch.where(ok, pool_start.index_select(0, c) + offset, -1)
    req = histogram(torch.where(active, cur, -1).to(_I32), n)
    # the pool pointer advances by the requests (the paper deletes coupons
    # on sampling), clipped to the pool size
    new_next = torch.minimum(next_coupon + req, pool_size)
    return coupon_id, ok, new_next


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def improved_pagerank(
    graph: CSRGraph,
    eps: float,
    *,
    walks_per_node: int | None = None,
    lam: int | None = None,
    eta: int | None = None,
    key: torch.Tensor | None = None,
    degree_proportional: bool = True,
    local_model: bool = False,
    eta_safety: float = 2.0,
    bandwidth_bits: int | None = None,
    device=None,
) -> ImprovedResult:
    """Algorithm 2 (undirected/CONGEST), or Section 5 (directed/LOCAL with
    `degree_proportional=False, local_model=True`), on `device` (the card
    when None; the graph moves there)."""
    graph = graph.to(resolve_device(device))
    dev = graph.device
    n, m = graph.n, graph.m
    key = key if key is not None else prng.PRNGKey(0)
    K = walks_per_node or walks_per_node_for(n, eps)
    log_n = math.log(max(n, 2))
    if lam is None:
        lam = max(1, int(math.ceil(math.sqrt(log_n if not local_model
                                             else log_n / eps))))
    ell = max(lam + 1, int(math.ceil(log_n / eps)))

    eta, pool_size_np = coupon_pool_sizes(
        graph, eps, K, lam, eta=eta, eta_safety=eta_safety,
        degree_proportional=degree_proportional, ell=ell)

    pool_start_np = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(pool_size_np, out=pool_start_np[1:])
    S = int(pool_start_np[-1])
    if S >= 2 ** 31:
        raise ValueError(f"{S} coupons exceed the int32 coupon ids")
    pool_size = torch.from_numpy(pool_size_np.astype(np.int32)).to(dev)
    src = torch.repeat_interleave(
        torch.arange(n, dtype=_I32, device=dev), pool_size.long())

    key, k1, k2, _ = prng.split(key, 4)

    # ---------------- Phase 1 ----------------
    p1 = _phase1_scan(graph.row_ptr, graph.col_idx, graph.out_deg, src, k1,
                      float(eps), int(lam))
    del src
    traces_p1 = _edge_traces(p1["edges"], p1["moved"], m)
    # +1 round: destinations report their ID to sources (direct comm)
    traces_p1.append(RoundTrace(active_walks=S, messages=S, max_edge_count=1,
                                total_count=S))

    # ---------------- Phase 2 ----------------
    pool_start = torch.from_numpy(pool_start_np[:-1].astype(np.int32)).to(dev)
    next_coupon = torch.zeros(n, dtype=_I32, device=dev)

    W = n * K
    cur = torch.arange(n, dtype=_I32, device=dev).repeat(K)
    len_done = torch.zeros(W, dtype=_I32, device=dev)
    long_term = torch.zeros(W, dtype=torch.bool, device=dev)
    exhausted = torch.zeros(W, dtype=torch.bool, device=dev)
    used = torch.zeros(S, dtype=torch.bool, device=dev)

    dest, c_term, c_len = p1["dest"], p1["terminated"], p1["valid_arrivals"]

    stitch_iters = 0
    max_iters = int(math.ceil(ell / lam)) + 3
    for _ in range(max_iters):
        active = (~long_term) & (~exhausted) & (len_done <= ell - lam)
        if not bool(active.any()):
            break
        coupon_id, ok, next_coupon = _allocate_coupons(
            cur, active, next_coupon, pool_start, pool_size)
        cid = torch.clamp(coupon_id, 0, S - 1).long()
        used[cid[ok]] = True
        cur = torch.where(ok, dest.index_select(0, cid), cur)
        len_done = torch.where(ok, len_done + c_len.index_select(0, cid),
                               len_done)
        long_term = long_term | (ok & c_term.index_select(0, cid))
        exhausted = exhausted | (active & ~ok)
        stitch_iters += 1
    del len_done, dest, c_term, c_len
    traces_p2 = [RoundTrace(active_walks=W, messages=W, max_edge_count=1,
                            total_count=W)] * stitch_iters

    # ---------------- tail: finish the unterminated walks naively --------
    tail_active = ~long_term
    tail_rounds = 0
    traces_tail: List[RoundTrace] = []
    zeta_tail = torch.zeros(n, dtype=_I32, device=dev)
    tail_walks = int(tail_active.sum())
    if tail_walks:
        # stepped in place: nothing reads `cur` or `tail_active` after it
        state = WalkState(pos=cur, alive=tail_active, zeta=zeta_tail, key=k2,
                          round=0, live=tail_walks)
        while state.live > 0:
            state, stats = _step_traced(graph.row_ptr, graph.col_idx,
                                        graph.out_deg, state, float(eps), m)
            traces_tail.append(RoundTrace(
                active_walks=stats["active"], messages=stats["messages"],
                max_edge_count=stats["max_edge_count"],
                total_count=stats["moved"]))
        zeta_tail = state.zeta
        tail_rounds = int(state.round)
        del state
    del cur, long_term, tail_active

    # ---------------- Phase 3: count the visits of used coupons ---------
    # the start visits of the W long walks, then the arrivals of the used
    # coupons: traj[i, s] counted where moved[i, s] & used[s], one step at
    # a time
    zeta = torch.full((n,), K, dtype=_I32, device=dev) + zeta_tail
    for i in range(p1["traj"].shape[0]):
        zeta += histogram(torch.where(p1["moved"][i] & used, p1["traj"][i],
                                      -1), n)
    traces_p3 = _edge_traces(p1["edges"], p1["moved"], m, mask=used)

    traces = traces_p1 + traces_p2 + traces_tail + traces_p3
    report = CongestReport(traces=traces, n=n,
                           bandwidth_bits=bandwidth_bits
                           or default_bandwidth(n))
    pi = pagerank_from_visits(zeta, n, K, eps)
    return ImprovedResult(
        pi=pi, zeta=zeta, walks_per_node=K, eps=eps,
        logical_rounds=len(traces), report=report,
        lam=int(lam), eta=int(eta), stitch_iterations=stitch_iters,
        phase1_rounds=len(traces_p1), phase2_rounds=stitch_iters,
        phase3_rounds=len(traces_p3), tail_rounds=tail_rounds,
        exhausted_walks=int(exhausted.sum()),
        coupons_created=S, coupons_used=int(used.sum()))


def directed_local_pagerank(graph: CSRGraph, eps: float, **kw
                            ) -> ImprovedResult:
    """Section 5: directed graphs in the LOCAL model — uniform per-node
    coupon pools (no degree bound available) and lambda = sqrt(log n /
    eps)."""
    kw.setdefault("degree_proportional", False)
    kw.setdefault("local_model", True)
    return improved_pagerank(graph, eps, **kw)
