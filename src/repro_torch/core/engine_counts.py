"""Count-based engine — the *faithful* Algorithm 1 implementation.

This engine materializes exactly the paper's CONGEST messages: per round,
every vertex v holding c_v coupons draws terminations ~ Binomial(c_v, eps)
and splits the survivors across its out-edges with a Multinomial (sampled as
the conditional-binomial chain, vectorized over all vertices). The int
matrix T[v, j] of per-edge counts *is* the message set of the round
(Lemma 1: counts, never identities).

The per-round splits run through the degree-bucketed aggregate sampler
(`core/aggregate_sampler`, one launch of the `multinomial_rows` kernel's
fused entry a round on the card), so per-round sampler work is
sum_v O(deg(v)). `bucketed=False` keeps the single-bucket max_deg-wide
layout. The per-edge counts are summed per destination by `segment_spmv`'s
exact integer entry.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core.accounting import RoundTrace
from repro_torch.core.aggregate_sampler import (build_layout,
                                                bucketize_adjacency)
from repro_torch.core.graph import CSRGraph, padded_adjacency_np
from repro_torch.kernels.multinomial_rows import multinomial_buckets
from repro_torch.kernels.multinomial_rows._math import key_words
from repro_torch.kernels.segment_spmv import hot_list, segment_sum_int


@dataclasses.dataclass
class CountState:
    counts: torch.Tensor  # [n] int32 coupons currently at each vertex
    zeta: torch.Tensor    # [n] int32 visit counters
    key: torch.Tensor     # PRNG key (uint32 [2], host)
    round: int


def init_state(graph: CSRGraph, walks_per_node: int,
               key: torch.Tensor) -> CountState:
    c0 = torch.full((graph.n,), walks_per_node, dtype=torch.int32,
                    device=graph.device)
    return CountState(counts=c0, zeta=c0.clone(), key=key, round=0)


def _step(bnbr, perm, deg, state: CountState, eps: float, n: int, layout,
          hot):
    """One super-step through the degree-bucketed sampler: every row draws
    its fused Binomial(eps) termination + conditional-binomial edge split
    (dangling rows terminate whole), then the per-edge counts route
    through one exact segment sum over the flat bucketed adjacency (`hot`:
    the hot list of `bnbr`)."""
    key, k_sample = prng.split(state.key)
    rid = torch.arange(n, dtype=torch.int32, device=deg.device)
    flat_T, _, residual = multinomial_buckets(
        state.counts, deg, rid, key_words(k_sample), perm, layout.widths,
        layout.caps, eps=eps)
    # route: new_counts[u] = sum over bucketed edge slots with dst == u
    new_counts = segment_sum_int(flat_T, bnbr, n, hot=hot)
    new_state = CountState(
        counts=new_counts,
        zeta=state.zeta + new_counts,
        key=key,
        round=state.round + 1,
    )
    stats = dict(
        active=state.counts.sum(),
        moved=flat_T.sum(),
        messages=(flat_T > 0).sum(),
        max_edge_count=flat_T.max(),
        residual=residual,  # must be 0 — multinomial exactness check
    )
    return new_state, stats


def run_traced(graph: CSRGraph, eps: float, walks_per_node: int,
               key: torch.Tensor, *, max_rounds: int = 100_000,
               bucketed: bool = True) -> Tuple[CountState, List[RoundTrace]]:
    row_ptr, col, deg = graph.numpy()
    nbr, _ = padded_adjacency_np(row_ptr, col, deg, graph.max_out_deg)
    max_deg = int(nbr.shape[1])
    layout, perm_np = build_layout(deg, max_deg, bucketed=bucketed)
    bnbr = torch.from_numpy(
        bucketize_adjacency(nbr, perm_np, layout)).to(graph.device)
    perm = torch.from_numpy(np.ascontiguousarray(perm_np)).to(graph.device)
    hot = hot_list(bnbr, graph.n)   # bnbr is the same every round
    state = init_state(graph, walks_per_node, key)
    traces: List[RoundTrace] = []
    while state.round < max_rounds and int(state.counts.sum()) > 0:
        state, stats = _step(bnbr, perm, graph.out_deg, state, float(eps),
                             graph.n, layout, hot)
        stats = {k: int(v) for k, v in stats.items()}
        if stats["residual"] != 0:
            raise RuntimeError(f"multinomial split leaked mass: residual "
                               f"{stats['residual']} in round {state.round}")
        traces.append(RoundTrace(
            active_walks=stats["active"],
            messages=stats["messages"],
            max_edge_count=stats["max_edge_count"],
            total_count=stats["moved"],
        ))
    return state, traces
