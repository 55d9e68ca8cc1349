"""Personalized PageRank through the same Monte-Carlo machinery.

PPR(s) is the stationary distribution of the walk that resets to the
source distribution s instead of the uniform one. In the
terminate-at-reset Monte-Carlo formulation (Avrachenkov et al.; Bahmani
et al.) that is Algorithm 1 with every walk started from s:

    ppr_v = zeta_v * eps / W        (W walks started ~ s)

The walk-array engine already takes explicit sources, so the single-query
engine is `engine_walks` run from them. The batched engine
(`core/personalized_batch.py`) draws its starts through
`source_start_counts` too, so both engines start from the same
distribution for the same key.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core import engine_walks
from repro_torch.core.graph import CSRGraph, transition_matrix
from repro_torch.device import resolve_device

# Round cap of the terminate-at-reset walk loop. Walks terminate w.p. eps
# a round, so P(any round beyond r) <= W (1-eps)^r: at eps >= 0.1 the loop
# ends long before the cap, which only bounds a malformed (eps ~ 0) call.
DEFAULT_MAX_ROUNDS = 100_000

_START_FOLD = 0x5052_5354  # "PRST": the start-assignment substream's tag


def source_start_counts(key: torch.Tensor, weights,
                        walks_total: int) -> np.ndarray:
    """Multinomial(walks_total, weights) walk-to-source assignment, on the
    host.

    numpy's generator is seeded with the uint32 words of
    `fold_in(key, 0x50525354)`, as the JAX package seeds it, so the counts
    are the reference's for the same key; two keys give two independent
    assignments, and the draw never collides with the walk-step uniforms
    drawn from the unfolded key."""
    weights = np.asarray(weights, dtype=np.float64)
    weights = weights / weights.sum()
    words = prng.fold_in(key, _START_FOLD).numpy().astype(np.uint32)
    rng = np.random.default_rng(words.reshape(-1))
    return rng.multinomial(int(walks_total), weights)


def normalize_query(sources, weights, n: int):
    """Validate and canonicalize a (sources, weights) PPR query."""
    sources = np.asarray(sources, dtype=np.int32).reshape(-1)
    if sources.size == 0:
        raise ValueError("PPR query needs at least one source vertex")
    if sources.min() < 0 or sources.max() >= n:
        raise ValueError(f"source vertex out of range [0, {n})")
    if weights is None:
        weights = np.full(len(sources), 1.0 / len(sources))
    weights = np.asarray(weights, dtype=np.float64)
    if weights.shape != sources.shape:
        raise ValueError("weights must match sources")
    return sources, weights / weights.sum()


def personalized_pagerank(graph: CSRGraph, eps: float, sources,
                          walks_total: int,
                          key: Optional[torch.Tensor] = None, weights=None,
                          max_rounds: int = DEFAULT_MAX_ROUNDS,
                          device=None) -> torch.Tensor:
    """Monte-Carlo PPR of a seed set on `device` (the card when None).

    sources: int vertex ids [k]; weights: optional distribution over them.
    `key` drives both the walk-to-source multinomial and the walk steps:
    the same key gives the same vector bit for bit. Returns the float32
    estimator vector [n] on the device."""
    graph = graph.to(resolve_device(device))
    key = key if key is not None else prng.PRNGKey(0)
    sources, weights = normalize_query(sources, weights, graph.n)
    counts = source_start_counts(key, weights, walks_total)
    starts = torch.from_numpy(np.repeat(sources, counts).astype(np.int32))
    state = engine_walks.init_state(graph, 0, key, sources=starts)
    state = engine_walks._run_while(graph.row_ptr, graph.col_idx,
                                    graph.out_deg, state, float(eps),
                                    int(max_rounds))
    # JAX rounds the Python constant to float32 before the product
    scale = float(np.float32(eps / walks_total))
    return state.zeta.to(torch.float32) * scale


def exact_ppr(graph: CSRGraph, eps: float, sources,
              weights=None) -> np.ndarray:
    """Dense linear-solve oracle on the host, for small n:
    ppr = eps * s (I - (1-eps) Q)^-1."""
    n = graph.n
    sources = np.asarray(sources)
    s = np.zeros(n)
    if weights is None:
        s[sources] = 1.0 / len(sources)
    else:
        w = np.asarray(weights, dtype=np.float64)
        s[sources] = w / w.sum()
    Q = transition_matrix(graph, 0.0)  # the pure walk matrix
    A = np.eye(n) - (1 - eps) * Q
    return eps * np.linalg.solve(A.T, s)
