"""Power-iteration PageRank — the traditional baseline the paper argues
against in the distributed setting:

    pi_{t+1} = eps/n + (1-eps) * (Q^T pi_t + dangling_mass/n)

The push over the CSR edge list is a segment-sum, which runs through the
`segment_spmv` kernel on the card, with the hot list of the destinations
built once for all iterations.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.core.graph import CSRGraph
from repro_torch.device import resolve_device
from repro_torch.kernels.segment_spmv import hot_list, segment_spmv


def spmv_push(graph: CSRGraph, x: torch.Tensor) -> torch.Tensor:
    """y = Q^T x  where Q is the row-stochastic out-edge matrix.

    Each edge (v -> u) pushes x[v]/deg(v) into y[u].
    """
    src = graph.edge_src()
    contrib = (x.index_select(0, src)
               / graph.out_deg.index_select(0, src).to(x.dtype))
    return segment_spmv(contrib, graph.col_idx, graph.n)


def _power_iterate(col_idx, out_deg, edge_src, n: int, eps: float,
                   tol: float, max_iters: int):
    deg_e = torch.clamp(out_deg, min=1).to(torch.float32).index_select(
        0, edge_src)
    dangling = out_deg == 0
    # the float32 constants of the reference's arithmetic
    base = float(np.float32(eps) / np.float32(n))
    damp = float(np.float32(1.0) - np.float32(eps))
    tol = float(np.float32(tol))

    hot = hot_list(col_idx, n)
    x = torch.full((n,), 1.0 / n, dtype=torch.float32, device=out_deg.device)
    err, it = float("inf"), 0
    while err > tol and it < max_iters:
        y = segment_spmv(x.index_select(0, edge_src) / deg_e, col_idx, n,
                         hot=hot)
        dang_mass = torch.where(dangling, x, 0.0).sum()
        x_new = base + damp * (y + dang_mass / n)
        err = float((x_new - x).abs().sum())
        x, it = x_new, it + 1
    return x, err, it


def power_iteration(graph: CSRGraph, eps: float, *, tol: float = 1e-7,
                    max_iters: int = 10_000, device=None
                    ) -> Tuple[torch.Tensor, float, int]:
    """Returns (pi, final_l1_delta, iterations), pi on `device` (the card
    when None)."""
    graph = graph.to(resolve_device(device))
    return _power_iterate(graph.col_idx, graph.out_deg, graph.edge_src(),
                          graph.n, float(eps), float(tol), int(max_iters))
