"""SIMPLE-PAGERANK-ALGORITHM (Algorithm 1): the entry point.

K = c*log(n) PageRank random walks from every node, terminated at the first
eps-reset; pi_tilde_v = zeta_v * eps / (nK). Engine selectable:
  * "walks"  — walk-array engine (default, fast)
  * "counts" — faithful count-message engine (CONGEST reference)
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core import engine_counts, engine_walks
from repro_torch.core.accounting import (CongestReport, RoundTrace,
                                         default_bandwidth)
from repro_torch.core.estimator import pagerank_from_visits
from repro_torch.core.graph import CSRGraph
from repro_torch.device import resolve_device


@dataclasses.dataclass
class PageRankResult:
    pi: np.ndarray
    zeta: torch.Tensor
    walks_per_node: int
    eps: float
    logical_rounds: int
    report: Optional[CongestReport] = None

    def congest_rounds(self) -> Optional[int]:
        return self.report.congest_rounds if self.report else None


def walks_per_node_for(n: int, eps: float, delta_prime: float = 1.0) -> int:
    """K = c*log n with c = 2/(delta' * eps)  (Section 3.2)."""
    c = 2.0 / (delta_prime * eps)
    return max(1, int(math.ceil(c * math.log(max(n, 2)))))


def simple_pagerank(graph: CSRGraph, eps: float, *,
                    walks_per_node: int | None = None,
                    key: torch.Tensor | None = None, engine: str = "walks",
                    traced: bool = False, bandwidth_bits: int | None = None,
                    device=None) -> PageRankResult:
    """Algorithm 1 on `device` (the card when None; the graph moves there)."""
    graph = graph.to(resolve_device(device))
    key = key if key is not None else prng.PRNGKey(0)
    K = walks_per_node or walks_per_node_for(graph.n, eps)
    traces: List[RoundTrace] = []

    if engine == "counts":
        state, traces = engine_counts.run_traced(graph, eps, K, key)
    elif engine == "walks" and traced:
        state, traces = engine_walks.run_traced(graph, eps, K, key)
    elif engine == "walks":
        state = engine_walks.run(graph, eps, K, key)
    else:
        raise ValueError(f"unknown engine {engine!r}")
    zeta, rounds = state.zeta, state.round

    report = None
    if traces:
        report = CongestReport(traces=traces, n=graph.n,
                               bandwidth_bits=bandwidth_bits or default_bandwidth(graph.n))
    pi = pagerank_from_visits(zeta, graph.n, K, eps)
    return PageRankResult(pi=pi, zeta=zeta, walks_per_node=K, eps=eps,
                          logical_rounds=rounds, report=report)
