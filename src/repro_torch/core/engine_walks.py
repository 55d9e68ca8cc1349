"""Walk-array engine — Algorithm 1 as a dense array of walk positions.

A round is one launch of `walk_step`'s keyed entry, which draws each
walk's two threefry uniforms where it consumes them (as XLA fuses
`jax.random.uniform` into the step on the TPU); visit counters grow by a
histogram of the round's arrivals (the `histogram` kernel on the card).
Mathematically identical to the paper's process (walks are iid PageRank
random walks terminated at the first eps-reset); the CONGEST message
structure (per-edge *counts*, Lemma 1) is recovered for accounting by
counting the per-round edge transitions.

Two loops:
  * run(...)        — steps to exact termination (or `max_rounds`).
  * run_traced(...) — also emits a RoundTrace per round for the CONGEST
                      accounting.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch

from repro_torch import prng
from repro_torch.core.accounting import RoundTrace
from repro_torch.core.graph import CSRGraph
from repro_torch.kernels.histogram import histogram
from repro_torch.kernels.walk_step import walk_step_keyed


@dataclasses.dataclass
class WalkState:
    pos: torch.Tensor    # [W] int32 current vertex
    alive: torch.Tensor  # [W] bool
    zeta: torch.Tensor   # [n] int32 visit counters (includes start visits)
    key: torch.Tensor    # PRNG key (uint32 [2], host)
    round: int


def init_state(graph: CSRGraph, walks_per_node: int, key: torch.Tensor,
               sources: Optional[torch.Tensor] = None) -> WalkState:
    """K walks from every node (or explicit `sources`). Start counts as a visit."""
    if sources is None:
        pos = torch.arange(graph.n, dtype=torch.int32,
                           device=graph.device).repeat(walks_per_node)
    else:
        pos = sources.to(device=graph.device, dtype=torch.int32)
    zeta = torch.zeros(graph.n, dtype=torch.int32, device=graph.device)
    zeta.index_add_(0, pos, torch.ones_like(pos))
    return WalkState(pos=pos, alive=torch.ones_like(pos, dtype=torch.bool),
                     zeta=zeta, key=key, round=0)


def advance(row_ptr, col_idx, out_deg, eps: float, state: WalkState, *,
            edges: bool = False):
    """The walk decisions of one round, one keyed `walk_step` launch:
    (key, new_pos, new_alive, edge). `new_pos` keeps the old position where
    the walk did not move; `edge` (with `edges`, else None) is the edge id
    each walk moved along, -1 where it did not."""
    key, k_term, k_edge = prng.split(state.key, 3)
    # a dangling vertex is an immediate reset (Avrachenkov convention)
    out = walk_step_keyed(state.pos, state.alive, k_term, k_edge, row_ptr,
                          col_idx, out_deg, eps=eps, edges=edges)
    return (key, *out) if edges else (key, *out, None)


def _step_core(row_ptr, col_idx, out_deg, eps: float, state: WalkState, *,
               edges: bool = False):
    """One synchronous round. Returns (new_state, edge): `edge` as
    `advance` gives it."""
    key, pos, alive, edge = advance(row_ptr, col_idx, out_deg, eps, state,
                                    edges=edges)
    arrivals = histogram(torch.where(alive, pos, -1), state.zeta.shape[0])
    new_state = WalkState(pos=pos, alive=alive, zeta=state.zeta + arrivals,
                          key=key, round=state.round + 1)
    return new_state, edge


def _run_while(row_ptr, col_idx, out_deg, state: WalkState, eps: float,
               max_rounds: int) -> WalkState:
    """Step `state` until no walk is alive or `max_rounds` is reached."""
    while state.round < max_rounds and bool(state.alive.any()):
        state, _ = _step_core(row_ptr, col_idx, out_deg, eps, state)
    return state


def run(graph: CSRGraph, eps: float, walks_per_node: int, key: torch.Tensor,
        *, max_rounds: int = 100_000) -> WalkState:
    state = init_state(graph, walks_per_node, key)
    return _run_while(graph.row_ptr, graph.col_idx, graph.out_deg, state,
                      float(eps), int(max_rounds))


def _step_traced(row_ptr, col_idx, out_deg, state: WalkState, eps: float,
                 n_edges: int):
    new_state, edge = _step_core(row_ptr, col_idx, out_deg, eps, state,
                                 edges=True)
    # CONGEST payload: count of walks per edge this round (Lemma 1 messages)
    edge_counts = histogram(edge, n_edges)
    stats = dict(
        active=int(state.alive.sum()),
        moved=int(new_state.alive.sum()),
        messages=int((edge_counts > 0).sum()),
        max_edge_count=int(edge_counts.max()) if n_edges else 0,
    )
    return new_state, stats


def run_traced(graph: CSRGraph, eps: float, walks_per_node: int,
               key: torch.Tensor, *, max_rounds: int = 100_000
               ) -> Tuple[WalkState, List[RoundTrace]]:
    state = init_state(graph, walks_per_node, key)
    traces: List[RoundTrace] = []
    while state.round < max_rounds and bool(state.alive.any()):
        state, stats = _step_traced(graph.row_ptr, graph.col_idx,
                                    graph.out_deg, state, float(eps),
                                    graph.m)
        traces.append(RoundTrace(
            active_walks=stats["active"],
            messages=stats["messages"],
            max_edge_count=stats["max_edge_count"],
            total_count=stats["moved"],
        ))
    return state, traces
