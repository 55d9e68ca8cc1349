"""Walk-array engine — Algorithm 1 as a dense array of walk positions.

A round is one launch of `walk_step`'s keyed entry, in place on the
state's `pos` and `alive`: it draws each live walk's two threefry
uniforms where it consumes them (as XLA fuses `jax.random.uniform` into
the step on the TPU) and appends the survivors' new vertices to a list,
whose length is the round's one host read; visit counters grow by a
histogram of that list (the `histogram` kernel on the card).
Mathematically identical to the paper's process (walks are iid PageRank
random walks terminated at the first eps-reset); the CONGEST message
structure (per-edge *counts*, Lemma 1) is recovered for accounting by
counting the per-round edge transitions.

Two loops, each going on while the last round moved a walk:
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
from repro_torch.kernels.walk_step import walk_step_keyed_


@dataclasses.dataclass
class WalkState:
    pos: torch.Tensor    # [W] int32 current vertex
    alive: torch.Tensor  # [W] bool
    zeta: torch.Tensor   # [n] int32 visit counters (includes start visits)
    key: torch.Tensor    # PRNG key (uint32 [2], host)
    round: int
    # walks alive, known on the host (the last round's moves); None: count
    # them from `alive` when first needed
    live: Optional[int] = None


def live_walks(state: WalkState) -> int:
    """Walks alive in `state`, read from the host's count where it has one."""
    if state.live is None:
        state.live = int(state.alive.sum())
    return state.live


def init_state(graph: CSRGraph, walks_per_node: int, key: torch.Tensor,
               sources: Optional[torch.Tensor] = None) -> WalkState:
    """K walks from every node (or explicit `sources`). Start counts as a visit."""
    if sources is None:
        pos = torch.arange(graph.n, dtype=torch.int32,
                           device=graph.device).repeat(walks_per_node)
    else:
        # a copy: the rounds step the state's buffers in place
        pos = sources.to(device=graph.device, dtype=torch.int32, copy=True)
    zeta = torch.zeros(graph.n, dtype=torch.int32, device=graph.device)
    zeta.index_add_(0, pos, torch.ones_like(pos))
    return WalkState(pos=pos, alive=torch.ones_like(pos, dtype=torch.bool),
                     zeta=zeta, key=key, round=0, live=pos.numel())


def _step_core(row_ptr, col_idx, out_deg, eps: float, state: WalkState, *,
               edges: bool = False):
    """One synchronous round, one keyed `walk_step_` launch that moves the
    walks of `state.pos` and `state.alive` in place (the new state holds
    the same buffers). Returns (new_state, edge): `edge` (with `edges`,
    else None) is the edge id each walk moved along, -1 where it did not.
    The state's only host read is the round's count of moves."""
    key, k_term, k_edge = prng.split(state.key, 3)
    arrivals = torch.empty_like(state.pos)
    edge = torch.empty_like(state.pos) if edges else None
    # a dangling vertex is an immediate reset (Avrachenkov convention)
    count = walk_step_keyed_(state.pos, state.alive, k_term, k_edge, row_ptr,
                             col_idx, out_deg, eps=eps, edge=edge,
                             arrivals=arrivals)
    moved = int(count)
    zeta = state.zeta + histogram(arrivals[:moved], state.zeta.shape[0])
    new_state = WalkState(pos=state.pos, alive=state.alive, zeta=zeta,
                          key=key, round=state.round + 1, live=moved)
    return new_state, edge


def _run_while(row_ptr, col_idx, out_deg, state: WalkState, eps: float,
               max_rounds: int) -> WalkState:
    """Step `state` until no walk is alive or `max_rounds` is reached. The
    state's `pos` and `alive` are stepped in place."""
    while state.round < max_rounds and live_walks(state) > 0:
        state, _ = _step_core(row_ptr, col_idx, out_deg, eps, state)
    return state


def run(graph: CSRGraph, eps: float, walks_per_node: int, key: torch.Tensor,
        *, max_rounds: int = 100_000) -> WalkState:
    state = init_state(graph, walks_per_node, key)
    return _run_while(graph.row_ptr, graph.col_idx, graph.out_deg, state,
                      float(eps), int(max_rounds))


def _step_traced(row_ptr, col_idx, out_deg, state: WalkState, eps: float,
                 n_edges: int):
    # the walks alive before the step: the step overwrites `alive`
    active = live_walks(state)
    new_state, edge = _step_core(row_ptr, col_idx, out_deg, eps, state,
                                 edges=True)
    # CONGEST payload: count of walks per edge this round (Lemma 1 messages)
    edge_counts = histogram(edge, n_edges)
    messages, max_count = (torch.stack([
        (edge_counts > 0).sum(), edge_counts.max().long()]).tolist()
        if n_edges else (0, 0))
    stats = dict(active=active, moved=new_state.live, messages=messages,
                 max_edge_count=max_count)
    return new_state, stats


def run_traced(graph: CSRGraph, eps: float, walks_per_node: int,
               key: torch.Tensor, *, max_rounds: int = 100_000
               ) -> Tuple[WalkState, List[RoundTrace]]:
    state = init_state(graph, walks_per_node, key)
    traces: List[RoundTrace] = []
    while state.round < max_rounds and live_walks(state) > 0:
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
