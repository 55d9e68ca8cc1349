"""Sharded Section-5 engine: directed graphs in the LOCAL model.

The three-phase machinery of `distributed_improved._run_three_phase` with
what Section 5 changes, the budget policy and the round budget:

  Uniform coupon budgets. A directed graph has no Lemma-2 bound that
    relates walk visits to d(v), so every node precomputes the same
    eta*ceil(log n) short walks (`coupon_pool_sizes(...,
    degree_proportional=False)`).

  Longer short walks. With uniform budgets the short walks take
    lam = ceil(sqrt(log n / eps)) steps, the Section-5 round bound
    O(sqrt(log n / eps)), instead of ceil(sqrt(log n)).

  Directed out-edges only, dangling resets. Walks follow the CSR out-edges
    as written, and a walk at a dangling node (out-degree 0) resets at
    once: the owner's sampler terminates the whole dangling row, as
    `graph.transition_matrix` treats a dangling row (uniform teleport).

Phases 1-3 move per-vertex counts, so a hub that draws the whole pool
still costs one lane entry. The one per-walk surface is the naive tail,
where a directed hub has no degree bound on its load: `cap2` keeps the
worst-case W = n*K walk slots a shard, so nothing drops (lane backpressure
shows as `waited`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch

from repro_torch import prng
from repro_torch.core.collectives import StackedMesh
from repro_torch.core.distributed_improved import (ImprovedDistResult,
                                                   _run_three_phase,
                                                   three_phase_audit_spec)
from repro_torch.core.graph import CSRGraph
from repro_torch.core.improved_pagerank import coupon_pool_sizes
from repro_torch.core.simple_pagerank import walks_per_node_for


@dataclasses.dataclass
class DirectedDistResult(ImprovedDistResult):
    """ImprovedDistResult plus the Section-5 telemetry."""

    uniform_budget: int = 0   # coupons a node (every node gets the same)
    dangling_nodes: int = 0   # out-degree-0 vertices (immediate reset)


def distributed_directed_pagerank(
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
    device=None,
) -> DirectedDistResult:
    """The Section-5 directed/LOCAL algorithm across the shards of `mesh`
    (one shard on `device`, the card when None, if no mesh is given).

    `cap2`/`route_cap2` size only the naive tail's buffers; the checkpoint
    arguments select the checkpoint-restart supervisor over the shared
    phase machine (bit-exact recovery)."""
    mesh = mesh or StackedMesh(1, device)
    key = key if key is not None else prng.PRNGKey(0)
    n = graph.n
    K = walks_per_node or walks_per_node_for(n, eps)
    log_n = math.log(max(n, 2))
    if lam is None:
        lam = max(1, int(math.ceil(math.sqrt(log_n / eps))))
    ell = max(lam + 1, int(math.ceil(log_n / eps)))
    eta, pool_np = coupon_pool_sizes(graph, eps, K, lam, eta=eta,
                                     eta_safety=eta_safety,
                                     degree_proportional=False, ell=ell)
    # the naive tail is per-walk: the worst-case W buffer (module docstring)
    if cap2 is None:
        cap2 = n * K + mesh.shards * 64
    return _run_three_phase(
        graph, eps, K, key, mesh, pool_np=pool_np, eta=int(eta),
        lam=int(lam), ell=int(ell), cap2=cap2, route_cap2=route_cap2,
        max_rounds=max_rounds, bandwidth_bits=bandwidth_bits,
        checkpoint_dir=checkpoint_dir, fail_at=fail_at,
        checkpoint_every=checkpoint_every, max_restarts=max_restarts,
        resume=resume, result_cls=DirectedDistResult,
        uniform_budget=int(pool_np[0]),
        dangling_nodes=int((graph.out_deg == 0).sum()))


def audit_spec(graph: CSRGraph, mesh: StackedMesh, *, eps: float = 0.2,
               walks_per_node: int = 2):
    """Section-5 frontend of the three-phase audit spec: the same programs,
    uniform (LOCAL-model) coupon pools and the longer Section-5 lam, sized
    as `distributed_directed_pagerank` sizes its run."""
    n = graph.n
    K = walks_per_node
    log_n = math.log(max(n, 2))
    lam = max(1, int(math.ceil(math.sqrt(log_n / eps))))
    ell = max(lam + 1, int(math.ceil(log_n / eps)))
    _, pool_np = coupon_pool_sizes(graph, eps, K, lam,
                                   degree_proportional=False, ell=ell)
    return three_phase_audit_spec(graph, mesh, eps=eps, K=K,
                                  pool_np=pool_np, lam=lam,
                                  engine="directed")
