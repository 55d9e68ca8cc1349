"""Mixture-of-Experts FFN: top-k routing, capacity dispatch, shared experts.

The JAX package's `repro.models.moe`: assignments are ranked within their
expert by a stable sort, tokens beyond an expert's capacity are dropped,
and the kept ones are gathered into expert buffers [E, C, d], run through
the expert FFNs, and combined with their gate weights. A Switch-style
load-balance aux loss is returned. DeepSeek-style shared experts run as a
dense MLP on every token and are added to the routed output. The integer
paths (ranks, capacities, buffer slots) match JAX bit for bit.

Two paths: the gather path on all tokens, and `moe_forward_sharded`,
taken under sharding rules whose mesh has a "model" axis: tokens stay on
their data shard, each expert's hidden dim is split over the model axis,
and the partial outputs are summed over it. On a stacked mesh
(`launch.mesh.make_stacked_mesh`) every shard lives on one card, so the
shards run in turn and the collectives are sums and means over them; on
a process mesh (`launch.mesh.make_process_mesh`) each rank runs its own
shard and the collectives are `sharding.collectives`' over its groups.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
from torch import nn

from repro_torch.models.common import (COMPUTE_DTYPE, dense_init, param,
                                       recomputing)
from repro_torch.models.mlp import MLP, activation, is_gated, mlp_forward
from repro_torch.sharding import collectives as coll
from repro_torch.sharding.layout import (gathered, global_shape, mesh_rules,
                                         placement)
from repro_torch.sharding.rules import current_rules


def _rank_within(ids: torch.Tensor) -> torch.Tensor:
    """Rank of each element within its equal-value group (stable order)."""
    N = ids.shape[0]
    order = torch.argsort(ids, stable=True)
    sorted_ids = ids[order]
    idx = torch.arange(N, device=ids.device)
    is_start = torch.ones(N, dtype=torch.bool, device=ids.device)
    is_start[1:] = sorted_ids[1:] != sorted_ids[:-1]
    run_start = torch.cummax(torch.where(is_start, idx, 0), dim=0).values
    rank = torch.empty(N, dtype=torch.int32, device=ids.device)
    rank[order] = (idx - run_start).to(torch.int32)
    return rank


class MoE(nn.Module):
    """router [d, E] float32; w_up, w_gate [E, d, f], w_down [E, f, d];
    `shared` an MLP of width f * num_shared_experts. Each expert's hidden
    dim is tensor-parallel over the model axis and d_model over data
    (FSDP at rest); the router is small and replicated."""
    AXES = dict(router=(None, "experts_router"),
                w_up=(None, "embed", "ffn"), w_down=(None, "ffn", "embed"),
                w_gate=(None, "embed", "ffn"))

    def __init__(self, cfg, *, device, gen):
        super().__init__()
        d, E = cfg.d_model, cfg.num_experts
        d_ff = cfg.moe_d_ff or cfg.d_ff
        self.router = param(dense_init(gen, (d, E), d, dtype=torch.float32,
                                       device=device))
        self.w_up = param(dense_init(gen, (E, d, d_ff), d, device=device))
        self.w_down = param(dense_init(gen, (E, d_ff, d), d_ff,
                                       device=device))
        self.w_gate = (param(dense_init(gen, (E, d, d_ff), d, device=device))
                       if is_gated(cfg.mlp) else None)
        self.shared = (MLP(d, d_ff * cfg.num_shared_experts, cfg.mlp,
                           device=device, gen=gen)
                       if cfg.num_shared_experts else None)
        # assignments dropped at capacity, summed over the calls since it
        # was last set to zero (a tensor: reading it waits for the card)
        self.dropped = torch.zeros((), dtype=torch.int64, device=device)


def capacity_for(cfg, tokens: int) -> int:
    c = int(math.ceil(tokens * cfg.num_experts_per_tok * cfg.capacity_factor
                      / cfg.num_experts))
    # large capacities round to 512 (the JAX package shards the buffers'
    # C dim over its data axes); small ones stay fine-grained
    mult = 512 if c > 4096 else 8
    return max(8, -(-c // mult) * mult)


def route(logits: torch.Tensor, k: int):
    """(gates [N, E], weights [N, k] renormalised, experts [N, k])."""
    gates = torch.softmax(logits, dim=-1)
    weights, experts = torch.topk(gates, k, dim=-1)
    weights = weights / torch.clamp(weights.sum(dim=-1, keepdim=True),
                                    min=1e-9)
    return gates, weights, experts


def _dispatch_compute_combine(xf, logits, w_gate, w_up, w_down, cfg,
                              f_slice_partial: bool = False,
                              vary=lambda t: t):
    """Dispatch, expert FFNs and combine on the tokens xf [N, d] (one
    data shard's, or all). Expert weights are [E, d, f_loc] / [E, f_loc,
    d]; with `f_slice_partial`, f_loc is a slice of the hidden dim and the
    returned out is a partial sum awaiting the sum over the model axis.
    `vary` marks the tokens and the gate weights where each model rank
    takes its own part of them (`coll.pvary` on a process mesh).
    Returns (out [N, d] float32, load [E], importance [E], dropped)."""
    N, d = xf.shape
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    C = capacity_for(cfg, N)
    gates, weights, experts = route(logits, k)
    load = torch.zeros(E, dtype=torch.float32, device=xf.device).index_add_(
        0, experts.reshape(-1), torch.ones(N * k, device=xf.device)) \
        / (N * k)
    importance = gates.mean(dim=0)

    flat_e = experts.reshape(-1).to(torch.int32)                  # [N*k]
    rank = _rank_within(flat_e)
    keep = rank < C
    token_of = torch.arange(N, dtype=torch.int32,
                            device=xf.device).repeat_interleave(k)
    # the token in each expert buffer slot, -1 where empty; JAX writes the
    # assignments past capacity out of range, where they are dropped: here
    # into one spare slot past the end
    buf_tok = torch.full((E * C + 1,), -1, dtype=torch.int32,
                         device=xf.device)
    buf_tok[torch.where(keep, flat_e.long() * C + rank, E * C)] = token_of
    buf_tok = buf_tok[:E * C].reshape(E, C)
    x_e = torch.where((buf_tok >= 0)[..., None],
                      vary(xf)[torch.clamp(buf_tok, 0, N - 1).long()],
                      0).to(COMPUTE_DTYPE)

    up = torch.bmm(x_e, w_up.to(COMPUTE_DTYPE))
    if w_gate is not None:
        h = activation(torch.bmm(x_e, w_gate.to(COMPUTE_DTYPE)),
                       cfg.mlp) * up
    else:
        h = activation(up, cfg.mlp)
    y_e = torch.bmm(h, w_down.to(COMPUTE_DTYPE))

    gathered = y_e.reshape(E * C, d)[torch.clamp(
        flat_e.long() * C + rank, 0, E * C - 1)]
    gathered = torch.where(keep[:, None], gathered, 0)
    contrib = gathered.float() * vary(weights).reshape(-1)[:, None]
    out = torch.zeros((N, d), dtype=torch.float32,
                      device=xf.device).index_add_(0, token_of, contrib)
    return out, load, importance, (~keep).sum()


def _data_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


def moe_forward_sharded(p: MoE, x: torch.Tensor, cfg, rules
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The data-local MoE on `rules.mesh`: the batch splits over the data
    axes (pod, data) and each data shard routes its own tokens, its
    capacity from its own token count; the expert weights are sliced on
    their hidden dim (`ffn`) over `model` and gathered whole on `embed`
    over the data axes, so the only sums are the output's over `model`
    and the load and importance means over the data axes. On a stacked
    mesh each shard runs in turn on the mesh's one card; on a process mesh
    x [B_loc, T, d] is this rank's data shard (`_moe_process`). Adds the
    assignments dropped (each data shard's once) to `p.dropped`, except in
    a remat's re-run."""
    mesh = rules.mesh
    if mesh.size > 1 and not (mesh.stacked or mesh.process):
        raise NotImplementedError("a mesh of several cards runs one "
                                  "process a card over NCCL "
                                  "(launch.mesh.make_process_mesh)")
    dp = rules._axis_size(_data_axes(mesh))
    tp = mesh.shape["model"]
    B, T, d = x.shape
    f = global_shape(p.w_up)[2]
    if tp > 1 and "model" not in (
            rules.spec((None, "embed", "ffn"), global_shape(p.w_up))[2]
            or ()):
        # the JAX package would sum tp whole copies of the output here
        raise ValueError(f"the expert hidden dim {f} does not split over "
                         f"the model axis ({tp})")
    f_loc = f // tp

    def f_slice(w, dim, j):
        if placement(w) is not None:
            # a block: its model coordinate's f-slice, gathered over the
            # data axes (process meshes: `_moe_process` passes j = that
            # coordinate)
            return gathered(w)
        return w if tp == 1 else w.narrow(dim, j * f_loc, f_loc)

    if mesh.process:
        return _moe_process(p, x, cfg, mesh, f_slice)

    outs, loads, imps, dropped = [], [], [], 0
    for xl in x.reshape(dp, B // dp, T, d):
        xf = xl.reshape(-1, d)
        logits = torch.matmul(xf.float(), p.router)
        out = None
        for j in range(tp):
            part, load, imp, drop = _dispatch_compute_combine(
                xf, logits,
                None if p.w_gate is None else f_slice(p.w_gate, 2, j),
                f_slice(p.w_up, 2, j), f_slice(p.w_down, 1, j), cfg,
                f_slice_partial=tp > 1)
            out = part if out is None else out + part
        outs.append(out.to(x.dtype).reshape(B // dp, T, d))
        loads.append(load)
        imps.append(imp)
        dropped = dropped + drop
    if not recomputing():
        p.dropped += dropped
    load = torch.stack(loads).mean(dim=0)
    imp = torch.stack(imps).mean(dim=0)
    aux = cfg.num_experts * torch.sum(load * imp)
    out = outs[0] if dp == 1 else torch.cat(outs, dim=0)
    if p.shared is not None:
        out = out + mlp_forward(p.shared, x, cfg.mlp)
    return out, aux


def _moe_process(p: MoE, x: torch.Tensor, cfg, mesh, f_slice
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`moe_forward_sharded` on this rank of a process mesh: x is its data
    shard, whole on every model rank; the expert weights' f-slice of its
    model coordinate is a `narrow` of the whole parameter, so its gradient
    lands in that slice alone, or, on a model that keeps blocks, the
    block itself gathered over the data axes. The partial outputs are summed over
    `model` and load and importance averaged over the data axes; the
    tokens and gate weights enter the slices through `pvary` over
    `model`, so their gradient, and that of everything before them, is
    whole on every model rank. Each data rank adds the aux loss to its own
    loss (the train step sums those over the data ranks), so aux leaves
    through `pvary` over the data axes. `p.dropped` grows on every rank
    by the drops of all data shards."""
    B, T, d = x.shape
    data, model = mesh.group(_data_axes(mesh)), mesh.group(("model",))
    tp, j = model.shards, model.rank
    xf = x.reshape(-1, d)
    logits = torch.matmul(xf.float(), p.router)
    out, load, imp, drop = _dispatch_compute_combine(
        xf, logits,
        None if p.w_gate is None else f_slice(p.w_gate, 2, j),
        f_slice(p.w_up, 2, j), f_slice(p.w_down, 1, j), cfg,
        f_slice_partial=tp > 1,
        vary=(lambda t: coll.pvary(t, model)) if tp > 1 else (lambda t: t))
    if tp > 1:
        out = coll.psum(out, model)
    if not recomputing():
        with torch.no_grad():
            p.dropped += coll.psum(drop.reshape(1).to(torch.int64),
                                   data)[0]
    load, imp = coll.pmean(load, data), coll.pmean(imp, data)
    aux = coll.pvary(cfg.num_experts * torch.sum(load * imp), data)
    out = out.to(x.dtype).reshape(B, T, d)
    if p.shared is not None:
        out = out + mlp_forward(p.shared, x, cfg.mlp)
    return out, aux


def moe_forward(p: MoE, x: torch.Tensor, cfg) -> Tuple[torch.Tensor,
                                                       torch.Tensor]:
    """x [B,T,d] -> (out [B,T,d], aux_loss scalar); adds the assignments
    dropped at capacity to `p.dropped`, except in a remat's re-run. Takes
    `moe_forward_sharded` when sharding rules are active on a mesh with a
    "model" axis and the batch divides the data axes (on a process mesh x
    is this rank's data shard: always); else the gather path."""
    rules = current_rules()
    if placement(p.w_up) is not None:
        # a model that keeps blocks runs on its own process mesh
        rules = mesh_rules(placement(p.w_up).mesh)
    if rules is not None and "model" in rules.mesh.shape:
        dp = rules._axis_size(_data_axes(rules.mesh))
        if rules.mesh.process or x.shape[0] % dp == 0:
            return moe_forward_sharded(p, x, cfg, rules)

    B, T, d = x.shape
    xf = x.reshape(B * T, d)
    logits = torch.matmul(xf.float(), p.router)
    out, load, imp, dropped = _dispatch_compute_combine(
        xf, logits, p.w_gate, p.w_up, p.w_down, cfg)
    if not recomputing():
        p.dropped += dropped
    aux = cfg.num_experts * torch.sum(load * imp)
    out = out.to(x.dtype).reshape(B, T, d)
    if p.shared is not None:
        out = out + mlp_forward(p.shared, x, cfg.mlp)
    return out, aux
