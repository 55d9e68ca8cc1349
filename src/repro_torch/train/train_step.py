"""Training step: microbatched gradient accumulation, then AdamW.

The JAX package's `repro.train.train_step`: each microbatch's tensors
are named batch-sharded by `maybe_constrain`, as JAX's are.

    step = make_train_step(cfg, model, adam_cfg, num_microbatches)
    state = init_state(lm_param_tree(model), adam_cfg)
    state, metrics = step(state, batch)

The global batch is split into `num_microbatches` along dim 0. Each
microbatch's gradients are taken with `torch.autograd.grad` (bf16 for
bf16 parameters, as JAX's) and summed into a float32 accumulator, then
divided by the count: `.grad` is never accumulated across `backward()`
calls, which would sum in bf16. One optimizer application follows; the
model's parameters are written in place. Per-layer remat is the models'
(`models.common.ckpt`, policy from `remat_policy`).

On a process mesh (`make_train_step(..., mesh=)`, the mesh of
`launch.mesh.make_process_mesh`) `train_step` takes the global batch on
every rank and keeps its data coordinate's rows of each microbatch
(`local_rows`: JAX lays each microbatch out over the data axes), so the
model ranks of one data row take the same rows. The loss it reports is
the global-batch mean (the data ranks' mean). The gradient invariant:
once reduced, every leaf's gradient is the single-device gradient of the
global-batch loss. Each rank's gradient of its own loss is summed over
the data ranks and divided by dp. A leaf whose ranks along `model` hold
different parts of it (a block split over `model`; on whole weights the
expert weights' f-slices of `models.moe`, whose gradient lands in the
slice of the rank's model coordinate) is summed over `model` as well,
while a leaf the model ranks hold alike is computed whole by each of
them, so only model rank 0 hands it on. A block split over the data axes
comes out of its FSDP gather's backward already summed over the data
ranks, each data rank holding its own block: it is handed on once. The
ZeRO optimizer (`optimizer.apply_updates(..., mesh=)`) does the sum in
its exchange into the ZeRO ranges, whose rule of who hands a block on is
this one.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.convert import Stack, lm_param_tree
from repro_torch.sharding import collectives as coll
from repro_torch.sharding.layout import placement, varies_over_model
from repro_torch.sharding.rules import maybe_constrain
from repro_torch.train.optimizer import (AdamState, AdamWConfig,
                                         leaf_slots, apply_updates,
                                         tree_leaves, tree_map)


def split_microbatches(batch: Dict[str, torch.Tensor], n: int
                       ) -> List[Dict[str, torch.Tensor]]:
    """[B, ...] -> n dicts of [B/n, ...], in order."""
    for name, x in batch.items():
        if x.shape[0] % n:
            raise ValueError(f"{name}: batch {x.shape[0]} does not split "
                             f"into {n} microbatches")
    return [{k: x.reshape((n, x.shape[0] // n) + x.shape[1:])[i]
             for k, x in batch.items()} for i in range(n)]


def _flat(tree) -> List[torch.Tensor]:
    out = []
    for leaf in tree_leaves(tree):
        out.extend(leaf if isinstance(leaf, list) else [leaf])
    return out


def _unflat(tree, flat: List[torch.Tensor]):
    it = iter(flat)

    def leaf_of(leaf):
        if isinstance(leaf, Stack):
            return Stack([next(it) for _ in leaf], leaf.lead)
        if isinstance(leaf, list):
            return [next(it) for _ in leaf]
        return next(it)

    return tree_map(leaf_of, tree)


def accumulate_grads(model, params, batch, num_microbatches: int = 1,
                     loss_kwargs: Optional[dict] = None
                     ) -> Tuple[object, torch.Tensor]:
    """(gradients in the tree of `params`, mean loss) over the batch:
    one microbatch gives the parameters' dtype; more give their float32
    mean, accumulated as JAX accumulates them."""
    loss_kwargs = loss_kwargs or {}
    flat_p = _flat(params)
    if num_microbatches == 1:
        loss, _ = model.loss_fn(batch, **loss_kwargs)
        grads = torch.autograd.grad(loss, flat_p)
        return _unflat(params, list(grads)), loss.detach()
    acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for p in flat_p]
    loss_sum = torch.zeros((), dtype=torch.float32, device=flat_p[0].device)
    for micro in split_microbatches(batch, num_microbatches):
        micro = {k: maybe_constrain(x, ("batch",) + (None,) * (x.ndim - 1))
                 for k, x in micro.items()}
        loss, _ = model.loss_fn(micro, **loss_kwargs)
        grads = torch.autograd.grad(loss, flat_p)
        for a, g in zip(acc, grads):
            a.add_(g)            # widened to float32 inside the add
        del grads
        loss_sum = loss_sum + loss.detach()
    for a in acc:
        a.div_(num_microbatches)
    return _unflat(params, acc), loss_sum / num_microbatches


def local_rows(batch: Dict[str, torch.Tensor], mesh,
               num_microbatches: int = 1) -> Dict[str, torch.Tensor]:
    """This rank's rows of a global batch on a process mesh: of each of
    the `num_microbatches` microbatches, the block of its data coordinate
    (row-major over the data axes), microbatches in order."""
    from repro_torch.launch.mesh import DATA_AXES
    data = mesh.group(DATA_AXES)
    n, dp = num_microbatches, data.shards
    out = {}
    for name, x in batch.items():
        if x.shape[0] % (n * dp):
            raise ValueError(f"{name}: batch {x.shape[0]} does not split "
                             f"into {n} microbatches over {dp} data ranks")
        rows = x.reshape((n, dp, x.shape[0] // (n * dp)) + x.shape[1:])
        out[name] = rows[:, data.rank].reshape((-1,) + x.shape[1:])
    return out


def _varying_leaves(model, params) -> List[bool]:
    """Whether the model ranks hold different parts of each leaf of
    `params` (in leaf order): a block split over `model`, or, on whole
    weights, an expert weight of a `models.moe.MoE` (sliced over `model`
    on a process mesh)."""
    from repro_torch.models.moe import MoE
    sliced = {id(t) for m in model.modules() if isinstance(m, MoE)
              for t in (m.w_up, m.w_gate, m.w_down) if t is not None}
    out = []
    for leaf in tree_leaves(params):
        first = leaf[0] if isinstance(leaf, list) else leaf
        out.append(varies_over_model(first) if placement(first) is not None
                   else id(first) in sliced)
    return out


def rank_grads(model, params, batch, mesh, num_microbatches: int = 1,
               loss_kwargs: Optional[dict] = None
               ) -> Tuple[object, torch.Tensor]:
    """One rank's part of the gradient on a process mesh, and the global
    batch's mean loss: its rows of the global `batch`, their gradients
    (of this rank's block of each leaf on a model that keeps blocks), and
    of each leaf the model ranks hold alike, model rank 0's alone (None
    elsewhere). Their sum over the ZeRO group divided by the data-
    parallel degree is the gradient (`optimizer.apply_updates`)."""
    from repro_torch.launch.mesh import DATA_AXES
    grads, loss = accumulate_grads(
        model, params, local_rows(batch, mesh, num_microbatches),
        num_microbatches, loss_kwargs)
    with torch.no_grad():
        loss = coll.pmean(loss, mesh.group(DATA_AXES))
    if mesh.coords.get("model", 0) != 0:
        # a leaf computed alike on every model rank: rank 0's copy is the
        # one the optimizer's exchange adds up
        for (t, k), varies in zip(list(leaf_slots(grads)),
                                  _varying_leaves(model, params)):
            if not varies:
                t[k] = None
    return grads, loss


def make_train_step(cfg, model, adam_cfg: AdamWConfig,
                    num_microbatches: int = 1,
                    loss_kwargs: Optional[dict] = None,
                    mesh=None) -> Callable:
    """`train_step(state, batch) -> (state, metrics)` for `model` (whose
    parameters it makes require gradients), with `cfg` its config; on a
    process mesh `mesh`, one rank's step (see the module doc), with
    `state` its ZeRO slice (`init_state(..., mesh=mesh)`)."""
    if cfg != model.cfg:
        raise ValueError("cfg is not the model's config")
    model.requires_grad_(True)
    params = lm_param_tree(model)
    process = mesh is not None and mesh.process

    def train_step(state: AdamState, batch) -> Tuple[AdamState, dict]:
        if process:
            grads, loss = rank_grads(model, params, batch, mesh,
                                     num_microbatches, loss_kwargs)
        else:
            grads, loss = accumulate_grads(model, params, batch,
                                           num_microbatches, loss_kwargs)
        _, state, metrics = apply_updates(params, grads, state, adam_cfg,
                                          mesh=mesh if process else None)
        return state, dict(loss=loss, **metrics)

    return train_step
