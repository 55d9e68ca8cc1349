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
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.convert import Stack, lm_param_tree
from repro_torch.sharding.rules import maybe_constrain
from repro_torch.train.optimizer import (AdamState, AdamWConfig,
                                         apply_updates, tree_leaves,
                                         tree_map)


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


def make_train_step(cfg, model, adam_cfg: AdamWConfig,
                    num_microbatches: int = 1,
                    loss_kwargs: Optional[dict] = None) -> Callable:
    """`train_step(state, batch) -> (state, metrics)` for `model` (whose
    parameters it makes require gradients), with `cfg` its config."""
    if cfg != model.cfg:
        raise ValueError("cfg is not the model's config")
    model.requires_grad_(True)
    params = lm_param_tree(model)

    def train_step(state: AdamState, batch) -> Tuple[AdamState, dict]:
        grads, loss = accumulate_grads(model, params, batch,
                                       num_microbatches, loss_kwargs)
        _, state, metrics = apply_updates(params, grads, state, adam_cfg)
        return state, dict(loss=loss, **metrics)

    return train_step
