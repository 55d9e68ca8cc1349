"""Collectives with gradients over the axis groups of a process mesh.

The JAX package takes these from `jax.lax` inside `shard_map`; here each
is a `torch.autograd.Function` over one group of a process mesh
(`launch.mesh.Mesh.group`: a `core.collectives.ProcessGroupMesh` over a
subgroup; `.group`, `.shards`, `.rank`), whose
backward is the transpose `jax.grad` takes through `shard_map`:

    psum(x)        all-reduce sum; backward: the cotangent as it is
    pmean(x)       all-reduce mean; backward: the cotangent / n
    pvary(x)       x as it is; backward: the all-reduce sum of the
                   cotangents
    all_gather(x)  tiled along `dim`; backward: the summed reduce-scatter

`psum` and `pmean` give a value that is the same on every rank of the
group, and each rank's code then consumes it alike: the gradient is
counted once, as JAX counts that of a replicated value once. `pvary`
marks the opposite step, a value the same on every rank that each rank
consumes in its own way (its tokens, its slice of a weight): there the
ranks' cotangents are parts of one gradient and are summed. A rank's
code must call these in the same order as every other rank of the group,
forward and backward, remat re-runs included, or the group hangs.

`reduce_scatter_` and `all_gather_` are the plain (no-gradient) forms
over flat buffers that the ZeRO optimizer moves its slices with.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, group=group.group)
    return out


def _gloo_on_card(t: torch.Tensor, group) -> bool:
    """Whether `t` is a card tensor on a gloo group: gloo all-reduces and
    all-gathers (a list of) card tensors, but reduce-scatters and
    all-gathers into one tensor on the CPU only."""
    return t.is_cuda and dist.get_backend(group.group) == "gloo"


def reduce_scatter_(out: torch.Tensor, inp: torch.Tensor, group) -> None:
    """`out` [m] := the sum over the group of every rank's block `rank`
    of `inp` [shards * m] (`inp` may be overwritten)."""
    if _gloo_on_card(inp, group):
        dist.all_reduce(inp, group=group.group)
        out.copy_(inp.view(group.shards, -1)[group.rank])
    else:
        dist.reduce_scatter_tensor(out, inp, group=group.group)


def all_gather_(out: torch.Tensor, inp: torch.Tensor, group) -> None:
    """`out` [shards * m] := every rank's `inp` [m], in rank order."""
    if _gloo_on_card(inp, group):
        dist.all_gather(list(out.view(group.shards, -1).unbind(0)), inp,
                        group=group.group)
    else:
        dist.all_gather_into_tensor(out, inp, group=group.group)


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, ct):
        return ct, None


class _PMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.n = group.shards
        return _all_reduce(x, group) / group.shards

    @staticmethod
    def backward(ctx, ct):
        return ct / ctx.n, None


class _PVary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        return _all_reduce(ct, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        xs = x.movedim(dim, 0).contiguous()
        out = torch.empty((group.shards * xs.shape[0],) + xs.shape[1:],
                          dtype=x.dtype, device=x.device)
        all_gather_(out.view(-1), xs.view(-1), group)
        return out.movedim(0, dim)

    @staticmethod
    def backward(ctx, ct):
        group, dim = ctx.group, ctx.dim
        cs = ct.movedim(dim, 0).contiguous()
        out = torch.empty((cs.shape[0] // group.shards,) + cs.shape[1:],
                          dtype=ct.dtype, device=ct.device)
        reduce_scatter_(out.view(-1), cs.view(-1), group)
        return out.movedim(0, dim), None, None


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of x over `group` (`jax.lax.psum`)."""
    return _PSum.apply(x, group)


def pmean(x: torch.Tensor, group) -> torch.Tensor:
    """The mean of x over `group` (`jax.lax.pmean`)."""
    return _PMean.apply(x, group)


def pvary(x: torch.Tensor, group) -> torch.Tensor:
    """x, whose gradient is summed over `group` (`jax.lax.pvary`)."""
    return _PVary.apply(x, group)


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's x concatenated along `dim`, in rank order
    (`jax.lax.all_gather(..., tiled=True)`)."""
    return _AllGather.apply(x, group, dim)
