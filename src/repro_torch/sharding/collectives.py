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
    row_parallel(x, w)
                   the row-parallel product: x @ w of this rank's rows of
                   w, summed over the group in float32 and rounded once;
                   backward: the local product's
    all_to_all(x)  block j of one dim to rank j, the blocks received
                   concatenated along another (serving's cache re-layout;
                   no gradient)

`psum` and `pmean` give a value that is the same on every rank of the
group, and each rank's code then consumes it alike: the gradient is
counted once, as JAX counts that of a replicated value once. `pvary`
marks the opposite step, a value the same on every rank that each rank
consumes in its own way (its tokens, its slice of a weight): there the
ranks' cotangents are parts of one gradient and are summed. A rank's
code must call these in the same order as every other rank of the group,
forward and backward, remat re-runs included, or the group hangs.

`reduce_scatter_`, `all_gather_` and `all_reduce_` are the plain
(no-gradient) forms over flat buffers that the ZeRO optimizer moves its
slices with; `all_to_all_v` (uneven blocks) moves a rank's blocks to
and from the ZeRO ranges. `gather_weight` is the FSDP gather of a weight
held split over the data axes (`sharding.layout`): the tiled
all_gather, whose backward reduce-scatters the gradient back into the
block.

Every collective here is noted, by kind and bytes (an all-reduce's
buffer, an all-gather's gathered output, a reduce-scatter's scattered
input, an all-to-all's sent buffer), by each `CollectiveLog` open at the
time. A `FakeGroup` stands
for a group of a mesh that has no processes (the dry run's production
meshes, on fake tensors): its collectives are noted and give tensors of
the right shape without communicating.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch
import torch.distributed as dist

_logs: List["CollectiveLog"] = []


class CollectiveLog:
    """While open (`with`), the bytes of every collective of this module,
    by kind ("all_reduce", "all_gather", "reduce_scatter", "all_to_all"),
    on any thread: `bytes[kind]`, `calls[kind]` and `total`."""

    def __init__(self):
        self.bytes: Dict[str, int] = {}
        self.calls: Dict[str, int] = {}

    @property
    def total(self) -> int:
        return sum(self.bytes.values())

    def __enter__(self):
        _logs.append(self)
        return self

    def __exit__(self, *exc):
        _logs.remove(self)


def _note(kind: str, t: torch.Tensor) -> None:
    for log in _logs:
        log.bytes[kind] = (log.bytes.get(kind, 0)
                           + t.numel() * t.element_size())
        log.calls[kind] = log.calls.get(kind, 0) + 1


@dataclasses.dataclass(frozen=True)
class FakeGroup:
    """A group of `shards` ranks of which this process plays `rank`,
    without processes: an all-reduce returns its input, an all-gather
    repeats it, a reduce-scatter takes this rank's block, an uneven
    all_to_all gives zeros of the sizes asked for. For tracing one
    rank's step on fake tensors; the values mean nothing."""
    shards: int
    rank: int
    group: None = None


def all_reduce_(x: torch.Tensor, group) -> None:
    """x := the sum of x over `group`, in place."""
    _note("all_reduce", x)
    if not isinstance(group, FakeGroup):
        dist.all_reduce(x, group=group.group)


def pmax_(x: torch.Tensor, group) -> None:
    """x := the elementwise max of x over `group`, in place (no
    gradient)."""
    _note("all_reduce", x)
    if not isinstance(group, FakeGroup):
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group.group)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    out = x.contiguous().clone()
    all_reduce_(out, group)
    return out


def _gloo_on_card(t: torch.Tensor, group) -> bool:
    """Whether `t` is a card tensor on a gloo group: gloo all-reduces and
    all-gathers (a list of) card tensors, but reduce-scatters and
    all-gathers into one tensor on the CPU only."""
    return t.is_cuda and dist.get_backend(group.group) == "gloo"


def reduce_scatter_(out: torch.Tensor, inp: torch.Tensor, group) -> None:
    """`out` [m] := the sum over the group of every rank's block `rank`
    of `inp` [shards * m] (`inp` may be overwritten)."""
    _note("reduce_scatter", inp)
    if isinstance(group, FakeGroup):
        out.copy_(inp.view(group.shards, -1)[group.rank])
    elif _gloo_on_card(inp, group):
        dist.all_reduce(inp, group=group.group)
        out.copy_(inp.view(group.shards, -1)[group.rank])
    else:
        dist.reduce_scatter_tensor(out, inp, group=group.group)


def all_gather_(out: torch.Tensor, inp: torch.Tensor, group) -> None:
    """`out` [shards * m] := every rank's `inp` [m], in rank order."""
    _note("all_gather", out)
    if isinstance(group, FakeGroup):
        out.view(group.shards, -1).copy_(inp.view(1, -1))
    elif _gloo_on_card(inp, group):
        dist.all_gather(list(out.view(group.shards, -1).unbind(0)), inp,
                        group=group.group)
    else:
        dist.all_gather_into_tensor(out, inp, group=group.group)


def all_to_all_(out: torch.Tensor, inp: torch.Tensor, group) -> None:
    """`out` [shards * m] := block `rank` of every rank's `inp` [shards *
    m], in rank order (`all_to_all_single`; gloo exchanges CPU tensors
    only, so card tensors on a gloo group go through the host)."""
    _note("all_to_all", inp)
    if isinstance(group, FakeGroup):
        out.copy_(inp)
    elif _gloo_on_card(inp, group):
        host = torch.empty(out.shape, dtype=out.dtype)
        dist.all_to_all_single(host, inp.cpu(), group=group.group)
        out.copy_(host)
    else:
        dist.all_to_all_single(out, inp, group=group.group)


def all_to_all_v(send: torch.Tensor, send_splits: List[int],
                 recv_splits: List[int], group) -> torch.Tensor:
    """The all_to_all of uneven blocks: `send` [sum(send_splits)] cut at
    `send_splits`, its block j sent to rank j; returns the blocks
    received [sum(recv_splits)], rank by rank, rank j's `recv_splits[j]`
    long (zeros of that length on a `FakeGroup`). Card tensors on a gloo
    group go through the host."""
    _note("all_to_all", send)
    recv = torch.empty(sum(recv_splits), dtype=send.dtype,
                       device=send.device)
    if isinstance(group, FakeGroup):
        return recv.zero_()
    if _gloo_on_card(send, group):
        host = torch.empty(recv.shape, dtype=recv.dtype)
        dist.all_to_all_single(host, send.cpu(), recv_splits, send_splits,
                               group=group.group)
        return recv.copy_(host)
    dist.all_to_all_single(recv, send, recv_splits, send_splits,
                           group=group.group)
    return recv


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


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of 2-D bf16 operands, its float32 sums unrounded: cuBLAS's
    float32 output on the card; float32 operands (exact) elsewhere."""
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


class _RowParallel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, group):
        ctx.save_for_backward(x, w)
        out = _mm_f32(x.reshape(-1, w.shape[0]), w)
        all_reduce_(out, group)
        return out.to(x.dtype).view(x.shape[:-1] + (w.shape[1],))

    @staticmethod
    def backward(ctx, ct):
        x, w = ctx.saved_tensors
        c = ct.reshape(-1, ct.shape[-1])
        dx = torch.matmul(c, w.t()).view(x.shape)
        dw = torch.matmul(x.reshape(-1, w.shape[0]).t(), c)
        return dx, dw, None


def row_parallel(x: torch.Tensor, w: torch.Tensor, group) -> torch.Tensor:
    """x [..., k] @ w [k, n], where x and w are this rank's columns and
    rows of a product whose k is split over `group` (a row-parallel
    projection): the partial products summed over the group in float32,
    then rounded once to x's dtype, as one device rounds the whole
    product (a sum of products rounded each would part from it by an
    ulp of each: far more, through a recurrence, than the tests allow).
    Its gradients are the local product's."""
    return _RowParallel.apply(x, w, group)


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


def all_to_all(x: torch.Tensor, group, split_dim: int, cat_dim: int
               ) -> torch.Tensor:
    """x cut into `shards` equal blocks along `split_dim`, block j sent to
    rank j; the blocks received, rank by rank, concatenated along
    `cat_dim` (`jax.lax.all_to_all(..., tiled=True)`). No gradient."""
    n = group.shards
    xs = x.movedim(split_dim, 0)
    send = xs.reshape((n, -1)).contiguous()
    recv = torch.empty_like(send)
    all_to_all_(recv.view(-1), send.view(-1), group)
    blocks = recv.view((n, xs.shape[0] // n) + xs.shape[1:]).unbind(0)
    return torch.cat([b.movedim(0, split_dim) for b in blocks], dim=cat_dim)


def gather_weight(w: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The FSDP gather: every rank's block of a weight split over `group`
    along `dim`, whole along it, in rank order; its gradient is the
    reduce-scatter (the sum over the group of each rank's cotangent, cut
    to the rank's block). `w` itself on a group of one."""
    return w if group.shards == 1 else all_gather(w, group, dim)
