"""The LM's weights at rest on a process mesh: each rank keeps its block.

The layout of the JAX package's dry run (`rules.tree_shardings` of the
parameters as the train step's `in_shardings`): `ShardingRules.spec`
with `default_rules` gives each weight's split, `embed` over the data
axes (FSDP at rest), `q_heads`, `kv_heads`, `ffn` and `vocab` over
`model`, an indivisible dim replicated; `ShardingRules.block` the slice
this rank holds. `keep_blocks_` cuts a module's parameters to their
blocks and tags each with its `Placement`; the layers read the tags:

    gathered(w)        w whole over the data axes (the FSDP all-gather
                       just before use; its gradient is reduce-scattered
                       back into the block), w itself when untagged
    model_group(w, d)  the `model` group when dim d of w is split over
                       it (tensor parallelism), else None

A parameter without a tag is whole (one device, a stacked mesh, or a
model built without `mesh=`), and the layers then compute as before.
The optimizer and the converters read `placement` and `global_shape` to
move blocks to and from the single-device layout (`train.optimizer`,
`convert`). A block's elements in a range of its whole tensor's flat
offsets are one run of the block's own order (`Grid`): `below` finds
the run's ends, `boxes` cuts it into strided views of the whole tensor,
so that a block moves to and from the ZeRO ranges of the flat state
without its whole tensor ever being built.

A serving cache on such a model is laid out as the JAX package's dry run
lays out its decode program's `cache_sh`: `ShardingRules.spec` of the
cache's axes, the rows over the data axes; a KV cache's `cache_seq` over
`model` (the flash-decoding split; every KV head whole on every rank),
a state cache's channels or heads over `model` as the rules give them
(Mamba-2's `conv` over `ffn` and `ssm` over `q_heads`, RG-LRU's `conv`
and `h` over `ffn`, Whisper's cross keys and values over `kv_heads`),
an indivisible dim whole:

    cache_spec(mesh, axes, shape)   a cache leaf's spec (refuses a KV
                                    layout whose sequence stays whole on
                                    a `model` of several ranks)
    seq_group(w)                    the `model` group the sequence splits
                                    over (rank j holds positions j * S_loc
                                    onwards), None when whole
    seq_blocks(w, kv, split)        one layer's keys and values from the
                                    forward's head split to the rank's
                                    block of the sequence
    serve_rows(batch, mesh)         the rows of a global batch a rank
                                    serves
    cut_blocks / whole_blocks       a whole tree to a rank's blocks and
                                    back (every rank calls the latter)
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from repro_torch.sharding import collectives as coll
from repro_torch.sharding.rules import (PartitionSpec, ShardingRules,
                                        default_rules)

# the mesh axes a weight's `embed` dim splits over (FSDP), and the one
# tensor parallelism runs over (`launch.mesh`'s DATA_AXES and MODEL_AXES)
DATA_AXES = ("pod", "data")
MODEL_AXES = ("model",)


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where a parameter's block lies: the process mesh, the whole
    tensor's spec and shape, and the slice of each dim this rank holds."""
    mesh: object
    spec: PartitionSpec
    shape: Tuple[int, ...]
    index: Tuple[slice, ...]

    def axes(self, dim: int) -> Tuple[str, ...]:
        part = self.spec[dim]
        if part is None:
            return ()
        return part if isinstance(part, tuple) else (part,)

    def replicated_over(self) -> Tuple[str, ...]:
        """The mesh axes of size > 1 that split no dim: the ranks along
        them hold the same block."""
        used = {a for d in range(len(self.shape)) for a in self.axes(d)}
        return tuple(a for a, n in self.mesh.shape.items()
                     if n > 1 and a not in used)


class Grid(NamedTuple):
    """A block of a tensor as the offsets of its elements in the whole
    tensor's flat (row-major) order: `base` that of its first element,
    `dims` (whole stride, extent, block stride) a dim, outermost first.
    A dim the block spans whole is merged into the next outer one, and a
    dim the block is one wide is dropped (its start is in `base`). The
    block's own row-major order over `dims` is its order as a tensor, in
    which the offsets strictly increase: the block's elements in one
    range of offsets are one run of its own order."""
    base: int
    dims: Tuple[Tuple[int, int, int], ...]


def block_grid(shape: Tuple[int, ...], index: Tuple[slice, ...]) -> Grid:
    """The `Grid` of the block `index` (unit-step slices, a `Placement`'s
    `index`) of a tensor of `shape`."""
    dims = []                  # [stride, size, start, extent], outer first
    stride = 1
    for n, sl in reversed(list(zip(shape, index))):
        start, stop, step = sl.indices(n)
        if step != 1:
            raise ValueError(f"a block's slices have unit steps: {index}")
        if dims and dims[0][3] == dims[0][1]:      # the inner dim is whole
            inner = dims[0]
            dims[0] = [inner[0], n * inner[1], start * inner[1],
                       (stop - start) * inner[1]]
        else:
            dims.insert(0, [stride, n, start, stop - start])
        stride *= n
    base = sum(d[0] * d[2] for d in dims)
    out, block_stride = [], 1
    for w, _, _, extent in reversed(dims):
        if extent != 1:
            out.insert(0, (w, extent, block_stride))
            block_stride *= extent
    return Grid(base, tuple(out))


def below(grid: Grid, x: int) -> int:
    """How many of the block's elements lie at whole offsets below `x`:
    the elements in offsets [a, b) are its run [below(a), below(b))."""
    y = x - grid.base
    if y <= 0:
        return 0
    count = 0
    for w, extent, block_stride in grid.dims:
        q = y // w
        if q >= extent:
            return count + extent * block_stride
        count += q * block_stride
        y -= q * w
    return count + (y > 0)


def _split(extents: Tuple[int, ...], j0: int, j1: int) -> list:
    """[j0, j1) of the row-major order over `extents` as boxes: [(first
    position, box shape)], at most 2 len(extents) - 1 of them."""
    if j0 >= j1:
        return []
    if len(extents) <= 1:
        return [(j0, (j1 - j0,) * len(extents))]
    inner = math.prod(extents[1:])
    q0, r0 = divmod(j0, inner)
    q1, r1 = divmod(j1, inner)

    def row(q, a, b):
        return [(q * inner + j, (1,) + s)
                for j, s in _split(extents[1:], a, b)]
    if q0 == q1:
        return row(q0, r0, r1)
    out = []
    if r0:
        out += row(q0, r0, inner)
        q0 += 1
    if q1 > q0:
        out.append((q0 * inner, (q1 - q0,) + extents[1:]))
    if r1:
        out += row(q1, 0, r1)
    return out


def boxes(grid: Grid, j0: int, j1: int) -> list:
    """The run [j0, j1) of the block's own order as boxes, each a strided
    view of the whole tensor's flat vector: [(position of its first
    element in the block's order, shape, offset of that element in the
    whole tensor, strides)]. Row-major over its shape, a box is a
    contiguous part of the run."""
    strides = tuple(w for w, _, _ in grid.dims)
    out = []
    for j, shape in _split(tuple(e for _, e, _ in grid.dims), j0, j1):
        offset = grid.base + sum((j // v) % e * w for w, e, v in grid.dims)
        out.append((j, shape, offset, strides))
    return out


def placement(t: torch.Tensor) -> Optional[Placement]:
    return getattr(t, "placement", None)


def global_shape(t: torch.Tensor) -> Tuple[int, ...]:
    """The whole tensor's shape of a block, or t's own."""
    pl = placement(t)
    return pl.shape if pl is not None else tuple(t.shape)


def global_numel(t: torch.Tensor) -> int:
    return math.prod(global_shape(t))


def is_block(t: torch.Tensor) -> bool:
    """Whether t is a strict part of its whole tensor."""
    pl = placement(t)
    return pl is not None and tuple(t.shape) != pl.shape


def mesh_rules(mesh) -> ShardingRules:
    return ShardingRules(mesh, default_rules("pod" in mesh.shape))


def keep_blocks_(module: nn.Module, mesh) -> None:
    """Cut every parameter of `module` (its own and its children's, each
    named in its class's `AXES`) to this rank's block on the process
    mesh `mesh`, tagged with its `Placement`. The whole tensor goes once
    its block is copied out."""
    rules = mesh_rules(mesh)
    for sub in module.modules():
        for name, p in list(sub.named_parameters(recurse=False)):
            if placement(p) is not None:
                continue
            shape = tuple(p.shape)
            spec = rules.spec(type(sub).AXES[name], shape)
            index = rules.block(shape, spec, mesh.coords)
            where = Placement(mesh, spec, shape, index)
            blk = p.data[index]
            if tuple(blk.shape) == shape:
                p.placement = where
                continue
            q = nn.Parameter(blk.clone(), requires_grad=p.requires_grad)
            q.placement = where
            setattr(sub, name, q)


def gathered(t: torch.Tensor) -> torch.Tensor:
    """t whole over the data axes: all-gathered along each dim they split
    (`collectives.gather_weight`); t itself when untagged or when no dim
    is split over them."""
    pl = placement(t)
    if pl is None:
        return t
    for dim in range(t.ndim):
        axes = pl.axes(dim)
        if axes and set(axes) <= set(DATA_AXES):
            t = coll.gather_weight(t, pl.mesh.group(DATA_AXES), dim)
    return t


def model_group(t: torch.Tensor, dim: int):
    """The `model` group when dim `dim` of the block t is split over it
    between more than one rank; None otherwise (untagged, replicated)."""
    pl = placement(t)
    if pl is None or pl.axes(dim) != MODEL_AXES:
        return None
    group = pl.mesh.group(MODEL_AXES)
    return group if group.shards > 1 else None


def block_start(t: torch.Tensor, dim: int) -> int:
    """Where the block t starts along `dim` of its whole tensor."""
    pl = placement(t)
    return 0 if pl is None else pl.index[dim].start


def varies_over_model(t: torch.Tensor) -> bool:
    """Whether the ranks of a `model` group hold different blocks of t."""
    pl = placement(t)
    return pl is not None and any(
        pl.axes(d) == MODEL_AXES for d in range(len(pl.shape))) and \
        pl.mesh.shape.get("model", 1) > 1


def whole(t: torch.Tensor) -> torch.Tensor:
    """The whole tensor of the block t on every rank (all-gathered over
    each axis that splits it; no gradient); t itself when it is whole."""
    if not is_block(t):
        return t.detach()
    pl = placement(t)
    out = t.detach()
    with torch.no_grad():
        for dim in range(out.ndim):
            axes = pl.axes(dim)
            if axes:
                group = pl.mesh.group(DATA_AXES if set(axes) <= set(
                    DATA_AXES) else MODEL_AXES)
                out = coll.gather_weight(out, group, dim)
    return out


# ---------------------------------------------------------------------------
# serving caches
# ---------------------------------------------------------------------------

def cache_spec(mesh, axes, shape) -> PartitionSpec:
    """The spec of a cache leaf of `shape` with logical `axes` on `mesh`.
    Raises where a leaf's `cache_seq` stays whole (its length does not
    divide over `model`) while `model` has several ranks: the rules would
    then split the KV heads instead, a layout the port's decode does not
    take. A state leaf (no `cache_seq`) takes the rules' spec as it is."""
    spec = mesh_rules(mesh).spec(axes, shape)
    if "cache_seq" in axes and mesh.shape.get("model", 1) > 1:
        d = axes.index("cache_seq")
        if spec[d] != MODEL_AXES[0]:
            raise ValueError(f"a cache of {shape[d]} positions does not "
                             f"split over model={mesh.shape['model']}: the "
                             "decode layout splits the sequence")
    return spec


def seq_group(t: torch.Tensor):
    """The `model` group over which a serving cache's sequence splits on
    the model whose parameter t is (its rank j holds positions j * S_loc
    to (j + 1) * S_loc); None on whole weights or a `model` of one."""
    pl = placement(t)
    if pl is None or pl.mesh.shape.get("model", 1) == 1:
        return None
    return pl.mesh.group(MODEL_AXES)


def seq_blocks(w: torch.Tensor, kv, split: bool):
    """One layer's cache entries {name: [B, S, ...]} from the forward's
    head split to the decode layout on the model whose parameter w is:
    the rank's block of the sequence with every KV head, by one
    all_to_all over `model` where `split` (the forward gave the rank its
    own KV heads), else the rank's slice of the whole heads. As they are
    on whole weights or a `model` of one."""
    group = seq_group(w)
    if group is None:
        return kv
    rows, S = next(iter(kv.values())).shape[:2]
    cache_spec(placement(w).mesh, ("batch", "cache_seq"), (rows, S))
    n_loc = S // group.shards
    return {n: (coll.all_to_all(t, group, 1, 2) if split else
                t.narrow(1, n_loc * group.rank, n_loc).clone())
            for n, t in kv.items()}


def serve_rows(batch: int, mesh) -> slice:
    """The rows of a global batch of `batch` sequences that this rank of
    the process mesh serves: its block over the data axes, or all of
    them where `batch` does not divide over those."""
    rules = mesh_rules(mesh)
    return rules.block((batch,), rules.spec(("batch",), (batch,)),
                       mesh.coords)[0]


def tree_map(fn, tree, *others):
    """fn over the leaves of a tree of nested dicts (and of `others`, of
    the same structure, leaf beside leaf)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(o[k] for o in others))
                for k, v in tree.items()}
    return fn(tree, *others)


def block_shapes(shapes, axes, mesh):
    """A tree of whole shapes cut to this rank's block shapes."""
    rules = mesh_rules(mesh)
    return tree_map(lambda s, a: rules.local_shape(
        tuple(s), cache_spec(mesh, a, tuple(s))), shapes, axes)


def cut_blocks(tree, axes, mesh):
    """A tree of whole tensors (a cache of one device) cut to this rank's
    blocks (copies), each leaf by `cache_spec` of its logical `axes`."""
    rules = mesh_rules(mesh)

    def cut(t, a):
        shape = tuple(t.shape)
        return t[rules.block(shape, cache_spec(mesh, a, shape),
                             mesh.coords)].clone()
    return tree_map(cut, tree, axes)


def whole_blocks(tree, axes, shapes, mesh):
    """`cut_blocks` undone: every rank's blocks of a tree gathered into
    the whole tensors of `shapes`, on every rank (each must call it)."""
    def gather(t, a, shape):
        spec = cache_spec(mesh, a, tuple(shape))
        for dim, part in enumerate(spec):
            if part is None:
                continue
            axes_d = part if isinstance(part, tuple) else (part,)
            group = mesh.group(DATA_AXES if set(axes_d) <= set(DATA_AXES)
                               else MODEL_AXES)
            t = coll.gather_weight(t, group, dim)
        return t
    with torch.no_grad():
        return tree_map(gather, tree, axes, shapes)
