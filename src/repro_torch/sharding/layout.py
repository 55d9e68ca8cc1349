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
`convert`).

A serving cache on such a model is laid out as the JAX package's dry run
lays out its decode program's `cache_sh`: `ShardingRules.spec` of the
cache's axes, the rows over the data axes and `cache_seq` over `model`
(the flash-decoding split; every KV head whole on every rank):

    cache_spec(mesh, axes, shape)   a cache leaf's spec (refuses a layout
                                    whose sequence stays whole on a
                                    `model` of several ranks)
    seq_group(w)                    the `model` group the sequence splits
                                    over (rank j holds positions j * S_loc
                                    onwards), None when whole
    serve_rows(batch, mesh)         the rows of a global batch a rank
                                    serves
    cut_blocks / whole_blocks       a whole tree to a rank's blocks and
                                    back (every rank calls the latter)
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

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


def owner(t: torch.Tensor) -> bool:
    """Whether this rank is the one that hands on t's block among the
    ranks holding the same block (coordinate 0 on every axis it is
    replicated over)."""
    pl = placement(t)
    if pl is None:
        return True
    return not any(pl.mesh.coords[a] for a in pl.replicated_over())


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
    Raises where `cache_seq` stays whole (its length does not divide over
    `model`) while `model` has several ranks: the rules would then split
    the KV heads instead, a layout the port's decode does not take."""
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


def serve_rows(batch: int, mesh) -> slice:
    """The rows of a global batch of `batch` sequences that this rank of
    the process mesh serves: its block over the data axes, or all of
    them where `batch` does not divide over those."""
    rules = mesh_rules(mesh)
    return rules.block((batch,), rules.spec(("batch",), (batch,)),
                       mesh.coords)[0]


def _tree_map(fn, tree, *others):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(o[k] for o in others))
                for k, v in tree.items()}
    return fn(tree, *others)


def block_shapes(shapes, axes, mesh):
    """A tree of whole shapes cut to this rank's block shapes."""
    rules = mesh_rules(mesh)
    return _tree_map(lambda s, a: rules.local_shape(
        tuple(s), cache_spec(mesh, a, tuple(s))), shapes, axes)


def cut_blocks(tree, axes, mesh):
    """A tree of whole tensors (a cache of one device) cut to this rank's
    blocks (copies), each leaf by `cache_spec` of its logical `axes`."""
    rules = mesh_rules(mesh)

    def cut(t, a):
        shape = tuple(t.shape)
        return t[rules.block(shape, cache_spec(mesh, a, shape),
                             mesh.coords)].clone()
    return _tree_map(cut, tree, axes)


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
        return _tree_map(gather, tree, axes, shapes)
