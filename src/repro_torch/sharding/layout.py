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
