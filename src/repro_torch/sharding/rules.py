"""Logical-axis sharding rules (MaxText-style).

The JAX package's `repro.sharding.rules`, for the port. Model code names
tensor dims with *logical* axes ("batch", "q_heads", "ffn", "experts",
"cache_seq", ...). A `ShardingRules` instance maps logical axes to the
axes of a mesh (`launch.mesh.Mesh`) and gives a `PartitionSpec` per
tensor: a dim mapping is dropped (replicated) where the dim does not
divide over the mesh axes it would shard over, where those axes are not
in the mesh, or where an earlier dim already took them.

`maybe_constrain` lets layer code name its activations' axes without
threading the rules through every call: `active_rules` installs them for
the calling thread. With no rules active it returns its input itself;
with rules active it checks the axes against the tensor and returns the
tensor unchanged. The port has no partitioner to hand a constraint to:
its sharded code (`models.moe.moe_forward_sharded`) splits its tensors
over the mesh itself.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Dict, Optional, Tuple

# default logical-axis -> mesh-axes mapping; "pod" exists only multi-pod
# (the JAX package's literal sets q_lora and kv_lora twice; its later (),
# the value in effect, is the one kept here)
def default_rules(multi_pod: bool) -> Dict[str, Tuple[str, ...]]:
    dp = ("pod", "data") if multi_pod else ("data",)
    return {
        "batch": dp,
        "q_heads": ("model",),
        "kv_heads": ("model",),
        "head_dim": (),
        "ffn": ("model",),
        "experts": ("model",),
        "vocab": ("model",),
        # weights: the d_model dim over the data axes (FSDP at rest)
        "embed": dp,
        "q_lora": (),
        "kv_lora": (),
        "layers": (),           # stacked, never sharded
        "seq": (),              # training seq unsharded (batch-parallel)
        "q_lora_act": (),       # activation-side latent dims replicated
        "kv_lora_act": (),
        "cache_seq": ("model",),  # decode KV split (flash-decoding layout)
        # MoE expert buffers [E, C, d]: E over model and C over data
        "moe_capacity": dp,
        "moe_tokens": dp,
        "state": (),            # SSM state
        "groups": (),
        # ZeRO: flattened optimizer state spreads over every axis available
        "zero": ("pod", "data", "model") if multi_pod else ("data", "model"),
    }


class PartitionSpec(tuple):
    """One entry a tensor dim: None (replicated), a mesh axis name, or a
    tuple of them; equal, as a tuple, to JAX's `PartitionSpec` of the same
    entries."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


@dataclasses.dataclass
class ShardingRules:
    mesh: "object"       # launch.mesh.Mesh: an ordered .shape, axis -> size
    rules: Dict[str, Tuple[str, ...]]

    def _axis_size(self, mesh_axes: Tuple[str, ...]) -> int:
        return math.prod(self.mesh.shape[a] for a in mesh_axes)

    def spec(self, logical_axes: Tuple[Optional[str], ...],
             shape: Optional[Tuple[int, ...]] = None) -> PartitionSpec:
        parts = []
        used = set()
        for i, ax in enumerate(logical_axes):
            mesh_axes = tuple(a for a in self.rules.get(ax, ()) or ()
                              if a in self.mesh.shape and a not in used)
            if not mesh_axes:
                parts.append(None)
                continue
            if shape is not None and shape[i] % self._axis_size(mesh_axes):
                # an indivisible dim (kv_heads < TP degree, odd vocab
                # sizes) is replicated
                parts.append(None)
                continue
            used.update(mesh_axes)
            parts.append(mesh_axes if len(mesh_axes) > 1 else mesh_axes[0])
        return PartitionSpec(*parts)

    def local_shape(self, shape: Tuple[int, ...],
                    spec: PartitionSpec) -> Tuple[int, ...]:
        """One device's shard of a tensor of `shape` laid out by `spec`."""
        return tuple(n if part is None else n // self._axis_size(
            part if isinstance(part, tuple) else (part,))
            for n, part in zip(shape, spec))

    def constrain(self, x, logical_axes):
        """`x`, after checking that `logical_axes` name each of its dims
        and give a spec on this mesh."""
        if len(logical_axes) != x.ndim:
            raise ValueError(f"axes {logical_axes} for a tensor of shape "
                             f"{tuple(x.shape)}")
        self.spec(logical_axes, tuple(x.shape))
        return x

    def tree_specs(self, shapes_tree, axes_tree):
        """The spec of every leaf of a tree of nested dicts, lists and
        tuples (an `AdamState`, int8 moments' (codes, scales)) whose leaves
        have `.shape`, with `axes_tree` its logical axes in the same
        structure: the JAX package's `tree_shardings`."""
        if isinstance(shapes_tree, dict):
            return {k: self.tree_specs(shapes_tree[k], axes_tree[k])
                    for k in shapes_tree}
        if isinstance(shapes_tree, (tuple, list)) and not hasattr(
                shapes_tree, "shape"):
            parts = [self.tree_specs(s, a)
                     for s, a in zip(shapes_tree, axes_tree)]
            return (type(shapes_tree)(*parts) if hasattr(shapes_tree,
                                                         "_fields")
                    else type(shapes_tree)(parts))
        return self.spec(axes_tree, tuple(shapes_tree.shape))


_local = threading.local()


@contextlib.contextmanager
def active_rules(rules: Optional[ShardingRules]):
    prev = getattr(_local, "rules", None)
    _local.rules = rules
    try:
        yield
    finally:
        _local.rules = prev


def current_rules() -> Optional[ShardingRules]:
    return getattr(_local, "rules", None)


def maybe_constrain(x, logical_axes):
    rules = getattr(_local, "rules", None)
    if rules is None:
        return x
    return rules.constrain(x, logical_axes)
