"""Meshes: named axes over devices.

The JAX package's `repro.launch.mesh`. A `Mesh` is an ordered `shape`
(axis name -> size) and its devices; `ShardingRules` reads only the
shape. Three kinds:

- `make_local_mesh`: the 1x1 mesh with the production axis names
  ("data", "model") on one device; sharding rules on it are the identity.
- `make_production_mesh`: 16x16 (256 devices) or 2x16x16 with "pod"
  (512), one CUDA card a device; `abstract=True` gives it without
  devices, for the dry run's per-device shapes.
- `make_stacked_mesh`: every shard on one card, as the engines'
  `core.collectives.StackedMesh` stacks their shards: code that splits
  its tensors over such a mesh loops over, or stacks, the shards, and
  its collectives are sums and means over them.
- `make_process_mesh`: one shard a process of the started
  `torch.distributed` world, each on its own card (or the CPU), as
  `jax.sharding.Mesh(np.array(devices).reshape(shape), axes)` places one
  shard a device: a rank's coordinates are row-major over the axes
  (`Mesh.coords`). `Mesh.group(axes)` is its group over each set of axes
  a collective spans, a `core.collectives.ProcessGroupMesh` over a
  subgroup: the data axes (pod, data) together, `model`, and the ZeRO
  axes (all of them); `sharding.collectives` runs over them.
- `make_rank_mesh`: one rank of such a mesh without processes, its
  groups `sharding.collectives.FakeGroup`s (the dry run's rank traces).
"""
from __future__ import annotations

import dataclasses
import datetime
import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.device import resolve_device

# the sets of axes the collectives of a training step span, in the order
# every rank creates their groups: the data axes, the tensor-parallel
# axis, the ZeRO axes (`sharding.rules.default_rules`' "zero")
DATA_AXES = ("pod", "data")
MODEL_AXES = ("model",)
ZERO_AXES = ("pod", "data", "model")


@dataclasses.dataclass(frozen=True)
class Mesh:
    shape: Dict[str, int]                  # axis name -> size, in order
    devices: Optional[Tuple[torch.device, ...]]   # None when abstract
    stacked: bool = False                  # every shard on devices[0]
    # one shard a process: this rank's coordinate on each axis, and its
    # `ProcessGroupMesh` over each set of axes a collective spans
    coords: Optional[Dict[str, int]] = None
    groups: Optional[Dict[Tuple[str, ...], object]] = None

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def process(self) -> bool:
        return self.coords is not None

    @property
    def writer(self) -> bool:
        """Whether this process writes snapshots (rank 0 of a process
        mesh, whose coordinates are all 0; the one process otherwise)."""
        return self.coords is None or not any(self.coords.values())

    def group(self, axes: Tuple[str, ...]):
        """The `core.collectives.ProcessGroupMesh` of this rank's group
        over those of `axes` the mesh has."""
        key = tuple(a for a in axes if a in self.shape)
        if not self.groups or key not in self.groups:
            raise KeyError(f"no group over {axes} on this mesh of "
                           f"{self.shape}")
        return self.groups[key]

    def barrier(self) -> None:
        """Wait for every process of a process mesh."""
        if self.process:
            import torch.distributed as dist
            dist.barrier()


def _shape(multi_pod: bool) -> Dict[str, int]:
    return ({"pod": 2, "data": 16, "model": 16} if multi_pod
            else {"data": 16, "model": 16})


def make_production_mesh(*, multi_pod: bool = False,
                         abstract: bool = False) -> Mesh:
    """16x16 = 256 cards (one pod); 2x16x16 = 512 (two pods). With more
    CUDA devices than the mesh needs, the first ones are used; with fewer
    it raises, unless `abstract`."""
    shape = _shape(multi_pod)
    need = math.prod(shape.values())
    if abstract:
        return Mesh(shape, None)
    have = torch.cuda.device_count()
    if have < need:
        raise RuntimeError(f"need {need} devices, have {have} — the "
                           "production mesh takes one CUDA device a shard")
    return Mesh(shape, tuple(torch.device("cuda", i) for i in range(need)))


def make_local_mesh(device=None) -> Mesh:
    """Degenerate 1x1 mesh with production axis names, on `device` (the
    card when None)."""
    return Mesh({"data": 1, "model": 1}, (resolve_device(device),))


def make_stacked_mesh(shape: Dict[str, int], device=None) -> Mesh:
    """A mesh of `shape` (e.g. {"data": 2, "model": 2}) whose shards all
    live on `device` (the card when None)."""
    return Mesh(dict(shape), (resolve_device(device),), stacked=True)


def make_process_mesh(shape: Dict[str, int], device=None, *,
                      timeout: float = 600.0) -> Mesh:
    """The mesh of `shape` over the processes of the started world (started
    here by `core.collectives.start_group` when it is not: NCCL on
    `cuda:<LOCAL_RANK>`, gloo when `device` is the CPU), one shard a
    process on its device. Every rank creates every subgroup, in the same
    order; `timeout` (seconds) bounds each of their collectives. Raises
    unless the world has one process a shard."""
    import os

    import torch.distributed as dist

    from repro_torch.core.collectives import (ProcessGroupMesh,
                                              local_device, start_group)
    shape = dict(shape)
    axes, sizes = tuple(shape), tuple(shape.values())
    world = (dist.get_world_size() if dist.is_initialized()
             else int(os.environ.get("WORLD_SIZE", "1")))
    if world != math.prod(sizes):
        raise RuntimeError(f"need {math.prod(sizes)} processes, have "
                           f"{world} — a process mesh of {shape} takes one "
                           "process a shard")
    if not dist.is_initialized():
        start_group(device, timeout=timeout)
    dev = resolve_device(device) if device is not None else local_device()
    rank = dist.get_rank()
    coords, rest = {}, rank
    for a, n in reversed(list(zip(axes, sizes))):
        coords[a], rest = rest % n, rest // n
    coords = {a: coords[a] for a in axes}

    def rank_of(c: Dict[str, int]) -> int:
        r = 0
        for a, n in zip(axes, sizes):
            r = r * n + c[a]
        return r

    groups = {}
    for want in (DATA_AXES, MODEL_AXES, ZERO_AXES):
        span = tuple(a for a in want if a in shape)
        if not span or span in groups:
            continue
        others = [a for a in axes if a not in span]
        # every group over `span`, the others' coordinates row-major
        for fixed in _row_major([shape[a] for a in others]):
            members = [rank_of({**dict(zip(others, fixed)),
                                **dict(zip(span, inner))})
                       for inner in _row_major([shape[a] for a in span])]
            g = dist.new_group(members,
                               timeout=datetime.timedelta(seconds=timeout))
            if rank in members:
                groups[span] = ProcessGroupMesh(g, dev)
    return Mesh(shape, (dev,), coords=coords, groups=groups)


def make_rank_mesh(shape: Dict[str, int], rank: int, device=None) -> Mesh:
    """The process mesh of `shape` as its rank `rank` sees it, without
    processes: `make_process_mesh`'s coordinates, and for each set of
    axes a collective spans a `sharding.collectives.FakeGroup` (its size,
    this rank's place in it), whose collectives are noted and move
    nothing. For tracing one rank's step on fake tensors (the dry run on
    the production meshes)."""
    from repro_torch.sharding.collectives import FakeGroup
    shape = dict(shape)
    axes, sizes = tuple(shape), tuple(shape.values())
    if not 0 <= rank < math.prod(sizes):
        raise ValueError(f"rank {rank} of a mesh of {shape}")
    coords, rest = {}, rank
    for a, n in reversed(list(zip(axes, sizes))):
        coords[a], rest = rest % n, rest // n
    coords = {a: coords[a] for a in axes}
    groups = {}
    for want in (DATA_AXES, MODEL_AXES, ZERO_AXES):
        span = tuple(a for a in want if a in shape)
        if span and span not in groups:
            idx = 0
            for a in span:
                idx = idx * shape[a] + coords[a]
            groups[span] = FakeGroup(math.prod(shape[a] for a in span), idx)
    return Mesh(shape, (resolve_device(device),), coords=coords,
                groups=groups)


def _row_major(sizes):
    """Every coordinate tuple over `sizes`, the last one fastest."""
    out = [()]
    for n in sizes:
        out = [c + (i,) for c in out for i in range(n)]
    return out
