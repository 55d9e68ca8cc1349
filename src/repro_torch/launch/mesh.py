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
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    shape: Dict[str, int]                  # axis name -> size, in order
    devices: Optional[Tuple[torch.device, ...]]   # None when abstract
    stacked: bool = False                  # every shard on devices[0]

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())


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
