"""The collective layer of the sharded engines: the port's counterpart of
`shard_map` with `jax.lax.{axis_index, all_to_all, psum}`.

A sharded engine keeps every per-shard tensor with a leading dimension of
the shards it holds locally, [S, ...], and names the global shard of each
row with `shard_ids()`. Its code is written over that leading dimension
(batched sorts and scans, segment sums offset by shard), so the same code
runs whether a process holds every shard or only its own.

`StackedMesh` is the one backend here: all P shards live on one device as
the leading dimension (S == P). An all_to_all is a block transpose on that
device and a psum a sum over dim 0; no tensor leaves the device. This is
how the JAX package runs on forced host devices, and it lets one card do
the lane packing, routing, merging and exchange at full width.

Each engine runs the programs of its stages inside `mesh.program(stage,
name)`, the names its `audit_spec` declares. Here the scope does nothing;
the CONGEST auditor's `analysis.congest.RecordingMesh` overrides it, and
the collectives, to record what every program call sends.
"""
from __future__ import annotations

import contextlib
import functools

import torch

from repro_torch.device import resolve_device


class StackedMesh:
    """P shards held as the leading dimension of tensors on one device."""

    def __init__(self, shards: int, device=None):
        if shards < 1:
            raise ValueError(f"a mesh needs at least one shard, got {shards}")
        self.shards = int(shards)
        self.device = resolve_device(device)

    def __repr__(self) -> str:
        return f"StackedMesh(shards={self.shards}, device={self.device})"

    def program(self, stage: str, name: str):
        """The scope of one call of the program `stage/name`: a no-op
        context here."""
        return contextlib.nullcontext()

    def shard_ids(self) -> torch.Tensor:
        """[S] int32 global shard id of each local row
        (`jax.lax.axis_index`)."""
        return torch.arange(self.shards, dtype=torch.int32,
                            device=self.device)

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """Tiled all_to_all over dim 1 of x [S, P*L, *rest]: block d of
        shard s arrives at shard d as block s."""
        P = self.shards
        S, N = x.shape[:2]
        if S != P or N % P:
            raise ValueError(f"all_to_all of {tuple(x.shape)} on {self}")
        rest = tuple(x.shape[2:])
        blocks = x.reshape((P, P, N // P) + rest)
        return blocks.transpose(0, 1).reshape((P, N) + rest)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum of a per-shard x [S, ...] over all shards, the same on each."""
        return x.sum(dim=0)


def in_program(stage: str, name: str):
    """Decorator: run a step function, which takes the mesh as its keyword
    `mesh`, as one call of the program `stage/name` of that mesh."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, mesh, **kw):
            with mesh.program(stage, name):
                return fn(*args, mesh=mesh, **kw)
        return run
    return wrap
