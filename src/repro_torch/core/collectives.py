"""The collective layer of the sharded engines: the port's counterpart of
`shard_map` with `jax.lax.{axis_index, all_to_all, psum}`.

A sharded engine keeps every per-shard tensor with a leading dimension of
the shards it holds locally, [S, ...], and names the global shard of each
row with `shard_ids()`. Its code is written over that leading dimension
(batched sorts and scans, segment sums offset by shard), so the same code
runs whether a process holds every shard or only its own.

Two backends, one API:

  * `StackedMesh`: all P shards live on one device as the leading
    dimension (S == P). An all_to_all is a block transpose on that device
    and a psum a sum over dim 0; no tensor leaves the device. This is how
    the JAX package runs on forced host devices, and it lets one card do
    the lane packing, routing, merging and exchange at full width.
  * `ProcessGroupMesh`: one shard per process of a `torch.distributed`
    group (S == 1, P the world size), as `shard_map` places one shard per
    device. The all_to_all is `all_to_all_single` on the contiguous lane
    buffer, a psum an `all_reduce`. The group's backend moves the tensors:
    NCCL for the card, gloo for the CPU.

Besides `all_to_all` and `psum`, both offer `pmax` (`jax.lax.pmax`), and
for use outside the rounds `gather_rows` (every shard's rows, [P, ...],
for result reads and snapshots), `local_rows` (this process's rows of a
host-built [P, ...] array), `gather_objects`, `broadcast_object` (the
writer's object on every process: a serving loop's clock and host
state), `barrier` and `writer` (whether this process writes the
snapshots). Every value that steers
control flow (a loop's end, a raise) must come out of a collective, so
that all processes take the same branch.

Each engine runs the programs of its stages inside `mesh.program(stage,
name)`, the names its `audit_spec` declares. Here the scope does nothing;
the CONGEST auditor's `analysis.congest.RecordingMesh` wraps a mesh to
record what every program call sends.
"""
from __future__ import annotations

import contextlib
import datetime
import functools
import os

import numpy as np
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

    def psum(self, x: torch.Tensor, dtype=None) -> torch.Tensor:
        """Sum of a per-shard x [S, ...] over all shards, the same on each;
        `dtype` is the sum's (torch's rule for `x.sum` when None)."""
        return x.sum(dim=0, dtype=dtype)

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        """Largest of a per-shard x [S, ...] over all shards."""
        return x.amax(dim=0)

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Every shard's rows of a per-shard x [S, ...]: [P, ...]."""
        return x

    def local_rows(self, x):
        """The rows this process holds of a host-built [P, ...] array or
        tensor: all of them here."""
        return x

    def host_rows(self, x: torch.Tensor) -> np.ndarray:
        """Every shard's rows of a per-shard x [S, ...] as a host array of
        its own, [P, ...] (for snapshots)."""
        return x.detach().cpu().numpy().copy()

    def gather_objects(self, obj) -> list:
        """Every process's `obj`, in rank order: one process here."""
        return [obj]

    def broadcast_object(self, obj):
        """The writer's `obj` on every process: this one's here."""
        return obj

    def barrier(self) -> None:
        """Wait for every process: there is one here."""

    @property
    def writer(self) -> bool:
        """Whether this process writes the snapshots and prints reports."""
        return True


class ProcessGroupMesh:
    """One shard per process of a `torch.distributed` group.

    `shards` is the group's size and this process holds the shard of its
    rank as its one local row. The group must be started; `start_group`
    starts the default one. Tensors handed to the collectives must lie on
    `device` (`cuda:<LOCAL_RANK>` by default, `cpu` when the caller names
    it): the mesh never moves a tensor through the host, and where the
    backend refuses a tensor, its error stands."""

    def __init__(self, group=None, device=None):
        import torch.distributed as dist
        if not dist.is_initialized():
            raise RuntimeError("ProcessGroupMesh needs a started process "
                               "group (collectives.start_group)")
        self._dist = dist
        self.group = group
        self.shards = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.device = (resolve_device(device) if device is not None
                       else local_device())

    def __repr__(self) -> str:
        return (f"ProcessGroupMesh(rank={self.rank}, shards={self.shards}, "
                f"device={self.device}, backend="
                f"{self._dist.get_backend(self.group)})")

    def program(self, stage: str, name: str):
        return contextlib.nullcontext()

    def shard_ids(self) -> torch.Tensor:
        return torch.tensor([self.rank], dtype=torch.int32,
                            device=self.device)

    def _check(self, what: str, x: torch.Tensor) -> None:
        if x.shape[:1] != (1,):
            raise ValueError(f"{what} of {tuple(x.shape)} on {self}: one "
                             f"local row expected")

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """Tiled all_to_all over dim 1 of x [1, P*L, *rest]: block d goes
        to rank d, and block s of the result came from rank s."""
        self._check("all_to_all", x)
        if x.shape[1] % self.shards:
            raise ValueError(f"all_to_all of {tuple(x.shape)} on {self}")
        send = x.contiguous()
        recv = torch.empty_like(send)
        self._dist.all_to_all_single(recv[0], send[0], group=self.group)
        return recv

    def psum(self, x: torch.Tensor, dtype=None) -> torch.Tensor:
        """As `StackedMesh.psum`; the local sum of a bool or an int32 x is
        int64, which every backend reduces (NCCL has no bool), unless
        `dtype` names the wire's type (int32 travels at 4 B)."""
        self._check("psum", x)
        out = x.sum(dim=0, dtype=dtype).contiguous()
        self._dist.all_reduce(out, group=self.group)
        return out

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        self._check("pmax", x)
        out = x[0].clone(memory_format=torch.contiguous_format)
        self._dist.all_reduce(out, op=self._dist.ReduceOp.MAX,
                              group=self.group)
        return out

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        self._check("gather_rows", x)
        out = torch.empty((self.shards,) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        self._dist.all_gather(list(out.unbind(0)), x[0].contiguous(),
                              group=self.group)
        return out

    def local_rows(self, x):
        return x[self.rank:self.rank + 1]

    def host_rows(self, x: torch.Tensor) -> np.ndarray:
        """`gather_rows` of x from wherever it lies (the keys stay on the
        host), uint32 words travelling as int32 bits."""
        words = x.dtype == torch.uint32
        wire = (x.view(torch.int32) if words else x).to(self.device)
        out = self.gather_rows(wire).cpu().numpy()
        return out.view(np.uint32) if words else out

    def gather_objects(self, obj) -> list:
        out = [None] * self.shards
        self._dist.all_gather_object(out, obj, group=self.group)
        return out

    def broadcast_object(self, obj):
        """Rank 0's `obj` (the others' is ignored) on every process."""
        box = [obj]
        self._dist.broadcast_object_list(box, group=self.group, group_src=0)
        return box[0]

    def barrier(self) -> None:
        self._dist.barrier(group=self.group)

    @property
    def writer(self) -> bool:
        return self.rank == 0


def local_device() -> torch.device:
    """This process's card, `cuda:<LOCAL_RANK>` (rank 0 without the
    variable); raises when there is no card."""
    resolve_device()
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))


def start_group(device=None, *, timeout: float = 600.0) -> ProcessGroupMesh:
    """Start the default process group from the environment `torchrun`
    sets (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT) and return its mesh:
    NCCL on this process's card, which becomes the current device first,
    or gloo when `device` is the CPU. `timeout` (seconds) bounds every
    collective, so a process that fails does not leave the others
    hanging."""
    import torch.distributed as dist
    dev = resolve_device(device) if device is not None else local_device()
    kw = dict(timeout=datetime.timedelta(seconds=timeout))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", device_id=dev, **kw)
    else:
        dist.init_process_group("gloo", **kw)
    return ProcessGroupMesh(device=dev)


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
