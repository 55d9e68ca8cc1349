"""Carrying state across from the JAX package, as numpy arrays.

The graph is this system's "weights": with the same CSR arrays and the same
PRNG key, the port computes what the JAX package computes. The sharded
engines' states carry over too, so a run started by one package can be
continued by the other.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.collectives import StackedMesh
from repro_torch.core.distributed import state_from_host
from repro_torch.core.graph import CSRGraph
from repro_torch.device import resolve_device
from repro_torch.runtime import staged_from_host


def graph_from_numpy(row_ptr, col_idx, out_deg, n: int, m: int,
                     undirected: bool, device=None) -> CSRGraph:
    """A CSRGraph on `device` (the card when None) from the int32 CSR
    arrays of a JAX `CSRGraph`."""
    device = resolve_device(device)
    row_ptr, col_idx, out_deg = (np.array(a, dtype=np.int32)
                                 for a in (row_ptr, col_idx, out_deg))
    if row_ptr.shape != (n + 1,) or col_idx.shape != (m,) \
            or out_deg.shape != (n,):
        raise ValueError("CSR arrays do not match n and m")
    return CSRGraph(row_ptr=torch.from_numpy(row_ptr).to(device),
                    col_idx=torch.from_numpy(col_idx).to(device),
                    out_deg=torch.from_numpy(out_deg).to(device),
                    n=int(n), m=int(m), undirected=bool(undirected))


def key_from_numpy(key_u32x2) -> torch.Tensor:
    """A port PRNG key from the two uint32 words of a JAX PRNG key."""
    words = np.asarray(key_u32x2, dtype=np.uint32).reshape(-1)
    if words.shape != (2,):
        raise ValueError(f"a PRNG key has 2 words, got {words.shape}")
    return torch.from_numpy(words.copy())


def dist_state_from_numpy(d: dict, device=None):
    """The walk engine's `DistState` on a stacked mesh on `device` (the
    card when None) from the dict the JAX package's
    `distributed.state_to_host` gives (or its snapshot restores): both
    packages then continue the same trajectory."""
    return state_from_host(d, StackedMesh(np.asarray(d["pos"]).shape[0],
                                          device))


def count_state_from_numpy(flat: dict, device=None):
    """The count engine's `StagedState` on `device` (the card when None)
    from a flat snapshot of the JAX package's count engine, as its
    `Checkpointer.restore` gives it. The layout schema and shard count
    stay unset: the engine supplies them when it resumes."""
    device = resolve_device(device)

    def put(name, arr):
        t = torch.from_numpy(np.array(arr))
        return t if name in ("key", "round") else t.to(device)

    return staged_from_host(flat, put)
