"""Carrying state across from the JAX package, as numpy arrays.

The graph is this system's "weights": with the same CSR arrays and the same
PRNG key, the port computes what the JAX package computes.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.graph import CSRGraph
from repro_torch.device import resolve_device


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
