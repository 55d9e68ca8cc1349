"""Graph representation for the PageRank engines.

CSR over int32 tensors on one device, built on the host with numpy.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class CSRGraph:
    """Compressed-sparse-row adjacency (out-edges).

    Attributes:
      row_ptr: [n+1] int32, row_ptr[v]..row_ptr[v+1] slice of col_idx.
      col_idx: [m] int32 destination vertex of each out-edge.
      out_deg: [n] int32 out-degree (== diff of row_ptr, kept for fast gather).
      n, m:    sizes.
      undirected: True if the edge set is symmetric.
    """

    row_ptr: torch.Tensor
    col_idx: torch.Tensor
    out_deg: torch.Tensor
    n: int
    m: int
    undirected: bool

    @property
    def device(self) -> torch.device:
        return self.row_ptr.device

    @property
    def max_out_deg(self) -> int:
        return int(self.out_deg.max()) if self.n else 0

    def edge_src(self) -> torch.Tensor:
        """[m] int32 source vertex of each edge (expanded from row_ptr)."""
        return torch.repeat_interleave(
            torch.arange(self.n, dtype=torch.int32, device=self.device),
            self.out_deg, output_size=self.m)

    def to(self, device) -> "CSRGraph":
        device = torch.device(device)
        if device == self.device:
            return self
        return dataclasses.replace(self, row_ptr=self.row_ptr.to(device),
                                   col_idx=self.col_idx.to(device),
                                   out_deg=self.out_deg.to(device))

    def numpy(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(row_ptr, col_idx, out_deg) as host int32 arrays."""
        return (self.row_ptr.cpu().numpy(), self.col_idx.cpu().numpy(),
                self.out_deg.cpu().numpy())


def from_edges(
    src: np.ndarray,
    dst: np.ndarray,
    n: int,
    *,
    undirected: bool = False,
    dedup: bool = True,
    device=None,
) -> CSRGraph:
    """Build a CSRGraph from (src, dst) edge arrays on `device` (the card
    when None).

    If `undirected`, each edge is inserted in both directions.
    """
    device = resolve_device(device)
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    if undirected:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
    if dedup and len(src):
        keys = src * n + dst
        keys = np.unique(keys)
        src, dst = keys // n, keys % n
    order = np.argsort(src, kind="stable")
    src, dst = src[order], dst[order]
    m = len(src)
    out_deg = np.bincount(src, minlength=n).astype(np.int32)
    row_ptr = np.zeros(n + 1, dtype=np.int32)
    np.cumsum(out_deg, out=row_ptr[1:])
    return CSRGraph(
        row_ptr=torch.from_numpy(row_ptr).to(device),
        col_idx=torch.from_numpy(dst.astype(np.int32)).to(device),
        out_deg=torch.from_numpy(out_deg).to(device),
        n=int(n),
        m=int(m),
        undirected=bool(undirected),
    )


def padded_adjacency_np(row_ptr: np.ndarray, col: np.ndarray,
                        deg: np.ndarray, md: int
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Host half of `padded_adjacency`: (nbr [n, max(md, 1)] int32,
    valid [n, max(md, 1)] bool)."""
    n = len(deg)
    if n and int(deg.max()) > max(md, 1):
        raise ValueError(f"max_deg {md} is below the graph's max out-degree "
                         f"{int(deg.max())}")
    nbr = np.tile(np.arange(n, dtype=np.int32)[:, None], (1, max(md, 1)))
    valid = np.zeros((n, max(md, 1)), dtype=bool)
    src = np.repeat(np.arange(n), deg)
    slot = np.arange(len(src)) - row_ptr[src]
    nbr[src, slot] = col[:len(src)]
    valid[src, slot] = True
    return nbr, valid


def padded_adjacency(graph: CSRGraph, max_deg: int | None = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense padded neighbor table for the count engine.

    Returns (nbr [n, max_deg] int32, valid [n, max_deg] bool) on the
    graph's device. Padded slots point at the vertex itself (never selected
    because valid=False there).
    """
    row_ptr, col, deg = graph.numpy()
    md = max_deg or graph.max_out_deg
    nbr, valid = padded_adjacency_np(row_ptr, col, deg, md)
    return (torch.from_numpy(nbr).to(graph.device),
            torch.from_numpy(valid).to(graph.device))


def transition_matrix(graph: CSRGraph, eps: float) -> np.ndarray:
    """Dense PageRank transition matrix P = (eps/n)J + (1-eps)Q (row-stochastic).

    Dangling rows of Q get uniform 1/n (Avrachenkov convention — matches the
    engines, which treat a dangling vertex as an immediate reset).
    Only for small test graphs.
    """
    n = graph.n
    row_ptr, col, deg = graph.numpy()
    Q = np.zeros((n, n), dtype=np.float64)
    for v in range(n):
        d = deg[v]
        if d:
            Q[v, col[row_ptr[v] : row_ptr[v] + d]] += 1.0 / d
        else:
            Q[v, :] = 1.0 / n
    return (eps / n) * np.ones((n, n)) + (1.0 - eps) * Q


def exact_pagerank(graph: CSRGraph, eps: float) -> np.ndarray:
    """Exact stationary distribution of P via eigen-solve (test oracle only)."""
    P = transition_matrix(graph, eps)
    w, V = np.linalg.eig(P.T)
    i = int(np.argmin(np.abs(w - 1.0)))
    pi = np.real(V[:, i])
    pi = np.abs(pi)
    return pi / pi.sum()
