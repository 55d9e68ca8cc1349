"""Plain PyTorch versions of the fused aggregate-multinomial sampler."""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels.multinomial_rows._math import sample_rows_math


def multinomial_rows_ref(counts: torch.Tensor, deg: torch.Tensor,
                         rid: torch.Tensor, key_words, *, eps: float,
                         width: int) -> torch.Tensor:
    """T [R, width+1] int32; column 0 = terminations, 1+j = out-edge j.

    `key_words` is the (k0, k1) pair of uint32 words of the round's key.
    """
    k0, k1 = key_words
    return sample_rows_math(counts, deg, rid, int(k0), int(k1), eps=eps,
                            width=width)


def bucket_tables(widths: Sequence[int], caps: Sequence[int], shards: int
                  ) -> Tuple[List[int], List[int], List[int], int]:
    """The fused entry's per-bucket table of a bucket-grouped permutation
    whose bucket b holds caps[b] slots, `shards` runs of caps[b] // shards,
    one shard's after another: (row_start, edge_start, cap, shard_edges),
    where row_start[b] is bucket b's first slot, cap[b] one shard's slots
    of it, edge_start[b] its first word in one shard's flat per-edge
    moves, and shard_edges the words of one shard's moves."""
    row_start, edge_start, cap = [], [], []
    rows = edges = 0
    for c, w in zip(caps, widths):
        row_start.append(rows)
        edge_start.append(edges)
        cap.append(c // shards)
        rows += c
        edges += (c // shards) * w
    return row_start, edge_start, cap, edges


def multinomial_buckets_ref(counts: torch.Tensor, deg: torch.Tensor,
                            rid: torch.Tensor, key_words, perm: torch.Tensor,
                            widths: Sequence[int], caps: Sequence[int], *,
                            eps: float, shards: int = 1,
                            cells: Optional[int] = None):
    """One round of the degree-bucketed sampler in one pass over the slots
    of `perm`, with the kernel's index arithmetic.

    `key_words` is the round key's (k0, k1), or a [shards, 2] tensor of
    each shard's words (shard p draws its slots with row p's).
    Returns (moves [shards * shard_edges] int32, the per-edge counts of
    each row at its place in the flat bucketed adjacency, shard after
    shard; occupancy [len(caps)] int32, the slots per bucket whose row
    holds coupons; residual, an int64 scalar: the counts no slot took,
    which must be 0). With `cells=md`, the first output is instead the
    dense cells [n_rows * (md + 1)] of `aggregate_sampler.scatter_cells`:
    row r's termination count at r * (md + 1), its count on out-edge j at
    r * (md + 1) + 1 + j, zeros past its bucket's width."""
    row_start, edge_start, cap, shard_edges = bucket_tables(widths, caps,
                                                            shards)
    dev = counts.device

    def table(x):
        return torch.tensor(x, dtype=torch.int64, device=dev)

    s = torch.arange(perm.numel(), dtype=torch.int64, device=dev)
    b = torch.searchsorted(table(row_start), s, right=True) - 1
    i = s - table(row_start)[b]
    cap_b, w = table(cap)[b], table(list(widths))[b]
    p = torch.div(i, cap_b, rounding_mode="floor")
    word = p * shard_edges + table(edge_start)[b] + (i - p * cap_b) * w
    r = perm.to(torch.int64)
    ok = r >= 0
    row = torch.clamp(r, 0, counts.numel() - 1)
    c, d, ids = (torch.where(ok, x.index_select(0, row), 0)
                 for x in (counts, deg, rid))
    width = max(widths, default=0)
    if isinstance(key_words, torch.Tensor):
        words = key_words.to(torch.int64).reshape(shards, 2).to(dev)
        k0, k1 = words[p, 0], words[p, 1]
    else:
        k0, k1 = (int(k) for k in key_words)
    # slot j of a chain depends on the slots before it only, so the chain
    # at the widest bucket's width holds each row's own width(b) slots
    T = sample_rows_math(c, d, ids, k0, k1, eps=eps, width=width)
    j = torch.arange(width, dtype=torch.int64, device=dev)
    keep = j[None, :] < w[:, None]
    drawn = T[:, 0].to(torch.int64) + torch.where(keep, T[:, 1:], 0).sum(1)
    residual = (c.to(torch.int64) - drawn).sum()
    occupancy = torch.bincount(b[c > 0], minlength=len(caps))
    if cells is None:
        out = torch.zeros(shards * shard_edges, dtype=torch.int32,
                          device=dev)
        out[(word[:, None] + j[None, :])[keep]] = T[:, 1:][keep]
    else:
        out = torch.zeros(counts.numel() * (cells + 1), dtype=torch.int32,
                          device=dev)
        k = torch.arange(width + 1, dtype=torch.int64, device=dev)
        put = ok[:, None] & (k[None, :] <= w[:, None])
        out[(row[:, None] * (cells + 1) + k[None, :])[put]] = T[put]
    return out, occupancy.to(torch.int32), residual
