"""Plain PyTorch versions of the fused aggregate-multinomial sampler."""
from __future__ import annotations

from typing import List, Sequence, Tuple

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
                            eps: float, shards: int = 1):
    """One round of the degree-bucketed sampler in one pass over the slots
    of `perm`, with the kernel's index arithmetic.

    Returns (moves [shards * shard_edges] int32, the per-edge counts of
    each row at its place in the flat bucketed adjacency, shard after
    shard; occupancy [len(caps)] int32, the slots per bucket whose row
    holds coupons; residual, an int64 scalar: the counts no slot took,
    which must be 0)."""
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
    k0, k1 = key_words
    # slot j of a chain depends on the slots before it only, so the chain
    # at the widest bucket's width holds each row's own width(b) slots
    T = sample_rows_math(c, d, ids, int(k0), int(k1), eps=eps, width=width)
    j = torch.arange(width, dtype=torch.int64, device=dev)
    keep = j[None, :] < w[:, None]
    moves = torch.zeros(shards * shard_edges, dtype=torch.int32, device=dev)
    moves[(word[:, None] + j[None, :])[keep]] = T[:, 1:][keep]
    drawn = T[:, 0].to(torch.int64) + torch.where(keep, T[:, 1:], 0).sum(1)
    residual = (c.to(torch.int64) - drawn).sum()
    occupancy = torch.bincount(b[c > 0], minlength=len(caps))
    return moves, occupancy.to(torch.int32), residual
