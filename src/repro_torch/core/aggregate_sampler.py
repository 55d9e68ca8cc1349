"""Degree-bucketed aggregate multinomial sampler — the shared compute core
of every count-moving engine.

The conditional-binomial chain that splits an aggregate coupon count over
a vertex's out-edges scans a fixed width per call. Rows are grouped by
power-of-two degree buckets: bucket b holds rows with degree in
(2^(b-1), 2^b] (bucket 0: degree 0 and 1) and scans width
min(2^b, max_deg) <= 2 * degree, so per-round sampler work is
sum_v O(deg(v)) instead of n * max_deg. The grouping is a static
permutation computed on the host and memoized.

The engines draw a round with one `multinomial_buckets` call over every
bucket of a layout (its widths and caps), which writes the per-edge counts
straight into the flat layout of `bucketize_adjacency`. `sample_buckets` +
`flatten_moves` are the same round as the JAX package computes it, a loop
over the O(log max_deg) buckets with one `multinomial_rows` call each; the
tests and the card's smoke run hold the fused round against them.

The three-phase engines' Phase 1 draws (home, vertex) rows into dense
outcome cells (`scatter_cells`, or the fused entry's `cells=` mode).

`bucketed=False` is the same machinery with a single bucket of width
max_deg.
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Iterator, List, Tuple

import numpy as np
import torch

from repro_torch.kernels.multinomial_rows import multinomial_rows


@dataclasses.dataclass(frozen=True)
class BucketLayout:
    """Static (hashable) shape of a bucketed row grouping.

    widths[b]: chain scan width of bucket b (min(2^b, max_deg)).
    caps[b]:   row slots in bucket b (>= real rows).
    n_rows:    number of real rows the permutation indexes into.
    """

    widths: Tuple[int, ...]
    caps: Tuple[int, ...]
    n_rows: int

    @property
    def total_rows(self) -> int:
        return sum(self.caps)

    @property
    def total_edges(self) -> int:
        """Flat bucketed-adjacency length: sum of caps[b] * widths[b]."""
        return sum(c * w for c, w in zip(self.caps, self.widths))

    @property
    def row_starts(self) -> Tuple[int, ...]:
        out, s = [], 0
        for c in self.caps:
            out.append(s)
            s += c
        return tuple(out)

    def tile(self, copies: int) -> "BucketLayout":
        """Layout for `copies` stacked replicas of the same row set (the
        Phase-1 home-major (home, vertex) row matrix)."""
        return BucketLayout(widths=self.widths,
                            caps=tuple(c * copies for c in self.caps),
                            n_rows=self.n_rows * copies)


def bucket_of(deg: np.ndarray) -> np.ndarray:
    """Power-of-two bucket index per degree: 0 for deg <= 1, else
    ceil(log2(deg))."""
    d = np.maximum(np.asarray(deg, np.int64), 1)
    return np.ceil(np.log2(d)).astype(np.int64)


@lru_cache(maxsize=256)
def _layout_cached(deg_bytes: bytes, max_deg: int, bucketed: bool):
    deg = np.frombuffer(deg_bytes, dtype=np.int32)
    n = len(deg)
    if not bucketed or max_deg <= 1:
        layout = BucketLayout(widths=(max(max_deg, 1),), caps=(n,), n_rows=n)
        return layout, np.arange(n, dtype=np.int32)
    n_b = int(np.ceil(np.log2(max_deg))) + 1
    widths = tuple(min(1 << b, max_deg) for b in range(n_b))
    b_of = bucket_of(deg)
    caps = tuple(int(c) for c in np.bincount(b_of, minlength=n_b))
    # rows grouped by bucket, in increasing row order within each bucket
    perm = np.argsort(b_of, kind="stable").astype(np.int32)
    return BucketLayout(widths=widths, caps=caps, n_rows=n), perm


def build_layout(deg: np.ndarray, max_deg: int, *,
                 bucketed: bool = True) -> Tuple[BucketLayout, np.ndarray]:
    """Single-shard layout: (layout, perm [total_rows] int32, -1 = pad).

    One shard needs no padding rows; `build_layout_sharded` pads each
    bucket to the largest shard's."""
    deg = np.ascontiguousarray(np.asarray(deg, np.int32))
    return _layout_cached(deg.tobytes(), int(max_deg), bool(bucketed))


@lru_cache(maxsize=64)
def _sharded_cached(deg_bytes: bytes, shards: int, max_deg: int,
                    bucketed: bool):
    deg = np.frombuffer(deg_bytes, dtype=np.int32).reshape(shards, -1)
    n_loc = deg.shape[1]
    if not bucketed or max_deg <= 1:
        layout = BucketLayout(widths=(max(max_deg, 1),), caps=(n_loc,),
                              n_rows=n_loc)
        return layout, np.tile(np.arange(n_loc, dtype=np.int32), (shards, 1))
    n_b = int(np.ceil(np.log2(max_deg))) + 1
    widths = tuple(min(1 << b, max_deg) for b in range(n_b))
    b_of = bucket_of(deg)
    counts = np.stack([np.bincount(b, minlength=n_b) for b in b_of])
    caps = tuple(int(c) for c in counts.max(axis=0))
    starts = np.concatenate([[0], np.cumsum(caps)[:-1]]).astype(np.int64)
    # each shard's rows grouped by bucket, in increasing row order within a
    # bucket, each bucket padded with -1 up to the largest shard's count
    perm = np.full((shards, int(sum(caps))), -1, np.int32)
    for p in range(shards):
        rows = np.argsort(b_of[p], kind="stable")
        b = b_of[p, rows]
        first = np.concatenate([[0], np.cumsum(counts[p])[:-1]])
        perm[p, starts[b] + np.arange(n_loc) - first[b]] = rows
    return BucketLayout(widths=widths, caps=caps, n_rows=n_loc), perm


def build_layout_sharded(deg: np.ndarray, max_deg: int, *,
                         bucketed: bool = True
                         ) -> Tuple[BucketLayout, np.ndarray]:
    """Shard-uniform layout from a [shards, n_loc] degree matrix:
    (layout with caps = the max over shards, perm [shards, total_rows]
    int32 of local row ids, -1 = padding)."""
    deg = np.ascontiguousarray(np.asarray(deg, np.int32))
    return _sharded_cached(deg.tobytes(), deg.shape[0], int(max_deg),
                           bool(bucketed))


def stack_shard_perm(perm: np.ndarray, layout: BucketLayout
                     ) -> Tuple[BucketLayout, np.ndarray]:
    """One permutation over all shards' rows at once: bucket b holds the
    shards' bucket-b rows shard after shard, as row ids into the flattened
    [shards * n_rows] row vector. Draws are counter-based per row id, so
    one sampler call per bucket over every shard gives each shard's own
    draws."""
    shards = perm.shape[0]
    base = (np.arange(shards, dtype=np.int64) * layout.n_rows)[:, None]
    blocks = []
    for start, cap in zip(layout.row_starts, layout.caps):
        blk = perm[:, start:start + cap].astype(np.int64)
        blocks.append(np.where(blk >= 0, blk + base, -1).reshape(-1))
    stacked = BucketLayout(widths=layout.widths,
                           caps=tuple(c * shards for c in layout.caps),
                           n_rows=layout.n_rows * shards)
    return stacked, np.concatenate(blocks).astype(np.int32)


def bucketize_adjacency(nbr: np.ndarray, perm: np.ndarray,
                        layout: BucketLayout, *,
                        pad_dst: int = 0) -> np.ndarray:
    """Flat bucketed neighbor table [*, total_edges]: bucket b contributes
    a [caps[b], widths[b]] block of `nbr[perm]` rows (row-major). Padding
    slots point at `pad_dst` — they only ever carry zero counts."""
    nbr = np.asarray(nbr)
    lead = nbr.shape[:-2]
    flat = np.empty(lead + (layout.total_edges,), nbr.dtype)
    s_rows, s_edges = 0, 0
    for cap, w in zip(layout.caps, layout.widths):
        rows = perm[..., s_rows:s_rows + cap]
        blk = np.take_along_axis(
            nbr[..., :w], np.maximum(rows, 0)[..., None], axis=-2)
        blk = np.where((rows < 0)[..., None], pad_dst, blk)
        flat[..., s_edges:s_edges + cap * w] = blk.reshape(lead + (cap * w,))
        s_rows += cap
        s_edges += cap * w
    return flat


def bucket_rows(counts: torch.Tensor, deg: torch.Tensor, rid: torch.Tensor,
                perm: torch.Tensor, layout: BucketLayout
                ) -> Iterator[Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                    torch.Tensor, int]]:
    """Per bucket: (rows_b, counts_b, deg_b, rid_b, width), the sampler's
    inputs gathered from ORIGINAL row order (padding rows give zeros)."""
    n = counts.shape[0]
    for start, cap, w in zip(layout.row_starts, layout.caps, layout.widths):
        rows_b = perm[start:start + cap]
        ok = rows_b >= 0
        safe = torch.clamp(rows_b, 0, n - 1)
        yield (rows_b,
               torch.where(ok, counts.index_select(0, safe), 0),
               torch.where(ok, deg.index_select(0, safe), 0),
               torch.where(ok, rid.index_select(0, safe), 0), w)


def sample_buckets(counts, deg, rid, key_words, perm: torch.Tensor,
                   layout: BucketLayout, *, eps: float
                   ) -> Tuple[List[Tuple[torch.Tensor, torch.Tensor]],
                              torch.Tensor, torch.Tensor]:
    """Run the fused sampler over every bucket of `layout`.

    counts/deg/rid: [n_rows] int32 vectors in ORIGINAL row order;
    key_words: the (k0, k1) words of the round's key;
    perm: [total_rows] int32 bucket-grouped row indices (-1 = padding).

    Returns (samples, occupancy, residual):
      samples   — per bucket (rows_b [caps[b]], T_b [caps[b], widths[b]+1])
                  with T_b column 0 the termination count;
      occupancy — [n_buckets] int32, rows with a nonzero count per bucket;
      residual  — scalar, sum over rows of (count - T.sum()): 0 by
                  construction (endpoint-exact chain), kept as a tripwire.
    """
    samples, occ = [], []
    residual = torch.zeros((), dtype=torch.int64, device=counts.device)
    for rows_b, c_b, d_b, r_b, w in bucket_rows(counts, deg, rid, perm,
                                                layout):
        T_b = multinomial_rows(c_b, d_b, r_b, key_words, eps=eps, width=w)
        samples.append((rows_b, T_b))
        occ.append((c_b > 0).sum())
        residual = residual + c_b.sum() - T_b.sum()
    return samples, torch.stack(occ).to(torch.int32), residual


def flatten_moves(samples, shards: int | None = None) -> torch.Tensor:
    """Per-edge counts [total_edges] aligned with `bucketize_adjacency`
    (termination column dropped). With `shards`, the samples of a
    `stack_shard_perm` layout give each shard's [shards, total_edges]."""
    if shards is None:
        return torch.cat([T[:, 1:].reshape(-1) for _, T in samples])
    return torch.cat([T[:, 1:].reshape(shards, -1) for _, T in samples],
                     dim=1)


def scatter_cells(samples, layout: BucketLayout, max_deg: int
                  ) -> torch.Tensor:
    """Dense per-row outcome cells [n_rows * (max_deg + 1)] int32 of
    `sample_buckets`' samples: cell r*(max_deg+1) is row r's termination
    count, cell r*(max_deg+1)+1+j its out-edge-j count (0 beyond the row's
    bucket width). The Phase-1 reply layout of the three-phase engines,
    and the plain version of `multinomial_buckets(..., cells=max_deg)`."""
    size = layout.n_rows * (max_deg + 1)
    dev = samples[0][1].device if samples else "cpu"
    out = torch.zeros(size + 1, dtype=torch.int32, device=dev)
    for (rows_b, T_b), w in zip(samples, layout.widths):
        base = torch.where(rows_b < 0, size,
                           rows_b.to(torch.int64) * (max_deg + 1))
        offs = torch.arange(w + 1, dtype=torch.int64, device=dev)
        idx = torch.clamp(base[:, None] + offs[None, :], max=size)
        out[idx.reshape(-1)] = T_b.reshape(-1)
    return out[:size]
