"""Fused aggregate-multinomial wrappers: the CUDA kernel for CUDA tensors,
the plain version for CPU tensors. Both entry points count their launches
under "multinomial_rows"."""
from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Optional, Sequence

import torch

from repro_torch import prng
from repro_torch.kernels import common
from repro_torch.kernels.multinomial_rows.ref import (bucket_tables,
                                                      multinomial_buckets_ref,
                                                      multinomial_rows_ref)

_ptr, _i64, _int, _u32 = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                          ctypes.c_uint32)
MAX_BUCKETS = 32


def _check_rows(fn: str, rows: int, counts, deg, rid) -> None:
    dev = counts.device
    for name, t in (("counts", counts), ("deg", deg), ("rid", rid)):
        common.require(t.device == dev and t.dtype == torch.int32
                       and t.shape == (rows,) and t.is_contiguous(),
                       f"{fn}: {name} must be a contiguous 1-D int32 tensor "
                       f"of {rows} rows on {dev}")


def _words(key_words):
    return [int(w) & 0xFFFFFFFF for w in key_words]


def multinomial_rows(counts: torch.Tensor, deg: torch.Tensor,
                     rid: torch.Tensor, key_words, *, eps: float,
                     width: int) -> torch.Tensor:
    """T [R, width+1] int32; column 0 = terminations, 1+j = out-edge j.

    `key_words` is the (k0, k1) pair of uint32 words of the round's key.
    """
    if counts.device.type == "cpu":
        return multinomial_rows_ref(counts, deg, rid, key_words, eps=eps,
                                    width=width)
    common.require(counts.device.type == "cuda",
                   f"multinomial_rows: unsupported device {counts.device}")
    rows = counts.numel()
    _check_rows("multinomial_rows", rows, counts, deg, rid)
    common.require(rows < 2 ** 31 and width >= 0,
                   "multinomial_rows: rows or width out of range")
    out = torch.empty((rows, width + 1), dtype=torch.int32,
                      device=counts.device)
    fn = common.library("multinomial_rows").multinomial_rows_launch
    fn.argtypes = [_ptr, _ptr, _ptr, _int, _u32, _u32, ctypes.c_float, _int,
                   _ptr, _int, _ptr]
    fn.restype = ctypes.c_int
    stream, sms = common.launch_args(counts)
    with torch.cuda.device(counts.device):
        err = fn(counts.data_ptr(), deg.data_ptr(), rid.data_ptr(), rows,
                 *_words(key_words), float(eps), width, out.data_ptr(), sms,
                 stream)
    common.check_launch("multinomial_rows", err)
    common.launches["multinomial_rows"] += 1
    return out


@lru_cache(maxsize=64)
def _c_tables(widths: tuple, caps: tuple, shards: int):
    """`bucket_tables` as the C arrays the launch takes, and shard_edges."""
    row_start, edge_start, cap, shard_edges = bucket_tables(widths, caps,
                                                            shards)
    nb = len(caps)
    return ((_i64 * nb)(*row_start), (_i64 * nb)(*edge_start),
            (_int * nb)(*cap), (_int * nb)(*widths), shard_edges)


def _shard_words(key_words, shards: int, dev) -> torch.Tensor:
    """[shards * 2] int32 (the bits of the uint32 key words) of per-shard
    key words given as a [shards, 2] tensor."""
    words = torch.as_tensor(key_words).to(torch.int64).reshape(-1)
    common.require(words.numel() == 2 * shards,
                   f"multinomial_buckets: {shards} shards need [{shards}, 2] "
                   f"key words")
    words = words & 0xFFFFFFFF
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(
        torch.int32).to(dev).contiguous()


def multinomial_buckets(counts: torch.Tensor, deg: torch.Tensor,
                        rid: torch.Tensor, key_words, perm: torch.Tensor,
                        widths: Sequence[int], caps: Sequence[int], *,
                        eps: float, shards: int = 1,
                        cells: Optional[int] = None):
    """A whole round of the degree-bucketed sampler in one launch.

    counts/deg/rid: [n_rows] int32 in row order; perm: [sum(caps)] int32
    row ids grouped by bucket (-1 = padding), bucket b of width widths[b]
    holding `shards` runs of caps[b] // shards slots, one shard's after
    another. `key_words` is the (k0, k1) pair of the round's key, or a
    [shards, 2] tensor of each shard's words (uint32 or int64). Returns (moves, occupancy,
    residual) as `multinomial_buckets_ref` defines them: each row's
    per-edge counts at their place in the flat bucketed adjacency
    ([shards * edges of one shard], shard after shard), the slots per
    bucket whose row holds coupons, and the int64 count no slot took (0).
    With `cells=md` the first output is the dense outcome cells
    [n_rows * (md + 1)] instead (`aggregate_sampler.scatter_cells`'
    layout: the termination count, then the count of each out-edge)."""
    prng.record_use(key_words, "multinomial_buckets")
    if counts.device.type == "cpu":
        return multinomial_buckets_ref(counts, deg, rid, key_words, perm,
                                       widths, caps, eps=eps, shards=shards,
                                       cells=cells)
    dev = counts.device
    common.require(dev.type == "cuda",
                   f"multinomial_buckets: unsupported device {dev}")
    rows, nb = counts.numel(), len(caps)
    _check_rows("multinomial_buckets", rows, counts, deg, rid)
    common.require(perm.device == dev and perm.dtype == torch.int32
                   and perm.dim() == 1 and perm.is_contiguous()
                   and perm.numel() == sum(caps),
                   f"multinomial_buckets: perm must be a contiguous 1-D "
                   f"int32 tensor of {sum(caps)} slots on {dev}")
    common.require(1 <= nb == len(widths) <= MAX_BUCKETS and shards >= 1
                   and all(w >= 1 for w in widths)
                   and all(c % shards == 0 for c in caps),
                   "multinomial_buckets: 1 to 32 buckets of width >= 1, "
                   "each holding whole shards")
    common.require((0 < rows < 2 ** 31 or perm.numel() == 0)
                   and perm.numel() < 2 ** 31,
                   "multinomial_buckets: no rows to draw, or 2**31 slots")
    common.require(cells is None or 0 <= max(widths) <= int(cells),
                   "multinomial_buckets: a bucket wider than the cells")
    *tables, shard_edges = _c_tables(tuple(widths), tuple(caps), shards)
    if cells is None:
        moves = torch.empty(shards * shard_edges, dtype=torch.int32,
                            device=dev)
        out, cell_width = None, 0
    else:
        moves, cell_width = None, int(cells) + 1
        out = torch.zeros(rows * cell_width, dtype=torch.int32, device=dev)
    keys = None
    if isinstance(key_words, torch.Tensor):
        keys = _shard_words(key_words, shards, dev)
        key_words = (0, 0)
    # one fill for both small outputs: the residual, then the occupancy
    scratch = torch.zeros(1 + common.cdiv(nb, 2), dtype=torch.int64,
                          device=dev)
    residual, occupancy = scratch[0], scratch[1:].view(torch.int32)[:nb]
    fn = common.library("multinomial_rows").multinomial_buckets_launch
    fn.argtypes = [_ptr, _ptr, _ptr, _ptr, _int, _u32, _u32, ctypes.c_float,
                   _int, _ptr, _ptr, _ptr, _ptr, _int, _i64, _i64, _ptr,
                   _int, _ptr, _ptr, _ptr, _ptr, _ptr]
    fn.restype = ctypes.c_int
    stream, _ = common.launch_args(counts)
    with torch.cuda.device(dev):
        err = fn(perm.data_ptr(), counts.data_ptr(), deg.data_ptr(),
                 rid.data_ptr(), rows, *_words(key_words), float(eps), nb,
                 *tables, shards, shard_edges, perm.numel(),
                 None if keys is None else keys.data_ptr(), cell_width,
                 None if moves is None else moves.data_ptr(),
                 None if out is None else out.data_ptr(),
                 occupancy.data_ptr(), residual.data_ptr(), stream)
    common.check_launch("multinomial_rows", err)
    common.launches["multinomial_rows"] += 1
    return (moves if out is None else out), occupancy, residual
