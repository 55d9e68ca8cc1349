"""Segment-sum SpMV wrappers: the CUDA kernel for a CUDA tensor, the plain
version for a CPU tensor.

The float path sums in float64 and rounds once to a float32 result, which
is exact for integer values only up to 2**24 (the f32 mantissa). Integer
inputs therefore go through a guarded cast: callers declare the largest
count a segment sum can reach via `count_bound`, and when that bound
exceeds the f32 exact-integer range the reduction widens to an exact
integer segment sum (`segment_sum_int`, the int32 instantiation of the
same kernel) instead of silently truncating. With no declared bound, or a
bound within range, integer inputs take the float32 path and are exact
because every partial sum is an integer below 2**24.

On the card the kernel sums the hot ids of `dst` per block in shared
memory (see `segment_spmv.cu`). `hot_list(dst, n)` finds them with the
`histogram` kernel's sample and hot-list passes; a caller whose `dst`
stays the same over many calls builds it once and passes it as `hot=`,
and a call without it builds its own. The hot list changes the time
only, never the sums; the plain version does not use it.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import common
from repro_torch.kernels.histogram import ops as histogram_ops
from repro_torch.kernels.segment_spmv.ref import (segment_spmv_ref,
                                                  segment_sum_int_ref)

# largest integer float32 represents exactly (24 mantissa bits)
F32_EXACT_MAX = 2 ** 24
# an id of dst expected more often than this is hot: lower than the
# histogram's threshold, since an id of a few hundred values already makes
# a chain of L2 atomics that sets the count engines' sums' time (PERF.md)
HOT_HITS = 500

_ENTRY = {torch.float32: "segment_spmv_f32_launch",
          torch.int32: "segment_spmv_i32_launch"}
_ptr = ctypes.c_void_p


def hot_list(dst: torch.Tensor, num_segments: int) -> Optional[torch.Tensor]:
    """The table of the ids of `dst` that the kernel sums in shared memory
    (`histogram.ops.hot_list`'s at HOT_HITS expected hits, 2**HOT_BITS
    slots of id + 1), or None when `dst` is too short for any id to be
    hot."""
    w = dst.numel()
    if w < HOT_HITS or num_segments == 0:
        return None
    return histogram_ops.hot_list(dst.reshape(-1), num_segments, HOT_HITS)[0]


def _launch(values: torch.Tensor, dst: torch.Tensor, num_segments: int,
            hot: Optional[torch.Tensor]) -> torch.Tensor:
    common.require(values.device.type == "cuda",
                   f"segment_spmv: unsupported device {values.device}")
    common.require(dst.device == values.device,
                   "segment_spmv: values and dst on different devices")
    common.require(values.dtype in _ENTRY,
                   f"segment_spmv: no kernel for {values.dtype}")
    common.require(dst.dtype == torch.int32, "segment_spmv: dst must be int32")
    common.require(values.dim() == 1 and dst.shape == values.shape
                   and values.is_contiguous() and dst.is_contiguous(),
                   "segment_spmv: values and dst must be contiguous 1-D "
                   "tensors of one length")
    common.require(0 <= num_segments < 2 ** 31,
                   "segment_spmv: num_segments out of range")
    if hot is None:
        hot = hot_list(dst, num_segments)
    else:
        common.require(hot.device == values.device and hot.dtype == torch.int32
                       and hot.shape == (1 << histogram_ops.HOT_BITS,)
                       and hot.is_contiguous(),
                       "segment_spmv: hot must be a table of hot_list")
    fn = getattr(common.library("segment_spmv"), _ENTRY[values.dtype])
    if values.dtype == torch.float32:
        # float64 accumulator, rounded once into the float32 output
        bufs = (torch.zeros(num_segments, dtype=torch.float64,
                            device=values.device),
                torch.empty(num_segments, dtype=torch.float32,
                            device=values.device))
    else:
        bufs = (torch.zeros(num_segments, dtype=values.dtype,
                            device=values.device),)
    fn.argtypes = [_ptr, _ptr, ctypes.c_longlong, ctypes.c_int, _ptr,
                   ctypes.c_int, *[_ptr] * len(bufs), ctypes.c_int, _ptr]
    fn.restype = ctypes.c_int
    stream, sms = common.launch_args(values)
    with torch.cuda.device(values.device):
        err = fn(values.data_ptr(), dst.data_ptr(), values.numel(),
                 num_segments, None if hot is None else hot.data_ptr(),
                 histogram_ops.HOT_BITS, *[b.data_ptr() for b in bufs], sms,
                 stream)
    common.check_launch("segment_spmv", err)
    common.launches["segment_spmv"] += 1
    return bufs[-1]


def segment_sum_int(values: torch.Tensor, dst: torch.Tensor,
                    num_segments: int, *,
                    hot: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The exact int32 segment sum of int32 `values` (ids outside
    [0, num_segments) dropped)."""
    if values.device.type == "cpu":
        return segment_sum_int_ref(values, dst, num_segments)
    return _launch(values, dst, num_segments, hot)


def _float_sum(values, dst, num_segments, hot):
    if values.device.type == "cpu":
        return segment_spmv_ref(values, dst, num_segments)
    return _launch(values.to(torch.float32).contiguous(), dst, num_segments,
                   hot)


def segment_spmv(values: torch.Tensor, dst: torch.Tensor, num_segments: int,
                 *, count_bound=None,
                 hot: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y[v] = sum over edges e with dst[e]==v of values[e]; ids outside
    [0, num_segments) are dropped. Float values give float32. `hot`: the
    `hot_list` of `dst`, built here when None."""
    if not torch.is_floating_point(values):
        if count_bound is not None and int(count_bound) > F32_EXACT_MAX:
            return segment_sum_int(values, dst, num_segments, hot=hot)
        return _float_sum(values.to(torch.float32), dst, num_segments,
                          hot).to(values.dtype)
    return _float_sum(values, dst, num_segments, hot)
