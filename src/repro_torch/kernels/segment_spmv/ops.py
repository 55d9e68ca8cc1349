"""Segment-sum SpMV wrapper: the CUDA kernel for a CUDA tensor, the plain
version for a CPU tensor.

The float path sums in float64 and rounds once to a float32 result, which
is exact for integer values only up to 2**24 (the f32 mantissa). Integer
inputs therefore go through a guarded cast: callers declare the largest
count a segment sum can reach via `count_bound`, and when that bound
exceeds the f32 exact-integer range the reduction widens to an exact
integer segment sum (the int32 instantiation of the same kernel) instead
of silently truncating. With no
declared bound, or a bound within range, integer inputs take the float32
path and are exact because every partial sum is an integer below 2**24.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import common
from repro_torch.kernels.segment_spmv.ref import (segment_spmv_ref,
                                                  segment_sum_int_ref)

# largest integer float32 represents exactly (24 mantissa bits)
F32_EXACT_MAX = 2 ** 24

_ENTRY = {torch.float32: "segment_spmv_f32_launch",
          torch.int32: "segment_spmv_i32_launch"}


def _launch(values: torch.Tensor, dst: torch.Tensor,
            num_segments: int) -> torch.Tensor:
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
    fn = getattr(common.library("segment_spmv"), _ENTRY[values.dtype])
    ptr = ctypes.c_void_p
    if values.dtype == torch.float32:
        # float64 accumulator, rounded once into the float32 output
        bufs = (torch.zeros(num_segments, dtype=torch.float64,
                            device=values.device),
                torch.empty(num_segments, dtype=torch.float32,
                            device=values.device))
    else:
        bufs = (torch.zeros(num_segments, dtype=values.dtype,
                            device=values.device),)
    fn.argtypes = [ptr, ptr, ctypes.c_longlong, ctypes.c_int,
                   *[ptr] * len(bufs), ctypes.c_int, ptr]
    fn.restype = ctypes.c_int
    stream, sms = common.launch_args(values)
    with torch.cuda.device(values.device):
        err = fn(values.data_ptr(), dst.data_ptr(), values.numel(),
                 num_segments, *[b.data_ptr() for b in bufs], sms, stream)
    out = bufs[-1]
    common.check_launch("segment_spmv", err)
    common.launches["segment_spmv"] += 1
    return out


def _float_sum(values, dst, num_segments):
    if values.device.type == "cpu":
        return segment_spmv_ref(values, dst, num_segments)
    return _launch(values.to(torch.float32).contiguous(), dst, num_segments)


def segment_spmv(values: torch.Tensor, dst: torch.Tensor, num_segments: int,
                 *, count_bound=None) -> torch.Tensor:
    """y[v] = sum over edges e with dst[e]==v of values[e]; ids outside
    [0, num_segments) are dropped. Float values give float32."""
    if not torch.is_floating_point(values):
        if count_bound is not None and int(count_bound) > F32_EXACT_MAX:
            if values.device.type == "cpu":
                return segment_sum_int_ref(values, dst, num_segments)
            return _launch(values, dst, num_segments)
        return _float_sum(values.to(torch.float32), dst,
                          num_segments).to(values.dtype)
    return _float_sum(values, dst, num_segments)
