"""Histogram wrapper: the CUDA kernel for a CUDA tensor, the plain version
for a CPU tensor."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import common
from repro_torch.kernels.histogram.ref import histogram_ref


def histogram(ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """counts[v] = |{w : ids[w] == v}| for v in [0, num_segments), int32.

    ids entries outside [0, num_segments) are ignored (use -1 to mask).
    """
    if ids.device.type == "cpu":
        return histogram_ref(ids, num_segments)
    common.require(ids.device.type == "cuda",
                   f"histogram: unsupported device {ids.device}")
    common.require(ids.dtype == torch.int32 and ids.dim() == 1
                   and ids.is_contiguous(),
                   "histogram: ids must be a contiguous 1-D int32 tensor")
    common.require(0 <= num_segments < 2 ** 31,
                   "histogram: num_segments out of range")
    out = torch.zeros(num_segments, dtype=torch.int32, device=ids.device)
    fn = common.library("histogram").histogram_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream, sms = common.launch_args(ids)
    with torch.cuda.device(ids.device):
        err = fn(ids.data_ptr(), ids.numel(), num_segments, out.data_ptr(),
                 sms, stream)
    common.check_launch("histogram", err)
    common.launches["histogram"] += 1
    return out
