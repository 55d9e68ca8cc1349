"""Fused aggregate-multinomial wrapper: the CUDA kernel for CUDA tensors,
the plain version for CPU tensors."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import common
from repro_torch.kernels.multinomial_rows.ref import multinomial_rows_ref


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
    for name, t in (("counts", counts), ("deg", deg), ("rid", rid)):
        common.require(t.device == counts.device and t.dtype == torch.int32
                       and t.shape == (rows,) and t.is_contiguous(),
                       f"multinomial_rows: {name} must be a contiguous 1-D "
                       f"int32 tensor of {rows} rows on {counts.device}")
    common.require(rows < 2 ** 31 and width >= 0,
                   "multinomial_rows: rows or width out of range")
    k0, k1 = (int(w) & 0xFFFFFFFF for w in key_words)
    out = torch.empty((rows, width + 1), dtype=torch.int32,
                      device=counts.device)
    fn = common.library("multinomial_rows").multinomial_rows_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_uint32, ctypes.c_uint32,
                   ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream, sms = common.launch_args(counts)
    with torch.cuda.device(counts.device):
        err = fn(counts.data_ptr(), deg.data_ptr(), rid.data_ptr(), rows,
                 k0, k1, float(eps), width, out.data_ptr(), sms, stream)
    common.check_launch("multinomial_rows", err)
    common.launches["multinomial_rows"] += 1
    return out
