"""The uniform wrapper: the CUDA kernel for a CUDA device, the plain
version for the CPU."""
from __future__ import annotations

import ctypes
import math
from typing import Sequence

import torch

from repro_torch import prng
from repro_torch.kernels import common
from repro_torch.kernels.uniform.ref import uniform_ref


def uniform(key: torch.Tensor, shape: Sequence[int] | int = (), *,
            device=None) -> torch.Tensor:
    """`jax.random.uniform(key, shape)`: float32 in [0, 1) on `device` (the
    host when None). On a CUDA device the kernel draws every element; a
    build or launch error raises."""
    device = torch.device("cpu") if device is None else torch.device(device)
    if device.type == "cpu":
        return uniform_ref(key, shape, device=device)
    common.require(device.type == "cuda",
                   f"uniform: unsupported device {device}")
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    k0, k1 = prng._words(key)
    out = torch.empty(shape, dtype=torch.float32, device=device)
    size = math.prod(shape)
    if size == 0:
        return out
    fn = common.library("uniform").uniform_launch
    fn.argtypes = [ctypes.c_uint32, ctypes.c_uint32, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream, sms = common.launch_args(out)
    with torch.cuda.device(out.device):
        err = fn(k0, k1, size, out.data_ptr(), sms, stream)
    common.check_launch("uniform", err)
    common.launches["uniform"] += 1
    return out
