"""Plain PyTorch version of the threefry uniform draw."""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from repro_torch import prng


def uniform_of_counters(key: torch.Tensor,
                        counters: torch.Tensor) -> torch.Tensor:
    """The float32 uniform of each 64-bit counter (an int64 tensor) under
    `key`: the element at flat index i of `jax.random.uniform(key, shape)`
    is that of counter i."""
    k0, k1 = prng._words(key)
    hi, lo = counters >> 32, counters.bitwise_and(prng._M32)
    del counters
    b0, b1 = prng.threefry2x32(k0, k1, hi, lo)
    # 23 random mantissa bits under the exponent of 1.0, then minus 1
    bits = b0.bitwise_xor_(b1).bitwise_right_shift_(9).bitwise_or_(
        int(np.float32(1.0).view(np.uint32)))
    return bits.to(torch.int32).view(torch.float32) - 1.0


def uniform_ref(key: torch.Tensor, shape: Sequence[int] | int = (), *,
                device=None) -> torch.Tensor:
    """`jax.random.uniform(key, shape)`: float32 in [0, 1) on `device` (the
    host when None), computed with int64 torch passes over the draw."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    return uniform_of_counters(key, torch.arange(
        math.prod(shape), dtype=torch.int64, device=device)).reshape(shape)
