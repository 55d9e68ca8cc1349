"""Plain PyTorch version of the threefry uniform draw."""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from repro_torch import prng


def uniform_ref(key: torch.Tensor, shape: Sequence[int] | int = (), *,
                device=None) -> torch.Tensor:
    """`jax.random.uniform(key, shape)`: float32 in [0, 1) on `device` (the
    host when None), computed with int64 torch passes over the draw."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    size = math.prod(shape)
    k0, k1 = prng._words(key)
    hi, lo = prng._counter_words(size, device)
    b0, b1 = prng.threefry2x32(k0, k1, hi, lo)
    # 23 random mantissa bits under the exponent of 1.0, then minus 1
    bits = b0.bitwise_xor_(b1).bitwise_right_shift_(9).bitwise_or_(
        int(np.float32(1.0).view(np.uint32)))
    return (bits.to(torch.int32).view(torch.float32) - 1.0).reshape(shape)
