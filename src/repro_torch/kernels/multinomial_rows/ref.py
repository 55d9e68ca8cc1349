"""Plain PyTorch version of the fused aggregate-multinomial sampler."""
from __future__ import annotations

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
