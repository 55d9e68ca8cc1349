"""Shared model components: norms, RoPE, embeddings, init helpers.

Parameters are stored bf16 and matmuls run in bf16; softmax, norms and
reductions run in float32, as in the JAX package's `repro.models.common`.
Parameters are drawn by the port's own generator (`torch.Generator` on
the model's device): the same seed gives other weights than JAX's, so the
tests carry JAX's weights over with `convert.lm_params_from_numpy`.

The training and dry-run helpers of the JAX module (`cross_entropy`,
`ckpt`, `remat_policy`, `maybe_scan`, `unroll_scans`) come with those
slices.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

PARAM_DTYPE = torch.bfloat16
COMPUTE_DTYPE = torch.bfloat16


def dense_init(gen: Optional[torch.Generator], shape, fan_in: int,
               dtype=PARAM_DTYPE, *, device=None) -> torch.Tensor:
    """N(0, 1) drawn in float32 from `gen` on its device, divided by
    sqrt(fan_in), cast to `dtype`. With `gen` None the tensor is left
    unset on `device`: its weights are loaded afterwards
    (`convert.lm_params_from_numpy`)."""
    if gen is None:
        return torch.empty(shape, dtype=dtype, device=device)
    w = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w / math.sqrt(max(fan_in, 1))).to(dtype)


def zeros_init(shape, dtype=PARAM_DTYPE, *, device=None) -> torch.Tensor:
    return torch.zeros(shape, dtype=dtype, device=device)


def ones_init(shape, dtype=PARAM_DTYPE, *, device=None) -> torch.Tensor:
    return torch.ones(shape, dtype=dtype, device=device)


def param(t: torch.Tensor) -> nn.Parameter:
    """A weight of a serving model: no gradient is kept."""
    return nn.Parameter(t, requires_grad=False)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    """float32 math, scaled by (1 + scale), cast back to x's dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(x.dtype)


def rope_tables(positions: torch.Tensor, dim: int, theta: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions [...] -> (cos, sin) [..., dim//2] float32."""
    half = dim // 2
    exps = torch.arange(half, dtype=torch.float32,
                        device=positions.device) / half
    freqs = 1.0 / (torch.tensor(theta, dtype=torch.float32,
                                device=positions.device) ** exps)
    angles = positions.float()[..., None] * freqs
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x [..., T, H, D]; cos/sin [..., T, D//2] broadcast over heads. The
    first and second halves of D are the rotated pairs (not interleaved)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1).to(x.dtype)


class Embedding(nn.Module):
    """A [vocab, d_model] table: the input embedding, or an untied head
    (JAX's `init_embedding`)."""

    def __init__(self, vocab: int, d_model: int, *, device, gen):
        super().__init__()
        self.table = param(dense_init(gen, (vocab, d_model), d_model,
                                      device=device))


def embed(emb: Embedding, tokens: torch.Tensor) -> torch.Tensor:
    return emb.table[tokens].to(COMPUTE_DTYPE)


def unembed(emb: Embedding, x: torch.Tensor) -> torch.Tensor:
    """Logits in float32."""
    return torch.matmul(x.to(COMPUTE_DTYPE), emb.table.t()).float()
