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

from repro_torch.device import resolve_device

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


def causal_conv(xp: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv in bf16, without its bias: xp [B, k-1+T, C]
    (k-1 rows of history, then the T inputs), w [k, C] -> [B, T, C],
    summed tap by tap in the JAX package's order."""
    k = w.shape[0]
    T = xp.shape[1] - (k - 1)
    w = w.to(COMPUTE_DTYPE)
    out = xp[:, 0:T] * w[0]
    for i in range(1, k):
        out = out + xp[:, i:i + T] * w[i]
    return out


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


class LM(nn.Module):
    """What the port's LMs share: `cfg`, the device (the card when None),
    the input embedding, the final norm and the head (the embedding when
    `cfg.tie_embeddings`). Weights are drawn from a generator seeded with
    `seed` in the order embedding, `_build`'s layers, head; with `seed`
    None they are left unset, for `convert.lm_params_from_numpy` to load."""

    def __init__(self, cfg, *, device=None, seed: Optional[int] = 0):
        super().__init__()
        device = resolve_device(device)
        gen = (torch.Generator(device=device).manual_seed(seed)
               if seed is not None else None)
        self.cfg = cfg
        self.device = device
        self.embed = Embedding(cfg.vocab_size, cfg.d_model, device=device,
                               gen=gen)
        self._build(cfg, device, gen)
        self.final_norm = param(zeros_init((cfg.d_model,), device=device))
        self.lm_head = (None if cfg.tie_embeddings else
                        Embedding(cfg.vocab_size, cfg.d_model, device=device,
                                  gen=gen))

    def _build(self, cfg, device, gen) -> None:
        """The layers, between the embedding and the head."""
        raise NotImplementedError

    def logits(self, x) -> torch.Tensor:
        """The final norm and the head over the stream x [B, T, d]."""
        hidden = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        table = self.embed if self.cfg.tie_embeddings else self.lm_head
        return unembed(table, hidden)
