"""Feed-forward blocks: SwiGLU / GeGLU / squared-ReLU / GELU."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.common import COMPUTE_DTYPE, dense_init, param


def is_gated(kind: str) -> bool:
    return kind in ("swiglu", "geglu")


def activation(h: torch.Tensor, kind: str) -> torch.Tensor:
    """The non-gated activations (and the gate's, for the gated kinds)."""
    if kind == "swiglu":
        return F.silu(h)
    if kind == "squared_relu":
        r = F.relu(h)
        return r * r
    if kind in ("gelu", "geglu"):
        # jax.nn.gelu defaults to the tanh approximation
        return F.gelu(h, approximate="tanh")
    raise ValueError(kind)


class MLP(nn.Module):
    """w_up [d, f], w_down [f, d], and w_gate [d, f] for the gated kinds."""
    AXES = dict(w_up=("embed", "ffn"), w_down=("ffn", "embed"),
                w_gate=("embed", "ffn"))

    def __init__(self, d_model: int, d_ff: int, kind: str, *, device, gen):
        super().__init__()
        self.kind = kind
        self.w_up = param(dense_init(gen, (d_model, d_ff), d_model,
                                     device=device))
        self.w_down = param(dense_init(gen, (d_ff, d_model), d_ff,
                                       device=device))
        self.w_gate = (param(dense_init(gen, (d_model, d_ff), d_model,
                                        device=device))
                       if is_gated(kind) else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mlp_forward(self, x, self.kind)


def mlp_forward(p: MLP, x: torch.Tensor, kind: str) -> torch.Tensor:
    up = torch.matmul(x, p.w_up.to(COMPUTE_DTYPE))
    if is_gated(kind):
        g = torch.matmul(x, p.w_gate.to(COMPUTE_DTYPE))
        h = activation(g, kind) * up
    else:
        h = activation(up, kind)
    return torch.matmul(h, p.w_down.to(COMPUTE_DTYPE))
