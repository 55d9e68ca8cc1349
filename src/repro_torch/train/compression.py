"""Gradient compression: int8 all-reduce with error feedback.

The JAX package's `repro.train.compression`. Before a cross-replica sum,
each shard quantizes its flat float32 vector blockwise to int8 (absmax,
blocks of QBLOCK) and carries what the quantization lost to its next
call (error feedback: unbiased over time). On a `StackedMesh` the shards
are the rows of x [S, n], each with its own residual row; the sum is the
mesh's `psum` of the dequantized rows (the wire would carry the int8
codes and the block scales). Across processes each process passes its
own row x [1, n] with its residual, and the sum is that of a
`ProcessGroupMesh`: the world's, or a process mesh's group over some of
its axes (`launch.mesh.Mesh.group`, e.g. its data axes).
"""
from __future__ import annotations

from typing import Tuple

import torch

QBLOCK = 256


def _quant(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [n] float32 -> (int8 [n/QBLOCK rounded up, QBLOCK], scales)."""
    n = x.shape[0]
    pad = -(-n // QBLOCK) * QBLOCK - n
    xp = torch.nn.functional.pad(x, (0, pad)).reshape(-1, QBLOCK)
    scale = xp.abs().amax(dim=1) / 127.0
    q = torch.round(xp / torch.clamp(scale[:, None], min=1e-12))
    return q.to(torch.int8), scale


def _dequant(q: torch.Tensor, scale: torch.Tensor, n: int) -> torch.Tensor:
    return (q.float() * scale[:, None]).reshape(-1)[:n]


def compressed_psum(x: torch.Tensor, mesh, residual: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Error-feedback int8 psum of per-shard flat float32 vectors x [S, n]
    with their residuals [S, n] -> (the sum [n], new residuals [S, n]).
    `mesh` is a mesh of the engines (`core.collectives`): a
    `ProcessGroupMesh` takes one row a process."""
    n = x.shape[1]
    corrected = x + residual
    local = torch.stack([_dequant(*_quant(row), n) for row in corrected])
    return mesh.psum(local), corrected - local


def compression_error(x: torch.Tensor) -> float:
    """Single-shot quantization relative L2 error (diagnostics)."""
    q, s = _quant(x)
    err = x - _dequant(q, s, x.shape[0])
    return float(torch.linalg.norm(err)
                 / torch.clamp(torch.linalg.norm(x), min=1e-12))
