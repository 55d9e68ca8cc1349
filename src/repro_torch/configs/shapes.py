"""Assigned input shapes x input_specs (meta-tensor stand-ins).

The JAX package's `repro.configs.shapes`. Four shapes per LM
architecture (40 cells):
    train_4k     seq 4096,    global_batch 256   (train_step)
    prefill_32k  seq 32768,   global_batch 32    (serve prefill)
    decode_32k   cache 32768, global_batch 128   (serve decode, 1 new token)
    long_500k    cache 524288, global_batch 1    (decode; sub-quadratic only)

`long_500k` requires bounded decode state: it runs for ssm / hybrid /
sliding-window archs and is skipped (recorded) for pure full-attention
archs. `input_specs` gives tensors on the `meta` device, which hold a
shape and a dtype and no memory, where the JAX package gives
`jax.ShapeDtypeStruct`s; the dtypes are the JAX package's (int32
tokens, bf16 frames and image embeddings).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.configs.base import ArchConfig


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ArchConfig, shape: ShapeConfig) -> bool:
    if shape.name == "long_500k":
        return cfg.is_subquadratic
    return True


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ArchConfig, shape: ShapeConfig
                ) -> Dict[str, torch.Tensor]:
    """Meta-tensor stand-ins for every model input of this cell.

    train:   batch dict for loss_fn (tokens/labels + modality extras)
    prefill: prompt tokens (+ modality extras)
    decode:  one new token; the KV cache comes from the model's
             init_cache (see launch/dryrun.py).
    """
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        return dict(token=_meta((B, 1), torch.int32))
    T = S - cfg.num_image_tokens if cfg.family == "vlm" else S
    spec = dict(tokens=_meta((B, T), torch.int32))
    if shape.kind == "train":
        spec["labels"] = _meta((B, T), torch.int32)
    if cfg.family == "audio":
        spec["frames"] = _meta((B, cfg.encoder_seq, cfg.d_model),
                               torch.bfloat16)
    if cfg.family == "vlm":
        # image prefix + text = S total positions
        spec["img_embeds"] = _meta((B, cfg.num_image_tokens, cfg.d_model),
                                   torch.bfloat16)
    return spec
