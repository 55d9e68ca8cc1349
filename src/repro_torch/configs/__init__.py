"""Config registry for the assigned architecture pool.

The same ten configurations as the JAX package's `repro.configs`, copied
so that the port imports nothing of it, and the dry run's input shapes
(`SHAPES`, `input_specs`, `shape_applicable`, in `configs.shapes`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.shapes import (SHAPES, ShapeConfig, input_specs,
                                        shape_applicable)

from repro_torch.configs.deepseek_v2_236b import CONFIG as _deepseek
from repro_torch.configs.dbrx_132b import CONFIG as _dbrx
from repro_torch.configs.qwen2_7b import CONFIG as _qwen2
from repro_torch.configs.nemotron_4_340b import CONFIG as _nemotron
from repro_torch.configs.h2o_danube3_4b import CONFIG as _danube
from repro_torch.configs.qwen3_32b import CONFIG as _qwen3
from repro_torch.configs.mamba2_1p3b import CONFIG as _mamba2
from repro_torch.configs.recurrentgemma_9b import CONFIG as _rgemma
from repro_torch.configs.internvl2_1b import CONFIG as _internvl
from repro_torch.configs.whisper_tiny import CONFIG as _whisper

ARCHS: Dict[str, ArchConfig] = {c.name: c for c in [
    _deepseek, _dbrx, _qwen2, _nemotron, _danube, _qwen3, _mamba2, _rgemma,
    _internvl, _whisper,
]}


def get_config(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


def reduced_config(name: str) -> ArchConfig:
    """Small same-family config for CPU smoke tests: few layers, narrow
    widths, tiny vocab/experts — structure preserved."""
    cfg = get_config(name)
    reps = dict(
        num_layers=min(cfg.num_layers, 2 if not cfg.block_pattern
                       else len(cfg.block_pattern) + 1),
        d_model=128, num_heads=4, num_kv_heads=min(cfg.num_kv_heads, 2),
        head_dim=32, d_ff=256, vocab_size=512,
        pad_q_heads_to=None,  # production TP-divisibility padding off
    )
    if cfg.num_experts:
        # capacity 4.0: no token drops at smoke scale, so incremental decode
        # is exactly comparable with the full forward
        reps |= dict(num_experts=4, num_experts_per_tok=2, moe_d_ff=64,
                     first_dense_layers=min(cfg.first_dense_layers, 1),
                     capacity_factor=4.0)
    if cfg.attention == "mla":
        reps |= dict(q_lora_rank=64, kv_lora_rank=32, qk_rope_head_dim=16,
                     qk_nope_head_dim=32, v_head_dim=32, head_dim=48)
    if cfg.family == "ssm":
        reps |= dict(num_heads=8, num_kv_heads=8, ssm_state=16, ssm_headdim=32,
                     ssm_chunk=16, d_model=128)
    if cfg.family == "hybrid":
        reps |= dict(lru_width=128, local_window=32,
                     num_layers=len(cfg.block_pattern) + 1)
    if cfg.encoder_layers:
        reps |= dict(encoder_layers=2, encoder_seq=24)
    if cfg.num_image_tokens:
        reps |= dict(num_image_tokens=8)
    if cfg.sliding_window:
        reps |= dict(sliding_window=16)
    return dataclasses.replace(cfg, **reps)


__all__ = ["ARCHS", "ArchConfig", "SHAPES", "ShapeConfig", "get_config",
           "input_specs", "reduced_config", "shape_applicable"]
