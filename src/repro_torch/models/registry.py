"""Model registry: family -> the model class that serves it.

Every class takes `(cfg, *, device=None, seed=0)` and provides
`init_cache`, `prefill` and `decode_step` (see `models/transformer.py`).
"""
from __future__ import annotations

from typing import Type

from repro_torch.models.transformer import Transformer
from repro_torch.models.vlm import VLM


def get_model(cfg) -> Type[Transformer]:
    if cfg.family in ("ssm", "hybrid", "audio"):
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet "
            "(ROADMAP Queue 1 item 12b: mamba2, rglru, encdec)")
    if cfg.family == "vlm":
        return VLM
    return Transformer  # dense | moe
