"""Model registry: family -> the model class that serves and trains it.

Every class is a `models.common.LM`: it takes `(cfg, *, device=None,
seed=0)` and provides `init_cache`, `prefill`, `decode_step` and
`loss_fn` (see `models/transformer.py`).
"""
from __future__ import annotations

from typing import Type

from repro_torch.models.common import LM
from repro_torch.models.encdec import EncDec
from repro_torch.models.mamba2 import Mamba2
from repro_torch.models.rglru import RecurrentGemma
from repro_torch.models.transformer import Transformer
from repro_torch.models.vlm import VLM

_FAMILIES = {"ssm": Mamba2, "hybrid": RecurrentGemma, "audio": EncDec,
             "vlm": VLM}


def get_model(cfg) -> Type[LM]:
    return _FAMILIES.get(cfg.family, Transformer)  # dense | moe
