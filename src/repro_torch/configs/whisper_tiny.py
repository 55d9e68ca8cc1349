"""Whisper-tiny (arXiv:2212.04356; unverified) — enc-dec audio backbone.

4+4L, d_model 384, 6H MHA, d_ff 1536, vocab 51865. Conv frontend is a STUB:
input_specs() provides 1500 precomputed frame embeddings. (Positional
encoding adapted to RoPE — backbone exercise per DESIGN.md.)
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-tiny", family="audio",
    num_layers=4, d_model=384, num_heads=6, num_kv_heads=6,
    d_ff=1536, vocab_size=51865,
    attention="gqa", mlp="gelu",
    encoder_layers=4, encoder_seq=1500,
)
