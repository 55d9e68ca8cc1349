"""Mamba2-1.3B (arXiv:2405.21060; unverified) — SSD, attention-free.

48L, d_model 2048, d_state 128, expand 2 (d_inner 4096), headdim 64
(64 SSD heads), vocab 50280. O(1) decode state => long_500k RUNS.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-1.3b", family="ssm",
    num_layers=48, d_model=2048, num_heads=64, num_kv_heads=64,
    d_ff=0, vocab_size=50280,
    attention="none", ssm_state=128, ssm_expand=2, ssm_headdim=64,
    ssm_chunk=128, conv_kernel=4, tie_embeddings=True,
)
