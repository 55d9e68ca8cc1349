"""Qwen3-32B (hf:Qwen/Qwen3-8B family; hf) — dense GQA with qk-norm.

64L, d_model 5120, 64Q/8KV (head 128; Q proj 8192 decoupled from d_model),
d_ff 25600, vocab 151936.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-32b", family="dense",
    num_layers=64, d_model=5120, num_heads=64, num_kv_heads=8,
    head_dim=128, d_ff=25600, vocab_size=151936,
    attention="gqa", qk_norm=True, mlp="swiglu",
    rope_theta=1_000_000.0,
)
