"""Qwen2-7B (arXiv:2407.10671; hf) — dense GQA with QKV bias.

28L, d_model 3584, 28Q/4KV (head 128), d_ff 18944, vocab 152064.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-7b", family="dense",
    num_layers=28, d_model=3584, num_heads=28, num_kv_heads=4,
    head_dim=128, d_ff=18944, vocab_size=152064,
    attention="gqa", pad_q_heads_to=32, qkv_bias=True, mlp="swiglu",
    rope_theta=1_000_000.0,
)
