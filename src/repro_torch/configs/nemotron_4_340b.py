"""Nemotron-4 340B (arXiv:2402.16819; unverified) — dense, squared-ReLU.

96L, d_model 18432, 96Q/8KV (head 192), d_ff 73728 (non-gated), vocab 256000.
Training fits 256x16GB only with blockwise-int8 Adam states + per-device
microbatch 1 (see train/optimizer.py).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="nemotron-4-340b", family="dense",
    num_layers=96, d_model=18432, num_heads=96, num_kv_heads=8,
    head_dim=192, d_ff=73728, vocab_size=256000,
    attention="gqa", mlp="squared_relu",
    rope_theta=10_000.0,
)
