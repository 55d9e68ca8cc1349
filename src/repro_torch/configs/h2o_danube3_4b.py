"""H2O-Danube3-4B (arXiv:2401.16818; unverified) — llama+mistral mix, SWA.

24L, d_model 3840, 32Q/8KV (head 120), d_ff 10240, vocab 32000,
sliding window 4096 => bounded decode cache => long_500k RUNS.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="h2o-danube-3-4b", family="dense",
    num_layers=24, d_model=3840, num_heads=32, num_kv_heads=8,
    head_dim=120, d_ff=10240, vocab_size=32000,
    attention="gqa", mlp="swiglu", sliding_window=4096,
    rope_theta=10_000.0,
)
