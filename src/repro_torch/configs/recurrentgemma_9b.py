"""RecurrentGemma-9B (arXiv:2402.19427 Griffin; unverified) — hybrid.

38 blocks in (RG-LRU, RG-LRU, local-attn) pattern, d_model 4096,
16Q/1KV MQA local attention (window 2048), d_ff 12288 (GeGLU),
lru_width 4096, vocab 256000. Bounded state => long_500k RUNS.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b", family="hybrid",
    num_layers=38, d_model=4096, num_heads=16, num_kv_heads=1,
    head_dim=256, d_ff=12288, vocab_size=256000,
    attention="gqa", mlp="geglu",
    block_pattern=("rglru", "rglru", "local"),
    lru_width=4096, local_window=2048, conv_kernel=4,
)
