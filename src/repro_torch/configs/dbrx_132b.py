"""DBRX 132B (hf:databricks/dbrx-base; unverified) — fine-grained MoE.

40L, d_model 6144, 48Q/8KV GQA, 16 experts top-4 (d_ff 10752), vocab 100352.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="dbrx-132b", family="moe",
    num_layers=40, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=10752, vocab_size=100352,
    attention="gqa", mlp="swiglu",
    num_experts=16, num_experts_per_tok=4, moe_d_ff=10752,
    rope_theta=500_000.0,
)
