"""DeepSeek-V2 236B (arXiv:2405.04434; hf) — MoE with MLA.

60L, d_model 5120, 128 heads, MLA (kv_lora 512, rope-dim 64), vocab 102400.
MoE: 160 routed experts (d_ff 1536) top-6 + 2 shared; first layer dense
(d_ff 12288). 236B total / ~21B active.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v2-236b", family="moe",
    num_layers=60, d_model=5120, num_heads=128, num_kv_heads=128,
    d_ff=12288, vocab_size=102400,
    attention="mla", q_lora_rank=1536, kv_lora_rank=512,
    qk_rope_head_dim=64, qk_nope_head_dim=128, v_head_dim=128,
    head_dim=192,  # nope + rope
    mlp="swiglu",
    num_experts=160, num_experts_per_tok=6, num_shared_experts=2,
    moe_d_ff=1536, first_dense_layers=1,
    rope_theta=10_000.0,
)
