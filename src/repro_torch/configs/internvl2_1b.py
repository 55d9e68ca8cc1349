"""InternVL2-1B (arXiv:2404.16821; hf) — VLM, Qwen2-0.5B text backbone.

24L, d_model 896, 14Q/2KV (head 64), d_ff 4864, vocab 151655.
InternViT frontend is a STUB: input_specs() provides 256 precomputed patch
embeddings per image, prepended to the text stream.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-1b", family="vlm",
    num_layers=24, d_model=896, num_heads=14, num_kv_heads=2,
    head_dim=64, d_ff=4864, vocab_size=151655,
    attention="gqa", pad_q_heads_to=16, qkv_bias=True, mlp="swiglu",
    num_image_tokens=256, tie_embeddings=True,
    rope_theta=1_000_000.0,
)
