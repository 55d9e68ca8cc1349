"""Architecture configuration schema for the assigned model pool."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None          # default d_model // num_heads
    # --- attention flavor ---
    attention: str = "gqa"                  # gqa | mla | none
    # pad the q-head dim to this count with zero (masked) heads so it
    # divides the TP degree — mathematically exact: padded heads are
    # masked before the output projection, so they contribute nothing and
    # receive zero gradient (§Perf qwen2 hillclimb)
    pad_q_heads_to: Optional[int] = None
    qkv_bias: bool = False
    qk_norm: bool = False
    sliding_window: Optional[int] = None    # SWA width (tokens), None = full
    rope_theta: float = 10_000.0
    # --- MLA (DeepSeek-V2) ---
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_rope_head_dim: int = 0
    qk_nope_head_dim: int = 0
    v_head_dim: int = 0
    # --- MLP flavor ---
    mlp: str = "swiglu"                     # swiglu | geglu | squared_relu | gelu
    # --- MoE ---
    num_experts: int = 0
    num_experts_per_tok: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0                       # per-expert hidden (0 = d_ff)
    first_dense_layers: int = 0             # leading dense layers (DeepSeek)
    capacity_factor: float = 1.25
    # --- SSM (Mamba-2 SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_chunk: int = 128
    conv_kernel: int = 4
    # --- hybrid (RecurrentGemma / Griffin) ---
    block_pattern: Tuple[str, ...] = ()     # e.g. ("rglru","rglru","local")
    lru_width: Optional[int] = None
    local_window: int = 2048
    # --- enc-dec (Whisper) ---
    encoder_layers: int = 0
    encoder_seq: int = 0                    # fixed frame count (stub frontend)
    # --- VLM ---
    num_image_tokens: int = 0               # stub patch-embedding prefix
    # --- training details ---
    tie_embeddings: bool = False
    norm_eps: float = 1e-6

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def is_subquadratic(self) -> bool:
        """Can this arch run the long_500k decode shape?"""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.sliding_window is not None

    @property
    def has_decoder(self) -> bool:
        return True  # every arch in the pool has an autoregressive decoder

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks), for roofline
        MODEL_FLOPS and memory-budget sanity checks."""
        d, L = self.d_model, self.num_layers
        hd = self.resolved_head_dim
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        total = emb
        if self.family == "ssm":
            d_in = self.ssm_expand * d
            nheads = d_in // self.ssm_headdim
            per = (d * (2 * d_in + 2 * self.ssm_state * 1 + nheads)  # in_proj-ish
                   + d_in * self.conv_kernel + d_in * d + 2 * d)
            # in_proj: d -> (2*d_in + 2*n_groups*state + nheads)
            per = d * (2 * d_in + 2 * self.ssm_state + nheads) + \
                d_in * self.conv_kernel + d_in * d + 2 * d + nheads * 2
            return total + L * per
        # attention params (padded q-heads included — they are real arrays)
        Hp = max(self.pad_q_heads_to or 0, self.num_heads)
        if self.attention == "mla":
            q_in = self.q_lora_rank or d
            attn = (d * self.q_lora_rank if self.q_lora_rank else 0)
            attn += q_in * self.num_heads * (self.qk_nope_head_dim + self.qk_rope_head_dim)
            attn += d * (self.kv_lora_rank + self.qk_rope_head_dim)
            attn += self.kv_lora_rank * self.num_heads * (self.qk_nope_head_dim + self.v_head_dim)
            attn += self.num_heads * self.v_head_dim * d
        else:
            attn = d * hd * (Hp + 2 * self.num_kv_heads) + Hp * hd * d
        # mlp params
        gated = self.mlp in ("swiglu", "geglu")
        dense_mlp = d * self.d_ff * (3 if gated else 2)
        if self.num_experts:
            eff = self.moe_d_ff or self.d_ff
            moe_mlp = self.num_experts * d * eff * (3 if gated else 2)
            moe_mlp += self.num_shared_experts * d * eff * (3 if gated else 2)
            moe_mlp += d * self.num_experts  # router
            n_moe = L - self.first_dense_layers
            total += n_moe * (attn + moe_mlp) + self.first_dense_layers * (attn + dense_mlp)
        else:
            total += L * (attn + dense_mlp)
        if self.family == "hybrid":
            pass  # close enough for roofline purposes; rglru ≈ attn-sized
        if self.encoder_layers:
            total += self.encoder_layers * (attn + dense_mlp)
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top-k + shared only)."""
        if not self.num_experts:
            return self.param_count()
        d, L = self.d_model, self.num_layers
        gated = self.mlp in ("swiglu", "geglu")
        eff = self.moe_d_ff or self.d_ff
        full = self.param_count()
        all_experts = (L - self.first_dense_layers) * self.num_experts * d * eff * (3 if gated else 2)
        active_experts = (L - self.first_dense_layers) * self.num_experts_per_tok * d * eff * (3 if gated else 2)
        return full - all_experts + active_experts
