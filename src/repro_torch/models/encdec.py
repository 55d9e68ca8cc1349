"""Whisper-style encoder-decoder backbone (audio): serving and training.

The JAX package's `repro.models.encdec`, in the same math. As there, the
conv frontend is a stub: the caller gives frame embeddings [B,
encoder_seq, d] (what the two strided convs would produce); without
them the frames are zeros. The backbone is real: bidirectional encoder
layers (RoPE, no mask), causal decoder layers with cross-attention into
the encoder states (no RoPE, no mask).

`prefill` runs the encoder once and caches the decoder's self-attention
keys and values and each layer's cross keys and values; `decode_step`
advances the decoder one token, writing the cache in place. The cache is
{self: {k, v, idx} [L, B, ...], cross_k, cross_v [L, B, S_enc, KV, hd]},
the JAX package's layout. On a model that keeps blocks (built with
`mesh=` a process mesh) the serving API runs on each rank's part, in the
JAX dry run's serving layout (`LM.init_cache`): the self-attention cache
split over sequence on `model` (`attention.gqa_decode`), the cross keys
and values over `kv_heads` (the rank's KV heads, or every one where the
rules leave them whole), the rows over the data axes; the logits are the
rank's rows over the whole vocabulary.

`loss_fn` takes the frames from the batch (JAX's `make_batch` gives
zeros); each encoder and decoder layer runs under `ckpt`, the cross keys
and values of a decoder layer outside it, as JAX's.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.models import attention as attn_lib
from repro_torch.models.common import (COMPUTE_DTYPE, LM, ckpt,
                                       cross_entropy, embed, param,
                                       prepend_layers_axis, rms_norm,
                                       vocab_split, zeros_init)
from repro_torch.models.mlp import MLP, mlp_forward
from repro_torch.sharding import collectives as coll
from repro_torch.sharding.layout import gathered, model_group, seq_blocks

Cache = Dict[str, object]


def _attention(p: attn_lib.GQA, q, k, v, cfg=None):
    """Unmasked attention of q [B,T,H,hd] over k, v [B,S,KV,hd], then the
    out projection (`attention.attn_out`: row-parallel on blocks)."""
    probs = torch.softmax(attn_lib._grouped_scores(q, k), dim=-1)
    return attn_lib.attn_out(p, attn_lib._grouped_out(probs, v), cfg)


def cross_attn_forward(p: attn_lib.GQA, x, enc_kv, cfg=None):
    """x [B,T,d] queries; enc_kv = (k, v) [B,S,KV,hd] precomputed (as
    this rank's query heads read them, `cross_kv`). On blocks whose query
    heads are split over `model`, x enters through `pvary`. `cfg` (the
    JAX package's argument) is needed on blocks only."""
    group = model_group(p.wq, 1)
    if group is not None:
        x = coll.pvary(x, group)
    q = attn_lib._proj(x, gathered(p.wq).to(COMPUTE_DTYPE))
    return _attention(p, q, *enc_kv, cfg)


def cross_kv_heads(p: attn_lib.GQA, enc_states):
    """The cross keys and values of the encoder states [B,S,d] (the same
    on every model rank) in the layout of the cache's `kv_heads`: on
    blocks whose key/value heads are split over `model`, this rank's,
    the states entering through `pvary`; else every head."""
    group = model_group(p.wk, 1)
    if group is not None:
        enc_states = coll.pvary(enc_states, group)
    k = attn_lib._proj(enc_states, gathered(p.wk).to(COMPUTE_DTYPE))
    v = attn_lib._proj(enc_states, gathered(p.wv).to(COMPUTE_DTYPE))
    return k, v


def cross_kv(p: attn_lib.GQA, enc_states, cfg=None):
    """The cross keys and values as this rank's query heads read them:
    `cross_kv_heads`, then, on blocks whose query heads alone are split,
    the replicated heads its query heads read
    (`attention._kv_for_heads`)."""
    return attn_lib._kv_for_heads(p, *cross_kv_heads(p, enc_states), cfg,
                                  p.wq.shape[1])


class EncLayer(nn.Module):
    AXES = dict(ln1=("embed",), ln2=("embed",))

    def __init__(self, cfg, *, device, gen):
        super().__init__()
        d = cfg.d_model
        self.ln1 = param(zeros_init((d,), device=device))
        self.attn = attn_lib.GQA(cfg, device=device, gen=gen)
        self.ln2 = param(zeros_init((d,), device=device))
        self.mlp = MLP(d, cfg.d_ff, cfg.mlp, device=device, gen=gen)


class DecLayer(nn.Module):
    AXES = dict(ln1=("embed",), ln_x=("embed",), ln2=("embed",))

    def __init__(self, cfg, *, device, gen):
        super().__init__()
        d = cfg.d_model
        self.ln1 = param(zeros_init((d,), device=device))
        self.self_attn = attn_lib.GQA(cfg, device=device, gen=gen)
        self.ln_x = param(zeros_init((d,), device=device))
        # the same projections as self-attention
        self.cross_attn = attn_lib.GQA(cfg, device=device, gen=gen)
        self.ln2 = param(zeros_init((d,), device=device))
        self.mlp = MLP(d, cfg.d_ff, cfg.mlp, device=device, gen=gen)


def enc_layer_forward(p: EncLayer, x, cfg, positions):
    """Bidirectional self-attention (no causal mask), then the MLP."""
    h = rms_norm(x, gathered(p.ln1), cfg.norm_eps)
    q, k, v = attn_lib._qkv(p.attn, h, cfg, positions[None, :])
    k, v = attn_lib._kv_for_heads(p.attn, k, v, cfg, q.shape[2])
    x = x + _attention(p.attn, q, k, v, cfg)
    return x + mlp_forward(p.mlp, rms_norm(x, gathered(p.ln2), cfg.norm_eps),
                           cfg.mlp)


def _cross_mlp(p: DecLayer, x, enc_kv, cfg):
    x = x + cross_attn_forward(
        p.cross_attn, rms_norm(x, gathered(p.ln_x), cfg.norm_eps), enc_kv,
        cfg)
    return x + mlp_forward(p.mlp, rms_norm(x, gathered(p.ln2), cfg.norm_eps),
                           cfg.mlp)


def dec_layer_forward(p: DecLayer, x, enc_kv, cfg, positions,
                      q_chunk: int = 512):
    """-> (x, self-attention keys, values)."""
    h = rms_norm(x, gathered(p.ln1), cfg.norm_eps)
    y, k, v = attn_lib.gqa_forward(p.self_attn, h, cfg, positions,
                                   q_chunk=q_chunk)
    return _cross_mlp(p, x + y, enc_kv, cfg), k, v


def dec_layer_decode(p: DecLayer, x, cache, enc_kv, cfg):
    """One token; writes the self-attention cache (k, v, idx) in place.
    enc_kv as this rank's query heads read them (`cross_kv`)."""
    h = rms_norm(x, gathered(p.ln1), cfg.norm_eps)
    y = attn_lib.gqa_decode(p.self_attn, h, cfg, cache)
    return _cross_mlp(p, x + y, enc_kv, cfg)


class EncDec(LM):
    """The encoder-decoder LM of `cfg`: embedding, `enc_layers`,
    `enc_norm`, `dec_layers`, final norm, head."""
    AXES = dict(LM.AXES, enc_norm=("embed",))

    def _build(self, cfg, device, gen) -> None:
        self.enc_layers = nn.ModuleList(
            self._kept(EncLayer(cfg, device=device, gen=gen))
            for _ in range(cfg.encoder_layers))
        self.dec_layers = nn.ModuleList(
            self._kept(DecLayer(cfg, device=device, gen=gen))
            for _ in range(cfg.num_layers))
        self.enc_norm = param(zeros_init((cfg.d_model,), device=device))

    def encode(self, frames) -> torch.Tensor:
        """frames [B, S_enc, d] (the stub frontend's output)."""
        x = frames.to(COMPUTE_DTYPE)
        positions = torch.arange(frames.shape[1], dtype=torch.int32,
                                 device=x.device)
        for layer in self.enc_layers:
            x = ckpt(lambda h, lp=layer: enc_layer_forward(
                lp, h, self.cfg, positions))(x)
        return rms_norm(x, gathered(self.enc_norm), self.cfg.norm_eps)

    def loss_fn(self, batch, *, q_chunk: int = 512, **_):
        cfg = self.cfg
        tokens = batch["tokens"]
        enc = self.encode(batch["frames"])
        x = embed(self.embed, tokens)
        positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                                 device=x.device)
        for layer in self.dec_layers:
            kv = cross_kv(layer.cross_attn, enc, cfg)
            x = ckpt(lambda h, lp=layer, kv=kv: dec_layer_forward(
                lp, h, kv, cfg, positions, q_chunk=q_chunk)[0])(x)
        ce = cross_entropy(self.logits(x), batch["labels"],
                           vocab=vocab_split(self.head()))
        return ce, dict(ce=ce, aux=ce.new_zeros(()))

    def cache_axes(self, batch: int, max_seq: int) -> dict:
        cross = ("layers", "batch", None, "kv_heads", "head_dim")
        return dict(self=prepend_layers_axis(attn_lib.GQA_CACHE_AXES),
                    cross_k=cross, cross_v=cross)

    def _cache_meta(self, batch: int, max_seq: int) -> Cache:
        cfg, L = self.cfg, self.cfg.num_layers
        self_c = attn_lib.init_gqa_cache(cfg, batch, max_seq, "meta")
        cross = torch.empty((L, batch, cfg.encoder_seq, cfg.num_kv_heads,
                             cfg.resolved_head_dim), dtype=COMPUTE_DTYPE,
                            device="meta")
        return dict(self={n: t.expand((L,) + t.shape)
                          for n, t in self_c.items()},
                    cross_k=cross, cross_v=cross)

    @torch.inference_mode()
    def prefill(self, tokens, *, frames=None, q_chunk: int = 512,
                pad_cache_to: Optional[int] = None):
        """Encode `frames` (zeros when None), run the decoder over tokens
        [B, T]: the last position's logits [B,1,V] and the cache. On
        blocks the self-attention cache is padded in global positions,
        then cut to the rank's block of the sequence
        (`layout.seq_blocks`); the cross keys and values are kept in the
        cache's `kv_heads` layout (`cross_kv_heads`)."""
        cfg = self.cfg
        B_, T = tokens.shape
        if frames is None:
            frames = torch.zeros((B_, cfg.encoder_seq, cfg.d_model),
                                 dtype=COMPUTE_DTYPE, device=tokens.device)
        enc = self.encode(frames)
        x = embed(self.embed, tokens)
        positions = torch.arange(T, dtype=torch.int32, device=x.device)
        entries = []
        for layer in self.dec_layers:
            p = layer.cross_attn
            ck, cv = cross_kv_heads(p, enc)
            kv = attn_lib._kv_for_heads(p, ck, cv, cfg, p.wq.shape[1])
            x, k, v = dec_layer_forward(layer, x, kv, cfg, positions,
                                        q_chunk=q_chunk)
            self_kv = dict(k=k, v=v)
            if pad_cache_to:
                self_kv = attn_lib.pad_layer_cache(self_kv, pad_cache_to,
                                                   cfg, T)
            sa = layer.self_attn
            entries.append(dict(seq_blocks(
                sa.wq, self_kv, model_group(sa.wk, 1) is not None),
                cross_k=ck, cross_v=cv))
        stack = {n: torch.stack([e[n] for e in entries])
                 for n in entries[0]}
        self_c = dict(k=stack["k"], v=stack["v"],
                      idx=torch.full((len(entries), B_), T,
                                     dtype=torch.int32, device=x.device))
        cache = dict(self=self_c, cross_k=stack["cross_k"],
                     cross_v=stack["cross_v"])
        return self._whole_vocab(self.logits(x[:, -1:])), cache

    @torch.inference_mode()
    def decode_step(self, cache: Cache, token) -> Tuple[torch.Tensor, Cache]:
        """token [B,1] -> (logits [B,1,V], cache updated in place). The
        cached cross keys and values are mapped to this rank's query
        heads as they are read (`attention._kv_for_heads`)."""
        x = embed(self.embed, token)
        for i, layer in enumerate(self.dec_layers):
            p = layer.cross_attn
            enc_kv = attn_lib._kv_for_heads(
                p, cache["cross_k"][i], cache["cross_v"][i], self.cfg,
                p.wq.shape[1])
            x = dec_layer_decode(
                layer, x, {n: t[i] for n, t in cache["self"].items()},
                enc_kv, self.cfg)
        return self._whole_vocab(self.logits(x)), cache
