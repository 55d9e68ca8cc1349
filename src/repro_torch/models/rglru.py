"""RecurrentGemma / Griffin hybrid: RG-LRU recurrent blocks and local
attention, serving and training.

The JAX package's `repro.models.rglru`, in the same math. The block
pattern (`cfg.block_pattern`, e.g. rglru, rglru, local) repeats in
`groups`; the layers past the last whole group are recurrent blocks in
`trailing` (38 layers = 12 groups of 3 + 2).

RG-LRU (Griffin eq. 1-4), gates in float32:
    r_t = sigmoid(W_a x_t + b_a)            recurrence gate
    i_t = sigmoid(W_x x_t + b_x)            input gate
    a_t = a^(c r_t),  a = sigmoid(Lambda), c = 8
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t x_t)

Prefill evaluates the linear recurrence with a log-depth doubling scan
over T (JAX: `jax.lax.associative_scan`, which associates in another
order); decode is the O(1) update. The local attention blocks are GQA
with `sliding_window = cfg.local_window` (`models/attention.py`'s ring).

The cache is {groups: {rec: {conv, h, idx} [G, n_rec, B, ...],
attn: {k, v, idx} [G, B, ...]}, trailing: {conv, h, idx} [n, B, ...]},
the JAX package's layout; decode writes it in place. `loss_fn` runs the
full forward, each block under `ckpt`; the doubling scan is
differentiable as written.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import attention as attn_lib
from repro_torch.models.common import (COMPUTE_DTYPE, LM, causal_conv, ckpt,
                                       cross_entropy, dense_init, embed,
                                       param, prepend_layers_axis, rms_norm,
                                       vocab_split, zeros_init)
from repro_torch.models.mlp import MLP, activation, mlp_forward
from repro_torch.sharding import collectives as coll
from repro_torch.sharding.layout import block_start, gathered, model_group
from repro_torch.sharding.rules import maybe_constrain

C_GATE = 8.0

Cache = Dict[str, Dict]


def _lru_width(cfg) -> int:
    return cfg.lru_width or cfg.d_model


def _group_layout(cfg) -> Tuple[int, int]:
    """(groups, trailing recurrent blocks)."""
    period = len(cfg.block_pattern)
    n_groups = cfg.num_layers // period
    return n_groups, cfg.num_layers - n_groups * period


def _n_rec(cfg) -> int:
    return sum(1 for b in cfg.block_pattern if b == "rglru")


def _attn_cfg(cfg):
    """Local-attention blocks use the sliding window."""
    return dataclasses.replace(cfg, sliding_window=cfg.local_window)


class RecurrentBlock(nn.Module):
    """The recurrent branch (w_in, conv, the RG-LRU gates w_a/w_x, lam
    float32), its GeLU gate w_gate_in, w_out, then the MLP."""
    AXES = dict(ln=("embed",), w_in=("embed", "ffn"),
                w_gate_in=("embed", "ffn"), conv_w=(None, "ffn"),
                conv_b=("ffn",), w_a=("ffn", "ffn_in"), b_a=("ffn",),
                w_x=("ffn", "ffn_in"), b_x=("ffn",), lam=("ffn",),
                w_out=("ffn", "embed"), ln_mlp=("embed",))

    def __init__(self, cfg, *, device, gen):
        super().__init__()
        d, w, k = cfg.d_model, _lru_width(cfg), cfg.conv_kernel

        def dense(shape, fan_in):
            return param(dense_init(gen, shape, fan_in, device=device))

        self.ln = param(zeros_init((d,), device=device))
        self.w_in = dense((d, w), d)
        self.w_gate_in = dense((d, w), d)
        self.conv_w = dense((k, w), k)
        self.conv_b = param(zeros_init((w,), device=device))
        self.w_a = dense((w, w), w)
        self.b_a = param(zeros_init((w,), device=device))
        self.w_x = dense((w, w), w)
        self.b_x = param(zeros_init((w,), device=device))
        # Lambda ~ U(2.2, 6.9), so a = sigmoid(Lambda) ~ U(0.9, 0.999)-ish
        self.lam = param(
            torch.empty((w,), dtype=torch.float32, device=device)
            if gen is None else
            torch.rand((w,), generator=gen, device=gen.device) * 4.7 + 2.2)
        self.w_out = dense((w, d), w)
        self.ln_mlp = param(zeros_init((d,), device=device))
        self.mlp = MLP(d, cfg.d_ff, cfg.mlp, device=device, gen=gen)


class AttnBlock(nn.Module):
    """Local MQA attention, then the MLP."""
    AXES = dict(ln=("embed",), ln_mlp=("embed",))

    def __init__(self, cfg, *, device, gen):
        super().__init__()
        d = cfg.d_model
        self.ln = param(zeros_init((d,), device=device))
        self.attn = attn_lib.GQA(_attn_cfg(cfg), device=device, gen=gen)
        self.ln_mlp = param(zeros_init((d,), device=device))
        self.mlp = MLP(d, cfg.d_ff, cfg.mlp, device=device, gen=gen)


class Group(nn.Module):
    """One repeat of the block pattern: `rec` recurrent blocks, then one
    attention block."""

    def __init__(self, cfg, *, device, gen):
        super().__init__()
        self.rec = nn.ModuleList(RecurrentBlock(cfg, device=device, gen=gen)
                                 for _ in range(_n_rec(cfg)))
        self.attn = AttnBlock(cfg, device=device, gen=gen)


def _rglru_scan(x_gated, a_pow, h0=None):
    """h_t = a_t h_{t-1} + b_t over dim 1, float32, by doubling: after the
    pass of stride d, (a, b)[t] combines the 2d steps ending at t (fewer
    at the start). h0, the state before step 0, folds in through the
    cumulative a."""
    a = a_pow
    b = torch.sqrt(torch.clamp(1.0 - a_pow * a_pow, min=1e-12)) * x_gated
    T, d = a.shape[1], 1
    while d < T:
        b = torch.cat([b[:, :d], b[:, :-d] * a[:, d:] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], dim=1)
        d *= 2
    if h0 is not None:
        b = b + a * h0[:, None]
    return b


def _gates(p: RecurrentBlock, xc):
    """The gates' pre-activations (xc @ w_a, xc @ w_x) in float32 of the
    conv output xc [B,T,w] float32. On blocks whose LRU width is split
    over `model`, w_a and w_x are split by rows alone: each rank's
    product over its channels of xc is a partial one over every column,
    summed over `model` (one float32 psum of the two stacked), then
    taken through `pvary` to this rank's columns."""
    group = model_group(p.w_a, 0)
    if group is None:
        return xc @ p.w_a.float(), xc @ p.w_x.float()
    both = torch.stack([xc @ gathered(p.w_a).float(),
                        xc @ gathered(p.w_x).float()])
    both = coll.pvary(coll.psum(both, group), group)
    lo = block_start(p.w_a, 0)
    mine = both[..., lo:lo + xc.shape[-1]]
    return mine[0], mine[1]


def _recurrent_branch(p: RecurrentBlock, xw, cfg, conv_hist=None, h0=None):
    """xw [B,T,w] conv input -> (y bf16, new conv history [B,k-1,w], last
    state [B,w] float32). On blocks whose LRU width is split over
    `model`, w is this rank's channels: the conv, the biases, lam and the
    scan are per channel."""
    B_, T, w = xw.shape
    k = cfg.conv_kernel
    if conv_hist is None:
        conv_hist = torch.zeros((B_, k - 1, w), dtype=xw.dtype,
                                device=xw.device)
    xp = torch.cat([conv_hist, xw], dim=1)
    # the bias added in float32: XLA keeps the sum unrounded where the
    # JAX package casts it to float32 right after
    xc = causal_conv(xp, p.conv_w).float() + p.conv_b.float()
    ra, ix = _gates(p, xc)
    r = torch.sigmoid(ra + p.b_a.float())
    i = torch.sigmoid(ix + p.b_x.float())
    log_a = -C_GATE * F.softplus(-p.lam) * r               # log a^(c r)
    h = _rglru_scan(i * xc, torch.exp(log_a), h0)
    return h.to(COMPUTE_DTYPE), xp[:, xp.shape[1] - (k - 1):], h[:, -1]


def recurrent_block_forward(p: RecurrentBlock, x, cfg, conv_hist=None,
                            h0=None):
    """x [B,T,d] -> (x, conv history [B,k-1,w], last state [B,w]); with
    no history and state, the ones before position 0 (zeros). On blocks
    whose LRU width is split over `model`, w_in and w_gate_in run
    column-parallel (the normed stream enters through `pvary`) and w_out
    row-parallel (`collectives.row_parallel`)."""
    h = rms_norm(x, gathered(p.ln), cfg.norm_eps)
    group = model_group(p.w_in, 1)
    if group is not None:
        h = coll.pvary(h, group)
    xw = torch.matmul(h, gathered(p.w_in).to(COMPUTE_DTYPE))
    gate = activation(torch.matmul(h, gathered(p.w_gate_in).to(
        COMPUTE_DTYPE)), "gelu")
    y, hist, h_last = _recurrent_branch(p, xw, cfg, conv_hist, h0)
    w_out = gathered(p.w_out).to(COMPUTE_DTYPE)
    x = x + (torch.matmul(y * gate, w_out) if group is None
             else coll.row_parallel(y * gate, w_out, group))
    x = maybe_constrain(x, ("batch", "seq", "embed"))
    x = x + mlp_forward(p.mlp, rms_norm(x, gathered(p.ln_mlp), cfg.norm_eps),
                        cfg.mlp)
    return x, hist, h_last


def recurrent_block_decode(p: RecurrentBlock, x, cfg, cache):
    """One token; writes this block's cache (conv, h, idx) in place."""
    x, hist, h_last = recurrent_block_forward(p, x, cfg, cache["conv"],
                                              cache["h"])
    cache["conv"].copy_(hist)
    cache["h"].copy_(h_last)
    cache["idx"] += 1
    return x


def _attn_mlp(p: AttnBlock, x, y, cfg):
    x = x + y
    return x + mlp_forward(p.mlp, rms_norm(x, gathered(p.ln_mlp),
                                           cfg.norm_eps), cfg.mlp)


def attn_block_forward(p: AttnBlock, x, cfg, positions, *,
                       q_chunk: int = 512):
    """`cfg` with the window (`_attn_cfg`). -> (x, k, v), k and v trimmed
    to the last `local_window` positions."""
    h = rms_norm(x, gathered(p.ln), cfg.norm_eps)
    y, k, v = attn_lib.gqa_forward(p.attn, h, cfg, positions,
                                   q_chunk=q_chunk)
    w = cfg.local_window
    if k.shape[1] > w:
        k, v = k[:, -w:], v[:, -w:]
    return _attn_mlp(p, x, y, cfg), k, v


def attn_block_decode(p: AttnBlock, x, cfg, cache):
    h = rms_norm(x, p.ln, cfg.norm_eps)
    return _attn_mlp(p, x, attn_lib.gqa_decode(p.attn, h, cfg, cache), cfg)


def _stack(entries):
    """A list of caches of one layout -> one cache, the list as dim 0."""
    return {n: torch.stack([e[n] for e in entries]) for n in entries[0]}


class RecurrentGemma(LM):
    """The Griffin LM of `cfg`: embedding, `groups` (one `Group` each),
    `trailing` recurrent blocks, final norm, head."""

    def _build(self, cfg, device, gen) -> None:
        n_groups, trailing = _group_layout(cfg)
        self.groups = nn.ModuleList(
            self._kept(Group(cfg, device=device, gen=gen))
            for _ in range(n_groups))
        self.trailing = nn.ModuleList(
            self._kept(RecurrentBlock(cfg, device=device, gen=gen))
            for _ in range(trailing))

    def loss_fn(self, batch, *, q_chunk: int = 512, **_):
        cfg, acfg = self.cfg, _attn_cfg(self.cfg)
        tokens = batch["tokens"]
        x = embed(self.embed, tokens)
        positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                                 device=x.device)

        def rec(h, b):
            return recurrent_block_forward(b, h, cfg)[0]

        for group in self.groups:
            for block in group.rec:
                x = ckpt(rec)(x, block)
            x = ckpt(lambda h, b=group.attn: attn_block_forward(
                b, h, acfg, positions, q_chunk=q_chunk)[0])(x)
        for block in self.trailing:
            x = ckpt(rec)(x, block)
        ce = cross_entropy(self.logits(x), batch["labels"],
                           vocab=vocab_split(self.head()))
        return ce, dict(ce=ce, aux=ce.new_zeros(()))

    def cache_axes(self, batch: int, max_seq: int) -> dict:
        rec = dict(conv=("batch", None, "ffn"), h=("batch", "ffn"),
                   idx=("batch",))
        axes = dict(groups=dict(
            rec=prepend_layers_axis(prepend_layers_axis(rec)),
            attn=prepend_layers_axis(attn_lib.GQA_CACHE_AXES)))
        if len(self.trailing):
            axes["trailing"] = prepend_layers_axis(rec)
        return axes

    @torch.inference_mode()
    def init_cache(self, batch: int, max_seq: int) -> Cache:
        self.serve_whole()
        cfg, dev = self.cfg, self.device
        w, k = _lru_width(cfg), cfg.conv_kernel
        rec = dict(conv=torch.zeros((batch, k - 1, w), dtype=COMPUTE_DTYPE,
                                    device=dev),
                   h=torch.zeros((batch, w), dtype=torch.float32, device=dev),
                   idx=torch.zeros((batch,), dtype=torch.int32, device=dev))
        attn = attn_lib.init_gqa_cache(_attn_cfg(cfg), batch, max_seq, dev)

        def stack(c, *lead):
            return {n: t.expand(lead + t.shape).clone() for n, t in c.items()}

        cache = dict(groups=dict(rec=stack(rec, len(self.groups),
                                           _n_rec(cfg)),
                                 attn=stack(attn, len(self.groups))))
        if len(self.trailing):
            cache["trailing"] = stack(rec, len(self.trailing))
        return cache

    @torch.inference_mode()
    def prefill(self, tokens, *, q_chunk: int = 512,
                pad_cache_to: Optional[int] = None):
        """Full forward over tokens [B, T]: the last position's logits
        [B,1,V] and the cache. The attention blocks keep their last
        `local_window` keys; `pad_cache_to` grows or rolls them into the
        ring of decode."""
        self.serve_whole()
        cfg, acfg = self.cfg, _attn_cfg(self.cfg)
        B_, T = tokens.shape
        x = embed(self.embed, tokens)
        positions = torch.arange(T, dtype=torch.int32, device=x.device)
        idx = torch.full((B_,), T, dtype=torch.int32, device=x.device)

        def rec_stack(x, blocks):
            entries = []
            for block in blocks:
                x, hist, h_last = recurrent_block_forward(block, x, cfg)
                entries.append(dict(conv=hist, h=h_last, idx=idx))
            return x, _stack(entries)

        recs, attns = [], []
        for group in self.groups:
            x, rec = rec_stack(x, group.rec)
            recs.append(rec)
            x, kc, vc = attn_block_forward(group.attn, x, acfg, positions,
                                           q_chunk=q_chunk)
            attns.append(dict(k=kc, v=vc, idx=idx))
        attn = _stack(attns)
        if pad_cache_to:
            attn = attn_lib.pad_stacked_cache(attn, pad_cache_to, acfg, T)
        cache = dict(groups=dict(rec=_stack(recs), attn=attn))
        if len(self.trailing):
            x, cache["trailing"] = rec_stack(x, self.trailing)
        return self.logits(x[:, -1:]), cache

    @torch.inference_mode()
    def decode_step(self, cache: Cache, token) -> Tuple[torch.Tensor, Cache]:
        """token [B,1] -> (logits [B,1,V], cache updated in place)."""
        self.serve_whole()
        cfg, acfg = self.cfg, _attn_cfg(self.cfg)
        x = embed(self.embed, token)
        rec, attn = cache["groups"]["rec"], cache["groups"]["attn"]
        for g, group in enumerate(self.groups):
            for r, block in enumerate(group.rec):
                x = recurrent_block_decode(
                    block, x, cfg, {n: t[g, r] for n, t in rec.items()})
            x = attn_block_decode(group.attn, x, acfg,
                                  {n: t[g] for n, t in attn.items()})
        for i, block in enumerate(self.trailing):
            x = recurrent_block_decode(
                block, x, cfg, {n: t[i] for n, t in cache["trailing"].items()})
        return self.logits(x), cache
