"""Attention: GQA (+bias, +qk-norm, +sliding-window) and MLA (DeepSeek-V2).

The JAX package's `repro.models.attention`, in the same math: float32
scores, a NEG_INF mask, float32 softmax, probabilities cast to bf16 before
the value product. No fused attention call stands in for it.

  * prefill runs blockwise over query chunks (exact: the whole key axis
    is resident for each chunk), chunking only when T divides evenly;
  * decode is one step of attention over the cache; MLA decode uses the
    absorbed form, scoring against the compressed c_kv latent, which is
    never decompressed.

KV caches are laid out [B, S_max, ...] per layer, stacked [L, B, S_max,
...] per layer stack, with a per-sequence position `idx` [B] (stacked
[L, B]). Unlike JAX, decode writes the cache in place: the views a layer
gets are slices of the stacked tensors.

On a model that keeps blocks (`sharding.layout`) decode takes the JAX
dry run's serving layout: each rank holds its rows and its block of the
sequence (`layout.seq_group`: `cache_seq` over `model`), every KV head
whole. The rank computes q, k and v of its heads as training does; the
new token's k and v and the queries are gathered over `model`; only the
rank whose block holds a row's slot writes it; each rank scores every
head against its own positions, and the softmax is combined over
`model` in float32 by log-sum-exp (`_combine`), after which the rank
takes its heads' part into the row-parallel out projection.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.common import (COMPUTE_DTYPE, apply_rope,
                                       dense_init, param, rms_norm,
                                       rope_tables, zeros_init)
from repro_torch.sharding import collectives as coll
from repro_torch.sharding.layout import (block_start, gathered, model_group,
                                        seq_group)

NEG_INF = -1e30


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("btd,d...->bt...", x, w): x [..., d] times w [d, *out]."""
    return torch.matmul(x, w.reshape(w.shape[0], -1)).unflatten(
        -1, w.shape[1:])


def _out_proj(x: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum("bthk,hkd->btd", x, wo)."""
    return torch.matmul(x.flatten(-2), wo.reshape(-1, wo.shape[-1]))


# ---------------------------------------------------------------------------
# GQA
# ---------------------------------------------------------------------------

def _padded_heads(cfg) -> int:
    return max(cfg.pad_q_heads_to or 0, cfg.num_heads)


def _head_mask(cfg, device, heads=None) -> Optional[torch.Tensor]:
    """[Hp] 1/0 mask; padded heads are zeroed before the out projection so
    they contribute no output. `heads` (first, count): the mask of those
    query heads alone."""
    Hp, H = _padded_heads(cfg), cfg.num_heads
    if Hp == H:
        return None
    first, n = heads if heads is not None else (0, Hp)
    return (torch.arange(first, first + n, device=device) < H).to(
        COMPUTE_DTYPE)


class GQA(nn.Module):
    """wq [d, Hp, hd] and wo [Hp, hd, d] (padded query heads zero),
    wk, wv [d, KV, hd]; bq/bk/bv with `qkv_bias`, q_norm/k_norm [hd] with
    `qk_norm`."""
    AXES = dict(wq=("embed", "q_heads", "head_dim"),
                wk=("embed", "kv_heads", "head_dim"),
                wv=("embed", "kv_heads", "head_dim"),
                wo=("q_heads", "head_dim", "embed"),
                bq=("q_heads", "head_dim"), bk=("kv_heads", "head_dim"),
                bv=("kv_heads", "head_dim"),
                q_norm=("head_dim",), k_norm=("head_dim",))

    def __init__(self, cfg, *, device, gen):
        super().__init__()
        d, H, KV = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
        Hp, hd = _padded_heads(cfg), cfg.resolved_head_dim

        def padh(w, axis):  # zero the padded head slots
            if Hp == H:
                return w
            shape = list(w.shape)
            shape[axis] = Hp - H
            return torch.cat([w, torch.zeros(shape, dtype=w.dtype,
                                             device=w.device)], dim=axis)

        self.wq = param(padh(dense_init(gen, (d, H, hd), d, device=device),
                             1))
        self.wk = param(dense_init(gen, (d, KV, hd), d, device=device))
        self.wv = param(dense_init(gen, (d, KV, hd), d, device=device))
        self.wo = param(padh(dense_init(gen, (H, hd, d), H * hd,
                                        device=device), 0))
        if cfg.qkv_bias:
            self.bq = param(zeros_init((Hp, hd), device=device))
            self.bk = param(zeros_init((KV, hd), device=device))
            self.bv = param(zeros_init((KV, hd), device=device))
        if cfg.qk_norm:
            self.q_norm = param(zeros_init((hd,), device=device))
            self.k_norm = param(zeros_init((hd,), device=device))


def _qkv(p: GQA, x, cfg, positions):
    """q, k, v of the heads this rank computes: all of them, or on blocks
    whose query heads are split over `model` its query heads (x enters
    through `pvary`) and its own key/value heads when `kv_heads` are
    split too, else every key/value head (see `_kv_for_heads`)."""
    hd = cfg.resolved_head_dim
    group = model_group(p.wq, 1)
    kv_split = model_group(p.wk, 1) is not None
    xq = x if group is None else coll.pvary(x, group)
    xk = xq if kv_split else x
    q = _proj(xq, gathered(p.wq).to(COMPUTE_DTYPE))
    k = _proj(xk, gathered(p.wk).to(COMPUTE_DTYPE))
    v = _proj(xk, gathered(p.wv).to(COMPUTE_DTYPE))
    if cfg.qkv_bias:
        q = q + p.bq.to(COMPUTE_DTYPE)
        k = k + p.bk.to(COMPUTE_DTYPE)
        v = v + p.bv.to(COMPUTE_DTYPE)
    if cfg.qk_norm:
        qn = p.q_norm if group is None else coll.pvary(p.q_norm, group)
        kn = p.k_norm if not kv_split else coll.pvary(p.k_norm, group)
        q = rms_norm(q, qn, cfg.norm_eps)
        k = rms_norm(k, kn, cfg.norm_eps)
    cos, sin = rope_tables(positions, hd, cfg.rope_theta)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _kv_for_heads(p: GQA, k, v, cfg, n_heads: int):
    """k, v as this rank's query heads read them: as they are, unless the
    query heads are split over `model` and the key/value heads are not;
    then the replicated key/value heads that its `n_heads` query heads
    read, each query head's own (GQA's groups are contiguous runs of
    Hp / KV query heads), taken through `pvary`."""
    group = model_group(p.wq, 1)
    if group is None or model_group(p.wk, 1) is not None:
        return k, v
    heads = (torch.arange(n_heads, device=k.device) + block_start(p.wq, 1)
             ) // (_padded_heads(cfg) // cfg.num_kv_heads)
    return (coll.pvary(k, group).index_select(2, heads),
            coll.pvary(v, group).index_select(2, heads))


def attn_out(p, out, cfg):
    """The out projection of the heads' outputs out [B, T, H, hd] (padded
    heads zeroed; none when `cfg` is None) by wo [H, hd, d] (GQA's or
    MLA's); on blocks whose heads are split over `model`, row-parallel
    (`collectives.row_parallel`)."""
    mask_h = cfg and _head_mask(cfg, out.device, (block_start(p.wo, 0),
                                                  out.shape[2]))
    if mask_h is not None:
        out = out * mask_h[:, None]
    wo = gathered(p.wo).to(COMPUTE_DTYPE)
    group = model_group(p.wo, 0)
    if group is None:
        return _out_proj(out, wo)
    return coll.row_parallel(out.flatten(-2), wo.reshape(-1, wo.shape[-1]),
                             group)


def _grouped_scores(q, k):
    """q [B,T,H,hd], k [B,S,KV,hd] -> scores [B,KV,G,T,S] float32."""
    B, T, H, hd = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, T, KV, H // KV, hd)
    s = torch.einsum("btkgd,bskd->bkgts", qg.float(), k.float())
    return s / math.sqrt(hd)


def _grouped_out(probs, v):
    """probs [B,KV,G,T,S] float32, v [B,S,KV,hd] -> [B,T,H,hd]."""
    B, KV, G, T, S = probs.shape
    out = torch.einsum("bkgts,bskd->btkgd", probs.to(COMPUTE_DTYPE), v)
    return out.reshape(B, T, KV * G, v.shape[-1])


def _causal_mask(q_pos, k_pos, window: Optional[int]):
    m = k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        m &= k_pos[None, :] > (q_pos[:, None] - window)
    return m


def _n_chunks(T: int, q_chunk: int) -> int:
    return T // q_chunk if (q_chunk < T and T % q_chunk == 0) else 1


def gqa_forward(p: GQA, x, cfg, positions, *, q_chunk: int = 512):
    """Full-sequence causal attention, blockwise over query chunks.

    positions: [T] int32 (shared across the batch; no packing). Returns
    (out, k, v): prefill caches the keys and values (JAX recomputes them).
    On blocks whose query heads are split over `model`, each rank attends
    with its heads and wo runs row-parallel: the partial outputs are
    summed over `model`; k and v are then the rank's key/value heads, or
    every one where `kv_heads` are not split."""
    B, T, _ = x.shape
    q, k, v = _qkv(p, x, cfg, positions[None, :])
    kh, vh = _kv_for_heads(p, k, v, cfg, q.shape[2])
    n_chunks = _n_chunks(T, q_chunk)
    outs = []
    for qi, qpi in zip(q.chunk(n_chunks, dim=1),
                       positions.chunk(n_chunks)):
        s = _grouped_scores(qi, kh)                      # [B,KV,G,qc,S]
        mask = _causal_mask(qpi, positions, cfg.sliding_window)
        s = torch.where(mask, s, NEG_INF)
        outs.append(_grouped_out(torch.softmax(s, dim=-1), vh))
    out = torch.cat(outs, dim=1) if n_chunks > 1 else outs[0]
    return attn_out(p, out, cfg), k, v


def pad_stacked_cache(cache: Dict[str, torch.Tensor], max_seq: int, cfg,
                      prompt_len: int) -> Dict[str, torch.Tensor]:
    """Grow a prefill-built stacked cache ([L, B, S, ...]) to decode
    capacity `max_seq` along the sequence axis (dim 2).

    Sliding-window caches are ring buffers of size `window`; instead of
    padding they are rolled so the ring invariant slot == token % window
    holds for subsequent decode steps."""
    def pad(x, to):
        return F.pad(x, [0, 0] * (x.ndim - 3) + [0, to - x.shape[2]])

    if "k" in cache:  # GQA
        S = cache["k"].shape[2]
        if cfg.sliding_window:
            # ring buffer of size min(window, max_seq); invariant:
            # slot == token % size
            target = min(cfg.sliding_window, max_seq)
            if S == target and prompt_len >= target:
                shift = prompt_len % target
                return dict(cache, k=torch.roll(cache["k"], shift, dims=2),
                            v=torch.roll(cache["v"], shift, dims=2))
            if S < target:
                return dict(cache, k=pad(cache["k"], target),
                            v=pad(cache["v"], target))
            return cache
        if S < max_seq:
            return dict(cache, k=pad(cache["k"], max_seq),
                        v=pad(cache["v"], max_seq))
        return cache
    # MLA
    if cache["c_kv"].shape[2] < max_seq:
        return dict(cache, c_kv=pad(cache["c_kv"], max_seq),
                    k_rope=pad(cache["k_rope"], max_seq))
    return cache


def pad_layer_cache(kv: Dict[str, torch.Tensor], max_seq: int, cfg,
                    prompt_len: int) -> Dict[str, torch.Tensor]:
    """`pad_stacked_cache` of one layer's entries [B, S, ...]."""
    return {n: t[0] for n, t in pad_stacked_cache(
        {n: t[None] for n, t in kv.items()}, max_seq, cfg,
        prompt_len).items()}


GQA_CACHE_AXES = dict(k=("batch", "cache_seq", "kv_heads", "head_dim"),
                      v=("batch", "cache_seq", "kv_heads", "head_dim"),
                      idx=("batch",))
MLA_CACHE_AXES = dict(c_kv=("batch", "cache_seq", "kv_lora"),
                      k_rope=("batch", "cache_seq", "head_dim"),
                      idx=("batch",))


def init_gqa_cache(cfg, batch: int, max_seq: int, device
                   ) -> Dict[str, torch.Tensor]:
    """idx is a per-sequence position vector [B]: decode slots advance
    independently (continuous batching admits requests at any time)."""
    KV, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    seq = min(max_seq, cfg.sliding_window) if cfg.sliding_window else max_seq
    return dict(
        k=torch.zeros((batch, seq, KV, hd), dtype=COMPUTE_DTYPE,
                      device=device),
        v=torch.zeros((batch, seq, KV, hd), dtype=COMPUTE_DTYPE,
                      device=device),
        idx=torch.zeros((batch,), dtype=torch.int32, device=device))


def _ring_slot(idx, S: int, window: Optional[int]):
    """Where token idx goes: idx % S in a ring buffer, else min(idx, S-1)."""
    return idx % S if window else torch.clamp(idx, max=S - 1)


def _seq_block(cache_leaf, group):
    """(S, s0): the whole cache's length and the first position of this
    rank's block of it (dim 1 of a layer's leaf [B, S_loc, ...])."""
    n = cache_leaf.shape[1]
    if group is None:
        return n, 0
    return n * group.shards, n * group.rank


def _write_owned(leaf, at, new):
    """leaf[b, at[b]] = new[b] for each row b whose slot lies in this
    rank's block of the sequence (at = slot - s0 in [0, S_loc): every row
    on one rank); the other rows write back what they read. No host
    sync."""
    n = leaf.shape[1]
    own = (at >= 0) & (at < n)
    at = at.clamp(0, n - 1)
    bidx = torch.arange(leaf.shape[0], device=leaf.device)
    own = own.view((-1,) + (1,) * (new.ndim - 1))
    leaf[bidx, at] = torch.where(own, new.to(leaf.dtype), leaf[bidx, at])


def _combine(s, attend, group):
    """softmax(s) over the last dim, applied by `attend` to the values,
    where s [..., S_loc] float32 holds this rank's block of the positions
    split over `group`: each rank's local max m, sum l and unnormalised
    output o = attend(exp(s - m)) (float32, [..., D] with s's leading
    dims) combined by log-sum-exp: M = pmax(m), L = psum(l e^(m - M)),
    O = psum(o e^(m - M)), out = O / L. A rank with no valid position
    (every score NEG_INF) has m = NEG_INF and contributes
    e^(NEG_INF - M) = 0."""
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    l = e.sum(dim=-1, keepdim=True)
    o = attend(e)
    top = m.clone()
    coll.pmax_(top, group)
    scale = torch.exp(m - top)
    buf = torch.cat([(l * scale).flatten(), (o * scale).flatten()])
    coll.all_reduce_(buf, group)
    L = buf[:l.numel()].view(l.shape)
    return buf[l.numel():].view(o.shape) / L


def gqa_decode(p: GQA, x, cfg, cache):
    """One-token decode. x [B,1,d]. Writes the new key and value into
    `cache` (k, v [B,S,KV,hd], idx [B]) in place and advances idx.
    Sliding-window caches are ring buffers. On blocks, the cache is the
    rank's rows and sequence block with every KV head (module doc)."""
    B = x.shape[0]
    idx = cache["idx"]                                   # [B]
    q, k, v = _qkv(p, x, cfg, idx[:, None])
    group = seq_group(p.wq)
    qg, kg = model_group(p.wq, 1), model_group(p.wk, 1)
    if qg is not None:
        q = coll.all_gather(q, qg, 2)                    # [B,1,Hp,hd]
    if kg is not None:
        k, v = coll.all_gather(k, kg, 2), coll.all_gather(v, kg, 2)
    S, s0 = _seq_block(cache["k"], group)
    slot = _ring_slot(idx, S, cfg.sliding_window).long()
    _write_owned(cache["k"], slot - s0, k[:, 0])
    _write_owned(cache["v"], slot - s0, v[:, 0])
    s = _grouped_scores(q, cache["k"])                   # [B,KV,G,1,S_loc]
    kpos = s0 + torch.arange(cache["k"].shape[1], device=x.device)
    if cfg.sliding_window:
        # ring buffer: valid slots are the last min(idx+1, S) writes
        age = (slot[:, None] - kpos[None, :]) % S
        valid = age < torch.clamp(idx + 1, max=S)[:, None]
    else:
        valid = kpos[None, :] <= idx[:, None]
    s = torch.where(valid[:, None, None, None, :], s, NEG_INF)
    if group is None:
        out = _grouped_out(torch.softmax(s, dim=-1), cache["v"])
    else:
        vf = cache["v"].float()
        o = _combine(s, lambda e: torch.einsum("bkgts,bskd->bkgtd", e, vf),
                     group)                              # [B,KV,G,1,hd]
        out = o.permute(0, 3, 1, 2, 4).reshape(
            B, 1, -1, vf.shape[-1]).to(COMPUTE_DTYPE)
        if qg is not None:                  # this rank's heads' part
            out = out.narrow(2, block_start(p.wo, 0), p.wo.shape[0])
    idx += 1
    return attn_out(p, out, cfg)


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2)
# ---------------------------------------------------------------------------

class MLA(nn.Module):
    """Low-rank queries (wq_a, q_norm, wq_b), the compressed key/value
    latent (wkv_a, kv_norm) and its up-projections (wkv_b_k, wkv_b_v)."""
    AXES = dict(wq_a=("embed", "q_lora"), q_norm=("q_lora",),
                wq_b=("q_lora", "q_heads", "head_dim"),
                wkv_a=("embed", "kv_lora"), kv_norm=("kv_lora",),
                wkv_b_k=("kv_lora", "q_heads", "head_dim"),
                wkv_b_v=("kv_lora", "q_heads", "head_dim"),
                wo=("q_heads", "head_dim", "embed"))

    def __init__(self, cfg, *, device, gen):
        super().__init__()
        d, H = cfg.d_model, cfg.num_heads
        nope, rope_d = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
        vh, qlr, kvlr = cfg.v_head_dim, cfg.q_lora_rank, cfg.kv_lora_rank

        def w(shape, fan_in):
            return param(dense_init(gen, shape, fan_in, device=device))

        self.wq_a = w((d, qlr), d)
        self.q_norm = param(zeros_init((qlr,), device=device))
        self.wq_b = w((qlr, H, nope + rope_d), qlr)
        self.wkv_a = w((d, kvlr + rope_d), d)
        self.kv_norm = param(zeros_init((kvlr,), device=device))
        self.wkv_b_k = w((kvlr, H, nope), kvlr)
        self.wkv_b_v = w((kvlr, H, vh), kvlr)
        self.wo = w((H, vh, d), H * vh)


def _mla_q(p: MLA, x, cfg, positions):
    """(q_nope, q_rope) of this rank's heads: the query latent computed
    whole (wq_a gathered over the data axes), then, on blocks whose heads
    are split over `model`, taken through `pvary` into wq_b's heads."""
    nope, rope_d = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    q_lat = rms_norm(torch.matmul(x, gathered(p.wq_a).to(COMPUTE_DTYPE)),
                     gathered(p.q_norm), cfg.norm_eps)
    group = model_group(p.wq_b, 1)
    if group is not None:
        q_lat = coll.pvary(q_lat, group)
    q = _proj(q_lat, gathered(p.wq_b).to(COMPUTE_DTYPE))
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    cos, sin = rope_tables(positions, rope_d, cfg.rope_theta)
    return q_nope, apply_rope(q_rope, cos, sin)


def _mla_kv_latent(p: MLA, x, cfg, positions):
    """(c_kv, k_rope), computed whole on every rank (wkv_a gathered over
    the data axes)."""
    kvlr, rope_d = cfg.kv_lora_rank, cfg.qk_rope_head_dim
    kv = torch.matmul(x, gathered(p.wkv_a).to(COMPUTE_DTYPE))
    c_kv = rms_norm(kv[..., :kvlr], gathered(p.kv_norm), cfg.norm_eps)
    k_rope = kv[..., None, kvlr:]  # [B,T,1,rope_d] shared across heads
    cos, sin = rope_tables(positions, rope_d, cfg.rope_theta)
    return c_kv, apply_rope(k_rope, cos, sin)[..., 0, :]


def _mla_scale(cfg) -> float:
    return 1.0 / math.sqrt(cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)


def mla_forward(p: MLA, x, cfg, positions, *, q_chunk: int = 512):
    """Prefill MLA: keys decompressed from the latent (exact). Returns
    (out, c_kv, k_rope): prefill caches the latent. On blocks whose heads
    are split over `model`, the latents enter this rank's heads through
    `pvary` (so wq_a, wkv_a and the norms take their whole gradient on
    every model rank, and k_rope, which every head reads, its heads'
    on all of them), and wo runs row-parallel (`attn_out`)."""
    B, T, _ = x.shape
    q_nope, q_rope = _mla_q(p, x, cfg, positions[None, :])
    c_kv, k_rope = _mla_kv_latent(p, x, cfg, positions[None, :])
    group = model_group(p.wkv_b_k, 1)
    c_in, kr = ((c_kv, k_rope) if group is None else
                (coll.pvary(c_kv, group), coll.pvary(k_rope, group)))
    k_nope = _proj(c_in, gathered(p.wkv_b_k).to(COMPUTE_DTYPE)).float()
    v = _proj(c_in, gathered(p.wkv_b_v).to(COMPUTE_DTYPE))
    kr = kr.float()
    scale = _mla_scale(cfg)
    n_chunks = _n_chunks(T, q_chunk)
    outs = []
    for qni, qri, qpi in zip(q_nope.chunk(n_chunks, dim=1),
                             q_rope.chunk(n_chunks, dim=1),
                             positions.chunk(n_chunks)):
        s = (torch.einsum("bthk,bshk->bhts", qni.float(), k_nope)
             + torch.einsum("bthk,bsk->bhts", qri.float(), kr)) * scale
        mask = _causal_mask(qpi, positions, None)
        s = torch.where(mask, s, NEG_INF)
        probs = torch.softmax(s, dim=-1).to(COMPUTE_DTYPE)
        outs.append(torch.einsum("bhts,bshk->bthk", probs, v))
    out = torch.cat(outs, dim=1) if n_chunks > 1 else outs[0]
    return attn_out(p, out, cfg), c_kv, k_rope


def init_mla_cache(cfg, batch: int, max_seq: int, device
                   ) -> Dict[str, torch.Tensor]:
    return dict(
        c_kv=torch.zeros((batch, max_seq, cfg.kv_lora_rank),
                         dtype=COMPUTE_DTYPE, device=device),
        k_rope=torch.zeros((batch, max_seq, cfg.qk_rope_head_dim),
                           dtype=COMPUTE_DTYPE, device=device),
        idx=torch.zeros((batch,), dtype=torch.int32, device=device))


def mla_decode(p: MLA, x, cfg, cache):
    """Absorbed-form decode: attention runs against the compressed latent.
    Writes the new latent into `cache` in place and advances idx. On
    blocks (module doc) the latent, whole on every rank, is written by
    the owner of its slot; the absorbed queries of every head are
    gathered over `model`, and the latent output `out_lat` is combined
    over it before the rank's heads of wkv_b_v and wo."""
    idx = cache["idx"]                                   # [B]
    positions = idx[:, None]
    q_nope, q_rope = _mla_q(p, x, cfg, positions)        # [B,1,H,*]
    c_new, kr_new = _mla_kv_latent(p, x, cfg, positions)
    c_kv, k_rope = cache["c_kv"], cache["k_rope"]
    group, hg = seq_group(p.wq_b), model_group(p.wkv_b_k, 1)
    S, s0 = _seq_block(c_kv, group)
    slot = torch.clamp(idx, max=S - 1).long()
    _write_owned(c_kv, slot - s0, c_new[:, 0])
    _write_owned(k_rope, slot - s0, kr_new[:, 0])
    # absorb W^UK into q: q_c [B,1,H,kv_lora]
    q_c = torch.einsum("bthk,rhk->bthr", q_nope,
                       gathered(p.wkv_b_k).to(COMPUTE_DTYPE))
    if hg is not None:
        q_c, q_rope = coll.all_gather(q_c, hg, 2), coll.all_gather(
            q_rope, hg, 2)
    s = (torch.einsum("bthr,bsr->bhts", q_c.float(), c_kv.float())
         + torch.einsum("bthk,bsk->bhts", q_rope.float(), k_rope.float())
         ) * _mla_scale(cfg)
    kpos = s0 + torch.arange(c_kv.shape[1], device=x.device)
    valid = kpos[None, :] <= idx[:, None]
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    if group is None:
        probs = torch.softmax(s, dim=-1).to(COMPUTE_DTYPE)
        # attend in latent space, then decompress
        out_lat = torch.einsum("bhts,bsr->bthr", probs, c_kv)
    else:
        cf = c_kv.float()
        o = _combine(s, lambda e: torch.einsum("bhts,bsr->bhtr", e, cf),
                     group)                              # [B,H,1,kv_lora]
        out_lat = o.transpose(1, 2).to(COMPUTE_DTYPE)    # [B,1,H,kv_lora]
        if hg is not None:                  # this rank's heads' part
            out_lat = out_lat.narrow(2, block_start(p.wkv_b_v, 1),
                                     p.wkv_b_v.shape[1])
    out = torch.einsum("bthr,rhk->bthk", out_lat,
                       gathered(p.wkv_b_v).to(COMPUTE_DTYPE))
    idx += 1
    return attn_out(p, out, cfg)
