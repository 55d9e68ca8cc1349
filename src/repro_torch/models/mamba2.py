"""Mamba-2 (SSD, state-space duality) language model: serving and
training.

The JAX package's `repro.models.mamba2`, in the same math. Prefill runs
the chunked dual form (quadratic within a chunk of `cfg.ssm_chunk`
positions, a linear pass of the state between chunks); decode is the
O(1) recurrent update of a [B, H, P, N] float32 state.

Layout: d_inner = expand * d_model, H = d_inner / headdim heads, B and C
shared by the heads (one group), a depthwise causal conv (kernel
`cfg.conv_kernel`) over [x, B, C].

The SSD contractions run in float32 as explicit two-operand products, in
an order chosen here (no `opt_einsum` path search), so no [b, c, l, s, h]
intermediate is built. They need full float32 matmuls: decode and the
full forward part if TF32 is enabled.

The cache is {conv [L, B, k-1, conv_dim] bf16, ssm [L, B, H, P, N]
float32, idx [L, B] int32}, the JAX package's layout; decode writes it
in place. `loss_fn` runs the full forward, each layer under `ckpt`.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.common import (COMPUTE_DTYPE, LM, causal_conv, ckpt,
                                       cross_entropy, dense_init, embed,
                                       ones_init, param, rms_norm,
                                       vocab_split, zeros_init)
from repro_torch.sharding import collectives as coll
from repro_torch.sharding.layout import block_start, gathered, model_group
from repro_torch.sharding.rules import maybe_constrain

Cache = Dict[str, torch.Tensor]


def _dims(cfg) -> Tuple[int, int, int, int]:
    """(d_inner, heads, state size, conv channels)."""
    d_in = cfg.ssm_expand * cfg.d_model
    H = d_in // cfg.ssm_headdim
    N = cfg.ssm_state
    conv_dim = d_in + 2 * N
    return d_in, H, N, conv_dim


class Mamba2Block(nn.Module):
    """in_proj [d, d_in + conv_dim + H] gives z, x|B|C and dt; A_log,
    dt_bias and D [H] are float32."""
    AXES = dict(ln=("embed",), in_proj=("embed", "ffn"),
                conv_w=(None, "ffn"), conv_b=("ffn",),
                A_log=("q_heads",), dt_bias=("q_heads",), D=("q_heads",),
                norm=("ffn",), out_proj=("ffn", "embed"))

    def __init__(self, cfg, *, device, gen):
        super().__init__()
        d = cfg.d_model
        d_in, H, N, conv_dim = _dims(cfg)
        k = cfg.conv_kernel
        self.ln = param(zeros_init((d,), device=device))
        self.in_proj = param(dense_init(gen, (d, d_in + conv_dim + H), d,
                                        device=device))
        self.conv_w = param(dense_init(gen, (k, conv_dim), k, device=device))
        self.conv_b = param(zeros_init((conv_dim,), device=device))
        self.A_log = param(zeros_init((H,), torch.float32, device=device))
        self.dt_bias = param(zeros_init((H,), torch.float32, device=device))
        self.D = param(ones_init((H,), torch.float32, device=device))
        self.norm = param(zeros_init((d_in,), device=device))
        self.out_proj = param(dense_init(gen, (d_in, d), d_in,
                                         device=device))


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x [..., T] -> lower-triangular pairwise cumulative sums [..., T, T]
    (the difference of two cumsums, -inf above the diagonal)."""
    T = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((T, T), dtype=torch.bool, device=x.device))
    return torch.where(mask, diff, -torch.inf)


def ssd_chunked(x, dtA, B, C, chunk: int, init_state=None):
    """SSD dual form, float32.

    x [b,l,h,p] (already dt-scaled), dtA [b,l,h], B/C [b,l,n], l a
    multiple of `chunk`. Returns (y [b,l,h,p], final state [b,h,p,n])."""
    b, l, h, pdim = x.shape
    n = B.shape[-1]
    c = l // chunk
    xr = x.reshape(b, c, chunk, h, pdim)
    Ar = dtA.reshape(b, c, chunk, h).permute(0, 3, 1, 2)      # [b,h,c,Q]
    Br = B.reshape(b, c, chunk, n)
    Cr = C.reshape(b, c, chunk, n)
    A_cs = torch.cumsum(Ar, dim=-1)

    # 1) within a chunk: (C B^T) * L, then against x, per (b, c, h)
    L = torch.exp(_segsum(Ar))                                # [b,h,c,Q,Q]
    CB = torch.matmul(Cr, Br.transpose(-1, -2))               # [b,c,l,s]
    M = L.permute(0, 2, 1, 3, 4) * CB[:, :, None]             # [b,c,h,l,s]
    Y_diag = torch.matmul(M, xr.permute(0, 1, 3, 2, 4))       # [b,c,h,l,p]

    # 2) the state each chunk ends in, from its own inputs
    decay_states = torch.exp(A_cs[..., -1:] - A_cs)           # [b,h,c,Q]
    xd = xr * decay_states.permute(0, 2, 3, 1)[..., None]     # [b,c,s,h,p]
    xd = xd.reshape(b, c, chunk, h * pdim)
    states = torch.matmul(xd.transpose(-1, -2), Br).reshape(
        b, c, h, pdim, n)                                     # [b,c,h,p,n]

    # 3) across chunks: the state entering each chunk
    state = (torch.zeros((b, h, pdim, n), dtype=states.dtype,
                         device=x.device)
             if init_state is None else init_state)
    chunk_decay = torch.exp(A_cs[..., -1])                    # [b,h,c]
    prev = []
    for ci in range(c):
        prev.append(state)
        state = state * chunk_decay[:, :, ci, None, None] + states[:, ci]
    prev_states = torch.stack(prev, dim=1)                    # [b,c,h,p,n]

    # 4) the entering state's part of each position's output
    state_decay = torch.exp(A_cs)                             # [b,h,c,Q]
    Y_off = torch.matmul(Cr, prev_states.reshape(b, c, h * pdim, n)
                         .transpose(-1, -2)).reshape(b, c, chunk, h, pdim)
    Y_off = Y_off * state_decay.permute(0, 2, 3, 1)[..., None]
    y = Y_diag.permute(0, 1, 3, 2, 4) + Y_off
    return y.reshape(b, l, h, pdim), state


def _split(p: Mamba2Block, h, cfg):
    """rms-normed stream -> (z, xBC, dt float32)."""
    d_in, _, _, conv_dim = _dims(cfg)
    zxbcdt = torch.matmul(h, gathered(p.in_proj).to(COMPUTE_DTYPE))
    return (zxbcdt[..., :d_in], zxbcdt[..., d_in:d_in + conv_dim],
            zxbcdt[..., d_in + conv_dim:].float())


def _over_model(w: torch.Tensor, dim: int, group):
    """The weight w whole over `model` for a rank that reads its own part
    of it: all-gathered along `dim` where it is split there (the
    gradient reduce-scattered back into the block), else taken through
    `pvary` (its gradient summed over the ranks)."""
    if model_group(w, dim) is not None:
        return coll.gather_weight(w, group, dim)
    return coll.pvary(w, group)


def _split_heads(p: Mamba2Block, h, cfg, group):
    """On blocks whose heads are split over `model` (`group`): (z, xBC,
    dt float32, conv_w, conv_b) of this rank's heads, xBC = its heads'
    x, then B and C whole (every head reads them). in_proj's columns
    (z | x | B | C | dt) split over `model` do not follow the heads: each
    rank's columns, the stream entering through `pvary`, are all-gathered
    over `model`, and each rank takes its heads' parts of the whole."""
    d_in, _, _, conv_dim = _dims(cfg)
    P = cfg.ssm_headdim
    h0, Hl = block_start(p.A_log, 0), p.A_log.shape[0]
    c0, c1 = h0 * P, (h0 + Hl) * P
    w = gathered(p.in_proj).to(COMPUTE_DTYPE)
    h = coll.pvary(h, group)
    if model_group(p.in_proj, 1) is not None:
        zx = coll.all_gather(torch.matmul(h, w), group, dim=-1)
    else:
        zx = torch.matmul(h, coll.pvary(w, group))
    xBC = torch.cat([zx[..., d_in + c0:d_in + c1],
                     zx[..., 2 * d_in:d_in + conv_dim]], dim=-1)
    dt = zx[..., d_in + conv_dim + h0:d_in + conv_dim + h0 + Hl].float()
    cw = _over_model(p.conv_w, 1, group)
    cb = _over_model(p.conv_b, 0, group)
    return (zx[..., c0:c1], xBC, dt,
            torch.cat([cw[:, c0:c1], cw[:, d_in:]], dim=1),
            torch.cat([cb[c0:c1], cb[d_in:]]))


def _gate_out(p: Mamba2Block, x, y, z, cfg, group=None):
    """y [..., d_in] bf16 gated by silu(z), normed, projected, added. On
    blocks whose heads are split over `model` (`group`), y and z are this
    rank's heads' channels: the norm's sum of squares over all of d_in is
    summed over `model` (then taken through `pvary`, as each rank scales
    its own channels by it), and out_proj runs row-parallel
    (`collectives.row_parallel`)."""
    g = y * F.silu(z)
    if group is None:
        y = rms_norm(g, p.norm, cfg.norm_eps)
    else:
        gf = g.float()
        ss = coll.psum(torch.sum(gf * gf, dim=-1, keepdim=True), group)
        var = coll.pvary(ss, group) / _dims(cfg)[0]
        y = (gf * torch.rsqrt(var + cfg.norm_eps)
             * (1.0 + p.norm.float())).to(g.dtype)
    w = gathered(p.out_proj).to(COMPUTE_DTYPE)
    return x + (torch.matmul(y, w) if group is None
                else coll.row_parallel(y, w, group))


def _heads_group(p: Mamba2Block):
    """The `model` group when the block's heads are split over it; None
    when every rank computes every head. Raises on blocks that split
    `model` otherwise (d_inner, in_proj or the conv channels, but not the
    heads): there every rank would read all of a split weight alike."""
    group = model_group(p.A_log, 0)
    if group is None and any(
            model_group(w, d) is not None for w, d in (
                (p.in_proj, 1), (p.conv_w, 1), (p.out_proj, 0))):
        raise NotImplementedError(
            "Mamba-2 blocks split over model without splitting the heads")
    return group


def block_forward(p: Mamba2Block, x, cfg):
    """x [B,T,d] -> (out, conv state [B,k-1,conv_dim], ssm state
    [B,H,P,N]). On blocks whose heads are split over `model`, this rank
    computes its heads (`_split_heads`, `_gate_out`): the conv state and
    the SSM state are then those of its heads' channels."""
    B_, T, _ = x.shape
    d_in, H, N, _ = _dims(cfg)
    k = cfg.conv_kernel
    h = rms_norm(x, gathered(p.ln), cfg.norm_eps)
    group = _heads_group(p)
    if group is None:
        z, xBC, dt = _split(p, h, cfg)
        conv_w, conv_b = p.conv_w, p.conv_b
    else:
        z, xBC, dt, conv_w, conv_b = _split_heads(p, h, cfg, group)
        H = p.A_log.shape[0]
        d_in = H * cfg.ssm_headdim

    # depthwise causal conv
    xBC_pad = F.pad(xBC, (0, 0, k - 1, 0))
    xBC_c = F.silu(causal_conv(xBC_pad, conv_w) + conv_b.to(COMPUTE_DTYPE))

    xs = xBC_c[..., :d_in].reshape(B_, T, H, cfg.ssm_headdim)
    Bm = xBC_c[..., d_in:d_in + N].float()
    Cm = xBC_c[..., d_in + N:].float()
    dt = F.softplus(dt + p.dt_bias)
    A = -torch.exp(p.A_log)                                   # [H]
    x_dt = xs.float() * dt[..., None]
    dtA = dt * A
    # pad T to a chunk multiple: zero inputs with dtA = 0 (decay 1) leave
    # the state as it is and add nothing to y
    chunk = min(cfg.ssm_chunk, T)
    T_pad = -(-T // chunk) * chunk
    if T_pad != T:
        x_dt = F.pad(x_dt, (0, 0, 0, 0, 0, T_pad - T))
        dtA = F.pad(dtA, (0, 0, 0, T_pad - T))
        Bm = F.pad(Bm, (0, 0, 0, T_pad - T))
        Cm = F.pad(Cm, (0, 0, 0, T_pad - T))
    y, ssm_state = ssd_chunked(x_dt, dtA, Bm, Cm, chunk)
    y = y[:, :T] + xs.float() * p.D[None, None, :, None]
    y = y.reshape(B_, T, d_in).to(COMPUTE_DTYPE)
    out = maybe_constrain(_gate_out(p, x, y, z, cfg, group),
                          ("batch", "seq", "embed"))
    # the last k-1 rows of the padded input, zero rows included when T is
    # shorter
    conv_state = xBC_pad[:, xBC_pad.shape[1] - (k - 1):]
    return out, conv_state, ssm_state


def block_decode(p: Mamba2Block, x, cfg, cache: Cache):
    """One-token recurrent update of x [B,1,d]; writes this layer's cache
    (conv [B,k-1,conv_dim], ssm [B,H,P,N], idx [B]) in place."""
    B_ = x.shape[0]
    d_in, H, N, _ = _dims(cfg)
    z, xBC, dt = _split(p, rms_norm(x, p.ln, cfg.norm_eps), cfg)
    z, xBC, dt = z[:, 0], xBC[:, 0], dt[:, 0]

    hist = torch.cat([cache["conv"], xBC[:, None]], dim=1)    # [B,k,cd]
    conv = (hist.float() * p.conv_w.float()).sum(dim=1).to(COMPUTE_DTYPE)
    xBC_c = F.silu(conv + p.conv_b.to(COMPUTE_DTYPE))
    cache["conv"].copy_(hist[:, 1:])

    xs = xBC_c[..., :d_in].reshape(B_, H, cfg.ssm_headdim).float()
    Bm = xBC_c[..., d_in:d_in + N].float()
    Cm = xBC_c[..., d_in + N:].float()
    dt = F.softplus(dt + p.dt_bias)                           # [B,H]
    decay = torch.exp(dt * -torch.exp(p.A_log))               # [B,H]
    ssm = cache["ssm"]
    ssm.mul_(decay[..., None, None]).add_(
        (dt[..., None] * xs)[..., None] * Bm[:, None, None, :])
    y = torch.matmul(ssm, Cm[:, None, :, None])[..., 0] \
        + xs * p.D[None, :, None]                             # [B,H,P]
    y = y.reshape(B_, 1, d_in).to(COMPUTE_DTYPE)
    cache["idx"] += 1
    return _gate_out(p, x, y, z[:, None], cfg)


class Mamba2(LM):
    """The Mamba-2 LM of `cfg`: embedding, `layers` (one `Mamba2Block`
    each), final norm, head (tied in mamba2-1.3b)."""

    def _build(self, cfg, device, gen) -> None:
        self.layers = nn.ModuleList(
            self._kept(Mamba2Block(cfg, device=device, gen=gen))
            for _ in range(cfg.num_layers))

    def loss_fn(self, batch, **_):
        x = embed(self.embed, batch["tokens"])
        for block in self.layers:
            x = ckpt(lambda h, b=block: block_forward(b, h, self.cfg)[0])(x)
        ce = cross_entropy(self.logits(x), batch["labels"],
                           vocab=vocab_split(self.head()))
        return ce, dict(ce=ce, aux=ce.new_zeros(()))

    def cache_axes(self, batch: int, max_seq: int) -> dict:
        return dict(conv=("layers", "batch", None, "ffn"),
                    ssm=("layers", "batch", "q_heads", None, "state"),
                    idx=("layers", "batch"))

    @torch.inference_mode()
    def init_cache(self, batch: int, max_seq: int) -> Cache:
        """A state cache: no sequence axis, so `max_seq` sets nothing."""
        self.serve_whole()
        _, H, N, conv_dim = _dims(self.cfg)
        L, k, dev = self.cfg.num_layers, self.cfg.conv_kernel, self.device
        return dict(
            conv=torch.zeros((L, batch, k - 1, conv_dim), dtype=COMPUTE_DTYPE,
                             device=dev),
            ssm=torch.zeros((L, batch, H, self.cfg.ssm_headdim, N),
                            dtype=torch.float32, device=dev),
            idx=torch.zeros((L, batch), dtype=torch.int32, device=dev))

    @torch.inference_mode()
    def prefill(self, tokens, *, q_chunk: int = 512,
                pad_cache_to: Optional[int] = None):
        """Full forward over tokens [B, T]: the last position's logits
        [B,1,V] and the cache. The state cache has no sequence axis, so
        `q_chunk` and `pad_cache_to` change nothing."""
        self.serve_whole()
        del q_chunk, pad_cache_to
        B_, T = tokens.shape
        x = embed(self.embed, tokens)
        convs, ssms = [], []
        for block in self.layers:
            x, conv_s, ssm_s = block_forward(block, x, self.cfg)
            convs.append(conv_s)
            ssms.append(ssm_s)
        cache = dict(conv=torch.stack(convs), ssm=torch.stack(ssms),
                     idx=torch.full((len(self.layers), B_), T,
                                    dtype=torch.int32, device=x.device))
        return self.logits(x[:, -1:]), cache

    @torch.inference_mode()
    def decode_step(self, cache: Cache, token) -> Tuple[torch.Tensor, Cache]:
        """token [B,1] -> (logits [B,1,V], cache updated in place)."""
        self.serve_whole()
        x = embed(self.embed, token)
        for i, block in enumerate(self.layers):
            x = block_decode(block, x, self.cfg,
                             {n: t[i] for n, t in cache.items()})
        return self.logits(x), cache
