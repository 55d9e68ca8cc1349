"""Shared model components: norms, RoPE, embeddings, init helpers.

Parameters are stored bf16 and matmuls run in bf16; softmax, norms and
reductions run in float32, as in the JAX package's `repro.models.common`.
Parameters are drawn by the port's own generator (`torch.Generator` on
the model's device): the same seed gives other weights than JAX's, so the
tests carry JAX's weights over with `convert.lm_params_from_numpy`.

Training: `param()` makes every weight without a gradient, as serving
wants; `model.requires_grad_()` turns gradients on for training.
`cross_entropy` is the JAX module's float32 loss; `remat_policy` and
`ckpt` its rematerialisation, by `torch.utils.checkpoint`. The JAX
module's scan helpers (`maybe_scan`, `unroll_scans`) have no counterpart:
the port loops over its layers, and its dry run counts every op it runs.

Sharding: each module class names the logical axes of its own parameters
in `AXES`; `module_axes` assembles a model's tree of them, the second
element of the JAX package's `init_params`, with a leading "layers" on
every layer stack (`prepend_layers_axis`). Built with `mesh=` a process
mesh, a model of any family keeps each rank's block of every weight
(drawn whole, a module at a time, so the values are the single-device
init's); the embedding then looks up its vocab block and sums over
`model`, the head gives this rank's vocab columns of the logits, and
`cross_entropy` combines them over `model` (`vocab=`).
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional, Tuple

import torch
from torch import nn
from torch.utils import checkpoint as _checkpoint

from repro_torch.device import resolve_device
from repro_torch.sharding import collectives as coll
from repro_torch.sharding.layout import (block_start, gathered, keep_blocks_,
                                         model_group)
from repro_torch.sharding.rules import active_rules, current_rules

PARAM_DTYPE = torch.bfloat16
COMPUTE_DTYPE = torch.bfloat16


def dense_init(gen: Optional[torch.Generator], shape, fan_in: int,
               dtype=PARAM_DTYPE, *, device=None) -> torch.Tensor:
    """N(0, 1) drawn in float32 from `gen` on its device, divided by
    sqrt(fan_in), cast to `dtype`. With `gen` None the tensor is left
    unset on `device`: its weights are loaded afterwards
    (`convert.lm_params_from_numpy`)."""
    if gen is None:
        return torch.empty(shape, dtype=dtype, device=device)
    w = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w / math.sqrt(max(fan_in, 1))).to(dtype)


def zeros_init(shape, dtype=PARAM_DTYPE, *, device=None) -> torch.Tensor:
    return torch.zeros(shape, dtype=dtype, device=device)


def ones_init(shape, dtype=PARAM_DTYPE, *, device=None) -> torch.Tensor:
    return torch.ones(shape, dtype=dtype, device=device)


def param(t: torch.Tensor) -> nn.Parameter:
    """A weight of a serving model: no gradient is kept."""
    return nn.Parameter(t, requires_grad=False)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    """float32 math, scaled by (1 + scale), cast back to x's dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(x.dtype)


def causal_conv(xp: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv in bf16, without its bias: xp [B, k-1+T, C]
    (k-1 rows of history, then the T inputs), w [k, C] -> [B, T, C],
    summed tap by tap in the JAX package's order."""
    k = w.shape[0]
    T = xp.shape[1] - (k - 1)
    w = w.to(COMPUTE_DTYPE)
    out = xp[:, 0:T] * w[0]
    for i in range(1, k):
        out = out + xp[:, i:i + T] * w[i]
    return out


def rope_tables(positions: torch.Tensor, dim: int, theta: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions [...] -> (cos, sin) [..., dim//2] float32."""
    half = dim // 2
    exps = torch.arange(half, dtype=torch.float32,
                        device=positions.device) / half
    freqs = 1.0 / (torch.tensor(theta, dtype=torch.float32,
                                device=positions.device) ** exps)
    angles = positions.float()[..., None] * freqs
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x [..., T, H, D]; cos/sin [..., T, D//2] broadcast over heads. The
    first and second halves of D are the rotated pairs (not interleaved)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1).to(x.dtype)


def prepend_layers_axis(axes_tree):
    """Every leaf of a logical-axes tree with a leading "layers" axis."""
    if isinstance(axes_tree, dict):
        return {k: prepend_layers_axis(v) for k, v in axes_tree.items()}
    return ("layers",) + axes_tree


def module_axes(m: nn.Module) -> dict:
    """The logical axes of `m`'s parameters in the tree of
    `convert.lm_param_tree`: its own from its class's `AXES`, its
    children's nested under their names, a layer stack (a non-empty
    `nn.ModuleList`) as its first layer's with "layers" prepended."""
    out = {name: type(m).AXES[name]
           for name, _ in m.named_parameters(recurse=False)}
    for name, child in m.named_children():
        if isinstance(child, nn.ModuleList):
            if len(child):
                out[name] = prepend_layers_axis(module_axes(child[0]))
        else:
            sub = module_axes(child)
            if sub:
                out[name] = sub
    return out


class Embedding(nn.Module):
    """A [vocab, d_model] table: the input embedding, or an untied head
    (JAX's `init_embedding`)."""
    AXES = dict(table=("vocab", "embed"))

    def __init__(self, vocab: int, d_model: int, *, device, gen):
        super().__init__()
        self.table = param(dense_init(gen, (vocab, d_model), d_model,
                                      device=device))


def embed(emb: Embedding, tokens: torch.Tensor) -> torch.Tensor:
    """The rows of `tokens`. With the table's vocab split over `model`
    (a block), each rank looks up the ids of its vocab block (zeros for
    the others) and the rows are summed over `model`."""
    table = gathered(emb.table)
    group = model_group(emb.table, 0)
    if group is None:
        return table[tokens].to(COMPUTE_DTYPE)
    n = table.shape[0]
    ids = tokens - block_start(emb.table, 0)
    mine = (ids >= 0) & (ids < n)
    rows = table[ids.clamp(0, n - 1)]
    return coll.psum(torch.where(mine[..., None], rows, 0).to(
        COMPUTE_DTYPE), group)


def unembed(emb: Embedding, x: torch.Tensor) -> torch.Tensor:
    """Logits in float32; with the table's vocab split over `model`, this
    rank's vocab columns of them (`vocab_split`)."""
    group = model_group(emb.table, 0)
    if group is not None:
        x = coll.pvary(x, group)
    return torch.matmul(x.to(COMPUTE_DTYPE),
                        gathered(emb.table).t()).float()


def vocab_split(emb: Embedding):
    """(the `model` group, the first vocab id) of a head whose vocab is
    split over `model`, for `cross_entropy`'s `vocab=`; None when whole."""
    group = model_group(emb.table, 0)
    return None if group is None else (group, block_start(emb.table, 0))


class _VocabParallelNLL(torch.autograd.Function):
    """Each token's -log p(label) from this rank's vocab columns of the
    logits [..., V_loc] (vocab ids from `start`): the max, the sum of
    exponentials and the label's logit summed over the `model` group.
    The backward is the local softmax less the label's one-hot, times the
    cotangent: one gradient of the logits, no collective (the head's
    input enters through `pvary`, which sums its gradient)."""

    @staticmethod
    def forward(ctx, logits, labels, group, start):
        top = logits.amax(dim=-1).contiguous()
        coll.pmax_(top, group)
        probs = torch.exp(logits - top[..., None])
        sumexp = probs.sum(dim=-1)
        coll.all_reduce_(sumexp, group)
        n = logits.shape[-1]
        ids = labels.long() - start
        mine = (ids >= 0) & (ids < n)
        ids = ids.clamp(0, n - 1)
        ll = torch.where(mine, torch.gather(logits, -1, ids[..., None])[
            ..., 0], 0.0).contiguous()
        coll.all_reduce_(ll, group)
        probs.div_(sumexp[..., None])
        ctx.save_for_backward(probs, ids, mine)
        return torch.log(sumexp) + top - ll

    @staticmethod
    def backward(ctx, ct):
        probs, ids, mine = ctx.saved_tensors
        grad = probs * ct[..., None]
        grad.scatter_add_(-1, ids[..., None], torch.where(
            mine, -ct, 0.0)[..., None])
        return grad, None, None, None


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None, *,
                  vocab=None) -> torch.Tensor:
    """Mean next-token CE. logits [B,T,V] float32, labels [B,T] int; with
    `mask` [B,T], the masked mean (over at least one token). With
    `vocab` = (group, first id) the logits are this rank's vocab columns
    (`unembed` of a split head) and every rank gets the whole-vocab loss
    (`_VocabParallelNLL`)."""
    if vocab is None:
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
        nll = lse - ll
    else:
        nll = _VocabParallelNLL.apply(logits, labels, *vocab)
    if mask is not None:
        nll = nll * mask
        return nll.sum() / torch.clamp(mask.sum(), min=1)
    return nll.mean()


# ---------------------------------------------------------------------------
# rematerialisation
# ---------------------------------------------------------------------------

_local = threading.local()

# the matmul outputs that the "dots" policy keeps (JAX's checkpoint_dots)
_DOT_OPS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
            torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default)


@contextlib.contextmanager
def remat_policy(name: str):
    """Active rematerialisation policy of the layers' `ckpt`: "full" (save
    nothing but each layer's input: the default), "dots" (save matmul
    outputs), "none" (no remat)."""
    if name not in ("full", "dots", "none"):
        raise ValueError(f"unknown remat policy {name!r}")
    prev = getattr(_local, "policy", "full")
    _local.policy = name
    try:
        yield
    finally:
        _local.policy = prev


def recomputing() -> bool:
    """True while `ckpt` re-runs a layer in the backward pass: side
    effects of the forward (MoE's drop count) must not repeat there."""
    return getattr(_local, "recomputing", False)


@contextlib.contextmanager
def _recompute(inner, rules):
    """`inner`, with `recomputing()` true inside and the forward's sharding
    `rules` active: autograd may re-run a layer on a thread of its own
    (one a card), where the forward's thread-local rules are not."""
    prev = recomputing()
    _local.recomputing = True
    try:
        with active_rules(rules), inner:
            yield
    finally:
        _local.recomputing = prev


def _save_dots(ctx, op, *args, **kwargs):
    return (_checkpoint.CheckpointPolicy.MUST_SAVE if op in _DOT_OPS
            else _checkpoint.CheckpointPolicy.PREFER_RECOMPUTE)


def _contexts(policy: str, rules):
    """(forward, recompute) contexts of `torch.utils.checkpoint`; the
    recompute runs under `rules`, the forward's."""
    if policy == "dots":
        fwd, rec = _checkpoint.create_selective_checkpoint_contexts(
            _save_dots)
    else:
        fwd, rec = contextlib.nullcontext(), contextlib.nullcontext()
    return fwd, _recompute(rec, rules)


def ckpt(f):
    """`f` under the active remat policy (see `remat_policy`), as the JAX
    package's `jax.checkpoint`; `f` itself where no gradient is taken."""
    def run(*args):
        policy = getattr(_local, "policy", "full")
        if policy == "none" or not torch.is_grad_enabled():
            return f(*args)
        rules = current_rules()
        return _checkpoint.checkpoint(
            f, *args, use_reentrant=False,
            context_fn=lambda: _contexts(policy, rules))
    return run


class LM(nn.Module):
    """What the port's LMs share: `cfg`, the device (the card when None),
    the input embedding, the final norm and the head (the embedding when
    `cfg.tie_embeddings`). Weights are drawn from a generator seeded with
    `seed` in the order embedding, `_build`'s layers, head; with `seed`
    None they are left unset, for `convert.lm_params_from_numpy` to load.

    `param_axes()` and `cache_axes(batch, max_seq)` give the logical axes
    of the parameters and of `init_cache`'s tensors: the JAX package's
    axes trees.

    With `mesh` a process mesh (`launch.mesh.make_process_mesh`), each
    rank keeps its block of every weight (`layout` is then the mesh):
    each module is drawn whole and cut to its block before the next is
    drawn. Other meshes keep whole weights (`layout` None)."""
    AXES = dict(final_norm=("embed",))

    def __init__(self, cfg, *, device=None, seed: Optional[int] = 0,
                 mesh=None):
        super().__init__()
        device = resolve_device(device)
        gen = (torch.Generator(device=device).manual_seed(seed)
               if seed is not None else None)
        self.cfg = cfg
        self.device = device
        self.layout = (mesh if mesh is not None and getattr(
            mesh, "process", False) else None)
        self.embed = self._kept(Embedding(cfg.vocab_size, cfg.d_model,
                                          device=device, gen=gen))
        self._build(cfg, device, gen)
        self.final_norm = param(zeros_init((cfg.d_model,), device=device))
        self.lm_head = (None if cfg.tie_embeddings else
                        Embedding(cfg.vocab_size, cfg.d_model, device=device,
                                  gen=gen))
        self._kept(self)

    def _kept(self, module: nn.Module) -> nn.Module:
        """`module` cut to this rank's blocks when the model keeps
        blocks; as it is otherwise."""
        if self.layout is not None:
            keep_blocks_(module, self.layout)
        return module

    def _build(self, cfg, device, gen) -> None:
        """The layers, between the embedding and the head (each passed
        through `_kept` as it is built)."""
        raise NotImplementedError

    def param_axes(self) -> dict:
        return module_axes(self)

    def serve_whole(self) -> None:
        """Raises on a model that keeps blocks: the families whose serving
        caches split over other axes than the sequence (Mamba-2's and
        RG-LRU's states, Whisper's cross keys; ROADMAP 4h) serve with
        whole weights only."""
        if self.layout is not None:
            raise NotImplementedError(
                f"{self.cfg.name}: serving on a process mesh (blocks) is "
                "the decoder-only transformers' (ROADMAP 4h)")

    def cache_axes(self, batch: int, max_seq: int) -> dict:
        raise NotImplementedError

    def logits(self, x) -> torch.Tensor:
        """The final norm and the head over the stream x [B, T, d]."""
        return self.logits_fn(rms_norm(x, gathered(self.final_norm),
                                       self.cfg.norm_eps))

    def head(self) -> Embedding:
        return self.embed if self.cfg.tie_embeddings else self.lm_head

    def logits_fn(self, hidden) -> torch.Tensor:
        """The head over the normed stream (this rank's vocab columns
        when the head is split: `vocab_split(self.head())`)."""
        return unembed(self.head(), hidden)

    def loss_fn(self, batch, **kw):
        """(loss, dict(ce, aux)) of a batch {tokens, labels [B, T], and the
        family's extra inputs}: the JAX package's `loss_fn`. For gradients,
        call it outside `torch.inference_mode` on a model whose parameters
        require them (`requires_grad_()`)."""
        raise NotImplementedError
