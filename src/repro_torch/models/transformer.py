"""Decoder-only transformer LM (dense + MoE): serving and training.

One `Block` module per layer, in `nn.ModuleList`s. MoE architectures with
leading dense layers (DeepSeek-V2) keep two stacks, `dense_layers` then
`moe_layers`, in layer order, as the JAX package's
`repro.models.transformer` stacks its layer parameters; the converter
(`convert.lm_params_from_numpy`) splits JAX's stacked leaves into these
modules. `maybe_constrain` names the residual stream's axes where the JAX
package does (the identity without sharding rules).

Training API (the JAX package's, outside `torch.inference_mode`):
  forward_hidden(x, positions)     -> (normed hidden, aux loss), each
                                      layer under `ckpt`
  loss_fn(batch, aux_coef, q_chunk) -> (loss, dict(ce, aux))

Serving API (the methods `ContinuousBatcher` calls):
  init_cache(batch, max_seq)       -> cache
  prefill(tokens, **kw)            -> (logits of the last position, cache)
  decode_step(cache, token)        -> (logits [B,1,V], cache), in place

A cache is {"dense": {...}, "moe": {...}}, one entry per layer stack, of
stacked tensors [L, B, S, ...] and a position idx [L, B] int32: the JAX
package's layout, so the two compare leaf by leaf.

On a model that keeps blocks (built with `mesh=` a process mesh) the
serving API runs on each rank's part, in the JAX dry run's serving
layout: `init_cache(batch, max_seq)` gives the rank's blocks of the
cache (`sharding.layout.cache_spec`: e.g. [L, B/dp, S/mp, KV, hd], idx
[L, B/dp]); `prefill` and `decode_step` take the rank's rows of the
tokens (`layout.serve_rows`) and return those rows' logits over the whole
vocabulary (gathered over `model` from the vocab-parallel head). Prefill
runs training's forward and re-lays each layer's keys and values into
the decode layout (`_seq_blocks`).
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

import torch
from torch import nn

from repro_torch.models import attention as attn_lib
from repro_torch.models.common import (LM, ckpt, cross_entropy, embed, param,
                                       prepend_layers_axis, rms_norm,
                                       vocab_split, zeros_init)
from repro_torch.models.mlp import MLP, mlp_forward
from repro_torch.models.moe import MoE, moe_forward
from repro_torch.sharding import collectives as coll
from repro_torch.sharding.layout import (block_shapes, cache_spec, gathered,
                                         model_group, seq_group)
from repro_torch.sharding.rules import maybe_constrain

Cache = Dict[str, Dict[str, torch.Tensor]]


class Block(nn.Module):
    AXES = dict(ln1=("embed",), ln2=("embed",))

    def __init__(self, cfg, *, moe: bool, device, gen):
        super().__init__()
        self.is_moe = moe
        self.ln1 = param(zeros_init((cfg.d_model,), device=device))
        attn_cls = attn_lib.MLA if cfg.attention == "mla" else attn_lib.GQA
        self.attn = attn_cls(cfg, device=device, gen=gen)
        self.ln2 = param(zeros_init((cfg.d_model,), device=device))
        if moe:
            self.moe = MoE(cfg, device=device, gen=gen)
        else:
            self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.mlp, device=device,
                           gen=gen)

    def _ffn(self, x, cfg):
        h = rms_norm(x, gathered(self.ln2), cfg.norm_eps)
        if self.is_moe:
            h, aux = moe_forward(self.moe, h, cfg)
        else:
            h, aux = mlp_forward(self.mlp, h, cfg.mlp), x.new_zeros(
                (), dtype=torch.float32)
        return x + h, aux

    def forward(self, x, cfg, positions, *, q_chunk: int = 512):
        """-> (x, aux, cache entries of this layer at every position). On
        a model that keeps blocks, each weight is gathered over the data
        axes here, inside the layer's remat, so that the backward
        gathers it again rather than keeping it."""
        h = rms_norm(x, gathered(self.ln1), cfg.norm_eps)
        if cfg.attention == "mla":
            h, c_kv, k_rope = attn_lib.mla_forward(
                self.attn, h, cfg, positions, q_chunk=q_chunk)
            kv = dict(c_kv=c_kv, k_rope=k_rope)
        else:
            h, k, v = attn_lib.gqa_forward(self.attn, h, cfg, positions,
                                           q_chunk=q_chunk)
            kv = dict(k=k, v=v)
        x = maybe_constrain(x + h, ("batch", "seq", "embed"))
        x, aux = self._ffn(x, cfg)
        return maybe_constrain(x, ("batch", "seq", "embed")), aux, kv

    def decode(self, x, cfg, cache: Dict[str, torch.Tensor]):
        h = rms_norm(x, gathered(self.ln1), cfg.norm_eps)
        if cfg.attention == "mla":
            h = attn_lib.mla_decode(self.attn, h, cfg, cache)
        else:
            h = attn_lib.gqa_decode(self.attn, h, cfg, cache)
        return self._ffn(x + h, cfg)[0]


def layer_split(cfg) -> Tuple[int, int]:
    """(n_dense_layers, n_moe_layers)."""
    if cfg.num_experts:
        return cfg.first_dense_layers, cfg.num_layers - cfg.first_dense_layers
    return cfg.num_layers, 0


class Transformer(LM):
    """The decoder-only LM of `cfg`: embedding, `dense_layers` then
    `moe_layers`, final norm, head (see `models/common.py::LM` for the
    device and the seed)."""

    def _build(self, cfg, device, gen) -> None:
        n_dense, n_moe = layer_split(cfg)
        self.dense_layers = nn.ModuleList(
            self._kept(Block(cfg, moe=False, device=device, gen=gen))
            for _ in range(n_dense))
        self.moe_layers = nn.ModuleList(
            self._kept(Block(cfg, moe=True, device=device, gen=gen))
            for _ in range(n_moe))

    def stacks(self) -> Iterator[Tuple[str, nn.ModuleList]]:
        """(cache key, layers) of each non-empty stack, in layer order."""
        for key, layers in (("dense", self.dense_layers),
                            ("moe", self.moe_layers)):
            if len(layers):
                yield key, layers

    def embed_inputs(self, tokens, **extra) -> torch.Tensor:
        """The input stream [B, T, d] of `tokens` [B, T]."""
        if extra:
            raise TypeError(f"unexpected inputs {sorted(extra)}")
        return embed(self.embed, tokens)

    # ----------------------------------------------------------- training
    def forward_hidden(self, x, positions, *, q_chunk: int = 512):
        """x [B, T, d] input stream -> (final-normed hidden, the summed
        MoE aux loss float32), each layer rematerialised by `ckpt`."""
        cfg = self.cfg
        aux_total = x.new_zeros((), dtype=torch.float32)
        for _, layers in self.stacks():
            aux = x.new_zeros((), dtype=torch.float32)
            for block in layers:
                x, a = ckpt(lambda h, b=block: b(
                    h, cfg, positions, q_chunk=q_chunk)[:2])(x)
                aux = aux + a
            aux_total = aux_total + aux
        return rms_norm(x, gathered(self.final_norm), cfg.norm_eps), \
            aux_total

    def _loss(self, x, labels, n_prefix: int, aux_coef: float,
              q_chunk: int):
        positions = torch.arange(x.shape[1], dtype=torch.int32,
                                 device=x.device)
        hidden, aux = self.forward_hidden(x, positions, q_chunk=q_chunk)
        ce = cross_entropy(self.logits_fn(hidden[:, n_prefix:]), labels,
                           vocab=vocab_split(self.head()))
        return ce + aux_coef * aux, dict(ce=ce, aux=aux)

    def loss_fn(self, batch, *, aux_coef: float = 0.01, q_chunk: int = 512):
        return self._loss(self.embed_inputs(batch["tokens"]),
                          batch["labels"], 0, aux_coef, q_chunk)

    # ------------------------------------------------------------ serving
    def cache_axes(self, batch: int, max_seq: int) -> dict:
        ax = (attn_lib.MLA_CACHE_AXES if self.cfg.attention == "mla"
              else attn_lib.GQA_CACHE_AXES)
        return {key: prepend_layers_axis(ax) for key, _ in self.stacks()}

    def cache_shapes(self, batch: int, max_seq: int) -> dict:
        """The whole cache's shapes (the single-device `init_cache`'s)."""
        init = (attn_lib.init_mla_cache if self.cfg.attention == "mla"
                else attn_lib.init_gqa_cache)
        c1 = init(self.cfg, batch, max_seq, "meta")
        return {key: {n: (len(layers),) + tuple(t.shape)
                      for n, t in c1.items()}
                for key, layers in self.stacks()}

    @torch.inference_mode()
    def init_cache(self, batch: int, max_seq: int) -> Cache:
        """The cache of `batch` sequences of up to `max_seq` positions;
        on blocks, this rank's blocks of it."""
        shapes = self.cache_shapes(batch, max_seq)
        if self.layout is not None:
            shapes = block_shapes(shapes, self.cache_axes(batch, max_seq),
                                  self.layout)
        return {key: {n: torch.zeros(shape, dtype=torch.int32 if n == "idx"
                                     else attn_lib.COMPUTE_DTYPE,
                                     device=self.device)
                      for n, shape in c.items()}
                for key, c in shapes.items()}

    def _seq_blocks(self, block: Block, kv: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
        """One layer's cache entries [B, S, ...] from the forward's head
        split to the decode layout (`cache_spec`): the rank's block of the
        sequence, with every KV head: one all_to_all over `model` where
        the keys and values are split over it by head, else the rank's
        slice of the whole heads. As they are on whole weights or a
        `model` of one."""
        group = seq_group(block.ln1)
        if group is None:
            return kv
        rows, S = next(iter(kv.values())).shape[:2]
        cache_spec(self.layout, ("batch", "cache_seq"), (rows, S))
        n_loc = S // group.shards
        split = (self.cfg.attention != "mla"
                 and model_group(block.attn.wk, 1) is not None)
        return {n: (coll.all_to_all(t, group, 1, 2) if split else
                    t.narrow(1, n_loc * group.rank, n_loc).clone())
                for n, t in kv.items()}

    @torch.inference_mode()
    def prefill(self, tokens, *, q_chunk: int = 512,
                pad_cache_to: Optional[int] = None, **extra):
        """Full-sequence forward over `tokens` [B, T] (after any prefix a
        subclass adds); returns the last position's logits [B,1,V] and the
        filled cache. Sliding-window caches keep the last `window`
        positions; `pad_cache_to` grows the cache to decode capacity. The
        trim, the padding and the ring's roll act on global positions,
        before a model on blocks cuts each layer's entries to its
        sequence block."""
        cfg = self.cfg
        x = self.embed_inputs(tokens, **extra)
        B, T = x.shape[:2]
        positions = torch.arange(T, dtype=torch.int32, device=x.device)
        window = cfg.sliding_window
        trim = cfg.attention != "mla" and window and window < T
        cache: Cache = {}
        for key, layers in self.stacks():
            c = {}
            for i, block in enumerate(layers):
                x, _, kv = block(x, cfg, positions, q_chunk=q_chunk)
                if trim:
                    kv = {n: t[:, -window:] for n, t in kv.items()}
                if pad_cache_to:
                    kv = {n: t[0] for n, t in attn_lib.pad_stacked_cache(
                        {n: t[None] for n, t in kv.items()}, pad_cache_to,
                        cfg, T).items()}
                # each layer's entries go straight into the stack: a list
                # stacked at the end would hold the cache twice
                for n, t in self._seq_blocks(block, kv).items():
                    if n not in c:
                        c[n] = t.new_empty((len(layers),) + t.shape)
                    c[n][i] = t
            c["idx"] = torch.full((len(layers), B), T, dtype=torch.int32,
                                  device=x.device)
            cache[key] = c
        return self._whole_vocab(self.logits(x[:, -1:])), cache

    def _whole_vocab(self, logits: torch.Tensor) -> torch.Tensor:
        """Logits over the whole vocabulary: a vocab-parallel head's
        columns gathered over `model`."""
        group = model_group(self.head().table, 0)
        return logits if group is None else coll.all_gather(logits, group,
                                                            logits.ndim - 1)

    @torch.inference_mode()
    def decode_step(self, cache: Cache, token) -> Tuple[torch.Tensor, Cache]:
        """token [B,1] int -> (logits [B,1,V], cache). Every slot decodes;
        the cache is updated in place and returned."""
        x = embed(self.embed, token)
        for key, layers in self.stacks():
            c = cache[key]
            for i, block in enumerate(layers):
                x = block.decode(x, self.cfg,
                                 {n: t[i] for n, t in c.items()})
        return self._whole_vocab(self.logits(x)), cache
