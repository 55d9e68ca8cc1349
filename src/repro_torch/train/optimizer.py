"""AdamW with float32 master weights and optional blockwise-int8 moments.

The JAX package's `repro.train.optimizer`. The state is kept per JAX
leaf, so that its blocks, its checkpoint keys and its int8 codes are the
JAX package's (`state_axes` names its ZeRO layout):

    master  float32, the leaf flattened and zero-padded to a multiple of
            QBLOCK
    m, v    float32 of the same length, or (int8 codes, float32 scales
            a block of QBLOCK)

A parameter tree here is nested dicts (JAX's names, flattened in sorted
key order) whose leaves are tensors, or lists of tensors: the per-layer
tensors of one JAX leaf stacked over layers ([L, ...]), in layer order.
A list is flattened as JAX flattens the stacked array, so a layer's
slice that is not a multiple of QBLOCK long shares a block with the next
layer, as in JAX (`convert.lm_param_tree` builds such a tree from a
model).

int8 moments: symmetric absmax quantization in blocks of QBLOCK, after
the update. The second moment is stored as sqrt(v), and dequantized with
a half-LSB floor, so that an entry whose sqrt(v) rounds to code 0 cannot
make m / (sqrt(v) + eps) explode.

`apply_updates` writes the new bf16 weights into the parameters and
updates the state's tensors in place (fp32 moments); each step is a chain
of elementwise torch ops a leaf (XLA fuses the JAX package's).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Tuple

import torch

QBLOCK = 128


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    int8_moments: bool = False


class AdamState(NamedTuple):
    step: torch.Tensor    # int32 scalar
    master: Any           # per-leaf flat float32
    m: Any                # per-leaf flat float32, or (int8, scales)
    v: Any


def tree_map(fn, tree, *rest):
    """fn over the leaves of nested dicts (a list of tensors is one
    leaf), in JAX's order (keys sorted), in the structure of `tree`;
    `rest` are trees of its shape."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def tree_leaves(tree):
    """The leaves of nested dicts in JAX's order (keys sorted)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k])
    else:
        yield tree


def _parts(leaf):
    return list(leaf) if isinstance(leaf, (list, tuple)) else [leaf]


def leaf_size(leaf) -> int:
    return sum(t.numel() for t in _parts(leaf))


def _pad_len(n: int) -> int:
    return -(-n // QBLOCK) * QBLOCK


def _flatten_pad(leaf) -> torch.Tensor:
    """A leaf (a tensor, or a list of them) as one float32 vector, padded
    with zeros to a multiple of QBLOCK."""
    parts = _parts(leaf)
    n = leaf_size(leaf)
    flat = torch.zeros(_pad_len(n), dtype=torch.float32,
                       device=parts[0].device)
    at = 0
    for t in parts:
        flat[at:at + t.numel()] = t.detach().reshape(-1)
        at += t.numel()
    return flat


def quantize_blockwise(flat: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 [N] (N % QBLOCK == 0) -> (int8 [N], float32 scales
    [N/QBLOCK])."""
    blocks = flat.reshape(-1, QBLOCK)
    scale = blocks.abs().amax(dim=1) / 127.0
    q = (blocks / torch.clamp(scale[:, None], min=1e-12)).round_()
    return q.to(torch.int8).reshape(-1), scale


def dequantize_blockwise(q: torch.Tensor, scale: torch.Tensor
                         ) -> torch.Tensor:
    return q.reshape(-1, QBLOCK).float().mul_(scale[:, None]).reshape(-1)


def dequantize_floor(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Non-negative dequant with a half-LSB floor (for sqrt(v) storage)."""
    s = scale[:, None]
    vals = q.reshape(-1, QBLOCK).float().mul_(s)
    return torch.maximum(vals, 0.5 * s, out=vals).reshape(-1)


def _sqrt_(x: torch.Tensor) -> torch.Tensor:
    """float32 sqrt, correctly rounded as XLA's and CUDA's, in place on
    the card: torch's vectorised float32 sqrt on the CPU is 1 ulp off in
    ~0.7% of values; float64's sqrt rounded to float32 is exact (53 >=
    2 * 24 + 2 bits)."""
    if x.device.type == "cpu":
        return torch.sqrt(x.double()).float()
    return x.sqrt_()


def init_state(params, cfg: AdamWConfig) -> AdamState:
    master = tree_map(_flatten_pad, params)

    def zeros(p):
        n = _pad_len(leaf_size(p))
        dev = _parts(p)[0].device
        if cfg.int8_moments:
            return (torch.zeros(n, dtype=torch.int8, device=dev),
                    torch.zeros(n // QBLOCK, dtype=torch.float32,
                                device=dev))
        return torch.zeros(n, dtype=torch.float32, device=dev)

    dev = next(iter(tree_leaves(master))).device
    return AdamState(step=torch.zeros((), dtype=torch.int32, device=dev),
                     master=master, m=tree_map(zeros, params),
                     v=tree_map(zeros, params))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32 (summed leaf
    by leaf in JAX's order; within a leaf in torch's order)."""
    total = None
    for leaf in tree_leaves(tree):
        for t in _parts(leaf):
            s = t.float().square().sum()
            total = s if total is None else total + s
    return _sqrt_(total)


def state_axes(param_axes, int8_moments: bool) -> AdamState:
    """The logical axes of `init_state`'s tree for parameters whose axes
    tree is `param_axes` (`LM.param_axes()`): every flat leaf on
    ("zero",), an int8 moment a (codes, scales) pair of them, the step
    a scalar."""
    master = tree_map(lambda _: ("zero",), param_axes)
    if int8_moments:
        mq = tree_map(lambda _: (("zero",), ("zero",)), param_axes)
        return AdamState(step=(), master=master, m=mq, v=mq)
    return AdamState(step=(), master=master, m=master, v=master)


@torch.no_grad()
def apply_updates(params, grads, state: AdamState, cfg: AdamWConfig
                  ) -> Tuple[Any, AdamState, Dict[str, torch.Tensor]]:
    """One AdamW step. Writes the new weights into `params` (cast to each
    parameter's dtype) and returns (params, the new state, metrics): the
    fp32 moments and the masters are updated in place."""
    step = state.step + 1
    gnorm = global_norm(grads)
    if cfg.grad_clip:
        gscale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                             max=1.0)
    else:
        gscale = torch.ones((), dtype=torch.float32, device=gnorm.device)
    stepf = step.float()
    bc1 = 1.0 - cfg.b1 ** stepf
    bc2 = 1.0 - cfg.b2 ** stepf

    def update(p, g, mstr, m, v):
        gf = _flatten_pad(g).mul_(gscale)
        if cfg.int8_moments:
            m_f = dequantize_blockwise(*m)
            u = dequantize_floor(*v)        # u = sqrt(v), half-LSB floored
            v_f = u.mul_(u)
        else:
            m_f, v_f = m, v
        # the JAX package's arithmetic, op by op, in place where it can be
        m_f = m_f.mul_(cfg.b1).add_((1 - cfg.b1) * gf)
        v_f = v_f.mul_(cfg.b2).add_(((1 - cfg.b2) * gf).mul_(gf))
        del gf
        upd = (m_f / bc1).div_(_sqrt_(v_f / bc2).add_(cfg.eps))
        upd.add_(cfg.weight_decay * mstr)
        mstr.sub_(upd.mul_(cfg.lr))
        del upd
        at = 0
        for t in _parts(p):
            n = t.numel()
            t.copy_(mstr[at:at + n].reshape(t.shape))
            at += n
        if cfg.int8_moments:
            return (mstr, quantize_blockwise(m_f),
                    quantize_blockwise(_sqrt_(v_f)))
        return mstr, m_f, v_f

    out = tree_map(update, params, grads, state.master, state.m, state.v)
    master, m, v = (tree_map(lambda o, i=i: o[i], out) for i in range(3))
    return params, AdamState(step=step, master=master, m=m, v=v), \
        dict(grad_norm=gnorm)
