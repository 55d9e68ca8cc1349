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

ZeRO-1 on a process mesh (`launch.mesh.make_process_mesh`): with
`mesh=`, `init_state` keeps of each leaf's flat padded vector only this
rank's slice over the ZeRO axes (`state_axes`' "zero": every axis), cut
at whole QBLOCK blocks (`zero_share`: the int8 scales are the
single-device ones), and `apply_updates` reduce-scatters each rank's
part of the gradient into the slices leaf by leaf, in buckets of at most
`BUCKET` floats, takes the global norm as the sqrt of a psum of the
slices' sums of squares, updates the slices with the same arithmetic,
and all-gathers the new weights into the parameters. With one rank the
slice is the whole vector and no arithmetic changes. `state_to_host` and
`state_from_host` move a state, a ZeRO slice or a whole one, to and from
the single-device layout of a snapshot.

A model that keeps blocks (`sharding.layout`: FSDP over the data axes,
tensor parallelism over `model`) keeps the same flat ZeRO state: a leaf's
flat vector is that of its whole tensors, and a rank's blocks move to and
from the ZeRO ranges through `_Whole`, which widens a block to its whole
tensor (zeros elsewhere) while a bucket reads or writes it. The ranks
holding the same block hand it on once (`sharding.layout.owner` for the
init; `train_step.rank_grads` for gradients), so the bucketed
reduce-scatter sums each element once; the all-gather of the new
weights writes every whole tensor, of which each rank keeps its block.
Transient: the whole tensors that a bucket's ranges are inside at once,
at most about `shards` layers' tensors of one leaf (an embedding
whole).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.sharding import collectives as coll
from repro_torch.sharding.layout import global_numel, is_block, owner

QBLOCK = 128
BUCKET = 1 << 25         # floats a reduce-scatter or all-gather moves at most


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
    """The elements of a leaf's whole tensors (of a block's whole)."""
    return sum(global_numel(t) for t in _parts(leaf))


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


def zero_share(n_pad: int, ranks: int) -> int:
    """The length of one rank's slice of a flat leaf of padded length
    `n_pad` over `ranks` ranks: ceil(blocks / ranks) whole QBLOCK blocks
    (the last ranks' run past `n_pad` into zeros)."""
    return -(-(n_pad // QBLOCK) // ranks) * QBLOCK


def _zero_group(mesh):
    """The ZeRO group of a process mesh; None on any other mesh."""
    if mesh is None or not getattr(mesh, "process", False):
        return None
    from repro_torch.launch.mesh import ZERO_AXES
    return mesh.group(ZERO_AXES)


def _read_range(parts, lo: int, out: torch.Tensor) -> torch.Tensor:
    """out := elements [lo, lo + len(out)) of the leaf's flat vector
    (zeros past its end), converted to out's dtype."""
    out.zero_()
    hi, at = lo + out.numel(), 0
    for t in parts:
        n = t.numel()
        a, b = max(lo, at), min(hi, at + n)
        if a < b:
            out[a - lo:b - lo] = t.detach().reshape(-1)[a - at:b - at]
        at += n
    return out


class _Whole:
    """A leaf's flat vector (its whole tensors, one after another) over
    this rank's `values` of its `parts` (the parameters; `values` their
    blocks' values, the parameters themselves by default), read
    (`read_rows`) or written (`write_rows`, then the block is copied into
    `values`) by rows: row r of a bucket is the range [r * per + lo,
    r * per + lo + m) of the ZeRO rank r's slice. A part that is whole is
    read and written in place; a block is widened to its whole tensor
    (`dtype`) when a row first reaches it, and dropped once each of its
    elements was read or written: every element is reached once by the
    rows of one exchange. The rows that lie whole inside one part move as
    one strided view (they are `per` apart), so a bucket costs a few ops
    a part, not one a rank."""

    def __init__(self, parts, values=None, dtype=torch.float32):
        self.parts = parts
        self.values = parts if values is None else values
        self.dtype = dtype
        self.open = {}          # part -> [whole tensor, elements left]

    def _spans(self, lo: int, per: int, rows: int, m: int):
        """Per part i that the rows reach: (i, (r0, r1, first): the rows
        r0..r1 whole inside it from its element `first` on, `per` apart,
        or None; [(r, a, b, first)]: each other row's elements [a, b)
        from the part's element `first`)."""
        at = 0
        for i, t in enumerate(self.parts):
            n = global_numel(t)
            r_min = max(0, (at - lo - m) // per + 1)
            r_max = min(rows - 1, (at + n - 1 - lo) // per)
            if r_min <= r_max:
                f0 = max(r_min, -((lo - at) // per))
                f1 = min(r_max, (at + n - m - lo) // per)
                full = (f0, f1, f0 * per + lo - at) if f0 <= f1 else None
                edges = []
                for r in range(r_min, r_max + 1):
                    if full is None or not f0 <= r <= f1:
                        start = r * per + lo
                        a, b = max(start, at), min(start + m, at + n)
                        edges.append((r, a - start, b - start, a - at))
                yield i, full, edges
            at += n

    def _flat(self, i: int, fill: bool) -> torch.Tensor:
        """Part i's whole tensor, flat: the value itself where it is
        whole (to read: a copy if it is not contiguous), else its block
        widened (zeros elsewhere; `fill`: to read)."""
        t = self.parts[i]
        if not is_block(t):
            v = self.values[i].detach()
            return v.reshape(-1) if fill else v.view(-1)
        if i not in self.open:
            w = torch.zeros(t.placement.shape, dtype=self.dtype,
                            device=t.device)
            if fill:
                w[t.placement.index] = self.values[i].detach()
            self.open[i] = [w, w.numel()]
        return self.open[i][0].view(-1)

    def _done(self, i: int, k: int, write: bool) -> None:
        if not is_block(self.parts[i]):
            return
        entry = self.open[i]
        entry[1] -= k
        if entry[1] == 0:
            if write:
                t = self.parts[i]
                self.values[i].copy_(entry[0][t.placement.index])
            del self.open[i]

    @staticmethod
    def _strided(flat: torch.Tensor, full, per: int, m: int):
        r0, r1, first = full
        return flat.as_strided((r1 - r0 + 1, m), (per, 1),
                               flat.storage_offset() + first)

    def read_rows(self, lo: int, per: int, out: torch.Tensor) -> None:
        """out [rows, m] := each row's elements (zeros past the end)."""
        out.zero_()
        rows, m = out.shape
        for i, full, edges in self._spans(lo, per, rows, m):
            src = self._flat(i, True)
            k = 0
            if full is not None:
                out[full[0]:full[1] + 1] = self._strided(src, full, per, m)
                k += (full[1] - full[0] + 1) * m
            for r, a, b, first in edges:
                out[r, a:b] = src[first:first + b - a]
                k += b - a
            self._done(i, k, False)

    def write_rows(self, lo: int, per: int, src: torch.Tensor) -> None:
        """Each row's elements := src [rows, m], where they exist."""
        rows, m = src.shape
        for i, full, edges in self._spans(lo, per, rows, m):
            dst = self._flat(i, False)
            k = 0
            if full is not None:
                self._strided(dst, full, per, m).copy_(
                    src[full[0]:full[1] + 1])
                k += (full[1] - full[0] + 1) * m
            for r, a, b, first in edges:
                dst[first:first + b - a].copy_(src[r, a:b])
                k += b - a
            self._done(i, k, True)


def _to_ranges(parts, values, zero, per: int, hand_on: bool
               ) -> torch.Tensor:
    """This rank's ZeRO range (`per` floats) of the sum over the ZeRO
    group of the ranks' `values` of a leaf's `parts` (their blocks, or
    None: nothing), each rank's counted where `hand_on`."""
    dev = parts[0].device
    whole = _Whole(parts, values) if values is not None else None
    mine = torch.empty(per, dtype=torch.float32, device=dev)
    for lo, m in _chunks(per, zero.shards):
        buf = torch.zeros((zero.shards, m), dtype=torch.float32, device=dev)
        if whole is not None and hand_on:
            whole.read_rows(lo, per, buf)
        coll.reduce_scatter_(mine[lo:lo + m], buf.view(-1), zero)
        del buf
    return mine


def _chunks(per: int, ranks: int):
    """(start, length) of the buckets one rank's slice of `per` moves in:
    each at most BUCKET floats over all ranks, whole blocks."""
    step = max(QBLOCK, min(per, BUCKET // ranks // QBLOCK * QBLOCK))
    return [(lo, min(step, per - lo)) for lo in range(0, per, step)]


def _add_sumsq(total, parts, lo: int, vec: torch.Tensor):
    """`total` (None for none yet) plus the float32 sums of squares of
    vec, the elements [lo, lo + len(vec)) of a leaf's flat vector, added
    part by part, as `global_norm` adds a whole leaf's."""
    at, hi = 0, lo + vec.numel()
    for t in parts:
        n = global_numel(t)
        a, b = max(lo, at), min(hi, at + n)
        if a < b:
            s = vec[a - lo:b - lo].square().sum()
            total = s if total is None else total + s
        at += n
    return total


def init_state(params, cfg: AdamWConfig, *, mesh=None) -> AdamState:
    """The state of `params` before the first step; on a process mesh,
    this rank's ZeRO slice of it (see the module doc)."""
    zero = _zero_group(mesh)
    if zero is not None:
        return _init_zero(params, cfg, zero)
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


def _init_zero(params, cfg: AdamWConfig, zero) -> AdamState:
    def slices(p):
        parts = _parts(p)
        per = zero_share(_pad_len(leaf_size(p)), zero.shards)
        dev = parts[0].device
        if any(is_block(t) for t in parts):
            # the ranges of whole tensors this rank holds blocks of: each
            # block handed on by one of the ranks that hold it
            master = _to_ranges(parts, parts, zero, per,
                                all(owner(t) for t in parts))
        else:
            master = _read_range(parts, zero.rank * per,
                                 torch.empty(per, dtype=torch.float32,
                                             device=dev))
        if cfg.int8_moments:
            mom = lambda: (torch.zeros(per, dtype=torch.int8, device=dev),
                           torch.zeros(per // QBLOCK, dtype=torch.float32,
                                       device=dev))
        else:
            mom = lambda: torch.zeros(per, dtype=torch.float32, device=dev)
        return master, mom(), mom()

    out = tree_map(slices, params)
    master, m, v = (tree_map(lambda o, i=i: o[i], out) for i in range(3))
    dev = _parts(next(iter(tree_leaves(params))))[0].device
    return AdamState(step=torch.zeros((), dtype=torch.int32, device=dev),
                     master=master, m=m, v=v)


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


def leaf_slots(tree):
    """(container, key) of every leaf of nested dicts, in JAX's order."""
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from leaf_slots(tree[k])
        else:
            yield tree, k


def leaf_paths(tree, prefix: str = ""):
    """The '/'-joined path of every leaf of nested dicts, in JAX's order
    (a snapshot's keys below its tree's name)."""
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from leaf_paths(tree[k], f"{prefix}{k}/")
        else:
            yield prefix + k


@torch.no_grad()
def reduce_scatter_grads(params, grads, zero, data_ranks: int) -> list:
    """This rank's slice of each leaf's gradient, float32, in leaf order:
    the sum over the ZeRO group of the ranks' parts (`grads`' leaves, of
    the shapes of `params`' blocks; a leaf None adds nothing), divided by
    `data_ranks`. Each leaf of `grads` is dropped once reduced, so that
    its memory goes."""
    out = []
    for (gtree, k), p in zip(leaf_slots(grads), tree_leaves(params)):
        g = gtree[k]
        gtree[k] = None
        per = zero_share(_pad_len(leaf_size(p)), zero.shards)
        mine = _to_ranges(_parts(p), None if g is None else _parts(g), zero,
                          per, True)
        del g
        if data_ranks > 1:
            mine.div_(data_ranks)
        out.append(mine)
    return out


@torch.no_grad()
def _gather_params(params, master_slices: list, zero) -> None:
    """Every parameter := the all-gather of its leaf's master slices, cast
    to the parameter's dtype (of a block: its part of them)."""
    for p, mstr in zip(tree_leaves(params), master_slices):
        parts = _parts(p)
        whole = _Whole(parts, dtype=parts[0].dtype)
        per = mstr.numel()
        for lo, m in _chunks(per, zero.shards):
            recv = torch.empty(zero.shards * m, dtype=parts[0].dtype,
                               device=mstr.device)
            coll.all_gather_(recv, mstr[lo:lo + m].to(parts[0].dtype), zero)
            whole.write_rows(lo, per, recv.view(zero.shards, m))


@torch.no_grad()
def apply_updates(params, grads, state: AdamState, cfg: AdamWConfig, *,
                  mesh=None
                  ) -> Tuple[Any, AdamState, Dict[str, torch.Tensor]]:
    """One AdamW step. Writes the new weights into `params` (cast to each
    parameter's dtype) and returns (params, the new state, metrics): the
    fp32 moments and the masters are updated in place.

    On a process mesh `state` is this rank's ZeRO slice (`init_state(...,
    mesh=)`) and `grads` this rank's part of the gradient: the gradient
    is their sum over the ZeRO group divided by the data-parallel degree
    (a leaf may be None: it adds nothing). `grads`' leaves are dropped as
    they are reduced."""
    zero = _zero_group(mesh)
    if zero is not None:
        from repro_torch.launch.mesh import DATA_AXES
        g_slices = reduce_scatter_grads(
            params, grads, zero, mesh.group(DATA_AXES).shards)
        total = None
        for p, g in zip(tree_leaves(params), g_slices):
            total = _add_sumsq(total, _parts(p), zero.rank * g.numel(), g)
        if total is None:
            total = torch.zeros((), dtype=torch.float32,
                                device=g_slices[0].device)
        total = total.reshape(1).contiguous()
        coll.all_reduce_(total, zero)
        gnorm = _sqrt_(total[0])
        it = iter(g_slices)
        grads = tree_map(lambda _: next(it), state.master)
    else:
        gnorm = global_norm(grads)
    step = state.step + 1
    if cfg.grad_clip:
        gscale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                             max=1.0)
    else:
        gscale = torch.ones((), dtype=torch.float32, device=gnorm.device)
    stepf = step.float()
    bc1 = 1.0 - cfg.b1 ** stepf
    bc2 = 1.0 - cfg.b2 ** stepf

    def update(p, g, mstr, m, v):
        gf = (g.mul_(gscale) if zero is not None
              else _flatten_pad(g).mul_(gscale))
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
        if zero is None:            # a ZeRO slice is all-gathered below
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
    if zero is not None:
        del grads, out
        _gather_params(params, list(tree_leaves(master)), zero)
    return params, AdamState(step=step, master=master, m=m, v=v), \
        dict(grad_norm=gnorm)


# ---------------------------------------------------------------------------
# a ZeRO state and the single-device layout of a snapshot
# ---------------------------------------------------------------------------

def _state_leaves(state: AdamState):
    """(field, leaf index, part) of every tensor of a state but the step,
    with the tensor: part None for a float32 vector, 0/1 for an int8
    moment's codes/scales."""
    for field in ("master", "m", "v"):
        for i, leaf in enumerate(tree_leaves(getattr(state, field))):
            if isinstance(leaf, tuple):
                yield (field, i, 0), leaf[0]
                yield (field, i, 1), leaf[1]
            else:
                yield (field, i, None), leaf


def _rebuild(state: AdamState, step, new: dict) -> AdamState:
    """`state`'s structure with each tensor replaced by `new[(field, i,
    part)]`."""
    def field(name):
        it = itertools.count()

        def leaf(x):
            i = next(it)
            if isinstance(x, tuple):
                return (new[(name, i, 0)], new[(name, i, 1)])
            return new[(name, i, None)]
        return tree_map(leaf, getattr(state, name))
    return AdamState(step=step, master=field("master"), m=field("m"),
                     v=field("v"))


def _full_len(params, where) -> int:
    """The single-device length of a state tensor: the padded leaf, or
    its block count for int8 scales."""
    _, i, part = where
    n = _pad_len(leaf_size(list(tree_leaves(params))[i]))
    return n // QBLOCK if part == 1 else n


@torch.no_grad()
def state_to_host(state: AdamState, params, mesh) -> Optional[AdamState]:
    """A ZeRO state gathered into the single-device layout, as numpy, on
    the mesh's writer (None on every other rank); every rank must call
    it. Any other state comes back as numpy as it is."""
    zero = _zero_group(mesh)
    host = {}
    for where, t in _state_leaves(state):
        if zero is not None:
            full = torch.empty(zero.shards * t.numel(), dtype=t.dtype,
                               device=t.device)
            coll.all_gather_(full, t.contiguous(), zero)
            t = full[:_full_len(params, where)]
        if mesh is None or mesh.writer:
            host[where] = t.cpu().numpy().copy()
    if mesh is not None and not mesh.writer:
        return None
    return _rebuild(state, state.step.cpu().numpy().copy(), host)


@torch.no_grad()
def state_from_host(flat, like: AdamState, params, mesh, *,
                    prefix: str = "opt") -> AdamState:
    """The state `like` (this rank's ZeRO slice, or a whole state) with the
    values of a flat snapshot in the single-device layout: `flat` maps
    `<prefix>/step`, `<prefix>/master/<JAX path>`, ... (an int8 moment's
    codes and scales under `.../0` and `.../1`) to numpy arrays, and may
    read them lazily (`Checkpointer.reading`). Each array is read, cut to
    this rank's slice on a process mesh and put on its device before the
    next is read, so the host holds one leaf at a time."""
    zero = _zero_group(mesh)
    paths = list(leaf_paths(like.master))
    out = {}
    for where, t in _state_leaves(like):
        field, i, part = where
        key = f"{prefix}/{field}/{paths[i]}" + (
            "" if part is None else f"/{part}")
        arr = flat[key]
        if arr.shape != (_full_len(params, where),):
            raise ValueError(f"{key}: shape {arr.shape}, expected "
                             f"({_full_len(params, where)},)")
        lo = 0 if zero is None else zero.rank * t.numel()
        seg = arr[lo:lo + t.numel()]
        dst = torch.zeros(t.numel(), dtype=t.dtype, device=t.device)
        dst[:seg.shape[0]] = torch.from_numpy(np.ascontiguousarray(seg)).to(
            device=t.device, dtype=t.dtype)
        out[where] = dst
        del arr, seg
    step = torch.as_tensor(np.asarray(flat[f"{prefix}/step"])).to(
        dtype=like.step.dtype, device=like.step.device)
    return _rebuild(like, step, out)
