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
rank's range over the ZeRO axes (`state_axes`' "zero": every axis,
ranks numbered row-major over `launch.mesh.ZERO_AXES`), cut at whole
QBLOCK blocks (`zero_share`: the int8 scales are the single-device
ones). `apply_updates` sums the ranks' parts of the gradient into the
ranges leaf by leaf, takes the global norm as the sqrt of a psum of the
ranges' sums of squares, updates the ranges with the same arithmetic,
and moves the new weights back into the parameters. With one rank the
range is the whole vector and no arithmetic changes. `state_to_host`
and `state_from_host` move a state, a ZeRO range or a whole one, to and
from the single-device layout of a snapshot.

A model that keeps blocks (`sharding.layout`: FSDP over the data axes,
tensor parallelism over `model`; every parameter tagged with its
`Placement`) keeps the same flat state: a leaf's flat vector is that of
its whole tensors. Its blocks move to and from the ranges by an uneven
all_to_all over the ZeRO group (`collectives.all_to_all_v`), bucket by
bucket, each bucket at most `BUCKET` floats over all ranks' ranges:
every rank computes every rank's block of every part from the mesh's
shape, the part's spec and that rank's coordinates (`_Plan`); a block's
elements in a rank's bucket are one run of the block's own order
(`layout.below`), sent as it lies, and land in the receiver's range as
a few strided views (`layout.boxes`). Each element moves once a
contributor and no rank holds a whole tensor of a block:

    gradient  the ranks holding a block hand it on alike, but off model
              rank 0 where the model ranks hold it alike
              (`train_step.rank_grads`); the receiver sums them in
              ZeRO-rank order, then divides by the data-parallel degree
    init      only the holder at coordinate 0 on each axis the block is
              replicated over hands it on
    weights   the reverse: each rank sends each holder of a block the
              part of its range in that block, cast to the weight's dtype

A rank's transient is one bucket's buffers (a send and a receive of at
most `BUCKET` floats each) beside its ranges. A model of untagged (whole)
parameters keeps the bucketed reduce-scatter and all-gather of whole
leaves, each rank's bucket rows read and written as strided views of the
parts (`_row_boxes`).
"""
from __future__ import annotations

import bisect
import dataclasses
import itertools
import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.sharding import collectives as coll
from repro_torch.sharding.layout import (below, block_grid, boxes,
                                        global_numel, mesh_rules, placement)

QBLOCK = 128
BUCKET = 1 << 25         # floats a bucket sends or receives at most


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


class _Plan:
    """A leaf of tagged parts (`sharding.layout.Placement`) on the ZeRO
    group of `shards` ranks: each part's offset in the leaf's flat vector
    and each ZeRO rank's `Grid` of its block of each part (computed from
    the mesh's shape, the part's spec and the rank's coordinates:
    `coords[s]` those of ZeRO rank s)."""

    def __init__(self, parts, shards: int):
        from repro_torch.launch.mesh import ZERO_AXES
        mesh = placement(parts[0]).mesh
        rules = mesh_rules(mesh)
        self.coords = [mesh.group_coords(ZERO_AXES, s) for s in range(shards)]
        self.replicated = placement(parts[0]).replicated_over()
        self.at = list(itertools.accumulate(
            (global_numel(t) for t in parts), initial=0))
        by_layout = {}
        self.grids = []                 # [part][rank]
        for t in parts:
            pl = placement(t)
            key = (pl.shape, pl.spec)
            if key not in by_layout:
                by_layout[key] = [block_grid(pl.shape,
                                             rules.block(pl.shape, pl.spec, c))
                                  for c in self.coords]
            self.grids.append(by_layout[key])

    def runs(self, s: int, a: int, b: int) -> list:
        """[(part i, j0, j1)]: the runs [j0, j1) of ZeRO rank s's blocks
        whose elements lie in [a, b) of the leaf's flat vector, part by
        part."""
        out = []
        i = max(0, bisect.bisect_right(self.at, a) - 1)
        while i < len(self.grids) and self.at[i] < b:
            g = self.grids[i][s]
            lo, hi = max(a, self.at[i]), min(b, self.at[i + 1])
            if lo < hi:
                j0, j1 = (below(g, lo - self.at[i]),
                          below(g, hi - self.at[i]))
                if j0 < j1:
                    out.append((i, j0, j1))
            i += 1
        return out


def _view(t: torch.Tensor, shape, strides, at: int) -> torch.Tensor:
    """The strided view of `t`'s elements from its element `at` on."""
    return t.as_strided(shape, strides, t.storage_offset() + at)


def _coalesced(runs) -> list:
    """Runs [(part, j0, j1)] laid end to end in a buffer, as [(part, j0,
    j1, buffer position)], a run that continues the one before it in the
    same part merged into it."""
    out, pos = [], 0
    for i, j0, j1 in runs:
        if out and out[-1][0] == i and out[-1][2] == j0:
            out[-1][2] = j1
        else:
            out.append([i, j0, j1, pos])
        pos += j1 - j0
    return out


def _pack(flats, runs, n: int, dtype) -> torch.Tensor:
    """The runs [(part, j0, j1)] of the flat blocks `flats`, end to end
    (`n` elements), as `dtype`: a view where they are one run of that
    dtype already."""
    merged = _coalesced(runs)
    if len(merged) == 1 and flats[merged[0][0]].dtype == dtype:
        i, j0, j1, _ = merged[0]
        return flats[i][j0:j1]
    out = torch.empty(n, dtype=dtype, device=flats[0].device)
    for i, j0, j1, pos in merged:
        out[pos:pos + j1 - j0].copy_(flats[i][j0:j1])
    return out


def _blocks_in(parts, values, zero, per: int, *, gradient: bool
               ) -> torch.Tensor:
    """This rank's ZeRO range (`per` floats) of the sum over the ZeRO
    group of the ranks' `values` of a leaf's tagged `parts` (their
    blocks, of any float dtype; None: zeros), in ZeRO-rank order. Of the
    ranks holding the same block, the one at coordinate 0 on every axis
    it is replicated over hands it on; with `gradient`, every one but
    those off coordinate 0 on `model` where the block is replicated over
    it (`train_step.rank_grads`: the data ranks' parts are summed; the
    model ranks' are alike). The other ranks' values are not read. One
    uneven all_to_all a bucket: each rank sends the runs of its blocks
    that lie in each rank's bucket of its range, so each element moves
    once a contributor and no whole tensor is built; what a bucket
    receives, at most one run a contributor and part, is added into the
    range through `boxes`."""
    plan, me, Z = _Plan(parts, zero.shards), zero.rank, zero.shards
    once = [a for a in plan.replicated if not gradient or a == "model"]
    senders = [s for s in range(Z)
               if not any(plan.coords[s][a] for a in once)]
    sending = me in senders
    flats = (None if values is None or not sending
             else [v.detach().reshape(-1) for v in values])
    mine = torch.zeros(per, dtype=torch.float32, device=parts[0].device)
    for lo, m in _chunks(per, Z):
        runs, send_splits = [], []
        for r in range(Z):
            rr = plan.runs(me, r * per + lo, r * per + lo + m) if sending \
                else []
            runs += rr
            send_splits.append(sum(j1 - j0 for _, j0, j1 in rr))
        n = sum(send_splits)
        send = (torch.zeros(n, dtype=torch.float32, device=mine.device)
                if flats is None else _pack(flats, runs, n, torch.float32))
        a = me * per + lo
        got = [(s, plan.runs(s, a, a + m)) for s in senders]
        recv_splits = [0] * Z
        for s, rr in got:
            recv_splits[s] = sum(j1 - j0 for _, j0, j1 in rr)
        recv = coll.all_to_all_v(send, send_splits, recv_splits, zero)
        del send
        pos = 0
        for s, rr in got:
            for i, j0, j1 in rr:
                for j, shape, off, strides in boxes(plan.grids[i][s], j0,
                                                    j1):
                    k = pos + j - j0
                    _view(mine, shape, strides,
                          plan.at[i] + off - me * per).add_(
                        recv[k:k + math.prod(shape)].view(shape))
                pos += j1 - j0
        del recv
    return mine


def _blocks_out(parts, mstr: torch.Tensor, zero) -> None:
    """Every tagged part (a parameter's block) := its elements of the
    ZeRO ranges, whose this rank's is `mstr`, cast to its dtype: the
    reverse all_to_all of `_blocks_in`, each rank sending to each rank
    the part of its bucket of the range that lies in that rank's blocks
    (a block held alike by several ranks goes to each)."""
    plan, me, Z = _Plan(parts, zero.shards), zero.rank, zero.shards
    flats = [t.detach().view(-1) for t in parts]
    per, dtype = mstr.numel(), parts[0].dtype
    for lo, m in _chunks(per, Z):
        a = me * per + lo
        out, send_splits = [], []
        for h in range(Z):
            rr = plan.runs(h, a, a + m)
            out += [(h, run) for run in rr]
            send_splits.append(sum(j1 - j0 for _, j0, j1 in rr))
        send = torch.empty(sum(send_splits), dtype=dtype, device=mstr.device)
        pos = 0
        for h, (i, j0, j1) in out:
            for j, shape, off, strides in boxes(plan.grids[i][h], j0, j1):
                k = pos + j - j0
                send[k:k + math.prod(shape)].view(shape).copy_(
                    _view(mstr, shape, strides, plan.at[i] + off - me * per))
            pos += j1 - j0
        runs, recv_splits = [], []
        for r in range(Z):
            rr = plan.runs(me, r * per + lo, r * per + lo + m)
            runs += rr
            recv_splits.append(sum(j1 - j0 for _, j0, j1 in rr))
        recv = coll.all_to_all_v(send, send_splits, recv_splits, zero)
        del send
        for i, j0, j1, pos in _coalesced(runs):
            flats[i][j0:j1].copy_(recv[pos:pos + j1 - j0])
        del recv


def _row_boxes(parts, per: int, rows: int, lo: int, m: int):
    """The boxes in which a bucket's rows meet each of a leaf's whole
    parts, row r the leaf's flat elements [r * per + lo, r * per + lo +
    m), as `(i, j, shape, offset, strides)`: the box is the contiguous
    run of the bucket [rows, m] (row-major) from its element j, and the
    view of part i's flat vector from its element `offset` with
    `strides`. The bucket is a block of the leaf seen as [rows, per], the
    rows that lie whole in a part one box."""
    grid = block_grid((rows, per), (slice(0, rows), slice(lo, lo + m)))
    at = 0
    for i, t in enumerate(parts):
        n = t.numel()
        for j, shape, off, strides in boxes(grid, below(grid, at),
                                            below(grid, at + n)):
            yield i, j, shape, off - at, strides
        at += n


def _whole_in(parts, values, zero, per: int) -> torch.Tensor:
    """This rank's ZeRO range of the sum over the group of the ranks'
    `values` of a leaf of whole (untagged) parts (None: zeros): the
    bucketed reduce-scatter of the flat leaf."""
    flats = (None if values is None
             else [v.detach().reshape(-1) for v in values])
    mine = torch.empty(per, dtype=torch.float32, device=parts[0].device)
    for lo, m in _chunks(per, zero.shards):
        buf = torch.zeros(zero.shards * m, dtype=torch.float32,
                          device=mine.device)
        if flats is not None:
            for i, j, shape, off, strides in _row_boxes(parts, per,
                                                        zero.shards, lo, m):
                buf[j:j + math.prod(shape)].view(shape).copy_(
                    _view(flats[i], shape, strides, off))
        coll.reduce_scatter_(mine[lo:lo + m], buf, zero)
        del buf
    return mine


def _whole_out(parts, mstr: torch.Tensor, zero) -> None:
    """Every whole part := its elements of the all-gather of the ZeRO
    ranges (this rank's `mstr`), cast to its dtype."""
    flats = [t.detach().view(-1) for t in parts]
    per, dtype = mstr.numel(), parts[0].dtype
    for lo, m in _chunks(per, zero.shards):
        recv = torch.empty(zero.shards * m, dtype=dtype, device=mstr.device)
        coll.all_gather_(recv, mstr[lo:lo + m].to(dtype), zero)
        for i, j, shape, off, strides in _row_boxes(parts, per, zero.shards,
                                                    lo, m):
            _view(flats[i], shape, strides, off).copy_(
                recv[j:j + math.prod(shape)].view(shape))
        del recv


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


def _tagged(parts) -> bool:
    return placement(parts[0]) is not None


def _init_zero(params, cfg: AdamWConfig, zero) -> AdamState:
    def slices(p):
        parts = _parts(p)
        per = zero_share(_pad_len(leaf_size(p)), zero.shards)
        dev = parts[0].device
        if _tagged(parts):
            master = _blocks_in(parts, parts, zero, per, gradient=False)
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
    its memory goes. A leaf of tagged parts moves by `_blocks_in`, whose
    rule says which ranks give their part (`train_step.rank_grads`'), a
    leaf of whole parts by the reduce-scatter."""
    out = []
    for (gtree, k), p in zip(leaf_slots(grads), tree_leaves(params)):
        g = gtree[k]
        gtree[k] = None
        parts = _parts(p)
        values = None if g is None else _parts(g)
        per = zero_share(_pad_len(leaf_size(p)), zero.shards)
        mine = (_blocks_in(parts, values, zero, per, gradient=True)
                if _tagged(parts) else _whole_in(parts, values, zero, per))
        del g, values
        if data_ranks > 1:
            mine.div_(data_ranks)
        out.append(mine)
    return out


@torch.no_grad()
def _gather_params(params, master_slices: list, zero) -> None:
    """Every parameter := its elements of its leaf's master slices, cast
    to the parameter's dtype (of a block: its part of them)."""
    for p, mstr in zip(tree_leaves(params), master_slices):
        parts = _parts(p)
        if _tagged(parts):
            _blocks_out(parts, mstr, zero)
        else:
            _whole_out(parts, mstr, zero)


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
