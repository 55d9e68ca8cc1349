"""Dry run: every (arch x shape) cell's real step at full width, without
allocation.

The JAX package's `repro.launch.dryrun`, for the port. Each cell runs the
port's own step function on fake tensors
(`torch._subclasses.fake_tensor.FakeTensorMode`: shapes, dtypes and
devices, no memory) at the config's full width and depth, on one device
under the 1x1 mesh's sharding rules:

    train_4k    -> make_train_step (loss + grads + AdamW)
    prefill_32k -> model.prefill
    decode_32k / long_500k -> model.decode_step against a full cache

and records:

- FLOPs from `torch.utils.flop_counter.FlopCounterMode`, which counts
  every matmul and attention op the step executes, remat's recomputed
  forward and every layer of every microbatch included. The JAX
  package's scan-unroll calibration (`calibrated_costs`) corrects XLA's
  cost analysis, which counts a loop body once; it has no counterpart
  here (`method: "direct_count"`).
- Bytes accessed: each op's tensor inputs and outputs (views move
  nothing), the eager step's traffic with nothing fused.
- Argument bytes from the shapes: the parameters, the optimizer state
  (`train.state_axes`' leaves), the inputs of `configs.input_specs` and
  the cache.
- Peak bytes from `LiveBytes`, a dispatch mode of this module that
  counts the bytes of the storages the step's ops create while they are
  alive, above the arguments.

Production-mesh rows give each device's share of the argument bytes,
from `ShardingRules.spec` and `local_shape` on an abstract 16x16 or
2x16x16 mesh. For the train cells (every family keeps blocks on a
process mesh) and the serving cells of the decoder-only transformers
(prefill and decode on blocks, the cache in the serving layout) they
also give one rank's temporaries and collective bytes: `trace_rank`
runs rank 0's step of the process-mesh program (its blocks of the
weights, its rows, its ZeRO slice or its cache block) on fake tensors
under `launch.mesh.make_rank_mesh`, whose collectives move nothing and
are noted by a `sharding.collectives.CollectiveLog`. The serving cells
of Mamba-2, RG-LRU and Whisper leave them null (`NO_RANK_TRACE`: their
layouts are ROADMAP item 4h).

Results land in results/dryrun_torch/<cell>.json; existing cells are
skipped, so the sweep is restartable cell by cell:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-7b \\
        --shape train_4k --mesh single [--device cpu]

`--rank-only` traces rank 0 alone, without the single-device trace, into
results/dryrun_torch/<cell>__rank.json.

Without `--device` the fake tensors are the card's (nothing is allocated
there).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback
import weakref
from typing import Callable, Dict, Optional

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.analysis.roofline import (HBM_BYTES, build_roofline,
                                           model_flops_for)
from repro_torch.configs import (ARCHS, SHAPES, get_config, input_specs,
                                 shape_applicable)
from repro_torch.convert import Stack, lm_param_tree
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import (make_local_mesh, make_production_mesh,
                                     make_rank_mesh)
from repro_torch.models import get_model
from repro_torch.models.common import remat_policy
from repro_torch.models.transformer import Transformer
from repro_torch.sharding.collectives import CollectiveLog
from repro_torch.sharding.layout import serve_rows
from repro_torch.sharding.rules import (ShardingRules, active_rules,
                                        default_rules)
from repro_torch.train import (AdamWConfig, init_state, make_train_step,
                               state_axes)

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")
MESHES = {"pod16x16": False, "pod2x16x16": True}
NOT_TRACED = "no rank trace run (the CLI's: minutes of host time a cell)"
NO_RANK_TRACE = ("no rank trace: Mamba-2, RG-LRU and Whisper serve with "
                 "whole weights only (ROADMAP 4h: their caches split over "
                 "ffn, q_heads and kv_heads)")


def microbatches_for(cfg, multi_pod: bool) -> int:
    """Per-device microbatch ~1-2 sequences for huge models."""
    n = cfg.param_count()
    if n > 100e9:
        return 16
    if n > 30e9:
        return 4
    return 1


def int8_for(cfg) -> bool:
    return cfg.param_count() > 100e9


def _nbytes(shape, dtype) -> int:
    return math.prod(shape) * dtype.itemsize


class LiveBytes(TorchDispatchMode):
    """Counts, for the ops run under it, the bytes of the storages they
    create while those are alive (`peak` the most at once, from
    `baseline` up) and the bytes every op reads and writes (`accessed`:
    its tensor inputs and outputs; views count nothing). A storage is
    counted once, when an op first returns it and none of the op's inputs
    holds it (a view or an in-place result of an input allocates
    nothing), and released when it is freed; storages that existed
    before are not counted (the arguments: pass their bytes as
    `baseline`). Works on fake tensors, whose storages are freed as real
    ones would be."""

    def __init__(self, baseline: int = 0):
        super().__init__()
        self.live = self.peak = baseline
        self.accessed = 0
        self._seen = WeakIdKeyDictionary()

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func is torch.ops.prim.device.default:   # a `.device` read
            return out
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        if not func.is_view:
            self.accessed += sum(t.numel() * t.element_size()
                                 for t in ins + outs)
        held = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            st = t.untyped_storage()
            if st in self._seen or st._cdata in held:
                continue
            n = st.nbytes()
            self._seen[st] = n
            weakref.finalize(st, self._free, n)
            self.live += n
            self.peak = max(self.peak, self.live)
        return out


def _param_leaves(model):
    """(shape, dtype, logical axes) of each parameter leaf in the JAX
    package's tree (a layer stack one leaf of shape lead + layer's)."""
    out = []

    def walk(tree, axes):
        for k in sorted(tree):
            leaf = tree[k]
            if isinstance(leaf, dict):
                walk(leaf, axes[k])
            elif isinstance(leaf, Stack):
                out.append((leaf.lead + tuple(leaf[0].shape), leaf[0].dtype,
                            axes[k]))
            else:
                out.append((tuple(leaf.shape), leaf.dtype, axes[k]))

    walk(lm_param_tree(model), model.param_axes())
    return out


def _tree_leaves(tree, axes):
    """(shape, dtype, axes) of a tree of nested dicts, tuples and
    NamedTuples of tensors (optimizer state, a cache), beside its axes."""
    if isinstance(tree, dict):
        for k in tree:
            yield from _tree_leaves(tree[k], axes[k])
    elif isinstance(tree, (tuple, list)):
        for t, a in zip(tree, axes):
            yield from _tree_leaves(t, a)
    else:
        yield tuple(tree.shape), tree.dtype, axes


def _batch_leaves(specs):
    return [(tuple(v.shape), v.dtype, ("batch",) + (None,) * (v.ndim - 1))
            for v in specs.values()]


def per_device_bytes(leaves, rules: Optional[ShardingRules]) -> int:
    """Bytes of `leaves` ((shape, dtype, axes) triples) that one device
    holds under `rules` (all of them when None)."""
    total = 0
    for shape, dtype, axes in leaves:
        if rules is not None:
            shape = rules.local_shape(shape, rules.spec(axes, shape))
        total += _nbytes(shape, dtype)
    return total


def _fake_inputs(cfg, shape, device) -> Dict[str, torch.Tensor]:
    """The cell's inputs as the port's step takes them: token ids int64
    (as `launch.train.make_batch` gives them), the rest as specified."""
    out = {}
    for k, v in input_specs(cfg, shape).items():
        dtype = torch.long if v.dtype == torch.int32 else v.dtype
        out[k] = torch.zeros(v.shape, dtype=dtype, device=device)
    return out


def build_cell(cfg, shape, device, *, q_chunk: int = 512,
               microbatches: Optional[int] = None,
               int8_moments: Optional[bool] = None,
               seed: Optional[int] = None) -> dict:
    """The cell's model, arguments and step on `device`, weights from
    `seed` (left unset when None). On the meta device, or under
    `FakeTensorMode`, nothing is allocated. Returns dict(run: the step as
    a thunk, inputs: as the step takes them, leaves: (shape, dtype, axes)
    of the parameters, optimizer state and cache, input_leaves: of the
    inputs as `input_specs` gives them, microbatches, int8_moments)."""
    model = get_model(cfg)(cfg, device=device, seed=seed)
    leaves = _param_leaves(model)
    inputs = _fake_inputs(cfg, shape, device)
    nm = int8 = None
    if shape.kind == "train":
        nm = (microbatches if microbatches is not None
              else microbatches_for(cfg, False))
        int8 = int8_for(cfg) if int8_moments is None else int8_moments
        adam = AdamWConfig(int8_moments=int8)
        state = init_state(lm_param_tree(model), adam)
        leaves += list(_tree_leaves(
            state, state_axes(model.param_axes(), int8)))
        step = make_train_step(cfg, model, adam, num_microbatches=nm,
                               loss_kwargs=dict(q_chunk=q_chunk))
        run = lambda: step(state, inputs)  # noqa: E731
    elif shape.kind == "prefill":
        extra = {k: v for k, v in inputs.items() if k != "tokens"}
        run = lambda: model.prefill(inputs["tokens"],  # noqa: E731
                                    q_chunk=q_chunk, **extra)
    else:
        cache = model.init_cache(shape.global_batch, shape.seq_len)
        leaves += list(_tree_leaves(cache, model.cache_axes(
            shape.global_batch, shape.seq_len)))
        run = lambda: model.decode_step(cache, inputs["token"])  # noqa
    return dict(run=run, inputs=inputs, leaves=leaves,
                input_leaves=_batch_leaves(input_specs(cfg, shape)),
                microbatches=nm, int8_moments=int8)


def argument_bytes(cell: dict) -> int:
    """The bytes of a `build_cell`'s arguments as allocated (token ids
    int64)."""
    return per_device_bytes(cell["leaves"], None) + sum(
        v.numel() * v.element_size() for v in cell["inputs"].values())


def trace_cell(cfg, shape, *, device=None, q_chunk: int = 512,
               microbatches: Optional[int] = None,
               int8_moments: Optional[bool] = None,
               remat: str = "full") -> dict:
    """Run the cell's step once on fake tensors at `cfg`'s size on
    `device` (the card when None) under the 1x1 mesh's rules. Returns its
    FLOPs, bytes accessed, argument bytes (as allocated), peak bytes, and
    the argument leaves ((shape, dtype, axes), the inputs as specified)
    for the production meshes' shares."""
    device = resolve_device(device)
    with FakeTensorMode():
        cell = build_cell(cfg, shape, device, q_chunk=q_chunk,
                          microbatches=microbatches,
                          int8_moments=int8_moments)
        args = argument_bytes(cell)
        rules = ShardingRules(make_local_mesh(device), default_rules(False))
        live = LiveBytes(baseline=args)
        flops = FlopCounterMode(display=False)
        policy = (remat_policy(remat) if shape.kind == "train"
                  else contextlib.nullcontext())
        t0 = time.perf_counter()
        with active_rules(rules), policy, live, flops:
            cell["run"]()
        secs = time.perf_counter() - t0
    return dict(flops=float(flops.get_total_flops()),
                bytes_accessed=float(live.accessed), argument_bytes=args,
                peak_bytes=live.peak,
                leaves=cell["leaves"] + cell["input_leaves"], trace_s=secs,
                microbatches=cell["microbatches"],
                int8_moments=cell["int8_moments"])


def rank_microbatches(cfg, shape, dp: int,
                      microbatches: Optional[int] = None) -> int:
    """The microbatches of a rank's step: `microbatches_for` (or the
    given count), cut to the most that leave each data rank whole rows of
    each (a 16-microbatch step has 16 rows a microbatch, fewer than the
    32 data ranks of 2x16x16)."""
    nm = microbatches if microbatches is not None else microbatches_for(
        cfg, False)
    while nm > 1 and shape.global_batch % (nm * dp):
        nm -= 1
    return nm


def rank_traceable(cfg, shape) -> bool:
    """Whether the cell runs on a process mesh with blocks: every train
    step, and the serving of the decoder-only transformers."""
    return shape.kind == "train" or issubclass(get_model(cfg), Transformer)


def trace_rank(cfg, shape, mesh_shape: Dict[str, int], rank: int = 0, *,
               device=None, q_chunk: int = 512,
               microbatches: Optional[int] = None,
               int8_moments: Optional[bool] = None,
               remat: str = "full") -> dict:
    """One rank's step of the cell over a process mesh of `mesh_shape`,
    on fake tensors at that rank's shapes on `device` (the card when
    None), under `make_rank_mesh`. A train step takes the global batch
    and keeps its rows, as `run_training` does, with the rank's blocks of
    the weights and its ZeRO slice of the state; prefill and decode take
    the rank's rows (`layout.serve_rows`), and decode the rank's blocks
    of the cache. Returns its FLOPs, bytes accessed, argument bytes, peak
    bytes, and the bytes and calls of its collectives by kind
    (`CollectiveLog`: the init's exchange of the state is not counted,
    the step's is)."""
    if not rank_traceable(cfg, shape):
        raise ValueError(f"{cfg.name} {shape.name}: {NO_RANK_TRACE}")
    device = resolve_device(device)
    mesh = make_rank_mesh(mesh_shape, rank, device)
    rules = ShardingRules(mesh, default_rules("pod" in mesh_shape))
    train = shape.kind == "train"
    nm = int8 = None
    if train:
        dp = rules._axis_size(tuple(a for a in ("pod", "data")
                                    if a in mesh_shape))
        nm = rank_microbatches(cfg, shape, dp, microbatches)
        int8 = int8_for(cfg) if int8_moments is None else int8_moments
    with FakeTensorMode():
        model = get_model(cfg)(cfg, device=device, seed=None, mesh=mesh)
        inputs = _fake_inputs(cfg, shape, device)
        state = ()
        if train:
            adam = AdamWConfig(int8_moments=int8)
            state = init_state(lm_param_tree(model), adam, mesh=mesh)
            step = make_train_step(cfg, model, adam, num_microbatches=nm,
                                   loss_kwargs=dict(q_chunk=q_chunk),
                                   mesh=mesh)
            run = lambda: step(state, inputs)  # noqa: E731
        else:
            rows = serve_rows(shape.global_batch, mesh)
            inputs = {k: v[rows] for k, v in inputs.items()}
            if shape.kind == "prefill":
                extra = {k: v for k, v in inputs.items() if k != "tokens"}
                run = lambda: model.prefill(  # noqa: E731
                    inputs["tokens"], q_chunk=q_chunk, **extra)
            else:
                state = model.init_cache(shape.global_batch, shape.seq_len)
                run = lambda: model.decode_step(  # noqa: E731
                    state, inputs["token"])
        args = sum(t.numel() * t.element_size()
                   for t in list(model.parameters()) + list(
                       tree_leaves(state)) + list(inputs.values()))
        live = LiveBytes(baseline=args)
        flops = FlopCounterMode(display=False)
        policy = remat_policy(remat) if train else contextlib.nullcontext()
        t0 = time.perf_counter()
        with active_rules(rules), policy, live, flops, \
                CollectiveLog() as log:
            run()
        secs = time.perf_counter() - t0
    return dict(flops=float(flops.get_total_flops()),
                bytes_accessed=float(live.accessed), argument_bytes=args,
                peak_bytes=live.peak, temp_bytes=live.peak - args,
                coll_bytes=log.total, coll_by_kind=dict(log.bytes),
                coll_calls=dict(log.calls), trace_s=secs, microbatches=nm,
                int8_moments=int8, mesh=dict(mesh_shape), rank=rank)


def mesh_argument_bytes(cfg, shape, multi_pod: bool) -> int:
    """One device's argument bytes of the cell on a production mesh, from
    the shapes alone (the model built on the meta device)."""
    cell = build_cell(cfg, shape, "meta")
    return per_device_bytes(cell["leaves"] + cell["input_leaves"],
                            mesh_rules(multi_pod))


def mesh_rules(multi_pod: bool) -> ShardingRules:
    return ShardingRules(make_production_mesh(multi_pod=multi_pod,
                                              abstract=True),
                         default_rules(multi_pod))


def cell_record(arch: str, shape_name: str, mesh_name: str,
                trace: Optional[Callable[[], dict]],
                rank_trace: Optional[Callable[[], dict]] = None) -> dict:
    """The JSON record of one cell at `mesh_name` ("pod16x16" or
    "pod2x16x16"): the step traced on one device (`trace()`, which
    returns `trace_cell`'s dict; with `trace` None, the record of the
    rank trace alone, `method` "rank_only"), the mesh's per-device
    argument bytes, and where the cell runs sharded (`rank_traceable`),
    rank 0's temporaries and collective bytes on the mesh
    (`rank_trace()`, which returns `trace_rank`'s dict for that mesh;
    null otherwise, with `NO_RANK_TRACE` where the cell does not run
    sharded and `NOT_TRACED` where no `rank_trace` was given)."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    record = dict(cell=f"{arch}__{shape_name}__{mesh_name}", arch=arch,
                  shape=shape_name, mesh=mesh_name, status="skipped",
                  reason=None)
    if not shape_applicable(cfg, shape):
        record["reason"] = ("long_500k needs sub-quadratic attention; "
                            f"{arch} is full-attention (DESIGN.md "
                            "§Arch-applicability)")
        return record
    try:
        rules = mesh_rules(MESHES[mesh_name])
        if trace is not None:
            traced = trace()
            args, peak = traced["argument_bytes"], traced["peak_bytes"]
            mem = dict(argument_size_in_bytes=args,
                       temp_size_in_bytes=peak - args, peak_bytes=peak)
            roof = build_roofline(arch, shape_name, "local1x1", 1,
                                  {"flops": traced["flops"],
                                   "bytes accessed":
                                       traced["bytes_accessed"]},
                                  mem, "", model_flops_for(cfg, shape))
            record |= dict(
                method="direct_count", t_trace_s=traced["trace_s"],
                memory=mem,
                cost=dict(flops=traced["flops"],
                          bytes_accessed=traced["bytes_accessed"]),
                roofline=roof.to_dict(), fits_80gb=peak <= HBM_BYTES,
                microbatches=traced["microbatches"],
                int8_moments=traced["int8_moments"])
            mesh_args = per_device_bytes(traced["leaves"], rules)
        else:
            record["method"] = "rank_only"
            mesh_args = mesh_argument_bytes(cfg, shape, MESHES[mesh_name])
        traceable = rank_traceable(cfg, shape)
        per_device = dict(chips=rules.mesh.size, argument_bytes=mesh_args,
                          temp_bytes=None, coll_bytes=None,
                          reason=NOT_TRACED if traceable else NO_RANK_TRACE)
        if rank_trace is not None and traceable:
            ranked = rank_trace()
            per_device |= dict(
                temp_bytes=ranked["temp_bytes"],
                coll_bytes=ranked["coll_bytes"], reason=None,
                rank=dict((k, ranked[k]) for k in (
                    "rank", "argument_bytes", "peak_bytes", "flops",
                    "coll_by_kind", "coll_calls", "microbatches",
                    "trace_s")))
        record |= dict(status="ok", per_device=per_device,
                       params_total=cfg.param_count(),
                       params_active=cfg.active_param_count())
    except Exception as e:  # noqa: BLE001 — the sweep survives a cell
        record |= dict(status="error", reason=f"{type(e).__name__}: {e}",
                       traceback=traceback.format_exc()[-4000:])
    return record


def run_cell(arch: str, shape_name: str, multi_pod: bool, *,
             q_chunk: int = 512, force: bool = False, device=None,
             results_dir: str = RESULTS_DIR,
             trace: Optional[Callable[[], dict]] = None,
             rank_only: bool = False) -> dict:
    """One cell's record, written to `results_dir` (read back from there
    unless `force`); `trace` as `cell_record`'s, by default a trace of
    the cell at full width on `device`; the rank trace (where the cell
    has one) at full width on the mesh, on `device`. With `rank_only`,
    the rank trace alone, into <cell>__rank.json."""
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    out_path = os.path.join(
        results_dir, f"{arch}__{shape_name}__{mesh_name}"
        + ("__rank" if rank_only else "") + ".json")
    if os.path.exists(out_path) and not force:
        with open(out_path) as f:
            return json.load(f)
    if trace is None and not rank_only:
        trace = lambda: trace_cell(get_config(arch),  # noqa: E731
                                   SHAPES[shape_name], device=device,
                                   q_chunk=q_chunk)
    rank_trace = lambda: trace_rank(  # noqa: E731
        get_config(arch), SHAPES[shape_name], dict(make_production_mesh(
            multi_pod=multi_pod, abstract=True).shape),
        device=device, q_chunk=q_chunk)
    record = cell_record(arch, shape_name, mesh_name,
                         None if rank_only else trace, rank_trace)
    os.makedirs(results_dir, exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(record, f, indent=2)
    return record


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--q-chunk", type=int, default=512)
    ap.add_argument("--device", default=None,
                    help="torch device of the fake tensors (default: the "
                    "CUDA card)")
    ap.add_argument("--results-dir", default=RESULTS_DIR)
    ap.add_argument("--rank-only", action="store_true",
                    help="trace rank 0 of the production mesh alone, "
                    "without the single-device trace")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list(ARCHS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    for arch in archs:
        for shape in shapes:
            # one trace serves both meshes' records
            traced = {}

            def trace(arch=arch, shape=shape, traced=traced):
                if not traced:
                    traced.update(trace_cell(
                        get_config(arch), SHAPES[shape], device=args.device,
                        q_chunk=args.q_chunk))
                return traced

            for mp in meshes:
                r = run_cell(arch, shape, mp, q_chunk=args.q_chunk,
                             force=args.force, device=args.device,
                             results_dir=args.results_dir, trace=trace,
                             rank_only=args.rank_only)
                status = r["status"]
                extra = ""
                if status == "ok" and args.rank_only:
                    pd = r["per_device"]
                    if pd["temp_bytes"] is not None:
                        extra = (f" rank-temp={pd['temp_bytes'] / 2**30:.2f}"
                                 f"GiB rank-coll="
                                 f"{pd['coll_bytes'] / 2**30:.4f}GiB "
                                 f"traced in {pd['rank']['trace_s']:.1f} s")
                    else:
                        extra = f" {pd['reason']}"
                elif status == "ok":
                    extra = (f" flops={r['cost']['flops']:.4g} "
                             f"peak={r['memory']['peak_bytes'] / 2**30:.2f}"
                             f"GiB per-device-args="
                             f"{r['per_device']['argument_bytes'] / 2**30:.3f}"
                             f"GiB bottleneck={r['roofline']['bottleneck']}")
                    pd = r["per_device"]
                    if pd["temp_bytes"] is not None:
                        extra += (f" rank-temp={pd['temp_bytes'] / 2**30:.2f}"
                                  f"GiB rank-coll="
                                  f"{pd['coll_bytes'] / 2**30:.2f}GiB")
                elif status == "error":
                    extra = f" {r['reason'][:120]}"
                print(f"[{status:7s}] {r['cell']}{extra}", flush=True)


if __name__ == "__main__":
    main()
