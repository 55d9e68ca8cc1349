"""The port's dry run (`launch.dryrun`), input shapes (`configs.shapes`),
roofline (`analysis.roofline`, `analysis.hlo`) and `train.state_axes`
against the JAX package's, on the CPU.

- `SHAPES`, `shape_applicable` and `input_specs` (shapes and dtypes,
  meta tensors against `ShapeDtypeStruct`s) equal for all 40 cells, and
  `model_flops_for` equal for all 40 (level 1).
- `state_axes`: its structure mirrors `init_state`'s (as
  tests/test_train.py:84), and it equals JAX's for a toy tree.
- tests/test_analysis_hlo.py's six tests on the port's `hlo` and
  `roofline`.
- Per-device argument bytes of full-width Qwen2-7B and DeepSeek-V2 at
  train_4k on the 16x16 and 2x16x16 meshes equal the JAX package's
  arithmetic: its `ShardingRules.spec` over `jax.eval_shape` of its init,
  its optimizer state and `input_specs` (level 1).
- A dry run of one reduced config per family (dense, MoE, VLM, SSM,
  hybrid, audio; train, prefill, decode): the fake run's FlopCounterMode
  total equals the same counter around a real step on the CPU, and
  `LiveBytes`' peak and bytes accessed on fake tensors equal its counts
  on the real ones (level 1).
"""
import dataclasses
import importlib
import json
import math
import os

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh
from torch.utils.flop_counter import FlopCounterMode

from repro.analysis.roofline import model_flops_for as jax_model_flops_for
from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.configs import input_specs as jax_input_specs
from repro.configs import shape_applicable as jax_shape_applicable
from repro.models import get_model as jax_get_model
from repro.sharding import ShardingRules as JaxRules
from repro.sharding import default_rules as jax_default_rules
from repro.train import AdamWConfig as JaxAdamWConfig
from repro.train import init_state as jax_init_state
from repro.train import state_axes as jax_state_axes
from repro_torch.analysis.hlo import collective_bytes, count_ops
from repro_torch.analysis.roofline import build_roofline, model_flops_for
from repro_torch.configs import (ARCHS, SHAPES, get_config, input_specs,
                                 reduced_config, shape_applicable)
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.sharding import ShardingRules, active_rules, default_rules
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.train import AdamWConfig, init_state, state_axes

CELLS = [(a, s) for a in ARCHS for s in SHAPES]


def jax_dryrun():
    """The JAX package's `launch.dryrun`. Importing it sets XLA_FLAGS to
    512 forced host devices for its own process; the flag is taken back
    at once, so that this process's JAX keeps its devices."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module("repro.launch.dryrun")
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
JAX_DTYPES = {jnp.int32: torch.int32, jnp.bfloat16: torch.bfloat16}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


# ------------------------------------------------------ shapes and FLOPs

def test_shapes_match_jax():
    assert list(SHAPES) == list(JAX_SHAPES)
    for name, s in SHAPES.items():
        assert dataclasses.asdict(s) == dataclasses.asdict(JAX_SHAPES[name])


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_and_model_flops_match_jax(arch, shape):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    s, js = SHAPES[shape], JAX_SHAPES[shape]
    assert shape_applicable(cfg, s) == jax_shape_applicable(jcfg, js)
    got, ref = input_specs(cfg, s), jax_input_specs(jcfg, js)
    assert sorted(got) == sorted(ref)
    for k, v in ref.items():
        assert got[k].device.type == "meta"
        assert tuple(got[k].shape) == tuple(v.shape), k
        assert got[k].dtype == JAX_DTYPES[v.dtype.type], k
    assert model_flops_for(cfg, s) == jax_model_flops_for(jcfg, js)
    jdry = jax_dryrun()
    assert dryrun.microbatches_for(cfg, False) == \
        jdry.microbatches_for(jcfg, False)
    assert dryrun.int8_for(cfg) == jdry.int8_for(jcfg)


# ------------------------------------------------------------ state_axes

def _toy_params():
    return dict(w=torch.zeros((8, 4), dtype=torch.bfloat16),
                b=torch.zeros((4,), dtype=torch.bfloat16))


def _structure(tree):
    """A tree's shape with its leaves blanked; axes tuples are leaves."""
    if isinstance(tree, dict):
        return {k: _structure(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and not all(
            isinstance(e, (str, type(None))) for e in tree):
        return type(tree)(*map(_structure, tree)) if hasattr(
            tree, "_fields") else tuple(map(_structure, tree))
    return None


@pytest.mark.parametrize("int8", [False, True])
def test_state_axes_structure(int8):
    axes = dict(w=("embed", "ffn"), b=("ffn",))
    st = init_state(_toy_params(), AdamWConfig(int8_moments=int8))
    ax = state_axes(axes, int8)
    assert _structure(st) == _structure(ax)
    ref = jax_state_axes(axes, int8)
    assert tuple(ax) == tuple(ref)


# ------------------------------- tests/test_analysis_hlo.py's six cases

SYNC_HLO = """\\
HloModule m
ENTRY %main {
  %x = f32[128]{0} parameter(0)
  %ar = f32[128]{0} all-reduce(f32[128]{0} %x), replica_groups={}
  ROOT %a2a = s32[8,24]{1,0} all-to-all(s32[8,24]{1,0} %y), dimensions={0}
}
"""

ASYNC_HLO = """\\
HloModule m
ENTRY %main {
  %p = f32[4,8]{1,0} parameter(0)
  %ag-start = (f32[4,8]{1,0}, f32[32,8]{1,0}) all-gather-start(f32[4,8]{1,0} %p), dimensions={0}
  %ag-done = f32[32,8]{1,0} all-gather-done((f32[4,8]{1,0}, f32[32,8]{1,0}) %ag-start)
  %cp-start = (u32[2]{0}, u32[2]{0}) collective-permute-start(u32[2]{0} %q)
  %cp-done = u32[2]{0} collective-permute-done((u32[2]{0}, u32[2]{0}) %cp-start)
}
"""


def test_sync_collectives_and_root():
    b = collective_bytes(SYNC_HLO)
    assert b["all-reduce"] == 128 * 4
    assert b["all-to-all"] == 8 * 24 * 4


def test_async_pair_counted_once_result_half_only():
    b = collective_bytes(ASYNC_HLO)
    assert b["all-gather"] == 32 * 8 * 4
    assert b["collective-permute"] == 2 * 4


def test_done_detection_is_structural_not_substring():
    hlo = "  %x = f32[4]{0} all-reduce(f32[4]{0} %ag-done.1)\\n"
    assert collective_bytes(hlo) == {"all-reduce": 16}


def test_count_ops_skips_done_only():
    counts = count_ops(SYNC_HLO + ASYNC_HLO)
    assert counts == {"all-reduce": 1, "all-to-all": 1, "all-gather": 1,
                      "collective-permute": 1}


def test_tuple_shape_sum_without_async_suffix():
    hlo = ("  %t = (f32[2]{0}, s32[3]{0}) all-to-all(f32[2]{0} %a, "
           "s32[3]{0} %b)\\n")
    assert collective_bytes(hlo) == {"all-to-all": 2 * 4 + 3 * 4}


def test_roofline_smoke():
    cost = {"flops": 1.0e12, "bytes accessed": 2.0e9}
    mem = {"argument_size_in_bytes": 1 << 20, "temp_size_in_bytes": 1 << 18,
           "output_size_in_bytes": 1 << 16}
    r = build_roofline("h100", "tiny", "dp8", 8, cost, mem, SYNC_HLO,
                       model_flops=6.0e12)
    assert r.coll_breakdown["all-reduce"] == 512
    assert r.coll_bytes == 512 + 768
    assert r.coll_ops == {"all-reduce": 1, "all-to-all": 1}
    assert r.bottleneck in ("compute", "memory", "collective")
    assert r.step_time == max(r.t_compute, r.t_memory, r.t_collective) > 0
    assert 0 < r.mfu < 1
    json.dumps(r.to_dict())  # the dashboard artifact must serialize


# ------------------------------------- per-device argument bytes at scale

def _jax_mesh_argument_bytes(arch, shape_name, multi_pod):
    """The JAX package's spec arithmetic: each argument leaf's shard under
    its rules on a device-less production mesh."""
    cfg, shape = jax_get_config(arch), JAX_SHAPES[shape_name]
    sizes, names = (((2, 16, 16), ("pod", "data", "model")) if multi_pod
                    else ((16, 16), ("data", "model")))
    rules = JaxRules(AbstractMesh(sizes, names), jax_default_rules(multi_pod))
    model = jax_get_model(cfg)
    jdry = jax_dryrun()
    p_axes = jdry.param_axes_of(cfg, model)
    params = jax.eval_shape(lambda k: model.init_params(cfg, k)[0],
                            jax.random.PRNGKey(0))
    adam = JaxAdamWConfig(int8_moments=jdry.int8_for(cfg))
    opt = jax.eval_shape(lambda p: jax_init_state(p, adam), params)
    o_axes = jax_state_axes(p_axes, adam.int8_moments)
    is_axes = lambda x: isinstance(x, tuple) and all(  # noqa: E731
        isinstance(e, (str, type(None))) for e in x)

    def nbytes(sds, axes):
        spec = rules.spec(axes, tuple(sds.shape))
        local = [n if part is None else n // math.prod(
            rules.mesh.shape[a] for a in (part if isinstance(part, tuple)
                                          else (part,)))
            for n, part in zip(sds.shape, spec)]
        return math.prod(local) * sds.dtype.itemsize

    total = 0
    for tree, axes in ((params, p_axes), (opt, o_axes)):
        flat_axes = jax.tree_util.tree_leaves(axes, is_leaf=is_axes)
        flat = jax.tree_util.tree_leaves(tree)
        assert len(flat) == len(flat_axes)
        total += sum(nbytes(s, a) for s, a in zip(flat, flat_axes))
    for v in jax_input_specs(cfg, shape).values():
        total += nbytes(v, ("batch",) + (None,) * (len(v.shape) - 1))
    return total


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", ["qwen2-7b", "deepseek-v2-236b"])
def test_mesh_argument_bytes_match_jax(arch, multi_pod):
    got = dryrun.mesh_argument_bytes(get_config(arch), SHAPES["train_4k"],
                                     multi_pod)
    assert got == _jax_mesh_argument_bytes(arch, "train_4k", multi_pod)


# -------------------------------------- the fake run against a real step

FAMILY_CELLS = [("qwen2-7b", "train"), ("deepseek-v2-236b", "train"),
                ("internvl2-1b", "train"), ("mamba2-1.3b", "train"),
                ("recurrentgemma-9b", "train"), ("whisper-tiny", "train"),
                ("dbrx-132b", "prefill"), ("recurrentgemma-9b", "decode")]


def _small_shape(kind):
    return {"train": ShapeConfig("t", 32, 4, "train"),
            "prefill": ShapeConfig("p", 32, 2, "prefill"),
            "decode": ShapeConfig("d", 48, 2, "decode")}[kind]


@pytest.mark.parametrize("arch,kind", FAMILY_CELLS)
def test_fake_run_counts_equal_real_step(arch, kind):
    cfg, shape = reduced_config(arch), _small_shape(kind)
    nm = 2 if kind == "train" else None
    fake = dryrun.trace_cell(cfg, shape, device="cpu", q_chunk=16,
                             microbatches=nm)
    cell = dryrun.build_cell(cfg, shape, "cpu", q_chunk=16,
                             microbatches=nm, seed=0)
    args = dryrun.argument_bytes(cell)
    assert args == fake["argument_bytes"]
    rules = ShardingRules(make_local_mesh("cpu"), default_rules(False))
    live = dryrun.LiveBytes(baseline=args)
    with active_rules(rules), live, FlopCounterMode(display=False) as fc:
        cell["run"]()
    assert fake["flops"] == fc.get_total_flops() > 0
    assert fake["peak_bytes"] == live.peak > args
    assert fake["bytes_accessed"] == live.accessed


# ------------------------------------------ the rank trace of a process mesh

def test_cell_record_carries_a_rank_trace_where_the_cell_runs_sharded():
    """A production-mesh record takes rank 0's temporaries and collective
    bytes from the rank trace for a train cell, of a GQA transformer and
    of Mamba-2 alike (every family keeps blocks), and for a serving cell
    of the GQA transformer (its prefill and decode run on blocks), and
    leaves them null with `NO_RANK_TRACE` for Mamba-2's serving cell (no
    rank trace is run); `trace_rank` refuses that cell; a rank's
    microbatches are cut to whole rows a data rank (16 of 256 rows over
    32 data ranks: 8)."""
    fake = dict(argument_bytes=10, peak_bytes=30, flops=1.0,
                bytes_accessed=2.0, leaves=[], trace_s=0.0, microbatches=1,
                int8_moments=False)
    ranked = dict(rank=0, argument_bytes=3, peak_bytes=7, temp_bytes=4,
                  coll_bytes=5, flops=1.0, coll_by_kind={"all_gather": 5},
                  coll_calls={"all_gather": 1}, microbatches=1, trace_s=0.0)
    calls = []

    def rank_trace():
        calls.append(1)
        return ranked

    for arch, shape, runs in (("qwen2-7b", "train_4k", True),
                              ("qwen2-7b", "prefill_32k", True),
                              ("mamba2-1.3b", "train_4k", True),
                              ("mamba2-1.3b", "prefill_32k", False)):
        rec = dryrun.cell_record(arch, shape, "pod16x16", lambda: fake,
                                 rank_trace)
        pd = rec["per_device"]
        assert rec["status"] == "ok", rec
        if runs:
            assert (pd["temp_bytes"], pd["coll_bytes"], pd["reason"]) == (
                4, 5, None)
            assert pd["rank"]["coll_by_kind"] == {"all_gather": 5}
        else:
            assert pd["temp_bytes"] is None and pd["coll_bytes"] is None
            assert pd["reason"] == dryrun.NO_RANK_TRACE
    assert len(calls) == 3
    with pytest.raises(ValueError, match="no rank trace.*4h"):
        dryrun.trace_rank(reduced_config("mamba2-1.3b"),
                          SHAPES["prefill_32k"], {"data": 2, "model": 2},
                          device="cpu")
    nemotron = get_config("nemotron-4-340b")
    assert dryrun.rank_microbatches(nemotron, SHAPES["train_4k"], 16) == 16
    assert dryrun.rank_microbatches(nemotron, SHAPES["train_4k"], 32) == 8


def test_rank_only_cli_traces_the_serving_cells_of_a_reduced_config(
        tmp_path, monkeypatch):
    """`--rank-only` writes rank 0's trace alone (no single-device trace)
    for reduced Qwen2-7B's prefill and decode cells and reduced
    DeepSeek-V2's decode cell (the configs and the shapes cut small, the
    meshes the production 16x16 and 2x16x16): temporaries and collective
    bytes in each record, the decode's cache block over the data axes
    and `model`, and Mamba-2's decode cell with `NO_RANK_TRACE`."""
    small = {"prefill_32k": ShapeConfig("prefill_32k", 64, 64, "prefill"),
             "decode_32k": ShapeConfig("decode_32k", 64, 64, "decode")}
    monkeypatch.setattr(dryrun, "get_config", reduced_config)
    monkeypatch.setattr(dryrun, "SHAPES", small)
    cells = (("qwen2-7b", "prefill_32k"), ("qwen2-7b", "decode_32k"),
             ("deepseek-v2-236b", "decode_32k"), ("mamba2-1.3b",
                                                  "decode_32k"))
    for arch, shape in cells:
        dryrun.main(["--arch", arch, "--shape", shape, "--rank-only",
                     "--device", "cpu", "--results-dir", str(tmp_path)])
    for arch, shape in cells:
        for mesh in ("pod16x16", "pod2x16x16"):
            with open(tmp_path / f"{arch}__{shape}__{mesh}__rank.json") as f:
                rec = json.load(f)
            pd = rec["per_device"]
            assert rec["status"] == "ok" and rec["method"] == "rank_only"
            assert "memory" not in rec and pd["argument_bytes"] > 0
            if arch == "mamba2-1.3b":
                assert pd["reason"] == dryrun.NO_RANK_TRACE
                assert pd["temp_bytes"] is None
                continue
            assert pd["reason"] is None and pd["temp_bytes"] > 0
            kinds = pd["rank"]["coll_by_kind"]
            # the FSDP gathers of the weights and the gathered logits
            assert kinds["all_gather"] > 0, kinds
            if shape == "decode_32k":
                # the softmax's max and its (sum, output) over `model`
                assert pd["rank"]["coll_calls"]["all_reduce"] >= 2
