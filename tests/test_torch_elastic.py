"""The port's elastic runtime against the JAX package's: snapshots resumed
at another shard count, the schema-driven re-layout, and the supervisor's
resize path. The JAX package's `tests/test_elastic.py` (17 tests) ported
test for test, plus what is left of `tests/test_fault_tolerance_improved.py`.

Parity levels (ROADMAP "Parity levels"):
  * the re-layout units (vertex, walk with its aux lane, the walk cap that
    grows under skew, the slot bijection, `derive_shard_keys`) and the
    staged snapshot's re-layout — bit-exact against the JAX function on the
    same numpy inputs; the schema errors raise the same types and texts;
  * the supervisor and `run_staged` on toy state — the same hook calls,
    restored states, manifests and errors in both packages, and a snapshot
    one package wrote resumed by the other at another shard count;
  * the engines, killed at 8 shards and resumed at P' (one JAX subprocess
    on 8 forced host devices writes the kill directories; the port resumes
    pristine copies of them, and also kills its own runs at 8 stacked
    shards, whose snapshots equal JAX's file for file):
      counts at P' in {1, 2, 4, 16} — zeta, pi and rounds bit-exact with
      JAX's unfailed run (its trajectory does not depend on P);
      improved killed mid-Phase 2 at P' in {4, 2} — bit-exact with JAX's
      unfailed run (Phase 2 draws nothing, and the tail is empty);
      directed killed in keyed Phase 1 at P' in {4, 2} — bit-exact with
      JAX's own resume at the same P' (the re-derived shard keys are
      equal), and the reference's statistical gate;
  * the PPR service shrunk 4 -> 2 under two queries in flight — every
    result vector, counter and the cache hit bit-exact with JAX's service;
  * the directed engine recovering from failures at the Phase 1 -> report
    boundary and mid-Phase 2 — bit-exact with JAX, telemetry included.
"""
import os
import shutil

import numpy as np
import pytest
import torch

import repro.checkpoint as jck
import repro.runtime as jrt
from repro.checkpoint.elastic import _slot_index as j_slot_index

import repro_torch.checkpoint as tck
import repro_torch.runtime as trt
from conftest import run_forced_devices
from repro_torch import prng
from repro_torch.checkpoint.elastic import _slot_index as t_slot_index
from repro_torch.core import l1_error, normalized, topk_overlap
from repro_torch.core.collectives import StackedMesh
from repro_torch.core.distributed_counts import distributed_pagerank_counts
from repro_torch.core.distributed_directed import \
    distributed_directed_pagerank
from repro_torch.core.distributed_improved import \
    distributed_improved_pagerank
from repro_torch.core.personalized import exact_ppr
from repro_torch.graphs import directed_web, erdos_renyi
from repro_torch.serve import PPRService

PKGS = dict(jax=(jck, jrt), torch=(tck, trt))
EPS = 0.25
FIELDS = ("rounds", "phase1_rounds", "report_rounds", "phase2_rounds",
          "phase3_rounds", "tail_rounds", "stitch_iterations",
          "exhausted_walks", "terminated_by_coupon", "tail_walks",
          "coupons_created", "coupons_used", "dropped", "waited",
          "a2a_bytes_total", "a2a_bytes_by_phase", "a2a_entries_by_site",
          "phase2_records", "total_visits", "residual")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small tensor ops: under parallel test workers torch's thread
    pool oversubscribes the cores; one thread keeps serial speed."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


# ---------------------------------------------------------------------------
# the schema-driven re-layout, against the JAX functions
# ---------------------------------------------------------------------------

def _shard_vertex(base: np.ndarray, n: int, shards: int) -> np.ndarray:
    n_loc = -(-n // shards)
    out = np.zeros((n_loc * shards,) + base.shape[1:], dtype=base.dtype)
    out[:n] = base
    return out.reshape((shards, n_loc) + base.shape[1:])


def _relayout(arrays, specs, old, new):
    """Both packages' `relayout_arrays` on the same inputs (the port reads
    the old shard count off the buffers); asserts they agree, returns the
    port's."""
    want = jck.relayout_arrays(arrays, {k: jck.LayoutSpec(**v.__dict__)
                                        for k, v in specs.items()},
                               old, new)
    got = tck.relayout_arrays(arrays, specs, new)
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))
        assert got[k].dtype == np.asarray(want[k]).dtype
    return got


@pytest.mark.parametrize("p_mid", [1, 3, 16])
def test_vertex_roundtrip_bit_exact(p_mid):
    """vertex buffers re-split along the contiguous partition, equal to
    JAX's, and round-trip 8 -> P' -> 8 bit-exactly with a feature axis."""
    n = 37
    rng = np.random.default_rng(0)
    base = rng.integers(0, 1000, size=(n, 2)).astype(np.int32)
    spec = dict(z=tck.LayoutSpec(kind="vertex", n=n))
    a8 = _shard_vertex(base, n, 8)
    mid = _relayout(dict(z=a8), spec, 8, p_mid)["z"]
    np.testing.assert_array_equal(mid, _shard_vertex(base, n, p_mid))
    back = _relayout(dict(z=mid), spec, p_mid, 8)["z"]
    np.testing.assert_array_equal(back, a8)


def _walk_multiset(pos, qid=None):
    live = pos.reshape(-1) >= 0
    v = pos.reshape(-1)[live].tolist()
    if qid is None:
        return sorted(v)
    return sorted(zip(v, qid.reshape(-1)[live].tolist()))


@pytest.mark.parametrize("p_mid", [1, 3, 16])
def test_walk_roundtrip_canonical_with_aux(p_mid):
    """Walk lanes and their aux lane: JAX's canonical packing bit for bit;
    the multiset is kept, re-laying out a canonical layout is the
    identity, and the round trip lands on the canonical 8-shard packing."""
    n, cap, P = 50, 24, 8
    rng = np.random.default_rng(1)
    pos = np.full((P, cap), -1, np.int32)
    qid = np.zeros((P, cap), np.int32)
    for _ in range(70):
        p, s = rng.integers(P), rng.integers(cap)
        pos[p, s] = rng.integers(n)
        qid[p, s] = rng.integers(4)
    specs = dict(pos=tck.LayoutSpec(kind="walk", n=n, cap=cap, fill=-1,
                                    aux=("qid",)),
                 qid=tck.LayoutSpec(kind="walk_aux", fill=0))
    mid = _relayout(dict(pos=pos, qid=qid), specs, P, p_mid)
    assert _walk_multiset(mid["pos"], mid["qid"]) == \
        _walk_multiset(pos, qid)
    again = _relayout(mid, specs, p_mid, p_mid)
    np.testing.assert_array_equal(again["pos"], mid["pos"])
    np.testing.assert_array_equal(again["qid"], mid["qid"])
    back = _relayout(mid, specs, p_mid, P)
    canon = _relayout(dict(pos=pos, qid=qid), specs, P, P)
    np.testing.assert_array_equal(back["pos"], canon["pos"])
    np.testing.assert_array_equal(back["qid"], canon["qid"])


def test_walk_cap_autogrows_under_skew():
    """Every walk on one vertex: the declared cap of 4 cannot hold shard
    0's bucket, so both packages grow it, to the same layout and keys."""
    n = 64
    host = dict(
        pos=np.zeros((2, 32), np.int32),
        zeta=np.zeros((2, 32), np.int32),
        key=np.arange(4, dtype=np.uint32).reshape(2, 2),
        round=np.int32(3), dropped=np.int32(0), waited=np.int32(0))
    out = tck.relayout_pagerank_state(host, n, 8, cap=4)
    want = jck.relayout_pagerank_state(host, n, 8, cap=4)
    assert sorted(out) == sorted(want)
    for k in out:
        np.testing.assert_array_equal(out[k], np.asarray(want[k]))
    assert out["pos"].shape[0] == 8
    assert out["pos"].shape[1] >= 64
    assert _walk_multiset(out["pos"]) == [0] * 64
    assert out["zeta"].shape == (8, 8)
    assert out["key"].shape == (8, 2)


def test_slot_bijection_matches_fresh_pool_layout():
    """A coupon-slot buffer re-homed 8 -> 3 equals the layout a fresh
    3-shard engine builds (and JAX's re-layout), and round-trips; a buffer
    that does not fit its pool layout raises in both packages."""
    n = 29
    rng = np.random.default_rng(2)
    pool = rng.integers(0, 5, size=n).astype(np.int64)
    total = int(pool.sum())
    for shards in (1, 3, 8, 16):
        t_idx, t_S = t_slot_index(pool, n, shards)
        j_idx, j_S = j_slot_index(pool, n, shards)
        assert t_S == j_S
        np.testing.assert_array_equal(t_idx, j_idx)

    def build(shards):
        idx, S = t_slot_index(pool, n, shards)
        buf = np.full(shards * S, -1, np.int64)
        buf[idx] = np.arange(total)
        return buf.reshape(shards, S)

    spec = dict(b=tck.LayoutSpec(kind="slot", n=n, pool=pool, fill=-1))
    b8 = build(8)
    got3 = _relayout(dict(b=b8), spec, 8, 3)["b"]
    np.testing.assert_array_equal(got3, build(3))
    back = _relayout(dict(b=got3), spec, 3, 8)["b"]
    np.testing.assert_array_equal(back, b8)
    # JAX takes the old shard count as an argument, the port reads it off
    # the buffer: a claim of 4 for 8 rows only JAX can be given
    j_spec = dict(b=jck.LayoutSpec(kind="slot", n=n, pool=pool, fill=-1))
    with pytest.raises(ValueError, match="does not match"):
        jck.relayout_arrays(dict(b=b8), j_spec, 4, 3)
    # four rows of the 8-shard layout fit no 4-shard pool layout
    with pytest.raises(ValueError, match="does not match"):
        jck.relayout_arrays(dict(b=b8[:4]), j_spec, 4, 3)
    with pytest.raises(ValueError, match="does not match"):
        tck.relayout_arrays(dict(b=b8[:4]), spec, 3)


def test_derive_shard_keys_separates_permuted_layouts():
    """Row-permuted old key arrays derive different new streams, the same
    ones in both packages, deterministically, distinct per shard."""
    a = np.arange(16, dtype=np.uint32).reshape(8, 2)
    b = a[::-1].copy()
    assert np.array_equal(np.bitwise_xor.reduce(a.reshape(-1)),
                          np.bitwise_xor.reduce(b.reshape(-1)))
    ka, kb = tck.derive_shard_keys(a, 4), tck.derive_shard_keys(b, 4)
    np.testing.assert_array_equal(ka, np.asarray(jck.derive_shard_keys(a, 4)))
    np.testing.assert_array_equal(kb, np.asarray(jck.derive_shard_keys(b, 4)))
    assert ka.shape == (4, 2) and ka.dtype == np.uint32
    assert not np.array_equal(ka, kb)
    np.testing.assert_array_equal(ka, tck.derive_shard_keys(a, 4))
    assert len({tuple(row) for row in ka.tolist()}) == 4


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_relayout_schema_errors(pkg):
    """The same exception types and texts in both packages."""
    ck, _ = PKGS[pkg]
    old = (2,) if pkg == "jax" else ()
    arr = np.zeros((2, 4), np.int32)
    with pytest.raises(ValueError, match="no layout schema"):
        ck.relayout_arrays(dict(x=arr), {}, *old, 4)
    with pytest.raises(ValueError, match="unknown layout kind"):
        ck.relayout_arrays(dict(x=arr), dict(x=ck.LayoutSpec(kind="bogus")),
                           *old, 4)
    flat = dict(stage=ck.pack_json("phase9"), host=ck.pack_json({}))
    with pytest.raises(ValueError, match="no layout schema declared"):
        ck.relayout_staged_flat(flat, *old, 4, dict(phase1={}))


def test_relayout_staged_flat_uses_stage_schema():
    """The stage tag selects the spec map; non-array leaves pass through;
    the result equals JAX's leaf for leaf."""
    n = 6
    base = np.arange(n, dtype=np.int32)
    flat = {"stage": tck.pack_json("count"),
            "host": tck.pack_json(dict(rounds=7)),
            "arrays/z": _shard_vertex(base, n, 8)}
    out = tck.relayout_staged_flat(
        flat, 2, dict(count=dict(z=tck.LayoutSpec(kind="vertex", n=n))))
    want = jck.relayout_staged_flat(
        flat, 8, 2, dict(count=dict(z=jck.LayoutSpec(kind="vertex", n=n))))
    assert sorted(out) == sorted(want)
    for k in out:
        np.testing.assert_array_equal(out[k], np.asarray(want[k]))
    np.testing.assert_array_equal(out["stage"], flat["stage"])
    np.testing.assert_array_equal(out["host"], flat["host"])
    np.testing.assert_array_equal(out["arrays/z"], _shard_vertex(base, n, 2))


# ---------------------------------------------------------------------------
# the supervisor's resize path on toy host state, in both packages
# ---------------------------------------------------------------------------

def _toy_supervisor(pkg, d, meta_shards, relayout=None):
    ck, rt = PKGS[pkg]

    def step(s):
        s = dict(s, count=int(s["count"]) + 1)
        return s, s["count"] >= 6

    return rt.Supervisor(
        step,
        lambda s: dict(x=np.asarray(s["x"]), count=np.asarray(s["count"])),
        lambda f: dict(x=np.asarray(f["x"]),
                       count=int(np.asarray(f["count"]))),
        ck.Checkpointer(str(d)), checkpoint_every=100,
        meta_fn=lambda: dict(shards=meta_shards), relayout=relayout)


def _toy_snapshot(tmp_path, x):
    """One snapshot at step 3, 8 shards, written by the JAX Checkpointer,
    copied once for each package."""
    src = tmp_path / "src"
    jck.Checkpointer(str(src)).save(3, dict(x=x, count=np.asarray(3)),
                                    metadata=dict(shards=8))
    for pkg in PKGS:
        shutil.copytree(src, tmp_path / pkg)
    return {pkg: tmp_path / pkg for pkg in PKGS}


def test_supervisor_shard_mismatch_without_hook_raises(tmp_path):
    dirs = _toy_snapshot(tmp_path, np.ones(8))
    for pkg, d in dirs.items():
        with pytest.raises(ValueError, match="no relayout hook"):
            _toy_supervisor(pkg, d, meta_shards=4).run(None, resume=True)


def test_supervisor_routes_resume_through_relayout_and_reanchors(tmp_path):
    """Manifest shards != live shards: the hook is called once with the old
    count, the state continues from it, the new layout is re-anchored at
    the resumed step, and the done-save leaves the final step; the same
    in both packages, down to the snapshots left on disk."""
    dirs = _toy_snapshot(tmp_path, np.arange(8, dtype=np.int64))
    got = {}
    for pkg, d in dirs.items():
        seen = []

        def relayout(flat, old_shards):
            seen.append(old_shards)
            return dict(flat, x=np.asarray(flat["x"]).reshape(4, 2).sum(1))

        res = _toy_supervisor(pkg, d, meta_shards=4,
                              relayout=relayout).run(None, resume=True)
        assert seen == [8]
        assert res.restarts == 0 and res.state["count"] == 6
        np.testing.assert_array_equal(res.state["x"], [1, 5, 9, 13])
        ck = PKGS[pkg][0].Checkpointer(str(d))
        flat, manifest = ck.restore()
        assert manifest["metadata"] == dict(shards=4)
        assert manifest["step"] == 6
        anchor, m3 = ck.restore(step=3)
        assert m3["metadata"] == dict(shards=4)
        np.testing.assert_array_equal(anchor["x"], [1, 5, 9, 13])
        got[pkg] = (ck.all_steps(), res.checkpoints_written,
                    {k: v.tolist() for k, v in flat.items()})
    assert got["torch"] == got["jax"]


def test_supervisor_matching_shards_skips_relayout(tmp_path):
    dirs = _toy_snapshot(tmp_path, np.ones(8))

    def boom(flat, old):
        raise AssertionError("relayout called despite matching shards")

    for pkg, d in dirs.items():
        res = _toy_supervisor(pkg, d, meta_shards=8, relayout=boom).run(
            None, resume=True)
        assert res.state["count"] == 6 and res.checkpoints_written == 1


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_final_snapshot_written_on_done(tmp_path, pkg):
    """A run that ends between periodic checkpoints leaves its final state
    on disk: the round-0 anchor and the done-save, in both packages."""
    ck, rt = PKGS[pkg]

    def step(ms):
        ms.host["count"] += 1
        return ms, ms.host["count"] >= 5

    sched = rt.StageSchedule([rt.Stage("s", step)])
    ms = rt.StagedState(stage="s", arrays={}, host=dict(count=0))
    out, restarts, ckpts = rt.run_staged(
        sched, ms, lambda n, a: a, checkpoint_dir=str(tmp_path),
        checkpoint_every=100)
    assert (restarts, ckpts) == (0, 2)
    flat, manifest = ck.Checkpointer(str(tmp_path)).restore()
    assert manifest["step"] == 5
    assert rt.staged_from_host(flat, lambda n, a: a).host == dict(count=5)


def _toy_staged(pkg, x, shards, n):
    ck, rt = PKGS[pkg]

    def step(ms):
        ms.host["count"] += 1
        return ms, ms.host["count"] >= 4

    layouts = dict(s=dict(x=ck.LayoutSpec(kind="vertex", n=n)))
    state = rt.StagedState(stage="s", arrays=dict(x=x), host=dict(count=0),
                           layouts=layouts, shards=shards)
    return rt.StageSchedule([rt.Stage("s", step)]), state


@pytest.mark.parametrize("killer,resumer", [("jax", "jax"),
                                            ("torch", "torch"),
                                            ("jax", "torch"),
                                            ("torch", "jax")])
def test_run_staged_elastic_resume_jax_free(tmp_path, killer, resumer):
    """Through run_staged on toy state: killed at 8 shards by one package,
    resumed at 4 by either: the snapshot re-lays out through the declared
    schema and the manifest re-anchors to the live shard count."""
    n = 6
    base = np.arange(n, dtype=np.int32)
    d = str(tmp_path)
    sched, st8 = _toy_staged(killer, _shard_vertex(base, n, 8), 8, n)
    rt = PKGS[killer][1]
    with pytest.raises(rt.SimulatedFailure):
        rt.run_staged(sched, st8, lambda name, a: a, checkpoint_dir=d,
                      fail_at=[2], checkpoint_every=2, max_restarts=0)
    sched, st4 = _toy_staged(resumer, _shard_vertex(base, n, 4), 4, n)
    rt = PKGS[resumer][1]
    out, restarts, _ = rt.run_staged(sched, st4, lambda name, a: a,
                                     checkpoint_dir=d, resume=True,
                                     checkpoint_every=100)
    assert restarts == 0 and out.host["count"] == 4
    np.testing.assert_array_equal(out.arrays["x"], _shard_vertex(base, n, 4))
    for ck, _ in PKGS.values():
        assert ck.Checkpointer(d).restore()[1]["metadata"] == dict(shards=4)


# ---------------------------------------------------------------------------
# tests/test_fault_tolerance_improved.py's units, in both packages
# ---------------------------------------------------------------------------

def test_stage_schedule_orders_stages_and_runs_transitions():
    logs = {}
    for pkg, (_, rt) in PKGS.items():
        log = logs[pkg] = []

        def stepper(tag, steps):
            def step(ms):
                ms.host[tag] = ms.host.get(tag, 0) + 1
                log.append(tag)
                return ms, ms.host[tag] >= steps
            return step

        def transition(ms):
            log.append("switch")
            return ms

        sched = rt.StageSchedule([
            rt.Stage("a", stepper("a", 2), on_done=transition),
            rt.Stage("b", stepper("b", 1))])
        ms = rt.StagedState(stage=sched.first_stage, arrays={}, host={})
        done, rounds = False, 0
        while not done:
            ms, done = sched.step(ms)
            rounds += 1
        assert rounds == 3 and ms.host == dict(a=2, b=1)
        with pytest.raises(ValueError, match="duplicate stage names"):
            rt.StageSchedule([rt.Stage("x", stepper("x", 1)),
                              rt.Stage("x", stepper("x", 1))])
    assert logs["torch"] == logs["jax"] == ["a", "a", "switch", "b"]


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_stage_schema_out_of_sync_raises(pkg):
    """A stage whose buffers and declared layout schema differ is refused
    before it steps, in both packages: a snapshot of it could not be
    re-laid out."""
    ck, rt = PKGS[pkg]
    sched = rt.StageSchedule([rt.Stage("s", lambda ms: (ms, True))])
    ms = rt.StagedState(stage="s", arrays=dict(x=np.zeros(4), y=np.zeros(4)),
                        host={}, shards=2,
                        layouts=dict(s=dict(x=ck.LayoutSpec(kind="vertex",
                                                            n=4),
                                            z=ck.LayoutSpec(kind="vertex",
                                                            n=4))))
    with pytest.raises(ValueError, match=r"layout schema out of sync .*"
                       r"uncovered buffers \['y'\], dangling specs \['z'\]"):
        sched.step(ms)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_fresh_run_refuses_stale_snapshots(tmp_path, writer):
    """A fresh run into a directory holding another run's snapshot (written
    by either package) refuses to start in both packages; after
    `Checkpointer.clear()` it runs its own trajectory."""
    ck_w, rt_w = PKGS[writer]
    stale = rt_w.StagedState(stage="s", arrays={}, host=dict(count=999))
    for pkg, (ck, rt) in PKGS.items():
        d = str(tmp_path / pkg)
        ck_w.Checkpointer(d).save(50, rt_w.staged_to_host(stale))

        def step(ms):
            ms.host["count"] += 1
            return ms, ms.host["count"] >= 5

        sched = rt.StageSchedule([rt.Stage("s", step)])

        def fresh():
            return rt.StagedState(stage=sched.first_stage, arrays={},
                                  host=dict(count=0))

        with pytest.raises(FileExistsError, match="already holds snapshots"):
            rt.run_staged(sched, fresh(), lambda n, a: a, checkpoint_dir=d,
                          fail_at=[2], checkpoint_every=10)
        ck.Checkpointer(d).clear()
        assert ck.Checkpointer(d).latest_step() is None
        out, restarts, _ = rt.run_staged(sched, fresh(), lambda n, a: a,
                                         checkpoint_dir=d, fail_at=[2],
                                         checkpoint_every=10)
        assert restarts == 1 and out.host["count"] == 5


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_resume_without_checkpoint_dir_raises(pkg):
    rt = PKGS[pkg][1]
    sched = rt.StageSchedule([rt.Stage("s", lambda ms: (ms, True))])
    ms = rt.StagedState(stage="s", arrays={}, host={})
    with pytest.raises(ValueError, match="needs checkpoint_dir"):
        rt.run_staged(sched, ms, lambda n, a: a, resume=True)


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_resume_from_empty_dir_raises(tmp_path, pkg):
    """A mistyped checkpoint directory must not recompute from round 0."""
    rt = PKGS[pkg][1]
    sched = rt.StageSchedule([rt.Stage("s", lambda ms: (ms, True))])
    ms = rt.StagedState(stage="s", arrays={}, host={})
    with pytest.raises(FileNotFoundError, match="no snapshots"):
        rt.run_staged(sched, ms, lambda n, a: a, resume=True,
                      checkpoint_dir=str(tmp_path / "typo"))


@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax"),
                                           ("torch", "torch")])
def test_staged_snapshot_roundtrip(tmp_path, writer, reader):
    """A staged state written by one package reads back in the other: the
    stage, the host accumulators and every buffer, with the same flat keys
    and manifest."""
    ck_w, rt_w = PKGS[writer]
    ck_r, rt_r = PKGS[reader]
    ms = rt_w.StagedState(stage="phase2",
                          arrays=dict(pos=np.arange(6, dtype=np.int32),
                                      used=np.ones((2, 3), np.int32)),
                          host=dict(rounds=7, wire=dict(phase1=40),
                                    traces=[[3, 2], [0, 1]]))
    ck_w.Checkpointer(str(tmp_path / "w")).save(7, rt_w.staged_to_host(ms))
    jck.Checkpointer(str(tmp_path / "j")).save(
        7, jrt.staged_to_host(jrt.StagedState(**{
            k: getattr(ms, k) for k in ("stage", "arrays", "host")})))
    flat, manifest = ck_r.Checkpointer(str(tmp_path / "w")).restore()
    back = rt_r.staged_from_host(flat, lambda name, arr: arr)
    assert manifest["step"] == 7
    assert manifest["keys"] == jck.Checkpointer(
        str(tmp_path / "j")).restore()[1]["keys"]
    assert back.stage == "phase2" and back.host == ms.host
    assert sorted(back.arrays) == ["pos", "used"]
    for k in ("pos", "used"):
        np.testing.assert_array_equal(back.arrays[k], ms.arrays[k])
        assert np.asarray(back.arrays[k]).dtype == ms.arrays[k].dtype


# ---------------------------------------------------------------------------
# the engines, killed at 8 shards and resumed at another shard count
# ---------------------------------------------------------------------------

JAX_CODE = """
import json, os, shutil, sys
from concurrent.futures import ThreadPoolExecutor
import jax, numpy as np
from jax.sharding import Mesh
from repro.core.distributed import AXIS
from repro.core.distributed_counts import distributed_pagerank_counts
from repro.core.distributed_directed import distributed_directed_pagerank
from repro.core.distributed_improved import distributed_improved_pagerank
from repro.graphs import directed_web, erdos_renyi
from repro.runtime import SimulatedFailure
from repro.serve.ppr_service import PPRService

BASE, FIELDS, EPS = %r, %r, %r
devs = jax.devices()

def submesh(p):
    return Mesh(np.array(devs[:p]), (AXIS,))

def zeta_of(r, n):
    return np.asarray(r.zeta).reshape(-1)[:n].tolist()

def summary(r, n):
    out = {f: getattr(r, f) for f in FIELDS}
    out.update(zeta=zeta_of(r, n), pi=np.asarray(r.pi).tolist(),
               shards=r.shards, restarts=r.restarts)
    return out

def kill(engine, g, K, key, d, fail_at, **kw):
    try:
        engine(g, EPS, K, key, checkpoint_dir=d, fail_at=fail_at,
               checkpoint_every=2, max_restarts=0, **kw)
    except SimulatedFailure:
        return True
    return False

def resume(engine, g, K, key, d, p, **kw):
    dp = f"{d}_jax{p}"          # the kill directory itself stays pristine
    shutil.copytree(d, dp)
    return engine(g, EPS, K, key, mesh=submesh(p), checkpoint_dir=dp,
                  resume=True, checkpoint_every=2, **kw)

def counts():
    g = erdos_renyi(64, 5.0, seed=1)
    key = jax.random.PRNGKey(2)
    ref = distributed_pagerank_counts(g, EPS, 40, key)
    d = os.path.join(BASE, "counts")
    out = dict(died=kill(distributed_pagerank_counts, g, 40, key, d, [3]),
               zeta=zeta_of(ref, g.n), pi=np.asarray(ref.pi).tolist(),
               rounds=ref.rounds, targets={})
    for p in (1, 2, 4):
        r = resume(distributed_pagerank_counts, g, 40, key, d, p)
        out["targets"][p] = dict(zeta=zeta_of(r, g.n), rounds=r.rounds,
                                 shards=r.shards, restarts=r.restarts)
    return "counts", out

def improved():
    # eta_safety=8.0 leaves the tail empty, so the run past Phase 1 draws
    # nothing: a mid-Phase-2 kill resumes bit-exactly at any shard count
    g = erdos_renyi(96, 5.0, seed=1)
    key = jax.random.PRNGKey(0)
    ref = distributed_improved_pagerank(g, EPS, 40, key, eta_safety=8.0)
    mid_p2 = (ref.phase1_rounds + ref.report_rounds
              + max(ref.phase2_rounds // 2, 1))
    d = os.path.join(BASE, "improved")
    out = dict(died=kill(distributed_improved_pagerank, g, 40, key, d,
                         [mid_p2], eta_safety=8.0),
               fail_at=mid_p2, ref=summary(ref, g.n), targets={})
    for p in (4, 2):
        out["targets"][p] = summary(resume(
            distributed_improved_pagerank, g, 40, key, d, p,
            eta_safety=8.0), g.n)
    return "improved", out

def directed():
    # killed in keyed Phase 1: the resume re-derives the shard keys
    g = directed_web(64, 5.0, seed=3)
    key = jax.random.PRNGKey(3)
    d = os.path.join(BASE, "directed")
    out = dict(died=kill(distributed_directed_pagerank, g, 20, key, d, [1]),
               targets={})
    for p in (4, 2):
        out["targets"][p] = summary(resume(
            distributed_directed_pagerank, g, 20, key, d, p), g.n)
    return "directed", out

def directed_recovery():
    # tests/test_fault_tolerance_improved.py's kills: the Phase 1 ->
    # report boundary and mid-Phase 2
    g = directed_web(64, 5.0, seed=3)
    key = jax.random.PRNGKey(1)
    ref = distributed_directed_pagerank(g, EPS, 20, key)
    boundary = ref.phase1_rounds
    mid_p2 = (ref.phase1_rounds + ref.report_rounds
              + max(ref.phase2_rounds // 2, 1))
    rec = distributed_directed_pagerank(
        g, EPS, 20, key, checkpoint_dir=os.path.join(BASE, "recovery"),
        fail_at=[boundary, mid_p2], checkpoint_every=3)
    return "directed_recovery", dict(
        fail_at=[boundary, mid_p2], ckpts=rec.checkpoints_written,
        ref=summary(ref, g.n), rec=summary(rec, g.n))

def serve():
    g = erdos_renyi(96, 5.0, seed=1)
    svc = PPRService(g, EPS, slots=2, walks_per_query=4096,
                     mesh=submesh(4))
    r1 = svc.submit([3], now=0.0)
    r2 = svc.submit([10, 17], now=0.0)
    for _ in range(2):
        svc.step(now=0.0)
    svc.resize(mesh=submesh(2))
    r3 = svc.submit([5], now=0.0)
    svc.drain(now=0.0)
    hit = svc.submit([3], now=0.0)
    st = svc.stats
    return "serve", dict(
        results=[np.asarray(r.result).tolist() for r in (r1, r2, r3)],
        done=[r.done for r in (r1, r2, r3)], dropped=st.dropped_walks,
        admit_dropped=st.admit_dropped, completed=st.completed,
        supersteps=st.supersteps, cache_hits=st.cache_hits,
        cache_hit=bool(hit.cached),
        cache_bitexact=bool(np.array_equal(hit.result, r1.result)))

# independent cases: compile them on a few threads (XLA compiles with the
# GIL released)
with ThreadPoolExecutor(4) as pool:
    futs = [pool.submit(f) for f in (counts, improved, directed,
                                     directed_recovery, serve)]
    out = dict(f.result() for f in futs)
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_base(tmp_path_factory):
    return str(tmp_path_factory.mktemp("elastic_jax"))


@pytest.fixture(scope="module")
def jax_runs(jax_base):
    """One JAX subprocess on 8 forced host devices: the kill directories
    under `jax_base`, JAX's unfailed runs and its own resumes."""
    out = run_forced_devices(JAX_CODE % (jax_base, FIELDS, EPS), devices=8,
                             timeout=900)
    for case in ("counts", "improved", "directed"):
        assert out[case]["died"], case
    return out


GRAPHS = dict(
    counts=lambda: erdos_renyi(64, 5.0, seed=1, device="cpu"),
    improved=lambda: erdos_renyi(96, 5.0, seed=1, device="cpu"),
    directed=lambda: directed_web(64, 5.0, seed=3, device="cpu"))
RUNS = dict(   # engine, K, key seed, keyword arguments
    counts=(distributed_pagerank_counts, 40, 2, {}),
    improved=(distributed_improved_pagerank, 40, 0, dict(eta_safety=8.0)),
    directed=(distributed_directed_pagerank, 20, 3, {}))


def _summary(r, n):
    out = {f: getattr(r, f) for f in FIELDS}
    out.update(zeta=r.zeta.reshape(-1)[:n].tolist(),
               pi=np.asarray(r.pi).tolist(), shards=r.shards,
               restarts=r.restarts)
    return out


@pytest.fixture(scope="module")
def port_kills(tmp_path_factory, jax_runs):
    """The port's own kills at 8 stacked shards, at JAX's rounds."""
    base = tmp_path_factory.mktemp("elastic_port")
    fail_at = dict(counts=3, improved=jax_runs["improved"]["fail_at"],
                   directed=1)
    dirs = {}
    for case, (engine, K, seed, kw) in RUNS.items():
        d = str(base / case)
        with pytest.raises(trt.SimulatedFailure):
            engine(GRAPHS[case](), EPS, K, prng.PRNGKey(seed),
                   mesh=StackedMesh(8, "cpu"), checkpoint_dir=d,
                   fail_at=[fail_at[case]], checkpoint_every=2,
                   max_restarts=0, **kw)
        dirs[case] = d
    return dirs


def _resume(case, source, target, jax_base, port_kills, tmp_path):
    """The port resumes a pristine copy of `source`'s kill directory at
    `target` stacked shards."""
    src = (os.path.join(jax_base, case) if source == "jax"
           else port_kills[case])
    dst = str(tmp_path / f"{case}_{source}_{target}")
    shutil.copytree(src, dst)
    engine, K, seed, kw = RUNS[case]
    return engine(GRAPHS[case](), EPS, K, prng.PRNGKey(seed),
                  mesh=StackedMesh(target, "cpu"), checkpoint_dir=dst,
                  resume=True, checkpoint_every=2, **kw)


@pytest.mark.parametrize("case", ["counts", "improved", "directed"])
def test_port_kill_snapshots_equal_jax(case, jax_runs, jax_base,
                                       port_kills):
    """The port's 8-shard kill leaves JAX's snapshots: the same steps,
    manifests (shards, keys, shapes, dtypes), arrays bit for bit, and host
    accumulators but for the sampler's wall time."""
    jdir, tdir = os.path.join(jax_base, case), port_kills[case]
    jck_, tck_ = jck.Checkpointer(jdir), tck.Checkpointer(tdir)
    assert tck_.all_steps() == jck_.all_steps()

    def host(flat):
        return {k: v for k, v in tck.unpack_json(flat.pop("host")).items()
                if k != "sampler_us"}

    for step in jck_.all_steps():
        jflat, jm = jck_.restore(step)
        tflat, tm = tck_.restore(step)
        assert tm["metadata"] == jm["metadata"] == dict(shards=8)
        assert host(tflat) == host(jflat)
        assert sorted(tflat) == sorted(jflat)
        for k in jflat:
            assert tm["keys"][k] == jm["keys"][k]
            np.testing.assert_array_equal(tflat[k], jflat[k], err_msg=k)


@pytest.mark.parametrize("source", ["jax", "torch"])
@pytest.mark.parametrize("target", [1, 2, 4, 16])
def test_counts_elastic_resume_bit_exact(target, source, jax_runs, jax_base,
                                         port_kills, tmp_path):
    """Killed at 8 shards, resumed at P' (16 grows the mesh): zeta, pi and
    rounds bit-exact with JAX's unfailed run, no in-process restart; JAX's
    own resumes at 1, 2 and 4 agree."""
    want = jax_runs["counts"]
    r = _resume("counts", source, target, jax_base, port_kills, tmp_path)
    assert r.shards == target and r.restarts == 0
    assert r.zeta.reshape(-1)[:64].tolist() == want["zeta"]
    assert np.asarray(r.pi).tolist() == want["pi"]
    assert r.rounds == want["rounds"]
    if str(target) in want["targets"]:
        t = want["targets"][str(target)]
        assert t["zeta"] == want["zeta"] and t["rounds"] == want["rounds"]
        assert t["shards"] == target and t["restarts"] == 0


@pytest.mark.parametrize("source", ["jax", "torch"])
@pytest.mark.parametrize("target", [4, 2])
def test_improved_midphase2_elastic_resume_bit_exact(target, source,
                                                     jax_runs, jax_base,
                                                     port_kills, tmp_path):
    """Phase 2 draws nothing and the tail is empty at eta_safety=8: a
    mid-Phase-2 kill resumed at P' reproduces JAX's unfailed 8-shard run
    bit for bit, and equals JAX's own resume at P' field for field."""
    want = jax_runs["improved"]
    assert want["ref"]["tail_walks"] == 0
    r = _resume("improved", source, target, jax_base, port_kills, tmp_path)
    assert r.tail_walks == 0
    assert r.shards == target and r.restarts == 0 and r.dropped == 0
    got = _summary(r, 96)
    assert got["zeta"] == want["ref"]["zeta"]
    assert got["pi"] == want["ref"]["pi"]
    assert got == want["targets"][str(target)]


@pytest.mark.parametrize("source", ["jax", "torch"])
@pytest.mark.parametrize("target", [4, 2])
def test_directed_keyed_elastic_resume_conformance(target, source, jax_runs,
                                                   jax_base, port_kills,
                                                   tmp_path):
    """Killed in keyed Phase 1, so the shard keys are re-derived: the
    resumed run is a fresh trajectory, equal to JAX's resume at the same
    P' (the reference holds it only to the --check tolerances, which it
    also meets)."""
    from repro_torch.core import power_iteration
    r = _resume("directed", source, target, jax_base, port_kills, tmp_path)
    assert r.shards == target and r.restarts == 0 and r.dropped == 0
    assert _summary(r, 64) == jax_runs["directed"]["targets"][str(target)]
    g = GRAPHS["directed"]()
    pi_ref = power_iteration(g, EPS, device="cpu")[0].numpy()
    pi = np.asarray(r.pi, dtype=np.float64)
    assert l1_error(pi / pi.sum(), pi_ref) < 0.15
    assert topk_overlap(pi, pi_ref) >= 0.6


def test_counts_elastic_resume_grows_mesh(jax_runs, jax_base, tmp_path):
    """8 -> 16 shards from JAX's snapshot: the snapshot re-anchored at the
    resumed step holds the 16-shard layout, and a second resume from it
    (no re-layout now) finishes bit-exactly as well."""
    want = jax_runs["counts"]
    d = str(tmp_path / "grow")
    shutil.copytree(os.path.join(jax_base, "counts"), d)
    step = tck.Checkpointer(d).latest_step()

    def resume():
        return distributed_pagerank_counts(
            GRAPHS["counts"](), EPS, 40, prng.PRNGKey(2),
            mesh=StackedMesh(16, "cpu"), checkpoint_dir=d, resume=True,
            checkpoint_every=100)

    r = resume()
    assert r.zeta.reshape(-1)[:64].tolist() == want["zeta"]
    ck = tck.Checkpointer(d)
    assert ck.all_steps()[-2:] == [step, want["rounds"]]
    flat, manifest = ck.restore(step=step)
    assert manifest["metadata"] == dict(shards=16)
    assert flat["arrays/zeta"].shape == (16, 4)
    shutil.rmtree(os.path.join(d, f"step_{want['rounds']:09d}"))
    again = resume()
    assert again.zeta.reshape(-1)[:64].tolist() == want["zeta"]
    assert again.rounds == want["rounds"] and again.restarts == 0


def test_directed_recovery_bit_exact(jax_runs):
    """tests/test_fault_tolerance_improved.py's directed case: failures at
    the Phase 1 -> report boundary and mid-Phase 2 recover to JAX's
    unfailed run, bit for bit, telemetry included, and to JAX's recovered
    run field for field."""
    want = jax_runs["directed_recovery"]
    g = GRAPHS["directed"]()
    key = prng.PRNGKey(1)
    ref = distributed_directed_pagerank(g, EPS, 20, key,
                                        mesh=StackedMesh(8, "cpu"))
    assert _summary(ref, 64) == want["ref"]
    assert [ref.phase1_rounds, ref.phase1_rounds + ref.report_rounds
            + max(ref.phase2_rounds // 2, 1)] == want["fail_at"]
    rec = distributed_directed_pagerank(g, EPS, 20, key,
                                        mesh=StackedMesh(8, "cpu"),
                                        fail_at=want["fail_at"],
                                        checkpoint_every=3)
    got = _summary(rec, 64)
    assert got == want["rec"]
    assert rec.restarts == 2 and rec.dropped == 0
    assert dict(got, restarts=0) == want["ref"]


def test_ppr_service_resize_mid_traffic(jax_runs):
    """The service shrunk 4 -> 2 with two queries in flight: every result
    vector, counter and the cache hit equal JAX's service's; nothing is
    dropped, and each query meets the reference's tolerance."""
    want = jax_runs["serve"]
    g = erdos_renyi(96, 5.0, seed=1, device="cpu")
    svc = PPRService(g, EPS, slots=2, walks_per_query=4096,
                     mesh=StackedMesh(4, "cpu"))
    r1 = svc.submit([3], now=0.0)
    r2 = svc.submit([10, 17], now=0.0)
    for _ in range(2):
        svc.step(now=0.0)
    assert svc.engine.active.any()
    svc.resize(mesh=StackedMesh(2, "cpu"))
    assert svc.engine.shards == 2
    r3 = svc.submit([5], now=0.0)
    svc.drain(now=0.0)
    hit = svc.submit([3], now=0.0)
    st = svc.stats
    reqs = (r1, r2, r3)
    assert [np.asarray(r.result).tolist() for r in reqs] == want["results"]
    assert [r.done for r in reqs] == want["done"] == [True] * 3
    assert (st.dropped_walks, st.admit_dropped, st.completed,
            st.supersteps, st.cache_hits) == (
        want["dropped"], want["admit_dropped"], want["completed"],
        want["supersteps"], want["cache_hits"])
    assert st.dropped_walks == 0 and st.admit_dropped == 0
    assert st.completed == 3
    assert hit.cached and np.array_equal(hit.result, r1.result)
    assert want["cache_hit"] and want["cache_bitexact"]
    for req, sources in zip(reqs, ([3], [10, 17], [5])):
        ref = exact_ppr(g, EPS, sources)
        assert l1_error(normalized(req.result), normalized(ref)) < 0.15
        assert topk_overlap(req.result, ref) >= 0.6
