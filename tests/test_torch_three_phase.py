"""The port's three-phase sharded engines (Algorithm 2 and Section 5) on a
stacked mesh, against the JAX package's shard_map engines on forced host
devices.

One subprocess runs the JAX engines with 8 forced host devices and prints
JSON; the port runs the same cases in process on the CPU, with P shards
stacked on one device. Cases: both engines on the six shared fixtures at
P=8 and on two fixtures at P in {1, 3}; eta=1 (most walks exhaust the
pools and finish in the naive tail); a run recovering from injected
failures; a run stopped mid-Phase-2 whose snapshot the port resumes.
eps = 0.2, K = 8, key PRNGKey(0).

Parity levels:
  * bit-exact — zeta, rounds by phase, wire bytes by phase, lane entries
    by site, coupons created and used, walks terminated by a coupon, tail
    walks, exhausted walks, dropped, waited, residual, p1_occupancy and
    the Phase-2 records; the slot re-layout against the JAX package's
    `relayout_staged_flat`; a JAX Phase-2 snapshot resumed by the port, at
    8 shards and at 3.
The static plan, the Phase-1 dense-cell sampler and the int64 keys are
tested in `test_torch_three_phase_plan.py`, which needs no subprocess.
"""
import importlib
import shutil

import numpy as np
import pytest

from repro.checkpoint import relayout_staged_flat as j_relayout_flat
from repro.core.distributed_improved import \
    _three_phase_layouts as j_layouts
from repro.core.distributed_improved import plan_three_phase as j_plan

from conftest import SMALL_GRAPHS_SRC, run_forced_devices
from repro_torch import convert, prng
from repro_torch.checkpoint import (Checkpointer, relayout_staged_flat,
                                    unpack_json)
from repro_torch.core.collectives import StackedMesh
from repro_torch.core.distributed_directed import \
    distributed_directed_pagerank
from repro_torch.core.distributed_improved import (
    _three_phase_layouts, distributed_improved_pagerank)

t_improved = importlib.import_module("repro_torch.core.improved_pagerank")
j_improved = importlib.import_module("repro.core.improved_pagerank")

EPS, K = 0.2, 8
NAMES = ["ring", "grid", "er", "ba", "ba_hub", "dweb"]
ENGINES = ["improved", "directed"]
CASES = [(name, 8) for name in NAMES] + [
    (name, p) for name in ("er", "dweb") for p in (1, 3)]
# (engine, fixture, P, eta) where eta=1 starves the pools
ETA1 = [("improved", "ba", 8), ("directed", "dweb", 3)]
FAIL_AT = [2, 6, 9]
STOP_AT = 5          # past Phase 1's 3 rounds at n = 96: a Phase-2 stage

FIELDS = ("rounds", "phase1_rounds", "report_rounds", "phase2_rounds",
          "phase3_rounds", "tail_rounds", "stitch_iterations",
          "exhausted_walks", "terminated_by_coupon", "tail_walks",
          "coupons_created", "coupons_used", "dropped", "waited",
          "a2a_bytes_total", "a2a_bytes_by_phase", "a2a_entries_by_site",
          "phase2_records", "total_visits", "residual", "lam", "eta", "ell")

JAX_RUNS = SMALL_GRAPHS_SRC + """
import json, os
from concurrent.futures import ThreadPoolExecutor
import jax, numpy as np
from jax.sharding import Mesh
from repro.core.distributed_improved import distributed_improved_pagerank
from repro.core.distributed_directed import distributed_directed_pagerank
from repro.runtime import SimulatedFailure
ENGINES = dict(improved=distributed_improved_pagerank,
               directed=distributed_directed_pagerank)
FIELDS, CASES, ETA1, EPS, K = %r, %r, %r, %r, %r
FAIL_AT, STOP_AT, BASE = %r, %r, %r

def summary(r):
    out = {f: getattr(r, f) for f in FIELDS}
    out.update(zeta=np.asarray(r.zeta).tolist(), shards=r.shards,
               p1_occupancy=list(r.p1_occupancy), restarts=r.restarts)
    return out

def mesh(P):
    return Mesh(np.array(jax.devices()[:P]), ("shards",))

key = jax.random.PRNGKey(0)
jobs = {f"{engine}/{name}/{P}": (fn, name, P, {})
        for engine, fn in ENGINES.items() for name, P in CASES}
jobs.update({f"eta1/{engine}/{name}/{P}": (ENGINES[engine], name, P,
                                           dict(eta=1))
             for engine, name, P in ETA1})
jobs["fail_at"] = (distributed_improved_pagerank, "er", 8,
                   dict(fail_at=FAIL_AT))
jobs["stopped"] = (distributed_improved_pagerank, "er", 8, dict(
    fail_at=[STOP_AT], max_restarts=0, checkpoint_every=1,
    checkpoint_dir=os.path.join(BASE, "stopped")))

def run(item):
    label, (fn, name, P, kw) = item
    try:
        return label, summary(fn(graphs[name], EPS, K, key, mesh=mesh(P),
                                 **kw))
    except SimulatedFailure:
        return label, "stopped"

# the runs are independent: compile them on a few threads (XLA compiles
# with the GIL released)
with ThreadPoolExecutor(4) as pool:
    out = dict(pool.map(run, jobs.items()))
assert out["stopped"] == "stopped", "the injected failure did not stop it"
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_base(tmp_path_factory):
    return str(tmp_path_factory.mktemp("three_phase_jax"))


@pytest.fixture(scope="module")
def jax_runs(jax_base):
    code = JAX_RUNS % (FIELDS, CASES, ETA1, EPS, K, FAIL_AT, STOP_AT,
                       jax_base)
    return run_forced_devices(code, devices=8, timeout=900)


@pytest.fixture(scope="module")
def graphs(small_graphs):
    """The shared fixtures as port graphs on the CPU."""
    return {name: convert.graph_from_numpy(
        np.asarray(g.row_ptr), np.asarray(g.col_idx), np.asarray(g.out_deg),
        g.n, g.m, g.undirected, device="cpu")
        for name, g in small_graphs.items()}


ENGINE_FNS = dict(improved=distributed_improved_pagerank,
                  directed=distributed_directed_pagerank)


def _summary(r):
    out = {f: getattr(r, f) for f in FIELDS}
    out.update(zeta=r.zeta.tolist(), shards=r.shards,
               p1_occupancy=list(r.p1_occupancy), restarts=r.restarts)
    return out


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("name,shards", CASES)
def test_engine_bit_exact(jax_runs, graphs, engine, name, shards):
    r = ENGINE_FNS[engine](graphs[name], EPS, K, prng.PRNGKey(0),
                           mesh=StackedMesh(shards, "cpu"))
    assert _summary(r) == jax_runs[f"{engine}/{name}/{shards}"]
    assert r.dropped == 0 and r.residual == 0 and r.phase3_rounds == 1
    assert r.phase1_rounds <= r.lam and r.report_rounds == 0


@pytest.mark.parametrize("engine,name,shards", ETA1)
def test_exhaustion_bit_exact(jax_runs, graphs, engine, name, shards):
    r = ENGINE_FNS[engine](graphs[name], EPS, K, prng.PRNGKey(0),
                           mesh=StackedMesh(shards, "cpu"), eta=1)
    assert r.tail_walks > 0 and r.tail_rounds > 0
    assert r.tail_walks == r.exhausted_walks
    assert _summary(r) == jax_runs[f"eta1/{engine}/{name}/{shards}"]


def test_fail_at_recovery_bit_exact(jax_runs, graphs):
    r = distributed_improved_pagerank(graphs["er"], EPS, K, prng.PRNGKey(0),
                                      mesh=StackedMesh(8, "cpu"),
                                      fail_at=FAIL_AT)
    want = jax_runs["fail_at"]
    assert r.restarts == len(FAIL_AT) == want["restarts"]
    assert _summary(r) == want
    clean = dict(jax_runs["improved/er/8"], restarts=len(FAIL_AT))
    assert _summary(r) == clean


@pytest.mark.parametrize("shards", [8, 3])
def test_jax_phase2_snapshot_resumes_in_port(jax_runs, jax_base, graphs,
                                             tmp_path, shards):
    """The JAX run stopped at round STOP_AT, mid-Phase-2; the port resumes
    its snapshot at 8 shards, and at 3 through the slot re-layout, and
    finishes bit-exactly as the uninterrupted JAX run."""
    src = f"{jax_base}/stopped"
    flat, manifest = Checkpointer(src).restore()
    assert manifest["step"] == STOP_AT
    assert unpack_json(flat["stage"]) == "phase2"
    dst = tmp_path / "ckpt"
    shutil.copytree(src, dst)
    r = distributed_improved_pagerank(graphs["er"], EPS, K, prng.PRNGKey(0),
                                      mesh=StackedMesh(shards, "cpu"),
                                      checkpoint_dir=str(dst), resume=True)
    want = jax_runs["improved/er/8"]
    assert r.zeta.tolist() == want["zeta"]
    for f in ("rounds", "phase2_rounds", "coupons_used",
              "terminated_by_coupon", "tail_walks", "phase2_records"):
        assert getattr(r, f) == want[f], f
    if shards == 8:
        assert {f: getattr(r, f) for f in FIELDS} == {
            f: want[f] for f in FIELDS}


@pytest.mark.parametrize("new_shards", [1, 3, 5])
def test_slot_relayout_matches_jax(jax_runs, jax_base, small_graphs,
                                   new_shards):
    """The JAX Phase-2 snapshot re-laid out onto another shard count by
    both packages: every buffer equal."""
    flat, _ = Checkpointer(f"{jax_base}/stopped").restore()
    jg = small_graphs["er"]
    _, pool = j_improved.coupon_pool_sizes(jg, EPS, K, 3)
    cap2 = j_plan(jg, 8, pool, K).cap2
    want = j_relayout_flat(dict(flat), 8, new_shards,
                           j_layouts(jg.n, pool, cap2))
    got = relayout_staged_flat(dict(flat), new_shards,
                               _three_phase_layouts(jg.n, pool, cap2))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
