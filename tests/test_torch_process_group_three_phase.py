"""The three-phase sharded engines (Algorithm 2 and Section 5) with one
shard per process (`core.collectives.ProcessGroupMesh`) against the JAX
package's `shard_map` engines at the same shard count, and against
`StackedMesh` at that count.

The port's side runs in gloo groups of 4 and 2 spawned processes on the
CPU, one after the other, as `tests/test_torch_process_group.py` runs
Algorithm 1's engines (`run_group`: a `FileStore` under the test's
temporary directory, a 60 s group timeout, every process killed past the
join timeout, one torch thread a process). The JAX side is one
subprocess on 8 forced host devices, `Mesh(devices[:P])`, running beside
the groups. Fixtures: erdos_renyi(96, 5.0, seed=1) for Algorithm 2 and
directed_web(96, 5.0, seed=3) for Section 5, eps = 0.2, K = 8, key
PRNGKey(0); Algorithm 2 also at eta = 1, where most walks exhaust the
pools and finish in the naive tail.

Parity level 1 (bit-exact) throughout:
  * both engines at 4 and 2 processes: zeta, rounds by phase, coupons
    used, tail, exhausted and coupon-terminated walks, dropped, waited,
    wire bytes by phase, lane entries by site, the Phase-2 records,
    Phase-1 occupancy and residual equal to JAX's and to the stacked
    run's;
  * Algorithm 2 at eta_safety 8 (an empty tail) with K = 40, killed
    mid-Phase 2 at 4 processes: its snapshots equal the stacked run's
    file for file (but for the sampler's wall time); resumed at 2
    processes, equal to JAX's unfailed run;
  * the tail placement check, which only one shard fails, raises the
    same error on both processes, and neither hangs;
  * the CONGEST auditor's improved and directed rows at 4 processes equal
    to the stacked rows, with 0 violations.
"""
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import REPO_SRC
from repro_torch import prng
from repro_torch.analysis.congest import audit_all_engines
from repro_torch.checkpoint import Checkpointer, unpack_json
from repro_torch.core.collectives import StackedMesh
from repro_torch.core.distributed_directed import \
    distributed_directed_pagerank
from repro_torch.core.distributed_improved import \
    distributed_improved_pagerank
from repro_torch.graphs import directed_web, erdos_renyi
from repro_torch.runtime import SimulatedFailure
from test_torch_process_group import run_group

EPS, K = 0.2, 8
WORLDS = (4, 2)
GRAPHS_SRC = """
graphs = dict(er=erdos_renyi(96, 5.0, seed=1%(dev)s),
              dweb=directed_web(96, 5.0, seed=3%(dev)s))
"""
# label: (engine, fixture, keyword arguments)
RUNS = {"improved": ("improved", "er", {}),
        "directed": ("directed", "dweb", {}),
        "improved_eta1": ("improved", "er", dict(eta=1))}
# the kill of tests/test_torch_elastic.py: at eta_safety 8 the tail is
# empty, so a mid-Phase-2 snapshot resumes bit-exactly at any shard count
KILL = dict(K=40, eta_safety=8.0, every=4)
# eta = 1 at 2 shards puts 219 and 232 walks in the two shards' tails:
# a buffer of 225 slots holds the first shard's and not the second's
GUARD_CAP2 = 225
FIELDS = ("rounds", "phase1_rounds", "report_rounds", "phase2_rounds",
          "phase3_rounds", "tail_rounds", "stitch_iterations",
          "exhausted_walks", "terminated_by_coupon", "tail_walks",
          "coupons_created", "coupons_used", "dropped", "waited",
          "a2a_bytes_total", "a2a_bytes_by_phase", "a2a_entries_by_site",
          "phase2_records", "total_visits", "residual", "lam", "eta", "ell")

JAX_CODE = """
import json, sys
from concurrent.futures import ThreadPoolExecutor
import jax, numpy as np
from jax.sharding import Mesh
from repro.core.distributed_improved import distributed_improved_pagerank
from repro.core.distributed_directed import distributed_directed_pagerank
from repro.graphs import directed_web, erdos_renyi
ENGINES = dict(improved=distributed_improved_pagerank,
               directed=distributed_directed_pagerank)
EPS, K, RUNS, KILL, FIELDS, WORLDS = %r, %r, %r, %r, %r, %r
""" % (EPS, K, RUNS, KILL, FIELDS, WORLDS) + GRAPHS_SRC % dict(dev="") + """
def summary(r):
    out = {f: getattr(r, f) for f in FIELDS}
    out.update(zeta=np.asarray(r.zeta).tolist(),
               p1_occupancy=list(r.p1_occupancy))
    return out

def mesh(P):
    return Mesh(np.array(jax.devices()[:P]), ("shards",))

jobs = {f"{label}/{P}": (ENGINES[e], graphs[name], K, kw, P)
        for label, (e, name, kw) in RUNS.items() for P in WORLDS}
jobs["unfailed/4"] = (distributed_improved_pagerank, graphs["er"], KILL["K"],
                      dict(eta_safety=KILL["eta_safety"]), 4)

def run(item):
    label, (fn, g, k, kw, P) = item
    return label, summary(fn(g, EPS, k, jax.random.PRNGKey(0), mesh=mesh(P),
                             **kw))

# the runs are independent: compile them on a few threads
with ThreadPoolExecutor(4) as pool:
    print(json.dumps(dict(pool.map(run, jobs.items()))))
"""

# the cases every process of a group runs (`run_group`'s body)
CHILD = """
from repro_torch import prng
from repro_torch.core.collectives import ProcessGroupMesh
from repro_torch.core.distributed_directed import \\
    distributed_directed_pagerank
from repro_torch.core.distributed_improved import \\
    distributed_improved_pagerank
from repro_torch.graphs import directed_web, erdos_renyi
from repro_torch.runtime import SimulatedFailure
ENGINES = dict(improved=distributed_improved_pagerank,
               directed=distributed_directed_pagerank)
EPS, K, RUNS, KILL, FIELDS, GUARD_CAP2, MID_P2, TMP = %(consts)r
""" + GRAPHS_SRC % dict(dev=", device='cpu'") + """
mesh = ProcessGroupMesh(device="cpu")
out = dict(rank=mesh.rank, shards=mesh.shards)

def summary(r):
    res = {f: getattr(r, f) for f in FIELDS}
    res.update(zeta=r.zeta.tolist(), p1_occupancy=list(r.p1_occupancy))
    return res

def engines():
    return {label: summary(ENGINES[e](graphs[name], EPS, K, prng.PRNGKey(0),
                                      mesh=mesh, **kw))
            for label, (e, name, kw) in RUNS.items()}

def kill_improved(**kw):
    return distributed_improved_pagerank(
        graphs["er"], EPS, KILL["K"], prng.PRNGKey(0), mesh=mesh,
        eta_safety=KILL["eta_safety"], checkpoint_every=KILL["every"], **kw)

def kill():
    try:
        kill_improved(checkpoint_dir=os.path.join(TMP, "kill"),
                      fail_at=[MID_P2], max_restarts=0)
    except SimulatedFailure:
        return True
    return False

def resume():
    r = kill_improved(checkpoint_dir=os.path.join(TMP, "resume"),
                      resume=True)
    return dict(summary(r), shards=r.shards, restarts=r.restarts)

def guard():
    try:
        distributed_improved_pagerank(graphs["er"], EPS, K, prng.PRNGKey(0),
                                      mesh=mesh, eta=1, cap2=GUARD_CAP2)
    except ValueError as e:
        return str(e)
    return "ran"

def audit():
    from repro_torch.analysis.congest import audit_all_engines
    return audit_all_engines(mesh, eps=EPS,
                             engines=("improved", "directed"))
"""

CASES = {4: ["engines", "kill", "audit"],
         2: ["engines", "resume", "guard"]}


def run_three_phase_group(world, tmp, mid_p2):
    """This file's cases of `world` in a gloo group of `world` processes
    (`tests/test_torch_process_group.py::run_group`)."""
    body = CHILD % dict(consts=(EPS, K, RUNS, KILL, FIELDS, GUARD_CAP2,
                                mid_p2, str(tmp)))
    return run_group(world, CASES[world], tmp, body=body)


def _graph(name):
    ns = dict(erdos_renyi=erdos_renyi, directed_web=directed_web)
    exec(GRAPHS_SRC % dict(dev=", device='cpu'"), ns)
    return ns["graphs"][name]


def _stacked_improved(P, **kw):
    return distributed_improved_pagerank(
        _graph("er"), EPS, KILL["K"], prng.PRNGKey(0),
        mesh=StackedMesh(P, "cpu"), eta_safety=KILL["eta_safety"], **kw)


def _summary(r):
    out = {f: getattr(r, f) for f in FIELDS}
    out.update(zeta=r.zeta.tolist(), p1_occupancy=list(r.p1_occupancy))
    return out


@pytest.fixture(scope="module")
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, one_torch_thread):
    """The JAX subprocess and the two groups: {"jax": ..., "mid_p2": ...,
    world: [per-process JSON]}. The group of 2 resumes a copy of the group
    of 4's kill directory."""
    tmp = tmp_path_factory.mktemp("process_group_three_phase")
    env = dict(os.environ, PYTHONPATH=REPO_SRC,
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    log = open(tmp / "jax.log", "w+")
    jax_proc = subprocess.Popen([sys.executable, "-c", JAX_CODE], env=env,
                                stdout=log, stderr=subprocess.STDOUT,
                                text=True)
    ref = _stacked_improved(4)
    mid_p2 = (ref.phase1_rounds + ref.report_rounds
              + max(ref.phase2_rounds // 2, 1))
    out = dict(tmp=tmp, mid_p2=mid_p2)
    try:
        out[4] = run_three_phase_group(4, tmp, mid_p2)
        shutil.copytree(tmp / "kill", tmp / "resume")
        out[2] = run_three_phase_group(2, tmp, mid_p2)
        jax_proc.wait(timeout=600)
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
            jax_proc.wait()
    log.seek(0)
    text = log.read()
    log.close()
    assert jax_proc.returncode == 0, text[-3000:]
    out["jax"] = json.loads(text.strip().splitlines()[-1])
    return out


@pytest.mark.parametrize("label", list(RUNS))
@pytest.mark.parametrize("world", WORLDS)
def test_three_phase_matches_jax(runs, world, label):
    want = runs["jax"][f"{label}/{world}"]
    assert want["dropped"] == 0 and want["residual"] == 0
    if label == "improved_eta1":
        assert want["tail_walks"] > 0 and want["tail_rounds"] > 0
    for got in runs[world]:
        assert got["rank"] < world and got["shards"] == world
        assert got["engines"][label] == want


@pytest.mark.parametrize("label", list(RUNS))
@pytest.mark.parametrize("world", WORLDS)
def test_three_phase_matches_stacked(runs, world, label):
    engine, name, kw = RUNS[label]
    fn = dict(improved=distributed_improved_pagerank,
              directed=distributed_directed_pagerank)[engine]
    want = _summary(fn(_graph(name), EPS, K, prng.PRNGKey(0),
                       mesh=StackedMesh(world, "cpu"), **kw))
    for got in runs[world]:
        assert got["engines"][label] == want


def _host(flat):
    return {k: v for k, v in unpack_json(flat.pop("host")).items()
            if k != "sampler_us"}


def test_kill_snapshots_equal_stacked(runs, tmp_path):
    """Killed mid-Phase 2 at 4 processes, the snapshots are the stacked
    run's at 4 shards file for file, written once."""
    assert all(got["kill"] for got in runs[4])
    d = str(tmp_path / "stacked")
    with pytest.raises(SimulatedFailure):
        _stacked_improved(4, checkpoint_dir=d, fail_at=[runs["mid_p2"]],
                          checkpoint_every=KILL["every"], max_restarts=0)
    want, got = Checkpointer(d), Checkpointer(str(runs["tmp"] / "kill"))
    assert got.all_steps() == want.all_steps()
    stages = []
    for step in want.all_steps():
        wflat, wm = want.restore(step)
        gflat, gm = got.restore(step)
        assert gm["metadata"] == wm["metadata"] == dict(shards=4)
        # the host leaf's length follows the sampler's wall time
        assert {k: v for k, v in gm["keys"].items() if k != "host"} == {
            k: v for k, v in wm["keys"].items() if k != "host"}
        stages.append(unpack_json(wflat["stage"]))
        assert _host(gflat) == _host(wflat)
        assert sorted(gflat) == sorted(wflat)
        for k in wflat:
            np.testing.assert_array_equal(gflat[k], wflat[k], err_msg=k)
    # the snapshot the resume starts from is a Phase-2 one
    assert stages[0] == "phase1" and stages[-1] == "phase2"
    assert sorted(os.listdir(runs["tmp"] / "kill")) == sorted(
        os.listdir(d))


def test_resume_at_two_processes_matches_jax(runs, tmp_path):
    """The 4-process kill resumed at 2 processes: the stacked resume at 2
    shards of the same snapshots field for field, and JAX's unfailed run
    at 4 shards in every field but the wire's (the resumed rounds route
    between 2 shards)."""
    want = runs["jax"]["unfailed/4"]
    assert want["tail_walks"] == 0
    d = tmp_path / "stacked"
    shutil.copytree(runs["tmp"] / "kill", d)
    stacked = _stacked_improved(2, checkpoint_dir=str(d), resume=True,
                                checkpoint_every=KILL["every"])
    wire = ("a2a_bytes_total", "a2a_bytes_by_phase", "a2a_entries_by_site")
    for got in runs[2]:
        r = dict(got["resume"])
        assert (r.pop("shards"), r.pop("restarts")) == (2, 0)
        assert r == _summary(stacked)
        assert ({k: v for k, v in r.items() if k not in wire}
                == {k: v for k, v in want.items() if k not in wire})


def test_tail_guard_raises_on_every_process(runs):
    """One shard's tail does not fit the buffer, the other's does: both
    processes raise the stacked run's error, and neither hangs."""
    with pytest.raises(ValueError) as err:
        distributed_improved_pagerank(
            _graph("er"), EPS, K, prng.PRNGKey(0),
            mesh=StackedMesh(2, "cpu"), eta=1, cap2=GUARD_CAP2)
    msg = str(err.value)
    held = [int(x) for x in re.search(r"hold \[(.*)\]", msg)[1].split(",")]
    assert min(held) <= GUARD_CAP2 < max(held)
    assert [got["guard"] for got in runs[2]] == [msg, msg]


@pytest.mark.parametrize("engine", ["improved", "directed"])
def test_audit_rows_match_stacked(runs, engine):
    """The wire rows, resume classes, W-independence, telemetry and meta
    at 4 processes equal the stacked audit's at 4 shards; 0 violations."""
    want = audit_all_engines(StackedMesh(4, "cpu"), eps=EPS,
                             engines=(engine,))
    assert want["ok"]
    for got in runs[4]:
        rep = got["audit"]
        assert rep["ok"] and rep["violations_total"] == 0
        g, w = rep["engines"][engine], want["engines"][engine]
        for field in ("sites", "resume", "w_independent", "telemetry",
                      "meta", "fixture", "violations"):
            assert g[field] == w[field], field
