"""Algorithm 1's sharded engines with one shard per process
(`core.collectives.ProcessGroupMesh`) against the JAX package's
`shard_map` engines at the same shard count.

The port's side runs in gloo groups of 2, 3 and 4 spawned processes on
the CPU, one after another; each process holds one shard, starts its
group from a `FileStore` under the test's temporary directory, with a 60 s
timeout on the group, and runs with one torch thread. The parent kills
every process of a group that is not done within its join timeout, so a
hung collective fails the test instead of the run. The JAX side is one
subprocess on 8 forced host devices, `Mesh(devices[:P])`, running beside
the groups. Fixtures: ring(96), erdos_renyi(96, 5.0, seed=1) and
directed_web(96, 5.0, seed=3), eps = 0.2, K = 8, key PRNGKey(0).

Parity level 1 (bit-exact) throughout:
  * the mesh's collectives against `StackedMesh` on the same stacked
    arrays: all_to_all of int32 and of int64 with trailing dims, psum,
    pmax, gather_rows, local_rows;
  * the count engine, packed and unpacked: zeta, rounds, a2a entries and
    bytes, lane_cap, overflow, occupancy and residual equal to JAX's (and
    occupancy and residual to the stacked run's);
  * the walk engine, with `work_cap` 0 and 8: zeta, rounds, dropped,
    waited, round_active, a2a entries and bytes equal to JAX's;
  * the packed-lane guard raises on every process, none hangs;
  * the count engine killed at 4 processes, its snapshots equal to the
    stacked run's file for file (but for the sampler's wall time), then
    resumed at 2 processes: zeta and rounds equal to the stacked runs,
    which tests/test_torch_elastic.py holds to JAX;
  * `launch.pagerank.run()` under 2 processes for `counts`, `walks`,
    `improved` and `directed` (with an injected failure) equal to
    `run(shards=2)`;
  * the CONGEST auditor's walk and count rows at 4 processes equal to the
    stacked rows, with 0 violations.
"""
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from conftest import REPO_SRC
from repro_torch import prng
from repro_torch.analysis.congest import audit_all_engines
from repro_torch.checkpoint import Checkpointer, unpack_json
from repro_torch.core.collectives import StackedMesh
from repro_torch.core.distributed import distributed_pagerank
from repro_torch.core.distributed_counts import distributed_pagerank_counts
from repro_torch.graphs import directed_web, erdos_renyi, ring
from repro_torch.launch import pagerank as launch
from repro_torch.runtime import SimulatedFailure

EPS, K = 0.2, 8
WORLDS = (4, 3, 2)
NAMES = ("ring", "er", "dweb")
# the count engine's lanes on each fixture: packed and unpacked on one,
# unpacked (the card's main path) on the others, to keep JAX's compiles few
PACKED = dict(ring=(False,), er=(True, False), dweb=(False,))
GRAPHS_SRC = """
graphs = dict(ring=ring(96%(dev)s), er=erdos_renyi(96, 5.0, seed=1%(dev)s),
              dweb=directed_web(96, 5.0, seed=3%(dev)s))
"""
# the elastic case of tests/test_torch_elastic.py
KILL = dict(n=64, K=40, seed=2, fail_at=3)
LAUNCH = (64, EPS, 8, "erdos_renyi")
LAUNCH_ALGOS = ("counts", "walks", "improved", "directed")
GROUP_TIMEOUT = 60      # seconds, on the group's collectives
JOIN_TIMEOUT = 180      # seconds, for a whole group to finish

JAX_CODE = """
import json, sys
import jax, numpy as np
from jax.sharding import Mesh
from repro.core.distributed import distributed_pagerank
from repro.core.distributed_counts import distributed_pagerank_counts
from repro.graphs import directed_web, erdos_renyi, ring
EPS, K, NAMES, PACKED = %r, %r, %r, %r
""" % (EPS, K, NAMES, PACKED) + GRAPHS_SRC % dict(dev="") + """
devs = jax.devices()

def walks(r):
    return dict(zeta=np.asarray(r.zeta).tolist(), rounds=r.rounds,
                dropped=r.dropped, waited=r.waited,
                round_active=r.round_active, entries=r.a2a_entries_total,
                bytes=r.a2a_bytes_total)

def one(P, name):
    g, mesh = graphs[name], Mesh(np.array(devs[:P]), ("shards",))
    key = jax.random.PRNGKey(0)
    out = {f"walks/{name}/{P}": walks(distributed_pagerank(
        g, EPS, K, key, mesh=mesh))}
    for packed in PACKED[name]:
        r = distributed_pagerank_counts(g, EPS, K, key, mesh=mesh,
                                        packed=packed)
        out[f"counts/{name}/{P}/{int(packed)}"] = dict(
            zeta=np.asarray(r.zeta).tolist(), rounds=r.rounds,
            entries=r.a2a_entries_total, bytes=r.a2a_bytes_total,
            lane_cap=r.lane_cap, overflow=r.overflow,
            occupancy=list(r.occupancy), residual=r.residual)
    if name == "er":
        out[f"work_cap/{name}/{P}"] = walks(distributed_pagerank(
            g, EPS, K, key, mesh=mesh, work_cap=8))
    return out

out = {}
for name in NAMES:
    out.update(one(int(sys.argv[1]), name))
print(json.dumps(out))
"""

# every process of a group starts it, runs a body of cases, then the cases
# of its world and prints their results
GROUP_START = """
import datetime, json, os, sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
RANK, WORLD = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
dist.init_process_group(
    "gloo", store=dist.FileStore(os.environ["PG_STORE"], WORLD), rank=RANK,
    world_size=WORLD, timeout=datetime.timedelta(seconds=%(timeout)d))
"""
GROUP_END = """
for case in %(cases)r:
    out[case] = globals()[case]()
dist.destroy_process_group()
print(json.dumps(out))
"""
CHILD = """
from repro_torch import prng
from repro_torch.core.collectives import ProcessGroupMesh, StackedMesh
from repro_torch.core.distributed import distributed_pagerank
from repro_torch.core.distributed_counts import distributed_pagerank_counts
from repro_torch.graphs import directed_web, erdos_renyi, ring
from repro_torch.runtime import SimulatedFailure
EPS, K, NAMES, PACKED, KILL, LAUNCH, LAUNCH_ALGOS, TMP = %(consts)r
""" + GRAPHS_SRC % dict(dev=", device='cpu'") + """
mesh = ProcessGroupMesh(device="cpu")
out = dict(rank=mesh.rank, shards=mesh.shards)

def units():
    rng = np.random.default_rng(WORLD)
    a32 = rng.integers(-2**31, 2**31, (WORLD, WORLD * 5), dtype=np.int64)
    a64 = rng.integers(-2**62, 2**62, (WORLD, WORLD * 2, 3), dtype=np.int64)
    small = rng.integers(0, 1000, (WORLD, 4), dtype=np.int64)
    mine = lambda a, dt: torch.from_numpy(mesh.local_rows(a)).to(dt)
    return dict(
        a2a_int32=mesh.all_to_all(mine(a32, torch.int32)).tolist(),
        a2a_int64=mesh.all_to_all(mine(a64, torch.int64)).tolist(),
        psum=mesh.psum(mine(small, torch.int32)).tolist(),
        psum_bool=mesh.psum(mine(small, torch.int32) > 500).tolist(),
        pmax=mesh.pmax(mine(small, torch.int64)).tolist(),
        gather_rows=mesh.gather_rows(mine(a64, torch.int64)).tolist(),
        local_rows=mine(a32, torch.int32).tolist(),
        shard_ids=mesh.shard_ids().tolist())

def walks(r):
    return dict(zeta=r.zeta.tolist(), rounds=r.rounds, dropped=r.dropped,
                waited=r.waited, round_active=r.round_active,
                entries=r.a2a_entries_total, bytes=r.a2a_bytes_total)

def engines():
    res, key = {}, prng.PRNGKey(0)
    for name in NAMES:
        g = graphs[name]
        res[f"walks/{name}"] = walks(distributed_pagerank(g, EPS, K, key,
                                                          mesh=mesh))
        if name == "er":
            res[f"work_cap/{name}"] = walks(distributed_pagerank(
                g, EPS, K, key, mesh=mesh, work_cap=8))
        for packed in PACKED[name]:
            r = distributed_pagerank_counts(g, EPS, K, key, mesh=mesh,
                                            packed=packed)
            res[f"counts/{name}/{int(packed)}"] = dict(
                zeta=r.zeta.tolist(), rounds=r.rounds,
                entries=r.a2a_entries_total, bytes=r.a2a_bytes_total,
                lane_cap=r.lane_cap, overflow=r.overflow,
                occupancy=list(r.occupancy), residual=r.residual)
    return res

def kill():
    g = erdos_renyi(KILL["n"], 5.0, seed=1, device="cpu")
    try:
        distributed_pagerank_counts(
            g, EPS, KILL["K"], prng.PRNGKey(KILL["seed"]), mesh=mesh,
            checkpoint_dir=os.path.join(TMP, "kill"),
            fail_at=[KILL["fail_at"]], checkpoint_every=2, max_restarts=0)
    except SimulatedFailure:
        return True
    return False

def resume():
    g = erdos_renyi(KILL["n"], 5.0, seed=1, device="cpu")
    r = distributed_pagerank_counts(
        g, EPS, KILL["K"], prng.PRNGKey(KILL["seed"]), mesh=mesh,
        checkpoint_dir=os.path.join(TMP, "resume"), resume=True,
        checkpoint_every=2)
    return dict(zeta=r.zeta.tolist(), rounds=r.rounds, shards=r.shards,
                restarts=r.restarts)

def hub_graph():
    from repro_torch.core.graph import from_edges
    src = np.concatenate([np.arange(32), [32], np.arange(33, 63), [63]])
    dst = np.concatenate([np.full(32, 32), [0], np.arange(34, 64), [33]])
    return from_edges(src, dst, 64, device="cpu")

def packed_guard():
    try:
        distributed_pagerank_counts(hub_graph(), EPS, 5000, prng.PRNGKey(1),
                                    mesh=mesh)
    except RuntimeError as e:
        return "packed=False" in str(e)
    return False

def launcher():
    from repro_torch.launch.pagerank import run
    res = {}
    for algo in LAUNCH_ALGOS:
        r = run(*LAUNCH, None, [3], algo=algo, device="cpu")
        res[algo] = dict(pi=r.pi.tolist(), rounds=r.rounds,
                         restarts=r.restarts, shards=r.shards)
    try:
        run(*LAUNCH, None, [], algo="counts", shards=WORLD + 1, device="cpu")
        res["wrong_shards"] = "ran"
    except SystemExit as e:
        res["wrong_shards"] = str(e)
    return res

def audit():
    from repro_torch.analysis.congest import audit_all_engines
    return audit_all_engines(mesh, eps=EPS, engines=("walks", "counts"))
"""

CASES = {4: ["units", "engines", "kill", "audit"],
         3: ["units", "engines"],
         2: ["units", "engines", "resume", "packed_guard", "launcher"]}


def run_group(world, cases, tmp, body=None):
    """Run `cases` in a gloo group of `world` processes; returns each
    process's JSON. Every process is killed after JOIN_TIMEOUT. `body`
    defines the cases (this file's CHILD by default); it finds the
    started group's mesh in `mesh` and the results in `out`."""
    if body is None:
        body = CHILD % dict(consts=(EPS, K, NAMES, PACKED, KILL, LAUNCH,
                                    LAUNCH_ALGOS, str(tmp)))
    code = (GROUP_START % dict(timeout=GROUP_TIMEOUT) + body
            + GROUP_END % dict(cases=cases))
    env = dict(os.environ, PYTHONPATH=REPO_SRC, WORLD_SIZE=str(world),
               PG_STORE=str(tmp / f"store_{world}"), OMP_NUM_THREADS="1")
    procs, logs = [], []
    for rank in range(world):
        log = open(tmp / f"rank_{world}_{rank}.log", "w+")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code], env=dict(env, RANK=str(rank)),
            stdout=log, stderr=subprocess.STDOUT, text=True))
    deadline = time.monotonic() + JOIN_TIMEOUT
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = []
    for rank, (p, log) in enumerate(zip(procs, logs)):
        log.seek(0)
        text = log.read()
        log.close()
        assert p.returncode == 0, f"rank {rank} of {world}:\n{text[-3000:]}"
        outs.append(json.loads(text.strip().splitlines()[-1]))
    return outs


@pytest.fixture(scope="module")
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, one_torch_thread):
    """The JAX subprocesses and the three groups: {"jax": ..., world:
    [per-process JSON]}. JAX's compiles are its cost, so each shard count
    runs in its own subprocess, all beside the groups. The group of 2
    resumes a copy of the group of 4's kill directory."""
    tmp = tmp_path_factory.mktemp("process_group")
    env = dict(os.environ, PYTHONPATH=REPO_SRC,
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    jax_procs = {world: subprocess.Popen(
        [sys.executable, "-c", JAX_CODE, str(world)], env=env,
        stdout=open(tmp / f"jax_{world}.log", "w"), stderr=subprocess.STDOUT,
        text=True) for world in WORLDS}
    out = dict(jax={}, tmp=tmp)
    try:
        for world in WORLDS:
            if world == 2:
                shutil.copytree(tmp / "kill", tmp / "resume")
            out[world] = run_group(world, CASES[world], tmp)
        for world, proc in jax_procs.items():
            proc.wait(timeout=600)
    finally:
        for proc in jax_procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for world, proc in jax_procs.items():
        text = (tmp / f"jax_{world}.log").read_text()
        assert proc.returncode == 0, text[-3000:]
        out["jax"].update(json.loads(text.strip().splitlines()[-1]))
    return out


def _graph(name):
    ns = dict(ring=ring, erdos_renyi=erdos_renyi, directed_web=directed_web)
    exec(GRAPHS_SRC % dict(dev=", device='cpu'"), ns)
    return ns["graphs"][name]


def _stacked_units(world):
    """The child's `units` on a StackedMesh of the same stacked arrays."""
    rng = np.random.default_rng(world)
    a32 = rng.integers(-2**31, 2**31, (world, world * 5), dtype=np.int64)
    a64 = rng.integers(-2**62, 2**62, (world, world * 2, 3), dtype=np.int64)
    small = rng.integers(0, 1000, (world, 4), dtype=np.int64)
    mesh = StackedMesh(world, "cpu")
    t32 = torch.from_numpy(a32).to(torch.int32)
    t64 = torch.from_numpy(a64)
    ts = torch.from_numpy(small)
    return dict(
        a2a_int32=mesh.all_to_all(t32).tolist(),
        a2a_int64=mesh.all_to_all(t64).tolist(),
        psum=mesh.psum(ts.to(torch.int32)).tolist(),
        psum_bool=mesh.psum(ts.to(torch.int32) > 500).tolist(),
        pmax=mesh.pmax(ts).tolist(),
        gather_rows=mesh.gather_rows(t64).tolist(),
        local_rows=t32.tolist(),
        shard_ids=mesh.shard_ids().tolist())


@pytest.mark.parametrize("what", ["a2a_int32", "a2a_int64", "local_rows",
                                  "shard_ids"])
@pytest.mark.parametrize("world", WORLDS)
def test_mesh_rows_match_stacked(runs, world, what):
    """Process r's row is row r of the stacked mesh's result."""
    want = _stacked_units(world)[what]
    for rank, got in enumerate(runs[world]):
        assert got["rank"] == rank and got["shards"] == world
        assert got["units"][what] == [want[rank]]


@pytest.mark.parametrize("what", ["psum", "psum_bool", "pmax",
                                  "gather_rows"])
@pytest.mark.parametrize("world", WORLDS)
def test_mesh_reductions_match_stacked(runs, world, what):
    """Every process holds the stacked mesh's whole result."""
    want = _stacked_units(world)[what]
    for got in runs[world]:
        assert got["units"][what] == want


@pytest.mark.parametrize("name,packed", [
    (name, int(p)) for name in NAMES for p in PACKED[name]])
@pytest.mark.parametrize("world", WORLDS)
def test_count_engine_matches_jax(runs, world, name, packed):
    want = runs["jax"][f"counts/{name}/{world}/{packed}"]
    for got in runs[world]:
        assert got["engines"][f"counts/{name}/{packed}"] == want
    r = distributed_pagerank_counts(_graph(name), EPS, K, prng.PRNGKey(0),
                                    mesh=StackedMesh(world, "cpu"),
                                    packed=bool(packed))
    assert (list(r.occupancy), r.residual) == (want["occupancy"],
                                               want["residual"])


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("world", WORLDS)
def test_walk_engine_matches_jax(runs, world, name):
    want = runs["jax"][f"walks/{name}/{world}"]
    assert want["dropped"] == 0
    for got in runs[world]:
        assert got["engines"][f"walks/{name}"] == want


@pytest.mark.parametrize("world", WORLDS)
def test_walk_engine_work_cap_matches_jax(runs, world):
    want = runs["jax"][f"work_cap/er/{world}"]
    assert want["rounds"] > runs["jax"][f"walks/er/{world}"]["rounds"]
    for got in runs[world]:
        assert got["engines"]["work_cap/er"] == want


def test_packed_guard_raises_on_every_process(runs):
    """The hub receives past 2 x 32767 remote counts on one process only;
    the guard's pmax makes both raise, and neither hangs."""
    assert [got["packed_guard"] for got in runs[2]] == [True, True]


def _host(flat):
    return {k: v for k, v in unpack_json(flat.pop("host")).items()
            if k != "sampler_us"}


def test_kill_snapshots_equal_stacked(runs, tmp_path):
    """Killed at 4 processes, the snapshots are the stacked run's at 4
    shards file for file, written once."""
    assert all(got["kill"] for got in runs[4])
    g = erdos_renyi(KILL["n"], 5.0, seed=1, device="cpu")
    d = str(tmp_path / "stacked")
    with pytest.raises(SimulatedFailure):
        distributed_pagerank_counts(
            g, EPS, KILL["K"], prng.PRNGKey(KILL["seed"]),
            mesh=StackedMesh(4, "cpu"), checkpoint_dir=d,
            fail_at=[KILL["fail_at"]], checkpoint_every=2, max_restarts=0)
    want, got = Checkpointer(d), Checkpointer(str(runs["tmp"] / "kill"))
    assert got.all_steps() == want.all_steps() == [0, 2]
    for step in want.all_steps():
        wflat, wm = want.restore(step)
        gflat, gm = got.restore(step)
        assert gm["metadata"] == wm["metadata"] == dict(shards=4)
        # the host leaf's length follows the sampler's wall time
        assert {k: v for k, v in gm["keys"].items() if k != "host"} == {
            k: v for k, v in wm["keys"].items() if k != "host"}
        assert _host(gflat) == _host(wflat)
        assert sorted(gflat) == sorted(wflat)
        for k in wflat:
            np.testing.assert_array_equal(gflat[k], wflat[k], err_msg=k)
    assert sorted(os.listdir(runs["tmp"] / "kill")) == sorted(
        os.listdir(d))


def test_resume_at_other_process_count_bit_exact(runs):
    """The 4-process kill resumed at 2 processes equals the stacked
    unfailed run and the stacked resume at 2 shards."""
    g = erdos_renyi(KILL["n"], 5.0, seed=1, device="cpu")
    ref = distributed_pagerank_counts(g, EPS, KILL["K"],
                                      prng.PRNGKey(KILL["seed"]),
                                      mesh=StackedMesh(4, "cpu"))
    for got in runs[2]:
        r = got["resume"]
        assert r["zeta"] == ref.zeta.tolist() and r["rounds"] == ref.rounds
        assert r["shards"] == 2 and r["restarts"] == 0


@pytest.mark.parametrize("algo", LAUNCH_ALGOS)
def test_launcher_under_processes_matches_stacked(runs, algo):
    want = launch.run(*LAUNCH, None, [3], algo=algo, shards=2, device="cpu")
    assert want.restarts == 1
    for got in runs[2]:
        r = got["launcher"][algo]
        assert r["pi"] == want.pi.tolist()
        assert (r["rounds"], r["restarts"], r["shards"]) == (
            want.rounds, want.restarts, 2)


def test_launcher_shards_must_equal_world_size(runs):
    for got in runs[2]:
        assert "differs from the world size 2" in got["launcher"][
            "wrong_shards"]


@pytest.mark.parametrize("engine", ["walks", "counts"])
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
