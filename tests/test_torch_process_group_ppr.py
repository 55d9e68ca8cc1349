"""Personalized PageRank with one shard per process
(`core.collectives.ProcessGroupMesh`): the batched engine, the query
service with `resize`, and the launcher's `--algo ppr` and `--audit`,
against the JAX package's `shard_map` engine and service at the same
shard count, and against `StackedMesh` at that count.

The port's side runs in gloo groups of 4 and 2 spawned processes on the
CPU, one after the other, through `tests/test_torch_process_group.py`'s
`run_group` (a `FileStore` under the test's temporary directory, a 60 s
group timeout, every process killed past the join timeout, one torch
thread a process). The JAX side is one subprocess on 8 forced host
devices, `Mesh(devices[:P])`, running beside the groups. Fixtures: the
batched engine on barabasi_albert(80, 3, seed=4), eps 0.25, the three
queries of tests/test_torch_personalized.py, 1500 walks a query, key
PRNGKey(2); the service trace of tests/test_torch_elastic.py
(erdos_renyi(96, 5.0, seed=1), 2 slots, 4096 walks a query, 4 -> 2),
continued 2 -> 4.

Parity level 1 (bit-exact) throughout:
  * the batched engine at 4 and 2 processes: every vector, rounds, the
    live-walk trace, lane entries, wire bytes, dropped and admit_dropped
    equal to JAX's and to the stacked run's;
  * the service 4 -> 2 -> 4: every result, counter and cache hit equal
    to JAX's service under the same resizes and to the stacked one; its
    host state (queue, slot map, statistics, cache keys and times, the
    engine's live walks and telemetry) equal on every serving process
    after each step, and to the stacked service's; the processes left
    out by the shrink say so, and are taken back by the grow;
  * the wall clock is rank 0's on every process;
  * `launch.pagerank.run(algo="ppr")` under 2 processes equal to
    `run(shards=2)`, and a failed `--check` exits on both processes;
  * `--audit` under 4 processes: the `ppr` row equal to the stacked
    audit's at 4 shards, with 0 violations.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import REPO_SRC
from repro_torch import prng
from repro_torch.analysis.congest import audit_all_engines
from repro_torch.core.collectives import StackedMesh
from repro_torch.core.personalized_batch import (
    batched_personalized_pagerank, check_virtual_ids)
from repro_torch.graphs import barabasi_albert, erdos_renyi
from repro_torch.launch import pagerank as launch
from repro_torch.serve import PPRService
from test_torch_process_group import run_group

EPS, WALKS = 0.25, 1500
QUERIES = [([0, 5], None), ([17], None), ([3, 40], [0.8, 0.2])]
WORLDS = (4, 2)
SERVE = dict(slots=2, walks_per_query=4096)
# the launcher: erdos_renyi(64), 64 walks a node for each of 3 queries;
# 1 walk a node misses the check
LAUNCH = (64, EPS, 64, "erdos_renyi")
LAUNCH_MISS = (64, EPS, 1, "erdos_renyi")
AUDIT_EPS = 0.2         # the launcher's default
RESULT_FIELDS = ("rounds", "active_trace", "a2a_entries", "a2a_bytes",
                 "dropped", "admit_dropped", "shards")

# the service's trace, the same on both packages: `resize(svc, k)` moves
# it onto k shards, `serving(svc)` says whether this process holds one,
# `after_step(svc)` records each step's state
TRACE = """
def trace(svc, resize, serving, after_step):
    reqs = dict(r1=svc.submit([3], now=0.0), r2=svc.submit([10, 17], now=0.0))
    parts = {}

    def drain():
        while svc.busy:
            svc.step(now=0.0)
            after_step(svc)

    for _ in range(2):
        svc.step(now=0.0)
        after_step(svc)
    resize(svc, 2)
    if serving(svc):
        reqs["r3"] = svc.submit([5], now=0.0)
        drain()
        reqs["hit"] = svc.submit([3], now=0.0)
        parts["shrunk"] = stats(svc)
        reqs["r4"] = svc.submit([7], now=0.0)
        reqs["r5"] = svc.submit([20, 30], now=0.0)
        for _ in range(2):
            svc.step(now=0.0)
            after_step(svc)
    resize(svc, 4)
    reqs["r6"] = svc.submit([11], now=0.0)
    drain()
    reqs["hit2"] = svc.submit([20, 30], now=0.0)
    parts["grown"] = stats(svc)
    return reqs, parts

STAT_FIELDS = ("submitted", "admitted", "completed", "cache_hits",
               "refreshes", "rejected", "supersteps", "max_active_queries",
               "dropped_walks", "admit_dropped", "a2a_bytes")

def stats(svc):
    return {f: getattr(svc.stats, f) for f in STAT_FIELDS}

def requests(reqs):
    return {name: dict(result=None if r.result is None
                       else np.asarray(r.result).tolist(),
                       cached=r.cached, done=r.done, rid=r.rid)
            for name, r in reqs.items()}
"""

JAX_CODE = """
import json
from concurrent.futures import ThreadPoolExecutor
import jax, numpy as np
from jax.sharding import Mesh
from repro.core.personalized_batch import batched_personalized_pagerank
from repro.graphs import barabasi_albert, erdos_renyi
from repro.serve.ppr_service import PPRService
EPS, WALKS, QUERIES, WORLDS, SERVE, RESULT_FIELDS = %r, %r, %r, %r, %r, %r
""" % (EPS, WALKS, QUERIES, WORLDS, SERVE, RESULT_FIELDS) + TRACE + """
def mesh(P):
    return Mesh(np.array(jax.devices()[:P]), ("shards",))

def batched(P):
    r = batched_personalized_pagerank(
        barabasi_albert(80, 3, seed=4), EPS, QUERIES, WALKS,
        jax.random.PRNGKey(2), mesh=mesh(P))
    out = {f: getattr(r, f) for f in RESULT_FIELDS}
    out.update(ppr=np.asarray(r.ppr).tolist())
    return f"batched/{P}", out

def serve(_):
    svc = PPRService(erdos_renyi(96, 5.0, seed=1), EPS, mesh=mesh(4),
                     **SERVE)
    reqs, parts = trace(svc, lambda s, k: s.resize(mesh=mesh(k)),
                        lambda s: True, lambda s: None)
    return "serve", dict(requests=requests(reqs), parts=parts)

with ThreadPoolExecutor(3) as pool:
    jobs = [pool.submit(batched, P) for P in WORLDS]
    jobs.append(pool.submit(serve, None))
    print(json.dumps(dict(j.result() for j in jobs)))
"""

# the cases every process of a group runs (`run_group`'s body)
CHILD = """
from repro_torch import prng
from repro_torch.core.collectives import ProcessGroupMesh
from repro_torch.core.personalized_batch import batched_personalized_pagerank
from repro_torch.graphs import barabasi_albert, erdos_renyi
from repro_torch.launch import pagerank as launch
from repro_torch.serve import PPRService
(EPS, WALKS, QUERIES, SERVE, RESULT_FIELDS, LAUNCH, LAUNCH_MISS, AUDIT_EPS,
 TMP) = %(consts)r
""" + TRACE + """
mesh = ProcessGroupMesh(device="cpu")
out = dict(rank=mesh.rank, shards=mesh.shards)

def host_state(svc):
    e = svc.engine
    return dict(
        pending=[r.rid for r in svc.pending],
        slots=[None if r is None else r.rid for r in svc._slot_req],
        refreshing=sorted(map(repr, svc._refreshing)),
        next_rid=svc._next_rid, stats=stats(svc),
        cache=[[repr(k), t] for k, t in svc.cache.times()],
        cache_counts=[svc.cache.hits, svc.cache.misses],
        shards=e.shards, cap=e.cap, active=e.active.tolist(),
        telemetry=[getattr(e, f) for f in e.TELEMETRY])

def batched():
    r = batched_personalized_pagerank(
        barabasi_albert(80, 3, seed=4, device="cpu"), EPS, QUERIES, WALKS,
        prng.PRNGKey(2), mesh=mesh)
    res = {f: getattr(r, f) for f in RESULT_FIELDS}
    res.update(ppr=r.ppr.tolist())
    return res

def service():
    svc = PPRService(erdos_renyi(96, 5.0, seed=1, device="cpu"), EPS,
                     mesh=mesh, **SERVE)
    states, serving = {}, []

    def resize(s, k):
        s.resize(shards=k)
        serving.append(s.serving)

    def after_step(s):
        states[s.stats.supersteps] = host_state(s)

    reqs, parts = trace(svc, resize, lambda s: s.serving, after_step)
    return dict(requests=requests(reqs), parts=parts, states=states,
                serving=serving)

def clock():
    svc = PPRService(erdos_renyi(96, 5.0, seed=1, device="cpu"), EPS,
                     mesh=mesh, slots=2, walks_per_query=256)
    r = svc.submit([3])
    svc.drain()
    hit = svc.submit([3])
    return dict(times=[r.t_submit, r.t_admit, r.t_done, hit.t_submit],
                cached=hit.cached, has_result=r.result is not None)

def explicit():
    # the explicit form: rank 0 alone on its own group's mesh, rank 1
    # leaving, then both taken back by shards=2
    import torch.distributed as dist
    svc = PPRService(erdos_renyi(96, 5.0, seed=1, device="cpu"), EPS,
                     mesh=mesh, slots=2, walks_per_query=512)
    reqs = [svc.submit([3], now=0.0)]
    svc.step(now=0.0)
    group = dist.new_group([0])
    if mesh.rank == 0:
        svc.resize(mesh=ProcessGroupMesh(group=group, device="cpu"))
        reqs.append(svc.submit([5], now=0.0))
        svc.drain(now=0.0)
    else:
        svc.resize(leave=True)
    served = svc.serving
    svc.resize(shards=2)
    reqs.append(svc.submit([7], now=0.0))
    svc.drain(now=0.0)
    return dict(served=served, stats=stats(svc),
                results=[None if r.result is None else r.result.tolist()
                         for r in reqs])

def launcher():
    res = dict(ppr=launch.run(*LAUNCH, None, [], algo="ppr", num_queries=3,
                              check=True, device="cpu").tolist())
    try:
        launch.run(*LAUNCH_MISS, None, [], algo="ppr", num_queries=3,
                   check=True, device="cpu")
        res["miss"] = "ran"
    except SystemExit as e:
        res["miss"] = str(e)
    return res

def audit():
    os.chdir(TMP)
    try:
        launch.main(["--audit", "--device", "cpu", "--eps", str(AUDIT_EPS)])
    except SystemExit as e:
        return dict(exit=str(e))
    if not mesh.writer:
        return dict(report=None, exit=None)
    with open("AUDIT.json") as f:
        return dict(report=json.load(f), exit=None)
"""

CASES = {4: ["batched", "service", "audit"],
         2: ["batched", "clock", "explicit", "launcher"]}


@pytest.fixture(scope="module")
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, one_torch_thread):
    """The JAX subprocess and the two groups: {"jax": ..., world:
    [per-process JSON]}."""
    tmp = tmp_path_factory.mktemp("process_group_ppr")
    env = dict(os.environ, PYTHONPATH=REPO_SRC,
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    log = open(tmp / "jax.log", "w+")
    jax_proc = subprocess.Popen([sys.executable, "-c", JAX_CODE], env=env,
                                stdout=log, stderr=subprocess.STDOUT,
                                text=True)
    body = CHILD % dict(consts=(EPS, WALKS, QUERIES, SERVE, RESULT_FIELDS,
                                LAUNCH, LAUNCH_MISS, AUDIT_EPS, str(tmp)))
    out = {}
    try:
        for world in WORLDS:
            out[world] = run_group(world, CASES[world], tmp, body=body)
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


def _stacked_batched(P):
    r = batched_personalized_pagerank(
        barabasi_albert(80, 3, seed=4, device="cpu"), EPS, QUERIES, WALKS,
        prng.PRNGKey(2), mesh=StackedMesh(P, "cpu"))
    out = {f: getattr(r, f) for f in RESULT_FIELDS}
    out.update(ppr=r.ppr.tolist())
    return out


def _trace_namespace():
    ns = dict(np=np)
    exec(TRACE, ns)
    return ns


@pytest.fixture(scope="module")
def stacked_service():
    """The trace on stacked shards in this process, with the host state
    of each step as the child records it."""
    ns = _trace_namespace()
    svc = PPRService(erdos_renyi(96, 5.0, seed=1, device="cpu"), EPS,
                     mesh=StackedMesh(4, "cpu"), **SERVE)
    states = {}

    def after_step(s):
        e = s.engine
        states[s.stats.supersteps] = dict(
            pending=[r.rid for r in s.pending],
            slots=[None if r is None else r.rid for r in s._slot_req],
            refreshing=sorted(map(repr, s._refreshing)),
            next_rid=s._next_rid, stats=ns["stats"](s),
            cache=[[repr(k), t] for k, t in s.cache.times()],
            cache_counts=[s.cache.hits, s.cache.misses],
            shards=e.shards, cap=e.cap, active=e.active.tolist(),
            telemetry=[getattr(e, f) for f in e.TELEMETRY])

    reqs, parts = ns["trace"](svc, lambda s, k: s.resize(shards=k),
                              lambda s: True, after_step)
    return dict(requests=ns["requests"](reqs), parts=parts,
                states={str(k): v for k, v in states.items()})


@pytest.mark.parametrize("world", WORLDS)
def test_batched_matches_jax_and_stacked(runs, world):
    want = runs["jax"][f"batched/{world}"]
    assert want["dropped"] == 0 and want["admit_dropped"] == 0
    assert want["active_trace"][-1] == 0
    stacked = _stacked_batched(world)
    assert stacked == want
    for got in runs[world]:
        assert got["rank"] < world and got["shards"] == world
        assert got["batched"] == want


def test_service_matches_jax(runs):
    """Every result, counter and cache hit of the trace equals JAX's
    service under the same resizes; rank 0 holds the vectors."""
    want = runs["jax"]["serve"]
    got = runs[4][0]["service"]
    assert got["requests"] == want["requests"]
    assert got["parts"] == want["parts"]
    assert want["parts"]["grown"]["completed"] == 6
    assert want["parts"]["grown"]["cache_hits"] == 2
    assert want["parts"]["grown"]["dropped_walks"] == 0
    reqs = want["requests"]
    assert reqs["hit"]["cached"] and reqs["hit2"]["cached"]
    assert reqs["hit"]["result"] == reqs["r1"]["result"]
    assert reqs["hit2"]["result"] == reqs["r5"]["result"]


def test_service_matches_stacked(runs, stacked_service):
    """Rank 0's results and every step's host state equal the stacked
    service's under the same resizes."""
    got = runs[4][0]["service"]
    assert got["requests"] == stacked_service["requests"]
    assert got["parts"] == stacked_service["parts"]
    assert got["states"] == stacked_service["states"]


def test_service_host_state_equal_on_every_rank(runs):
    """After each step, each serving process's host state is rank 0's;
    the processes the shrink left out skip its steps, say so, and after
    the grow agree again. Only rank 0 holds vectors."""
    outs = [o["service"] for o in runs[4]]
    steps = outs[0]["states"]
    assert [o["serving"] for o in outs] == [[True, True], [True, True],
                                           [False, True], [False, True]]
    for rank, o in enumerate(outs):
        for step, state in o["states"].items():
            assert state == steps[step], (rank, step)
        if rank >= 2:
            assert len(o["states"]) < len(steps)
            assert "shrunk" not in o["parts"]
        else:
            assert o["states"].keys() == steps.keys()
        assert o["parts"]["grown"] == outs[0]["parts"]["grown"]
        for name in ("r6", "hit2"):
            r, w = o["requests"][name], outs[0]["requests"][name]
            assert (r["cached"], r["done"], r["rid"]) == (
                w["cached"], w["done"], w["rid"])
            assert (r["result"] is None) == (rank > 0)


def test_wall_clock_is_rank_zeros(runs):
    a, b = (o["clock"] for o in runs[2])
    assert a["times"] == b["times"] and a["cached"] and b["cached"]
    assert a["has_result"] and not b["has_result"]


def test_explicit_resize_matches_stacked(runs):
    """`resize(mesh=)` onto rank 0's own group, the other process passing
    `leave=True`, then `shards=2`: the stacked service's answers under
    the same shard counts."""
    ns = _trace_namespace()
    svc = PPRService(erdos_renyi(96, 5.0, seed=1, device="cpu"), EPS,
                     mesh=StackedMesh(2, "cpu"), slots=2, walks_per_query=512)
    reqs = [svc.submit([3], now=0.0)]
    svc.step(now=0.0)
    svc.resize(mesh=StackedMesh(1, "cpu"))
    reqs.append(svc.submit([5], now=0.0))
    svc.drain(now=0.0)
    svc.resize(shards=2)
    reqs.append(svc.submit([7], now=0.0))
    svc.drain(now=0.0)
    a, b = (o["explicit"] for o in runs[2])
    assert (a["served"], b["served"]) == (True, False)
    assert a["stats"] == b["stats"] == ns["stats"](svc)
    assert a["results"] == [r.result.tolist() for r in reqs]
    assert b["results"][-1] is None


def test_launcher_ppr_under_processes_matches_stacked(runs):
    want = launch.run(*LAUNCH, None, [], algo="ppr", num_queries=3,
                      check=True, shards=2, device="cpu")
    for got in runs[2]:
        assert got["launcher"]["ppr"] == want.tolist()


def test_launcher_ppr_check_fails_on_every_process(runs):
    with pytest.raises(SystemExit) as err:
        launch.run(*LAUNCH_MISS, None, [], algo="ppr", num_queries=3,
                   check=True, shards=2, device="cpu")
    msg = str(err.value)
    assert "ppr check FAILED" in msg
    assert [got["launcher"]["miss"] for got in runs[2]] == [msg, msg]


def test_launcher_audit_under_processes_matches_stacked(runs):
    """`--audit` under 4 processes: every engine clean, the ppr row equal
    to the stacked audit's at 4 shards."""
    want = audit_all_engines(StackedMesh(4, "cpu"), eps=AUDIT_EPS,
                             engines=("ppr",))["engines"]["ppr"]
    assert want["violations"] == []
    assert [o["audit"]["exit"] for o in runs[4]] == [None] * 4
    rep = runs[4][0]["audit"]["report"]
    assert rep["ok"] and rep["violations_total"] == 0
    assert rep["devices"] == 4
    got = rep["engines"]["ppr"]
    for field in ("sites", "resume", "w_independent", "telemetry", "meta",
                  "fixture", "violations", "psum_sites", "psum_max_bytes"):
        assert got[field] == want[field], field


@pytest.mark.parametrize("local_shards, raises", [(1, False), (4, True)])
def test_virtual_id_guard_counts_local_rows(local_shards, raises):
    """P = 4 shards of n_pad = 2^20 with 512 query slots: 2^29 virtual
    ids, 2^31 segment ids when all four shards are stacked on one device,
    2^29 on a process that holds one. The guard counts the rows a process
    holds; n_pad * Q past int32 raises either way."""
    n_pad, Q = 1 << 20, 512
    if raises:
        with pytest.raises(ValueError, match="4 local shards"):
            check_virtual_ids(n_pad, Q, local_shards)
    else:
        check_virtual_ids(n_pad, Q, local_shards)
    with pytest.raises(ValueError, match="virtual vertex ids"):
        check_virtual_ids(n_pad, 4 * Q, local_shards)
