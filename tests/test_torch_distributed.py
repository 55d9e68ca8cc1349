"""The port's sharded engines on a stacked mesh against the JAX package's
shard_map engines on forced host devices.

One subprocess runs the JAX engines with 8 forced host devices and prints
JSON; it starts with the module, and the port runs the same cases in
process on the CPU, with P shards stacked on one device, while it runs. Cases: both engines on the six shared fixtures at
P=8, and on two fixtures at P in {1, 3} (uneven padding); the count
engine with packed and unpacked lanes. eps = 0.2, K = 8, key PRNGKey(0).
The walk engine's `work_cap` straggler bound on erdos_renyi(64, 4), K = 4,
at P in {1, 3}.

Parity level: bit-exact — zeta, rounds, dropped, waited, round_active,
a2a entries and bytes (walks); zeta, rounds, a2a entries and bytes,
lane_cap, overflow, occupancy and residual (counts). Also bit-exact: the
sharded count engine's zeta equals the single-device count engine's for
the same key at any shard count (the draws are counter-based per global
vertex id). The shard layouts (CSR cuts, the padded adjacency, the
bucketed sampler layout and lane bounds) equal the JAX package's exactly.
The packed lanes' two limits raise instead of dropping counts.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core.distributed import shard_graph as j_shard_graph
from repro.core.distributed_counts import \
    shard_graph_padded as j_shard_graph_padded

from conftest import REPO_SRC, SMALL_GRAPHS_SRC
from repro_torch import convert, prng
from repro_torch.core import simple_pagerank
from repro_torch.core.collectives import StackedMesh
from repro_torch.core.distributed import distributed_pagerank, shard_graph
from repro_torch.core.distributed_counts import (distributed_pagerank_counts,
                                                 shard_graph_padded)
from repro_torch.core.graph import from_edges
from repro_torch.graphs import erdos_renyi, ring

EPS, K = 0.2, 8
WORK_CAP_SHARDS = [1, 3]
NAMES = ["ring", "grid", "er", "ba", "ba_hub", "dweb"]
CASES = [(name, 8) for name in NAMES] + [
    (name, p) for name in ("er", "dweb") for p in (1, 3)]

JAX_RUNS = SMALL_GRAPHS_SRC + """
import json
import jax, numpy as np
from jax.sharding import Mesh
from repro.core.distributed import distributed_pagerank
from repro.core.distributed_counts import distributed_pagerank_counts
out = {}
for name, P in %r:
    g = graphs[name]
    mesh = Mesh(np.array(jax.devices()[:P]), ("shards",))
    key = jax.random.PRNGKey(0)
    r = distributed_pagerank(g, %r, %r, key, mesh=mesh)
    out[f"walks/{name}/{P}"] = dict(
        zeta=np.asarray(r.zeta).tolist(), rounds=r.rounds,
        dropped=r.dropped, waited=r.waited, round_active=r.round_active,
        entries=r.a2a_entries_total, bytes=r.a2a_bytes_total)
    for packed in (True, False):
        r = distributed_pagerank_counts(g, %r, %r, key, mesh=mesh,
                                        packed=packed)
        out[f"counts/{name}/{P}/{int(packed)}"] = dict(
            zeta=np.asarray(r.zeta).tolist(), rounds=r.rounds,
            entries=r.a2a_entries_total, bytes=r.a2a_bytes_total,
            lane_cap=r.lane_cap, overflow=r.overflow,
            occupancy=list(r.occupancy), residual=r.residual)
from repro.graphs import erdos_renyi
g = erdos_renyi(64, 4.0, seed=0)
for P in %r:
    mesh = Mesh(np.array(jax.devices()[:P]), ("shards",))
    r = distributed_pagerank(g, %r, 4, jax.random.PRNGKey(0), mesh=mesh,
                             work_cap=8)
    out[f"work_cap/{P}"] = dict(
        zeta=np.asarray(r.zeta).tolist(), rounds=r.rounds,
        dropped=r.dropped, waited=r.waited, round_active=r.round_active,
        entries=r.a2a_entries_total, bytes=r.a2a_bytes_total)
print(json.dumps(out))
""" % (CASES, EPS, K, EPS, K, WORK_CAP_SHARDS, EPS)


@pytest.fixture(scope="module", autouse=True)
def jax_proc():
    """The JAX subprocess (8 forced host devices), started with the module
    so that it runs beside every port case."""
    env = dict(os.environ, PYTHONPATH=REPO_SRC,
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    proc = subprocess.Popen([sys.executable, "-c", JAX_RUNS], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def graphs(small_graphs):
    """The shared fixtures as port graphs on the CPU."""
    return {name: convert.graph_from_numpy(
        np.asarray(g.row_ptr), np.asarray(g.col_idx), np.asarray(g.out_deg),
        g.n, g.m, g.undirected, device="cpu")
        for name, g in small_graphs.items()}


def _walk_summary(r):
    return dict(zeta=r.zeta.tolist(), rounds=r.rounds, dropped=r.dropped,
                waited=r.waited, round_active=r.round_active,
                entries=r.a2a_entries_total, bytes=r.a2a_bytes_total)


def _count_summary(r):
    return dict(zeta=r.zeta.tolist(), rounds=r.rounds,
                entries=r.a2a_entries_total, bytes=r.a2a_bytes_total,
                lane_cap=r.lane_cap, overflow=r.overflow,
                occupancy=list(r.occupancy), residual=r.residual)


def _port_cases(graphs):
    """The port's run of every case the JAX subprocess runs, by its label:
    (summary, shards of the run) or the exception the run raised."""
    jobs = {}
    for name, P in CASES:
        jobs[f"walks/{name}/{P}"] = (
            _walk_summary, distributed_pagerank, graphs[name], K, {}, P)
        for packed in (True, False):
            jobs[f"counts/{name}/{P}/{int(packed)}"] = (
                _count_summary, distributed_pagerank_counts, graphs[name], K,
                dict(packed=packed), P)
    g = erdos_renyi(64, 4.0, seed=0, device="cpu")
    for P in WORK_CAP_SHARDS:
        jobs[f"work_cap/{P}"] = (_walk_summary, distributed_pagerank, g, 4,
                                 dict(work_cap=8), P)
    port = {}
    for label, (summary, fn, graph, walks, kw, P) in jobs.items():
        try:
            r = fn(graph, EPS, walks, prng.PRNGKey(0),
                   mesh=StackedMesh(P, "cpu"), **kw)
            port[label] = (summary(r), r.shards)
        except Exception as e:      # raised again by its test
            port[label] = e
    return port


@pytest.fixture(scope="module")
def runs(jax_proc, graphs):
    """{"jax": the JAX subprocess's JSON, "port": `_port_cases`}: the
    port's cases run here while the subprocess runs."""
    port = _port_cases(graphs)
    try:
        out, err = jax_proc.communicate(timeout=900)
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
            jax_proc.communicate()
    assert jax_proc.returncode == 0, err[-3000:]
    return dict(jax=json.loads(out.strip().splitlines()[-1]), port=port)


@pytest.fixture(scope="module")
def jax_runs(runs):
    return runs["jax"]


def port_run(runs, label):
    """The port's (summary, shards) of the case `label`, or what it
    raised."""
    got = runs["port"][label]
    if isinstance(got, Exception):
        raise got
    return got


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("shards", [1, 3, 8])
def test_shard_layouts_match_jax(small_graphs, graphs, name, shards):
    jg, tg = small_graphs[name], graphs[name]
    a, b = shard_graph(tg, shards), j_shard_graph(jg, shards)
    for f in ("row_ptr", "col_idx", "out_deg"):
        np.testing.assert_array_equal(getattr(a, f).numpy(),
                                      np.asarray(getattr(b, f)))
    a, b = shard_graph_padded(tg, shards), j_shard_graph_padded(jg, shards)
    assert (a.n_loc, a.max_deg, a.lane_cap) == (b.n_loc, b.max_deg,
                                                 b.lane_cap)
    assert (a.layout.widths, a.layout.caps, a.layout.n_rows) == (
        b.layout.widths, b.layout.caps, b.layout.n_rows)
    for f in ("deg", "bperm", "bnbr"):
        np.testing.assert_array_equal(getattr(a, f).numpy(),
                                      np.asarray(getattr(b, f)))


@pytest.mark.parametrize("name,shards", CASES)
def test_walk_engine_bit_exact(runs, jax_runs, name, shards):
    got, r_shards = port_run(runs, f"walks/{name}/{shards}")
    want = jax_runs[f"walks/{name}/{shards}"]
    assert got == want
    assert got["dropped"] == 0 and r_shards == shards


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("name,shards", CASES)
def test_count_engine_bit_exact(runs, jax_runs, graphs, name, shards,
                                packed):
    g = graphs[name]
    got, _ = port_run(runs, f"counts/{name}/{shards}/{int(packed)}")
    want = jax_runs[f"counts/{name}/{shards}/{int(packed)}"]
    assert got == want
    single = simple_pagerank(g, EPS, walks_per_node=K, key=prng.PRNGKey(0),
                             engine="counts", device="cpu")
    np.testing.assert_array_equal(np.asarray(got["zeta"], np.int32),
                                  single.zeta.numpy())
    assert got["rounds"] == single.logical_rounds


def test_packed_lanes_refuse_wide_shards():
    """n_loc > 65536 does not fit a packed lane's 16-bit local id."""
    g = ring(2 * 65536 + 2, device="cpu")
    with pytest.raises(ValueError, match="packed=False"):
        distributed_pagerank_counts(g, EPS, 1, prng.PRNGKey(0),
                                    mesh=StackedMesh(2, "cpu"))


def _hub_graph():
    """Vertices 0..31 (shard 0 of 2) all link to vertex 32 (shard 1), which
    links back to 0; 33..63 form a path."""
    src = np.concatenate([np.arange(32), [32], np.arange(33, 63), [63]])
    dst = np.concatenate([np.full(32, 32), [0], np.arange(34, 64), [33]])
    return from_edges(src, dst, 64, device="cpu")


def test_packed_lanes_refuse_large_counts():
    """With K = 5000 the hub receives ~128,000 remote counts in the first
    round, past the 2 x 32767 a packed vertex carries: the run raises, and
    the unpacked lanes give the single-device count engine's zeta."""
    g = _hub_graph()
    mesh = StackedMesh(2, "cpu")
    with pytest.raises(RuntimeError, match="packed=False"):
        distributed_pagerank_counts(g, EPS, 5000, prng.PRNGKey(1), mesh=mesh)
    r = distributed_pagerank_counts(g, EPS, 5000, prng.PRNGKey(1), mesh=mesh,
                                    packed=False)
    single = simple_pagerank(g, EPS, walks_per_node=5000, key=prng.PRNGKey(1),
                             engine="counts", device="cpu")
    np.testing.assert_array_equal(r.zeta.numpy(), single.zeta.numpy())
    assert r.overflow == 0 and r.residual == 0
    assert int(r.zeta[32]) > 2 * 32767


def test_one_shard_packed_has_no_limit():
    """One shard sends nothing over the wire, so packing limits nothing."""
    g = _hub_graph()
    r = distributed_pagerank_counts(g, EPS, 5000, prng.PRNGKey(1),
                                    mesh=StackedMesh(1, "cpu"))
    assert r.a2a_entries_total == 0 and r.residual == 0


@pytest.mark.parametrize("shards", WORK_CAP_SHARDS)
def test_work_cap_bit_exact(runs, jax_runs, shards):
    """`work_cap=8` steps at most 8 owned walks a shard in a round: on
    erdos_renyi(64, 4) with K = 4 the JAX engine takes 161 rounds at one
    shard (25 without the cap); the port matches it bit for bit."""
    g = erdos_renyi(64, 4.0, seed=0, device="cpu")
    got, _ = port_run(runs, f"work_cap/{shards}")
    want = jax_runs[f"work_cap/{shards}"]
    assert got == want
    if shards == 1:
        assert got["rounds"] == 161
        free = distributed_pagerank(g, EPS, 4, prng.PRNGKey(0),
                                    mesh=StackedMesh(1, "cpu"))
        assert free.rounds == 25


def test_entry_points_need_a_card_or_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    g = _hub_graph()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        distributed_pagerank(g, EPS, 2, prng.PRNGKey(0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        distributed_pagerank_counts(g, EPS, 2, prng.PRNGKey(0))
