"""Checkpoint/restart in the port: the snapshot format, failure recovery of
both sharded engines, and snapshots carried between the two packages.

Parity levels:
  * the Checkpointer round trip — exact (dtypes and values), and the same
    flat keys, shapes and dtypes as the JAX package's Checkpointer writes;
  * `fail_at` recovery — bit-exact with the uninterrupted run, both
    engines (the state carries the PRNG keys);
  * a snapshot the JAX engines wrote (stopped by an injected failure with
    max_restarts=0), resumed by the port — bit-exact with the
    uninterrupted JAX run (counts engine: zeta; walk engine: pi);
  * the count engine killed at P shards and resumed at P' != P —
    bit-exact (its round key is the same on every shard);
  * the walk state's re-layout and the re-derived shard keys — bit-exact
    against the JAX package's `relayout_pagerank_state`; a walk run
    resumed at another shard count draws fresh keys, so it is held to the
    accuracy gate (statistical) with nothing dropped;
  * `Supervisor(async_checkpoints=True)` — the walk engine recovered from
    injected failures, and killed and resumed, with its periodic snapshots
    written in the background: bit-exact with the blocking run and with
    the JAX package's uninterrupted run.
"""
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import Checkpointer as JaxCheckpointer
from repro.checkpoint import relayout_pagerank_state as j_relayout

from conftest import run_forced_devices
from repro_torch import convert, prng
from repro_torch.checkpoint import (Checkpointer, relayout_pagerank_state,
                                    restore_into)
from repro_torch.core.collectives import StackedMesh
from repro_torch.core.distributed import (init_state, shard_graph,
                                          state_from_host, state_to_host,
                                          superstep)
from repro_torch.core.distributed_counts import distributed_pagerank_counts
from repro_torch.graphs import directed_web, erdos_renyi
from repro_torch.launch.pagerank import run, run_walks
from repro_torch.runtime import (FailureSchedule, SimulatedFailure,
                                 Supervisor)

EPS, K = 0.2, 8


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return dict(a=torch.randn(8, 4, generator=g),
                nested=dict(b=torch.randn(3, generator=g).to(torch.bfloat16),
                            step=torch.tensor(7, dtype=torch.int32),
                            key=prng.PRNGKey(3)))


def test_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path))
    tree = _tree()
    ck.save(5, tree, metadata=dict(note="x"))
    flat, manifest = ck.restore()
    assert manifest["step"] == 5 and manifest["metadata"] == dict(note="x")
    restored = restore_into(tree, flat)
    for path in (("a",), ("nested", "b"), ("nested", "step"),
                 ("nested", "key")):
        a, b = tree, restored
        for k in path:
            a, b = a[k], b[k]
        assert b.dtype == a.dtype
        assert torch.equal(a, b)


def test_async_and_gc(tmp_path):
    ck = Checkpointer(str(tmp_path), keep_last=2)
    for s in (1, 2, 3, 4):
        ck.save(s, _tree(s), blocking=False)
    ck.wait()
    assert ck.all_steps() == [3, 4]
    assert ck.latest_step() == 4


def test_restore_specific_step(tmp_path):
    ck = Checkpointer(str(tmp_path), keep_last=0)
    t1, t2 = _tree(1), _tree(2)
    ck.save(1, t1)
    ck.save(2, t2)
    r1 = restore_into(t1, ck.restore(step=1)[0])
    assert torch.equal(r1["a"], t1["a"])


def test_snapshot_format_matches_jax(tmp_path):
    """The same tree written by both packages: the same flat keys, shapes
    and dtypes, and each package reads the other's arrays."""
    tree = _tree()
    nested = tree["nested"]
    jtree = dict(a=jnp.asarray(tree["a"].numpy()),
                 nested=dict(b=jnp.asarray(nested["b"].float().numpy())
                             .astype(jnp.bfloat16),
                             step=jnp.int32(7),
                             key=jnp.asarray(nested["key"].numpy())))
    Checkpointer(str(tmp_path / "port")).save(3, tree)
    JaxCheckpointer(str(tmp_path / "jax")).save(3, jtree)
    port_flat, port_m = Checkpointer(str(tmp_path / "jax")).restore()
    jax_flat, jax_m = JaxCheckpointer(str(tmp_path / "port")).restore()
    assert port_m["keys"] == jax_m["keys"]
    for k in port_flat:
        np.testing.assert_array_equal(port_flat[k], jax_flat[k])


# ------------------------------------------------------- failure recovery

def _graph():
    return directed_web(96, 5.0, seed=3, device="cpu")


@pytest.mark.parametrize("shards", [1, 3])
def test_walks_recovery_bit_exact(tmp_path, shards):
    g = _graph()
    mesh = StackedMesh(shards, "cpu")
    pi0, r0 = run_walks(g, EPS, K, None, [], seed=5, mesh=mesh)
    pi1, r1 = run_walks(g, EPS, K, str(tmp_path), [3, 14], seed=5,
                        mesh=mesh)
    assert r1.restarts == 2 and r0.restarts == 0
    np.testing.assert_array_equal(pi0, pi1)
    assert r0.rounds == r1.rounds
    assert torch.equal(r0.state.pos, r1.state.pos)


@pytest.mark.parametrize("packed", [True, False])
def test_counts_recovery_bit_exact(tmp_path, packed):
    g = _graph()
    mesh = StackedMesh(4, "cpu")
    a = distributed_pagerank_counts(g, EPS, K, prng.PRNGKey(2), mesh=mesh,
                                    packed=packed)
    b = distributed_pagerank_counts(g, EPS, K, prng.PRNGKey(2), mesh=mesh,
                                    packed=packed,
                                    checkpoint_dir=str(tmp_path),
                                    fail_at=[2, 11], checkpoint_every=4)
    assert b.restarts == 2 and b.checkpoints_written > 0
    assert torch.equal(a.zeta, b.zeta)
    assert (a.rounds, a.a2a_bytes_total, a.occupancy) == \
        (b.rounds, b.a2a_bytes_total, b.occupancy)


@pytest.mark.parametrize("new_shards", [2, 3, 8])
def test_counts_resume_at_other_shard_count(tmp_path, new_shards):
    g = _graph()
    ref = distributed_pagerank_counts(g, EPS, K, prng.PRNGKey(4),
                                      mesh=StackedMesh(4, "cpu"))
    with pytest.raises(SimulatedFailure):
        distributed_pagerank_counts(g, EPS, K, prng.PRNGKey(4),
                                    mesh=StackedMesh(4, "cpu"),
                                    checkpoint_dir=str(tmp_path),
                                    fail_at=[13], checkpoint_every=5,
                                    max_restarts=0)
    res = distributed_pagerank_counts(g, EPS, K, prng.PRNGKey(4),
                                      mesh=StackedMesh(new_shards, "cpu"),
                                      checkpoint_dir=str(tmp_path),
                                      resume=True)
    assert torch.equal(res.zeta, ref.zeta)
    assert res.rounds == ref.rounds and res.shards == new_shards


@pytest.mark.parametrize("new_shards", [1, 2, 3, 8])
def test_walk_relayout_matches_jax(new_shards):
    """Live walks keep their multiset, zeta its values, and the keys are
    derived as the JAX package derives them."""
    n = 64
    rng = np.random.default_rng(new_shards)
    pos = np.full((4, 100), -1, np.int32)
    for p in range(4):
        k = rng.integers(10, 60)
        pos[p, :k] = rng.integers(0, n, size=k)
    state = dict(pos=pos,
                 zeta=rng.integers(0, 50, size=(4, 16)).astype(np.int32),
                 key=rng.integers(0, 2 ** 32, (4, 2), dtype=np.uint32),
                 round=np.int64(7), dropped=np.int64(0), waited=np.int64(3))
    got = relayout_pagerank_state(state, n, new_shards)
    want = j_relayout(state, n, new_shards)
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))
    assert sorted(got["pos"][got["pos"] >= 0]) == sorted(pos[pos >= 0])


def test_walks_resume_at_other_shard_count(tmp_path):
    args = (128, EPS, 16, "directed_web")
    with pytest.raises(SimulatedFailure):
        run(*args, str(tmp_path), [12], algo="walks", shards=4,
            max_restarts=0, device="cpu")
    res = run(*args, str(tmp_path), [], algo="walks", shards=2, resume=True,
              check=True, device="cpu")
    assert res.shards == 2 and res.l1 < 0.15


# ------------------------------------------- snapshots from the JAX engines

JAX_SNAPSHOTS = """
import json, os
import jax, numpy as np
from jax.sharding import Mesh
from repro.core.distributed_counts import distributed_pagerank_counts
from repro.graphs import directed_web, erdos_renyi
from repro.launch.pagerank import run_walks
from repro.runtime import SimulatedFailure
base = %r
mesh = Mesh(np.array(jax.devices()[:4]), ("shards",))
g = directed_web(96, 5.0, seed=3)
out = {}
ref = distributed_pagerank_counts(g, 0.2, 8, jax.random.PRNGKey(6),
                                  mesh=mesh)
out["counts_zeta"] = np.asarray(ref.zeta).tolist()
out["counts_rounds"] = ref.rounds
try:
    distributed_pagerank_counts(g, 0.2, 8, jax.random.PRNGKey(6), mesh=mesh,
                                checkpoint_dir=os.path.join(base, "counts"),
                                fail_at=[12], checkpoint_every=5,
                                max_restarts=0)
except SimulatedFailure:
    out["counts_stopped"] = True
gw = erdos_renyi(96, 5.0, seed=1)
out["walks_pi"] = np.asarray(run_walks(gw, 0.2, 8, None, [], 9,
                                       mesh=mesh)).tolist()
try:
    run_walks(gw, 0.2, 8, os.path.join(base, "walks"), [15], 9, mesh=mesh,
              max_restarts=0)
except SimulatedFailure:
    out["walks_stopped"] = True
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_snapshots(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("jax_snapshots"))
    out = run_forced_devices(JAX_SNAPSHOTS % base, devices=4, timeout=600)
    assert out["counts_stopped"] and out["walks_stopped"]
    return base, out


def test_jax_count_snapshot_resumes_in_port(jax_snapshots):
    base, out = jax_snapshots
    ckpt = os.path.join(base, "counts")
    flat, manifest = Checkpointer(ckpt).restore()
    assert manifest["step"] == 10 and manifest["metadata"]["shards"] == 4
    state = convert.count_state_from_numpy(flat, device="cpu")
    assert state.stage == "counts" and state.host["rounds"] == 10
    np.testing.assert_array_equal(state.arrays["zeta"].numpy(),
                                  flat["arrays/zeta"])
    g = _graph()
    for shards in (4, 3):
        # a resumed run leaves its final snapshot: each resume gets a copy
        copy = os.path.join(base, f"counts_at_{shards}")
        shutil.copytree(ckpt, copy)
        res = distributed_pagerank_counts(
            g, EPS, K, prng.PRNGKey(6), mesh=StackedMesh(shards, "cpu"),
            checkpoint_dir=copy, resume=True)
        np.testing.assert_array_equal(res.zeta.numpy(), out["counts_zeta"])
        assert res.rounds == out["counts_rounds"]


def _supervised_walks(ckpt_dir, fail_at, *, async_checkpoints,
                      max_restarts=16):
    """The walk engine at P=4 on the JAX snapshot run's graph and seed,
    under a Supervisor snapshotting every 2 rounds. Returns (supervisor,
    initial state, pi of a result)."""
    g = erdos_renyi(96, 5.0, seed=1, device="cpu")
    mesh = StackedMesh(4, "cpu")
    sg = shard_graph(g, 4)
    W = g.n * K
    route_cap = W // 4 + 64
    state = init_state(sg, K, prng.PRNGKey(9), 2 * W // 4 + 4 * 64, "cpu")

    def step_fn(s):
        s2, active, _, _ = superstep(sg, s, mesh=mesh, eps=EPS,
                                     route_cap=route_cap)
        return s2, active == 0

    sup = Supervisor(step_fn, state_to_host,
                     lambda f: state_from_host(f, mesh),
                     Checkpointer(str(ckpt_dir)), checkpoint_every=2,
                     max_restarts=max_restarts,
                     async_checkpoints=async_checkpoints,
                     failure_schedule=FailureSchedule(fail_at) if fail_at
                     else None)

    def pi(res):
        zeta = res.state.zeta.reshape(-1)[: g.n].numpy()
        return zeta.astype(np.float64) * EPS / (g.n * K)

    return sup, state, pi


def test_async_checkpoints_resume_bit_exact(tmp_path, jax_snapshots):
    _, out = jax_snapshots
    runs = {}
    for mode in (True, False):
        sup, state, pi = _supervised_walks(tmp_path / str(mode), [3, 14],
                                           async_checkpoints=mode)
        res = sup.run(state)
        runs[mode] = (pi(res), res.restarts, res.checkpoints_written,
                      res.rounds)
    assert runs[True][1] == 2 and runs[True][1:] == runs[False][1:]
    np.testing.assert_array_equal(runs[True][0], runs[False][0])
    np.testing.assert_array_equal(runs[True][0], out["walks_pi"])
    # killed mid-run with a background write in flight, then resumed
    sup, state, pi = _supervised_walks(tmp_path / "killed", [9],
                                       async_checkpoints=True,
                                       max_restarts=0)
    with pytest.raises(SimulatedFailure):
        sup.run(state)
    sup.ckpt.wait()
    assert sup.ckpt.latest_step() == 8
    sup, state, pi = _supervised_walks(tmp_path / "killed", [],
                                       async_checkpoints=True)
    res = sup.run(state, resume=True)
    np.testing.assert_array_equal(pi(res), out["walks_pi"])
    assert res.rounds == runs[True][3]


def test_jax_walk_snapshot_resumes_in_port(jax_snapshots):
    base, out = jax_snapshots
    ckpt = os.path.join(base, "walks")
    flat, _ = Checkpointer(ckpt).restore()
    state = convert.dist_state_from_numpy(flat, device="cpu")
    assert state.pos.shape == flat["pos"].shape and state.round == 10
    assert torch.equal(state.key, torch.from_numpy(flat["key"]))
    g = erdos_renyi(96, 5.0, seed=1, device="cpu")
    pi, res = run_walks(g, EPS, K, ckpt, [], 9, resume=True,
                        mesh=StackedMesh(4, "cpu"))
    np.testing.assert_array_equal(pi, out["walks_pi"])
    assert res.state.dropped == 0
