"""The walk step's in-place keyed entry (`walk_step_keyed_`) and its callers.

Parity level 1 (bit-exact) throughout, on the CPU (the plain version):
  * `walk_step_keyed_` against the JAX package's `walk_step_pallas` (in
    interpret mode) fed `jax.random.uniform` of the same keys, and against
    the out-of-place `walk_step_keyed_ref`: `pos` and `alive` after the
    step (dtype kept, bool or int32), dead slots untouched, the edge ids
    (against the JAX engine's formula), the appended arrivals as a sorted
    list and their count, the buffer past the count untouched; on the
    shared fixtures and a graph with dangling vertices, with some, none
    and all slots alive;
  * the callers leave what they were handed: Phase 1 steps a copy of the
    coupon sources, and `routing.advance_owned` copies of `pos` and
    `eligible`; Phase 1's traj, edges and moved equal the JAX package's;
  * the single-device engine's traced rounds (`active`, `moved`) equal the
    JAX package's, the engine reads one count a round, and the tail of
    Algorithm 2 steps in place with the same traces.
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine_walks as j_walks
from repro.core.graph import from_edges as j_from_edges
from repro.kernels.walk_step import walk_step as j_walk_step

from repro_torch import convert
from repro_torch.core import engine_walks, routing
from repro_torch.kernels.walk_step import walk_step_keyed, walk_step_keyed_
from repro_torch.kernels.walk_step.ref import walk_step_keyed_ref

j_improved = importlib.import_module("repro.core.improved_pagerank")
three_phase = importlib.import_module("repro_torch.core.improved_pagerank")

EPS = 0.2
W = 1500
UNTOUCHED = 987654


def _dangling(g):
    """`g` with the out-edges of every fifth vertex taken away."""
    rp, ci = np.asarray(g.row_ptr), np.asarray(g.col_idx)
    src = np.repeat(np.arange(g.n), np.diff(rp))
    keep = src % 5 != 0
    return j_from_edges(src[keep], ci[keep], g.n)


@pytest.fixture(scope="module")
def graphs(small_graphs):
    """(JAX graph, port graph on the CPU) by name; "dangling" is dweb with
    the out-edges of every fifth vertex taken away."""
    out = dict(small_graphs)
    out["dangling"] = _dangling(small_graphs["dweb"])
    return {name: (g, convert.graph_from_numpy(
        np.asarray(g.row_ptr), np.asarray(g.col_idx), np.asarray(g.out_deg),
        g.n, g.m, g.undirected, device="cpu")) for name, g in out.items()}


def _keys(seed):
    jk = jax.random.split(jax.random.PRNGKey(seed))
    return jk, [convert.key_from_numpy(np.asarray(k)) for k in jk]


def _slots(n, seed, live_share):
    """Positions in [-2, n + 2) (out-of-range ones clip) and the live mask."""
    rng = np.random.default_rng(seed)
    return (rng.integers(-2, n + 2, W).astype(np.int32),
            rng.random(W) < live_share)


def _jax_step(jg, pos, alive, jk):
    """The JAX kernel's (new_pos, new_alive) and the JAX engine's edge ids
    (-1 where a walk did not move), on the draws of the two keys."""
    u_term = jax.random.uniform(jk[0], (W,))
    u_edge = jax.random.uniform(jk[1], (W,))
    new_pos, new_alive = j_walk_step(jnp.asarray(pos), jnp.asarray(alive),
                                     u_term, u_edge, jg.row_ptr, jg.col_idx,
                                     jg.out_deg, eps=EPS)
    safe = jnp.clip(jnp.asarray(pos), 0, jg.n - 1)
    deg = jg.out_deg[safe]
    j = jnp.minimum((u_edge * jnp.maximum(deg, 1)).astype(jnp.int32),
                    jnp.maximum(deg - 1, 0))
    moved = new_alive.astype(bool)
    edge = jnp.where(moved, jg.row_ptr[safe] + j, -1)
    return np.asarray(new_pos), np.asarray(moved), np.asarray(edge)


@pytest.mark.parametrize("live_share", [0.8, 0.0, 1.0],
                         ids=["some_dead", "all_dead", "all_alive"])
@pytest.mark.parametrize("alive_dtype", [torch.bool, torch.int32])
@pytest.mark.parametrize("name", ["er", "ba_hub", "dweb", "dangling"])
def test_inplace_step_equals_jax(graphs, name, alive_dtype, live_share):
    jg, g = graphs[name]
    seed = W + len(name)
    pos_np, live_np = _slots(g.n, seed, live_share)
    jk, (kt, ke) = _keys(seed)
    want_pos, want_moved, want_edge = _jax_step(jg, pos_np, live_np, jk)

    pos0 = torch.from_numpy(pos_np)
    alive0 = torch.from_numpy(live_np).to(alive_dtype)
    pos, alive = pos0.clone(), alive0.clone()
    edge = torch.full((W,), UNTOUCHED, dtype=torch.int32)
    arrivals = torch.full((W,), UNTOUCHED, dtype=torch.int32)
    count = walk_step_keyed_(pos, alive, kt, ke, g.row_ptr, g.col_idx,
                             g.out_deg, eps=EPS, edge=edge,
                             arrivals=arrivals)
    assert pos.dtype == torch.int32 and alive.dtype == alive_dtype
    np.testing.assert_array_equal(pos.numpy(), want_pos)
    np.testing.assert_array_equal(alive.bool().numpy(), want_moved)
    np.testing.assert_array_equal(edge.numpy(), want_edge)
    dead = ~alive0.bool()
    assert torch.equal(pos[dead], pos0[dead])
    assert torch.equal(alive[dead], alive0[dead])
    # the arrivals: the survivors' new vertices, in no fixed order
    assert count.dtype == torch.int64 and count.shape == (1,)
    moved = int(count)
    assert moved == int(want_moved.sum())
    np.testing.assert_array_equal(np.sort(arrivals[:moved].numpy()),
                                  np.sort(want_pos[want_moved]))
    assert bool((arrivals[moved:] == UNTOUCHED).all())
    # the out-of-place entry and its plain version: the same step
    for fn in (walk_step_keyed, walk_step_keyed_ref):
        got = fn(pos0, alive0, kt, ke, g.row_ptr, g.col_idx, g.out_deg,
                 eps=EPS, edges=True)
        for a, b in zip(got, (pos, alive, edge)):
            assert a.dtype == b.dtype and torch.equal(a, b)
    if live_share == 0.0:
        assert moved == 0 and bool((edge == -1).all())
    if name == "dangling" and live_share > 0:
        on_dangling = g.out_deg[pos0.clamp(0, g.n - 1).long()] == 0
        assert bool((on_dangling & alive0.bool()).any())
        assert not bool((on_dangling & alive.bool()).any())


@pytest.mark.parametrize("with_edge", [False, True])
def test_inplace_step_without_outputs_is_the_same_step(graphs, with_edge):
    """Without `arrivals` no count comes back; with or without `edge`,
    `pos` and `alive` are stepped the same way."""
    _, g = graphs["ba"]
    pos_np, live_np = _slots(g.n, 3, 0.7)
    _, (kt, ke) = _keys(3)
    want = walk_step_keyed_ref(torch.from_numpy(pos_np),
                               torch.from_numpy(live_np), kt, ke, g.row_ptr,
                               g.col_idx, g.out_deg, eps=EPS)
    pos, alive = torch.from_numpy(pos_np), torch.from_numpy(live_np)
    edge = torch.empty_like(pos) if with_edge else None
    assert walk_step_keyed_(pos, alive, kt, ke, g.row_ptr, g.col_idx,
                            g.out_deg, eps=EPS, edge=edge) is None
    assert torch.equal(pos, want[0]) and torch.equal(alive, want[1])


def test_phase1_steps_a_copy_and_equals_jax(graphs):
    """Phase 1 leaves the coupon sources as they were; its trajectory, edge
    and move tables equal the JAX package's."""
    jg, g = graphs["dangling"]
    src_np = np.repeat(np.arange(g.n, dtype=np.int32), 5)
    jk = jax.random.PRNGKey(8)
    want = j_improved._phase1_scan(jg.row_ptr, jg.col_idx, jg.out_deg,
                                   jnp.asarray(src_np), jk, EPS, 4)
    src = torch.from_numpy(src_np)
    got = three_phase._phase1_scan(g.row_ptr, g.col_idx, g.out_deg, src,
                                   convert.key_from_numpy(np.asarray(jk)),
                                   EPS, 4)
    assert torch.equal(src, torch.from_numpy(src_np))
    for name in ("traj", "edges", "moved", "dest", "valid_arrivals",
                 "terminated"):
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]))
    assert got["dest"].data_ptr() != src.data_ptr()


def test_advance_owned_leaves_its_inputs(graphs):
    """`advance_owned` steps copies: `pos` and `eligible` are as they were,
    and (survive, dst) are each shard's out-of-place keyed step of its
    local positions (JAX parity: tests/test_torch_routing.py)."""
    from repro_torch.core.distributed import shard_graph
    _, g = graphs["er"]
    P, cap = 3, 700
    sg = shard_graph(g, P)
    rng = np.random.default_rng(1)
    pos_np = rng.integers(-1, g.n, (P, cap)).astype(np.int32)
    owner = np.clip(pos_np, 0, None) // sg.n_loc
    elig_np = (pos_np >= 0) & (owner == np.arange(P)[:, None]) \
        & (rng.random((P, cap)) < 0.9)
    keys = [convert.key_from_numpy(np.asarray(k)) for k in
            jax.random.split(jax.random.PRNGKey(2), 2 * P)]
    kt, ke = torch.stack(keys[:P]), torch.stack(keys[P:])
    pos, eligible = torch.from_numpy(pos_np), torch.from_numpy(elig_np)
    survive, dst = routing.advance_owned(
        sg.row_ptr, sg.col_idx, sg.out_deg, pos, eligible, kt, ke, EPS,
        torch.arange(P), sg.n_loc)
    assert torch.equal(pos, torch.from_numpy(pos_np))
    assert torch.equal(eligible, torch.from_numpy(elig_np))
    assert survive.dtype == torch.bool and dst.dtype == torch.int32
    assert survive.shape == dst.shape == (P, cap)
    assert bool(survive.any()) and not bool(survive[~eligible].any())
    for s in range(P):
        local = torch.where(eligible[s], pos[s] - s * sg.n_loc, 0)
        want = walk_step_keyed(local, eligible[s], kt[s], ke[s],
                               sg.row_ptr[s], sg.col_idx[s], sg.out_deg[s],
                               eps=EPS)
        assert torch.equal(dst[s], want[0])
        assert torch.equal(survive[s], want[1])


@pytest.mark.parametrize("name", ["dangling", "er"])
def test_traced_rounds_equal_jax_one_count_a_round(graphs, name,
                                                   monkeypatch):
    """`active` is read before the in-place step, `moved` from its count:
    both equal the JAX package's traces; the untraced run reads one count
    a round and nothing else of the walks."""
    jg, g = graphs[name]
    jk = jax.random.PRNGKey(6)
    key = convert.key_from_numpy(np.asarray(jk))
    j_state, j_traces = j_walks.run_traced(jg, EPS, 4, jk)
    state, traces = engine_walks.run_traced(g, EPS, 4, key)
    assert [(t.active_walks, t.total_count) for t in traces] == \
        [(t.active_walks, t.total_count) for t in j_traces]
    assert [dataclasses.astuple(t) for t in traces] == \
        [dataclasses.astuple(t) for t in j_traces]
    assert state.round == int(j_state.round)
    np.testing.assert_array_equal(state.zeta.numpy(),
                                  np.asarray(j_state.zeta))

    reads = []
    real = engine_walks.walk_step_keyed_

    class Count(torch.Tensor):
        def __int__(self):
            reads.append(1)
            return super().__int__()

    def launch(*args, **kw):
        assert kw.get("arrivals") is not None and kw.get("edge") is None
        return real(*args, **kw).as_subclass(Count)

    monkeypatch.setattr(engine_walks, "walk_step_keyed_", launch)
    run = engine_walks.run(g, EPS, 4, key)
    assert len(reads) == run.round == state.round
    np.testing.assert_array_equal(run.zeta.numpy(), np.asarray(j_state.zeta))
    assert run.live == 0 and not bool(run.alive.sum())


def test_tail_steps_in_place_with_jax_traces(graphs):
    """eta = 1 leaves most walks to Algorithm 2's naive tail, which steps
    its walks in place: zeta, tail rounds and the report equal the JAX
    package's."""
    jg, g = graphs["dweb"]
    jk = jax.random.PRNGKey(5)
    want = j_improved.improved_pagerank(jg, EPS, walks_per_node=4, key=jk,
                                        eta=1)
    got = three_phase.improved_pagerank(
        g, EPS, walks_per_node=4, key=convert.key_from_numpy(np.asarray(jk)),
        eta=1, device="cpu")
    assert got.tail_rounds == int(want.tail_rounds) > 0
    np.testing.assert_array_equal(got.zeta.numpy(), np.asarray(want.zeta))
    assert got.report.summary() == want.report.summary()
