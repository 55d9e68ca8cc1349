"""The threefry draws of the walk step, drawn where they are consumed.

Parity level 1 (bit-exact) throughout:
  * `walk_step_keyed` with `edges=True` (the plain version on the CPU)
    against the composition the single-device engines ran before they
    moved onto the keyed entry: `prng.uniform` of both keys, then the
    torch passes of the old `engine_walks.advance` (new_pos, new_alive and
    the edge id, -1 where a walk did not move), on fixtures with dangling
    vertices and dead slots, with `alive` int32 (the sharded engines) and
    bool (the single-device engines);
  * the walk engine's state after a cut run, `alive` included, equal in
    value and dtype to the JAX package's;
  * the single-device walk engine (`run`, `run_traced`), single-query PPR
    and Algorithm 2 / Section 5 call no standalone `uniform`: with it made
    to raise they run as before, one keyed step a round or coupon step,
    and give the same results;
  * the kernels' build digest covers the threefry header that `uniform.cu`
    and `walk_step.cu` share, so an edit of the header rebuilds both.
"""
import importlib

import jax
import numpy as np
import pytest
import torch

from repro.core import engine_walks as j_walks
from repro.core.graph import from_edges as j_from_edges

import repro_torch.kernels.uniform as uniform_pkg
from repro_torch import convert, prng
from repro_torch.core import engine_walks
from repro_torch.core.graph import from_edges
from repro_torch.kernels import common
from repro_torch.kernels.uniform import ops as uniform_ops
from repro_torch.kernels.walk_step import walk_step_keyed, walk_step_keyed_
from repro_torch.kernels.walk_step.ref import walk_step_keyed_ref

# the modules, whose names `repro_torch.core` gives to their entry points
three_phase = importlib.import_module("repro_torch.core.improved_pagerank")
single_ppr = importlib.import_module("repro_torch.core.personalized")

EPS = 0.2


@pytest.fixture(scope="module")
def graphs(small_graphs):
    """The shared fixtures as port graphs on the CPU, and "dangling": dweb
    with the out-edges of every fifth vertex taken away."""
    out = {name: convert.graph_from_numpy(
        np.asarray(g.row_ptr), np.asarray(g.col_idx), np.asarray(g.out_deg),
        g.n, g.m, g.undirected, device="cpu")
        for name, g in small_graphs.items()}
    g = out["dweb"]
    src, dst = g.edge_src().numpy(), g.col_idx.numpy()
    keep = src % 5 != 0
    out["dangling"] = from_edges(src[keep], dst[keep], g.n, device="cpu")
    return out


def composed_step(row_ptr, col_idx, out_deg, eps, pos, alive, k_term,
                  k_edge):
    """One walk step as two standalone draws and torch passes, the way
    `engine_walks.advance` computed it before it launched the keyed step:
    (new_pos, new_alive, edge)."""
    u_term = prng.uniform(k_term, pos.shape, device=pos.device)
    deg = out_deg.index_select(0, pos)
    survive = alive.bool() & (u_term >= eps) & (deg > 0)
    u_edge = prng.uniform(k_edge, pos.shape, device=pos.device)
    j = torch.minimum((u_edge * torch.clamp(deg, min=1)).to(torch.int32),
                      torch.clamp(deg - 1, min=0))
    edge_ids = row_ptr.index_select(0, pos) + j
    dst = col_idx.index_select(
        0, torch.clamp(edge_ids, 0, col_idx.shape[0] - 1))
    return (torch.where(survive, dst, pos), survive.to(alive.dtype),
            torch.where(survive, edge_ids, -1))


@pytest.mark.parametrize("alive_dtype", [torch.int32, torch.bool])
@pytest.mark.parametrize("name", ["dangling", "ba_hub", "er"])
@pytest.mark.parametrize("seed", [0, 3])
def test_keyed_edges_equal_the_composed_draws(graphs, name, seed,
                                              alive_dtype):
    """Random positions, a fifth of the slots dead; on "dangling" a live
    walk at a vertex without out-edges ends there. `new_alive` keeps the
    dtype of `alive`."""
    g = graphs[name]
    rng = np.random.default_rng(seed)
    W = 4000
    pos = torch.from_numpy(rng.integers(0, g.n, W).astype(np.int32))
    alive = torch.from_numpy(rng.random(W) < 0.8).to(alive_dtype)
    k_term, k_edge = prng.split(prng.PRNGKey(seed))
    tables = (g.row_ptr, g.col_idx, g.out_deg)
    want = composed_step(*tables, EPS, pos, alive, k_term, k_edge)
    for fn in (walk_step_keyed, walk_step_keyed_ref):
        got = fn(pos, alive, k_term, k_edge, *tables, eps=EPS, edges=True)
        assert len(got) == 3
        for a, b, dtype in zip(got, want,
                               (torch.int32, alive_dtype, torch.int32)):
            assert a.dtype == dtype and a.shape == (W,)
            assert torch.equal(a, b)
        # without the request: the same two outputs and nothing else
        two = fn(pos, alive, k_term, k_edge, *tables, eps=EPS)
        assert len(two) == 2
        assert torch.equal(two[0], got[0]) and torch.equal(two[1], got[1])
    dangling = g.out_deg.index_select(0, pos) == 0
    moved = want[1].bool()
    if name == "dangling":
        assert bool((dangling & alive.bool()).any())
    assert not bool((moved & dangling).any())
    assert bool((want[2][~moved] == -1).all())
    assert bool((want[2][moved] >= 0).all()) and bool(moved.any())


def test_keyed_edges_name_the_edge_taken(graphs):
    """Every edge id a walk moved along leads from its old vertex to its
    new one."""
    g = graphs["ba"]
    pos = torch.arange(g.n, dtype=torch.int32).repeat(8)
    alive = torch.ones_like(pos)
    kt, ke = prng.split(prng.PRNGKey(11))
    new_pos, new_alive, edge = walk_step_keyed(
        pos, alive, kt, ke, g.row_ptr, g.col_idx, g.out_deg, eps=EPS,
        edges=True)
    moved = new_alive.bool()
    e = edge[moved].long()
    assert torch.equal(g.col_idx[e], new_pos[moved])
    assert bool((g.row_ptr[pos[moved].long()] <= e).all())
    assert bool((e < g.row_ptr[pos[moved].long() + 1]).all())
    assert torch.equal(new_pos[~moved], pos[~moved])


@pytest.fixture
def no_standalone_uniform(monkeypatch):
    """Make every standalone threefry draw raise, and count the in-place
    keyed steps each engine takes (True: with the edge output)."""
    def refuse(*args, **kw):
        raise AssertionError("a standalone uniform draw")

    monkeypatch.setattr(uniform_pkg, "uniform", refuse)
    monkeypatch.setattr(uniform_ops, "uniform", refuse)
    monkeypatch.setattr(prng, "uniform", refuse)
    steps = []

    def counted(*args, **kw):
        steps.append(kw.get("edge") is not None)
        return walk_step_keyed_(*args, **kw)

    monkeypatch.setattr(engine_walks, "walk_step_keyed_", counted)
    monkeypatch.setattr(three_phase, "walk_step_keyed_", counted)
    return steps


@pytest.fixture(scope="module")
def dangling(graphs):
    return graphs["dangling"]


@pytest.fixture(scope="module")
def reference_runs(dangling):
    """Each engine's results before any patch."""
    key = prng.PRNGKey(4)
    run = engine_walks.run(dangling, EPS, 6, key)
    traced, traces = engine_walks.run_traced(dangling, EPS, 6, key)
    ppr = single_ppr.personalized_pagerank(dangling, EPS, [0, 9], 2000,
                                           key=key, device="cpu")
    improved = three_phase.improved_pagerank(
        dangling, EPS, walks_per_node=6, key=key, device="cpu")
    directed = three_phase.directed_local_pagerank(
        dangling, EPS, walks_per_node=4, key=key, device="cpu")
    return dict(run=run, traced=(traced, traces), ppr=ppr, improved=improved,
                directed=directed)


def test_walk_engine_draws_no_standalone_uniform(dangling, reference_runs,
                                                 no_standalone_uniform):
    key = prng.PRNGKey(4)
    s = engine_walks.run(dangling, EPS, 6, key)
    assert no_standalone_uniform == [False] * s.round
    want = reference_runs["run"]
    assert torch.equal(s.zeta, want.zeta) and s.round == want.round
    del no_standalone_uniform[:]
    t, traces = engine_walks.run_traced(dangling, EPS, 6, key)
    assert no_standalone_uniform == [True] * t.round
    assert torch.equal(t.zeta, reference_runs["traced"][0].zeta)
    assert traces == reference_runs["traced"][1]


def test_ppr_draws_no_standalone_uniform(dangling, reference_runs,
                                         no_standalone_uniform):
    vec = single_ppr.personalized_pagerank(dangling, EPS, [0, 9], 2000,
                                           key=prng.PRNGKey(4), device="cpu")
    assert len(no_standalone_uniform) > 0
    assert torch.equal(vec, reference_runs["ppr"])


@pytest.mark.parametrize("engine", ["improved", "directed"])
def test_three_phase_draws_no_standalone_uniform(dangling, reference_runs,
                                                 no_standalone_uniform,
                                                 engine):
    """Phase 1's coupon steps and the tail's rounds are keyed steps with
    the edge output, one launch each."""
    key = prng.PRNGKey(4)
    if engine == "improved":
        r = three_phase.improved_pagerank(
            dangling, EPS, walks_per_node=6, key=key, device="cpu")
    else:
        r = three_phase.directed_local_pagerank(
            dangling, EPS, walks_per_node=4, key=key, device="cpu")
    want = reference_runs[engine]
    assert no_standalone_uniform == [True] * (r.lam + r.tail_rounds)
    assert torch.equal(r.zeta, want.zeta)
    assert r.report.summary() == want.report.summary()
    assert (r.tail_rounds, r.coupons_used) == (want.tail_rounds,
                                               want.coupons_used)


@pytest.mark.parametrize("name", ["dangling", "er"])
def test_walk_state_equals_jax_after_a_cut_run(graphs, small_graphs, name):
    """Three rounds and a stop: positions, `alive` (bool, as the JAX
    package keeps it), zeta and key equal the JAX package's, dtypes too."""
    g = graphs[name]
    jg = small_graphs.get(name) or j_from_edges(
        g.edge_src().numpy(), g.col_idx.numpy(), g.n)
    jk = jax.random.PRNGKey(7)
    js = j_walks.run(jg, EPS, 6, jk, max_rounds=3)
    ts = engine_walks.run(g, EPS, 6, convert.key_from_numpy(np.asarray(jk)),
                          max_rounds=3)
    assert ts.round == int(js.round) == 3
    for got, want in ((ts.pos, js.pos), (ts.alive, js.alive),
                      (ts.zeta, js.zeta), (ts.key, js.key)):
        want = np.asarray(want)
        assert got.numpy().dtype == want.dtype
        np.testing.assert_array_equal(got.numpy(), want)
    assert ts.alive.dtype == torch.bool
    assert bool(ts.alive.any()) and not bool(ts.alive.all())


def test_build_digest_covers_the_shared_header(tmp_path, monkeypatch):
    """A library's name hashes its source and every header the source
    includes by a quoted path (through other headers too): editing the
    header moves it, editing a file it does not include does not."""
    tmp_path = tmp_path.resolve()
    (tmp_path / "k").mkdir()
    src = tmp_path / "k" / "k.cu"
    src.write_text('#include <cstdint>\n#include "../gen.cuh"\n'
                   '__global__ void k() {}\n')
    (tmp_path / "gen.cuh").write_text('#pragma once\n#include "more.cuh"\n')
    (tmp_path / "more.cuh").write_text("// rounds\n")
    (tmp_path / "other.cuh").write_text("// not included\n")
    monkeypatch.setitem(common.SOURCES, "k", src)
    assert common.source_files("k") == [src, tmp_path / "gen.cuh",
                                        tmp_path / "more.cuh"]
    first = common.library_path("k")
    (tmp_path / "other.cuh").write_text("// edited\n")
    assert common.library_path("k") == first
    (tmp_path / "more.cuh").write_text("// rounds, edited\n")
    second = common.library_path("k")
    assert second != first
    (tmp_path / "gen.cuh").write_bytes(
        (tmp_path / "gen.cuh").read_bytes() + b" ")
    assert common.library_path("k") not in (first, second)


def test_one_copy_of_threefry_on_the_card():
    """`uniform` and `walk_step` both build from the shared header, and
    neither source holds a copy of the generator."""
    header = common.KERNELS_DIR / "threefry.cuh"
    assert b"0x1BD11BDA" in header.read_bytes()
    for name in common.SOURCES:
        files = common.source_files(name)
        assert (header in files) == (name in ("uniform", "walk_step"))
        assert b"0x1BD11BDA" not in common.SOURCES[name].read_bytes()
