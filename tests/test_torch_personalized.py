"""Personalized PageRank in the port against the JAX package.

One subprocess runs the JAX batched engine on 8 forced host devices and
prints JSON: `batched_personalized_pagerank` at P in {3, 8}, and a
resident engine at P = 8 stepped three rounds, its state re-laid out onto
3 shards (`relayout_arrays` with the `walk_aux` query lane, and
`relayout_from`) and run on to the end. The port runs the same cases in
process on the CPU, its P shards stacked on one device; P = 1 and the
single-query engine run against the in-process JAX package.

Parity levels:
  * bit-exact: `source_start_counts`, `personalized_pagerank` (the float32
    vector), `exact_ppr`, and the batched engine at P in {1, 3, 8}: the
    float64 vectors, rounds, the live-walk trace, a2a entries and bytes,
    dropped and admit_dropped; the re-laid-out state and the run after it;
  * statistical (the policy of tests/test_engine_conformance.py): the
    ported `tests/test_personalized.py` checks and the batched-PPR
    conformance cells against the port's `exact_ppr`.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core.personalized import exact_ppr as j_exact_ppr
from repro.core.personalized import \
    personalized_pagerank as j_personalized_pagerank
from repro.core.personalized import source_start_counts as j_start_counts
from repro.core.personalized_batch import \
    batched_personalized_pagerank as j_batched
from repro.graphs import barabasi_albert as j_barabasi_albert

from conftest import run_forced_devices
from repro_torch import convert, prng
from repro_torch.checkpoint import relayout_arrays
from repro_torch.core import l1_error, normalized, topk_overlap
from repro_torch.core.collectives import StackedMesh
from repro_torch.core.personalized import (exact_ppr, normalize_query,
                                           personalized_pagerank,
                                           source_start_counts)
from repro_torch.core.personalized_batch import (
    BatchedPPREngine, batched_personalized_pagerank, ppr_state_specs)
from repro_torch.graphs import barabasi_albert, ring

EPS = 0.25
QUERIES = [([0, 5], None), ([17], None), ([3, 40], [0.8, 0.2])]
WALKS = 1500
SHARDS = [3, 8]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU runs here are many small tensor ops. Under parallel
    test workers torch's thread pool oversubscribes the cores and every op
    waits at its barrier (100x slower); one thread keeps serial speed."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)

JAX_RUNS = """
import json
import jax, numpy as np
from jax.sharding import Mesh
from repro.checkpoint import relayout_arrays
from repro.core.personalized_batch import (BatchedPPREngine,
                                           batched_personalized_pagerank,
                                           ppr_state_specs)
from repro.graphs import barabasi_albert
g = barabasi_albert(80, 3, seed=4)
out = {}
def mesh(P):
    return Mesh(np.array(jax.devices()[:P]), ("shards",))
for P in %r:
    r = batched_personalized_pagerank(g, %r, %r, %r, jax.random.PRNGKey(2),
                                      mesh=mesh(P))
    out[f"batch/{P}"] = dict(
        ppr=r.ppr.tolist(), rounds=r.rounds, trace=r.active_trace,
        entries=r.a2a_entries, bytes=r.a2a_bytes, dropped=r.dropped,
        admit_dropped=r.admit_dropped)
e8 = BatchedPPREngine(g, %r, num_slots=3, walks_per_query=%r, mesh=mesh(8))
e8.reset(jax.random.PRNGKey(9))
for i, (s, w) in enumerate(%r):
    e8.admit(i, s, w, key=jax.random.fold_in(jax.random.PRNGKey(9), i))
for _ in range(3):
    e8.superstep()
state = {k: np.asarray(getattr(e8.state, k)) for k in ("pos", "qid", "zeta",
                                                       "key")}
relaid = relayout_arrays(state, ppr_state_specs(g.n, e8.cap), 8, 3)
e3 = BatchedPPREngine(g, %r, num_slots=3, walks_per_query=%r, mesh=mesh(3))
e3.relayout_from(e8)
while e3.active.sum() > 0:
    e3.superstep()
out["relayout"] = dict(
    state={k: v.tolist() for k, v in state.items()},
    relaid={k: v.tolist() for k, v in relaid.items()},
    cap=e3.cap, rounds=e3.rounds, bytes=e3.a2a_bytes,
    ppr=[e3.extract(i).tolist() for i in range(3)])
print(json.dumps(out))
""" % (SHARDS, EPS, QUERIES, WALKS, EPS, WALKS, QUERIES, EPS, WALKS)


@pytest.fixture(scope="module")
def jax_runs():
    return run_forced_devices(JAX_RUNS, devices=8, timeout=900)


@pytest.fixture(scope="module")
def jg():
    return j_barabasi_albert(80, 3, seed=4)


@pytest.fixture(scope="module")
def g(jg):
    return convert.graph_from_numpy(
        np.asarray(jg.row_ptr), np.asarray(jg.col_idx),
        np.asarray(jg.out_deg), jg.n, jg.m, jg.undirected, device="cpu")


def _same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


# ------------------------------------------------------- single query

@pytest.mark.parametrize("seed", [0, 1, 2 ** 32 - 1])
@pytest.mark.parametrize("weights", [[1.0], [0.5, 0.3, 0.2], [0.9, 0.1]])
def test_source_start_counts_bit_exact(seed, weights):
    w = np.asarray(weights)
    got = source_start_counts(prng.PRNGKey(seed), w, 10_000)
    want = j_start_counts(jax.random.PRNGKey(seed), w, 10_000)
    np.testing.assert_array_equal(got, want)
    assert got.sum() == 10_000


@pytest.mark.parametrize("sources,weights,walks,key,max_rounds", [
    ([0, 5, 17], None, 4000, 1, 100_000),
    ([1, 2], [0.9, 0.1], 3000, 2, 100_000),
    ([0], None, 2000, 3, 1),
    ([7, 7, 30], [0.2, 0.3, 0.5], 2500, 4, 100_000)])
def test_personalized_pagerank_bit_exact(jg, g, sources, weights, walks,
                                         key, max_rounds):
    got = personalized_pagerank(g, EPS, sources, walks,
                                key=prng.PRNGKey(key), weights=weights,
                                max_rounds=max_rounds, device="cpu")
    want = j_personalized_pagerank(jg, EPS, sources, walks,
                                   key=jax.random.PRNGKey(key),
                                   weights=weights, max_rounds=max_rounds)
    assert got.dtype == torch.float32
    _same_bits(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("sources,weights", [([0, 5, 17], None),
                                             ([1, 2], [0.9, 0.1])])
def test_exact_ppr_matches_jax(jg, g, sources, weights):
    np.testing.assert_array_equal(exact_ppr(g, EPS, sources, weights),
                                  j_exact_ppr(jg, EPS, sources, weights))


def test_normalize_query_refuses_bad_queries():
    with pytest.raises(ValueError, match="at least one"):
        normalize_query([], None, 10)
    with pytest.raises(ValueError, match="out of range"):
        normalize_query([10], None, 10)
    with pytest.raises(ValueError, match="weights must match"):
        normalize_query([1, 2], [1.0], 10)
    s, w = normalize_query([3, 4], [2.0, 6.0], 10)
    assert s.dtype == np.int32 and w.tolist() == [0.25, 0.75]


# ------------------------------------------------- tests/test_personalized.py

def test_ppr_matches_linear_solve():
    g = barabasi_albert(80, 3, seed=4, device="cpu")
    seeds = [0, 5, 17]
    est = personalized_pagerank(g, EPS, seeds, 40_000, key=prng.PRNGKey(1),
                                device="cpu").numpy()
    ref = exact_ppr(g, EPS, seeds)
    assert np.abs(est / est.sum() - ref / ref.sum()).sum() < 0.12
    # mass concentrates near the seed set against uniform PageRank
    assert (est / est.sum())[seeds].sum() > 3 * len(seeds) / g.n


def test_ppr_weighted_seeds():
    g = barabasi_albert(60, 3, seed=5, device="cpu")
    est = personalized_pagerank(g, 0.3, [1, 2], 30_000, weights=[0.9, 0.1],
                                key=prng.PRNGKey(2), device="cpu").numpy()
    ref = exact_ppr(g, 0.3, [1, 2], weights=[0.9, 0.1])
    assert np.abs(est / est.sum() - ref / ref.sum()).sum() < 0.12


def test_start_counts_key_sensitivity():
    w = np.array([0.5, 0.3, 0.2])
    a = source_start_counts(prng.PRNGKey(0), w, 10_000)
    b = source_start_counts(prng.PRNGKey(1), w, 10_000)
    a2 = source_start_counts(prng.PRNGKey(0), w, 10_000)
    assert a.sum() == b.sum() == 10_000
    assert not np.array_equal(a, b)
    assert np.array_equal(a, a2)


def test_ppr_key_sensitivity():
    g = barabasi_albert(40, 3, seed=6, device="cpu")

    def run(k):
        return personalized_pagerank(g, 0.3, [0, 7], 4_000, key=k,
                                     device="cpu").numpy()

    a, b, a2 = run(prng.PRNGKey(0)), run(prng.PRNGKey(1)), run(
        prng.PRNGKey(0))
    assert np.array_equal(a, a2)
    assert not np.array_equal(a, b)


def test_ppr_max_rounds_cap():
    g = barabasi_albert(40, 3, seed=6, device="cpu")
    kw = dict(sources=[0], walks_total=4_000, key=prng.PRNGKey(3),
              device="cpu")
    full = personalized_pagerank(g, 0.3, **kw).numpy()
    capped = personalized_pagerank(g, 0.3, max_rounds=1, **kw).numpy()
    assert capped.sum() < full.sum()
    assert 0.9 < full.sum() < 1.1


# ------------------------------------------------------- batched engine

def _port_batch(g, shards):
    return batched_personalized_pagerank(
        g, EPS, QUERIES, WALKS, prng.PRNGKey(2),
        mesh=StackedMesh(shards, "cpu"))


def _summary(r):
    return dict(rounds=r.rounds, trace=r.active_trace, entries=r.a2a_entries,
                bytes=r.a2a_bytes, dropped=r.dropped,
                admit_dropped=r.admit_dropped)


def test_batched_one_shard_bit_exact(jg, g):
    """P = 1 against the in-process JAX package (one CPU device)."""
    got = _port_batch(g, 1)
    want = j_batched(jg, EPS, QUERIES, WALKS, jax.random.PRNGKey(2))
    _same_bits(got.ppr, want.ppr)
    assert _summary(got) == _summary(want)
    assert got.shards == 1 and got.dropped == 0 == got.admit_dropped


@pytest.mark.parametrize("shards", SHARDS)
def test_batched_bit_exact(jax_runs, g, shards):
    got = _port_batch(g, shards)
    want = jax_runs[f"batch/{shards}"]
    _same_bits(got.ppr, np.asarray(want.pop("ppr")))
    assert _summary(got) == want
    assert got.a2a_entries > 0 and got.shards == shards


def _port_engine_at_8(g):
    e8 = BatchedPPREngine(g, EPS, num_slots=3, walks_per_query=WALKS,
                          mesh=StackedMesh(8, "cpu"))
    key = prng.PRNGKey(9)
    e8.reset(key)
    for i, (s, w) in enumerate(QUERIES):
        e8.admit(i, s, w, key=prng.fold_in(key, i))
    for _ in range(3):
        e8.superstep()
    return e8


def test_relayout_walk_aux_bit_exact(jax_runs, g):
    """8 -> 3 shards: the engine's state after three rounds equals JAX's,
    the `walk_aux` re-layout of it equals `relayout_arrays` of the JAX
    package, and the run continued on 3 shards equals JAX's to the end."""
    want = jax_runs["relayout"]
    e8 = _port_engine_at_8(g)
    state = {k: getattr(e8.state, k).numpy() for k in ("pos", "qid", "zeta",
                                                       "key")}
    for k, v in state.items():
        np.testing.assert_array_equal(v, np.asarray(want["state"][k],
                                                    dtype=v.dtype))
    relaid = relayout_arrays(state, ppr_state_specs(g.n, e8.cap), 3)
    assert set(relaid) == set(want["relaid"])
    for k, v in relaid.items():
        np.testing.assert_array_equal(v, np.asarray(want["relaid"][k],
                                                    dtype=v.dtype))
    e3 = BatchedPPREngine(g, EPS, num_slots=3, walks_per_query=WALKS,
                          mesh=StackedMesh(3, "cpu"))
    e3.relayout_from(e8)
    assert (e3.rounds, e3.cap) == (3, want["cap"])
    while e3.active.sum() > 0:
        e3.superstep()
    assert (e3.rounds, e3.a2a_bytes) == (want["rounds"], want["bytes"])
    for i in range(3):
        _same_bits(e3.extract(i), np.asarray(want["ppr"][i]))


def test_relayout_keeps_walks_and_visits(g):
    """The multiset of (vertex, query) walks and every visit count survive
    8 -> 3 -> 8 shards; a second round trip gives the same buffers."""
    e8 = _port_engine_at_8(g)
    mid = BatchedPPREngine(g, EPS, num_slots=3, walks_per_query=WALKS,
                           mesh=StackedMesh(3, "cpu"))
    mid.relayout_from(e8)
    back = BatchedPPREngine(g, EPS, num_slots=3, walks_per_query=WALKS,
                            mesh=StackedMesh(8, "cpu"))
    back.relayout_from(mid)

    def walks(e):
        live = e.state.pos >= 0
        return sorted(zip(e.state.pos[live].tolist(),
                          e.state.qid[live].tolist()))

    assert walks(e8) == walks(mid) == walks(back)
    for i in range(3):
        np.testing.assert_array_equal(e8.extract(i), mid.extract(i))
        np.testing.assert_array_equal(e8.extract(i), back.extract(i))
    again = BatchedPPREngine(g, EPS, num_slots=3, walks_per_query=WALKS,
                             mesh=StackedMesh(3, "cpu"))
    again.relayout_from(back)
    assert torch.equal(again.state.pos, mid.state.pos)
    assert torch.equal(again.state.qid, mid.state.qid)


def test_engine_admission_guards(g):
    e = BatchedPPREngine(g, EPS, num_slots=2, walks_per_query=50,
                         mesh=StackedMesh(3, "cpu"))
    with pytest.raises(ValueError, match="out of range"):
        e.admit(2, [0])
    e.admit(0, [0, 1])
    with pytest.raises(ValueError, match="still has live walks"):
        e.admit(0, [4])
    other = BatchedPPREngine(g, EPS, num_slots=3, walks_per_query=50,
                             device="cpu")
    with pytest.raises(ValueError, match="engine mismatch"):
        other.relayout_from(e)


def test_tight_cap_counts_drops(jg, g):
    """A cap below the walks in flight drops starts and says so, as the
    JAX engine does (P = 1, bit-exact, the drop counters included)."""
    got = batched_personalized_pagerank(g, EPS, QUERIES, WALKS,
                                        prng.PRNGKey(2), cap=1000,
                                        device="cpu")
    want = j_batched(jg, EPS, QUERIES, WALKS, jax.random.PRNGKey(2),
                     cap=1000)
    assert got.admit_dropped > 0
    _same_bits(got.ppr, want.ppr)
    assert _summary(got) == _summary(want)


def test_virtual_ids_never_wrap():
    """n_pad * Q past int32 is refused before anything is allocated."""
    g = ring(1 << 16, device="cpu")
    with pytest.raises(ValueError, match="int32"):
        BatchedPPREngine(g, EPS, num_slots=1 << 15, walks_per_query=1,
                         device="cpu")
    with pytest.raises(ValueError, match="int32"):
        BatchedPPREngine(g, EPS, num_slots=1 << 13, walks_per_query=1,
                         mesh=StackedMesh(4, "cpu"))


# ------------------------------- batched-PPR cells of the conformance suite

CONF_EPS, L1_TOL, MASS_TOL, TOPK_MIN = 0.2, 0.15, 0.10, 0.6
CONF_WALKS = 12_000


@pytest.fixture(scope="module")
def conformance_run(small_graphs):
    jg = small_graphs["ba"]
    g = convert.graph_from_numpy(
        np.asarray(jg.row_ptr), np.asarray(jg.col_idx),
        np.asarray(jg.out_deg), jg.n, jg.m, jg.undirected, device="cpu")
    return g, batched_personalized_pagerank(
        g, CONF_EPS, QUERIES, CONF_WALKS, prng.PRNGKey(21),
        mesh=StackedMesh(8, "cpu"))


@pytest.mark.parametrize("qi", range(len(QUERIES)),
                         ids=[f"q{i}" for i in range(len(QUERIES))])
def test_batched_ppr_conformance(qi, conformance_run):
    g, r = conformance_run
    assert r.dropped == 0 and r.admit_dropped == 0
    sources, weights = QUERIES[qi]
    ref = normalized(exact_ppr(g, CONF_EPS, sources, weights=weights))
    pi = r.ppr[qi]
    assert abs(pi.sum() - 1.0) < MASS_TOL
    assert l1_error(normalized(pi), ref) < L1_TOL
    assert topk_overlap(pi, ref, k=10) >= TOPK_MIN


def test_entry_points_need_a_card_or_cpu(g):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        personalized_pagerank(g, EPS, [0], 10)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BatchedPPREngine(g, EPS, num_slots=1, walks_per_query=10)
