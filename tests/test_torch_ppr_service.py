"""The port's PPR query service: admission, cache, refresh and resize.

The JAX package's `tests/test_ppr_service.py`, ported to the port's
service on the CPU (time injected with `now=`, so TTL and refresh run on
a controlled clock), plus:
  * the same trace of requests through both packages' services at one
    shard (the in-process JAX package has one CPU device) — parity level
    bit-exact: every result vector, the cache hits and the counters;
  * `resize` mid-traffic on the stacked mesh (3 -> 2 -> 5 shards):
    nothing dropped or rejected, every request completes, cached answers
    stay the stored vectors, and a query in flight keeps the visits it
    had gathered (statistical after the resize, since the shard keys are
    re-derived; held to exact_ppr with the loose anchor below).
"""
import jax
import numpy as np
import pytest
import torch

from repro.graphs import barabasi_albert as j_barabasi_albert
from repro.serve import PPRService as JPPRService

from repro_torch import convert, prng
from repro_torch.core import l1_error, normalized
from repro_torch.core.collectives import StackedMesh
from repro_torch.core.personalized import exact_ppr
from repro_torch.serve import PPRService, ResultCache, query_cache_key


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU runs here are many small tensor ops. Under parallel
    test workers torch's thread pool oversubscribes the cores and every op
    waits at its barrier (100x slower); one thread keeps serial speed."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def jgraph():
    return j_barabasi_albert(48, 3, seed=3)


@pytest.fixture(scope="module")
def graph(jgraph):
    return convert.graph_from_numpy(
        np.asarray(jgraph.row_ptr), np.asarray(jgraph.col_idx),
        np.asarray(jgraph.out_deg), jgraph.n, jgraph.m, jgraph.undirected,
        device="cpu")


def make_service(graph, **kw):
    kw.setdefault("slots", 2)
    kw.setdefault("walks_per_query", 800)
    kw.setdefault("eps", 0.3)
    kw.setdefault("device", "cpu")
    return PPRService(graph, kw.pop("eps"), key=prng.PRNGKey(5), **kw)


def drive(svc, now):
    done = []
    while svc.busy:
        done.extend(svc.step(now=now))
    return done


def test_serves_batched_queries_and_caches(graph):
    svc = make_service(graph)
    r1 = svc.submit([0, 5], now=0.0)
    r2 = svc.submit([7], now=0.0)
    r3 = svc.submit([11, 2], now=0.0)   # queued: only 2 slots
    done = drive(svc, now=1.0)
    assert {r.rid for r in done} == {r1.rid, r2.rid, r3.rid}
    assert all(r.done and r.result is not None for r in (r1, r2, r3))
    assert svc.stats.admitted == 3 and svc.stats.completed == 3
    assert svc.stats.max_active_queries == 2          # batched, slot-bound
    assert svc.stats.dropped_walks == 0
    assert svc.stats.admit_dropped == 0
    # loose oracle anchor
    ref = exact_ppr(graph, 0.3, [0, 5])
    assert l1_error(normalized(r1.result), normalized(ref)) < 0.3

    # cache hit: answered at submit time, the stored vector bit for bit
    r4 = svc.submit([0, 5], now=2.0)
    assert r4.cached and r4.done
    assert np.array_equal(r4.result, r1.result)
    assert svc.stats.cache_hits == 1
    assert svc.stats.admitted == 3                    # no recompute
    assert not svc.busy


def test_ttl_expiry_forces_recompute(graph):
    svc = make_service(graph, ttl=10.0)
    svc.submit([1, 3], now=0.0)
    drive(svc, now=0.5)
    assert svc.stats.admitted == 1
    assert svc.submit([1, 3], now=5.0).cached
    r = svc.submit([1, 3], now=50.0)
    assert not r.cached
    drive(svc, now=51.0)
    assert svc.stats.admitted == 2
    assert r.done and r.result is not None


def test_hot_source_refresh_serves_stale_and_recomputes(graph):
    svc = make_service(graph, ttl=100.0, refresh_age=5.0)
    first = svc.submit([2], now=0.0)
    drive(svc, now=0.5)
    stored_v1 = svc.cache.stored_at((first.sources, first.weights))

    hit = svc.submit([2], now=7.0)      # older than refresh_age: hot
    assert hit.cached
    assert np.array_equal(hit.result, first.result)
    assert svc.stats.refreshes == 1
    assert svc.busy                      # the background refresh is queued

    # a second hot hit while a refresh is in flight does not pile up
    assert svc.submit([2], now=7.5).cached
    assert svc.stats.refreshes == 1

    done = drive(svc, now=8.0)
    assert len(done) == 1 and done[0].refresh
    assert svc.cache.stored_at((first.sources, first.weights)) > stored_v1
    assert np.array_equal(svc.submit([2], now=9.0).result, done[0].result)


def test_max_pending_rejects_not_drops(graph):
    svc = make_service(graph, slots=1, max_pending=1)
    svc.submit([4], now=0.0)
    svc.submit([6], now=0.0)
    r = svc.submit([8], now=0.0)        # queue full
    assert r.rejected and r.done and r.result is None
    assert svc.stats.rejected == 1
    drive(svc, now=1.0)
    assert svc.stats.completed == 2


def test_result_cache_lru_and_ttl_clock():
    c = ResultCache(max_entries=2, ttl=10.0, refresh_age=4.0)
    a, b, d = (np.array([1.0]), np.array([2.0]), np.array([3.0]))
    c.put("a", a, now=0.0)
    c.put("b", b, now=1.0)
    assert c.get("a", now=2.0) == (a, False)
    c.put("d", d, now=3.0)               # evicts the LRU entry, "b"
    assert c.get("b", now=3.0) == (None, False)
    v, refresh = c.get("a", now=5.0)     # age 5 >= refresh_age
    assert v is a and refresh
    assert c.get("a", now=11.0) == (None, False)   # age >= ttl: evicted
    assert len(c) == 1
    with pytest.raises(ValueError, match="refresh_age"):
        ResultCache(ttl=1.0, refresh_age=2.0)


def test_query_cache_key_is_canonical():
    assert query_cache_key([3, 1], None, 10) == ((3, 1), (0.5, 0.5))
    assert query_cache_key([3], [4.0], 10) == ((3,), (1.0,))


TRACE = [(0.0, [0, 5], None), (0.0, [7], None), (0.0, [11, 2], [0.7, 0.3]),
         (1.0, [0, 5], None), (1.0, [9], None), (30.0, [7], None),
         (30.0, [20, 21, 22], None)]


def _replay(svc):
    """Submit TRACE, stepping the service once between submission times;
    returns each request's (cached, result) and the counters."""
    reqs, t_prev = [], None
    for t, sources, weights in TRACE:
        if t_prev is not None and t != t_prev:
            svc.step(now=t)
        reqs.append(svc.submit(sources, weights, now=t))
        t_prev = t
    while svc.busy:
        svc.step(now=t_prev + 1.0)
    s = svc.stats
    return ([(r.cached, r.result) for r in reqs],
            (s.submitted, s.admitted, s.completed, s.cache_hits,
             s.refreshes, s.supersteps, s.max_active_queries,
             s.dropped_walks, s.admit_dropped))


def test_service_trace_bit_exact_against_jax(jgraph, graph):
    kw = dict(slots=2, walks_per_query=600, ttl=20.0, refresh_age=10.0)
    got = _replay(PPRService(graph, 0.3, key=prng.PRNGKey(5), device="cpu",
                             **kw))
    want = _replay(JPPRService(jgraph, 0.3, key=jax.random.PRNGKey(5),
                               **kw))
    assert got[1] == want[1]
    for (c1, r1), (c2, r2) in zip(got[0], want[0]):
        assert c1 == c2
        np.testing.assert_array_equal(r1, r2)


def test_resize_mid_traffic(graph):
    svc = make_service(graph, slots=3, mesh=StackedMesh(3, "cpu"))
    reqs = [svc.submit(q, now=0.0) for q in ([0, 5], [7], [11, 2], [9])]
    for _ in range(2):
        svc.step(now=0.5)
    in_flight = {slot: svc.engine.extract(slot) for slot in range(3)}
    svc.resize(shards=2)
    assert svc.engine.shards == 2 and svc.engine.rounds == 2
    for slot, v in in_flight.items():
        np.testing.assert_array_equal(svc.engine.extract(slot), v)
    drive(svc, now=1.0)
    first = reqs[0].result
    assert all(r.done and r.result is not None for r in reqs)
    hit = svc.submit([0, 5], now=2.0)
    assert hit.cached and np.array_equal(hit.result, first)
    svc.resize(mesh=StackedMesh(5, "cpu"))
    late = svc.submit([30], now=3.0)
    drive(svc, now=4.0)
    assert late.done and svc.engine.shards == 5
    s = svc.stats
    assert (s.dropped_walks, s.admit_dropped, s.rejected) == (0, 0, 0)
    assert s.completed == 5 and s.cache_hits == 1
    ref = exact_ppr(graph, 0.3, [0, 5])
    assert l1_error(normalized(first), normalized(ref)) < 0.3
    with pytest.raises(ValueError, match="exactly one"):
        svc.resize()
