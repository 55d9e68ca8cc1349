"""Algorithm 1 and the power-iteration oracle: the port against the JAX
package on the shared small fixtures at K=8, eps=0.2.

Parity levels:
  * power_iteration — tolerance: pi within 1e-6 L1 and iterations within
    +-1 (float32 sums in another order);
  * engine_walks run / run_traced — bit-exact zeta and rounds, every
    RoundTrace field equal (same threefry uniforms, integer decisions);
  * engine_counts run_traced — bit-exact zeta, rounds and traces (at K=8
    every Binomial draw is in the BINV regime);
  * simple_pagerank — logical_rounds and report summary equal, pi within
    1e-12 (both scale the same integer zeta in float64).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import engine_counts as j_counts
from repro.core import engine_walks as j_walks
from repro.core import power_iteration as j_power_iteration
from repro.core import simple_pagerank as j_simple_pagerank

from repro_torch import convert, prng
from repro_torch.core import engine_counts as t_counts
from repro_torch.core import engine_walks as t_walks
from repro_torch.core import power_iteration as t_power_iteration
from repro_torch.core import simple_pagerank as t_simple_pagerank

GRAPH_NAMES = ["ring", "grid", "er", "ba", "ba_hub", "dweb"]
EPS, K = 0.2, 8


@pytest.fixture(scope="module")
def pair(small_graphs):
    """(JAX graph, port graph on the CPU) by fixture name."""
    cache = {}

    def get(name):
        if name not in cache:
            g = small_graphs[name]
            cache[name] = (g, convert.graph_from_numpy(
                np.asarray(g.row_ptr), np.asarray(g.col_idx),
                np.asarray(g.out_deg), g.n, g.m, g.undirected,
                device="cpu"))
        return cache[name]
    return get


def _keys(seed):
    jk = jax.random.PRNGKey(seed)
    return jk, convert.key_from_numpy(np.asarray(jk))


def _traces(traces):
    return [dataclasses.astuple(t) for t in traces]


@pytest.mark.parametrize("name", GRAPH_NAMES)
def test_power_iteration_matches(pair, name):
    jg, tg = pair(name)
    j_pi, _, j_it = j_power_iteration(jg, EPS)
    t_pi, _, t_it = t_power_iteration(tg, EPS, device="cpu")
    assert t_pi.dtype == torch.float32 and t_pi.shape == (jg.n,)
    l1 = np.abs(t_pi.numpy().astype(np.float64)
                - np.asarray(j_pi, np.float64)).sum()
    assert l1 < 1e-6
    assert abs(t_it - j_it) <= 1


@pytest.mark.parametrize("name", GRAPH_NAMES)
def test_engine_walks_bit_exact(pair, name):
    jg, tg = pair(name)
    jk, tk = _keys(0)
    js = j_walks.run(jg, EPS, K, jk)
    ts = t_walks.run(tg, EPS, K, tk)
    np.testing.assert_array_equal(ts.zeta.numpy(), np.asarray(js.zeta))
    assert ts.round == int(js.round)
    np.testing.assert_array_equal(ts.pos.numpy(), np.asarray(js.pos))
    np.testing.assert_array_equal(ts.key.numpy(), np.asarray(js.key))
    jt_state, j_tr = j_walks.run_traced(jg, EPS, K, jk)
    tt_state, t_tr = t_walks.run_traced(tg, EPS, K, tk)
    np.testing.assert_array_equal(tt_state.zeta.numpy(),
                                  np.asarray(jt_state.zeta))
    assert tt_state.round == int(jt_state.round) == ts.round
    assert _traces(t_tr) == _traces(j_tr)


def test_engine_walks_max_rounds_stop(pair):
    jg, tg = pair("er")
    jk, tk = _keys(5)
    js = j_walks.run(jg, EPS, K, jk, max_rounds=3)
    ts = t_walks.run(tg, EPS, K, tk, max_rounds=3)
    assert ts.round == int(js.round) == 3
    np.testing.assert_array_equal(ts.zeta.numpy(), np.asarray(js.zeta))
    np.testing.assert_array_equal(ts.alive.numpy(), np.asarray(js.alive))


@pytest.mark.parametrize("name", GRAPH_NAMES)
def test_engine_counts_bit_exact(pair, name):
    jg, tg = pair(name)
    jk, tk = _keys(1)
    js, j_tr = j_counts.run_traced(jg, EPS, K, jk)
    ts, t_tr = t_counts.run_traced(tg, EPS, K, tk)
    np.testing.assert_array_equal(ts.zeta.numpy(), np.asarray(js.zeta))
    assert ts.round == int(js.round)
    assert _traces(t_tr) == _traces(j_tr)
    assert int(ts.counts.sum()) == 0


def test_engine_counts_flat_layout_same_draws(pair):
    """The draws are a pure function of (key, row id, slot): the flat
    single-bucket layout gives the same trajectory as the bucketed one."""
    _, tg = pair("ba_hub")
    _, tk = _keys(3)
    a, ta = t_counts.run_traced(tg, EPS, K, tk)
    b, tb = t_counts.run_traced(tg, EPS, K, tk, bucketed=False)
    np.testing.assert_array_equal(a.zeta.numpy(), b.zeta.numpy())
    assert _traces(ta) == _traces(tb)


@pytest.mark.parametrize("engine,traced", [("walks", False), ("walks", True),
                                           ("counts", True)])
@pytest.mark.parametrize("name", ["er", "dweb"])
def test_simple_pagerank_matches(pair, name, engine, traced):
    jg, tg = pair(name)
    jk, tk = _keys(2)
    jr = j_simple_pagerank(jg, EPS, walks_per_node=K, key=jk, engine=engine,
                           traced=traced)
    tr = t_simple_pagerank(tg, EPS, walks_per_node=K, key=tk, engine=engine,
                           traced=traced, device="cpu")
    assert tr.logical_rounds == jr.logical_rounds
    assert tr.walks_per_node == jr.walks_per_node == K
    np.testing.assert_allclose(tr.pi, np.asarray(jr.pi), rtol=0, atol=1e-12)
    if jr.report is None:
        assert tr.report is None
    else:
        assert tr.report.summary() == jr.report.summary()
        assert tr.report.total_message_bits == jr.report.total_message_bits


def test_simple_pagerank_default_key_and_k(pair):
    from repro.core.simple_pagerank import walks_per_node_for as j_wpn
    from repro_torch.core.simple_pagerank import walks_per_node_for as t_wpn
    for n in (2, 96, 1 << 20):
        assert t_wpn(n, EPS) == j_wpn(n, EPS)
    jg, tg = pair("ring")
    jr = j_simple_pagerank(jg, EPS)
    tr = t_simple_pagerank(tg, EPS, device="cpu")
    np.testing.assert_array_equal(tr.zeta.numpy(), np.asarray(jr.zeta))
    np.testing.assert_array_equal(prng.PRNGKey(0).numpy(),
                                  np.asarray(jax.random.PRNGKey(0)))


def test_unknown_engine_raises(pair):
    _, tg = pair("ring")
    with pytest.raises(ValueError):
        t_simple_pagerank(tg, EPS, engine="nope", device="cpu")


def test_entry_points_refuse_cpu_without_asking(pair, monkeypatch):
    """With no card and no explicit device="cpu", the entry points raise
    instead of running on the CPU."""
    from repro_torch.graphs import ring
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tg = pair("ring")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_simple_pagerank(tg, EPS)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_power_iteration(tg, EPS)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ring(8)
