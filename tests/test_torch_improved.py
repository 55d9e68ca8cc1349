"""Algorithm 2 and Section 5 on one device: the port against the JAX
package on the shared small fixtures at K=8, eps=0.2, key PRNGKey(0).

Parity levels, all bit-exact:
  * coupon_pool_sizes — eta and the pool vector, for the degree-
    proportional (Lemma 2) and the uniform (Section 5) policies, with eta
    derived and given;
  * _allocate_coupons — coupon ids, the ok mask and the advanced pool
    pointers on random inputs (a stable sort and integer arithmetic);
  * improved_pagerank and directed_local_pagerank — zeta, every phase's
    rounds, stitch_iterations, exhausted_walks, coupons created and used,
    logical_rounds and every RoundTrace (the same threefry uniforms and
    integer decisions).
"""
import dataclasses
import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import convert, prng

# the packages export functions of the modules' names
j_improved = importlib.import_module("repro.core.improved_pagerank")
t_improved = importlib.import_module("repro_torch.core.improved_pagerank")

GRAPH_NAMES = ["ring", "grid", "er", "ba", "ba_hub", "dweb"]
EPS, K = 0.2, 8


@pytest.fixture(scope="module")
def pair(small_graphs):
    """(JAX graph, port graph on the CPU) by fixture name."""
    def get(name):
        g = small_graphs[name]
        return g, convert.graph_from_numpy(
            np.asarray(g.row_ptr), np.asarray(g.col_idx),
            np.asarray(g.out_deg), g.n, g.m, g.undirected, device="cpu")
    return get


@pytest.mark.parametrize("name", GRAPH_NAMES)
@pytest.mark.parametrize("policy", [
    dict(), dict(eta=3), dict(eta_safety=1.5),
    dict(degree_proportional=False, ell=23),
    dict(degree_proportional=False, eta=2)])
def test_coupon_pool_sizes_identical(pair, name, policy):
    jg, tg = pair(name)
    lam = 5 if policy.get("degree_proportional") is False else 3
    j_eta, j_pool = j_improved.coupon_pool_sizes(jg, EPS, K, lam, **policy)
    t_eta, t_pool = t_improved.coupon_pool_sizes(tg, EPS, K, lam, **policy)
    assert t_eta == j_eta
    assert t_pool.dtype == j_pool.dtype
    np.testing.assert_array_equal(t_pool, j_pool)


def test_uniform_pools_need_ell(pair):
    _, tg = pair("dweb")
    with pytest.raises(ValueError, match="ell"):
        t_improved.coupon_pool_sizes(tg, EPS, K, 5,
                                     degree_proportional=False)


@pytest.mark.parametrize("seed", range(4))
def test_allocate_coupons_bit_exact(seed):
    rng = np.random.default_rng(seed)
    n, W = int(rng.integers(1, 40)), int(rng.integers(1, 600))
    cur = rng.integers(0, n, W).astype(np.int32)
    active = rng.random(W) < 0.7
    pool_size = rng.integers(1, 12, n).astype(np.int32)
    pool_start = np.concatenate([[0], np.cumsum(pool_size)[:-1]]).astype(
        np.int32)
    next_coupon = np.minimum(rng.integers(0, 8, n), pool_size).astype(
        np.int32)
    want = j_improved._allocate_coupons(
        jnp.asarray(cur), jnp.asarray(active), jnp.asarray(next_coupon),
        jnp.asarray(pool_start), jnp.asarray(pool_size))
    got = t_improved._allocate_coupons(
        torch.from_numpy(cur), torch.from_numpy(active),
        torch.from_numpy(next_coupon), torch.from_numpy(pool_start),
        torch.from_numpy(pool_size))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_run_starts():
    flags = torch.tensor([1, 0, 0, 1, 1, 0, 1, 0], dtype=torch.bool)
    assert t_improved.run_starts(flags).tolist() == [0, 0, 0, 3, 4, 4, 6, 6]


def _summary(r):
    return dict(
        zeta=np.asarray(r.zeta).tolist(), logical_rounds=r.logical_rounds,
        **{f: getattr(r, f) for f in (
            "lam", "eta", "stitch_iterations", "phase1_rounds",
            "phase2_rounds", "phase3_rounds", "tail_rounds",
            "exhausted_walks", "coupons_created", "coupons_used")},
        traces=[dataclasses.astuple(t) for t in r.report.traces])


@pytest.mark.parametrize("name", GRAPH_NAMES)
@pytest.mark.parametrize("engine", ["improved_pagerank",
                                    "directed_local_pagerank"])
def test_engine_bit_exact(pair, name, engine):
    jg, tg = pair(name)
    want = getattr(j_improved, engine)(jg, EPS, walks_per_node=K,
                                       key=jax.random.PRNGKey(0))
    got = getattr(t_improved, engine)(tg, EPS, walks_per_node=K,
                                      key=prng.PRNGKey(0), device="cpu")
    assert _summary(got) == _summary(want)
    np.testing.assert_array_equal(got.pi, np.asarray(want.pi))


def test_exhaustion_bit_exact(pair):
    """eta=1 starves the pools: most walks finish in the naive tail, which
    runs the Algorithm-1 walk step."""
    jg, tg = pair("ba")
    want = j_improved.improved_pagerank(jg, EPS, walks_per_node=K, eta=1,
                                        key=jax.random.PRNGKey(2))
    got = t_improved.improved_pagerank(tg, EPS, walks_per_node=K, eta=1,
                                       key=prng.PRNGKey(2), device="cpu")
    assert got.exhausted_walks > 0 and got.tail_rounds > 0
    assert _summary(got) == _summary(want)


def test_round_budget(pair):
    """The paper's claim at this size: phase 1 takes lam rounds plus the
    report round, stitching about ell / lam, and the total stays below
    Algorithm 1's rounds on the same graph."""
    from repro_torch.core import simple_pagerank
    _, tg = pair("er")
    r = t_improved.improved_pagerank(tg, EPS, walks_per_node=K,
                                     key=prng.PRNGKey(0), device="cpu")
    assert r.phase1_rounds == r.lam + 1
    assert r.stitch_iterations <= math.ceil(math.ceil(
        math.log(tg.n) / EPS) / r.lam) + 3
    alg1 = simple_pagerank(tg, EPS, walks_per_node=K, key=prng.PRNGKey(0),
                           device="cpu")
    assert r.phase1_rounds + r.phase2_rounds < alg1.logical_rounds
