"""The three-phase engines' static plan, Phase-1 sampler and int64 keys,
against the JAX package, on the CPU (no JAX subprocess; the engines'
runs against the JAX shard_map engines are in
`test_torch_three_phase.py`).

Parity levels:
  * bit-exact — `plan_three_phase`'s static sizes, pool layout and bucket
    permutation at P in {1, 3, 8}, for both pool policies; the fused
    sampler's dense-cell mode (its CPU plain version) over the stacked
    Phase-1 rows against `scatter_cells(sample_buckets())` owner by owner,
    and, where every draw is in the inverse-CDF regime (counts below 21),
    against the JAX package's `scatter_cells(sample_buckets())` (dweb,
    P=3);
  * statistical — where the JAX package's int32 outcome keys overflow
    (erdos_renyi(4096, 8) at P=1) it refuses, and the port's int64 keys
    run: conservation exact, L1 < 0.15 against power iteration.
"""
import importlib

import jax
import numpy as np
import pytest
import torch

from repro.core.aggregate_sampler import sample_buckets as j_sample_buckets
from repro.core.aggregate_sampler import scatter_cells as j_scatter_cells
from repro.core.distributed_improved import \
    distributed_improved_pagerank as j_dimp
from repro.core.distributed_improved import plan_three_phase as j_plan
from repro.graphs import erdos_renyi as j_erdos_renyi
from repro.kernels.multinomial_rows._math import key_words as j_key_words

from repro_torch import convert, prng
from repro_torch.core import l1_error, normalized, power_iteration
from repro_torch.core.aggregate_sampler import (sample_buckets,
                                                scatter_cells)
from repro_torch.core.collectives import StackedMesh
from repro_torch.core.distributed_improved import (
    distributed_improved_pagerank, plan_three_phase)
from repro_torch.graphs import erdos_renyi
from repro_torch.kernels.multinomial_rows import multinomial_buckets
from repro_torch.kernels.multinomial_rows._math import key_words

t_improved = importlib.import_module("repro_torch.core.improved_pagerank")

EPS, K = 0.2, 8
NAMES = ["ring", "grid", "er", "ba", "ba_hub", "dweb"]


@pytest.fixture(scope="module")
def graphs(small_graphs):
    """The shared fixtures as port graphs on the CPU."""
    return {name: convert.graph_from_numpy(
        np.asarray(g.row_ptr), np.asarray(g.col_idx), np.asarray(g.out_deg),
        g.n, g.m, g.undirected, device="cpu")
        for name, g in small_graphs.items()}


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("shards", [1, 3, 8])
def test_plan_matches_jax(small_graphs, graphs, name, shards):
    jg, tg = small_graphs[name], graphs[name]
    for uniform in (False, True):
        lam = 5 if uniform else 3
        kw = dict(degree_proportional=False, ell=23) if uniform else {}
        _, pool = t_improved.coupon_pool_sizes(tg, EPS, K, lam, **kw)
        a = plan_three_phase(tg, shards, pool, K)
        b = j_plan(jg, shards, pool, K)
        for f in ("n_loc", "md", "S_loc_pad", "S_total", "rep_cap",
                  "route_cap2", "cap2"):
            assert getattr(a, f) == getattr(b, f), f
        assert (a.layout.widths, a.layout.caps, a.layout.n_rows) == (
            b.layout.widths, b.layout.caps, b.layout.n_rows)
        for f in ("pool_pad", "psize_sh", "pstart_sh", "bperm_np"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def _phase1_inputs(plan, shards, seed, most):
    """A Phase-1 sample's inputs: random per-(home, vertex) counts below
    `most` on each owner and each owner's sample key."""
    rng = np.random.default_rng(seed)
    n_loc = plan.n_loc
    deg = plan.sg.out_deg.numpy()
    c = rng.integers(0, most, (shards, shards * n_loc)).astype(np.int32)
    c[np.tile(deg, (1, shards)) == 0] = rng.integers(0, 3)
    keys = torch.stack([prng.split(prng.PRNGKey(seed + p), 3)[1]
                        for p in range(shards)])
    return c, keys


@pytest.mark.parametrize("name", ["ba_hub", "dweb"])
@pytest.mark.parametrize("shards", [1, 3])
@pytest.mark.parametrize("most", [21, 300])
def test_dense_cell_sampler_matches_scatter_cells(graphs, name, shards,
                                                  most):
    """The fused entry's dense-cell mode over the stacked Phase-1 rows (its
    CPU plain version) equals, owner by owner, scatter_cells of the
    per-bucket sampler over the tiled rows. Counts below 21 keep every
    draw in the inverse-CDF regime (mean <= 10), where the JAX package's
    draws are the same bit for bit (ROADMAP, Queue 2 item 3); there, on
    dweb at P=3, the JAX package's scatter_cells(sample_buckets()) is
    equal too (its eager per-bucket chain is slow on the CPU)."""
    tg = graphs[name]
    _, pool = t_improved.coupon_pool_sizes(tg, EPS, K, 3)
    plan = plan_three_phase(tg, shards, pool, K)
    n_loc, md, lay = plan.n_loc, plan.md, plan.layout
    n_pad = shards * n_loc
    c, keys = _phase1_inputs(plan, shards, seed=shards, most=most)
    deg_row = np.tile(plan.sg.out_deg.numpy(), (1, shards))
    got, occ, res = multinomial_buckets(
        torch.from_numpy(c).reshape(-1), torch.from_numpy(deg_row).reshape(-1),
        torch.arange(shards * n_pad, dtype=torch.int32), keys,
        torch.from_numpy(plan.rows_perm), plan.rows_layout.widths,
        plan.rows_layout.caps, eps=EPS, shards=shards, cells=md)
    got = got.reshape(shards, -1)
    lay_t = lay.tile(shards)
    occ_want = 0
    for p in range(shards):
        offs = np.arange(shards)[:, None] * n_loc
        perm_t = np.concatenate([
            np.where(pb[None, :] < 0, -1, offs + pb[None, :]).reshape(-1)
            for pb in (plan.bperm_np[p, s:s + cap]
                       for s, cap in zip(lay.row_starts, lay.caps))]
        ).astype(np.int32)
        rid = p * n_pad + np.arange(n_pad, dtype=np.int32)
        args = (torch.from_numpy(c[p]), torch.from_numpy(deg_row[p]),
                torch.from_numpy(rid), key_words(keys[p]),
                torch.from_numpy(perm_t), lay_t)
        samples, occ_p, res_p = sample_buckets(*args, eps=EPS)
        want = scatter_cells(samples, lay_t, md)
        assert torch.equal(got[p], want), p
        assert int(res_p) == 0
        occ_want = occ_want + occ_p
        if most > 21 or shards == 1 or name != "dweb":
            continue
        j_samples, _, _ = j_sample_buckets(
            *(jax.numpy.asarray(a.numpy()) for a in args[:3]),
            j_key_words(jax.numpy.asarray(keys[p].numpy())),
            jax.numpy.asarray(perm_t), lay_t, eps=EPS, use_pallas=False)
        np.testing.assert_array_equal(
            want.numpy(), np.asarray(j_scatter_cells(j_samples, lay_t, md)))
    assert torch.equal(occ, occ_want) and int(res) == 0
    # each row's cells sum to its count, and the cells past its degree are 0
    cells = got.reshape(shards, shards * n_loc, md + 1)
    assert torch.equal(cells.sum(-1), torch.from_numpy(c))
    j = torch.arange(md + 1)
    past = j[None, None, :] > torch.from_numpy(deg_row)[..., None]
    assert not bool(cells[past].any())


def test_port_lifts_the_int32_key_limit():
    """erdos_renyi(4096, 8) at P=1: (n_pad + 1)(S_loc_pad + 1) is past
    2**31, so the JAX package refuses the pool; the port's int64 keys run
    it, exact in its conservation and within the accuracy policy."""
    jg = j_erdos_renyi(4096, 8.0, seed=0)
    with pytest.raises(ValueError, match="overflow int32"):
        j_dimp(jg, EPS, key=jax.random.PRNGKey(0))
    g = erdos_renyi(4096, 8.0, seed=0, device="cpu")
    r = distributed_improved_pagerank(g, EPS, key=prng.PRNGKey(0),
                                      mesh=StackedMesh(1, "cpu"))
    n, Kd = g.n, r.walks_per_node
    plan = plan_three_phase(g, 1, t_improved.coupon_pool_sizes(
        g, EPS, Kd, r.lam)[1], Kd)
    assert (n + 1) * (plan.S_loc_pad + 1) >= 2 ** 31
    assert r.residual == 0 and r.dropped == 0
    assert r.terminated_by_coupon + r.tail_walks == n * Kd
    assert r.tail_walks == r.exhausted_walks
    assert r.coupons_used <= r.coupons_created
    active = n * Kd
    for rec in r.phase2_records:
        active -= rec["terminated"] + rec["exhausted"]
        assert rec["active"] == active
    assert active == 0
    expect = n * Kd / EPS
    assert abs(r.total_visits - expect) / expect < 0.07
    pi_ref, _, _ = power_iteration(g, EPS, device="cpu")
    assert l1_error(normalized(r.pi), pi_ref.numpy()) < 0.15
