"""The port's CUDA kernels against their plain torch versions, on the card.

Each test needs a CUDA device and skips without one (the kernels have no
CPU mode). Every test carries the `cuda` marker. This file imports no JAX, so the
card's machine runs it as is:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Parity levels: histogram (every path: all-shared, hot list, hot list
overfull, no hot list) and integer segment_spmv (with and without a hot
list) bit-exact; multinomial_rows, both entries, bit-exact against its
plain version on the same card (no FMA contraction on either side); float
segment_spmv within 1e-5 relative of a float64 sum (atomic order);
walk_step bit-exact from given uniforms and from key words, with and
without its edge output, and its in-place entry at the edges of its tile
of slots (arrivals compared as a histogram); uniform bit-exact against
its plain version on the card and on the CPU, at every ragged tail, and a
misaligned output refused; the
single-device walk engine and Algorithm 2 / Section 5 on the card
bit-exact against the CPU, with no standalone uniform launched; the
sharded engines (walks, counts, and the three-phase Algorithm 2 and
Section 5) and both PPR engines and the PPR service on the card bit-exact
against the same run on the CPU, at counts whose draws stay in the
inverse-CDF regime; the CONGEST audit report on the card equal to the CPU
one; the reduced LM configs' prefill and decode logits within 0.05 of
the CPU's on the same weights, their cache idx and batcher stats equal;
one train step of each reduced config card against CPU (loss within
1e-2, masters within 2.2 lr and 0.05 lr on average).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import prng
from repro_torch.core import aggregate_sampler as agg
from repro_torch.core.collectives import StackedMesh
from repro_torch.core.distributed import distributed_pagerank
from repro_torch.core.distributed_counts import distributed_pagerank_counts
from repro_torch.core.distributed_directed import \
    distributed_directed_pagerank
from repro_torch.core.distributed_improved import (
    distributed_improved_pagerank, plan_three_phase)
from repro_torch.core.improved_pagerank import coupon_pool_sizes
from repro_torch.core.routing import _hist_rows
from repro_torch.graphs import directed_web, erdos_renyi
from repro_torch.kernels import common
from repro_torch.kernels.histogram import histogram
from repro_torch.kernels.histogram import ops as histogram_ops
from repro_torch.kernels.histogram.ref import histogram_ref
from repro_torch.kernels.multinomial_rows import (multinomial_buckets,
                                                  multinomial_rows)
from repro_torch.kernels.multinomial_rows.ref import (multinomial_buckets_ref,
                                                      multinomial_rows_ref)
from repro_torch.kernels.segment_spmv import (hot_list, segment_spmv,
                                              segment_sum_int)
from repro_torch.kernels.segment_spmv.ref import (segment_spmv_ref,
                                                  segment_sum_int_ref)
from repro_torch.core.personalized import personalized_pagerank
from repro_torch.core.personalized_batch import \
    batched_personalized_pagerank
from repro_torch.kernels.uniform import uniform
from repro_torch.kernels.uniform.ref import uniform_ref
from repro_torch.kernels.walk_step import (walk_step, walk_step_keyed,
                                           walk_step_keyed_)
from repro_torch.kernels.walk_step.ops import TILE
from repro_torch.kernels.walk_step.ref import (walk_step_keyed_ref,
                                               walk_step_keyed_ref_,
                                               walk_step_ref)

KEY_WORDS = (0xDEADBEEF, 0x12345678)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    """The card; decided here, not at import, so every worker collects the
    same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _skewed_ids(rng, W, n, hub_share):
    """Ids in [-1, n] with `hub_share` of them on vertex 0 (a web hub)."""
    ids = rng.integers(-1, n + 1, W)
    ids[rng.random(W) < hub_share] = 0
    return torch.from_numpy(ids.astype(np.int32))


def _hub_ids(rng, W, n, hub_share, hubs):
    """Ids in [-3, n + 3) with `hub_share` of them spread over the `hubs`;
    a share of 1 makes every id the first hub."""
    ids = rng.integers(-3, n + 3, W)
    if hub_share >= 1:
        ids[:] = hubs[0]
    else:
        on_hub = rng.random(W) < hub_share
        ids[on_hub] = rng.choice(np.asarray(hubs), int(on_hub.sum()))
    return torch.from_numpy(ids.astype(np.int32))


# (W, n, hub share, hubs); n "max" is the all-shared path's largest n
HISTOGRAM_CASES = {
    "uniform": (2 ** 20 + 7, 2 ** 20, 0.0, (0,)),
    "hub_0.21": (2 ** 20 + 7, 2 ** 20, 0.21, (0,)),
    "hub_0.9": (2 ** 20 + 7, 2 ** 20, 0.9, (0,)),
    "all_same": (2 ** 20 + 7, 2 ** 20, 1.0, (0,)),
    "hub_last": (2 ** 20 + 7, 2 ** 20, 0.21, (2 ** 20 - 1,)),
    "hubs_high": (2 ** 20 + 7, 2 ** 20, 0.3,
                  (2 ** 20 - 1, 2 ** 20 - 2, 987_654, 2 ** 19 + 3)),
    "W0": (0, 2 ** 20, 0.0, (0,)),
    "W1": (1, 2 ** 20, 0.0, (0,)),
    "W31": (31, 2 ** 20, 0.5, (7,)),
    "W33": (33, 2 ** 20, 0.5, (7,)),
    "n1": (2 ** 20 + 7, 1, 0.5, (0,)),
    "n_shared_max": (2 ** 20 + 7, "max", 0.21, (0,)),
    "n_shared_max_plus_1": (2 ** 20 + 7, "max+1", 0.21, (0,)),
    "n_2^22": (2 ** 22 + 3, 2 ** 22, 0.21, (2 ** 22 - 1,)),
    "shared_hub": (1 << 20, 4096, 0.2, (0,)),
    "shared_W0": (0, 5, 0.0, (0,)),
}


@pytest.mark.parametrize("case", list(HISTOGRAM_CASES))
def test_cuda_histogram_matches_plain(cuda, case):
    W, n, hub, hubs = HISTOGRAM_CASES[case]
    if isinstance(n, str):
        n = histogram_ops.shared_max(cuda) + (n == "max+1")
    ids = _hub_ids(np.random.default_rng(1), W, n, hub, hubs)
    before = common.launches["histogram"]
    got = histogram(ids.to(cuda), n)
    again = histogram(ids.to(cuda), n)
    assert common.launches["histogram"] == before + 2
    assert torch.equal(got, again)
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  histogram_ref(ids, n).numpy())


def test_cuda_histogram_unaligned_views(cuda):
    """Views that start 1, 2 or 3 ids past a 16-byte boundary: the ids
    before it and after the last whole int4 are read one by one."""
    ids = _hub_ids(np.random.default_rng(4), 2 ** 20 + 7, 2 ** 20, 0.21,
                   (2 ** 20 - 1,))
    dev = ids.to(cuda)
    for start in (1, 2, 3):
        for n in (4096, 2 ** 20):
            got = histogram(dev[start:], n)
            np.testing.assert_array_equal(
                got.cpu().numpy(), histogram_ref(ids[start:], n).numpy())


def test_cuda_histogram_hot_list_overflow(cuda):
    """Half of the ids on 10,000 ids, each at 1/20,000 of them: each is
    sampled above the low threshold, so more ids are hot than the hot list
    holds; those left off are counted in global memory, exactly."""
    rng = np.random.default_rng(2)
    W, n = 1 << 26, 1 << 20
    ids = rng.integers(-1, n, W, dtype=np.int32)
    warm = rng.random(W) < 0.5
    ids[warm] = rng.choice(rng.permutation(n)[:10_000].astype(np.int32),
                           int(warm.sum()))
    ids = torch.from_numpy(ids)
    dev = ids.to(cuda)
    table, hot = histogram_ops.hot_list(dev, n)
    assert int(hot) > histogram_ops.HOT_CAP
    keys = table[table > 0].cpu().numpy()
    assert len(keys) == histogram_ops.HOT_CAP == len(np.unique(keys))
    assert keys.min() >= 1 and keys.max() <= n
    np.testing.assert_array_equal(histogram(dev, n).cpu().numpy(),
                                  histogram_ref(ids, n).numpy())


def test_cuda_histogram_sharded_rows(cuda):
    """The sharded engines' shape: two rows of `_hist_rows`, each offset by
    its row, with one hub in each row."""
    rng = np.random.default_rng(3)
    n_loc, L = 1 << 19, 1 << 20
    rows = [_hub_ids(rng, L, n_loc, 0.25, (hub,)).numpy()
            for hub in (5, n_loc - 1)]
    ids = torch.from_numpy(np.stack(rows))
    mask = torch.from_numpy(rng.random((2, L)) < 0.8)
    before = common.launches["histogram"]
    got = _hist_rows(ids.to(cuda), mask.to(cuda), n_loc)
    assert common.launches["histogram"] == before + 1
    want = _hist_rows(ids, mask, n_loc)
    assert got.shape == want.shape == (2, n_loc)
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


def test_cuda_segment_spmv_matches_plain(cuda):
    rng = np.random.default_rng(2)
    for hub in (0.0, 0.2):
        dst = _skewed_ids(rng, 1 << 20, 5000, hub)
        val = torch.from_numpy(rng.random(1 << 20).astype(np.float32))
        got = segment_spmv(val.to(cuda), dst.to(cuda), 5000).cpu()
        want = segment_spmv_ref(val.double(), dst, 5000)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5)
        # bound None: float path, exact while every sum stays below 2**24
        for bound, hi in ((None, 2 ** 6), (2 ** 31 - 1, 2 ** 10)):
            ival = torch.from_numpy(
                rng.integers(0, hi, 1 << 20).astype(np.int32))
            got = segment_spmv(ival.to(cuda), dst.to(cuda), 5000,
                               count_bound=bound).cpu()
            np.testing.assert_array_equal(
                got.numpy(), segment_spmv(ival, dst, 5000,
                                          count_bound=bound).numpy())


def test_cuda_multinomial_matches_plain(cuda):
    rng = np.random.default_rng(3)
    for hi, width in ((21, 8), (2 ** 20, 8), (2 ** 28, 17)):
        counts = rng.integers(0, hi, 50000).astype(np.int32)
        deg = rng.integers(0, width + 1, 50000).astype(np.int32)
        rid = np.arange(50000, dtype=np.int32)
        args = [torch.from_numpy(a).to(cuda) for a in (counts, deg, rid)]
        got = multinomial_rows(*args, KEY_WORDS, eps=0.2,
                               width=width).cpu().numpy()
        want = multinomial_rows_ref(*args, KEY_WORDS, eps=0.2,
                                    width=width).cpu().numpy()
        np.testing.assert_array_equal(got.sum(axis=1), counts)
        np.testing.assert_array_equal(got, want)


# (rows, degrees drawn from, count bound, shards); a list of degrees with
# no 3 or 4 leaves bucket 2 empty, a single 17 makes bucket 5 one row, 40
# makes a bucket wider than the kernel's staged rows
BUCKET_CASES = {
    "random": (50_001, list(range(18)), 2 ** 20, None),
    "stacked_P4": (50_001, list(range(18)), 2 ** 20, 4),
    "large_counts": (50_001, list(range(18)), 2 ** 28, None),
    "small_counts": (50_001, list(range(18)), 21, 3),
    "empty_and_one_row_buckets": (4099, [0, 1, 2, 5, 9, 16, 17], 2 ** 12, 2),
    "wide": (20_000, [0, 1, 3, 33, 40], 2 ** 16, None),
    "flat": (20_000, list(range(18)), 2 ** 16, "flat"),
}


@pytest.mark.parametrize("case", list(BUCKET_CASES))
def test_cuda_multinomial_buckets_matches_plain(cuda, case):
    """The fused round against its plain version on the card and against
    the per-bucket kernel round: moves, occupancy and residual exact."""
    rows, choices, hi, shards = BUCKET_CASES[case]
    rng = np.random.default_rng(len(case))
    deg = rng.choice(choices, rows).astype(np.int32)
    if case == "empty_and_one_row_buckets":
        deg[deg == 17] = 16
        deg[-1] = 17
    P = shards if isinstance(shards, int) else 1
    rows = -(-rows // P) * P
    deg = np.concatenate([deg, np.zeros(rows - len(deg), np.int32)])
    counts = rng.integers(0, hi, rows).astype(np.int32)
    counts[rng.random(rows) < 0.2] = 0
    md = int(deg.max())
    if isinstance(shards, int):
        layout, bperm = agg.build_layout_sharded(deg.reshape(P, -1), md)
        layout, perm = agg.stack_shard_perm(bperm, layout)
    else:
        layout, perm = agg.build_layout(deg, md, bucketed=shards != "flat")
    args = [torch.from_numpy(a).to(cuda) for a in
            (counts, deg, np.arange(rows, dtype=np.int32))]
    perm = torch.from_numpy(perm).to(cuda)
    before = common.launches["multinomial_rows"]
    got = multinomial_buckets(*args, KEY_WORDS, perm, layout.widths,
                              layout.caps, eps=0.2, shards=P)
    assert common.launches["multinomial_rows"] == before + 1
    want = multinomial_buckets_ref(*args, KEY_WORDS, perm, layout.widths,
                                   layout.caps, eps=0.2, shards=P)
    samples, occ, res = agg.sample_buckets(*args, KEY_WORDS, perm, layout,
                                           eps=0.2)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[0].reshape(P, -1),
                       agg.flatten_moves(samples, P if P > 1 else None)
                       .reshape(P, -1))
    assert torch.equal(got[1], want[1]) and torch.equal(got[1], occ)
    assert int(got[2]) == int(want[2]) == int(res) == 0
    # every count left over by the terminations went down some edge
    assert int(got[0].sum(dtype=torch.int64)) <= int(counts.sum(
        dtype=np.int64))


@pytest.mark.parametrize("shards,most", [(1, 2 ** 20), (4, 2 ** 12),
                                         (3, 21)])
def test_cuda_multinomial_buckets_cells_match_plain(cuda, shards, most):
    """The fused entry's dense-cell mode over the Phase-1 (home, vertex)
    rows of a three-phase plan, each owner under its own key: exact
    against its plain version on the card and against
    scatter_cells(sample_buckets()) owner by owner, one launch."""
    g = directed_web(2000, 6.0, seed=3, device="cpu")
    _, pool = coupon_pool_sizes(g, 0.2, 8, 3)
    plan = plan_three_phase(g, shards, pool, 8, device=cuda)
    n_loc, md, lay = plan.n_loc, plan.md, plan.layout
    n_pad = shards * n_loc
    rng = np.random.default_rng(shards)
    c = torch.from_numpy(rng.integers(0, most, (shards, n_pad)).astype(
        np.int32)).to(cuda)
    deg_row = plan.sg.out_deg.repeat(1, shards)
    rid = torch.arange(shards * n_pad, dtype=torch.int32, device=cuda)
    keys = torch.stack([prng.split(prng.PRNGKey(p), 3)[1]
                        for p in range(shards)])
    perm = torch.from_numpy(plan.rows_perm).to(cuda)
    args = (c.reshape(-1), deg_row.reshape(-1), rid, keys, perm,
            plan.rows_layout.widths, plan.rows_layout.caps)
    before = common.launches["multinomial_rows"]
    got = multinomial_buckets(*args, eps=0.2, shards=shards, cells=md)
    assert common.launches["multinomial_rows"] == before + 1
    want = multinomial_buckets_ref(*args, eps=0.2, shards=shards, cells=md)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int(got[2]) == int(want[2]) == 0
    cells = got[0].reshape(shards, -1)
    lay_t = lay.tile(shards)
    offs = np.arange(shards)[:, None] * n_loc
    for p in range(shards):
        perm_t = np.concatenate([
            np.where(pb[None, :] < 0, -1, offs + pb[None, :]).reshape(-1)
            for pb in (plan.bperm_np[p, s:s + cap]
                       for s, cap in zip(lay.row_starts, lay.caps))]
        ).astype(np.int32)
        samples, _, _ = agg.sample_buckets(
            c[p], deg_row[p], rid[p * n_pad:(p + 1) * n_pad],
            tuple(keys[p].to(torch.int64).tolist()),
            torch.from_numpy(perm_t).to(cuda), lay_t, eps=0.2)
        assert torch.equal(cells[p], agg.scatter_cells(samples, lay_t, md))
    assert torch.equal(cells.reshape(shards, n_pad, md + 1).sum(-1), c)


def test_cuda_three_phase_engines_match_cpu(cuda):
    """Both three-phase engines on the card against the CPU at P=1 and 4,
    and with eta=1, where the naive tail launches walk_step."""
    g_cpu = erdos_renyi(96, 5.0, seed=1, device="cpu")
    g = g_cpu.to(cuda)
    key = prng.PRNGKey(5)
    for fn, kw in ((distributed_improved_pagerank, {}),
                   (distributed_directed_pagerank, {}),
                   (distributed_improved_pagerank, dict(eta=1))):
        for shards in (1, 4):
            common.reset_launches()
            a = fn(g, 0.2, 8, key, mesh=StackedMesh(shards, cuda), **kw)
            for name in ("histogram", "segment_spmv", "multinomial_rows"):
                assert common.launches[name] > 0, name
            assert (common.launches["walk_step"] > 0) == (a.tail_rounds > 0)
            b = fn(g_cpu, 0.2, 8, key, mesh=StackedMesh(shards, "cpu"), **kw)
            assert torch.equal(a.zeta.cpu(), b.zeta)
            for f in ("rounds", "a2a_bytes_by_phase", "p1_occupancy",
                      "coupons_used", "tail_walks", "residual", "dropped"):
                assert getattr(a, f) == getattr(b, f), f


def _spmv_ids(rng, case, e, n):
    """Ids in [-5, n + 5) shaped by `case`: a hub taking 90% of them, every
    id the same, or 10,000 warm ids taking half of them, each too common
    for the hot list to hold them all."""
    ids = rng.integers(-5, n + 5, e)
    if case in ("hub_0.9", "zeros_at_hub"):
        ids[rng.random(e) < 0.9] = 0
    elif case == "all_equal":
        ids[:] = n - 1
    elif case == "overfull":
        warm = rng.random(e) < 0.5
        ids[warm] = rng.choice(rng.permutation(n)[:10_000], int(warm.sum()))
    return torch.from_numpy(ids.astype(np.int32))


SPMV_CASES = ["hub_0.9", "zeros_at_hub", "uniform", "all_equal", "overfull",
              "unaligned", "E0"]


@pytest.mark.parametrize("case", SPMV_CASES)
def test_cuda_segment_spmv_hot_list_matches_plain(cuda, case):
    """Both entries against the plain version, with the hot list built in
    the call and passed in: the integer sums exact, the float sums within
    1e-5 of the float64 sum."""
    rng = np.random.default_rng(len(case))
    e = {"E0": 0, "overfull": 1 << 26}.get(case, (1 << 22) + 3)
    n = 1 << 20
    dst = _spmv_ids(rng, case, e, n)
    ival = torch.from_numpy(rng.integers(0, 1000, e).astype(np.int32))
    fval = torch.from_numpy(rng.random(e).astype(np.float32))
    if case == "zeros_at_hub":
        ival[dst == 0] = 0
        fval[(dst == 0) & torch.from_numpy(rng.random(e) < 0.5)] = 0
    views = [(0, 0)] if case != "unaligned" else [(1, 1), (2, 1), (3, 0)]
    d_dst, d_ival, d_fval = dst.to(cuda), ival.to(cuda), fval.to(cuda)
    if case == "overfull":
        _, hot = histogram_ops.hot_list(d_dst, n)
        assert int(hot) > histogram_ops.HOT_CAP
    for sv, sd in views:
        # values and ids starting sv and sd ids past a 16-byte boundary
        m = e - max(sv, sd)
        dv, dd = slice(sv, sv + m), slice(sd, sd + m)
        want_i = segment_sum_int_ref(ival[dv], dst[dd], n)
        want_f = segment_spmv_ref(fval[dv].double(), dst[dd], n)
        hot = hot_list(d_dst[dd], n)
        before = common.launches["segment_spmv"]
        for kw in ({}, {"hot": hot}):
            got_i = segment_sum_int(d_ival[dv], d_dst[dd], n, **kw)
            np.testing.assert_array_equal(got_i.cpu().numpy(),
                                          want_i.numpy())
            got_f = segment_spmv(d_fval[dv], d_dst[dd], n, **kw)
            np.testing.assert_allclose(got_f.cpu().numpy(), want_f.numpy(),
                                       rtol=1e-5)
        assert common.launches["segment_spmv"] == before + 4


def test_cuda_wrappers_refuse_bad_inputs(cuda):
    with pytest.raises(ValueError):
        histogram(torch.zeros(4, dtype=torch.int64, device=cuda), 3)
    with pytest.raises(ValueError):
        segment_spmv(torch.zeros(4, device=cuda),
                     torch.zeros(3, dtype=torch.int32, device=cuda), 3)
    ids = torch.zeros(4, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        segment_sum_int(ids, ids, 3, hot=torch.zeros(8, dtype=torch.int32,
                                                     device=cuda))
    with pytest.raises(ValueError):   # a bucket that splits a shard
        multinomial_buckets(ids, ids, ids, KEY_WORDS, ids, (1, 2), (1, 3),
                            eps=0.2, shards=2)


def test_cuda_walk_step_matches_plain(cuda):
    g = directed_web(5000, 6.0, seed=1, device=cuda)
    tables = (g.row_ptr, g.col_idx, g.out_deg)
    rng = np.random.default_rng(4)
    W = 1 << 20
    pos = torch.from_numpy(rng.integers(-2, g.n + 2, W).astype(np.int32))
    alive = torch.from_numpy((rng.random(W) < 0.8).astype(np.int32))
    u = [torch.from_numpy(rng.random(W).astype(np.float32)) for _ in "ab"]
    pos, alive, u = pos.to(cuda), alive.to(cuda), [x.to(cuda) for x in u]
    before = common.launches["walk_step"]
    got = walk_step(pos, alive, *u, *tables, eps=0.2)
    want = walk_step_ref(pos, alive, *u, *tables, eps=0.2)
    kt, ke = prng.split(prng.PRNGKey(9))
    got_b = walk_step_keyed(pos, alive, kt, ke, *tables, eps=0.2)
    want_b = walk_step_keyed_ref(pos, alive, kt, ke, *tables, eps=0.2)
    got_e = walk_step_keyed(pos, alive, kt, ke, *tables, eps=0.2, edges=True)
    want_e = walk_step_keyed_ref(pos, alive, kt, ke, *tables, eps=0.2,
                                 edges=True)
    # a bool `alive`, as the single-device engines keep it
    got_o = walk_step_keyed(pos, alive.bool(), kt, ke, *tables, eps=0.2,
                            edges=True)
    want_o = walk_step_keyed_ref(pos, alive.bool(), kt, ke, *tables, eps=0.2,
                                 edges=True)
    assert common.launches["walk_step"] == before + 4
    assert len(got_e) == 3 and got_o[1].dtype == torch.bool
    for a, b in zip(got + got_b + got_e + got_o,
                    want + want_b + want_e + want_o):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert int(got_b[1].sum()) > 0
    assert bool((got_e[2] == -1).any()) and bool((got_e[2] >= 0).any())
    assert torch.equal(got_o[1], got_e[1].bool())


@pytest.mark.parametrize("outputs", ["none", "edge", "arrivals", "both"])
@pytest.mark.parametrize("alive_dtype", [torch.bool, torch.int32])
@pytest.mark.parametrize("W", [0, 1, TILE - 1, TILE, TILE + 1,
                               3 * TILE + 17])
def test_cuda_walk_step_inplace_tile_edges(cuda, W, alive_dtype, outputs):
    """The in-place keyed entry against its plain version at the edges of
    the kernel's tile of slots, on a view of `alive` that is not 16-byte
    aligned too: pos and alive bit for bit, dead slots untouched, the edge
    ids, and the appended arrivals as a histogram with their count."""
    g = directed_web(5000, 6.0, seed=1, device=cuda)
    tables = (g.row_ptr, g.col_idx, g.out_deg)
    rng = np.random.default_rng(W)
    pos0 = torch.from_numpy(rng.integers(-2, g.n + 2, W).astype(np.int32))
    live = torch.from_numpy(rng.random(W) < 0.7)
    kt, ke = prng.split(prng.PRNGKey(W + 1))
    for offset in (0, 3):
        base = torch.zeros(W + offset, dtype=alive_dtype)
        base[offset:] = live.to(alive_dtype)
        runs = []
        for fn in (walk_step_keyed_, walk_step_keyed_ref_):
            alive = base.to(cuda)[offset:]
            pos = pos0.to(cuda)
            edge = (torch.full_like(pos, 7) if outputs in ("edge", "both")
                    else None)
            arr = (torch.full_like(pos, 7) if outputs in ("arrivals", "both")
                   else None)
            count = fn(pos, alive, kt, ke, *tables, eps=0.2, edge=edge,
                       arrivals=arr)
            runs.append((pos, alive, edge, arr, count))
        (pos, alive, edge, arr, count), (r_pos, r_alive, r_edge, r_arr,
                                         r_count) = runs
        assert torch.equal(pos, r_pos) and torch.equal(alive, r_alive)
        dead = ~live.to(cuda)
        assert torch.equal(pos[dead], pos0.to(cuda)[dead])
        if edge is not None:
            assert torch.equal(edge, r_edge)
        if arr is None:
            assert count is None
            continue
        moved = int(count)
        assert moved == int(r_count) == int(r_alive.bool().sum())
        assert torch.equal(histogram_ref(arr[:moved], g.n),
                           histogram_ref(r_arr[:moved], g.n))
        assert bool((arr[moved:] == 7).all())
    torch.cuda.synchronize()


def test_cuda_sharded_engines_match_cpu(cuda):
    g_cpu = directed_web(300, 5.0, seed=2, device="cpu")
    g = g_cpu.to(cuda)
    key = prng.PRNGKey(5)
    for shards in (1, 4):
        common.reset_launches()
        a = distributed_pagerank(g, 0.2, 8, key,
                                 mesh=StackedMesh(shards, cuda))
        assert common.launches["walk_step"] == shards * a.rounds
        b = distributed_pagerank(g_cpu, 0.2, 8, key,
                                 mesh=StackedMesh(shards, "cpu"))
        assert torch.equal(a.zeta.cpu(), b.zeta)
        assert (a.rounds, a.round_active, a.a2a_bytes_total) == \
            (b.rounds, b.round_active, b.a2a_bytes_total)
        for packed in (True, False):
            c = distributed_pagerank_counts(g, 0.2, 8, key, packed=packed,
                                            mesh=StackedMesh(shards, cuda))
            d = distributed_pagerank_counts(g_cpu, 0.2, 8, key, packed=packed,
                                            mesh=StackedMesh(shards, "cpu"))
            assert torch.equal(c.zeta.cpu(), d.zeta)
            assert (c.rounds, c.a2a_bytes_total, c.occupancy) == \
                (d.rounds, d.a2a_bytes_total, d.occupancy)


def test_cuda_nccl_world_one_matches_stacked(cuda, tmp_path):
    """An NCCL group of one process on the card: Algorithm 1's engines,
    Algorithm 2 and Section 5 through `ProcessGroupMesh` equal
    `StackedMesh(1)` bit for bit, and launch the kernels under the
    group."""
    import datetime
    import torch.distributed as dist
    from repro_torch.core.collectives import ProcessGroupMesh
    card = torch.device("cuda", torch.cuda.current_device())
    g = directed_web(300, 5.0, seed=2, device=card)
    key = prng.PRNGKey(5)
    dist.init_process_group(
        "nccl", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=60), device_id=card)
    try:
        mesh = ProcessGroupMesh(device=card)
        common.reset_launches()
        a = distributed_pagerank(g, 0.2, 8, key, mesh=mesh)
        c = distributed_pagerank_counts(g, 0.2, 8, key, mesh=mesh,
                                        packed=False)
        assert common.launches["walk_step"] == a.rounds
        assert common.launches["multinomial_rows"] == c.rounds
        assert common.launches["segment_spmv"] > 0
        assert common.launches["histogram"] > 0
        # eta = 1: most walks finish in the tail, which launches walk_step
        common.reset_launches()
        e = distributed_improved_pagerank(g, 0.2, 8, key, mesh=mesh, eta=1)
        f = distributed_directed_pagerank(g, 0.2, 8, key, mesh=mesh)
        assert e.tail_walks > 0
        assert all(common.launches[k] > 0 for k in common.launches)
    finally:
        dist.destroy_process_group()
    b = distributed_pagerank(g, 0.2, 8, key, mesh=StackedMesh(1, card))
    d = distributed_pagerank_counts(g, 0.2, 8, key, packed=False,
                                    mesh=StackedMesh(1, card))
    assert torch.equal(a.zeta, b.zeta) and a.rounds == b.rounds
    assert a.round_active == b.round_active
    assert torch.equal(c.zeta, d.zeta) and c.rounds == d.rounds
    assert (c.a2a_bytes_total, c.occupancy, c.residual) == \
        (d.a2a_bytes_total, d.occupancy, d.residual)
    for got, want in (
            (e, distributed_improved_pagerank(g, 0.2, 8, key, eta=1,
                                              mesh=StackedMesh(1, card))),
            (f, distributed_directed_pagerank(g, 0.2, 8, key,
                                              mesh=StackedMesh(1, card)))):
        assert torch.equal(got.zeta, want.zeta)
        assert all(getattr(got, k) == getattr(want, k) for k in (
            "rounds", "phase1_rounds", "phase2_rounds", "tail_rounds",
            "coupons_used", "tail_walks", "exhausted_walks",
            "terminated_by_coupon", "dropped", "waited",
            "a2a_bytes_by_phase", "a2a_entries_by_site", "phase2_records",
            "p1_occupancy", "residual"))


def test_cuda_nccl_world_one_ppr_matches_stacked(cuda, tmp_path):
    """Batched PPR and the service through `ProcessGroupMesh` on an NCCL
    group of one process equal `StackedMesh(1)` bit for bit on the card
    (every vector, supersteps, entries, bytes; the service's result and
    counters after one step and at the end), and the superstep launches
    its three kernels under the group."""
    import datetime
    import torch.distributed as dist
    from repro_torch.core.collectives import ProcessGroupMesh
    from repro_torch.serve import PPRService
    card = torch.device("cuda", torch.cuda.current_device())
    g = directed_web(300, 5.0, seed=2, device=card)
    queries = [([0, 5], None), ([17], None), ([3, 40], [0.8, 0.2])]
    key = prng.PRNGKey(2)
    fields = ("rounds", "active_trace", "a2a_entries", "a2a_bytes",
              "dropped", "admit_dropped")

    def serve(mesh):
        svc = PPRService(g, 0.25, slots=2, walks_per_query=2048, mesh=mesh)
        a = svc.submit([3], now=0.0)
        b = svc.submit([10, 17], now=0.0)
        svc.step(now=0.0)
        first = (svc.stats.supersteps, svc.engine.active.tolist())
        svc.drain(now=0.0)
        return first, a.result, b.result, dataclasses.asdict(svc.stats)

    dist.init_process_group(
        "nccl", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=60), device_id=card)
    try:
        mesh = ProcessGroupMesh(device=card)
        common.reset_launches()
        got = batched_personalized_pagerank(g, 0.25, queries, 1500, key,
                                            mesh=mesh)
        assert all(common.launches[k] > 0 for k in (
            "walk_step", "histogram", "segment_spmv"))
        got_svc = serve(mesh)
    finally:
        dist.destroy_process_group()
    want = batched_personalized_pagerank(g, 0.25, queries, 1500, key,
                                         mesh=StackedMesh(1, card))
    assert np.array_equal(got.ppr, want.ppr)
    assert all(getattr(got, f) == getattr(want, f) for f in fields)
    assert got.dropped == 0 and got.active_trace[-1] == 0
    want_svc = serve(StackedMesh(1, card))
    assert got_svc[0] == want_svc[0]
    assert np.array_equal(got_svc[1], want_svc[1])
    assert np.array_equal(got_svc[2], want_svc[2])
    assert got_svc[3] == want_svc[3]


@pytest.mark.parametrize("seed", [0, 7, 2 ** 32 - 1])
@pytest.mark.parametrize("shape", [(0,), (1,), (1000,), (3, 4099),
                                   (1 << 22,)])
def test_cuda_uniform_matches_plain(cuda, seed, shape):
    key = prng.PRNGKey(seed)
    before = common.launches["uniform"]
    got = uniform(key, shape, device=cuda)
    assert got.shape == shape and got.device.type == "cuda"
    assert common.launches["uniform"] == before + (1 if got.numel() else 0)
    want = uniform_ref(key, shape, device=cuda)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    host = uniform_ref(key, shape)
    assert torch.equal(got.cpu().view(torch.int32), host.view(torch.int32))
    # prng.uniform on the card is the kernel
    assert torch.equal(prng.uniform(key, shape, device=cuda), got)


@pytest.mark.parametrize("tail", [0, 1, 2, 3])
def test_cuda_uniform_ragged_sizes(cuda, tail):
    """Sizes below a quad and sizes of whole quads plus `tail` floats:
    bit-equal to the plain version."""
    key = prng.PRNGKey(21)
    for quads in (0, 1, 2, 1023, 1 << 18):
        size = 4 * quads + tail
        got = uniform(key, (size,), device=cuda)
        want = uniform_ref(key, (size,))
        assert torch.equal(got.cpu().view(torch.int32),
                           want.view(torch.int32))


def test_cuda_uniform_refuses_a_misaligned_output(cuda):
    """The kernel's C entry takes a 16-byte aligned output only: an
    address 4 bytes past one is refused with cudaErrorMisalignedAddress
    and nothing is written."""
    import ctypes
    buf = torch.zeros(64, dtype=torch.float32, device=cuda)
    fn = common.library("uniform").uniform_launch
    fn.argtypes = [ctypes.c_uint32, ctypes.c_uint32, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream, sms = common.launch_args(buf)
    assert fn(0, 7, 16, buf.data_ptr() + 4, sms, stream) == 716
    torch.cuda.synchronize()
    assert not bool(buf.any())
    assert fn(0, 7, 16, buf.data_ptr(), sms, stream) == 0
    torch.cuda.synchronize()
    assert torch.equal(buf[:16].cpu(), uniform_ref(prng.PRNGKey(7), (16,)))


def test_cuda_single_device_engines_match_cpu(cuda):
    """The single-device walk engine, Algorithm 2 and Section 5 on the card
    against the CPU, bit for bit: every draw inside the keyed walk step, one
    launch a round or coupon step, no standalone uniform."""
    from repro_torch.core import (directed_local_pagerank, engine_walks,
                                  improved_pagerank)
    g_cpu = directed_web(300, 5.0, seed=2, device="cpu")
    g = g_cpu.to(cuda)
    key = prng.PRNGKey(5)
    common.reset_launches()
    a = engine_walks.run(g, 0.2, 8, key)
    assert common.launches["walk_step"] == a.round
    t, traces = engine_walks.run_traced(g, 0.2, 8, key)
    b = engine_walks.run(g_cpu, 0.2, 8, key)
    u, traces_cpu = engine_walks.run_traced(g_cpu, 0.2, 8, key)
    assert torch.equal(a.zeta.cpu(), b.zeta) and a.round == b.round
    assert torch.equal(t.zeta.cpu(), u.zeta) and traces == traces_cpu
    for fn in (improved_pagerank, directed_local_pagerank):
        c = fn(g, 0.2, walks_per_node=8, key=key, device=cuda)
        d = fn(g_cpu, 0.2, walks_per_node=8, key=key, device="cpu")
        assert torch.equal(c.zeta.cpu(), d.zeta)
        assert c.report.summary() == d.report.summary()
    assert common.launches["uniform"] == 0


def test_cuda_ppr_engines_match_cpu(cuda):
    g_cpu = directed_web(300, 5.0, seed=2, device="cpu")
    g = g_cpu.to(cuda)
    key = prng.PRNGKey(5)
    common.reset_launches()
    a = personalized_pagerank(g, 0.2, [0, 7], 3000, key=key, device=cuda)
    # the draws are made inside the keyed walk step
    assert common.launches["uniform"] == 0
    assert common.launches["walk_step"] > 0
    assert common.launches["histogram"] > 0
    b = personalized_pagerank(g_cpu, 0.2, [0, 7], 3000, key=key,
                              device="cpu")
    assert torch.equal(a.cpu(), b)
    queries = [([0, 5], None), ([17], None), ([3, 40], [0.8, 0.2])]
    for shards in (1, 4):
        common.reset_launches()
        c = batched_personalized_pagerank(g, 0.2, queries, 2000, key,
                                          mesh=StackedMesh(shards, cuda))
        for name in ("walk_step", "histogram", "segment_spmv"):
            assert common.launches[name] > 0, name
        d = batched_personalized_pagerank(g_cpu, 0.2, queries, 2000, key,
                                          mesh=StackedMesh(shards, "cpu"))
        assert np.array_equal(c.ppr, d.ppr)
        assert (c.rounds, c.active_trace, c.a2a_bytes, c.dropped) == \
            (d.rounds, d.active_trace, d.a2a_bytes, d.dropped)


def test_cuda_audit_report_matches_cpu(cuda):
    """The CONGEST audit on the card: clean, its engines' kernels launched,
    and the same report as on the CPU (the runs are bit-exact, and the
    lints see no op inside a kernel on either device)."""
    from repro_torch.analysis.congest import audit_all_engines
    common.reset_launches()
    a = audit_all_engines(StackedMesh(8, cuda))
    for name in ("walk_step", "histogram", "segment_spmv",
                 "multinomial_rows", "uniform"):
        assert common.launches[name] > 0, name
    b = audit_all_engines(StackedMesh(8, "cpu"))
    assert a["ok"] and a["violations_total"] == 0
    assert a.pop("device") == "cuda" and b.pop("device") == "cpu"
    assert a == b


LM_ARCHS = ["dbrx-132b", "deepseek-v2-236b", "h2o-danube-3-4b",
            "internvl2-1b", "nemotron-4-340b", "qwen2-7b", "qwen3-32b",
            "mamba2-1.3b", "recurrentgemma-9b", "whisper-tiny"]


def idx_leaves(cache, prefix=""):
    """path -> every idx leaf of a nested LM cache, on the CPU."""
    out = {}
    for name, t in cache.items():
        if isinstance(t, dict):
            out.update(idx_leaves(t, f"{prefix}{name}."))
        elif name == "idx":
            out[prefix + name] = t.cpu()
    return out


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_cuda_lm_reduced_matches_cpu(cuda, arch):
    """The reduced LM configs on the card against the same weights on the
    CPU: prefill and decode logits within 0.05 of the largest |logit|
    (bf16 matmuls round in other places in cuBLAS), the cache's idx
    equal, and the batcher's accounting equal."""
    from repro_torch.configs import reduced_config
    from repro_torch.models import get_model
    from repro_torch.serve import ContinuousBatcher, Request

    cfg = reduced_config(arch)
    cpu = get_model(cfg)(cfg, device="cpu", seed=0)
    card = get_model(cfg)(cfg, device=cuda, seed=None)
    card.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 25)))
    outs = []
    for m in (cpu, card):
        pre, cache = m.prefill(toks[:, :24].to(m.device), q_chunk=8,
                               pad_cache_to=72)
        dec, cache = m.decode_step(cache, toks[:, 24:].to(m.device))
        outs.append((pre.cpu(), dec.cpu(), idx_leaves(cache)))
    for a, b in zip(outs[0][:2], outs[1][:2]):
        assert float((a - b).abs().max() / a.abs().max()) < 0.05
    assert outs[0][2].keys() == outs[1][2].keys()
    for k in outs[0][2]:
        assert torch.equal(outs[0][2][k], outs[1][2][k])
    prompts = [rng.integers(0, cfg.vocab_size, 9 + 5 * i).astype(np.int32)
               for i in range(3)]
    stats = []
    for m in (cpu, card):
        reqs = [Request(rid=i, prompt=p, max_new_tokens=n)
                for i, (p, n) in enumerate(zip(prompts, (1, 4, 6)))]
        stats.append(vars(ContinuousBatcher(m, slots=2, max_seq=40).run(reqs)))
    assert stats[0] == stats[1]


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_cuda_lm_train_step_matches_cpu(cuda, arch):
    """One train step (two microbatches, AdamW lr 1e-3) of each reduced
    config on the card against the same step on the CPU, same weights and
    batch (level 2: bf16 matmuls round in other places in cuBLAS, and
    CUDA's atomic index_add_ and embedding backward sum in no fixed
    order): loss within 1e-2 relative; the masters within 2.2 lr (an
    entry with a near-zero gradient may take its first Adam step the
    other way) and within 0.05 lr on average."""
    from repro_torch.configs import reduced_config
    from repro_torch.convert import lm_param_tree
    from repro_torch.data import DataConfig, SyntheticTokens
    from repro_torch.launch.train import make_batch
    from repro_torch.models import get_model
    from repro_torch.train import AdamWConfig, init_state, make_train_step
    from repro_torch.train.optimizer import tree_leaves

    cfg = reduced_config(arch)
    nb = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                    global_batch=4)).batch_at(0)
    cpu = get_model(cfg)(cfg, device="cpu", seed=0)
    card = get_model(cfg)(cfg, device=cuda, seed=None)
    card.load_state_dict(cpu.state_dict())
    adam = AdamWConfig(lr=1e-3)
    res = []
    for m in (cpu, card):
        step = make_train_step(cfg, m, adam, num_microbatches=2,
                               loss_kwargs=dict(q_chunk=8))
        state, met = step(init_state(lm_param_tree(m), adam),
                          make_batch(cfg, nb, m.device))
        res.append((state, float(met["loss"])))
    assert abs(res[0][1] - res[1][1]) <= 1e-2 * abs(res[0][1])
    total, count = 0.0, 0
    for a, b in zip(tree_leaves(res[0][0].master),
                    tree_leaves(res[1][0].master)):
        d = (a - b.cpu()).abs()
        assert float(d.max()) <= 2.2 * adam.lr
        total, count = total + float(d.sum()), count + d.numel()
    assert total / count <= 0.05 * adam.lr
