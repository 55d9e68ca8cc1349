"""The fused round of the degree-bucketed sampler and the hot list of the
segment sums, on the CPU.

One `multinomial_buckets` call over every bucket (its plain version here)
against the per-bucket round: the port's `sample_buckets` +
`flatten_moves`, and the JAX package's (`sample_buckets` per shard, as its
sharded engine runs it, through its plain reference). Layouts: the
single-device layout and the stacked layout of P in {1, 3, 8} shards, on
the shared fixtures and on a degree vector made to have an empty bucket, a
bucket of one row, padding rows, rows of degree 0 and rows of count 0.

Parity level: bit-exact (integer counts from the same counter-hash
draws): the per-edge moves, the occupancy and the residual. Against JAX
the counts stay <= 20, where every draw takes the BINV branch
(tests/test_torch_kernels.py says why); against the port's per-bucket
round they reach 2**28.

The hot list (`segment_spmv.hot_list`, the plain version of `histogram`'s
sample and hot-list passes here): which ids it holds, and that it never
changes a sum.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregate_sampler as j_agg

from repro_torch.core import aggregate_sampler as agg
from repro_torch.core.graph import padded_adjacency_np
from repro_torch.kernels.histogram import ops as histogram_ops
from repro_torch.kernels.multinomial_rows import multinomial_buckets
from repro_torch.kernels.segment_spmv import (hot_list, segment_spmv,
                                              segment_sum_int)
from repro_torch.kernels.segment_spmv.ops import HOT_HITS
from repro_torch.kernels.segment_spmv.ref import segment_sum_int_ref

KEY_WORDS = (0x9E3779B9, 0x7F4A7C15)
EPS = 0.2
GRAPH_NAMES = ["ring", "grid", "er", "ba", "ba_hub", "dweb"]


def _made_degrees():
    """Degrees 0-17 with bucket 2 (degrees 3-4) empty and bucket 5
    (degrees 17, the widest) holding one row."""
    rng = np.random.default_rng(11)
    deg = rng.choice([0, 1, 2, 5, 6, 7, 8, 9, 12, 16], 61)
    return np.concatenate([deg, [17]]).astype(np.int32)


def _degrees(small_graphs, name):
    if name == "made":
        return _made_degrees()
    return np.asarray(small_graphs[name].out_deg, np.int32)


def _inputs(deg, shards, hi, seed):
    """(deg, counts, rid) over the padded rows of `shards` shards (None:
    one device): counts in [0, hi), a quarter of them 0; padding rows
    have degree and count 0."""
    n = len(deg)
    rows = n if shards is None else -(-n // shards) * shards
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, hi, rows).astype(np.int32)
    counts[rng.random(rows) < 0.25] = 0
    counts[n:] = 0
    deg = np.concatenate([deg, np.zeros(rows - n, np.int32)])
    return deg, counts, np.arange(rows, dtype=np.int32)


def _port_layout(deg, shards):
    """(layout the sampler runs, its perm, shards or None)."""
    md = max(int(deg.max()), 1)
    if shards is None:
        layout, perm = agg.build_layout(deg, md)
        return layout, perm, None
    layout, bperm = agg.build_layout_sharded(deg.reshape(shards, -1), md)
    stacked, perm = agg.stack_shard_perm(bperm, layout)
    return stacked, perm, shards


def _fused(deg, counts, rid, shards):
    layout, perm, p = _port_layout(deg, shards)
    moves, occ, res = multinomial_buckets(
        *(torch.from_numpy(a) for a in (counts, deg, rid)), KEY_WORDS,
        torch.from_numpy(perm), layout.widths, layout.caps, eps=EPS,
        shards=p or 1)
    assert moves.dtype == occ.dtype == torch.int32
    assert moves.shape == (layout.total_edges,)
    if p is not None:
        moves = moves.reshape(p, -1)
    return moves.numpy(), occ.numpy(), int(res)


def _per_bucket(deg, counts, rid, shards):
    layout, perm, p = _port_layout(deg, shards)
    samples, occ, res = agg.sample_buckets(
        *(torch.from_numpy(a) for a in (counts, deg, rid)), KEY_WORDS,
        torch.from_numpy(perm), layout, eps=EPS)
    return agg.flatten_moves(samples, p).numpy(), occ.numpy(), int(res)


def _jax(deg, counts, rid, shards):
    """The JAX package's round: one `sample_buckets` per shard, with each
    shard's own layout rows and global row ids, as its sharded engine."""
    md = max(int(deg.max()), 1)
    kw = jnp.asarray(np.array(KEY_WORDS, np.uint32))
    P = 1 if shards is None else shards
    if shards is None:
        layout, bperm = j_agg.build_layout(deg, md)
        bperm = bperm[None]
    else:
        layout, bperm = j_agg.build_layout_sharded(deg.reshape(P, -1), md)
    moves, occ, res = [], 0, 0
    for p, rows in enumerate(np.split(np.arange(len(deg)), P)):
        samples, o, r = j_agg.sample_buckets(
            jnp.asarray(counts[rows]), jnp.asarray(deg[rows]),
            jnp.asarray(rid[rows]), kw, bperm[p], layout, eps=EPS,
            use_pallas=False)
        moves.append(np.asarray(j_agg.flatten_moves(samples)))
        occ, res = occ + np.asarray(o), res + int(r)
    moves = np.stack(moves)
    return (moves[0] if shards is None else moves), occ, res


@pytest.mark.parametrize("shards", [None, 1, 3, 8],
                         ids=["device", "P1", "P3", "P8"])
@pytest.mark.parametrize("name", GRAPH_NAMES + ["made"])
def test_fused_round_matches_per_bucket_and_jax(small_graphs, name, shards):
    deg, counts, rid = _inputs(_degrees(small_graphs, name), shards, 21,
                               len(name))
    got = _fused(deg, counts, rid, shards)
    for want in (_per_bucket(deg, counts, rid, shards),
                 _jax(deg, counts, rid, shards)):
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2] == want[2] == 0
    # every row's count is either terminated or sent down one of its edges
    assert got[0].sum() <= counts.sum()


@pytest.mark.parametrize("shards", [None, 3])
def test_fused_round_large_counts(small_graphs, shards):
    """Counts up to 2**28 (the normal branch): the fused round equals the
    port's per-bucket round bit for bit."""
    deg, counts, rid = _inputs(_degrees(small_graphs, "ba_hub"), shards,
                               2 ** 28, 5)
    got = _fused(deg, counts, rid, shards)
    want = _per_bucket(deg, counts, rid, shards)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_fused_round_lands_on_the_bucketed_adjacency(small_graphs):
    """Summing the fused round's moves by `bucketize_adjacency`'s
    destinations gives each vertex the counts its in-edges carried: the
    per-edge words sit where the adjacency expects them."""
    g = small_graphs["dweb"]
    rp, col, deg = (np.asarray(a) for a in (g.row_ptr, g.col_idx,
                                            g.out_deg))
    nbr, _ = padded_adjacency_np(rp, col, deg, g.max_out_deg)
    layout, perm = agg.build_layout(deg, nbr.shape[1])
    bnbr = agg.bucketize_adjacency(nbr, perm, layout)
    _, counts, rid = _inputs(deg.astype(np.int32), None, 21, 3)
    moves, _, _ = _fused(deg.astype(np.int32), counts, rid, None)
    samples, _, _ = agg.sample_buckets(
        *(torch.from_numpy(a) for a in (counts, deg.astype(np.int32), rid)),
        KEY_WORDS, torch.from_numpy(perm), layout, eps=EPS)
    # row r's edge j counts, from the per-bucket samples, summed by target
    want = np.zeros(g.n, np.int64)
    for (rows, T), w in zip(samples, layout.widths):
        for r, t in zip(rows.numpy(), T.numpy()):
            if r >= 0:
                np.add.at(want, nbr[r, :w], t[1:])
    np.testing.assert_array_equal(np.bincount(bnbr, moves, g.n), want)


# ------------------------------------------------------------- the hot list

def _sampled(ids):
    pos = np.arange(len(ids))
    return ids[pos % histogram_ops.SAMPLE_STRIDE < histogram_ops.SAMPLE_CHUNK]


def _keys(table):
    t = table.numpy()
    return set((t[t > 0] - 1).tolist())


@pytest.mark.parametrize("case", ["hub", "padding_at_0", "short"])
def test_hot_list_plan(case):
    """The ids sampled at least the low threshold's count make the list;
    each sits at its hash slot or after it with no gap (so the kernel's
    probe finds it)."""
    rng = np.random.default_rng(7)
    n, w = 1 << 16, (1 << 20) + 123
    ids = rng.integers(-2, n + 2, w).astype(np.int32)
    if case == "hub":
        ids[rng.random(w) < 0.3] = 4321
    elif case == "padding_at_0":
        # the count engines' adjacency: a fifth of the slots are padding on
        # vertex 0, and vertex 7 is an in-degree hub
        ids[rng.random(w) < 0.2] = 0
        ids[rng.random(w) < 0.1] = 7
    else:
        w = HOT_HITS - 1
        ids = np.zeros(w, np.int32)
    table = hot_list(torch.from_numpy(ids), n)
    if case == "short":
        assert table is None   # fewer ids than any hot id needs
        return
    assert table.dtype == torch.int32
    assert table.shape == (1 << histogram_ops.HOT_BITS,)
    low, _ = histogram_ops.hot_thresholds(w, HOT_HITS)
    s = _sampled(ids)
    counts = np.bincount(s[(s >= 0) & (s < n)], minlength=n)
    want = set(np.nonzero(counts >= low)[0].tolist())
    assert _keys(table) == want and len(want) <= histogram_ops.HOT_CAP
    assert {4321} <= want if case == "hub" else {0, 7} <= want
    t = table.numpy()
    bits = histogram_ops.HOT_BITS
    for v in want:
        s = ((v * 0x9E3779B1) & 0xFFFFFFFF) >> (32 - bits)
        while t[s] != v + 1:
            assert t[s] != 0
            s = (s + 1) % len(t)


def test_hot_list_overfull_keeps_cap():
    """More ids reach the low threshold than the list holds: it keeps
    HOT_CAP of them, every id that reached the high threshold among them,
    and `hot` counts them all."""
    rng = np.random.default_rng(3)
    n, w = 1 << 20, 1 << 24
    ids = rng.choice(np.arange(0, 3 * 5000, 3, dtype=np.int32), w)
    ids[rng.random(w) < 0.05] = 99_999
    table, hot = histogram_ops.hot_list(torch.from_numpy(ids), n)
    keys = _keys(table)
    assert len(keys) == histogram_ops.HOT_CAP < int(hot)
    assert 99_999 in keys


@pytest.mark.parametrize("dtype", ["int", "float"])
def test_segment_sums_ignore_hot_list_and_zeros(dtype):
    """The hot list never changes a sum (`hot=` equals no argument), and
    slots with a value of 0 change nothing: dropping them, wherever they
    point, leaves every sum as it was. Integer sums bit-exact, float sums
    bit-exact on the CPU (the same plain version)."""
    rng = np.random.default_rng(5)
    n, e = 5000, 200_000
    dst = rng.integers(-3, n + 3, e).astype(np.int32)
    dst[rng.random(e) < 0.5] = 0
    if dtype == "int":
        val = rng.integers(0, 1000, e).astype(np.int32)
    else:
        val = rng.random(e).astype(np.float32)
    val[(dst == 0) & (rng.random(e) < 0.8)] = 0
    d, v = torch.from_numpy(dst), torch.from_numpy(val)
    keep = torch.from_numpy(val != 0)
    if dtype == "int":
        def fn(vv, dd, **kw):
            return segment_sum_int(vv, dd, n, **kw)
    else:
        def fn(vv, dd, **kw):
            return segment_spmv(vv, dd, n, **kw)
    plain = fn(v, d)
    assert torch.equal(fn(v, d, hot=hot_list(d, n)), plain)
    assert torch.equal(fn(v[keep], d[keep]), plain)
    if dtype == "int":
        assert torch.equal(plain, segment_sum_int_ref(v, d, n))
        want = np.zeros(n + 1, np.int64)
        np.add.at(want, np.where((dst >= 0) & (dst < n), dst, n), val)
        np.testing.assert_array_equal(plain.numpy(), want[:n])


def test_sharded_segment_ids_refuse_int32_overflow():
    """Stacked shards whose segment ids would pass the int32 range raise
    instead of wrapping into another shard's segments."""
    from repro_torch.core.routing import _offset_ids
    ids = torch.zeros((8, 3), dtype=torch.int32)
    ok = torch.ones((8, 3), dtype=torch.bool)
    assert _offset_ids(ids, ok, 2 ** 28 - 1).max() == 7 * (2 ** 28 - 1)
    with pytest.raises(ValueError):
        _offset_ids(ids, ok, 2 ** 28)
