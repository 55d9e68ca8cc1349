"""The port's kernels: each plain torch version against the JAX Pallas
kernel (interpret mode) and its jnp reference. The CUDA kernels against
their plain versions are in test_torch_cuda.py.

Parity levels (stated per test):
  * histogram — bit-exact (integer counts);
  * segment_spmv — float values within 1e-6 relative (the summation order
    differs); integer values bit-exact below and above count_bound 2**24;
  * multinomial_rows — the counter hash bit-exact; T bit-exact where every
    draw takes the BINV branch; conservation exact in every row; at counts
    up to 2**28 a moments test and a row mismatch rate <= 5% (float32
    log/exp/sqrt differ by ulps between XLA and torch in the normal branch);
  * walk_step — bit-exact (one float32 multiply, integer decisions), both
    from given uniforms and from key words (threefry draws).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.histogram.histogram import histogram_pallas
from repro.kernels.histogram.ref import histogram_ref as j_histogram_ref
from repro.kernels.multinomial_rows import _math as j_math
from repro.kernels.multinomial_rows.multinomial_rows import \
    multinomial_rows_pallas
from repro.kernels.multinomial_rows.ref import \
    multinomial_rows_ref as j_multinomial_ref
from repro.kernels.segment_spmv import segment_spmv as j_segment_spmv
from repro.kernels.segment_spmv.ref import segment_spmv_ref as j_spmv_ref
from repro.kernels.walk_step import walk_step as j_walk_step
from repro.kernels.walk_step.ref import walk_step_ref as j_walk_step_ref

from repro_torch import convert, prng
from repro_torch.kernels import common
from repro_torch.kernels.histogram import histogram
from repro_torch.kernels.histogram.ops import (HOT_BITS, HOT_CAP, HOT_HITS,
                                               SAMPLE_CHUNK, SAMPLE_STRIDE,
                                               hot_thresholds, sample_size)
from repro_torch.kernels.multinomial_rows import _math as t_math
from repro_torch.kernels.multinomial_rows import (multinomial_buckets,
                                                  multinomial_rows)
from repro_torch.kernels.segment_spmv import (hot_list, segment_spmv,
                                              segment_sum_int)
from repro_torch.kernels.walk_step import (walk_step, walk_step_keyed,
                                           walk_step_keyed_)

KEY_WORDS = (0xDEADBEEF, 0x12345678)


# ---------------------------------------------------------------- histogram

@pytest.mark.parametrize("W,n,hub", [
    *[pytest.param(W, n, None, id=f"{W}-{n}")
      for W, n in [(64, 8), (1000, 100), (4096, 512), (5000, 700), (257, 1),
                   (1, 31), (0, 5)]],
    pytest.param(5000, 700, 0.3, id="5000-700-hub0.3"),
    pytest.param(4096, 512, 1.0, id="4096-512-all-equal")])
def test_histogram_matches_jax(W, n, hub):
    rng = np.random.default_rng(W + n)
    ids = rng.integers(-1, n + 3, W).astype(np.int32)
    if hub is not None:
        # a web hub: `hub` of the ids on one vertex (all of them at 1.0)
        ids[rng.random(W) < hub] = n - 3
    got = histogram(torch.from_numpy(ids), n)
    assert got.dtype == torch.int32 and got.shape == (n,)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(histogram_pallas(jnp.asarray(ids), n,
                                                 interpret=True)))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(j_histogram_ref(jnp.asarray(ids), n)))


@pytest.mark.parametrize("w", [0, 1, 31, 32, 33, SAMPLE_STRIDE - 1,
                               SAMPLE_STRIDE + 5, SAMPLE_STRIDE * 7 + 40,
                               HOT_HITS - 1, HOT_HITS, 2 ** 20 + 7,
                               145_752_064, 2 * 145_752_192])
def test_histogram_hot_thresholds(w):
    """The hot-list plan of the card's kernel: the sample reads the first
    SAMPLE_CHUNK ids of every SAMPLE_STRIDE; an id with HOT_HITS expected
    hits reaches the low threshold, at most HOT_CAP / 2 ids can reach the
    high one, and below HOT_HITS ids no id is hot."""
    s = sample_size(w)
    if w <= 8 * SAMPLE_STRIDE:
        assert s == int((np.arange(w) % SAMPLE_STRIDE < SAMPLE_CHUNK).sum())
    else:
        assert abs(s - w * SAMPLE_CHUNK / SAMPLE_STRIDE) <= SAMPLE_CHUNK
    low, high = hot_thresholds(w)
    assert 1 <= low <= high and s // high <= HOT_CAP // 2
    if w < HOT_HITS:
        assert low > s
    else:
        # an id with HOT_HITS expected hits is sampled HOT_HITS * s / w times
        assert HOT_HITS * s / w <= low < HOT_HITS * s / w + 1
    assert 1 << HOT_BITS == 2 * HOT_CAP


def test_histogram_out_of_range_and_padding():
    ids = torch.tensor([-5, 0, 3, 99, 3, -1], dtype=torch.int32)
    np.testing.assert_array_equal(histogram(ids, 4).numpy(), [1, 0, 0, 2])
    pad = torch.full((512,), -1, dtype=torch.int32)
    np.testing.assert_array_equal(histogram(pad, 16).numpy(),
                                  np.zeros(16, np.int32))


# ------------------------------------------------------------- segment_spmv

@pytest.mark.parametrize("E,n", [(100, 10), (4000, 300), (999, 50),
                                 (8192, 1024)])
def test_spmv_float_matches_jax(E, n):
    rng = np.random.default_rng(E)
    val = rng.standard_normal(E).astype(np.float32)
    dst = rng.integers(-2, n + 2, E).astype(np.int32)
    got = segment_spmv(torch.from_numpy(val), torch.from_numpy(dst), n)
    assert got.dtype == torch.float32
    want = np.asarray(j_segment_spmv(jnp.asarray(val), jnp.asarray(dst), n,
                                     interpret=True))
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                               atol=1e-6 * scale)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(j_spmv_ref(jnp.asarray(val),
                                           jnp.asarray(dst), n)),
        rtol=1e-6, atol=1e-6 * scale)


@pytest.mark.parametrize("count_bound", [None, 2 ** 24, 2 ** 24 + 1, 2 ** 31 - 1])
def test_spmv_integer_exact(count_bound):
    """Below the bound the sum runs in float32 (every partial sum an
    integer below 2**24); above it the exact integer sum is taken."""
    rng = np.random.default_rng(5)
    hi = 2 ** 17 if count_bound is None or count_bound <= 2 ** 24 else 2 ** 26
    val = rng.integers(0, hi, 600).astype(np.int32)
    dst = rng.integers(-1, 40, 600).astype(np.int32)
    got = segment_spmv(torch.from_numpy(val), torch.from_numpy(dst), 40,
                       count_bound=count_bound)
    want = np.asarray(j_segment_spmv(jnp.asarray(val), jnp.asarray(dst), 40,
                                     count_bound=count_bound, interpret=True))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    exact = np.zeros(41, np.int64)
    np.add.at(exact, np.where(dst >= 0, dst, 40), val)
    if hi == 2 ** 26:
        np.testing.assert_array_equal(got.numpy(), exact[:40])


def test_spmv_f32_exact_at_2_pow_24():
    val = torch.tensor([2.0 ** 23, 2.0 ** 23, 1, 2, 3])
    dst = torch.tensor([0, 0, 1, 1, 1], dtype=torch.int32)
    np.testing.assert_array_equal(segment_spmv(val, dst, 2).numpy(),
                                  [2.0 ** 24, 6.0])


# --------------------------------------------------------- multinomial_rows

def _rows(R, width, hi, seed):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, hi, R).astype(np.int32)
    deg = rng.integers(0, width + 1, R).astype(np.int32)
    rid = (np.arange(R) * 3 + 11).astype(np.int32)
    return counts, deg, rid


def _port(counts, deg, rid, eps, width):
    return multinomial_rows(torch.from_numpy(counts), torch.from_numpy(deg),
                            torch.from_numpy(rid), KEY_WORDS, eps=eps,
                            width=width).numpy()


def _jax(counts, deg, rid, eps, width, pallas=False):
    args = (jnp.asarray(counts), jnp.asarray(deg), jnp.asarray(rid),
            jnp.asarray(np.array(KEY_WORDS, np.uint32)))
    if pallas:
        return np.asarray(multinomial_rows_pallas(*args, eps=eps, width=width,
                                                  interpret=True))
    return np.asarray(j_multinomial_ref(*args, eps=eps, width=width))


def test_counter_hash_bit_exact():
    rid = np.concatenate([np.arange(5000), [2 ** 31 - 1, -1, -2 ** 31]]
                         ).astype(np.int32)
    for t in (0, 1, 16, 1000):
        for k0, k1 in (KEY_WORDS, (0, 0), (2 ** 32 - 1, 1)):
            a = np.asarray(j_math.counter_u01(jnp.asarray(rid), t,
                                              np.uint32(k0), np.uint32(k1)))
            b = t_math.counter_u01(torch.from_numpy(rid), t, k0, k1).numpy()
            np.testing.assert_array_equal(b.view(np.uint32), a.view(np.uint32))
            assert (b > 0).all() and (b < 1).all()


@pytest.mark.parametrize("R,width,eps", [(64, 4, 0.2), (1000, 8, 0.1),
                                         (4096, 16, 0.5), (257, 1, 0.3),
                                         (1, 32, 0.2)])
def test_multinomial_binv_regime_bit_exact(R, width, eps):
    """Counts <= 20 put every draw in the BINV branch (the complement flip
    keeps p <= 1/2, so the mean is <= 10): T is bit-exact there, against
    the Pallas kernel and the jnp reference."""
    counts, deg, rid = _rows(R, width, 21, R + width)
    got = _port(counts, deg, rid, eps, width)
    assert got.dtype == np.int32 and got.shape == (R, width + 1)
    np.testing.assert_array_equal(got, _jax(counts, deg, rid, eps, width))
    np.testing.assert_array_equal(
        got, _jax(counts, deg, rid, eps, width, pallas=True))
    np.testing.assert_array_equal(got.sum(axis=1), counts)


def test_multinomial_large_counts_moments_and_mismatch():
    """Counts up to 2**28 take the normal branch: conservation stays exact,
    the draws' moments match the Binomial's, and at most 5% of rows differ
    from the JAX reference (float32 transcendental ulps)."""
    R, width, eps = 20000, 16, 0.2
    counts, deg, rid = _rows(R, width, 2 ** 28, 9)
    got = _port(counts, deg, rid, eps, width)
    want = _jax(counts, deg, rid, eps, width)
    np.testing.assert_array_equal(got.sum(axis=1), counts)
    assert (got >= 0).all()
    mismatch = float((got != want).any(axis=1).mean())
    assert mismatch <= 0.05, mismatch
    # termination ~ Bin(c, eps): standardized residuals are ~N(0, 1)
    live = (deg > 0) & (counts > 1000)
    c = counts[live].astype(np.float64)
    z = (got[live, 0] - c * eps) / np.sqrt(c * eps * (1 - eps))
    assert abs(z.mean()) < 0.05 and abs(z.std() - 1.0) < 0.05
    # the first edge slot ~ Bin(c - term, 1/deg)
    rem, d = c - got[live, 0], deg[live].astype(np.float64)
    z1 = (got[live, 1] - rem / d) / np.sqrt(np.maximum(rem / d * (1 - 1 / d),
                                                      1e-9))
    keep = d > 1
    assert abs(z1[keep].mean()) < 0.05 and abs(z1[keep].std() - 1.0) < 0.05


def test_multinomial_dangling_rows_terminate_whole():
    counts = np.array([5, 0, 77, 2 ** 20], np.int32)
    deg = np.zeros(4, np.int32)
    got = _port(counts, deg, np.arange(4, dtype=np.int32), 0.2, 3)
    np.testing.assert_array_equal(got[:, 0], counts)
    assert not got[:, 1:].any()


# ---------------------------------------------------------------- walk_step

def _tables(g):
    """(JAX tables, port tables) of a JAX fixture graph."""
    arrs = [np.asarray(a) for a in (g.row_ptr, g.col_idx, g.out_deg)]
    return ([jnp.asarray(a) for a in arrs],
            [torch.from_numpy(a.copy()) for a in arrs])


def _walk_inputs(W, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(-2, n + 2, W).astype(np.int32),
            (rng.random(W) < 0.8).astype(np.int32),
            rng.random(W).astype(np.float32),
            rng.random(W).astype(np.float32))


def _both_walk_steps(inputs, jt, tt, eps):
    """(port, JAX Pallas, JAX ref) outputs as numpy pairs."""
    j_in = [jnp.asarray(x) for x in inputs]
    t_in = [torch.from_numpy(x) for x in inputs]
    port = [x.numpy() for x in walk_step(*t_in, *tt, eps=eps)]
    pallas = [np.asarray(x) for x in j_walk_step(*j_in, *jt, eps=eps)]
    ref = [np.asarray(x) for x in j_walk_step_ref(*j_in, *jt, eps=eps)]
    return port, pallas, ref


@pytest.mark.parametrize("name,W", [("er", 1000), ("ba", 4096),
                                    ("dweb", 257), ("ring", 1)])
@pytest.mark.parametrize("eps", [0.1, 0.5])
def test_walk_step_matches_jax(small_graphs, name, W, eps):
    """Positions out of range clip, dead walks stay, and every surviving
    walk takes the JAX kernel's edge: bit-exact."""
    g = small_graphs[name]
    jt, tt = _tables(g)
    port, pallas, ref = _both_walk_steps(_walk_inputs(W, g.n, W), jt, tt,
                                         eps)
    for a, b, c in zip(port, pallas, ref):
        assert a.dtype == np.int32 and a.shape == (W,)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def test_walk_step_dead_walks_stay(small_graphs):
    jt, tt = _tables(small_graphs["er"])
    pos = np.arange(10, dtype=np.int32)
    zeros = np.zeros(10, np.float32)
    port, pallas, _ = _both_walk_steps(
        (pos, np.zeros(10, np.int32), zeros, zeros), jt, tt, 0.3)
    np.testing.assert_array_equal(port[0], pos)
    assert not port[1].any()
    np.testing.assert_array_equal(port[0], pallas[0])


def test_walk_step_dangling_reset():
    """A walk on a vertex without out-edges ends there (graph 0 -> 1, 1
    dangling)."""
    tables = [np.array(a, np.int32) for a in ([0, 1, 1], [1], [1, 0])]
    jt = [jnp.asarray(a) for a in tables]
    tt = [torch.from_numpy(a) for a in tables]
    inputs = (np.array([0, 1, 1], np.int32), np.ones(3, np.int32),
              np.full(3, 0.99, np.float32), np.zeros(3, np.float32))
    port, pallas, _ = _both_walk_steps(inputs, jt, tt, 0.2)
    np.testing.assert_array_equal(port[1], [1, 0, 0])
    assert port[0][0] == 1
    for a, b in zip(port, pallas):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 7])
def test_walk_step_keyed_is_uniform_then_walk_step(small_graphs, seed):
    """Entry point (b) draws u_term and u_edge as `uniform(key, (W,))` of
    its two keys: it equals those draws fed to entry point (a), and the
    JAX package's draws fed to its kernel. Bit-exact."""
    g = small_graphs["dweb"]
    jt, tt = _tables(g)
    pos, alive, _, _ = _walk_inputs(3000, g.n, seed)
    jk_term, jk_edge = jax.random.split(jax.random.PRNGKey(seed))
    tk_term, tk_edge = (convert.key_from_numpy(np.asarray(k))
                        for k in (jk_term, jk_edge))
    keyed = walk_step_keyed(torch.from_numpy(pos), torch.from_numpy(alive),
                            tk_term, tk_edge, *tt, eps=0.2)
    u_term = prng.uniform(tk_term, (3000,))
    u_edge = prng.uniform(tk_edge, (3000,))
    plain = walk_step(torch.from_numpy(pos), torch.from_numpy(alive), u_term,
                      u_edge, *tt, eps=0.2)
    pallas = j_walk_step(jnp.asarray(pos), jnp.asarray(alive),
                         jax.random.uniform(jk_term, (3000,)),
                         jax.random.uniform(jk_edge, (3000,)), *jt, eps=0.2)
    for a, b, c in zip(keyed, plain, pallas):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
        np.testing.assert_array_equal(a.numpy(), np.asarray(c))


# ----------------------------------------------------- dispatch and counters

def test_cpu_wrappers_launch_nothing():
    common.reset_launches()
    ids = torch.tensor([0, 1, 1], dtype=torch.int32)
    histogram(ids, 2)
    segment_spmv(torch.ones(3), ids, 2)
    segment_spmv(ids, ids, 2, count_bound=2 ** 30)
    segment_sum_int(ids, ids, 2, hot=hot_list(ids.repeat(1000), 2))
    multinomial_rows(ids, ids, ids, KEY_WORDS, eps=0.2, width=2)
    multinomial_buckets(ids, ids, ids, KEY_WORDS, ids, (1, 2), (1, 2),
                        eps=0.2)
    u = torch.zeros(3)
    walk_step(ids, ids, u, u, ids, ids, ids, eps=0.2)
    key = prng.PRNGKey(0)
    walk_step_keyed(ids, ids, key, key, ids, ids, ids, eps=0.2)
    walk_step_keyed_(ids.clone(), ids.clone(), key, key, ids, ids, ids,
                     eps=0.2, edge=torch.empty_like(ids),
                     arrivals=torch.empty_like(ids))
    prng.uniform(key, (3,), device="cpu")
    assert common.launches == {"histogram": 0, "segment_spmv": 0,
                               "multinomial_rows": 0, "walk_step": 0,
                               "uniform": 0}


def test_no_kernel_built_or_loaded_on_cpu():
    """The CPU paths never reach nvcc or the kernel loader."""
    assert common._libs == {}
