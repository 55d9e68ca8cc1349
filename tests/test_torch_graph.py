"""Graph substrate, generators, bucket layout, estimator and carry-across of
the port against the JAX package.

Parity levels: bit-exact for every integer structure (CSR arrays, padded
adjacency, bucket permutation and bucketed adjacency); 1e-12 for the
float64 oracles and metrics, which both sides compute in numpy float64.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregate_sampler as j_agg
from repro.core import estimator as j_est
from repro.core.graph import exact_pagerank as j_exact
from repro.core.graph import padded_adjacency as j_padded
from repro.graphs import doc_link_graph as j_doc_link_graph
from repro.graphs import random_regular as j_random_regular

from repro_torch import convert
from repro_torch import graphs as t_graphs
from repro_torch.core import aggregate_sampler as t_agg
from repro_torch.core import estimator as t_est
from repro_torch.core.graph import exact_pagerank as t_exact
from repro_torch.core.graph import from_edges, padded_adjacency

GRAPH_NAMES = ["ring", "grid", "er", "ba", "ba_hub", "dweb"]

# the port's rebuild of each graph of conftest.SMALL_GRAPHS_SRC
PORT_GRAPHS = dict(
    ring=lambda: t_graphs.ring(64, device="cpu"),
    grid=lambda: t_graphs.grid2d(8, 8, device="cpu"),
    er=lambda: t_graphs.erdos_renyi(96, 5.0, seed=1, device="cpu"),
    ba=lambda: t_graphs.barabasi_albert(96, 3, seed=2, device="cpu"),
    ba_hub=lambda: t_graphs.barabasi_albert_hub(96, 3, seed=4, device="cpu"),
    dweb=lambda: t_graphs.directed_web(96, 5.0, seed=3, device="cpu"),
)


def _carry(g):
    return convert.graph_from_numpy(np.asarray(g.row_ptr),
                                    np.asarray(g.col_idx),
                                    np.asarray(g.out_deg), g.n, g.m,
                                    g.undirected, device="cpu")


def _assert_same_graph(jg, tg):
    assert (tg.n, tg.m, tg.undirected) == (jg.n, jg.m, jg.undirected)
    for name in ("row_ptr", "col_idx", "out_deg"):
        got = getattr(tg, name)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(jg, name)))


@pytest.mark.parametrize("name", GRAPH_NAMES)
def test_generators_identical(small_graphs, name):
    jg, tg = small_graphs[name], PORT_GRAPHS[name]()
    _assert_same_graph(jg, tg)
    assert tg.max_out_deg == jg.max_out_deg
    np.testing.assert_array_equal(tg.edge_src().numpy(),
                                  np.asarray(jg.edge_src()))


@pytest.mark.parametrize("make_j,make_t", [
    (lambda: j_random_regular(64, 4, seed=5),
     lambda: t_graphs.random_regular(64, 4, seed=5, device="cpu")),
    (lambda: j_doc_link_graph(200, seed=1),
     lambda: t_graphs.doc_link_graph(200, seed=1, device="cpu")),
])
def test_other_generators_identical(make_j, make_t):
    _assert_same_graph(make_j(), make_t())


@pytest.mark.parametrize("name", GRAPH_NAMES)
def test_padded_adjacency_identical(small_graphs, name):
    jg = small_graphs[name]
    j_nbr, j_valid = j_padded(jg)
    t_nbr, t_valid = padded_adjacency(_carry(jg))
    np.testing.assert_array_equal(t_nbr.numpy(), np.asarray(j_nbr))
    np.testing.assert_array_equal(t_valid.numpy(), np.asarray(j_valid))


def test_padded_adjacency_refuses_narrow_width(small_graphs):
    with pytest.raises(ValueError):
        padded_adjacency(_carry(small_graphs["ba_hub"]), max_deg=2)


@pytest.mark.parametrize("name", GRAPH_NAMES)
@pytest.mark.parametrize("bucketed", [True, False])
def test_layout_and_bucketized_adjacency_identical(small_graphs, name,
                                                   bucketed):
    jg = small_graphs[name]
    nbr = np.asarray(j_padded(jg)[0])
    deg = np.asarray(jg.out_deg)
    j_layout, j_perm = j_agg.build_layout(deg, nbr.shape[1],
                                          bucketed=bucketed)
    t_layout, t_perm = t_agg.build_layout(deg, nbr.shape[1],
                                          bucketed=bucketed)
    assert (t_layout.widths, t_layout.caps, t_layout.n_rows) == \
        (j_layout.widths, j_layout.caps, j_layout.n_rows)
    np.testing.assert_array_equal(t_perm, j_perm)
    np.testing.assert_array_equal(
        t_agg.bucketize_adjacency(nbr, t_perm, t_layout),
        j_agg.bucketize_adjacency(nbr, j_perm, j_layout))


def test_layout_of_skewed_degrees_identical():
    """A wide spread of degrees, zeros included, in shuffled row order."""
    rng = np.random.default_rng(11)
    deg = rng.choice([0, 1, 2, 3, 5, 8, 9, 17, 40], size=500).astype(np.int32)
    j_layout, j_perm = j_agg.build_layout(deg, 40)
    t_layout, t_perm = t_agg.build_layout(deg, 40)
    assert t_layout == t_agg.BucketLayout(j_layout.widths, j_layout.caps,
                                          j_layout.n_rows)
    np.testing.assert_array_equal(t_perm, j_perm)
    np.testing.assert_array_equal(t_agg.bucket_of(deg), j_agg.bucket_of(deg))


@pytest.mark.parametrize("name", ["ring", "ba_hub", "dweb"])
def test_exact_pagerank_agrees(small_graphs, name):
    jg = small_graphs[name]
    np.testing.assert_allclose(t_exact(_carry(jg), 0.2), j_exact(jg, 0.2),
                               rtol=0, atol=1e-12)


def test_estimator_functions_agree():
    rng = np.random.default_rng(3)
    zeta = rng.integers(0, 2 ** 31 - 1, size=300).astype(np.int32)
    a = j_est.pagerank_from_visits(jnp.asarray(zeta), 300, 139, 0.2)
    b = t_est.pagerank_from_visits(torch.from_numpy(zeta), 300, 139, 0.2)
    assert b.dtype == np.float64
    np.testing.assert_allclose(b, a, rtol=1e-12, atol=0)
    est, ref = rng.random(300), rng.random(300)
    t_est_in = torch.from_numpy(est)
    for fn in ("l1_error", "linf_error", "max_rel_error"):
        assert getattr(t_est, fn)(t_est_in, ref) == pytest.approx(
            getattr(j_est, fn)(est, ref), rel=1e-12, abs=1e-12)
    for k in (1, 10, 50):
        assert t_est.topk_overlap(t_est_in, ref, k) == \
            j_est.topk_overlap(est, ref, k)


def test_normalized_agrees():
    """float32 both sides; the sums run in different orders, so the
    tolerance is a few float32 ulps."""
    x = np.random.default_rng(4).random(257).astype(np.float32)
    got = t_est.normalized(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(j_est.normalized(x)),
                               rtol=1e-6)
    assert float(got.sum()) == pytest.approx(1.0, abs=1e-6)


@pytest.mark.parametrize("name", GRAPH_NAMES)
def test_graph_carry_across_round_trips(small_graphs, name):
    jg = small_graphs[name]
    tg = _carry(jg)
    _assert_same_graph(jg, tg)
    back = convert.graph_from_numpy(*tg.numpy(), tg.n, tg.m, tg.undirected,
                                    device="cpu")
    _assert_same_graph(jg, back)


def test_key_carry_across_round_trips():
    import jax
    for seed in (0, 5, 2 ** 33 + 9):
        jk = jax.random.split(jax.random.PRNGKey(seed))[1]
        tk = convert.key_from_numpy(np.asarray(jk))
        assert tk.dtype == torch.uint32
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    with pytest.raises(ValueError):
        convert.key_from_numpy(np.zeros(3, np.uint32))
    with pytest.raises(ValueError):
        convert.graph_from_numpy(np.zeros(3), np.zeros(1), np.zeros(2), 2, 2,
                                 False, device="cpu")


def test_from_edges_dedup_and_undirected():
    src, dst = np.array([0, 0, 1, 2, 2]), np.array([1, 1, 2, 0, 0])
    g = from_edges(src, dst, 3, undirected=True, device="cpu")
    np.testing.assert_array_equal(g.out_deg.numpy(), [2, 2, 2])
    assert g.m == 6 and g.undirected
