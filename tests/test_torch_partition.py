"""The port's degree-balanced partitioner against the JAX package's.

Host numpy on both sides, so the parity level is bit-exact: the
permutation, the relabelled CSR arrays and the per-shard load statistics
are identical, at shard counts that do and do not divide n.
"""
import numpy as np
import pytest

from repro.graphs import generators as jgen
from repro.graphs import partition as jpart

from repro_torch.graphs import generators as tgen
from repro_torch.graphs.partition import (degree_balanced_relabel,
                                          shard_load_stats)

GRAPHS = {
    "erdos_renyi(100)": ("erdos_renyi", (100, 5.0, 1)),
    "barabasi_albert_hub(97)": ("barabasi_albert_hub", (97, 3, 4)),
    "directed_web(96)": ("directed_web", (96, 5.0, 3)),
    "doc_link_graph(2^10)": ("doc_link_graph", (1 << 10,)),
}
SHARDS = [1, 3, 4, 8]


def _pair(name):
    fn, args = GRAPHS[name]
    return (getattr(jgen, fn)(*args),
            getattr(tgen, fn)(*args, device="cpu"))


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("name", list(GRAPHS))
def test_relabel_matches_jax(name, shards):
    jg, tg = _pair(name)
    j2, jperm = jpart.degree_balanced_relabel(jg, shards)
    t2, tperm = degree_balanced_relabel(tg, shards)
    np.testing.assert_array_equal(tperm, jperm)
    assert (t2.n, t2.m, t2.undirected) == (j2.n, j2.m, j2.undirected)
    for a, b in ((t2.row_ptr, j2.row_ptr), (t2.col_idx, j2.col_idx),
                 (t2.out_deg, j2.out_deg)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # a bijection onto ids below n_loc * shards
    assert len(set(tperm.tolist())) == tg.n and tperm.max() < t2.n


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("name", list(GRAPHS))
def test_shard_load_stats_match_jax(name, shards):
    jg, tg = _pair(name)
    assert shard_load_stats(tg, shards) == jpart.shard_load_stats(jg, shards)
    t2, _ = degree_balanced_relabel(tg, shards)
    j2, _ = jpart.degree_balanced_relabel(jg, shards)
    assert shard_load_stats(t2, shards) == jpart.shard_load_stats(j2, shards)
