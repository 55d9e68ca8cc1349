"""The port's data pipeline against the JAX package's, on the CPU.

Level 1 (bit-exact): `SyntheticTokens` and `PageRankWeightedSampler`
batches (tokens, labels, doc ids) for the same config, seed, shard and
step; the sampler's probabilities. The sampler's scores come from the
port's own Algorithm 1 (`simple_pagerank`) on a small link graph, as on
the card.
"""
import numpy as np
import pytest

from repro.data import DataConfig as JDataConfig
from repro.data import PageRankWeightedSampler as JSampler
from repro.data import SyntheticTokens as JTokens
from repro_torch.data import DataConfig, PageRankWeightedSampler, \
    SyntheticTokens


def configs():
    for seed, shards, shard in ((0, 1, 0), (3, 2, 1), (7, 4, 2)):
        kw = dict(vocab_size=1000, seq_len=33, global_batch=8, seed=seed,
                  num_shards=shards, shard_id=shard)
        yield kw


def same(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("kw", list(configs()),
                         ids=lambda kw: f"seed{kw['seed']}_shard"
                         f"{kw['shard_id']}of{kw['num_shards']}")
def test_synthetic_tokens_match_jax(kw):
    port, ref = SyntheticTokens(DataConfig(**kw)), JTokens(JDataConfig(**kw))
    for step in (0, 1, 17):
        same(port.batch_at(step), ref.batch_at(step))
    it = iter(port)
    same(next(it), ref.batch_at(0))
    same(next(it), ref.batch_at(1))


@pytest.fixture(scope="module")
def scores():
    """Algorithm 1's PageRank of a 512-node link graph, by the port."""
    import torch
    from repro_torch.core import simple_pagerank
    from repro_torch.graphs import doc_link_graph

    g = doc_link_graph(512, seed=0, device="cpu")
    res = simple_pagerank(g, 0.2, walks_per_node=8, engine="counts",
                          device="cpu")
    pi = res.pi.cpu().numpy() if isinstance(res.pi, torch.Tensor) \
        else np.asarray(res.pi)
    assert pi.shape == (512,) and (pi >= 0).all() and pi.sum() > 0
    return pi


@pytest.mark.parametrize("kw", list(configs()),
                         ids=lambda kw: f"seed{kw['seed']}_shard"
                         f"{kw['shard_id']}of{kw['num_shards']}")
def test_pagerank_sampler_matches_jax(kw, scores):
    port = PageRankWeightedSampler(scores, DataConfig(**kw))
    ref = JSampler(scores, JDataConfig(**kw))
    assert np.array_equal(port.p, ref.p)
    for step in (0, 5):
        b = port.batch_at(step)
        same(b, ref.batch_at(step))
        assert b["tokens"].shape == (port.local_batch, kw["seq_len"])
    assert np.array_equal(port.empirical_doc_freq(4),
                          ref.empirical_doc_freq(4))


def test_sampler_follows_scores(scores):
    """Documents come in proportion to their scores: the top-scored
    documents are drawn most."""
    s = PageRankWeightedSampler(scores, DataConfig(
        vocab_size=64, seq_len=4, global_batch=64))
    freq = s.empirical_doc_freq(50)
    top = np.argsort(-scores)[:5]
    assert freq[top].sum() > 3 * (5 / len(scores))
    assert abs(freq.sum() - 1.0) < 1e-12
