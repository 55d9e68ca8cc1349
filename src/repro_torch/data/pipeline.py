"""Deterministic sharded synthetic token pipeline and PageRank-weighted
document sampling.

The JAX package's `repro.data.pipeline`, which is numpy only: a copy, so
the port imports nothing of it. Batches are host-side numpy, deterministic
per (seed, shard, step), the same as the JAX package's for the same
arguments: any worker can reproduce any batch, which makes a resumed run
exact.

`PageRankWeightedSampler` is where the paper's system meets the LM code:
documents live in a link graph, a PageRank engine scores them (the
port's `simple_pagerank` on the card), and documents are drawn in
proportion to their scores (web-corpus curation).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    num_shards: int = 1
    shard_id: int = 0


class SyntheticTokens:
    """Markov-ish synthetic stream: deterministic per (seed, shard, step)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        if cfg.global_batch % cfg.num_shards:
            raise ValueError("global_batch must divide into num_shards")
        self.local_batch = cfg.global_batch // cfg.num_shards

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 65_537 + cfg.shard_id)
        toks = rng.integers(0, cfg.vocab_size,
                            size=(self.local_batch, cfg.seq_len + 1),
                            dtype=np.int64).astype(np.int32)
        return dict(tokens=toks[:, :-1], labels=toks[:, 1:])

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class PageRankWeightedSampler:
    """Sample document ids proportionally to PageRank scores and emit
    doc-conditioned token sequences (each doc has a stable token 'style')."""

    def __init__(self, scores: np.ndarray, cfg: DataConfig):
        scores = np.asarray(scores, dtype=np.float64)
        scores = np.maximum(scores, 0)
        self.p = scores / scores.sum()
        self.cfg = cfg
        self.local_batch = cfg.global_batch // cfg.num_shards

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed * 998_244_353 + step) * 257 + cfg.shard_id)
        docs = rng.choice(len(self.p), size=self.local_batch, p=self.p)
        toks = np.empty((self.local_batch, cfg.seq_len + 1), dtype=np.int32)
        for i, d in enumerate(docs):
            doc_rng = np.random.default_rng(int(d) * 31 + cfg.seed)
            base = doc_rng.integers(0, cfg.vocab_size, size=cfg.seq_len + 1)
            noise = rng.integers(0, cfg.vocab_size, size=cfg.seq_len + 1)
            mix = rng.random(cfg.seq_len + 1) < 0.1
            toks[i] = np.where(mix, noise, base).astype(np.int32)
        return dict(tokens=toks[:, :-1], labels=toks[:, 1:],
                    doc_ids=docs.astype(np.int32))

    def empirical_doc_freq(self, steps: int = 50) -> np.ndarray:
        counts = np.zeros(len(self.p))
        for s in range(steps):
            b = self.batch_at(s)
            np.add.at(counts, b["doc_ids"], 1)
        return counts / counts.sum()
