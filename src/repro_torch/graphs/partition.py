"""Vertex partitioners for the sharded engines.

The engines use owner = vertex // n_loc (uniform contiguous ranges), so
load balancing is done by *relabeling*: vertices are permuted so that the
uniform ranges receive near-equal degree sums (snake/boustrophedon greedy
over degree-sorted vertices). On power-law graphs this flattens the
per-shard walk load (visits ∝ degree, Lemma 2), which is the straggler
story: the most loaded shard sets the superstep time. Host numpy: the
relabel is the JAX package's, array for array.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np

from repro_torch.core.graph import CSRGraph, from_edges


def degree_balanced_relabel(graph: CSRGraph, shards: int
                            ) -> Tuple[CSRGraph, np.ndarray]:
    """Returns (relabeled graph, perm) with perm[old_id] = new_id such that
    uniform contiguous ranges of the new ids have ~equal degree sums. The
    graph has n_loc * shards vertices (the padding ones isolated) and
    lives on `graph`'s device.

    Vertices in order of falling degree (stable) go to shards in snake
    order, 0, 1, .., P-1, P-1, .., 0, 0, 1, ..: the r-th takes slot r // P
    of its shard. Each pass of the snake gives every shard one vertex, so
    no shard ever holds more than ceil(n / P) = n_loc."""
    n = graph.n
    n_loc = math.ceil(n / shards)
    _, col, deg = graph.numpy()
    order = np.argsort(-deg.astype(np.int64), kind="stable")  # heavy first
    rank = np.arange(n, dtype=np.int64)
    lap, step = rank // shards, rank % shards
    shard = np.where(lap % 2 == 0, step, shards - 1 - step)
    new_id = np.empty(n, np.int64)
    new_id[order] = shard * n_loc + lap
    # rebuild the edges under the new labels
    src = new_id[np.repeat(np.arange(n), deg)]
    dst = new_id[col]
    g2 = from_edges(src, dst, n_loc * shards, undirected=False, dedup=False,
                    device=graph.device)
    return g2, new_id


def shard_load_stats(graph: CSRGraph, shards: int) -> dict:
    """Per-shard degree-sum imbalance under uniform contiguous ranges."""
    n_loc = math.ceil(graph.n / shards)
    deg = graph.out_deg.cpu().numpy()
    deg = np.concatenate([deg, np.zeros(n_loc * shards - len(deg),
                                        deg.dtype)])
    per_shard = deg.reshape(shards, n_loc).sum(axis=1)
    return dict(per_shard=per_shard.tolist(),
                max=int(per_shard.max()),
                mean=float(per_shard.mean()),
                imbalance=float(per_shard.max() / max(per_shard.mean(), 1)))
