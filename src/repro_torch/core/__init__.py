"""Algorithm 1 (SIMPLE-PAGERANK) and its power-iteration baseline.

Public API:
  CSRGraph, from_edges, exact_pagerank    — graph substrate
  simple_pagerank (Algorithm 1)           — O(log n / eps) CONGEST rounds
  improved_pagerank (Algorithm 2)         — O(sqrt(log n) / eps) CONGEST
                                            rounds
  directed_local_pagerank (Section 5)     — O(sqrt(log n / eps)) LOCAL
                                            rounds
  power_iteration                         — classical baseline

The sharded engines live in their own modules: `core.distributed`,
`core.distributed_counts`, `core.distributed_improved` and
`core.distributed_directed`.
"""
from repro_torch.core.graph import CSRGraph, exact_pagerank, from_edges
from repro_torch.core.power_iteration import power_iteration
from repro_torch.core.simple_pagerank import (PageRankResult,
                                              simple_pagerank,
                                              walks_per_node_for)
from repro_torch.core.improved_pagerank import (ImprovedResult,
                                                coupon_pool_sizes,
                                                directed_local_pagerank,
                                                improved_pagerank)
from repro_torch.core.estimator import (l1_error, linf_error, max_rel_error,
                                        normalized, pagerank_from_visits,
                                        topk_overlap)

__all__ = [
    "CSRGraph", "from_edges", "exact_pagerank", "power_iteration",
    "PageRankResult", "simple_pagerank", "walks_per_node_for",
    "ImprovedResult", "coupon_pool_sizes", "improved_pagerank",
    "directed_local_pagerank",
    "l1_error", "linf_error", "max_rel_error", "normalized",
    "pagerank_from_visits", "topk_overlap",
]
