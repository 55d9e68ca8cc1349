"""Serving: continuous batching for the LMs, and Personalized PageRank
over the batched PPR engine."""
from repro_torch.serve.batching import ContinuousBatcher, Request, ServeStats
from repro_torch.serve.ppr_service import (PPRRequest, PPRServeStats,
                                           PPRService, ResultCache,
                                           query_cache_key)

__all__ = ["ContinuousBatcher", "Request", "ServeStats",
           "PPRRequest", "PPRServeStats", "PPRService", "ResultCache",
           "query_cache_key"]
