"""Personalized-PageRank serving over the batched PPR engine."""
from repro_torch.serve.ppr_service import (PPRRequest, PPRServeStats,
                                           PPRService, ResultCache,
                                           query_cache_key)

__all__ = ["PPRRequest", "PPRServeStats", "PPRService", "ResultCache",
           "query_cache_key"]
