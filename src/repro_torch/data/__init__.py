from repro_torch.data.pipeline import (DataConfig, PageRankWeightedSampler,
                                       SyntheticTokens)

__all__ = ["DataConfig", "PageRankWeightedSampler", "SyntheticTokens"]
