from repro_torch.kernels.segment_spmv.ops import (hot_list, segment_spmv,
                                                  segment_sum_int)

__all__ = ["hot_list", "segment_spmv", "segment_sum_int"]
