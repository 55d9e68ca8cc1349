from repro_torch.kernels.segment_spmv.ops import segment_spmv

__all__ = ["segment_spmv"]
