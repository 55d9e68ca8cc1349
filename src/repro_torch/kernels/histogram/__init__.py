from repro_torch.kernels.histogram.ops import histogram

__all__ = ["histogram"]
