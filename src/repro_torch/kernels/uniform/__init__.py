from repro_torch.kernels.uniform.ops import uniform

__all__ = ["uniform"]
