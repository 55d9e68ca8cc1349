from repro_torch.kernels.multinomial_rows.ops import multinomial_rows

__all__ = ["multinomial_rows"]
