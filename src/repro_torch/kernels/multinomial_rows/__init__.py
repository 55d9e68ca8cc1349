from repro_torch.kernels.multinomial_rows.ops import (multinomial_buckets,
                                                      multinomial_rows)

__all__ = ["multinomial_buckets", "multinomial_rows"]
