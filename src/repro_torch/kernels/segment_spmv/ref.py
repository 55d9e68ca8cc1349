"""Plain PyTorch versions of the segment_spmv kernel."""
import torch


def _segment_sum(values: torch.Tensor, dst: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    valid = (dst >= 0) & (dst < num_segments)
    out = torch.zeros(num_segments + 1, dtype=values.dtype,
                      device=values.device)
    out.index_add_(0, torch.where(valid, dst, num_segments).long(),
                   torch.where(valid, values, 0))
    return out[:num_segments]


def segment_spmv_ref(values: torch.Tensor, dst: torch.Tensor,
                     num_segments: int) -> torch.Tensor:
    """y[v] = sum over e with dst[e]==v of values[e], summed in float64 and
    rounded once to float32, as the kernel does; ids outside
    [0, num_segments) are dropped."""
    return _segment_sum(values.to(torch.float64), dst,
                        num_segments).to(torch.float32)


def segment_sum_int_ref(values: torch.Tensor, dst: torch.Tensor,
                        num_segments: int) -> torch.Tensor:
    """The exact integer segment sum, in the values' own dtype."""
    return _segment_sum(values, dst, num_segments)
