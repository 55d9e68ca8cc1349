"""Plain PyTorch version of the histogram kernel."""
import torch


def histogram_ref(ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """counts[v] = |{w : ids[w] == v}| for v in [0, num_segments), int32;
    ids outside the range are ignored."""
    valid = (ids >= 0) & (ids < num_segments)
    out = torch.zeros(num_segments + 1, dtype=torch.int32, device=ids.device)
    out.index_add_(0, torch.where(valid, ids, num_segments).long(),
                   valid.to(torch.int32))
    return out[:num_segments]
