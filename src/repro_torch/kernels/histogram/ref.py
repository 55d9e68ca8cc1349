"""Plain PyTorch versions of the histogram kernel and of its hot-list
passes."""
from typing import Tuple

import torch


def histogram_ref(ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """counts[v] = |{w : ids[w] == v}| for v in [0, num_segments), int32;
    ids outside the range are ignored."""
    valid = (ids >= 0) & (ids < num_segments)
    out = torch.zeros(num_segments + 1, dtype=torch.int32, device=ids.device)
    out.index_add_(0, torch.where(valid, ids, num_segments).long(),
                   valid.to(torch.int32))
    return out[:num_segments]


def hot_list_ref(ids: torch.Tensor, num_segments: int, *, chunk: int,
                 stride: int, low: int, high: int, cap: int, bits: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sample and hot-list passes: (table, hot) as the card's
    `hot_list` returns them. The sample counts the first `chunk` ids of
    every `stride`; the ids sampled at least `high` times go into the
    table, then those sampled `low` to `high - 1` times while it holds
    fewer than `cap`, each at its hash slot or the next free one (the
    table holds id + 1, 0 when empty); `hot` counts every id that reached
    `low`. Where more than `cap` do, the card's list keeps another choice
    of those below `high`; here they go in in increasing id order."""
    first = torch.arange(0, ids.numel(), stride, device=ids.device)
    pos = (first[:, None] + torch.arange(chunk, device=ids.device)).reshape(-1)
    sample = histogram_ref(ids[pos[pos < ids.numel()]], num_segments)
    table = [0] * (1 << bits)
    mask, placed = (1 << bits) - 1, 0
    hot = 0
    for lo, hi in ((high, 2 ** 31 - 1), (low, high)):
        if lo >= hi:
            continue
        found = torch.nonzero((sample >= lo) & (sample < hi)).reshape(-1)
        hot += found.numel()
        for v in found[:max(cap - placed, 0)].tolist():
            s = ((v * 0x9E3779B1) & 0xFFFFFFFF) >> (32 - bits)
            while table[s]:
                s = (s + 1) & mask
            table[s] = v + 1
            placed += 1
    return (torch.tensor(table, dtype=torch.int32, device=ids.device),
            torch.tensor([hot], dtype=torch.int32, device=ids.device))
