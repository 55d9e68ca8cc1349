"""Histogram wrapper: the CUDA kernel for a CUDA tensor, the plain version
for a CPU tensor.

On the card a call takes one of two paths (see `histogram.cu`):

* n up to `shared_max` counters: one launch, counting in shared memory;
* larger n: a sample pass and two hot-list passes (`hot_list`), then the
  main pass, which counts the hot ids in shared memory and the rest in
  global memory: four launches. Below `HOT_HITS` ids no id can be hot, and
  the main pass runs alone.

Besides its kernels a call makes one or two `torch.zeros` fills: the output,
and on the hot-list path the scratch of the sample and hot-list passes.
"""
from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from repro_torch.kernels import common
from repro_torch.kernels.histogram.ref import histogram_ref, hot_list_ref

# an id expected to take more hits than this is hot: above it, an id's
# atomics in L2, one after another, cost more than ~7 us
HOT_HITS = 2_000
# ids the hot list holds; its table has twice as many slots (load <= 0.5),
# 64 KB of keys and counters in each block's shared memory
HOT_CAP = 4096
HOT_BITS = (2 * HOT_CAP).bit_length() - 1
# the sample pass reads the 32 ids at every multiple of this stride
SAMPLE_CHUNK = 32
SAMPLE_STRIDE = SAMPLE_CHUNK * 509

_ptr, _i64, _int = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


def sample_size(w: int) -> int:
    """The number of ids among `w` that the sample pass reads."""
    whole, part = divmod(w, SAMPLE_STRIDE)
    return SAMPLE_CHUNK * whole + min(part, SAMPLE_CHUNK)


def hot_thresholds(w: int, hits: int = HOT_HITS) -> Tuple[int, int]:
    """(low, high): the sampled counts at which an id of `w` is hot.

    `low` is that of an id with `hits` expected hits. No more than
    HOT_CAP / 2 ids can reach `high`, so all of those make the list; the
    ids between `low` and `high` fill what room is left. Above
    `sample_size(w)` (fewer than `hits` ids) no id is hot."""
    s = sample_size(w)
    low = max(1, math.ceil(hits * s / max(w, 1)))
    return low, max(low, math.ceil(2 * s / HOT_CAP))


def _fn(name: str, argtypes):
    fn = getattr(common.library("histogram"), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def shared_max(device: torch.device) -> int:
    """Counters that one block holds in the card's opt-in shared memory:
    the largest n of the all-shared path."""
    index = torch.device(device).index
    counters = ctypes.c_int(0)
    err = _fn("histogram_shared_max", [_int, _ptr])(
        torch.cuda.current_device() if index is None else index,
        ctypes.byref(counters))
    common.check_launch("histogram_shared_max", err)
    return counters.value


def _check(ids: torch.Tensor, num_segments: int) -> None:
    common.require(ids.device.type == "cuda",
                   f"histogram: unsupported device {ids.device}")
    common.require(ids.dtype == torch.int32 and ids.dim() == 1
                   and ids.is_contiguous(),
                   "histogram: ids must be a contiguous 1-D int32 tensor")
    common.require(0 <= num_segments < 2 ** 31,
                   "histogram: num_segments out of range")


def hot_list(ids: torch.Tensor, num_segments: int, hits: int = HOT_HITS
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sample and hot-list passes alone: (table, hot), where `table`
    holds 2 HOT_CAP slots of id + 1 (0 when empty) and `hot` counts the ids
    that reached the low threshold of `hits` expected hits; past HOT_CAP
    the rest stay off the list. `segment_spmv` keeps its hot ids in the
    same table."""
    n, w = num_segments, ids.numel()
    low, high = hot_thresholds(w, hits)
    if ids.device.type == "cpu":
        return hot_list_ref(ids, n, chunk=SAMPLE_CHUNK, stride=SAMPLE_STRIDE,
                            low=low, high=high, cap=HOT_CAP, bits=HOT_BITS)
    _check(ids, num_segments)
    slots = 1 << HOT_BITS
    scratch = torch.zeros(n + slots + 1, dtype=torch.int32,
                          device=ids.device)
    sample, table, hot = scratch[:n], scratch[n:n + slots], scratch[-1:]
    stream, sms = common.launch_args(ids)
    with torch.cuda.device(ids.device):
        err = _fn("histogram_sample_launch",
                  [_ptr, _i64, _int, _i64, _ptr, _ptr])(
            ids.data_ptr(), w, n, SAMPLE_STRIDE, sample.data_ptr(), stream)
        common.check_launch("histogram sample", err)
        fn = _fn("histogram_hot_launch",
                 [_ptr, _int, _int, _int, _int, _int, _ptr, _ptr, _int, _ptr])
        for lo, hi in ((high, 2 ** 31 - 1), (low, high)):
            if lo < hi:
                err = fn(sample.data_ptr(), n, lo, hi, HOT_CAP, HOT_BITS,
                         table.data_ptr(), hot.data_ptr(), sms, stream)
                common.check_launch("histogram hot list", err)
    return table, hot


def _count(ids: torch.Tensor, n: int, out: torch.Tensor) -> None:
    """Adds the histogram of the non-empty `ids` into the zeroed `out`."""
    w = ids.numel()
    stream, sms = common.launch_args(ids)
    if n <= shared_max(ids.device):
        with torch.cuda.device(ids.device):
            err = _fn("histogram_shared_launch",
                      [_ptr, _i64, _int, _ptr, _int, _ptr])(
                ids.data_ptr(), w, n, out.data_ptr(), sms, stream)
        common.check_launch("histogram", err)
        return
    table = hot_list(ids, n)[0] if hot_thresholds(w)[0] <= sample_size(w) \
        else None
    with torch.cuda.device(ids.device):
        err = _fn("histogram_global_launch",
                  [_ptr, _i64, _int, _ptr, _int, _ptr, _int, _ptr])(
            ids.data_ptr(), w, n, None if table is None else table.data_ptr(),
            HOT_BITS, out.data_ptr(), sms, stream)
    common.check_launch("histogram", err)


def histogram(ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """counts[v] = |{w : ids[w] == v}| for v in [0, num_segments), int32.

    ids entries outside [0, num_segments) are ignored (use -1 to mask).
    """
    if ids.device.type == "cpu":
        return histogram_ref(ids, num_segments)
    _check(ids, num_segments)
    out = torch.zeros(num_segments, dtype=torch.int32, device=ids.device)
    if ids.numel() and num_segments:
        _count(ids, num_segments, out)
    common.launches["histogram"] += 1
    return out
