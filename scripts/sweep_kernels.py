#!/usr/bin/env python3
"""Sweep the count engines' two kernels over their tuning choices on one
CUDA card, by device time (torch.profiler).

    python3 scripts/sweep_kernels.py [--root DIR] [--iters N]

On doc_link_graph(2**20, seed 0), eps 0.2, with the kernels of the
checkout at DIR (default this one):

  * `segment_spmv` on the power-iteration push (float) and on the
    single-device count engine's first-round sum (int32), with the hot
    list built at several thresholds of expected hits (the module's
    HOT_HITS set for the sweep), and with no hot list at all (every id in
    global memory);
  * the fused sampler (`multinomial_buckets`) on the single-device layout
    with every vertex holding K coupons, for K = 139 (the first round at
    this graph's K), 20 and 3: how its time splits between the slots and
    the draws.

Prints the card's name and power limit and, as its last line, one JSON
object of device ms a call (and hot ids a list).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path


def device_ms(fn, iters: int, part: str) -> float:
    """Device time a call of `fn`'s kernels whose names hold `part`."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and part in e.key
               ) / 1e3 / iters


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve() / "src"))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("sweep_kernels: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch import prng
    from repro_torch.core import aggregate_sampler as agg
    from repro_torch.core.graph import padded_adjacency_np
    from repro_torch.graphs import doc_link_graph
    from repro_torch.kernels import common
    from repro_torch.kernels.histogram import ops as histogram_ops
    from repro_torch.kernels.multinomial_rows import multinomial_buckets
    from repro_torch.kernels.multinomial_rows._math import key_words
    from repro_torch.kernels.segment_spmv import ops as spmv

    common.build_all()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    it = args.iters
    g = doc_link_graph(1 << 20, seed=0)
    n, dev = g.n, g.device
    src = g.edge_src()
    push = (torch.full((n,), 1.0 / n, device=dev).index_select(0, src)
            / torch.clamp(g.out_deg, min=1).float().index_select(0, src))
    row_ptr, col, deg = g.numpy()
    nbr, _ = padded_adjacency_np(row_ptr, col, deg, g.max_out_deg)
    layout, perm_np = agg.build_layout(deg, nbr.shape[1])
    perm = torch.from_numpy(np.ascontiguousarray(perm_np)).to(dev)
    bnbr = torch.from_numpy(agg.bucketize_adjacency(nbr, perm_np, layout)
                            ).to(dev)
    kw = key_words(prng.split(prng.PRNGKey(0))[1])
    rid = torch.arange(n, dtype=torch.int32, device=dev)

    def sampler(K):
        counts = torch.full((n,), K, dtype=torch.int32, device=dev)
        return lambda: multinomial_buckets(counts, g.out_deg, rid, kw, perm,
                                           layout.widths, layout.caps,
                                           eps=0.2)

    out = {"card": smi}
    counts_sum = sampler(139)()[0]
    sums = {"push": (push, g.col_idx), "count_sum": (counts_sum, bnbr)}
    for hits in (8000, 2000, 500, 125):
        spmv.HOT_HITS = hits
        for name, (vals, dst) in sums.items():
            hot = spmv.hot_list(dst, n)
            out[f"{name}_hits{hits}_ms"] = device_ms(
                lambda: spmv.segment_spmv(vals, dst, n, count_bound=2 ** 31,
                                          hot=hot), it, "segment_sum")
            out[f"{name}_hits{hits}_hot_ids"] = int((hot > 0).sum())

    def without_hot_list(vals, dst):
        """The kernel with a null table: every id in global memory."""
        lib = common.library("segment_spmv")
        if vals.dtype == torch.float32:
            bufs = (torch.zeros(n, dtype=torch.float64, device=dev),
                    torch.empty(n, dtype=torch.float32, device=dev))
            fn = lib.segment_spmv_f32_launch
        else:
            bufs = (torch.zeros(n, dtype=torch.int32, device=dev),)
            fn = lib.segment_spmv_i32_launch
        p = ctypes.c_void_p
        fn.argtypes = [p, p, ctypes.c_longlong, ctypes.c_int, p,
                       ctypes.c_int, *[p] * len(bufs), ctypes.c_int, p]
        fn.restype = ctypes.c_int
        stream, sms = common.launch_args(vals)
        common.check_launch("segment_spmv", fn(
            vals.data_ptr(), dst.data_ptr(), vals.numel(), n, None,
            histogram_ops.HOT_BITS, *[b.data_ptr() for b in bufs], sms,
            stream))
        return bufs[-1]

    for name, (vals, dst) in sums.items():
        out[f"{name}_no_hot_list_ms"] = device_ms(
            lambda: without_hot_list(vals, dst), it, "segment_sum")
    for K in (139, 20, 3):
        out[f"sampler_K{K}_ms"] = device_ms(sampler(K), it,
                                            "multinomial_buckets")
    print(smi)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
