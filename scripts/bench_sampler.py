#!/usr/bin/env python3
"""Time the count engines' sampler round and the `segment_spmv` sums of a
checkout of the port on one CUDA card.

    python3 scripts/bench_sampler.py [--root DIR] [--iters N]

Imports `repro_torch` from DIR/src (default: this checkout), builds its
kernels there, and times, on doc_link_graph(2**20, seed 0) at eps 0.2 and
K = 139 walks a vertex (the count engines' first round):

  * the sampler round on the single-device layout and on the stacked
    layout of P = 4 shards: `multinomial_buckets` where the checkout has
    it (one fused launch), else `sample_buckets` + `flatten_moves` (a
    launch per bucket and the gathers around it);
  * the power-iteration push through `segment_spmv` (with the hot list
    built once, where the checkout has one);
  * the single-device count engine's sum of the round's moves by
    destination, as that checkout's engine computes it (`segment_sum_int`
    with its hot list, else int32 `index_add_`), and, where the checkout
    has no `segment_sum_int`, its `segment_spmv` integer entry on the same
    input.

Each stage is timed twice: between CUDA events over a run of calls
(the host's launch rate where the kernels are short), and as the device
time of all its kernels from torch.profiler. Then each count engine end to
end, on the host clock: `simple_pagerank` with engine="counts" (traced),
and the sharded engine at P = 4 with unpacked lanes, with its
`sampler_s`. The moves and the engines' zeta are
checked to be equal across the two ways of computing them. Prints the
card's name and power limit and, as its last line, one JSON object. Run it
on two checkouts in one call (parent, change, change, parent) to compare
them on one card.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path


def cuda_ms(fn, iters: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int) -> float:
    """The device time of all of `fn`'s kernels, copies and fills, a call,
    from torch.profiler: where they are short, `cuda_ms` times the host
    launching them instead."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
             for e in prof.key_averages() if e.device_type == DeviceType.CUDA)
    return us / 1e3 / iters


def wall_s(fn):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root / "src"))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("bench_sampler: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch import prng
    from repro_torch.core import (aggregate_sampler as agg, simple_pagerank,
                                  walks_per_node_for)
    from repro_torch.core.collectives import StackedMesh
    from repro_torch.core.distributed_counts import (
        distributed_pagerank_counts, shard_graph_padded)
    from repro_torch.core.graph import padded_adjacency_np
    from repro_torch.graphs import doc_link_graph
    from repro_torch.kernels import common
    from repro_torch.kernels import multinomial_rows as mn
    from repro_torch.kernels import segment_spmv as spmv
    from repro_torch.kernels.multinomial_rows._math import key_words

    for name, text in common.build_all().items():
        for line in text.splitlines():
            if name in ("segment_spmv", "multinomial_rows") and (
                    "registers" in line or "spill" in line or "error" in line):
                print(f"  {name}: {line.strip()}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    eps, it = 0.2, args.iters
    g = doc_link_graph(1 << 20, seed=0)
    n, dev = g.n, g.device
    K = walks_per_node_for(n, eps)
    fused = hasattr(mn, "multinomial_buckets")
    hot_of = getattr(spmv, "hot_list", None)
    out = dict(root=str(root), card=smi, fused_sampler=fused,
               hot_list=hot_of is not None)

    row_ptr, col, deg = g.numpy()
    nbr, _ = padded_adjacency_np(row_ptr, col, deg, g.max_out_deg)
    layout, perm_np = agg.build_layout(deg, nbr.shape[1])
    perm = torch.from_numpy(np.ascontiguousarray(perm_np)).to(dev)
    sg = shard_graph_padded(g, 4)
    kw = key_words(prng.split(prng.PRNGKey(0))[1])
    counts = torch.full((n,), K, dtype=torch.int32, device=dev)
    rid = torch.arange(n, dtype=torch.int32, device=dev)
    layouts = {"single": (counts, g.out_deg, rid, perm, layout, 1),
               "stacked_p4": (counts, sg.deg.reshape(-1), rid,
                              sg.stacked_perm, sg.stacked_layout, 4)}
    moves = {}
    for label, (c, d, r, pm, lay, P) in layouts.items():
        if fused:
            def round_():
                return mn.multinomial_buckets(c, d, r, kw, pm, lay.widths,
                                              lay.caps, eps=eps, shards=P)[0]
        else:
            def round_():
                samples = agg.sample_buckets(c, d, r, kw, pm, lay, eps=eps)[0]
                return agg.flatten_moves(samples, P if P > 1 else None
                                         ).reshape(-1)
        moves[label] = round_()
        out[f"sampler_{label}_ms"] = cuda_ms(round_, it)
        out[f"sampler_{label}_device_ms"] = device_ms(round_, it)
        out[f"moves_{label}_sha256"] = hashlib.sha256(
            moves[label].cpu().numpy().tobytes()).hexdigest()[:16]

    src = g.edge_src()
    contrib = (torch.full((n,), 1.0 / n, device=dev).index_select(0, src)
               / torch.clamp(g.out_deg, min=1).float().index_select(0, src))
    push_kw = {"hot": hot_of(g.col_idx, n)} if hot_of else {}

    def push():
        return spmv.segment_spmv(contrib, g.col_idx, n, **push_kw)

    out["push_ms"] = cuda_ms(push, it)
    out["push_device_ms"] = device_ms(push, it)

    bnbr = torch.from_numpy(agg.bucketize_adjacency(nbr, perm_np, layout)
                            ).to(dev)
    flat = moves["single"]
    if hasattr(spmv, "segment_sum_int"):
        hot = hot_of(bnbr, n)

        def count_sum():
            return spmv.segment_sum_int(flat, bnbr, n, hot=hot)
    else:
        def count_sum():
            return torch.zeros(n, dtype=torch.int32, device=dev).index_add_(
                0, bnbr, flat)

        def kernel_sum():
            return spmv.segment_spmv(flat, bnbr, n, count_bound=2 ** 31 - 1)

        out["count_sum_kernel_ms"] = cuda_ms(kernel_sum, it)
        out["count_sum_kernel_device_ms"] = device_ms(kernel_sum, it)
    out["count_sum_ms"] = cuda_ms(count_sum, it)
    out["count_sum_device_ms"] = device_ms(count_sum, it)
    del moves, flat, bnbr

    res, out["counts_s"] = wall_s(lambda: simple_pagerank(
        g, eps, engine="counts", traced=True))
    zeta = res.zeta
    res, out["sharded_counts_p4_s"] = wall_s(
        lambda: distributed_pagerank_counts(
            g, eps, K, prng.PRNGKey(0), mesh=StackedMesh(4, dev),
            packed=False))
    out["sharded_sampler_s"] = res.sampler_us / 1e6
    out["rounds"] = res.rounds
    if not torch.equal(res.zeta, zeta):
        print("bench_sampler: the sharded engine's zeta differs from the "
              "single-device engine's", file=sys.stderr)
        return 1
    out["zeta_sha256"] = hashlib.sha256(
        zeta.cpu().numpy().tobytes()).hexdigest()[:16]
    print(smi)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
