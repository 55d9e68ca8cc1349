#!/usr/bin/env python3
"""Time a checkout's threefry draws and single-device walk engine on the card.

    python3 scripts/bench_walk_draws.py [--root DIR] [--runs N]

Imports the port from DIR/src (default: this checkout), so the parent
commit unpacked elsewhere can be timed on the same card in the same call
(run parent, change, change, parent). On doc_link_graph(2^20), eps 0.2,
K = 139 (W = 145,752,064 walks):

* `uniform` of W float32 draws: device time of its kernel (torch.profiler)
  and the call's time between CUDA events;
* `simple_pagerank(engine="walks")`, untraced: seconds (host clock around
  a synchronised run), peak device memory, rounds and the launches of
  each kernel, `--runs` times after a warm-up run; then one more run
  under torch.profiler with device activity only: the device's busy time
  (every kernel, copy and set) by kernel, and the idle share, 1 - busy
  over the unprofiled runs' mean seconds.

Prints one JSON line with the card's name and power limit. Needs a card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--runs", type=int, default=3)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root / "src"))
    import torch
    if not torch.cuda.is_available():
        print("bench_walk_draws: no CUDA device", file=sys.stderr)
        return 2
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import prng
    from repro_torch.core import simple_pagerank, walks_per_node_for
    from repro_torch.graphs import doc_link_graph
    from repro_torch.kernels import common

    common.build_all()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    eps = 0.2
    g = doc_link_graph(1 << 20, seed=0)
    K = walks_per_node_for(g.n, eps)
    W = g.n * K
    key = prng.PRNGKey(11)

    def draw():
        return prng.uniform(key, (W,), device=g.device)

    draw()
    torch.cuda.synchronize()
    iters = 20
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            draw()
        torch.cuda.synchronize()
    # mean over the launches recorded: CUPTI has been seen to drop a
    # session's first kernel
    kernel_us = sum(getattr(e, "self_device_time_total", 0) / e.count * iters
                    for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA and e.count
                    and "uniform" in e.key)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        draw()
    end.record()
    torch.cuda.synchronize()
    out = dict(root=str(root), card=smi, W=W,
               uniform_ms=kernel_us / 1e3 / iters,
               uniform_call_ms=start.elapsed_time(end) / iters, walks=[])

    simple_pagerank(g, eps, engine="walks")     # warm-up
    for _ in range(args.runs):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        common.reset_launches()
        t0 = time.perf_counter()
        res = simple_pagerank(g, eps, engine="walks")
        torch.cuda.synchronize()
        out["walks"].append(dict(
            seconds=time.perf_counter() - t0,
            peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
            rounds=res.logical_rounds, launches=dict(common.launches),
            zeta_sum=int(res.zeta.sum(dtype=torch.int64))))
        del res
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        # a throwaway first kernel: CUPTI has been seen to drop a
        # session's first one
        torch.zeros(1, device=g.device)
        torch.cuda.synchronize()
        simple_pagerank(g, eps, engine="walks")
        torch.cuda.synchronize()
    by_kernel = {e.key[:80]: getattr(e, "self_device_time_total", 0) / 1e3
                 for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA}
    busy_ms = sum(by_kernel.values())
    wall_ms = 1e3 * sum(r["seconds"] for r in out["walks"]) / args.runs
    out.update(walks_busy_ms=busy_ms, walks_wall_ms=wall_ms,
               walks_idle_share=max(0.0, 1 - busy_ms / wall_ms),
               walks_device_ms_by_kernel=dict(sorted(
                   by_kernel.items(), key=lambda kv: -kv[1])[:8]))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
