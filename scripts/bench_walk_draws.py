#!/usr/bin/env python3
"""Time a checkout's threefry draws, walk step and single-device walk engine
on the card.

    python3 scripts/bench_walk_draws.py [--root DIR] [--runs N]

Imports the port from DIR/src (default: this checkout), so the parent
commit unpacked elsewhere, or a variant of the kernels, can be timed on
the same card in the same call (run parent, change, change, parent). On
doc_link_graph(2^20), eps 0.2, K = 139 (W = 145,752,064 walks):

* the keyed walk step against its plain version, bit for bit, on 2^20 + 7
  slots with a fifth of them dead, bool and int32 `alive` (edge ids and,
  where the checkout has the in-place entry, the appended arrivals as a
  histogram);
* `uniform` of W float32 draws: device time of its kernel (torch.profiler)
  and the call's time between CUDA events;
* the keyed walk step's device time at the engine's first round (all W
  slots alive, with the edge output) and at its rounds 2 and 10 (the
  launch as the engine makes it); the SASS of both threefry kernels
  (cuobjdump, through the checkout's `chip_smoke.py::sass_loop`):
  instructions and ALU-pipe instructions a draw in the loop it picks;
* `simple_pagerank(engine="walks")`, untraced: seconds (host clock
  around a synchronised run), peak device memory,
  rounds, the launches of each kernel and the ids the engine histograms,
  `--runs` times after a warm-up run; then one more run under
  torch.profiler with device activity only: the device's busy time (every
  kernel, copy and set) by kernel, and the idle share, 1 - busy over the
  unprofiled runs' mean seconds.

Prints one JSON line with the card's name and power limit. Needs a card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path


def kernel_ms(fn, iters, part):
    """Device time of the kernels whose names hold `part`, a call of `fn`,
    from torch.profiler over `iters` calls: the mean over the launches
    recorded (CUPTI has been seen to drop a session's first kernel)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(getattr(e, "self_device_time_total", 0) / e.count
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.count
               and part in e.key) / 1e3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--runs", type=int, default=3)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import chip_smoke  # the checkout's: it puts DIR/src first on the path
    import torch
    if not torch.cuda.is_available():
        print("bench_walk_draws: no CUDA device", file=sys.stderr)
        return 2
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import prng
    from repro_torch.core import (engine_walks, simple_pagerank,
                                  walks_per_node_for)
    from repro_torch.graphs import doc_link_graph
    from repro_torch.kernels import common
    from repro_torch.kernels import walk_step as ws
    from repro_torch.kernels.histogram.ref import histogram_ref
    from repro_torch.kernels.walk_step.ref import walk_step_keyed_ref

    logs = common.build_all()
    inplace = hasattr(ws, "walk_step_keyed_")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    eps = 0.2
    g = doc_link_graph(1 << 20, seed=0)
    K = walks_per_node_for(g.n, eps)
    W = g.n * K
    tables = (g.row_ptr, g.col_idx, g.out_deg)
    out = dict(root=str(root), card=smi, W=W,
               inplace_entry=inplace,
               ptxas=[line.strip() for line in logs["walk_step"].splitlines()
                      if "registers" in line or "spill" in line])

    # exact against the plain version
    gen = torch.Generator(device=g.device).manual_seed(5)
    w = (1 << 20) + 7
    pos = torch.randint(-2, g.n + 2, (w,), generator=gen, device=g.device,
                        dtype=torch.int32)
    live = torch.rand(w, generator=gen, device=g.device) < 0.8
    kt, ke = prng.split(prng.PRNGKey(9))
    exact = True
    for alive in (live, live.to(torch.int32)):
        got = ws.walk_step_keyed(pos, alive, kt, ke, *tables, eps=eps,
                                 edges=True)
        want = walk_step_keyed_ref(pos, alive, kt, ke, *tables, eps=eps,
                                   edges=True)
        exact &= all(torch.equal(a, b) for a, b in zip(got, want))
        if inplace:
            p, a = pos.clone(), alive.clone()
            arr = torch.empty_like(pos)
            count = ws.walk_step_keyed_(p, a, kt, ke, *tables, eps=eps,
                                        arrivals=arr)
            moved = int(count)
            exact &= (torch.equal(p, want[0]) and torch.equal(a, want[1])
                      and moved == int(want[1].bool().sum())
                      and torch.equal(histogram_ref(arr[:moved], g.n),
                                      histogram_ref(torch.where(
                                          want[1].bool(), want[0], -1), g.n)))
    out["exact"] = exact
    del pos, live, got, want

    key = prng.PRNGKey(11)

    def draw():
        return prng.uniform(key, (W,), device=g.device)

    out["uniform_ms"] = kernel_ms(draw, 20, "uniform")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(20):
        draw()
    end.record()
    torch.cuda.synchronize()
    out["uniform_call_ms"] = start.elapsed_time(end) / 20

    # the keyed step at the engine's first round (with edges), rounds 2, 10
    state = engine_walks.init_state(g, K, prng.PRNGKey(0))
    _, kt, ke = prng.split(state.key, 3)
    first = (state.pos, state.alive, kt, ke, *tables)
    out["first_round_ms"] = kernel_ms(
        lambda: ws.walk_step_keyed(*first, eps=eps, edges=True), 10,
        "walk_step")
    buf = torch.empty_like(state.pos)
    done = 1
    for at in (2, 10):
        for _ in range(at - done):
            state, _ = engine_walks._step_core(*tables, eps, state)
        done = at
        _, kt, ke = prng.split(state.key, 3)

        def launch():
            if inplace:   # the engine's launch, on copies of the state
                return ws.walk_step_keyed_(
                    state.pos.clone(), state.alive.clone(), kt, ke, *tables,
                    eps=eps, arrivals=buf)
            return ws.walk_step_keyed(state.pos, state.alive, kt, ke,
                                      *tables, eps=eps)

        out[f"round{at}_ms"] = kernel_ms(launch, 10, "walk_step")
        out[f"round{at}_live"] = int(state.alive.sum())
    del state, first, buf
    for name, part in (("walk_step", "walk_step_inplace_kernelIhLb0"
                        if inplace else "walk_step_keyed_kernelIhLb1"),
                       ("uniform", "uniform_quad_kernel")):
        sass = chip_smoke.sass_loop(common.library_path(name), part)
        if sass and sass["draws"]:
            out[f"{name}_sass"] = dict(
                symbol=sass["symbol"], loop=sass["instructions"],
                draws=sass["draws"],
                per_draw=sass["instructions"] / sass["draws"],
                alu_per_draw=chip_smoke.alu_instructions(sass["opcodes"])
                / sass["draws"], opcodes=sass["opcodes"])
    torch.cuda.empty_cache()

    hist_ids = []
    counted = engine_walks.histogram

    def histogram(ids, n):
        hist_ids.append(ids.numel())
        return counted(ids, n)

    engine_walks.histogram = histogram
    simple_pagerank(g, eps, engine="walks")     # warm-up
    out["walks"] = []
    for _ in range(args.runs):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        common.reset_launches()
        hist_ids.clear()
        t0 = time.perf_counter()
        res = simple_pagerank(g, eps, engine="walks")
        torch.cuda.synchronize()
        out["walks"].append(dict(
            seconds=time.perf_counter() - t0,
            peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
            rounds=res.logical_rounds, launches=dict(common.launches),
            histogram_ids=sum(hist_ids),
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
