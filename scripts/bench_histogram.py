#!/usr/bin/env python3
"""Time the `histogram` kernel of a checkout of the port on one CUDA card.

    python3 scripts/bench_histogram.py [--root DIR] [--iters N]

Imports `repro_torch` from DIR/src (default: this checkout), builds its
kernels there, and times `histogram(ids, n)` by CUDA events on two inputs
of the main path's shape (W = n * K ids, n = 2**20):

  * real: the arrivals of the single-device walk engine's first round on
    doc_link_graph(2**20, seed 0), dead walks as -1 (a web graph's hubs);
  * uniform: the same -1 slots, every other id drawn uniformly from
    [0, n) (no hub: the same number of valid ids, spread out).

Both are checked exactly against the plain version. Also reports the
first round's expected hits per vertex from the graph (how skewed the real
ids are). Prints the card's
name and power limit and, as its last line, one JSON object with the
times. Run it on two checkouts in one call to compare them on one card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
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


def expected_hits(g, K: int, eps: float) -> dict:
    """The first round's expected arrivals per vertex, (1 - eps) K / deg
    summed over in-edges: how many vertices pass each hit count and what
    share of the arrivals they take."""
    import torch
    src = g.edge_src()
    w = (1 - eps) * K / torch.clamp(g.out_deg, min=1).double()[src]
    hits = torch.zeros(g.n, dtype=torch.float64, device=w.device)
    hits.index_add_(0, g.col_idx.long(), w)
    top = torch.sort(hits, descending=True).values
    out = {"top15_share": float(top[:15].sum() / top.sum())}
    for t in (50_000, 10_000, 2_000):
        above = hits > t
        out[f"above_{t}"] = [int(above.sum()),
                             float(hits[above].sum() / hits.sum())]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root / "src"))
    import torch
    if not torch.cuda.is_available():
        print("bench_histogram: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch import prng
    from repro_torch.core import walks_per_node_for
    from repro_torch.graphs import doc_link_graph
    from repro_torch.kernels import common
    from repro_torch.kernels.histogram import histogram
    from repro_torch.kernels.histogram import ops
    from repro_torch.kernels.histogram.ref import histogram_ref
    from repro_torch.kernels.walk_step import walk_step_keyed

    for name, text in common.build_all().items():
        for line in text.splitlines():
            if name == "histogram" and ("registers" in line or "spill" in line
                                        or "error" in line):
                print(f"  {name}: {line.strip()}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    eps = 0.2
    g = doc_link_graph(1 << 20, seed=0)
    n = g.n
    K = walks_per_node_for(n, eps)
    # the walk engine's first round: every walk alive at its start vertex,
    # the engine's keys (init_state's key, split in three)
    pos = torch.arange(n, dtype=torch.int32, device=g.device).repeat(K)
    _, k_term, k_edge = prng.split(prng.PRNGKey(0), 3)
    dst, survive = walk_step_keyed(pos, torch.ones_like(pos), k_term, k_edge,
                                   g.row_ptr, g.col_idx, g.out_deg, eps=eps)
    survive = survive.bool()
    real = torch.where(survive, dst, -1)
    del pos, dst
    gen = torch.Generator(device=real.device).manual_seed(0)
    uniform = torch.where(survive, torch.randint(
        0, n, real.shape, generator=gen, device=real.device,
        dtype=torch.int32), -1)
    del survive
    out = dict(root=str(root), card=smi, W=real.numel(), n=n,
               expected_hits=expected_hits(g, K, eps))
    for name, ids in (("real", real), ("uniform", uniform)):
        want = histogram_ref(ids, n)
        err = int((histogram(ids, n) - want).abs().max())
        if err:
            print(f"bench_histogram: {name} ids differ by {err}",
                  file=sys.stderr)
            return 1
        out[f"{name}_ms"] = cuda_ms(lambda: histogram(ids, n), args.iters)
        out[f"{name}_top_share"] = float(want.max()) / float(want.sum())
        if hasattr(ops, "hot_list"):
            out[f"{name}_hot_list_ms"] = cuda_ms(lambda: ops.hot_list(ids, n),
                                                 args.iters)
            out[f"{name}_hot_ids"] = int(ops.hot_list(ids, n)[1])
    print(smi)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
