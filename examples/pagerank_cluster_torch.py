"""Sharded PageRank with injected failures, on the port.

    PYTHONPATH=src python examples/pagerank_cluster_torch.py --device cpu
    PYTHONPATH=src python examples/pagerank_cluster_torch.py --n 1048576

The JAX package's examples/pagerank_cluster.py on `repro_torch`: a
vertex-sharded graph, all_to_all walk routing, checkpoint-restart
supervision with two injected failures, and exact-recovery validation.
The JAX example runs 8 forced host devices; here the 8 shards are stacked
on one device (`core.collectives.StackedMesh`), the card unless
`--device` names another. Each run prints its rounds and seconds, the
failing run its restarts and the checkpoint directory's bytes; the
script exits non-zero unless the recovered pi equals the clean pi bit for
bit after 2 restarts.
"""
import argparse
import os
import tempfile

import numpy as np

from repro_torch.launch.pagerank import run
from repro_torch.launch.stages import Stages, device_lines, device_or_exit

FAIL_AT = [6, 17]


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=256,
                    help="vertices of the Erdős–Rényi graph")
    ap.add_argument("--shards", type=int, default=8,
                    help="vertex shards stacked on the device")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = device_or_exit(args.device)
    for line in device_lines(device):
        print(line)
    print(f"shards: {args.shards} stacked on {device}")
    stages = Stages(device)

    kw = dict(n=args.n, eps=0.2, walks_per_node=64,
              graph_kind="erdos_renyi", shards=args.shards, device=device)
    with tempfile.TemporaryDirectory() as ckpt_dir:
        print("--- clean run ---")
        with stages("clean"):
            clean = run(checkpoint_dir=None, fail_at=[], **kw)
        print(f"--- run with failures at rounds {FAIL_AT[0]} and "
              f"{FAIL_AT[1]} ---")
        with stages("failures"):
            ft = run(checkpoint_dir=ckpt_dir, fail_at=FAIL_AT, **kw)
        ckpt_bytes = dir_bytes(ckpt_dir)
    exact = bool(np.array_equal(clean.pi, ft.pi))
    print(f"recovered run bit-exact with clean run: {exact}")
    print(f"clean run: {clean.rounds} rounds in "
          f"{stages.seconds['clean']:.3f} s; with failures: {ft.rounds} "
          f"rounds, restarts={ft.restarts}, in "
          f"{stages.seconds['failures']:.3f} s; checkpoint directory "
          f"{ckpt_bytes} bytes")
    stages.print()
    out = dict(device=str(device), n=args.n, shards=clean.shards,
               pi_clean=clean.pi, pi_recovered=ft.pi, exact=exact,
               rounds=clean.rounds, rounds_recovered=ft.rounds,
               restarts=ft.restarts, l1=clean.l1, top10=clean.topk,
               checkpoint_bytes=ckpt_bytes, **stages.report())
    if not exact or ft.restarts != len(FAIL_AT):
        raise SystemExit(f"pagerank_cluster: check failed: bit-exact "
                         f"{exact}, restarts {ft.restarts}")
    return out


if __name__ == "__main__":
    main()
