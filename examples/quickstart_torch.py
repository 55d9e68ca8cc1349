"""Quickstart on the port: the paper's two algorithms on a small graph, end
to end, on the CUDA card.

    PYTHONPATH=src python examples/quickstart_torch.py --device cpu
    PYTHONPATH=src python examples/quickstart_torch.py --n 524288   (the card)

The JAX package's examples/quickstart.py on `repro_torch`: the same graph,
keys and lines, so on the CPU at the default size it prints the JAX
example's numbers. Without `--device` it runs on the card, and exits
non-zero where there is none. It also prints the seconds and kernel
launches of each stage (the graph is built by a Python loop on the host),
and exits non-zero unless both algorithms reach L1 < 0.15 and top-10 >=
0.6 against power iteration and Algorithm 2 takes fewer CONGEST rounds.
"""
import argparse

from repro_torch import prng
from repro_torch.core import (improved_pagerank, l1_error, normalized,
                              power_iteration, simple_pagerank, topk_overlap,
                              walks_per_node_for)
from repro_torch.graphs import barabasi_albert
from repro_torch.launch.stages import Stages, device_lines, device_or_exit

L1_TOL, TOPK_MIN = 0.15, 0.6


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=512,
                    help="vertices of the Barabási–Albert graph")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = device_or_exit(args.device)
    for line in device_lines(device):
        print(line)
    stages = Stages(device)

    eps = 0.2
    with stages("graph"):
        g = barabasi_albert(args.n, 3, seed=0, device=device)
    print(f"graph: n={g.n} m={g.m} (Barabási–Albert power-law)")

    # classical baseline the paper argues against
    with stages("power_iteration"):
        pi_ref, delta, iters = power_iteration(g, eps, device=device)
    pi_ref = pi_ref.cpu().numpy()
    print(f"power iteration: {iters} iterations to L1 delta {delta:.2e}")

    # Algorithm 1: SIMPLE-PAGERANK (O(log n / eps) rounds)
    K = walks_per_node_for(g.n, eps)
    with stages("simple_pagerank"):
        res = simple_pagerank(g, eps, walks_per_node=K,
                              key=prng.PRNGKey(0), traced=True,
                              device=device)
    l1 = l1_error(normalized(res.pi), pi_ref)
    top = topk_overlap(res.pi, pi_ref)
    print(f"SIMPLE-PAGERANK: K={K} walks/node, "
          f"{res.logical_rounds} logical rounds, "
          f"{res.report.congest_rounds} CONGEST rounds, "
          f"max bits/edge/round={res.report.max_bits_per_edge_per_round}")
    print(f"  L1 vs baseline: {l1:.4f}  top-10 overlap: {top:.2f}")

    # Algorithm 2: IMPROVED-PAGERANK (O(sqrt(log n)/eps) rounds)
    with stages("improved_pagerank"):
        res2 = improved_pagerank(g, eps, walks_per_node=K,
                                 key=prng.PRNGKey(1), device=device)
    l1_2 = l1_error(normalized(res2.pi), pi_ref)
    top_2 = topk_overlap(res2.pi, pi_ref)
    rounds, rounds_2 = res.report.congest_rounds, res2.report.congest_rounds
    print(f"IMPROVED-PAGERANK: lambda={res2.lam}, "
          f"{res2.stitch_iterations} stitch iters, "
          f"{rounds_2} CONGEST rounds "
          f"({rounds / rounds_2:.1f}x fewer than SIMPLE)")
    print(f"  L1 vs baseline: {l1_2:.4f}  "
          f"coupons used/created: {res2.coupons_used}/{res2.coupons_created}")
    print(f"  top-10 overlap: {top_2:.2f}")
    stages.print()

    out = dict(device=str(device), n=g.n, m=g.m, power_iterations=iters,
               power_delta=delta, power_pi=pi_ref, K=K,
               logical_rounds=res.logical_rounds, congest_rounds=rounds,
               max_bits=res.report.max_bits_per_edge_per_round, l1=l1,
               top10=top, lam=res2.lam,
               stitch_iterations=res2.stitch_iterations,
               congest_rounds_2=rounds_2, l1_2=l1_2, top10_2=top_2,
               coupons_used=res2.coupons_used,
               coupons_created=res2.coupons_created, **stages.report())
    failed = [f"{name} L1 {v:.4f} >= {L1_TOL}"
              for name, v in (("SIMPLE", l1), ("IMPROVED", l1_2))
              if not v < L1_TOL]
    failed += [f"{name} top-10 {v:.2f} < {TOPK_MIN}"
               for name, v in (("SIMPLE", top), ("IMPROVED", top_2))
               if not v >= TOPK_MIN]
    if not rounds_2 < rounds:
        failed.append(f"IMPROVED takes {rounds_2} CONGEST rounds, SIMPLE "
                      f"{rounds}")
    if failed:
        raise SystemExit("quickstart: check failed: " + "; ".join(failed))
    return out


if __name__ == "__main__":
    main()
