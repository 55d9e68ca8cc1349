#!/usr/bin/env python3
"""The sharded engines with one shard per card, over NCCL: Algorithm 1's
walk and count engines, Algorithm 2's three-phase engine, and batched
Personalized PageRank with its service.

    python3 scripts/multi_card.py          # on a host with two or more cards

Builds the kernels, then, with `torch.distributed.run` (torchrun) starting
one process a card:

1. the launcher, `repro_torch.launch.pagerank.main` with `--algo walks`
   and `--algo improved` on erdos_renyi(2^20, 8), K = 139, and `--algo
   counts` on erdos_renyi(65536 x cards, 8) (the launcher's packed count
   lanes hold 65,536 local ids a shard), `--check`, each timed from the
   command's start to its end (process start-up, graph, run), and `--algo
   ppr` on erdos_renyi(2^20, 8), 16 queries of 2^21 walks, without
   `--check` (n is above the launcher's dense-solve limit). It runs
   through this script (`--cli ALGO`), not `-m`: torchrun's
   own parser (torch 2.11, Python 3.12.3) takes the launcher's `--n` for
   an abbreviation of its options and refuses the command;
2. this script as the worker (`--worker`): the count engine (unpacked
   lanes) on doc_link_graph(2^20), the walk engine and Algorithm 2 on
   erdos_renyi(2^20, 8), K = 139 each, over a `ProcessGroupMesh`, each
   run twice and timed per vector between barriers (the first run also
   sets up NCCL's connections); the all_to_all of each engine's round
   lanes timed alone; the batched PPR engine on doc_link_graph(2^20), 16
   queries of 2^21 walks (chip_smoke's PPR width), run twice, timed per
   batch between barriers; the PPR service (chip_smoke's
   `ppr_service_trace` at 2^21 walks a query: 40 requests on an injected
   clock, shrunk to cards / 2 at tick 10 and grown back at tick 30),
   timed between barriers; then rank 0 runs the engines and the service
   on `StackedMesh(cards)` on its own card, and each result must be
   bit-equal (zeta, rounds, wire counters; Algorithm 2's rounds, coupons
   and walks by phase too; PPR's vectors, supersteps and live-walk
   trace; the service's answers, statistics, and every card's host state
   after each tick equal to the stacked service's).

Prints the card's name and power limit and one JSON line per part; exits
non-zero if a part fails or disagrees.
"""
from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))        # chip_smoke's PPR queries and trace

EPS = 0.2
N = 1 << 20
ENGINES = ("counts", "walks", "improved", "ppr")
PPR_QUERIES, PPR_WALKS = 16, 1 << 21
TIMEOUT_S = 420         # a torchrun command; its group's collectives: 360


def summary(res, engine: str) -> dict:
    import hashlib
    import numpy as np
    if engine == "ppr":
        from chip_smoke import ppr_summary
        return ppr_summary(res)
    out = dict(zeta=hashlib.sha256(np.ascontiguousarray(
        res.zeta.cpu().numpy().astype(np.int32)).tobytes()).hexdigest(),
        rounds=res.rounds)
    if engine == "improved":
        out.update(
            by_phase=[res.phase1_rounds, res.phase2_rounds,
                      res.phase3_rounds, res.tail_rounds],
            coupons=[res.coupons_created, res.coupons_used],
            walks=[res.terminated_by_coupon, res.exhausted_walks,
                   res.tail_walks],
            a2a_bytes=dict(res.a2a_bytes_by_phase),
            a2a_entries=dict(res.a2a_entries_by_site),
            phase2_records=hashlib.sha256(json.dumps(
                res.phase2_records).encode()).hexdigest(),
            occupancy=list(res.p1_occupancy), dropped=res.dropped,
            waited=res.waited, residual=res.residual)
        return out
    out.update(a2a_entries=res.a2a_entries_total,
               a2a_bytes=res.a2a_bytes_total)
    if engine == "walks":
        out.update(dropped=res.dropped, waited=res.waited)
    else:
        out.update(overflow=res.overflow, residual=res.residual)
    return out


def a2a_ms(mesh, shape, iters: int = 10) -> float:
    """Mean ms of one `mesh.all_to_all` of an int32 tensor of `shape`,
    between CUDA events, every rank starting together."""
    import torch
    x = torch.zeros(shape, dtype=torch.int32, device=mesh.device)
    mesh.all_to_all(x)
    mesh.barrier()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        mesh.all_to_all(x)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def worker() -> int:
    import torch
    from repro_torch import prng
    from repro_torch.core import walks_per_node_for
    from repro_torch.core.collectives import StackedMesh, start_group
    from repro_torch.core.distributed import (default_route_cap,
                                              distributed_pagerank)
    from repro_torch.core.distributed_counts import (
        distributed_pagerank_counts, shard_graph_padded)
    from repro_torch.core.distributed_improved import \
        distributed_improved_pagerank
    from repro_torch.core.personalized_batch import \
        batched_personalized_pagerank
    from repro_torch.graphs import doc_link_graph, erdos_renyi
    from repro_torch.kernels import common
    from chip_smoke import ppr_queries, ppr_service_trace

    mesh = start_group(timeout=TIMEOUT_S - 60)
    P, dev = mesh.shards, mesh.device
    key = prng.PRNGKey(0)
    graphs = dict(counts=doc_link_graph(N, seed=0, device=dev),
                  walks=erdos_renyi(N, 8.0, seed=0, device=dev))
    graphs["improved"] = graphs["walks"]
    graphs["ppr"] = graphs["counts"]
    K = walks_per_node_for(N, EPS)
    queries = ppr_queries(N, PPR_QUERIES)

    def run(engine, m):
        g = graphs[engine]
        if engine == "counts":
            return distributed_pagerank_counts(g, EPS, K, key, mesh=m,
                                               packed=False)
        if engine == "improved":
            return distributed_improved_pagerank(g, EPS, K, key, mesh=m)
        if engine == "ppr":
            return batched_personalized_pagerank(g, EPS, queries, PPR_WALKS,
                                                 key, mesh=m)
        return distributed_pagerank(g, EPS, K, key, mesh=m)

    out = dict(shards=P, K=K, backend=str(mesh))
    for engine in ENGINES:
        secs = []
        for _ in range(2):
            common.reset_launches()
            mesh.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = run(engine, mesh)
            torch.cuda.synchronize()
            mesh.barrier()
            secs.append(time.perf_counter() - t0)
        out[engine] = dict(summary(res, engine), seconds=secs,
                           launches=dict(common.launches))
        if engine == "improved":
            out[engine]["sampler_s_rank"] = res.sampler_us / 1e6
        del res
        torch.cuda.empty_cache()
    common.reset_launches()
    mesh.barrier()
    t0 = time.perf_counter()
    service = ppr_service_trace(graphs["ppr"], mesh, PPR_WALKS)
    torch.cuda.synchronize()
    mesh.barrier()
    out["service"] = dict(seconds=time.perf_counter() - t0,
                          stats=service["stats"], ticks=service["ticks"],
                          launches=dict(common.launches))
    services = mesh.gather_objects(service)
    lane_cap = shard_graph_padded(graphs["counts"], P).lane_cap
    out["a2a_ms"] = {
        "count lanes": dict(shape=[1, P * lane_cap, 2], ms=a2a_ms(
            mesh, (1, P * lane_cap, 2))),
        "walk lanes": dict(shape=[1, P * default_route_cap(N * K, P)],
                           ms=a2a_ms(mesh, (1, P * default_route_cap(
                               N * K, P))))}
    ok = True
    if mesh.rank == 0:
        for engine in ENGINES:
            t0 = time.perf_counter()
            res = run(engine, StackedMesh(P, dev))
            torch.cuda.synchronize()
            want = summary(res, engine)
            del res
            torch.cuda.empty_cache()
            got = {k: out[engine][k] for k in want}
            out[engine].update(stacked_seconds=time.perf_counter() - t0,
                               equal_to_stacked=got == want)
            ok &= got == want
        t0 = time.perf_counter()
        want = ppr_service_trace(graphs["ppr"], StackedMesh(P, dev),
                                 PPR_WALKS)
        out["service"]["stacked_seconds"] = time.perf_counter() - t0
        equal = {f: services[0][f] == want[f]
                 for f in ("requests", "queries", "results", "stats",
                           "states")}
        # every card's host state after each tick it served is rank 0's;
        # the cards the shrink left out served again after the grow
        equal["every_card"] = all(
            all(s["states"][t] == want["states"][t] for t in s["states"])
            and s["serving"] == [r < P // 2, True]
            for r, s in enumerate(services))
        out["service"]["equal_to_stacked"] = equal
        ok &= all(equal.values())
        print(json.dumps(out), flush=True)
    mesh.barrier()
    torch.distributed.destroy_process_group()
    return 0 if ok else 1


def torchrun(cards: int, args: list) -> tuple:
    """(exit code, stdout, stderr, seconds) of one torchrun command, its
    whole process group killed past TIMEOUT_S."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={cards}", *args]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="4")
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, cwd=ROOT,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
    return proc.returncode, out, err, time.perf_counter() - t0


def cli(algo: str) -> int:
    """The launcher's entry point under torchrun, one shard a card."""
    from repro_torch.core import walks_per_node_for
    from repro_torch.core.distributed_counts import PACKED_VID_MAX
    from repro_torch.launch.pagerank import main as launch
    n = N if algo != "counts" else min(
        N, PACKED_VID_MAX * int(os.environ["WORLD_SIZE"]))
    args = ["--algo", algo, "--n", str(n), "--graph", "erdos_renyi",
            "--avg-deg", "8"]
    if algo == "ppr":
        # 2^21 walks a query; n is above the dense exact_ppr's limit
        launch(args + ["--walks", str(PPR_WALKS // n), "--queries",
                       str(PPR_QUERIES)])
    else:
        launch(args + ["--walks", str(walks_per_node_for(n, EPS)),
                       "--check"])
    return 0


def main() -> int:
    import torch
    if sys.argv[1:] == ["--worker"]:
        return worker()
    if sys.argv[1:2] == ["--cli"]:
        return cli(sys.argv[2])
    cards = torch.cuda.device_count()
    if cards < 2:
        print(f"multi_card: {cards} CUDA cards; this needs two or more",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import common
    common.build_all()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    print(smi.strip(), flush=True)
    rc = 0
    for algo in ("counts", "walks", "improved", "ppr"):
        code, out, err, secs = torchrun(cards, [
            str(Path(__file__).resolve()), "--cli", algo])
        print(out[-3000:], err[-3000:], flush=True)
        print(json.dumps(dict(cli=algo, cards=cards, seconds=secs,
                              rc=code)), flush=True)
        rc = rc or code
    code, out, err, secs = torchrun(cards, [str(Path(__file__).resolve()),
                                            "--worker"])
    print(out[-12000:], err[-3000:], flush=True)
    print(json.dumps(dict(worker=cards, seconds=secs, rc=code)), flush=True)
    return rc or code


if __name__ == "__main__":
    sys.exit(main())
