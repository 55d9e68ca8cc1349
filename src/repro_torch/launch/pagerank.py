"""Sharded PageRank launcher: the sharded engines under checkpoint/restart.

    PYTHONPATH=src python -m repro_torch.launch.pagerank --n 512 --eps 0.2 \\
        --walks 64 --graph erdos_renyi --algo counts --shards 4

Runs on the CUDA card unless `--device cpu` is given. `--shards N` holds N
vertex shards on that one device as a stacked mesh (`core/collectives.py`):
every lane, route, merge and all_to_all runs as it would across N devices.

Under `torchrun` (WORLD_SIZE set) each process holds one shard, on its own
card over NCCL, or on the CPU over gloo with `--device cpu`:

    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.pagerank \
        --algo counts --n 512 --device cpu

`--shards`, if given, must equal the world size, and rank 0 prints the
report. Every `--algo` runs so, and `--audit` audits the engines on the
group's mesh: rank 0 writes AUDIT.json, and every process exits
non-zero on a violation or a failed `--check`.

Engine selection (`--algo`):
  walks     Algorithm 1, walk-routing engine (default), under the
            checkpoint `Supervisor`.
  counts    Algorithm 1, count-aggregated engine (Lemma-1 wire: per-vertex
            coupon counts, payload independent of the walk count).
  improved  Algorithm 2 (IMPROVED-PAGERANK), the three-phase engine:
            sqrt(log n)-step short walks from degree-proportional coupon
            pools, count-aggregated stitching, one counting exchange.
  directed  Section 5 (directed/LOCAL): the same three phases with
            uniform coupon pools, sqrt(log n / eps)-step short walks and
            dangling-node resets. Pair it with `--graph directed_web`.
  ppr       batched Personalized PageRank (`core.personalized_batch`):
            `--queries` seed-drawn queries of 1-3 sources each, each with
            `--walks` * n walks, advance together, every superstep moving
            all queries' walks over one `route_counts` exchange (the query
            id folded into a virtual vertex id). Prints rounds,
            a2a_bytes, dropped and admit_dropped (both must be 0) and the
            peak of live walks; each query is checked against its own
            `exact_ppr` (a dense solve: `--check` is refused above n =
            4096).

`--audit` runs the CONGEST auditor instead of an engine
(`analysis/congest.py`): every sharded engine runs on a fixture graph
under a recording mesh of `--shards` shards (8 by default; under
`torchrun`, the world size), each call of
each program its `audit_spec` declares is checked against the declared
per-round lane budget of its all_to_all sites, the RNG / dtype /
elastic-schema lints run over the same run, the runtime telemetry is
cross-checked against the declared widths, and AUDIT.json is written next
to the table. Non-zero exit on any violation. Per-engine wire budgets
(P = shards, n_loc = ceil(n/P), md = max degree, Q = PPR query slots;
every entry is a Lemma-1 (vertex, count) cell except the walk-class
lanes, which the declaration pins at n_loc so the checked capacity stays
W-free):

  engine    site         B/entry  per-shard-per-round lane budget
  walks     route          4      P * n_loc walk slots       [walk-class]
  counts    counts         4      P * min(cut_max, n_loc) cells
  improved  phase1_req     8      P * n_loc cells
            phase1_rep    12      P * n_loc * (md+1) (vertex,class,count)
            phase2         8      P * n_loc cells
            phase3         8      P * n_loc cells
            tail           4      P * n_loc walk slots       [walk-class]
  directed  same five sites as improved (uniform-budget coupon pools)
  ppr       ppr            8      P * n_loc * Q (vertex, query) lanes

No budget depends on the walk multiplicity W: the auditor rebuilds every
spec at 2x walks and fails if any budget moves. The RNG lint also
certifies which stages resume bit-exactly after an elastic restore:
`counts` (replicated round key, counter-based RNG) and the three-phase
engines' phase2/phase3 programs (RNG-free) are bit-exact; walks, phase1,
tail and ppr consume per-shard key streams that are re-derived on a
resized mesh, so their resume is statistical (tolerance-gated).

Telemetry of `improved` and `directed`: rounds by phase (phase1 <= lam,
report always 0, phase2 the stitches, phase3 always 1, tail the naive
fallback), coupons created and used, exhausted and tail walks, wire
bytes by phase, `dropped` (must be 0) and `waited`, the Phase-1 sampler's
time, bucket occupancy and residual (must be 0).

Fault tolerance: `--checkpoint-dir` enables periodic snapshots,
`--fail-at R [R ...]` injects simulated failures at the listed rounds, and
recovery from the latest snapshot is bit-exact: the recovered run prints
the same pi and telemetry as an unfailed one, plus restarts > 0.
`--resume` cold-starts from the latest snapshot in `--checkpoint-dir`,
which this package or the JAX package may have written; with `--shards N`
different from the snapshot's, the snapshot is re-laid out onto N shards
(bit-exact for `counts` and for the three-phase engines' Phases 2 and 3,
a fresh key stream for `walks`, Phase 1 and the tail).

Every run but `ppr` is checked against power iteration (L1 and top-10
overlap); `--check` turns the report into a gate (non-zero exit on a
miss).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import shutil
import tempfile

import numpy as np

from repro_torch import prng
from repro_torch.checkpoint import Checkpointer, relayout_pagerank_state
from repro_torch.core import (l1_error, normalized, power_iteration,
                              topk_overlap)
from repro_torch.core.collectives import (ProcessGroupMesh, StackedMesh,
                                          start_group)
from repro_torch.core.distributed import (init_state, shard_graph,
                                          state_from_host, state_to_host,
                                          superstep)
from repro_torch.core.distributed_counts import distributed_pagerank_counts
from repro_torch.core.distributed_directed import \
    distributed_directed_pagerank
from repro_torch.core.distributed_improved import \
    distributed_improved_pagerank
from repro_torch.core.personalized import exact_ppr
from repro_torch.core.personalized_batch import \
    batched_personalized_pagerank
from repro_torch.device import resolve_device
from repro_torch.graphs import GENERATORS
from repro_torch.runtime import FailureSchedule, Supervisor

# `exact_ppr` solves a dense n x n system: the largest n `--check` takes
PPR_CHECK_MAX_N = 4096


@dataclasses.dataclass
class RunResult:
    pi: np.ndarray      # float64 [n] PageRank estimate
    rounds: int
    restarts: int       # supervisor recoveries from injected failures
    shards: int
    l1: float           # against power iteration
    topk: float         # top-10 overlap with power iteration


def _say(mesh):
    """`print` on the mesh's writer, nothing on the other processes."""
    return print if mesh is None or mesh.writer else (lambda *a, **k: None)


def _report_accuracy(pi, g, eps: float, check: bool = False,
                     l1_tol: float = 0.15, topk_min: float = 0.6,
                     mesh=None):
    pi = np.asarray(pi, dtype=np.float64)
    pi_ref, _, _ = power_iteration(g, eps, device=g.device)
    pi_ref = pi_ref.cpu().numpy()
    l1 = l1_error(pi / pi.sum(), pi_ref)
    topk = topk_overlap(pi, pi_ref)
    _say(mesh)(f"[pagerank] L1 vs power-iter: {l1:.4f}  "
               f"top-10 overlap: {topk:.2f}")
    if check and (l1 >= l1_tol or topk < topk_min):
        raise SystemExit(
            f"[pagerank] accuracy check FAILED: L1 {l1:.4f} "
            f"(tol {l1_tol}) top-10 {topk:.2f} (min {topk_min})")
    return l1, topk


def run_walks(g, eps: float, walks_per_node: int, checkpoint_dir, fail_at,
              seed: int, resume: bool = False, mesh=None,
              max_restarts: int = 16):
    mesh = mesh or StackedMesh(1, g.device)
    shards = mesh.shards
    sg = shard_graph(g, shards, mesh=mesh)
    W = g.n * walks_per_node
    cap = 2 * W // shards + shards * 64
    route_cap = W // shards + 64
    state = init_state(sg, walks_per_node, prng.PRNGKey(seed), cap,
                       mesh.device, mesh=mesh)

    def step_fn(s):
        s2, active, _, _ = superstep(sg, s, mesh=mesh, eps=eps,
                                     route_cap=route_cap)
        return s2, active == 0

    # without a directory the snapshots go to a private temporary one,
    # made by the mesh's writer and removed by it once the run is over
    ckpt_dir = checkpoint_dir or mesh.gather_objects(
        tempfile.mkdtemp(prefix="pr_ckpt_") if mesh.writer else None)[0]
    sup = Supervisor(step_fn, lambda s: state_to_host(s, mesh),
                     lambda f: state_from_host(f, mesh),
                     Checkpointer(ckpt_dir, mesh=mesh), checkpoint_every=10,
                     max_restarts=max_restarts,
                     failure_schedule=FailureSchedule(fail_at) if fail_at
                     else None,
                     meta_fn=lambda: dict(shards=shards),
                     relayout=lambda f, old: relayout_pagerank_state(
                         f, g.n, shards, cap=cap))
    try:
        res = sup.run(state, resume=resume)
    finally:
        if checkpoint_dir is None and mesh.writer:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
    zeta = mesh.gather_rows(res.state.zeta).reshape(-1)[: g.n].cpu().numpy()
    pi = zeta.astype(np.float64) * eps / (g.n * walks_per_node)
    _say(mesh)(f"[pagerank] algo=walks n={g.n} shards={shards} "
               f"rounds={res.rounds} restarts={res.restarts} "
               f"dropped={res.state.dropped}")
    return pi, res


def run_ppr(g, eps: float, walks_per_query: int, num_queries: int,
            seed: int, check: bool = False, l1_tol: float = 0.15,
            topk_min: float = 0.6, mesh=None):
    """Batched PPR: seed-drawn multi-source queries, one shared engine.

    Each query is checked against its own `exact_ppr` (PPR has no single
    power-iteration reference), on the mesh's writer; the verdict reaches
    every process, so `--check` fails on all of them or on none. Returns
    the [num_queries, n] estimator matrix, the same on every process."""
    mesh = mesh or StackedMesh(1, g.device)
    say = _say(mesh)
    if check and g.n > PPR_CHECK_MAX_N:
        raise SystemExit(
            f"[pagerank] --check with --algo ppr solves a dense n x n "
            f"system per query (exact_ppr): n = {g.n} is above "
            f"{PPR_CHECK_MAX_N}; run without --check or on a smaller graph")
    rng = np.random.default_rng(seed)
    queries = []
    for _ in range(num_queries):
        k = int(rng.integers(1, 4))
        sources = rng.choice(g.n, size=k, replace=False)
        queries.append((sources, None))
    res = batched_personalized_pagerank(
        g, eps, queries, walks_per_query, prng.PRNGKey(seed), mesh=mesh)
    peak = max(res.active_trace) if res.active_trace else 0
    say(f"[pagerank] algo=ppr n={g.n} shards={res.shards} "
        f"queries={num_queries} walks/query={walks_per_query} "
        f"rounds={res.rounds} a2a_bytes={res.a2a_bytes} "
        f"dropped={res.dropped} admit_dropped={res.admit_dropped} "
        f"peak_active={peak}")
    if g.n > PPR_CHECK_MAX_N:
        say(f"[pagerank] no exact_ppr report above n = {PPR_CHECK_MAX_N} "
            f"(a dense n x n solve per query)")
        return res.ppr
    failed = None
    if mesh.writer:
        worst_l1, worst_topk = 0.0, 1.0
        for i, (sources, weights) in enumerate(queries):
            ref = exact_ppr(g, eps, sources, weights=weights)
            est = res.ppr[i]
            l1 = l1_error(normalized(est), normalized(ref))
            topk = topk_overlap(est, ref)
            say(f"[pagerank]   query {i} sources="
                f"{list(map(int, sources))} L1 vs exact_ppr: {l1:.4f}  "
                f"top-10 overlap: {topk:.2f}")
            worst_l1, worst_topk = max(worst_l1, l1), min(worst_topk, topk)
        if check and (worst_l1 >= l1_tol or worst_topk < topk_min
                      or res.dropped or res.admit_dropped):
            failed = (f"[pagerank] ppr check FAILED: worst L1 "
                      f"{worst_l1:.4f} (tol {l1_tol}) worst top-10 "
                      f"{worst_topk:.2f} (min {topk_min}) dropped="
                      f"{res.dropped} admit_dropped={res.admit_dropped}")
    failed = mesh.broadcast_object(failed)
    if failed:
        raise SystemExit(failed)
    return res.ppr


@contextlib.contextmanager
def _mesh(shards: int | None, device, default_shards: int = 1):
    """The mesh a command runs on: `shards` (or `default_shards`) stacked
    shards on `device` (the card when None), or under `torchrun`
    (WORLD_SIZE set) one shard per process: the started default process
    group's mesh, or a group started here (NCCL on `cuda:<LOCAL_RANK>`,
    gloo when `device` is the CPU) and destroyed at the end. `shards`, if
    given, must then equal the world size."""
    if shards is not None and shards < 1:
        raise SystemExit(f"[pagerank] --shards {shards} out of range")
    if "WORLD_SIZE" not in os.environ:
        yield StackedMesh(shards or default_shards, resolve_device(device))
        return
    import torch.distributed as dist
    started = not dist.is_initialized()
    mesh = (start_group(device) if started else
            ProcessGroupMesh(device=None if device is None
                             else resolve_device(device)))
    try:
        if shards is not None and shards != mesh.shards:
            raise SystemExit(f"[pagerank] --shards {shards} differs from "
                             f"the world size {mesh.shards}")
        yield mesh
    finally:
        if started:
            dist.destroy_process_group()


def run(n: int, eps: float, walks_per_node: int, graph_kind: str,
        checkpoint_dir: str | None, fail_at: list[int], seed: int = 0,
        algo: str = "walks", avg_deg: float = 6.0, resume: bool = False,
        check: bool = False, num_queries: int = 4, shards: int | None = None,
        max_restarts: int = 16, device=None):
    """Build the graph, run `algo` on `shards` stacked shards on `device`
    (the card when None) and report its accuracy. `--algo ppr` returns the
    [num_queries, n] PPR estimator matrix instead of a `RunResult`.

    Under `torchrun` (WORLD_SIZE set) each process holds one shard: the
    mesh is the started default process group's, or a group started here
    (NCCL on `cuda:<LOCAL_RANK>`, gloo when `device` is the CPU) and
    destroyed at the end."""
    if resume and not checkpoint_dir:
        raise SystemExit("[pagerank] --resume needs --checkpoint-dir "
                         "(there is no snapshot to cold-start from)")
    with _mesh(shards, device) as mesh:
        return _run(mesh, n, eps, walks_per_node, graph_kind,
                    checkpoint_dir, fail_at, seed, algo, avg_deg, resume,
                    check, num_queries, max_restarts)


def _run(mesh, n, eps, walks_per_node, graph_kind, checkpoint_dir, fail_at,
         seed, algo, avg_deg, resume, check, num_queries, max_restarts):
    g = GENERATORS[graph_kind](n, avg_deg, seed, device=mesh.device) \
        if graph_kind != "ring" else GENERATORS[graph_kind](
            n, device=mesh.device)
    if algo == "ppr":
        return run_ppr(g, eps, walks_per_node * g.n, num_queries, seed,
                       check=check, mesh=mesh)
    say = _say(mesh)
    if algo == "walks":
        pi, res = run_walks(g, eps, walks_per_node, checkpoint_dir, fail_at,
                            seed, resume=resume, mesh=mesh,
                            max_restarts=max_restarts)
    elif algo == "counts":
        res = distributed_pagerank_counts(
            g, eps, walks_per_node, prng.PRNGKey(seed), mesh=mesh,
            checkpoint_dir=checkpoint_dir, fail_at=fail_at, resume=resume,
            max_restarts=max_restarts)
        say(f"[pagerank] algo=counts n={g.n} shards={res.shards} "
            f"rounds={res.rounds} restarts={res.restarts} "
            f"lane_cap={res.lane_cap} "
            f"a2a_bytes={res.a2a_bytes_total} overflow={res.overflow}")
        say(f"[pagerank] sampler: {res.sampler_us:.0f} us total "
            f"({res.sampler_us / max(res.rounds, 1):.0f} us/round) "
            f"bucket_occupancy={list(res.occupancy)} "
            f"residual={res.residual}")
        pi = res.pi
    elif algo in ("improved", "directed"):
        engine = (distributed_improved_pagerank if algo == "improved"
                  else distributed_directed_pagerank)
        res = engine(g, eps, walks_per_node, prng.PRNGKey(seed), mesh=mesh,
                     checkpoint_dir=checkpoint_dir, fail_at=fail_at,
                     resume=resume, max_restarts=max_restarts)
        say(f"[pagerank] algo={algo} n={g.n} shards={res.shards} "
            f"lam={res.lam} eta={res.eta} ell={res.ell} "
            f"rounds={res.rounds} restarts={res.restarts} "
            f"(p1={res.phase1_rounds} "
            f"report={res.report_rounds} p2={res.phase2_rounds} "
            f"p3={res.phase3_rounds} tail={res.tail_rounds})")
        say(f"[pagerank] coupons created={res.coupons_created} "
            f"used={res.coupons_used} exhausted_walks="
            f"{res.exhausted_walks} tail_walks={res.tail_walks}")
        say(f"[pagerank] wire by phase: {res.a2a_bytes_by_phase} "
            f"dropped={res.dropped} waited={res.waited}")
        say(f"[pagerank] p1 sampler: {res.sampler_us:.0f} us total "
            f"({res.sampler_us / max(res.phase1_rounds, 1):.0f} us/round)"
            f" bucket_occupancy={list(res.p1_occupancy)} "
            f"residual={res.residual}")
        if algo == "directed":
            say(f"[pagerank] uniform budget={res.uniform_budget} "
                f"coupons/node dangling_nodes={res.dangling_nodes}")
        pi = res.pi
    else:
        raise ValueError(f"unknown algo {algo!r}")
    l1, topk = _report_accuracy(pi, g, eps, check=check, mesh=mesh)
    return RunResult(pi=pi, rounds=res.rounds, restarts=res.restarts,
                     shards=mesh.shards, l1=l1, topk=topk)


def audit(eps: float, shards: int | None = None, device=None,
          engines=None, *, out: str = "AUDIT.json",
          run_telemetry: bool = True, walks_per_node: int = 2,
          strict: bool = True) -> dict:
    """The CONGEST audit of every engine (or of `engines`) on `shards`
    stacked shards (8 when None) on `device` (the card when None), or
    under `torchrun` on the group's mesh: prints the wire table and a
    `VIOLATION` line for each violation, and writes the report to `out`
    (rank 0). With `strict` it exits non-zero on any violation (every
    process: the merged report is the same on each). Returns the
    report."""
    from repro_torch.analysis.congest import (audit_all_engines,
                                              format_wire_table)
    with _mesh(shards, device, default_shards=8) as mesh:
        report = audit_all_engines(mesh, eps=eps, engines=engines,
                                   run_telemetry=run_telemetry,
                                   walks_per_node=walks_per_node)
        if mesh.writer:
            print(format_wire_table(report))
            for e in report["engines"].values():
                for v in e["violations"]:
                    print(f"VIOLATION [{v['engine']}] {v['kind']} at "
                          f"{v['where']}: {v['message']}")
            with open(out, "w") as f:
                json.dump(report, f, indent=2, sort_keys=True)
            print(f"[pagerank] wrote {out}")
    if strict and not report["ok"]:
        raise SystemExit("[pagerank] CONGEST audit FAILED")
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--eps", type=float, default=0.2)
    ap.add_argument("--walks", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0,
                    help="graph-generator and PRNG seed")
    ap.add_argument("--avg-deg", type=float, default=6.0,
                    help="generator degree parameter (ignored by ring)")
    ap.add_argument("--graph", default="erdos_renyi",
                    choices=sorted(GENERATORS))
    ap.add_argument("--algo", default="walks",
                    choices=["walks", "counts", "improved", "directed",
                             "ppr"])
    ap.add_argument("--queries", type=int, default=4,
                    help="(--algo ppr) seed-drawn multi-source queries "
                         "batched into one engine; each gets --walks * n "
                         "walks")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--fail-at", type=int, nargs="*", default=[])
    ap.add_argument("--resume", action="store_true",
                    help="cold-start from the latest snapshot in "
                         "--checkpoint-dir instead of round 0; with "
                         "--shards N unlike the snapshot's, it is re-laid "
                         "out onto N shards")
    ap.add_argument("--shards", type=int, default=None,
                    help="vertex shards of the stacked mesh on the one "
                         "device (default 1)")
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: the CUDA card)")
    ap.add_argument("--max-restarts", type=int, default=16,
                    help="supervisor restart budget before an injected "
                         "failure is re-raised (0 = die on the first one, "
                         "leaving the snapshots for a resume)")
    ap.add_argument("--check", action="store_true",
                    help="non-zero exit if the accuracy report misses "
                         "L1 < 0.15 / top-10 >= 0.6 (--algo ppr: each "
                         "query against exact_ppr, n <= 4096)")
    ap.add_argument("--audit", action="store_true",
                    help="run the CONGEST wire-budget + lint auditor over "
                         "every engine instead of a PageRank run: prints "
                         "the per-engine wire table, writes AUDIT.json, "
                         "exits non-zero on any violation (see the module "
                         "docstring for the budget table); --shards sets "
                         "the mesh (default 8; under torchrun the world "
                         "size)")
    args = ap.parse_args(argv)
    if args.audit:
        audit(args.eps, shards=args.shards, device=args.device)
        return
    run(args.n, args.eps, args.walks, args.graph, args.checkpoint_dir,
        args.fail_at, seed=args.seed, algo=args.algo, avg_deg=args.avg_deg,
        resume=args.resume, check=args.check, num_queries=args.queries,
        shards=args.shards,
        max_restarts=args.max_restarts, device=args.device)


if __name__ == "__main__":
    main()
