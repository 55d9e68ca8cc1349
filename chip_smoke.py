#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one CUDA card.

    python3 chip_smoke.py

1. Builds the three CUDA kernels from the checkout's sources into
   `build/kernels/` and prints what the compiler reports.
2. Kernel phase: at the shapes the main path gives them, on the card, each
   kernel against its plain torch version (histogram exact,
   multinomial_rows exact or a mismatch rate under 0.5% with conservation
   exact, segment_spmv both against a float64 sum: the kernel's relative
   error at most twice the plain version's + 1e-6, since both sum with
   atomics in different orders), with times of the kernel, the plain
   version and a one-call PyTorch yardstick, beside the least time the card
   could take (bytes over the HBM rate, or operations over the FP32 rate).
3. Main path on doc_link_graph(2**20): power_iteration, then
   simple_pagerank with the walk engine and with the count engine (traced),
   each with the launch counters set to 0 just before and read just after.
   Each run must agree with power iteration (L1 < 0.15, top-10 >= 0.6) and
   launch its kernels; the count engine's residual must be 0.
4. A small input checked against the CPU: the walk engine bit-exact, power
   iteration within 1e-6 L1, the count engine against the exact PageRank.

Prints the card's name and power limit, a `{"kernels": [...]}` line, and as
its last line `{"ok": true, "device": {...}}`. Exits non-zero, printing no
result, when there is no CUDA card or any phase fails.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

EPS = 0.2
N = 1 << 20
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
FP32_OPS_PER_S = 67e12         # H100 SXM data sheet, outside tensor cores
MN_OPS_PER_DRAW = 30           # lower bound: counter hash + Binomial setup


class PhaseError(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def log(*args) -> None:
    print(*args, flush=True)


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean device time of `fn` over `iters` calls, by CUDA events."""
    import torch
    for _ in range(warmup):
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


def bound(nbytes: float, ops: float = 0.0) -> dict:
    """The least time the card could take: the larger of the bytes over the
    HBM rate and the operations over the FP32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bound_bytes=int(nbytes), bound_ops=int(ops))


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def kernel_phase(g, K):
    """Each kernel against its plain version at the main path's shapes."""
    import numpy as np
    import torch
    from repro_torch import prng
    from repro_torch.core import aggregate_sampler as agg
    from repro_torch.core import engine_walks
    from repro_torch.core.graph import padded_adjacency_np
    from repro_torch.kernels.histogram import histogram
    from repro_torch.kernels.histogram.ref import histogram_ref
    from repro_torch.kernels.multinomial_rows import multinomial_rows
    from repro_torch.kernels.multinomial_rows._math import key_words
    from repro_torch.kernels.multinomial_rows.ref import multinomial_rows_ref
    from repro_torch.kernels.segment_spmv import segment_spmv
    from repro_torch.kernels.segment_spmv.ref import segment_spmv_ref

    rows = {}
    n, dev = g.n, g.device

    # histogram: the arrivals of the walk engine's first round
    state = engine_walks.init_state(g, K, prng.PRNGKey(0))
    _, survive, dst, _ = engine_walks.advance(g.row_ptr, g.col_idx,
                                              g.out_deg, EPS, state)
    ids = torch.where(survive, dst, -1)
    del state, survive, dst
    W = ids.numel()
    got, want = histogram(ids, n), histogram_ref(ids, n)
    err = int((got - want).abs().max())
    check(err == 0, f"histogram differs from its plain version by {err}")
    hub_share = float(want[0]) / float(want.sum())
    shifted = ids + 1
    rows["histogram"] = dict(
        ms=cuda_ms(lambda: histogram(ids, n), 10),
        plain_ms=cuda_ms(lambda: histogram_ref(ids, n), 3),
        library_ms=cuda_ms(lambda: torch.bincount(shifted, minlength=n + 1),
                           3),
        max_abs_err=err, shape=f"W={W} ids, n={n}",
        **bound(4 * W + 4 * n))
    log(f"histogram: PASS, W={W} n={n} exact (max diff {err}); vertex 0 "
        f"takes {hub_share:.4f} of the arrivals; {rows['histogram']}")
    del shifted, got, want

    # the threefry draws of that round, for the walk engine's breakdown
    k = prng.PRNGKey(1)
    threefry_ms = cuda_ms(lambda: prng.uniform(k, (W,), device=dev), 3)
    log(f"threefry uniform of {W} float32: {threefry_ms:.3f} ms")
    del ids

    # segment_spmv: the power-iteration push from the uniform start vector
    src = g.edge_src()
    deg_e = torch.clamp(g.out_deg, min=1).float().index_select(0, src)
    x0 = torch.full((n,), 1.0 / n, dtype=torch.float32, device=dev)
    contrib = x0.index_select(0, src) / deg_e
    E = contrib.numel()
    exact = torch.zeros(n, dtype=torch.float64, device=dev).index_add_(
        0, g.col_idx, contrib.double())
    y_k = segment_spmv(contrib, g.col_idx, n)
    y_p = segment_spmv_ref(contrib, g.col_idx, n)
    pos = exact > 0

    def rel(y):
        return float(((y.double() - exact).abs()[pos] / exact[pos]).max())

    rel_k, rel_p = rel(y_k), rel(y_p)
    # the one-call yardstick sums in float32, whose rounding piles up at hubs
    rel_lib = rel(torch.zeros(n, device=dev).index_add_(0, g.col_idx,
                                                        contrib))
    check(bool(torch.isfinite(y_k).all()), "segment_spmv: non-finite output")
    check(rel_k <= 2 * rel_p + 1e-6,
          f"segment_spmv: relative error {rel_k} > 2 * {rel_p} + 1e-6")
    rows["segment_spmv"] = dict(
        ms=cuda_ms(lambda: segment_spmv(contrib, g.col_idx, n), 20),
        plain_ms=cuda_ms(lambda: segment_spmv_ref(contrib, g.col_idx, n), 5),
        library_ms=cuda_ms(lambda: torch.zeros(n, device=dev).index_add_(
            0, g.col_idx, contrib), 5),
        max_abs_err=float((y_k - y_p).abs().max()),
        shape=f"E={E} edges, n={n}", **bound(8 * E + 4 * n))
    log(f"segment_spmv: PASS, E={E} n={n} max rel err vs a float64 sum: "
        f"kernel {rel_k:.3e}, plain {rel_p:.3e}, float32 index_add_ "
        f"{rel_lib:.3e}; {rows['segment_spmv']}")
    del src, deg_e, x0, contrib, exact, y_k, y_p, pos

    # multinomial_rows: every bucket of the count engine's first round
    row_ptr, col, deg = g.numpy()
    nbr, _ = padded_adjacency_np(row_ptr, col, deg, g.max_out_deg)
    layout, perm = agg.build_layout(deg, nbr.shape[1])
    perm = torch.from_numpy(np.ascontiguousarray(perm)).to(dev)
    counts = torch.full((n,), K, dtype=torch.int32, device=dev)
    rid = torch.arange(n, dtype=torch.int32, device=dev)
    kw = key_words(prng.split(prng.PRNGKey(0))[1])
    buckets = [(c_b, d_b, r_b, w) for _, c_b, d_b, r_b, w in
               agg.bucket_rows(counts, g.out_deg, rid, perm, layout)]
    mism = total = draws = nbytes = max_err = 0
    for c_b, d_b, r_b, w in buckets:
        T_k = multinomial_rows(c_b, d_b, r_b, kw, eps=EPS, width=w)
        T_p = multinomial_rows_ref(c_b, d_b, r_b, kw, eps=EPS, width=w)
        check(bool((T_k.sum(1) == c_b).all()),
              f"multinomial_rows: width {w} leaks mass")
        mism += int((T_k != T_p).any(1).sum())
        max_err = max(max_err, int((T_k - T_p).abs().max()))
        total += c_b.numel()
        # draws the data needs: the termination, then each slot j < deg
        # that still has a count left before it
        rem = c_b[:, None] - T_k[:, 0:1] - torch.cumsum(T_k[:, 1:], 1) \
            + T_k[:, 1:]
        slot = torch.arange(w, device=dev)[None, :]
        draws += int(((c_b > 0) & (d_b > 0)).sum()) \
            + int(((rem > 0) & (slot < d_b[:, None])).sum())
        nbytes += 12 * c_b.numel() + 4 * (w + 1) * c_b.numel()
    rate = mism / max(total, 1)
    check(rate <= 0.005, f"multinomial_rows: {rate:.4%} of rows differ")

    def all_buckets(fn):
        return lambda: [fn(c, d, r, kw, eps=EPS, width=w)
                        for c, d, r, w in buckets]

    rows["multinomial_rows"] = dict(
        ms=cuda_ms(all_buckets(multinomial_rows), 10),
        plain_ms=cuda_ms(all_buckets(multinomial_rows_ref), 2),
        library_ms=None, max_abs_err=max_err,
        shape=f"{len(buckets)} buckets, widths {list(layout.widths)}, "
              f"{total} rows, {draws} draws",
        **bound(nbytes, MN_OPS_PER_DRAW * draws))
    log(f"multinomial_rows: PASS, mismatch {mism}/{total} rows ({rate:.4%}, "
        f"gate 0.5%), conservation exact; {rows['multinomial_rows']}")
    return rows, threefry_ms


def main_path(g, K):
    """power_iteration and both engines, through the public entry points."""
    import torch
    from repro_torch.core import (l1_error, normalized, power_iteration,
                                  simple_pagerank, topk_overlap)
    from repro_torch.kernels import common

    launches, out = {name: 0 for name in common.launches}, {}

    def drive(label, fn, must_launch):
        common.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = dict(common.launches)
        for name, c in counts.items():
            launches[name] += c
        check(counts[must_launch] > 0,
              f"{label}: the {must_launch} kernel was never launched")
        log(f"{label}: {secs:.3f} s, launches {counts}")
        return result, secs

    tol, max_iters = 1e-7, 1000
    (pi_ref, delta, iters), secs = drive(
        "power_iteration", lambda: power_iteration(g, EPS, tol=tol,
                                                   max_iters=max_iters),
        "segment_spmv")
    check(bool(torch.isfinite(pi_ref).all()) and pi_ref.shape == (g.n,),
          "power_iteration: bad output")
    log(f"power_iteration: tol {tol}, {iters} iterations, final L1 delta "
        f"{delta:.3e}, stopped at max_iters: {iters >= max_iters}")
    out["power_iteration"] = dict(seconds=secs, iterations=iters)

    for engine, traced, kernel in (("walks", False, "histogram"),
                                   ("counts", True, "multinomial_rows")):
        res, secs = drive(
            f"simple_pagerank[{engine}]",
            lambda: simple_pagerank(g, EPS, engine=engine, traced=traced),
            kernel)
        zmax = int(res.zeta.max())
        l1 = l1_error(normalized(res.pi), pi_ref)
        top = topk_overlap(res.pi, pi_ref.cpu().numpy())
        check(res.pi.shape == (g.n,) and bool((res.pi >= 0).all())
              and math.isfinite(float(res.pi.sum())),
              f"{engine}: bad estimate")
        check(zmax < 2 ** 31, f"{engine}: zeta overflows int32")
        check(l1 < 0.15, f"{engine}: L1 {l1} vs power iteration")
        check(top >= 0.6, f"{engine}: top-10 overlap {top}")
        info = dict(seconds=secs, rounds=res.logical_rounds, K=K,
                    walks=K * g.n, l1=l1, top10=top, zeta_max=zmax,
                    zeta_sum=int(res.zeta.sum(dtype=torch.int64)))
        if engine == "counts":
            # run_traced raises on any round whose residual is not 0
            info.update(residual=0,
                        congest_rounds=res.report.congest_rounds)
        log(f"simple_pagerank[{engine}]: {info}")
        out[engine] = info
    return launches, out


def small_check():
    """A small graph on the card against the same run on the CPU."""
    import torch
    from repro_torch import prng
    from repro_torch.core import (exact_pagerank, l1_error, normalized,
                                  power_iteration, simple_pagerank)
    from repro_torch.graphs import erdos_renyi

    g_cpu = erdos_renyi(96, 5.0, seed=1, device="cpu")
    g = g_cpu.to("cuda")
    key = prng.PRNGKey(7)
    a = simple_pagerank(g, EPS, walks_per_node=8, key=key)
    b = simple_pagerank(g_cpu, EPS, walks_per_node=8, key=key, device="cpu")
    check(torch.equal(a.zeta.cpu(), b.zeta) and
          a.logical_rounds == b.logical_rounds,
          "small walks run: card and CPU differ")
    pa, _, _ = power_iteration(g, EPS)
    pb, _, _ = power_iteration(g_cpu, EPS, device="cpu")
    l1_pi = l1_error(pa, pb)
    check(l1_pi < 1e-6, f"small power iteration: card vs CPU L1 {l1_pi}")
    exact = exact_pagerank(g_cpu, EPS)
    c = simple_pagerank(g, EPS, walks_per_node=400, key=key, engine="counts",
                        traced=True)
    l1_c = l1_error(normalized(c.pi), exact)
    check(l1_c < 0.15, f"small counts run: L1 {l1_c} vs exact PageRank")
    log(f"small check (erdos_renyi(96)): walks zeta card == CPU, power "
        f"iteration L1 {l1_pi:.2e}, counts L1 vs exact {l1_c:.4f}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch is missing beside the script",
              file=sys.stderr)
        return 2
    from repro_torch.core import walks_per_node_for
    from repro_torch.graphs import doc_link_graph
    from repro_torch.kernels import common

    t0 = time.perf_counter()
    logs = common.build_all()
    build_s = time.perf_counter() - t0
    log(f"build: {build_s:.2f} s into {common.BUILD_DIR}")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"  {name}: {line.strip()}")

    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log(f"device: {kind} (torch {torch.__version__}, CUDA "
        f"{torch.version.cuda})")
    log(smi)

    t0 = time.perf_counter()
    g = doc_link_graph(N, seed=0)
    graph_s = time.perf_counter() - t0
    K = walks_per_node_for(g.n, EPS)
    log(f"graph: doc_link_graph({N}) n={g.n} m={g.m} max_out_deg="
        f"{g.max_out_deg} in {graph_s:.2f} s; K={K}, {K * g.n} walks")

    try:
        rows, threefry_ms = kernel_phase(g, K)
        torch.cuda.empty_cache()
        launches, runs = main_path(g, K)
        small_check()
    except PhaseError as e:
        log(f"FAILED: {e}")
        return 1

    walks = runs["walks"]
    share = 2 * walks["rounds"] * threefry_ms / 1e3 / walks["seconds"]
    log(f"phases: build {build_s:.2f} s, graph {graph_s:.2f} s, power "
        f"iteration {runs['power_iteration']['seconds']:.3f} s, walks "
        f"{walks['seconds']:.3f} s (threefry ~{share:.1%}: 2 draws x "
        f"{walks['rounds']} rounds x {threefry_ms:.3f} ms), counts "
        f"{runs['counts']['seconds']:.3f} s; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")

    replaces = {
        "histogram": "src/repro/kernels/histogram/histogram.py:67",
        "segment_spmv": "src/repro/kernels/segment_spmv/segment_spmv.py:66",
        "multinomial_rows":
            "src/repro/kernels/multinomial_rows/multinomial_rows.py:47",
    }
    kernels = []
    for name, row in rows.items():
        kernels.append(dict(
            name=name, route="cuda",
            source=str(common.SOURCES[name].relative_to(ROOT)),
            replaces=replaces[name], launches=launches[name],
            max_abs_err=row["max_abs_err"], ms=row["ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"]))
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
