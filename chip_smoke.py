#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one CUDA card.

    python3 chip_smoke.py

1. Builds the five CUDA kernels from the checkout's sources into
   `build/kernels/` and prints what the compiler reports (registers,
   spills).
2. Kernel phase: at the shapes the main path gives them, on the card, each
   kernel against its plain torch version (histogram exact, on the walk
   engine's first-round arrivals and on as many ids spread uniformly, each
   timed, with its sample and hot-list passes timed alone;
   multinomial_rows exact, with conservation exact, at the count engines'
   first round: the per-bucket entry on every bucket, and the fused entry
   the engines launch, on the single-device layout and the stacked P=4
   one, each timed against the per-bucket round it replaces;
   segment_spmv on the power-iteration push against a float64 sum, the
   kernel's relative error at most twice the plain version's + 1e-6, since
   both sum with atomics in different orders, and exact on the count
   engines' first-round sums, single-device and sharded; walk_step exact
   from given uniforms (a) and from key words (b), at the first round of
   the sharded walk engine at P=2; uniform bit-equal to its plain version
   at the walk engine's 1.46e8 draws on the card, and at 2^20 draws to the
   plain version on the CPU), with times of the kernel, the plain version
   and a one-call PyTorch yardstick where there is one, beside the least
   time the card could take (bytes over the HBM rate, or operations over
   the FP32 rate).
3. Single-device path on doc_link_graph(2**20): power_iteration, then
   simple_pagerank with the walk engine and with the count engine (traced).
   Each run must agree with power iteration (L1 < 0.15, top-10 >= 0.6) and
   launch its kernels; the count engine's residual must be 0.
4. Sharded path on the same graph, P shards stacked on the card: the count
   engine at P=4 with unpacked lanes (zeta bit-identical to step 3's count
   engine, overflow and residual 0) and the walk engine at P=2 (nothing
   dropped, walks alive never increasing, L1 and top-10 as above). A
   profiled extra run of the count engine (its device time split into the
   fused sampler, segment_spmv and the rest) and two profiled rounds of
   the walk engine print where the device time goes and its idle share.
   The kernel phase also times segment_spmv on the count engine's
   received-lane sum (its first round's lanes at P=4).
4b. One shard per process (`process_group_path`, run right after step 4),
   under build/process_group/ (removed at the end): (a) an NCCL group of world size 1 in this
   process, from a FileStore: the count engine (unpacked) and the walk
   engine at step 4's K on `ProcessGroupMesh`, each bit-equal to
   `StackedMesh(1)` (zeta, rounds, wire counters) and launching its
   kernels, the group destroyed at the end; the all_to_all of each
   engine's round lanes timed against the stacked block transpose, and
   the collectives (recorded) and host syncs (torch's sync debug mode) a
   round counted. (b) Four child processes of this script on the one card
   (`--process-group-child`), a gloo group whose collectives take the
   card's tensors (the library stages them through the host): the count
   engine at P=4 bit-equal to step 4's stacked run, killed at P=4 at
   round 40 and resumed at P=2 bit-equal, and the walk engine at P=2 on
   doc_link_graph(2^16) (cut: gloo stages the 36 MB a round of route
   lanes through the host, 583 MB at 2^20) bit-equal to `StackedMesh(2)`;
   each child reports its kernel launches, and a child that fails or
   outlives its join timeout fails the script. The three-phase engines
   the same way: in (a) Algorithm 2 on erdos_renyi(2^20, 8) at K = 139
   and Section 5 on doc_link_graph(2^14), each bit-equal to
   `StackedMesh(1)` (zeta, rounds by phase, coupons, walks, wire by
   site, Phase-2 records, occupancy, residual) and held to step 5's
   guards, with each phase's collectives and host syncs a round counted;
   in (b) Algorithm 2 on erdos_renyi(2^16, 8) and Section 5 on
   doc_link_graph(2^12) at P=4 (cut: the tail's walk lanes through the
   host), and Algorithm 2 on erdos_renyi(2^15, 8) at eta_safety 8 (step
   4a's) killed at P=4 mid-Phase 2 and resumed at P=2, each bit-equal
   to `StackedMesh(4)`. Personalized PageRank the same way: in (a) the
   batched engine at step 6's width (16 queries x 2^21 walks on
   doc_link_graph(2^20)) at P = 1, bit-equal to `StackedMesh(1)` (every
   vector, supersteps, live-walk trace, entries, bytes) and held to the
   personalized power iteration, with the collectives and host syncs of
   an admission, a superstep and a vector's read counted; in (b) at P=4
   on doc_link_graph(2^16) with 2^18 walks a query (cut: gloo stages a
   superstep's 2^20 virtual lanes through the host), the batched engine,
   the service (32 distinct queries and 8 repeats, shrunk to 2 processes
   at tick 10 and grown back to 4 at tick 30; rank 0's answers and every
   process's host state after each tick equal to the stacked service's)
   and the auditor's `ppr` row, each equal to `StackedMesh(4)`.
4a. The elastic runtime (`elastic_path`), snapshots under build/elastic/
   (removed at the end): the count engine killed at P=8 at round 40 and
   resumed from pristine copies at P = 1, 2, 4 and 16 (zeta bit-identical
   to step 3's count engine, rounds equal); the launcher's walk engine
   (`run_walks`) killed at P=2 at round 11 and resumed at P=4 (from
   round 10's snapshot), and killed at round 5 and resumed at P=1 (from
   round 0's: every walk alive), the re-layout keeping every vertex's
   live walks, the sum of zeta and the counters, nothing dropped, L1 and
   top-10 as above; Algorithm 2 on erdos_renyi(2^15, 8) at eta_safety 8
   (an empty tail), killed at P=4 mid-Phase 2 and resumed at P = 2 and 8
   (zeta and pi bit-identical to its unfailed run); Section 5 on
   doc_link_graph(2^12) killed at P=4 in keyed Phase 1 and resumed at
   P=2 (the three-phase guards); and small kills at P=8 resumed at P=3
   on the card against the CPU (counts, improved, directed, walks). Each
   run prints its snapshot bytes, the seconds of each save, restore +
   re-layout + placement seconds, and the time to recover (the resume
   call to the end of its first round).
5. Algorithm 2 and Section 5: the three-phase engine at P=4 on
   erdos_renyi(2^20, 8), eps 0.2, K = 139 (S = 6.6e8 coupons), beside the
   sharded count engine on the same graph; a second run of it splits its
   wall time by phase and captures each phase's first histogram and
   segment sum, each then timed at that shape and held exact against its
   plain version; the fused sampler's dense-cell mode at that run's first
   Phase-1 round (4 x 4 x 2^18 rows, md 28), exact against its plain
   version and scatter_cells(sample_buckets()); the single-device engine
   on erdos_renyi(2^19, 8) (cut from 2^20: its [lam, S] tables and
   threefry temporaries) beside the count engine; both Section-5 engines
   on doc_link_graph(2^14) (uniform pools: 13,720 coupons a node); and an
   eta=1 probe on erdos_renyi(2^16, 8) whose walks finish in the tail,
   launching walk_step. Each against power iteration (L1 < 0.15, top-10
   >= 0.6) and the conservation guards (residual and dropped 0, every
   walk terminated by a coupon or in the tail, coupons used at most once,
   total visits within 7% of n*K/eps, phase 1 within lam rounds, phase 3
   one exchange).
6. Personalized PageRank on doc_link_graph(2^20) (no dangling vertex,
   asserted), eps 0.2: the batched engine at P=4 with 16 queries drawn as
   the CLI's run_ppr draws them, 2^21 walks each (2^25 in flight), its
   first superstep's kernels (walk_step (b) on one shard's buffer, the
   histogram of 2^27 virtual ids into 2^26 segments, the received-lane
   segment_spmv) timed at their shapes and exact against their plain
   versions, one superstep profiled; the single-query engine on query 0;
   and the PPR service (16 slots, P=4) answering 64 requests (48 distinct,
   16 repeats) on an injected clock, resized to P=2 after 20 completions.
   Checks: dropped == admit_dropped == 0, live walks never increasing,
   each query's visits within 2% of W/eps, L1 < 0.15 and top-10 >= 0.6
   against a personalized power iteration through segment_spmv (to an L1
   change under 1e-7), cached answers equal to their stored vectors, no
   request rejected, every request completed, some after the resize.
7. The launch CLI's `run()` on a small graph: walks at 2 shards and counts
   at 4 (packed lanes), each with the accuracy gate, and each again with an
   injected failure that must recover to the identical pi.
8. Small inputs checked against the CPU: the single-device walk engine
   bit-exact, power iteration within 1e-6 L1, the count engine against the
   exact PageRank, the sharded engines at P=8 bit-exact (walks, counts
   packed and unpacked, improved, directed), and both PPR engines
   bit-exact (batched at P=8).

9. LM serving (`lm_serve_path`), weights drawn on the card from a seed:
   (a) Qwen2-7B at full width (28 layers, 7.72 B parameters, bf16):
   decode against the full forward at B=2, T=256 (relative error < 0.05,
   tests/test_serve.py's bound), then `ContinuousBatcher(slots=8,
   max_seq=1024)` serving 32 requests (prompts of 32-512 tokens, budgets
   8-64, two of 1) with exact accounting, prefill tokens/s, decode ms a
   step at 8 active slots against the weight-read bound, one decode step
   profiled, and 4 requests replayed alone at batch 1: where a token
   parts from the batched one, the batch-1 top-2 margin must be below
   the decode-vs-full error; (b) H2O-Danube3-4B at full width: decode
   against the full forward on a prompt past its 4,096 window, and 6
   requests of 4,200-6,000 prompt tokens on 4 slots (max_seq 8192: the
   ring rolls); (c) DeepSeek-V2 and DBRX at full width cut to 2 layers:
   decode against the full forward at B=2, T=256 with capacity E/k (no
   drop), and the drops at the configs' capacity factor 1.25; (e)
   Mamba2-1.3B at full width and depth (48 layers, 1,343,740,928
   parameters): decode against the full forward at B=2, T=300 (not a
   multiple of the 128 chunk), (a)'s 32 requests on 8 slots, decode ms a
   step against the bound of its weights plus twice the slots' state
   (read and written), 4 requests replayed at batch 1, one decode step
   profiled; (f) RecurrentGemma-9B at full width and depth (38 layers,
   10,444,984,320 parameters): decode against the full forward on a
   prompt past its 2,048 local window, 6 requests of 2,100-3,000 prompt
   tokens on 4 slots (max_seq 4096: the ring rolls), decode ms a step
   against the weight-read bound, the time of the 52 float32 gate casts
   a step makes, 2 requests replayed, one step profiled; (g)
   Whisper-tiny at full width and depth (4 + 4 layers, 1,500 frames):
   decode against the full forward with frames drawn from a seed, 32
   requests (prompts of 4-64 tokens, budgets 8-64) on 8 slots with
   max_seq 448, 4 replayed, one step profiled; (d) the ten reduced
   configs on the card against the CPU, same weights; (h) serving on a
   process mesh (`lm_serve_process`, under build/lm_serve_process/,
   removed at the end): Qwen2-7B at full width cut to 4 layers, prefill
   of 4 x 256 tokens and 8 decode steps under an NCCL group of world size
   1 in this process, the model keeping its blocks, logits and cache
   bit-equal (digests of their bits) to the whole-weight model's; then
   four child processes of this script on the one card
   (`--lm-serve-child`), a gloo group with card tensors at (data 2,
   model 2): reduced Qwen2-7B, H2O-Danube3 (its ring of 16 wrapping from
   model rank 1's slots to rank 0's), DeepSeek-V2 and InternVL2 from the
   seeded init, each rank keeping its blocks of the weights and of the
   cache (its rows, its block of the sequence), prefill of 4 x 14
   positions and 4 decode steps fed tokens from a seed: each rank's
   logits within 0.03 of the single-process model's on the card, the
   cache gathered back (`layout.whole_blocks`) within 0.03 of its
   largest value, its idx and filled slots equal, and each rank's dry-run
   trace of the decode step (`launch.dryrun.trace_rank`) noting the
   collectives its first gloo step moved.
10. LM training (`lm_train_path`): (a) Qwen2-7B at full width cut to 8
   layers (2.98 B parameters: 16 B of training state a parameter for 28
   layers would not fit 80 GB), trained on 4 x 1,024 tokens that
   `PageRankWeightedSampler` draws in proportion to step 3's walk-engine
   vector of doc_link_graph(2^20): 2 microbatches, remat full, AdamW with
   fp32 moments at lr 3e-4, a warm-up step and 4 timed steps on that
   batch (every loss and grad norm finite, the last loss below the
   first, peak under 72 GiB, no MoE drop), `apply_updates` timed alone,
   model FLOPs a step against the data sheet's 989 TFLOP/s dense bf16;
   then 2 steps with int8 moments from the same seeded weights, and the
   peak of one microbatch's gradients under each remat policy; (b) one
   train step of each reduced config on the card against the CPU (loss
   within 1e-2, masters within 2.2 lr, 0.05 lr on average); (c) the
   reduced DeepSeek-V2's loss and gradients under the three remat
   policies against "none" (within 1e-2 of each leaf's largest); (d) the
   step over one process a shard (`launch.mesh.make_process_mesh`,
   ZeRO-1 AdamW state, under build/lm_process/, removed at the end):
   (a)'s Qwen2-7B x8, 2 steps of `run_training` on 4 x 1,024 tokens,
   under an NCCL group of world size 1 in this process, its parameters
   and state bit-equal (digests of their bits) to the same steps under
   the local mesh; then four child processes of this script on the one
   card (`--lm-group-child`), a gloo group with card tensors at (data 2,
   model 2): reduced DBRX, Qwen2-7B, DeepSeek-V2 (MLA), InternVL2 (the
   VLM), Mamba2-1.3B, RecurrentGemma-9B and Whisper-tiny, each rank
   keeping its blocks (at most half the whole's bytes), 2 steps each,
   every process's losses equal, its state 1/4 of the whole (plus at most a
   block a leaf), rank 0's parameters within 4e-3 of the single-process
   step on the card, losses within 2e-3, and each leaf's update (its
   gathered masters less their init) within 0.25 of the single
   process's in norm (the key biases of Qwen2 and InternVL2 excepted:
   their gradient is mostly rounding noise).
11. The dry run and the sharded MoE (`dryrun_path`): (a) the cells of
   `launch.dryrun` in DRYRUN_SMOKE_CELLS (24 of the 40; the CLI traces
   all) traced at full width on fake card tensors, each `ok` or skipped
   with the JAX package's reason, with FLOPs, argument and peak bytes,
   the H100 roofline and whether the peak fits 80 GB, and all 40 cells'
   per-device argument bytes on the 16x16 and 2x16x16 meshes; (b) step
   10 (a)'s Qwen2-7B x8 step dry-run against the card: argument bytes
   within 1% of the rise of `memory_allocated()` across model, state
   and batch init, peak within 20% of `max_memory_allocated()` of a
   step, FlopCounterMode's total equal to the same counter around the
   real step; (c) one DBRX-132B MoE layer at full width, B=2, T=64,
   capacity E/k: the sharded path on the 1x1 mesh equal to the gather
   path bit for bit (deterministic algorithms), on a stacked 2x2 mesh
   within 2e-2 of the largest |out|, 0 drops, both timed.

Steps 3 to 6 (4a and 4b included) are the main path: every engine is driven
with the launch counters set to 0 just before it and read just after.
The LM runs of steps 9 and 10 and step 11's parts are driven the same
way; they launch none of the five kernels.
Prints the card's name and power limit, a `{"kernels": [...]}` line, and
as its last line `{"ok": true, "device": {...}}`. Exits non-zero,
printing no result, when there is no CUDA card or any phase fails.
"""
from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import time
from contextlib import contextmanager
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

EPS = 0.2
N = 1 << 20
# the single-device Algorithm 2 holds [lam, S] trajectory, edge and move
# tables and threefry temporaries over its S coupons: at n = 2^20 (S =
# 6.6e8) some 50 GB, so it runs at half the width
N_SINGLE_IMPROVED = 1 << 19
# Section 5 gives every node eta * ceil(ln n) coupons: 13,720 a node at
# n = 2^14 (S = 2.25e8); at 2^20 no card holds its pools
N_DIRECTED = 1 << 14
N_PROBE = 1 << 16              # the eta=1 probe, most walks in the tail
PPR_QUERIES = 16               # the batched PPR engine's query slots
PPR_WALKS = 1 << 21            # walks a PPR query
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
FP32_OPS_PER_S = 67e12         # H100 SXM data sheet, outside tensor cores
MN_OPS_PER_DRAW = 30           # lower bound: counter hash + Binomial setup
# 32-bit integer operations of one threefry-2x32 uniform as the kernel
# writes it: 20 rounds of (add, two shifts, or, xor), 6 key injections of
# two adds, and the float conversion (shift, or, subtract)
THREEFRY_OPS_PER_DRAW = 20 * 5 + 6 * 2 + 3
SHARDED_WALK_BUDGET_S = 90.0   # lower K for the sharded walk engine past it
# histogram at this shape before the hot-list design (PERF.md kernel table)
HISTOGRAM_BEFORE_MS = 16.042
# the kernels of a segment_spmv call (the float entry rounds in a second)
SPMV_KERNELS = ("segment_sum_kernel", "round_to_float")


class PhaseError(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def log(*args) -> None:
    print(*args, flush=True)


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean time of a call of `fn` over `iters` calls, between CUDA events:
    the card's time, or the host's where it launches short kernels slower
    than the card runs them."""
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


def _dev_us(e) -> float:
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0))


def device_ms(fn, iters: int, *parts) -> float:
    """Device time of `fn`'s kernels whose names hold one of `parts`, a
    call, from torch.profiler over `iters` calls after a warm-up. Where a
    call's kernels are short, the CUDA events of `cuda_ms` time the host
    launching them; this is the time they hold the card. A session that
    records no device time (a whole session's kernels have been seen to go
    missing from CUPTI's records) is repeated, up to three in all."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(_dev_us(e) for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA
                 and any(p in e.key for p in parts))
        if us > 0:
            break
        log(f"device_ms: profiler session {attempt + 1} recorded no "
            f"device time for {parts}")
    check(us > 0, f"the profiler recorded no device time for {parts}")
    return us / 1e3 / iters


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
    import torch
    from repro_torch import prng
    from repro_torch.core import engine_walks
    from repro_torch.kernels.histogram import histogram
    from repro_torch.kernels.histogram import ops as histogram_ops
    from repro_torch.kernels.histogram.ref import histogram_ref
    from repro_torch.kernels.segment_spmv import hot_list as segment_hot_list
    from repro_torch.kernels.segment_spmv import segment_spmv
    from repro_torch.kernels.segment_spmv.ref import segment_spmv_ref

    rows = {}
    n, dev = g.n, g.device

    # histogram: the arrivals of the walk engine's first round, and the same
    # number of valid ids spread uniformly (no hub) in the same slots
    state = engine_walks.init_state(g, K, prng.PRNGKey(0))
    _, survive, dst, _ = engine_walks.advance(g.row_ptr, g.col_idx,
                                              g.out_deg, EPS, state)
    ids = torch.where(survive, dst, -1)
    gen = torch.Generator(device=dev).manual_seed(0)
    uniform = torch.where(survive, torch.randint(
        0, n, ids.shape, generator=gen, device=dev, dtype=torch.int32), -1)
    del state, survive, dst
    W = ids.numel()
    hot = {}
    for name, x in (("real", ids), ("uniform", uniform)):
        got, want = histogram(x, n), histogram_ref(x, n)
        err = int((got - want).abs().max())
        check(err == 0, f"histogram ({name} ids) differs from its plain "
                        f"version by {err}")
        table, count = histogram_ops.hot_list(x, n)
        hot[name] = dict(
            err=err, ms=cuda_ms(lambda: histogram(x, n), 20),
            hot_list_ms=cuda_ms(lambda: histogram_ops.hot_list(x, n), 20),
            hot_ids=int(count), hub_share=float(want.max()) / float(
                want.sum()),
            hot_share=float(want[table[table > 0].long() - 1].sum())
            / float(want.sum()))
        del got, want, table
    shifted = ids + 1
    rows["histogram"] = dict(
        ms=hot["real"]["ms"],
        plain_ms=cuda_ms(lambda: histogram_ref(ids, n), 3),
        library_ms=cuda_ms(lambda: torch.bincount(shifted, minlength=n + 1),
                           3),
        max_abs_err=hot["real"]["err"], shape=f"W={W} ids, n={n}",
        uniform_ms=hot["uniform"]["ms"], **bound(4 * W + 4 * n))
    log(f"histogram: PASS, W={W} n={n} exact on real and uniform ids; "
        f"{rows['histogram']}")
    for name, h in hot.items():
        log(f"histogram, {name} ids: {h['ms']:.4f} ms a call (before the "
            f"redesign: {HISTOGRAM_BEFORE_MS} ms on real ids, PERF.md); "
            f"sample + hot-list passes alone {h['hot_list_ms']:.4f} ms; "
            f"{h['hot_ids']} hot ids (thresholds "
            f"{histogram_ops.hot_thresholds(W)} of "
            f"{histogram_ops.sample_size(W)} sampled) taking "
            f"{h['hot_share']:.4f} of the counts; the largest count is "
            f"{h['hub_share']:.4f} of them")
    del shifted, uniform

    # the threefry draws of that round (the uniform kernel), for the walk
    # engine's breakdown
    k = prng.PRNGKey(1)
    threefry_ms = cuda_ms(lambda: prng.uniform(k, (W,), device=dev), 3)
    log(f"prng.uniform of {W} float32 (the uniform kernel, a call): "
        f"{threefry_ms:.3f} ms")
    del ids

    # segment_spmv: the power-iteration push from the uniform start vector
    src = g.edge_src()
    deg_e = torch.clamp(g.out_deg, min=1).float().index_select(0, src)
    x0 = torch.full((n,), 1.0 / n, dtype=torch.float32, device=dev)
    contrib = x0.index_select(0, src) / deg_e
    E = contrib.numel()
    exact = torch.zeros(n, dtype=torch.float64, device=dev).index_add_(
        0, g.col_idx, contrib.double())
    hot = segment_hot_list(g.col_idx, n)
    y_k = segment_spmv(contrib, g.col_idx, n, hot=hot)
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
        ms=device_ms(lambda: segment_spmv(contrib, g.col_idx, n, hot=hot), 20,
                     *SPMV_KERNELS),
        call_ms=cuda_ms(lambda: segment_spmv(contrib, g.col_idx, n, hot=hot),
                        20),
        plain_ms=cuda_ms(lambda: segment_spmv_ref(contrib, g.col_idx, n), 5),
        library_ms=cuda_ms(lambda: torch.zeros(n, device=dev).index_add_(
            0, g.col_idx, contrib), 5),
        max_abs_err=float((y_k - y_p).abs().max()),
        shape=f"E={E} edges, n={n}", **bound(8 * E + 4 * n),
        ms_hot_list_in_call=cuda_ms(
            lambda: segment_spmv(contrib, g.col_idx, n), 20),
        hot_list_ms=cuda_ms(lambda: segment_hot_list(g.col_idx, n), 20),
        hot_ids=int((hot > 0).sum()))
    log(f"segment_spmv: PASS, E={E} n={n} max rel err vs a float64 sum: "
        f"kernel {rel_k:.3e}, plain {rel_p:.3e}, float32 index_add_ "
        f"{rel_lib:.3e}; {rows['segment_spmv']}")
    del src, deg_e, x0, contrib, exact, y_k, y_p, pos, hot

    return rows, threefry_ms


def sampler_phase(g, K, rows):
    """multinomial_rows at the count engines' first round: the per-bucket
    entry (the TPU kernel's counterpart) on every bucket, exact, then the
    fused entry the engines launch, exact against its plain version and
    the per-bucket round on the single-device layout and the stacked P=4
    one, each timed against the per-bucket round. Then segment_spmv's
    integer entry on the sums of those first rounds, each exact and timed
    against int32 index_add_. Fills rows["multinomial_rows"] and adds the
    count sums to rows["segment_spmv"]."""
    import numpy as np
    import torch
    from repro_torch import prng
    from repro_torch.core import aggregate_sampler as agg
    from repro_torch.core.collectives import StackedMesh
    from repro_torch.core.distributed_counts import (shard_graph_padded,
                                                     sum_plan)
    from repro_torch.core.graph import padded_adjacency_np
    from repro_torch.kernels.multinomial_rows import (multinomial_buckets,
                                                      multinomial_rows)
    from repro_torch.kernels.multinomial_rows._math import key_words
    from repro_torch.kernels.multinomial_rows.ref import (
        multinomial_buckets_ref, multinomial_rows_ref)
    from repro_torch.kernels.segment_spmv import hot_list, segment_sum_int
    from repro_torch.kernels.segment_spmv.ref import segment_sum_int_ref

    n, dev = g.n, g.device
    row_ptr, col, deg = g.numpy()
    nbr, _ = padded_adjacency_np(row_ptr, col, deg, g.max_out_deg)
    layout, perm_np = agg.build_layout(deg, nbr.shape[1])
    perm = torch.from_numpy(np.ascontiguousarray(perm_np)).to(dev)
    counts = torch.full((n,), K, dtype=torch.int32, device=dev)
    rid = torch.arange(n, dtype=torch.int32, device=dev)
    kw = key_words(prng.split(prng.PRNGKey(0))[1])

    # the per-bucket entry on every bucket: exact, as PR 11 and PR 13
    # measured it on this card (0 of 1,048,576 rows differing)
    buckets = [(c_b, d_b, r_b, w) for _, c_b, d_b, r_b, w in
               agg.bucket_rows(counts, g.out_deg, rid, perm, layout)]
    mism = total = draws = max_err = 0
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
    check(mism == 0, f"multinomial_rows: {mism} of {total} rows differ from "
                     f"its plain version")
    def per_bucket():
        return [multinomial_rows(c, d, r, kw, eps=EPS, width=w)
                for c, d, r, w in buckets]

    per_bucket_ms = cuda_ms(per_bucket, 10)
    per_bucket_dev = device_ms(per_bucket, 10, "multinomial_rows_kernel")
    log(f"multinomial_rows, per-bucket entry: PASS, 0 of {total} rows "
        f"differ, conservation exact; the {len(buckets)} calls of a round "
        f"{per_bucket_ms:.4f} ms ({per_bucket_dev:.4f} ms of it on the "
        f"card)")
    del buckets

    # the fused entry on both layouts of the count engines
    sg = shard_graph_padded(g, 4)
    layouts = {
        "single-device": (counts, g.out_deg, rid, perm, layout, 1),
        "stacked P=4": (counts.reshape(-1), sg.deg.reshape(-1),
                        torch.arange(4 * sg.n_loc, dtype=torch.int32,
                                     device=dev),
                        sg.stacked_perm, sg.stacked_layout, 4)}
    fused, first = {}, {}
    for label, (c, d, r, pm, lay, P) in layouts.items():
        def kernel():
            return multinomial_buckets(c, d, r, kw, pm, lay.widths, lay.caps,
                                       eps=EPS, shards=P)

        def plain():
            return multinomial_buckets_ref(c, d, r, kw, pm, lay.widths,
                                           lay.caps, eps=EPS, shards=P)

        def six_calls():
            samples, occ, res = agg.sample_buckets(c, d, r, kw, pm, lay,
                                                   eps=EPS)
            return agg.flatten_moves(samples, P if P > 1 else None), occ, res

        got, want, old = kernel(), plain(), six_calls()
        diff = int((got[0] != want[0]).sum())
        check(diff == 0 and torch.equal(got[0], old[0].reshape(-1)),
              f"multinomial_buckets ({label}): {diff} moves differ from its "
              f"plain version, or it differs from the per-bucket round")
        check(torch.equal(got[1], want[1]) and torch.equal(got[1], old[1])
              and int(got[2]) == int(want[2]) == int(old[2]) == 0,
              f"multinomial_buckets ({label}): occupancy or residual differ "
              f"(residual {int(got[2])})")
        first[label] = got[0]
        fused[label] = dict(
            ms=device_ms(kernel, 20, "multinomial_buckets_kernel"),
            call_ms=cuda_ms(kernel, 20),
            six_call_round_ms=cuda_ms(six_calls, 10),
            six_call_round_device_ms=device_ms(six_calls, 10, ""),
            plain_ms=cuda_ms(plain, 2),
            shape=f"{pm.numel()} slots, {c.numel()} rows, "
                  f"{lay.total_edges} moves, {len(lay.caps)} buckets",
            **bound(4 * pm.numel() + 12 * c.numel() + 4 * lay.total_edges,
                    MN_OPS_PER_DRAW * draws))
        log(f"multinomial_buckets ({label}): PASS, exact (0 moves differ, "
            f"occupancy equal, residual 0) against its plain version and "
            f"the per-bucket round; {fused[label]}")
    single = fused["single-device"]
    rows["multinomial_rows"] = dict(
        ms=single["ms"], plain_ms=single["plain_ms"], library_ms=None,
        max_abs_err=max_err, shape=single["shape"] + f", {draws} draws",
        per_bucket_calls_ms=per_bucket_ms,
        per_bucket_calls_device_ms=per_bucket_dev,
        stacked_p4=fused["stacked P=4"],
        **{k: single[k] for k in ("call_ms", "six_call_round_ms",
                                  "six_call_round_device_ms", "bound_ms",
                                  "bound_by", "bound_bytes", "bound_ops")})

    # segment_spmv's integer entry on the count engines' first-round sums
    bnbr = torch.from_numpy(agg.bucketize_adjacency(nbr, perm_np, layout)
                            ).to(dev)
    mesh = StackedMesh(4, dev)
    plan = sum_plan(sg, mesh)
    flat4 = first["stacked P=4"]
    recv_c, recv_ids = received_lanes(sg, plan, flat4, mesh)
    sums = {
        "single-device count sum": (first["single-device"], bnbr, n,
                                    hot_list(bnbr, n)),
        "sharded local sum (P=4)": (flat4, plan.local_ids.reshape(-1),
                                    4 * sg.n_loc, plan.local_hot),
        "sharded remote sum (P=4)": (flat4, plan.remote_ids.reshape(-1),
                                     4 * sg.n_pad, plan.remote_hot),
        # the engine builds this sum's hot list in every call
        "sharded received-lane sum (P=4)": (recv_c, recv_ids, 4 * sg.n_loc,
                                            None)}
    extra = {}
    for label, (vals, ids, segs, hot) in sums.items():
        got = segment_sum_int(vals, ids, segs, hot=hot)
        err = int((got - segment_sum_int_ref(vals, ids, segs)).abs().max())
        check(err == 0, f"segment_spmv ({label}): differs from its plain "
                        f"version by {err}")
        E = vals.numel()
        # index_add_ takes no id outside the output: dropped ids to a spare
        lib_ids = torch.where(ids >= 0, ids, segs)
        extra[label] = dict(
            ms=device_ms(lambda: segment_sum_int(vals, ids, segs, hot=hot),
                         20, *SPMV_KERNELS),
            call_ms=cuda_ms(
                lambda: segment_sum_int(vals, ids, segs, hot=hot), 20),
            ms_hot_list_in_call=cuda_ms(
                lambda: segment_sum_int(vals, ids, segs), 20),
            plain_ms=cuda_ms(lambda: segment_sum_int_ref(vals, ids, segs), 5),
            library_ms=cuda_ms(lambda: torch.zeros(
                segs + 1, dtype=torch.int32, device=dev).index_add_(
                    0, lib_ids, vals), 5),
            max_abs_err=err,
            live_share=float(((vals != 0) & (ids >= 0)).sum()) / E,
            hot_ids=int((hot > 0).sum()) if hot is not None else 0,
            shape=f"E={E}, n={segs}", **bound(8 * E + 4 * segs))
        log(f"segment_spmv ({label}): PASS, exact; {extra[label]}")
    rows["segment_spmv"]["count_sums"] = extra


def received_lanes(sg, plan, flat_T, mesh):
    """The (count, offset id) lanes each shard of the sharded count engine
    receives in the round whose per-edge counts are `flat_T`, with
    unpacked lanes, as `distributed_counts._exchange_step` builds them:
    the inputs of its received-lane sum."""
    import torch
    from repro_torch.core.routing import _offset_ids, lane_slots, pack_lanes
    from repro_torch.kernels.segment_spmv import segment_sum_int

    P, n_loc = mesh.shards, sg.n_loc
    per_vertex = segment_sum_int(flat_T.reshape(-1), plan.remote_ids.reshape(
        -1), P * sg.n_pad, hot=plan.remote_hot).reshape(P, sg.n_pad)
    vid = torch.arange(sg.n_pad, dtype=torch.int32,
                       device=flat_T.device).expand(P, -1)
    owner = torch.div(vid, n_loc, rounding_mode="floor")
    ok, idx = lane_slots(owner, per_vertex > 0, P, sg.lane_cap)
    recv_v = mesh.all_to_all(pack_lanes(idx, vid, ok, P, sg.lane_cap))
    recv_c = mesh.all_to_all(pack_lanes(idx, per_vertex, ok, P, sg.lane_cap,
                                        fill=0))
    sid = mesh.shard_ids().reshape(-1, 1)
    ids = _offset_ids(recv_v - sid * n_loc, recv_v >= 0, n_loc)
    return recv_c.reshape(-1), ids.reshape(-1)


def walk_step_phase(g, K):
    """walk_step at the first round of the sharded walk engine at P=2: each
    shard's buffer of cap = W + 128 slots, eligible = the walks it owns."""
    import torch
    from repro_torch import prng
    from repro_torch.core.collectives import StackedMesh
    from repro_torch.core.distributed import init_state, shard_graph
    from repro_torch.kernels.walk_step import walk_step, walk_step_keyed
    from repro_torch.kernels.walk_step.ref import (walk_step_keyed_ref,
                                                   walk_step_ref)

    shards, dev = 2, g.device
    mesh = StackedMesh(shards, dev)
    sg = shard_graph(g, shards)
    W = g.n * K
    cap = 2 * W // shards + shards * 64
    state = init_state(sg, K, prng.PRNGKey(0), cap, dev)
    # before the first step every walk sits on its own shard, so the route
    # and the merge leave the buffers as they are
    sid = mesh.shard_ids()[:, None]
    pos = state.pos
    eligible = (pos >= 0) & (torch.div(pos, sg.n_loc, rounding_mode="floor")
                             == sid)
    local = torch.where(eligible, pos - sid * sg.n_loc, 0).to(torch.int32)
    alive = eligible.to(torch.int32)
    keys = torch.stack([prng.split(k, 3) for k in state.key])
    del state, pos, eligible
    err, args = 0, None
    for p in range(shards):
        tables = (sg.row_ptr[p], sg.col_idx[p], sg.out_deg[p])
        kt, ke = keys[p, 1], keys[p, 2]
        u_term = prng.uniform(kt, (cap,), device=dev)
        u_edge = prng.uniform(ke, (cap,), device=dev)
        a = walk_step(local[p], alive[p], u_term, u_edge, *tables, eps=EPS)
        a_ref = walk_step_ref(local[p], alive[p], u_term, u_edge, *tables,
                              eps=EPS)
        b = walk_step_keyed(local[p], alive[p], kt, ke, *tables, eps=EPS)
        b_ref = walk_step_keyed_ref(local[p], alive[p], kt, ke, *tables,
                                    eps=EPS)
        for x, y in zip(a + b, a_ref + b_ref):
            err = max(err, int((x - y).abs().max()))
        if p == 0:
            deg = sg.out_deg[0].index_select(0, local[0].long())
            draws = int((alive[0].bool() & (deg > 0)).sum()) \
                + int(b_ref[1].sum())
            args = (local[0], alive[0], u_term, u_edge, kt, ke, tables,
                    int(alive[0].sum()))
        del a, a_ref, b, b_ref, u_term, u_edge
    check(err == 0, f"walk_step differs from its plain version by {err}")
    loc, alv, ut, ue, kt, ke, tables, n_elig = args
    table_bytes = sum(4 * t.numel() for t in tables)
    row = dict(
        ms=cuda_ms(lambda: walk_step_keyed(loc, alv, kt, ke, *tables,
                                           eps=EPS), 20),
        plain_ms=cuda_ms(lambda: walk_step_keyed_ref(loc, alv, kt, ke,
                                                     *tables, eps=EPS), 2),
        library_ms=None, max_abs_err=err,
        shape=f"cap={cap} slots, {n_elig} eligible, {draws} draws, "
              f"n_loc={sg.n_loc}",
        **bound(16 * cap + table_bytes, THREEFRY_OPS_PER_DRAW * draws))
    entry_a = dict(
        ms=cuda_ms(lambda: walk_step(loc, alv, ut, ue, *tables, eps=EPS), 20),
        plain_ms=cuda_ms(lambda: walk_step_ref(loc, alv, ut, ue, *tables,
                                               eps=EPS), 3),
        **bound(24 * cap + table_bytes))
    # the same integer work at the H100's INT32 throughput (64 lanes per SM
    # per clock, 132 SMs, 1.98 GHz boost), for comparison only
    int_ms = THREEFRY_OPS_PER_DRAW * draws / (64 * 132 * 1.98e9) * 1e3
    log(f"walk_step: PASS, both entry points exact on both shards (max "
        f"diff {err}); (b) keyed, the main path's: {row}; (a) from given "
        f"uniforms: {entry_a}; (b)'s operations at the INT32 throughput "
        f"would take {int_ms:.4f} ms")
    row["entry_a"] = entry_a
    return row


class Runner:
    """Drives entry points with the launch counters set to 0 just before
    and read just after, summing what each run launched."""

    def __init__(self):
        from repro_torch.kernels import common
        self.common = common
        self.launches = {name: 0 for name in common.launches}
        self.last = {}

    def __call__(self, label, fn, must_launch):
        import torch
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        self.common.reset_launches()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = dict(self.common.launches)
        self.last = counts
        for name, c in counts.items():
            self.launches[name] += c
        for name in must_launch:
            check(counts[name] > 0,
                  f"{label}: the {name} kernel was never launched")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"{label}: {secs:.3f} s, peak memory {peak:.2f} GiB, launches "
            f"{counts}")
        return result, secs, peak


def accuracy(label, pi, pi_ref, n, gate_topk=True):
    """L1 (after normalising) and top-10 overlap against power iteration;
    fails the phase past L1 0.15 or, with `gate_topk`, under top-10 0.6."""
    import numpy as np
    from repro_torch.core import l1_error, normalized, topk_overlap
    pi = np.asarray(pi, dtype=np.float64)
    check(pi.shape == (n,) and bool((pi >= 0).all())
          and math.isfinite(float(pi.sum())), f"{label}: bad estimate")
    l1 = l1_error(normalized(pi), pi_ref)
    top = topk_overlap(pi, pi_ref)
    check(l1 < 0.15, f"{label}: L1 {l1} vs power iteration")
    check(top >= 0.6 or not gate_topk, f"{label}: top-10 overlap {top}")
    return l1, top


def main_path(g, K, drive):
    """power_iteration and both single-device engines, through the public
    entry points. Returns (runs, power-iteration pi on the host, the count
    engine's zeta); runs["scores"] is the walk engine's vector."""
    import numpy as np
    import torch
    from repro_torch.core import power_iteration, simple_pagerank

    out = {}
    tol, max_iters = 1e-7, 1000
    (pi_ref, delta, iters), secs, _ = drive(
        "power_iteration", lambda: power_iteration(g, EPS, tol=tol,
                                                   max_iters=max_iters),
        ["segment_spmv"])
    check(bool(torch.isfinite(pi_ref).all()) and pi_ref.shape == (g.n,),
          "power_iteration: bad output")
    log(f"power_iteration: tol {tol}, {iters} iterations, final L1 delta "
        f"{delta:.3e}, stopped at max_iters: {iters >= max_iters}")
    out["power_iteration"] = dict(seconds=secs, iterations=iters)
    pi_ref = pi_ref.cpu().numpy()

    counts_zeta = None
    for engine, traced, kernels in (
            ("walks", False, ["histogram"]),
            ("counts", True, ["multinomial_rows", "segment_spmv"])):
        res, secs, peak = drive(
            f"simple_pagerank[{engine}]",
            lambda: simple_pagerank(g, EPS, engine=engine, traced=traced),
            kernels)
        zmax = int(res.zeta.max())
        check(zmax < 2 ** 31, f"{engine}: zeta overflows int32")
        l1, top = accuracy(engine, res.pi, pi_ref, g.n)
        info = dict(seconds=secs, rounds=res.logical_rounds, K=K,
                    walks=K * g.n, l1=l1, top10=top, zeta_max=zmax,
                    zeta_sum=int(res.zeta.sum(dtype=torch.int64)),
                    peak_gib=peak)
        if engine == "counts":
            # run_traced raises on any round whose residual is not 0
            info.update(residual=0,
                        congest_rounds=res.report.congest_rounds)
            counts_zeta = res.zeta
        log(f"simple_pagerank[{engine}]: {info}")
        out[engine] = info
        if engine == "walks":
            # Algorithm 1's vector: the LM training path's document scores
            out["scores"] = np.asarray(res.pi)
        del res
        torch.cuda.empty_cache()
    return out, pi_ref, counts_zeta


def profile_rounds(step, state, rounds, label, top=10, groups=None,
                   stats=None):
    """Run `rounds` steps under torch.profiler and print the device time of
    the kernels by name, the device's busy time (kernels, copies and sets)
    and its idle share of the wall time, and the device time of each of
    `groups` (label: a part of the kernel's name) and of the rest. Returns
    the last state; fills `stats` (a dict), when given, with a round's
    wall and busy ms, the idle share and the device ops."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(rounds):
            state = step(state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    # device-side events only: an aten op's device time repeats its kernels'
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and _dev_us(e) > 0]
    busy = sum(_dev_us(e) for e in kernels) / 1e3
    launched = sum(e.count for e in kernels)
    idle = max(0.0, 1 - busy / 1e3 / wall)
    log(f"{label}: wall {wall * 1e3 / rounds:.2f} ms a round, device busy "
        f"{busy / rounds:.2f} ms a round, idle share {idle:.3f}, "
        f"{launched / rounds:.0f} device ops a round")
    if stats is not None:
        stats.update(wall_ms=wall * 1e3 / rounds, busy_ms=busy / rounds,
                     idle_share=idle, device_ops=launched / rounds)
    ranked = sorted(kernels, key=_dev_us, reverse=True)
    # the top ones, then the kernels in an anonymous namespace at file
    # scope wherever they rank: the port's own, and a few of torch's
    for i, e in enumerate(ranked):
        if i < top or e.key.removeprefix("void ").startswith(
                "(anonymous namespace)::"):
            log(f"  {_dev_us(e) / 1e3 / rounds:9.3f} ms/round  "
                f"{e.count / rounds:6.1f}x  {e.key[:100]}")
    if not kernels:
        log(f"{label}: the profiler recorded no device time")
    if groups:
        split = {name: sum(_dev_us(e) for e in kernels if part in e.key) / 1e3
                 for name, part in groups.items()}
        split["the rest"] = busy - sum(split.values())
        log(f"{label}: device ms by kernel: "
            + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
            + f" (of {busy:.3f} busy)")
    return state


def sharded_path(g, K, drive, pi_ref, counts_zeta):
    """Both sharded engines at full width, their shards stacked on the
    card: counts at P=4 (unpacked lanes: n_loc = 262,144 is past the packed
    lanes' 16-bit ids), walks at P=2 (cap >= W, so nothing can drop)."""
    import torch
    from repro_torch import prng
    from repro_torch.core.collectives import StackedMesh
    from repro_torch.core.distributed import (distributed_pagerank,
                                              init_state, shard_graph,
                                              superstep)
    from repro_torch.core.distributed_counts import \
        distributed_pagerank_counts

    out = {}
    res, secs, peak = drive(
        "distributed_pagerank_counts[P=4]",
        lambda: distributed_pagerank_counts(
            g, EPS, K, prng.PRNGKey(0), mesh=StackedMesh(4, g.device),
            packed=False),
        ["multinomial_rows", "segment_spmv"])
    check(torch.equal(res.zeta, counts_zeta),
          "sharded counts: zeta differs from the single-device count engine")
    check(res.overflow == 0 and res.residual == 0,
          f"sharded counts: overflow {res.overflow}, residual "
          f"{res.residual}")
    l1, top = accuracy("sharded counts", res.pi, pi_ref, g.n)
    out["counts"] = dict(
        seconds=secs, rounds=res.rounds, shards=4, K=K,
        a2a_entries=res.a2a_entries_total, a2a_bytes=res.a2a_bytes_total,
        lane_cap=res.lane_cap, overflow=res.overflow, residual=res.residual,
        sampler_s=res.sampler_us / 1e6, occupancy=list(res.occupancy),
        l1=l1, top10=top, peak_gib=peak, zeta_equal_single_device=True)
    log(f"distributed_pagerank_counts[P=4]: {out['counts']}")
    del res
    profile_rounds(lambda _: distributed_pagerank_counts(
        g, EPS, K, prng.PRNGKey(0), mesh=StackedMesh(4, g.device),
        packed=False), None, 1, "sharded counts, a whole run (profiled)",
        groups={"fused sampler": "multinomial_buckets_kernel",
                "segment_spmv": "segment_sum_kernel"})
    torch.cuda.empty_cache()

    # one round at full K tells whether the whole walk engine fits its
    # budget; past it, K (never the graph) is lowered
    shards, mesh = 2, StackedMesh(2, g.device)
    sg = shard_graph(g, shards)
    W = g.n * K
    state = init_state(sg, K, prng.PRNGKey(0), 2 * W // shards + shards * 64,
                       g.device)
    route_cap = max(W // shards, 64)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, _, _, _ = superstep(sg, state, mesh=mesh, eps=EPS,
                               route_cap=route_cap)
    torch.cuda.synchronize()
    round_s = time.perf_counter() - t0
    # where a round's time goes: two more rounds under the profiler
    profile_rounds(lambda s: superstep(sg, s, mesh=mesh, eps=EPS,
                                       route_cap=route_cap)[0], state, 2,
                   "sharded walks, rounds 2-3")
    del state, sg
    torch.cuda.empty_cache()
    rounds_guess = 90
    K_walk = K
    if round_s * rounds_guess > SHARDED_WALK_BUDGET_S:
        K_walk = max(1, int(K * SHARDED_WALK_BUDGET_S
                            / (round_s * rounds_guess)))
    log(f"sharded walks: first round at K={K} took {round_s:.3f} s "
        f"(~{round_s * rounds_guess:.1f} s for {rounds_guess} rounds); "
        f"running K={K_walk}" + ("" if K_walk == K else
                                 f" (cut from {K} to fit "
                                 f"{SHARDED_WALK_BUDGET_S:.0f} s)"))

    res, secs, peak = drive(
        "distributed_pagerank[P=2]",
        lambda: distributed_pagerank(g, EPS, K_walk, prng.PRNGKey(0),
                                     mesh=mesh),
        ["walk_step", "histogram"])
    check(res.dropped == 0, f"sharded walks: {res.dropped} walks dropped")
    ra = res.round_active
    check(all(b <= a for a, b in zip(ra, ra[1:])) and ra[-1] == 0,
          "sharded walks: walks alive increased or did not reach 0")
    l1, top = accuracy("sharded walks", res.pi, pi_ref, g.n)
    out["walks"] = dict(
        seconds=secs, rounds=res.rounds, shards=shards, K=K_walk,
        K_cut_from=K if K_walk != K else None, first_round_s=round_s,
        a2a_entries=res.a2a_entries_total, a2a_bytes=res.a2a_bytes_total,
        dropped=res.dropped, waited=res.waited, l1=l1, top10=top,
        peak_gib=peak)
    log(f"distributed_pagerank[P=2]: {out['walks']}")
    del res
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# one shard per process: ProcessGroupMesh under NCCL and under gloo
# ---------------------------------------------------------------------------

PG_DIR = ROOT / "build" / "process_group"
PG_TIMEOUT_S = 120          # every collective of a group
PG_JOIN_S = 300             # a whole group of child processes
PG_RANKS = 4                # (b): processes sharing the one card
PG_KILL = dict(kill_at=40, every=10, resume_ranks=2)
N_PG_WALKS = 1 << 16        # (b)'s walk engine: gloo stages lanes on the host
# (b)'s Algorithm 2: at 2^20 the tail's walk lanes are 583 MB a process a
# round, staged through the host; Section 5 at doc_link_graph(2^12)
N_PG_IMPROVED = 1 << 16
N_PG_DIRECTED = 1 << 12
# what a three-phase run launches: the Phase-1 sampler and priorities, the
# counts of every phase; walk_step only when walks reach the tail
THREE_PHASE = ("histogram", "segment_spmv", "multinomial_rows", "uniform")
# (b)'s PPR: ppr_path's 16 query slots on doc_link_graph(2^16) with 2^18
# walks a query (gloo stages each superstep's 2^20 virtual lanes through
# the host); the service's resizes 4 -> 2 -> 4 fall on fixed ticks, which
# every process knows, in or out of the serving group
PG_PPR_WALKS = 1 << 18
PG_PPR_SERVICE = dict(distinct=32, repeats=8, repeat_tick=60, shrink_tick=10,
                      grow_tick=30)
# what a PPR superstep launches
PPR_KERNELS = ("walk_step", "histogram", "segment_spmv")
AUDIT_ROW = ("sites", "resume", "w_independent", "telemetry", "meta",
             "fixture", "violations", "psum_sites", "psum_max_bytes")


def zeta_digest(zeta) -> str:
    """sha256 of a visit vector's int32 bytes: bit-equality without
    shipping 2^20 numbers between processes."""
    import hashlib
    import numpy as np
    return hashlib.sha256(np.ascontiguousarray(
        zeta.cpu().numpy().astype(np.int32)).tobytes()).hexdigest()


def count_summary(res) -> dict:
    return dict(zeta=zeta_digest(res.zeta), rounds=res.rounds,
                a2a_entries=res.a2a_entries_total,
                a2a_bytes=res.a2a_bytes_total, overflow=res.overflow,
                occupancy=list(res.occupancy), residual=res.residual)


def walk_summary(res) -> dict:
    return dict(zeta=zeta_digest(res.zeta), rounds=res.rounds,
                dropped=res.dropped, waited=res.waited,
                round_active=res.round_active,
                a2a_entries=res.a2a_entries_total,
                a2a_bytes=res.a2a_bytes_total)


def three_phase_summary(res) -> dict:
    """The fields of a three-phase run that two meshes must agree on (all
    but the sampler's wall time), the visit vector as its digest."""
    return dict(
        zeta=zeta_digest(res.zeta), rounds=res.rounds,
        by_phase=[res.phase1_rounds, res.report_rounds, res.phase2_rounds,
                  res.phase3_rounds, res.tail_rounds],
        coupons=[res.coupons_created, res.coupons_used],
        walks=[res.terminated_by_coupon, res.exhausted_walks,
               res.tail_walks],
        dropped=res.dropped, waited=res.waited,
        wire=dict(res.a2a_bytes_by_phase),
        entries=dict(res.a2a_entries_by_site),
        phase2_records=res.phase2_records,
        occupancy=list(res.p1_occupancy), residual=res.residual)


def ppr_summary(res) -> dict:
    """The fields of a batched PPR run that two meshes must agree on, the
    vectors as their digest."""
    import hashlib
    import numpy as np
    return dict(
        ppr=hashlib.sha256(np.ascontiguousarray(res.ppr).tobytes())
        .hexdigest(), rounds=res.rounds, trace=list(res.active_trace),
        a2a_entries=res.a2a_entries, a2a_bytes=res.a2a_bytes,
        dropped=res.dropped, admit_dropped=res.admit_dropped)


def ppr_service_state(svc) -> str:
    """Digest of the service's host state: queue, slot map, statistics,
    cache keys and times, the engine's live walks, telemetry and cap."""
    import dataclasses
    import hashlib
    e = svc.engine
    state = dict(
        pending=[r.rid for r in svc.pending],
        slots=[None if r is None else r.rid for r in svc._slot_req],
        refreshing=sorted(map(repr, svc._refreshing)),
        next_rid=svc._next_rid, stats=dataclasses.asdict(svc.stats),
        cache=[[repr(k), t] for k, t in svc.cache.times()],
        shards=e.shards, cap=e.cap, active=e.active.tolist(),
        telemetry=[getattr(e, f) for f in e.TELEMETRY])
    return hashlib.sha256(json.dumps(state).encode()).hexdigest()


def ppr_service_trace(g, mesh, walks: int, vectors: bool = False):
    """(b)'s service: 16 slots of `walks` walks on `mesh` (P shards),
    answering PG_PPR_SERVICE's distinct queries, four a tick, then the
    repeats, two a tick, on an injected clock (one tick a superstep); it
    shrinks to P // 2 shards at one tick and grows back to P at another,
    the same on every process. Returns the requests, each result's digest
    (None where this process holds no vector), the final statistics, the
    host state's digest after each tick's step and whether this process
    served after each resize; with `vectors`, also the results
    themselves, in request order."""
    import dataclasses
    import hashlib
    import numpy as np
    from repro_torch import prng
    from repro_torch.serve import PPRService

    c = PG_PPR_SERVICE
    distinct = ppr_queries(g.n, c["distinct"], seed=2)
    rng = np.random.default_rng(3)
    repeats = [distinct[int(i)] for i in rng.choice(
        c["distinct"] // 2, c["repeats"], replace=False)]
    arrivals = sorted([(t // 4, q) for t, q in enumerate(distinct)] + [
        (c["repeat_tick"] + t // 2, q) for t, q in enumerate(repeats)],
        key=lambda a: a[0])
    svc = PPRService(g, EPS, slots=16, walks_per_query=walks, mesh=mesh,
                     key=prng.PRNGKey(3))
    reqs, states, serving, tick, P = [], {}, [], 0, mesh.shards
    while True:
        if tick in (c["shrink_tick"], c["grow_tick"]):
            svc.resize(shards=P // 2 if tick == c["shrink_tick"] else P)
            serving.append(svc.serving)
        due = []
        while arrivals and arrivals[0][0] <= tick:
            due.append(arrivals.pop(0)[1])
        if svc.serving:
            for src, w in due:
                reqs.append(svc.submit(src, w, now=float(tick)))
            svc.step(now=float(tick))
            states[str(tick)] = ppr_service_state(svc)
            if tick > c["grow_tick"] and not arrivals and not svc.busy:
                break
        tick += 1
        check(tick < 2000, "service trace: open after 2000 ticks")

    def digest(v):
        return None if v is None else hashlib.sha256(
            np.ascontiguousarray(v).tobytes()).hexdigest()

    out = dict(
        requests=[[r.rid, r.cached, r.done, r.t_done] for r in reqs],
        queries=[[list(r.sources), list(r.weights)] for r in reqs],
        results=[digest(r.result) for r in reqs],
        stats=dataclasses.asdict(svc.stats), states=states,
        serving=serving, ticks=tick)
    return (out, [r.result for r in reqs]) if vectors else out


def three_phase_kernels(res) -> list:
    """The kernels a three-phase run must have launched."""
    return list(THREE_PHASE) + (["walk_step"] if res.tail_walks else [])


def save_graph(g, path) -> None:
    import numpy as np
    rp, ci, dg = g.numpy()
    np.savez(path, row_ptr=rp, col_idx=ci, out_deg=dg, n=g.n, m=g.m,
             undirected=g.undirected)


def load_graph(path, device):
    import numpy as np
    from repro_torch import convert
    with np.load(path) as z:
        return convert.graph_from_numpy(
            z["row_ptr"], z["col_idx"], z["out_deg"], int(z["n"]),
            int(z["m"]), bool(z["undirected"]), device=device)


def process_group_child(spec: dict) -> int:
    """One process of phase (b): a gloo group whose collectives take the
    card's tensors, every process on the one card. Runs `spec["cases"]`
    and prints their results, each with its kernel launches, as JSON."""
    import datetime
    import torch
    import torch.distributed as dist
    from repro_torch import prng
    from repro_torch.core.collectives import ProcessGroupMesh
    from repro_torch.core.distributed import distributed_pagerank
    from repro_torch.core.distributed_counts import \
        distributed_pagerank_counts
    from repro_torch.core.distributed_directed import \
        distributed_directed_pagerank
    from repro_torch.core.distributed_improved import \
        distributed_improved_pagerank
    from repro_torch.core.personalized_batch import \
        batched_personalized_pagerank
    from repro_torch.kernels import common
    from repro_torch.runtime import SimulatedFailure

    torch.set_num_threads(1)
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dev = torch.device(spec["device"])
    dist.init_process_group(
        "gloo", store=dist.FileStore(spec["store"], world), rank=rank,
        world_size=world,
        timeout=datetime.timedelta(seconds=spec["timeout"]))
    out = dict(rank=rank, world=world)
    try:
        mesh = ProcessGroupMesh(device=dev)
        for case in spec["cases"]:
            g = load_graph(spec["graphs"][case], dev)
            K, key = spec["Ks"][case], prng.PRNGKey(0)
            kill3p = dict(eta_safety=spec["eta_safety"],
                          checkpoint_dir=spec["kill3p_dir"])
            common.reset_launches()
            t0 = time.perf_counter()
            if case == "improved":
                row = three_phase_summary(distributed_improved_pagerank(
                    g, EPS, K, key, mesh=mesh))
            elif case == "directed":
                row = three_phase_summary(distributed_directed_pagerank(
                    g, EPS, K, key, mesh=mesh))
            elif case == "kill3p":
                try:
                    distributed_improved_pagerank(
                        g, EPS, K, key, mesh=mesh, fail_at=[spec["mid_p2"]],
                        checkpoint_every=spec["mid_p2"], max_restarts=0,
                        **kill3p)
                    row = dict(died=False)
                except SimulatedFailure:
                    row = dict(died=True)
            elif case == "resume3p":
                # snapshots only at the re-anchor and the end: each is GBs
                res = distributed_improved_pagerank(
                    g, EPS, K, key, mesh=mesh, resume=True,
                    checkpoint_every=10 ** 6, **kill3p)
                row = dict(three_phase_summary(res), restarts=res.restarts,
                           shards=res.shards)
            elif case == "walks":
                row = walk_summary(distributed_pagerank(g, EPS, K, key,
                                                        mesh=mesh))
            elif case == "ppr":
                row = ppr_summary(batched_personalized_pagerank(
                    g, EPS, ppr_queries(g.n, PPR_QUERIES), spec["ppr_walks"],
                    key, mesh=mesh))
            elif case == "ppr_service":
                row = ppr_service_trace(g, mesh, spec["ppr_walks"])
            elif case == "ppr_audit":
                from repro_torch.analysis.congest import audit_all_engines
                rep = audit_all_engines(mesh, eps=EPS, engines=("ppr",))
                row = dict(ok=rep["ok"], violations=rep["violations_total"],
                           row={k: rep["engines"]["ppr"][k]
                                for k in AUDIT_ROW})
            elif case == "counts":
                row = count_summary(distributed_pagerank_counts(
                    g, EPS, K, key, mesh=mesh, packed=False))
            elif case == "kill":
                try:
                    distributed_pagerank_counts(
                        g, EPS, K, key, mesh=mesh, packed=False,
                        checkpoint_dir=spec["kill_dir"],
                        fail_at=[PG_KILL["kill_at"]],
                        checkpoint_every=PG_KILL["every"], max_restarts=0)
                    row = dict(died=False)
                except SimulatedFailure:
                    row = dict(died=True)
            else:
                res = distributed_pagerank_counts(
                    g, EPS, K, key, mesh=mesh, packed=False,
                    checkpoint_dir=spec["resume_dir"], resume=True,
                    checkpoint_every=PG_KILL["every"])
                row = dict(count_summary(res), restarts=res.restarts,
                           shards=res.shards)
            # the summaries read the results on the host: the runs are done
            row.update(seconds=time.perf_counter() - t0,
                       launches=dict(common.launches))
            out[case] = row
    finally:
        dist.destroy_process_group()
    print(json.dumps(out))
    return 0


def run_process_group(world: int, spec: dict, label: str, *,
                      flag: str = "--process-group-child",
                      where: Path = PG_DIR) -> list:
    """Start `world` child processes of this script (`flag`: which child)
    on the one card, each a rank of a gloo group from a FileStore under
    `where`; kill them all past PG_JOIN_S. Fails the phase unless every
    one exits 0. Returns their JSON."""
    store = where / f"store_{label}"
    spec = dict(spec, store=str(store), timeout=PG_TIMEOUT_S)
    procs, logs = [], []
    for rank in range(world):
        logf = open(where / f"{label}_rank{rank}.log", "w+")
        logs.append(logf)
        procs.append(subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), flag,
             json.dumps(spec)],
            env=dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
                     OMP_NUM_THREADS="1"),
            stdout=logf, stderr=subprocess.STDOUT, text=True))
    deadline = time.monotonic() + PG_JOIN_S
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    texts = []
    for logf in logs:
        logf.seek(0)
        texts.append(logf.read())
        logf.close()
    # every rank that failed: the first to fail ends the others' groups
    failed = [(rank, p.returncode, text) for rank, (p, text) in
              enumerate(zip(procs, texts)) if p.returncode != 0]
    check(not failed, "\n".join(
        f"{label}: rank {rank} of {world} exited {code}:\n{text[-2000:]}"
        for rank, code, text in failed))
    return [json.loads(text.strip().splitlines()[-1]) for text in texts]


# the program whose calls count a stage's rounds
STAGE_ROUND = {"phase1": "assign", "phase2": "stitch", "phase3": "count",
               "tail": "step"}


def per_stage_round(rec, syncs) -> dict:
    """Rounds, collectives a round (by kind) and host syncs a round of
    each stage, from a `RecordingMesh`'s program calls and the syncs
    counted while each stage's calls were the last opened."""
    out = {}
    for stage, prog in STAGE_ROUND.items():
        calls = [c for c in rec.calls if c.stage == stage]
        rounds = sum(c.program == prog for c in calls)
        prims = {}
        for call in calls:
            for c in call.collectives:
                prims[c.prim] = prims.get(c.prim, 0) + 1
        out[stage] = dict(
            rounds=rounds,
            collectives_a_round={p: n / max(rounds, 1)
                                 for p, n in sorted(prims.items())},
            host_syncs_a_round=syncs.get(stage, 0) / max(rounds, 1))
    out["outside_rounds_syncs"] = syncs.get("setup", 0)
    return out


def three_phase_world_one(mesh, drive):
    """(a) for the three-phase engines: Algorithm 2 on erdos_renyi(2^20,
    8) at main_path's K and Section 5 on doc_link_graph(2^14), each on the
    NCCL group of world size 1 and on `StackedMesh(1)`, bit-equal, both
    held to the three-phase guards; then Algorithm 2 once more over a
    `RecordingMesh` of the group, with torch's sync debug mode on, for
    the collectives and host syncs a round of each phase."""
    import warnings
    import torch
    from repro_torch import prng
    from repro_torch.analysis.congest import RecordingMesh
    from repro_torch.core import power_iteration, walks_per_node_for
    from repro_torch.core.collectives import StackedMesh
    from repro_torch.core.distributed_directed import \
        distributed_directed_pagerank
    from repro_torch.core.distributed_improved import \
        distributed_improved_pagerank
    from repro_torch.graphs import doc_link_graph, erdos_renyi

    dev, key, out = mesh.device, prng.PRNGKey(0), {}
    # erdos_renyi's PageRank is near-uniform: its top-10 lies within the
    # estimate's noise at K = 139 (0.5 at P = 1), so only its L1 is gated
    for engine, fn, gg, topk in (
            ("improved", distributed_improved_pagerank,
             erdos_renyi(N, 8.0, seed=0), False),
            ("directed", distributed_directed_pagerank,
             doc_link_graph(N_DIRECTED, seed=0), True)):
        K = walks_per_node_for(gg.n, EPS)
        pi_ref = power_iteration(gg, EPS, tol=1e-7,
                                 max_iters=1000)[0].cpu().numpy()
        runs = {}
        for name, m in (("nccl", mesh), ("stacked", StackedMesh(1, dev))):
            res, secs, peak = drive(
                f"{engine}[{name} P=1, n={gg.n}]",
                lambda: fn(gg, EPS, K, key, mesh=m), THREE_PHASE)
            checked = three_phase_checks(f"{engine} {name} P=1", res, gg.n,
                                         K, pi_ref, gate_topk=topk)
            for kernel in three_phase_kernels(res):
                check(drive.last[kernel] > 0,
                      f"{engine} {name} P=1: {kernel} never launched")
            runs[name] = dict(three_phase_summary(res), seconds=secs,
                              peak_gib=peak, sampler_s=res.sampler_us / 1e6,
                              l1=checked["l1"], top10=checked["top10"])
            del res
            torch.cuda.empty_cache()
        a, b = ({k: v for k, v in runs[n].items()
                 if k not in ("seconds", "peak_gib", "sampler_s", "l1",
                              "top10")}
                for n in ("nccl", "stacked"))
        check(a == b, f"{engine}: NCCL world 1 differs from StackedMesh(1): "
                      f"{a} != {b}")
        out[engine] = dict(
            n=gg.n, K=K, rounds=a["rounds"], by_phase=a["by_phase"],
            coupons=a["coupons"], walks=a["walks"], wire=a["wire"],
            l1=runs["nccl"]["l1"], top10=runs["nccl"]["top10"],
            **{f"{k}_{n}": runs[n][k] for n in ("nccl", "stacked")
               for k in ("seconds", "peak_gib", "sampler_s")})
        log(f"process group (a) {engine} world 1: {out[engine]}")

        if engine == "improved":
            rec = RecordingMesh(mesh, lints=False)
            syncs = {}

            def show(message, *args, **kw):
                if "synchroniz" in str(message):
                    stage = rec.calls[-1].stage if rec.calls else "setup"
                    syncs[stage] = syncs.get(stage, 0) + 1

            with warnings.catch_warnings():
                warnings.simplefilter("always")
                warnings.showwarning = show
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    res = fn(gg, EPS, K, key, mesh=rec)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            check(zeta_digest(res.zeta) == a["zeta"],
                  "improved over the recording mesh differs")
            out["per_round"] = per_stage_round(rec, syncs)
            log(f"process group (a) improved a round by phase: "
                f"{out['per_round']}")
            del res, rec
        del gg
        torch.cuda.empty_cache()
    return out


def pg_ppr_stacked(g, four) -> dict:
    """(b)'s PPR cases on `StackedMesh(4)` in this process, the batched
    run and the service's computed answers held to the personalized power
    iteration, and the service's trace checked across the processes of
    `four`: rank 0's requests, result digests and host state after every
    tick equal the stacked service's; every process's state after each
    tick it served equals rank 0's; the two processes the shrink left out
    said so and served again after the grow. Returns the summaries the
    processes must equal."""
    import torch
    from repro_torch import prng
    from repro_torch.analysis.congest import audit_all_engines
    from repro_torch.core.collectives import StackedMesh
    from repro_torch.core.personalized_batch import \
        batched_personalized_pagerank
    from repro_torch.serve import query_cache_key

    dev, out = g.device, {}
    mesh = StackedMesh(PG_RANKS, dev)
    queries = ppr_queries(g.n, PPR_QUERIES)
    t0 = time.perf_counter()
    res = batched_personalized_pagerank(g, EPS, queries, PG_PPR_WALKS,
                                        prng.PRNGKey(0), mesh=mesh)
    torch.cuda.synchronize()
    out["seconds"] = dict(ppr=time.perf_counter() - t0)
    ref = ppr_oracle(g, queries)
    for q in range(len(queries)):
        ppr_accuracy(f"(b) batched PPR stacked P=4 query {q}", res.ppr[q],
                     ref[q], PG_PPR_WALKS)
    out["ppr"] = ppr_summary(res)
    del res
    t0 = time.perf_counter()
    svc, vectors = ppr_service_trace(g, mesh, PG_PPR_WALKS, vectors=True)
    out["seconds"]["ppr_service"] = time.perf_counter() - t0
    out["service"] = svc
    check(svc["serving"] == [True, True] and svc["stats"]["dropped_walks"]
          == svc["stats"]["admit_dropped"] == 0
          and svc["stats"]["cache_hits"] > 0
          and all(r[2] for r in svc["requests"]),
          f"(b) stacked service: {svc['stats']}, serving {svc['serving']}")
    rank0 = four[0]["ppr_service"]
    for field in ("requests", "queries", "results", "states", "stats"):
        check(rank0[field] == svc[field],
              f"(b) service: rank 0's {field} differ from the stacked "
              f"service's")
    for o in four:
        r = o["ppr_service"]
        check(all(r["states"][t] == rank0["states"][t] for t in r["states"]),
              f"(b) service: rank {o['rank']}'s host state differs from "
              f"rank 0's")
        left_out = o["rank"] >= 2
        check(r["serving"] == [not left_out, True]
              and (len(r["states"]) < len(rank0["states"])) == left_out,
              f"(b) service: rank {o['rank']} served {r['serving']}")
        check(all(d is None for d in r["results"]) == (o["rank"] > 0),
              f"(b) service: rank {o['rank']}'s vectors")
    # the first answer to each of the first 16 distinct queries: the
    # oracle
    distinct = ppr_queries(g.n, PPR_QUERIES, seed=2)
    ref = ppr_oracle(g, distinct)
    first = {}
    for (src, w), vec in zip(svc.pop("queries"), vectors):
        first.setdefault((tuple(src), tuple(w)), vec)
    for q, (src, w) in enumerate(distinct):
        ppr_accuracy(f"(b) service stacked query {q}",
                     first[query_cache_key(src, w, g.n)], ref[q],
                     PG_PPR_WALKS)
    rep = audit_all_engines(mesh, eps=EPS, engines=("ppr",))
    out["audit"] = json.loads(json.dumps(dict(
        ok=rep["ok"], violations=rep["violations_total"],
        row={k: rep["engines"]["ppr"][k] for k in AUDIT_ROW})))
    check(out["audit"]["ok"], f"(b) stacked ppr audit: {out['audit']}")
    log(f"process group (b) PPR stacked P=4: {out['seconds']}, service "
        f"{svc['stats']}, {svc['ticks']} ticks")
    return out


def ppr_world_one(mesh, g, drive):
    """(a) for PPR: the batched engine at ppr_path's width (PPR_QUERIES
    queries of PPR_WALKS walks) on `g` at P = 1, on the NCCL group of
    world size 1 and on `StackedMesh(1)`, bit-equal (every vector,
    supersteps, the live-walk trace, entries, bytes), each query held to
    the personalized power iteration; then the engine once more over a
    `RecordingMesh` of the group, with torch's sync debug mode on, for
    the collectives and host syncs of each admission, each superstep and
    each vector's read."""
    import warnings
    import numpy as np
    import torch
    from repro_torch import prng
    from repro_torch.analysis.congest import RecordingMesh
    from repro_torch.core.collectives import StackedMesh
    from repro_torch.core.personalized_batch import (
        BatchedPPREngine, batched_personalized_pagerank)

    dev, key, W = mesh.device, prng.PRNGKey(0), PPR_WALKS
    queries = ppr_queries(g.n, PPR_QUERIES)
    ref = ppr_oracle(g, queries)
    runs = {}
    for name, m in (("nccl", mesh), ("stacked", StackedMesh(1, dev))):
        res, secs, peak = drive(
            f"batched_personalized_pagerank[{name} P=1]",
            lambda: batched_personalized_pagerank(g, EPS, queries, W, key,
                                                  mesh=m), PPR_KERNELS)
        check(res.dropped == 0 and res.admit_dropped == 0
              and res.active_trace[-1] == 0,
              f"batched PPR {name} P=1: dropped {res.dropped}, "
              f"admit_dropped {res.admit_dropped}, live walks left")
        accs = [ppr_accuracy(f"batched PPR {name} P=1 query {q}", res.ppr[q],
                             ref[q], W) for q in range(len(queries))]
        runs[name] = dict(ppr_summary(res), seconds=secs, peak_gib=peak,
                          worst_l1=max(a[0] for a in accs),
                          worst_top10=min(a[1] for a in accs),
                          launches=dict(drive.last))
        del res
        torch.cuda.empty_cache()
    keep = ("seconds", "peak_gib", "worst_l1", "worst_top10", "launches")
    a, b = ({k: v for k, v in runs[n].items() if k not in keep}
            for n in ("nccl", "stacked"))
    check(a == b, f"batched PPR: NCCL world 1 differs from StackedMesh(1): "
                  f"{ {k: v for k, v in a.items() if k != 'trace'} } != "
                  f"{ {k: v for k, v in b.items() if k != 'trace'} }")
    out = dict(n=g.n, queries=len(queries), walks_per_query=W,
               supersteps=a["rounds"], a2a_entries=a["a2a_entries"],
               a2a_bytes=a["a2a_bytes"],
               **{f"{k}_{n}": runs[n][k] for n in ("nccl", "stacked")
                  for k in keep})

    # each part of batched_personalized_pagerank over a recording mesh
    rec = RecordingMesh(mesh, lints=False)
    engine = BatchedPPREngine(g, EPS, num_slots=len(queries),
                              walks_per_query=W, mesh=rec)
    engine.reset(prng.fold_in(key, 0xBA7C))

    def admit():
        for i, (src, w) in enumerate(queries):
            engine.admit(i, src, w, key=prng.fold_in(key, i))

    def run():
        while engine.active.sum() > 0:
            engine.superstep()

    syncs, parts = {}, (("admit", admit), ("superstep", run), (
        "extract", lambda: np.stack([engine.extract(i)
                                     for i in range(len(queries))])))
    for part, fn in parts:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                got = fn()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        syncs[part] = sum("synchroniz" in str(w.message) for w in caught)
    import hashlib
    check(hashlib.sha256(np.ascontiguousarray(got).tobytes()).hexdigest()
          == a["ppr"] and (engine.rounds, engine.a2a_entries,
                           engine.a2a_bytes)
          == (a["rounds"], a["a2a_entries"], a["a2a_bytes"]),
          "batched PPR over the recording mesh differs")
    calls = {"admit": len(queries), "superstep": engine.rounds,
             "extract": len(queries)}
    per = {}
    for part, n_calls in calls.items():
        prims = {}
        for call in rec.calls:
            if call.program == part:
                for c in call.collectives:
                    prims[c.prim] = prims.get(c.prim, 0) + 1
        per[part] = dict(calls=n_calls,
                         collectives_a_call={p: k / n_calls
                                             for p, k in sorted(prims.items())},
                         host_syncs_a_call=syncs[part] / n_calls)
    out["per_call"] = per
    log(f"process group (a) batched PPR world 1: {out}")
    del engine, rec, got
    torch.cuda.empty_cache()
    return out


def process_group_path(g, K, drive, sharded, counts_zeta):
    """The sharded engines with one shard per process
    (`ProcessGroupMesh`). (a) An NCCL group of one process, this one: the
    count engine (unpacked) and the walk engine at main_path's K on
    doc_link_graph(2^20), bit-equal to `StackedMesh(1)`, with the
    all_to_all timed against the stacked block transpose and the
    collectives and host syncs a round counted; then Algorithm 2 and
    Section 5 (`three_phase_world_one`). (b) Four processes on the one
    card over gloo with card tensors: the count engine at P=4 bit-equal to
    main_path's `StackedMesh(4)` run, killed at P=4 and resumed at P=2
    bit-equal; Algorithm 2 on erdos_renyi(2^16, 8) and Section 5 on
    doc_link_graph(2^12) at P=4, and elastic_path's Algorithm 2 (2^15,
    eta_safety 8) killed mid-Phase 2 at P=4 and resumed at P=2, each
    bit-equal to `StackedMesh(4)` (the resume but for its wire, which
    routes between 2 shards); and the walk engine at P=2 on
    doc_link_graph(2^16) bit-equal to `StackedMesh(2)` there. PPR:
    `ppr_world_one` in (a), and in (b) the batched engine, the service
    resized 4 -> 2 -> 4 and the `ppr` audit row at P=4 on
    doc_link_graph(2^16) (`pg_ppr_stacked` holds them to the stacked
    runs)."""
    import datetime
    import warnings
    import torch
    import torch.distributed as dist
    from repro_torch import prng
    from repro_torch.analysis.congest import RecordingMesh
    from repro_torch.core.collectives import ProcessGroupMesh, StackedMesh
    from repro_torch.core.distributed import distributed_pagerank
    from repro_torch.core import power_iteration, walks_per_node_for
    from repro_torch.core.distributed_counts import \
        distributed_pagerank_counts
    from repro_torch.core.distributed_directed import \
        distributed_directed_pagerank
    from repro_torch.core.distributed_improved import \
        distributed_improved_pagerank
    from repro_torch.graphs import doc_link_graph, erdos_renyi

    shutil.rmtree(PG_DIR, ignore_errors=True)
    PG_DIR.mkdir(parents=True)
    dev = g.device
    key, K_walk = prng.PRNGKey(0), sharded["walks"]["K"]
    out = {}

    # (a) NCCL, world size 1, in this process
    dist.init_process_group(
        "nccl", store=dist.FileStore(str(PG_DIR / "store_nccl"), 1),
        rank=0, world_size=1,
        device_id=torch.device("cuda", torch.cuda.current_device()),
        timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
    try:
        mesh = ProcessGroupMesh(device=dev)
        check(mesh.shards == 1 and dist.get_backend() == "nccl",
              f"process group: {mesh}")
        runs = {}
        for name, m in (("nccl", mesh), ("stacked", StackedMesh(1, dev))):
            res, secs, _ = drive(
                f"distributed_pagerank_counts[{name} P=1]",
                lambda: distributed_pagerank_counts(g, EPS, K, key, mesh=m,
                                                    packed=False),
                ["multinomial_rows", "segment_spmv"])
            runs[f"counts/{name}"] = dict(count_summary(res), seconds=secs)
            del res
            res, secs, _ = drive(
                f"distributed_pagerank[{name} P=1]",
                lambda: distributed_pagerank(g, EPS, K_walk, key, mesh=m),
                ["walk_step", "histogram"])
            runs[f"walks/{name}"] = dict(walk_summary(res), seconds=secs)
            del res
            torch.cuda.empty_cache()
        for engine in ("counts", "walks"):
            a, b = (dict(runs[f"{engine}/{n}"]) for n in ("nccl", "stacked"))
            secs = (a.pop("seconds"), b.pop("seconds"))
            check(a == b, f"{engine}: NCCL world 1 differs from "
                          f"StackedMesh(1): {a} != {b}")
            out[f"{engine}_world1"] = dict(a, seconds_nccl=secs[0],
                                           seconds_stacked=secs[1])
        check(runs["counts/nccl"]["zeta"] == zeta_digest(counts_zeta)
              and runs["counts/nccl"]["rounds"]
              == sharded["counts"]["rounds"],
              "counts under NCCL: zeta or rounds differ from main_path's")

        # the all_to_all of a round's lanes: the count engine's unpacked
        # (vertex, count) lanes and the walk engine's route lanes
        a2a = {}
        for label, shape in (("count lanes", (1, g.n, 2)),
                             ("walk lanes", (1, g.n * K_walk))):
            x = torch.arange(math.prod(shape), dtype=torch.int32,
                             device=dev).reshape(shape)
            check(torch.equal(mesh.all_to_all(x),
                              StackedMesh(1, dev).all_to_all(x)),
                  f"all_to_all of {label} differs from the stacked one")
            a2a[label] = dict(
                shape=list(shape), nbytes=x.numel() * 4,
                nccl_ms=cuda_ms(lambda: mesh.all_to_all(x), 20),
                stacked_ms=cuda_ms(
                    lambda: StackedMesh(1, dev).all_to_all(x).contiguous(),
                    20))
            del x
        out["all_to_all"] = a2a

        # collectives a round (recorded) and host syncs a round (torch's
        # sync debug mode warns on each)
        rec = RecordingMesh(mesh, lints=False)
        counted = {}
        for engine, fn in (
                ("counts", lambda: distributed_pagerank_counts(
                    g, EPS, K, key, mesh=rec, packed=False)),
                ("walks", lambda: distributed_pagerank(g, EPS, K_walk, key,
                                                       mesh=rec))):
            rec.calls.clear()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    res = fn()
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            prims = {}
            for call in rec.calls:
                for c in call.collectives:
                    prims[c.prim] = prims.get(c.prim, 0) + 1
            syncs = sum("synchroniz" in str(w.message) for w in caught)
            counted[engine] = dict(
                rounds=res.rounds,
                collectives_a_round={p: n / res.rounds
                                     for p, n in sorted(prims.items())},
                host_syncs_a_round=syncs / res.rounds)
            del res
        out["per_round"] = counted
        del rec
        torch.cuda.empty_cache()
        out["three_phase"] = three_phase_world_one(mesh, drive)
        out["ppr"] = ppr_world_one(mesh, g, drive)
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    check(not dist.is_initialized(), "the NCCL group was not destroyed")
    log(f"process group (a), NCCL world 1: {out}")

    # (b) four processes on the card, gloo with card tensors
    graphs = dict(graph=g, walk_graph=doc_link_graph(N_PG_WALKS, seed=0,
                                                     device=dev),
                  improved=erdos_renyi(N_PG_IMPROVED, 8.0, seed=0),
                  directed=doc_link_graph(N_PG_DIRECTED, seed=0),
                  kill3p=erdos_renyi(N_ELASTIC_IMPROVED, 8.0, seed=0))
    files = {}
    for name, gg in graphs.items():
        files[name] = str(PG_DIR / f"{name}.npz")
        save_graph(gg, files[name])
    Ks = {name: walks_per_node_for(gg.n, EPS) for name, gg in graphs.items()}
    Ks["graph"] = Ks["walk_graph"] = K
    # which graph each case runs on
    of = dict(counts="graph", kill="graph", resume="graph",
              walks="walk_graph", improved="improved", directed="directed",
              kill3p="kill3p", resume3p="kill3p", ppr="walk_graph",
              ppr_service="walk_graph", ppr_audit="walk_graph")
    # the stacked runs the processes must equal; the kill of Algorithm 2
    # is elastic_path's, mid-Phase 2 of its unfailed run
    stacked = {}
    for case, fn, kw in (
            ("improved", distributed_improved_pagerank, {}),
            ("directed", distributed_directed_pagerank, {}),
            ("kill3p", distributed_improved_pagerank,
             dict(eta_safety=ELASTIC_IMPROVED["eta_safety"]))):
        gg = graphs[case]
        res, secs, _ = drive(
            f"{case}[stacked P=4, n={gg.n}] for (b)",
            lambda: fn(gg, EPS, Ks[case], key, mesh=StackedMesh(4, dev),
                       **kw), THREE_PHASE)
        # only the L1 is gated on erdos_renyi (three_phase_world_one)
        three_phase_checks(f"{case} stacked P=4", res, gg.n, Ks[case],
                           power_iteration(gg, EPS, tol=1e-7, max_iters=1000)
                           [0].cpu().numpy(), gate_topk=case == "directed")
        stacked[case] = dict(three_phase_summary(res), seconds=secs,
                             kernels=three_phase_kernels(res))
        if case == "kill3p":
            check(res.tail_walks == 0, "(b)'s kill: the tail is not empty, "
                                       "so its resume is not bit-exact")
            mid_p2 = (res.phase1_rounds + res.report_rounds
                      + max(res.phase2_rounds // 2, 1))
        del res, gg
    torch.cuda.empty_cache()
    spec = dict(graphs={case: files[of[case]] for case in of},
                Ks={case: Ks[of[case]] for case in of}, device=str(dev),
                kill_dir=str(PG_DIR / "kill"),
                resume_dir=str(PG_DIR / "resume"),
                kill3p_dir=str(PG_DIR / "kill3p"), mid_p2=mid_p2,
                ppr_walks=PG_PPR_WALKS,
                eta_safety=ELASTIC_IMPROVED["eta_safety"])
    t0 = time.perf_counter()
    four = run_process_group(
        PG_RANKS, dict(spec, cases=["counts", "kill", "improved",
                                    "directed", "kill3p", "ppr",
                                    "ppr_service", "ppr_audit"]), "gloo4")
    shutil.copytree(PG_DIR / "kill", PG_DIR / "resume")
    # Algorithm 2 resumes in its kill directory: a copy would write its
    # 3.2 GB again, on top of elastic_path's ~37 GB of snapshots
    two = run_process_group(
        PG_KILL["resume_ranks"],
        dict(spec, cases=["resume", "walks", "resume3p"]), "gloo2")
    out["gloo_wall_s"] = time.perf_counter() - t0
    want_counts = dict(zeta=zeta_digest(counts_zeta),
                       rounds=sharded["counts"]["rounds"],
                       a2a_entries=sharded["counts"]["a2a_entries"],
                       a2a_bytes=sharded["counts"]["a2a_bytes"])
    stacked_walks = walk_summary(distributed_pagerank(
        graphs["walk_graph"], EPS, K, key, mesh=StackedMesh(2, dev)))
    stacked_ppr = pg_ppr_stacked(graphs["walk_graph"], four)
    out["gloo_ppr_stacked_s"] = stacked_ppr.pop("seconds")
    # the resumed run routes between 2 shards: its wire differs
    resumed = {k: v for k, v in stacked["kill3p"].items()
               if k not in ("wire", "entries", "seconds", "kernels")}
    rows = {}
    for case, outs, want, kernels in (
            ("counts", four, want_counts, ["multinomial_rows",
                                           "segment_spmv"]),
            ("kill", four, dict(died=True), ["multinomial_rows"]),
            ("improved", four, stacked["improved"],
             stacked["improved"]["kernels"]),
            ("directed", four, stacked["directed"],
             stacked["directed"]["kernels"]),
            ("kill3p", four, dict(died=True), list(THREE_PHASE)),
            ("resume", two, dict(zeta=want_counts["zeta"],
                                 rounds=want_counts["rounds"], restarts=0,
                                 shards=2), ["multinomial_rows"]),
            ("walks", two, stacked_walks, ["walk_step", "histogram"]),
            ("ppr", four, stacked_ppr["ppr"], PPR_KERNELS),
            ("ppr_service", four, dict(stats=stacked_ppr["service"]["stats"],
                                       ticks=stacked_ppr["service"]["ticks"]),
             PPR_KERNELS),
            ("ppr_audit", four, stacked_ppr["audit"], PPR_KERNELS),
            ("resume3p", two, dict(resumed, restarts=0, shards=2),
             ["histogram", "segment_spmv"])):
        want = {k: v for k, v in want.items()
                if k not in ("seconds", "kernels")}
        for o in outs:
            r = o[case]
            check({k: r[k] for k in want} == want,
                  f"gloo P={o['world']} {case}, rank {o['rank']}: "
                  f"{ {k: r[k] for k in want} } != {want}")
            for name in kernels:
                check(r["launches"][name] > 0,
                      f"gloo {case}, rank {o['rank']}: {name} never "
                      f"launched")
            for name, c in r["launches"].items():
                drive.launches[name] += c
        rows[case] = dict(ranks=len(outs),
                          seconds=max(o[case]["seconds"] for o in outs),
                          launches=[o[case]["launches"] for o in outs])
        log(f"process group (b) {case}: {rows[case]}")
    out["gloo"] = rows
    out["gloo_stacked_s"] = {case: r["seconds"] for case, r in stacked.items()}
    log(f"process group (b) stacked P=4 s: {out['gloo_stacked_s']}")
    shutil.rmtree(PG_DIR, ignore_errors=True)
    log(f"process group: PASS, (b) {out['gloo_wall_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# the elastic runtime: kill at one shard count, resume at another
# ---------------------------------------------------------------------------

ELASTIC_DIR = ROOT / "build" / "elastic"
ELASTIC_COUNTS = dict(kill_shards=8, kill_at=40, every=10,
                      targets=(1, 2, 4, 16))
# the launcher snapshots every 10 rounds. Killed at round 11 it resumes
# mid-run from round 10's snapshot (on doc_link_graph(2^20) every live walk
# then sits in the first quarter of the ids: one shard of four); killed at
# round 5 it resumes from round 0's, every walk alive, the largest
# re-layout. That one resumes at P=1: at P=4 the launcher's cap of 2W/P
# slots a shard cannot hold the walks that converge on the low ids, and
# both packages drop some. Kill round: the shard counts it resumes at
ELASTIC_WALKS = dict(kill_shards=2, kills={11: (4,), 5: (1,)})
# Algorithm 2 killed mid-Phase 2. A Phase-2 snapshot holds 3 + lam int32
# coupon slots a coupon; at eta_safety 8 erdos_renyi(2^15, 8) has S =
# 61,594,440 coupons (1.72 GB a snapshot); 2^17 would write 7.8 GB a
# snapshot, ~30 GB for the kill and two resumes
N_ELASTIC_IMPROVED = 1 << 15
ELASTIC_IMPROVED = dict(kill_shards=4, targets=(2, 8), eta_safety=8.0)
# Section 5 killed in keyed Phase 1: uniform pools give doc_link_graph(2^12)
# S = 37,158,912 coupons, (2 + lam) int32 slots a coupon (1.34 GB a
# snapshot); 2^14 would write 8.1 GB a snapshot
N_ELASTIC_DIRECTED = 1 << 12
ELASTIC_DIRECTED = dict(kill_shards=4, kill_at=3, every=2, targets=(2,))


class RecoveryProbe:
    """Times the checkpoint runtime from outside the engines while they run
    (`with probe.watch(): ...`): each snapshot save (seconds and bytes on
    disk), the restore of a snapshot, its re-layout and its placement on
    the card, and the end of the first round a resumed supervisor runs.
    Patches `Checkpointer.save`/`restore` and `Supervisor.run` for the
    duration of the block; `check_relayout(flat, out)` sees each re-layout's
    input and output."""

    def __init__(self):
        self.check_relayout = None
        self.reset()

    def reset(self):
        self.t_call = time.perf_counter()
        self.saves, self.restore_s, self.relayout_s = [], 0.0, 0.0
        self.place_s, self.first_round_end = 0.0, None

    @contextmanager
    def watch(self):
        import torch
        from repro_torch.checkpoint import checkpointer
        from repro_torch.runtime import fault_tolerance
        ck, sup = checkpointer.Checkpointer, fault_tolerance.Supervisor
        save, restore, run = ck.save, ck.restore, sup.run
        probe = self

        def timed_save(self, step, tree, **kw):
            t0 = time.perf_counter()
            path = save(self, step, tree, **kw)
            secs = time.perf_counter() - t0
            size = sum(f.stat().st_size for f in Path(path).iterdir())
            probe.saves.append((int(step), secs, size))
            return path

        def timed_restore(self, *a, **kw):
            t0 = time.perf_counter()
            out = restore(self, *a, **kw)
            probe.restore_s += time.perf_counter() - t0
            return out

        def probed_run(self, state, **kw):
            step_fn, from_host, relayout = (self.step_fn, self.from_host,
                                            self.relayout)

            def timed_from_host(flat):
                t0 = time.perf_counter()
                out = from_host(flat)
                torch.cuda.synchronize()
                probe.place_s += time.perf_counter() - t0
                return out

            def timed_relayout(flat, old_shards):
                t0 = time.perf_counter()
                out = relayout(flat, old_shards)
                probe.relayout_s += time.perf_counter() - t0
                if probe.check_relayout is not None:
                    probe.check_relayout(flat, out)
                return out

            def timed_step(s):
                out = step_fn(s)
                if probe.first_round_end is None:
                    torch.cuda.synchronize()
                    probe.first_round_end = time.perf_counter()
                return out

            self.step_fn, self.from_host = timed_step, timed_from_host
            if relayout is not None:
                self.relayout = timed_relayout
            try:
                return run(self, state, **kw)
            finally:
                self.step_fn, self.from_host, self.relayout = (
                    step_fn, from_host, relayout)

        ck.save, ck.restore, sup.run = timed_save, timed_restore, probed_run
        try:
            yield self
        finally:
            ck.save, ck.restore, sup.run = save, restore, run

    def summary(self, resumed: bool) -> dict:
        """Seconds and bytes of the last run; `recover_s` runs from the
        engine call to the end of the first resumed round."""
        out = dict(saves=len(self.saves),
                   save_s=[round(s, 4) for _, s, _ in self.saves],
                   snapshot_bytes=max((b for _, _, b in self.saves),
                                      default=0))
        if resumed:
            out.update(restore_s=self.restore_s, relayout_s=self.relayout_s,
                       place_s=self.place_s,
                       restore_relayout_s=(self.restore_s + self.relayout_s
                                           + self.place_s),
                       recover_s=self.first_round_end - self.t_call)
        return out


def _snapshot_stage(ckpt_dir):
    """(step, stage tag) of the latest snapshot under `ckpt_dir`, reading
    only the tag from its arrays."""
    import numpy as np
    from repro_torch.checkpoint import Checkpointer, unpack_json
    step = Checkpointer(str(ckpt_dir)).latest_step()
    with np.load(Path(ckpt_dir) / f"step_{step:09d}" / "arrays.npz") as z:
        return step, unpack_json(z["stage"])


def _kill(fn):
    """Run `fn`, which must die of its injected failure."""
    from repro_torch.runtime import SimulatedFailure
    try:
        fn()
    except SimulatedFailure:
        return True
    check(False, "the injected failure did not stop the run")


def check_walk_relayout(flat, out):
    """The re-layout of the walk state keeps the live-walk multiset (each
    vertex's count of live walks), the sum of zeta and the counters."""
    import numpy as np
    old, new = np.asarray(flat["pos"]), out["pos"]
    n = int(np.asarray(flat["zeta"]).size)
    live_old, live_new = old[old >= 0], new[new >= 0]
    check(live_old.size == live_new.size,
          f"walk re-layout: {live_old.size} live walks became "
          f"{live_new.size}")
    check(np.array_equal(np.bincount(live_old, minlength=n),
                         np.bincount(live_new, minlength=n)),
          "walk re-layout: the live-walk multiset changed")
    zo = np.asarray(flat["zeta"], dtype=np.int64)
    zn = out["zeta"].astype(np.int64)
    check(zo.sum() == zn.sum(), "walk re-layout: the sum of zeta changed")
    check(all(int(np.asarray(flat[k])) == int(np.asarray(out[k]))
              for k in ("round", "dropped", "waited")),
          "walk re-layout: a replicated counter changed")
    log(f"walk re-layout: {live_old.size} live walks, "
        f"{old.shape} -> {new.shape} (live walks by new shard "
        f"{[int((row >= 0).sum()) for row in new]}), sum of zeta "
        f"{int(zo.sum())}: kept")


def elastic_path(g, K, K_walk, drive, pi_ref, counts_zeta, counts_rounds):
    """Kill and resume at another shard count on the card, through the
    engines' entry points: the sharded count engine at full size (killed
    at P=8, resumed at 1, 2, 4 and 16; zeta bit-equal to the single-device
    count engine's), the launcher's walk engine at full size (killed at
    P=2, resumed at 4 mid-run and at 1 from its first snapshot; the live
    walks kept by the re-layout, the accuracy gate), Algorithm 2 killed mid-Phase 2 (bit-equal to its
    unfailed run), Section 5 killed in keyed Phase 1 (the three-phase
    guards), and small kills on the card against the CPU. Prints each
    run's snapshot bytes, save seconds, restore + re-layout seconds and
    time to recover."""
    import numpy as np
    import torch
    from repro_torch import prng
    from repro_torch.core import power_iteration, walks_per_node_for
    from repro_torch.core.collectives import StackedMesh
    from repro_torch.core.distributed_counts import \
        distributed_pagerank_counts
    from repro_torch.core.distributed_directed import \
        distributed_directed_pagerank
    from repro_torch.core.distributed_improved import \
        distributed_improved_pagerank
    from repro_torch.graphs import doc_link_graph, erdos_renyi
    from repro_torch.launch.pagerank import run_walks

    out = {}
    probe = RecoveryProbe()
    three = ["histogram", "segment_spmv", "multinomial_rows"]

    def record(label, resumed, **info):
        info.update(probe.summary(resumed))
        out[label] = info
        log(f"elastic {label}: {info}")

    def kill_and_resume(name, kill, resume, targets, kernels, gate,
                        resume_kernels=None, kill_check=None, **kill_info):
        """`kill(dir)` must die of its injected failure; `resume(P, dir)`
        continues a pristine copy of its snapshots at each of `targets`,
        and `gate(P, result)` checks it and returns what to record."""
        kill_dir = ELASTIC_DIR / name
        with probe.watch():
            probe.reset()
            drive(f"elastic {name}: kill", lambda: _kill(
                lambda: kill(str(kill_dir))), kernels)
            if kill_check is not None:
                kill_check(kill_dir)
            record(f"{name} kill", False, **kill_info)
            for p in targets:
                # a resume writes into its directory (the re-anchor, later
                # snapshots), so each gets a copy of the kill's: hard links,
                # since the Checkpointer writes every snapshot as new files
                d = ELASTIC_DIR / f"{name}_{p}"
                shutil.copytree(kill_dir, d, copy_function=os.link)
                res, secs, peak = drive(
                    f"elastic {name}: resume at P={p}",
                    lambda: (probe.reset(), resume(p, str(d)))[1],
                    resume_kernels or kernels)
                record(f"{name} resume P={p}", True, seconds=secs,
                       peak_gib=peak, **gate(p, res))
                del res
                shutil.rmtree(d)
                torch.cuda.empty_cache()
        shutil.rmtree(kill_dir)

    def stage_check(step, stage):
        def check_kill(kill_dir):
            got = _snapshot_stage(kill_dir)
            check(got == (step, stage), f"the kill left the snapshot "
                  f"{got}, not a {stage} snapshot of round {step}")
        return check_kill

    shutil.rmtree(ELASTIC_DIR, ignore_errors=True)
    ELASTIC_DIR.mkdir(parents=True)
    try:
        # ---- counts, doc_link_graph(2^20), unpacked lanes ----
        c = ELASTIC_COUNTS

        def counts(shards, d, **kw):
            return distributed_pagerank_counts(
                g, EPS, K, prng.PRNGKey(0), mesh=StackedMesh(shards, g.device),
                packed=False, checkpoint_dir=d, checkpoint_every=c["every"],
                **kw)

        def counts_gate(p, res):
            check(torch.equal(res.zeta, counts_zeta),
                  f"counts resumed at P={p}: zeta differs from the "
                  f"single-device count engine's")
            check(res.rounds == counts_rounds and res.restarts == 0
                  and res.shards == p and res.overflow == 0
                  and res.residual == 0,
                  f"counts resumed at P={p}: rounds {res.rounds} (want "
                  f"{counts_rounds}), restarts {res.restarts}, overflow "
                  f"{res.overflow}, residual {res.residual}")
            return dict(rounds=res.rounds, zeta_equal_single_device=True)

        kill_and_resume(
            "counts", lambda d: counts(c["kill_shards"], d,
                                       fail_at=[c["kill_at"]],
                                       max_restarts=0),
            lambda p, d: counts(p, d, resume=True), c["targets"],
            ["multinomial_rows", "segment_spmv"], counts_gate,
            shards=c["kill_shards"], round=c["kill_at"])

        # ---- walks, the launcher's walk engine, doc_link_graph(2^20) ----
        w = ELASTIC_WALKS

        def walks_gate(p, res):
            pi, res = res
            check(res.state.dropped == 0 and res.restarts == 0,
                  f"walks resumed at P={p}: dropped {res.state.dropped}, "
                  f"restarts {res.restarts}")
            l1, top = accuracy(f"walks resumed at P={p}", pi, pi_ref, g.n)
            return dict(rounds=res.rounds, l1=l1, top10=top,
                        cap=int(res.state.pos.shape[1]),
                        zeta_sum=int(res.state.zeta.sum(dtype=torch.int64)))

        probe.check_relayout = check_walk_relayout
        for kill_at, targets in w["kills"].items():
            kill_and_resume(
                f"walks_round{kill_at}", lambda d: run_walks(
                    g, EPS, K_walk, d, [kill_at], 0,
                    mesh=StackedMesh(w["kill_shards"], g.device),
                    max_restarts=0),
                lambda p, d: run_walks(g, EPS, K_walk, d, [], 0,
                                       resume=True,
                                       mesh=StackedMesh(p, g.device)),
                targets, ["walk_step", "histogram"], walks_gate,
                shards=w["kill_shards"], round=kill_at, K=K_walk)
        probe.check_relayout = None

        # ---- Algorithm 2 killed mid-Phase 2, erdos_renyi(2^15, 8) ----
        a = ELASTIC_IMPROVED
        g2 = erdos_renyi(N_ELASTIC_IMPROVED, 8.0, seed=0)
        K2 = walks_per_node_for(g2.n, EPS)

        def improved(shards, **kw):
            return distributed_improved_pagerank(
                g2, EPS, K2, prng.PRNGKey(0),
                mesh=StackedMesh(shards, g2.device),
                eta_safety=a["eta_safety"], **kw)

        ref, secs, _ = drive(f"elastic improved: unfailed P="
                             f"{a['kill_shards']}",
                             lambda: improved(a["kill_shards"]), three)
        check(ref.tail_walks == 0 and ref.dropped == 0,
              f"improved at eta_safety {a['eta_safety']}: {ref.tail_walks} "
              f"tail walks, {ref.dropped} dropped (a resume is bit-exact "
              f"only with an empty tail)")
        mid_p2 = (ref.phase1_rounds + ref.report_rounds
                  + max(ref.phase2_rounds // 2, 1))

        def improved_gate(p, res):
            check(torch.equal(res.zeta, ref.zeta)
                  and np.array_equal(res.pi, ref.pi)
                  and res.tail_walks == 0 and res.restarts == 0
                  and res.rounds == ref.rounds,
                  f"improved resumed at P={p}: not bit-equal to the "
                  f"unfailed P={a['kill_shards']} run")
            return dict(rounds=res.rounds, bit_equal=True)

        # snapshots only at round 0 and mid-Phase 2, and at a resume only
        # the re-anchor and the final state: each is GBs
        kill_and_resume(
            "improved", lambda d: improved(
                a["kill_shards"], checkpoint_dir=d, fail_at=[mid_p2],
                checkpoint_every=mid_p2, max_restarts=0),
            lambda p, d: improved(p, checkpoint_dir=d, resume=True,
                                  checkpoint_every=10 ** 6),
            a["targets"], three, improved_gate,
            resume_kernels=["histogram", "segment_spmv"],
            kill_check=stage_check(mid_p2, "phase2"),
            shards=a["kill_shards"], round=mid_p2, n=g2.n, K=K2,
            S=ref.coupons_created, unfailed_s=secs, rounds=ref.rounds)
        del ref, g2
        torch.cuda.empty_cache()

        # ---- Section 5 killed in keyed Phase 1, doc_link_graph(2^12) ----
        s = ELASTIC_DIRECTED
        g3 = doc_link_graph(N_ELASTIC_DIRECTED, seed=0)
        K3 = walks_per_node_for(g3.n, EPS)
        pi3 = power_iteration(g3, EPS, tol=1e-7,
                              max_iters=1000)[0].cpu().numpy()

        def directed(shards, d, **kw):
            return distributed_directed_pagerank(
                g3, EPS, K3, prng.PRNGKey(0),
                mesh=StackedMesh(shards, g3.device), checkpoint_dir=d, **kw)

        def directed_gate(p, res):
            check(res.restarts == 0 and res.shards == p,
                  f"directed resumed at P={p}: restarts {res.restarts}")
            return three_phase_checks(f"directed resumed at P={p}", res,
                                      g3.n, K3, pi3)

        kill_and_resume(
            "directed", lambda d: directed(
                s["kill_shards"], d, fail_at=[s["kill_at"]],
                checkpoint_every=s["every"], max_restarts=0),
            lambda p, d: directed(p, d, resume=True,
                                  checkpoint_every=10 ** 6),
            s["targets"], three, directed_gate,
            kill_check=stage_check(s["kill_at"] // s["every"] * s["every"],
                                   "phase1"),
            shards=s["kill_shards"], round=s["kill_at"], n=g3.n, K=K3)
        del g3

        elastic_card_vs_cpu()
    finally:
        shutil.rmtree(ELASTIC_DIR, ignore_errors=True)
    return out


def elastic_card_vs_cpu():
    """The port's own kills at P=8 resumed at P=3 on small graphs, on the
    card and on the CPU: counts, improved (mid-Phase 2), directed (keyed
    Phase 1) and the launcher's walk engine, each bit-equal across the
    two."""
    from repro_torch import prng
    from repro_torch.core.collectives import StackedMesh
    from repro_torch.core.distributed_counts import \
        distributed_pagerank_counts
    from repro_torch.core.distributed_directed import \
        distributed_directed_pagerank
    from repro_torch.core.distributed_improved import \
        distributed_improved_pagerank
    from repro_torch.graphs import directed_web, erdos_renyi
    from repro_torch.launch.pagerank import run_walks

    def engine_run(engine, K, seed, **kw):
        def run(g, d, shards, **more):
            r = engine(g, 0.25, K, prng.PRNGKey(seed),
                       mesh=StackedMesh(shards, g.device), checkpoint_dir=d,
                       checkpoint_every=2, **kw, **more)
            return (r.zeta.cpu().tolist(), r.rounds, r.restarts, r.shards,
                    [float(x) for x in r.pi])
        return run

    def walks_run(g, d, shards, fail_at=(), resume=False, **more):
        pi, r = run_walks(g, 0.25, 16, d, list(fail_at), 0, resume=resume,
                          mesh=StackedMesh(shards, g.device), **more)
        return pi.tolist(), r.rounds, r.restarts, int(r.state.dropped)

    # tests/test_torch_elastic.py's cases (eps 0.25): graph, run, kill round
    # (improved: mid-Phase 2; directed: keyed Phase 1; walks: round 10's
    # snapshot)
    er64 = erdos_renyi(64, 5.0, seed=1, device="cpu")
    er96 = erdos_renyi(96, 5.0, seed=1, device="cpu")
    dweb = directed_web(64, 5.0, seed=3, device="cpu")
    cases = dict(
        counts=(er64, engine_run(distributed_pagerank_counts, 40, 2), 3),
        improved=(er96, engine_run(distributed_improved_pagerank, 40, 0,
                                   eta_safety=8.0), 9),
        directed=(dweb, engine_run(distributed_directed_pagerank, 20, 3), 1),
        walks=(dweb, walks_run, 11))
    for name, (g_cpu, run, kill_at) in cases.items():
        got = {}
        for dev in ("cuda", "cpu"):
            g = g_cpu.to(dev)
            d = str(ELASTIC_DIR / f"small_{name}_{dev}")
            _kill(lambda: run(g, d, 8, fail_at=[kill_at], max_restarts=0))
            got[dev] = run(g, d, 3, resume=True)
            shutil.rmtree(d)
        check(got["cuda"] == got["cpu"],
              f"small {name} killed at P=8, resumed at P=3: card and CPU "
              f"differ")
    log("elastic card vs CPU: counts, improved (mid-Phase 2), directed "
        "(keyed Phase 1) and walks killed at P=8 and resumed at P=3: "
        "card == CPU")


class PhaseCalls:
    """Within `capture()`, records how often each phase of a three-phase
    run calls `histogram` and `segment_spmv` through the routing layer,
    and keeps the inputs of each phase's first call of each, for timing
    at the engine's own shapes afterwards. Also splits the run's wall time
    by phase: a phase's time runs from its first round's entry (the card
    synchronised) to the next phase's."""

    PHASES = {"_p1_request": "phase1", "_p2_local": "phase2",
              "_p3_local": "phase3", "superstep": "tail"}

    def __init__(self):
        self.calls = {}           # (phase, kernel) -> [count, args, kw]
        self.phase = None
        self.seconds = {}
        self._since = None

    def _enter(self, phase):
        import torch
        torch.cuda.synchronize()
        now = time.perf_counter()
        if self.phase is not None:
            self.seconds[self.phase] = (self.seconds.get(self.phase, 0.0)
                                        + now - self._since)
        self.phase, self._since = phase, now

    def _record(self, kernel, args, kw):
        entry = self.calls.setdefault((self.phase, kernel), [0, args, kw])
        entry[0] += 1

    @contextmanager
    def capture(self):
        from repro_torch.core import distributed_improved as di
        from repro_torch.core import routing
        saved = {name: getattr(di, name) for name in self.PHASES}
        saved_kernels = routing.histogram, routing.segment_spmv

        def phase(name):
            def run(*args, **kw):
                self._enter(self.PHASES[name])
                return saved[name](*args, **kw)
            return run

        def kernel(name, fn):
            def run(*args, **kw):
                self._record(name, args, kw)
                return fn(*args, **kw)
            return run

        for name in self.PHASES:
            setattr(di, name, phase(name))
        routing.histogram = kernel("histogram", saved_kernels[0])
        routing.segment_spmv = kernel("segment_spmv", saved_kernels[1])
        try:
            yield self
            self._enter(None)
        finally:
            for name, fn in saved.items():
                setattr(di, name, fn)
            routing.histogram, routing.segment_spmv = saved_kernels


def phase_kernel_rows(calls):
    """Each phase's first histogram and segment sum of a three-phase run,
    timed: the kernel, its plain version and a one-call PyTorch yardstick,
    beside the bound of its bytes; each exact against its plain version."""
    import torch
    from repro_torch.kernels.histogram import histogram
    from repro_torch.kernels.histogram.ref import histogram_ref
    from repro_torch.kernels.segment_spmv import segment_spmv
    from repro_torch.kernels.segment_spmv.ref import (segment_spmv_ref,
                                                      segment_sum_int_ref)
    from repro_torch.kernels.segment_spmv.ops import F32_EXACT_MAX

    out = {}
    for (phase, kernel), (count, args, kw) in sorted(calls.items()):
        if kernel == "histogram":
            ids, n = args
            W = ids.numel()
            got, want = histogram(ids, n), histogram_ref(ids, n)
            err = int((got - want).abs().max()) if n else 0
            del got, want
            shifted = ids + 1
            row = dict(
                ms=cuda_ms(lambda: histogram(ids, n), 5),
                plain_ms=cuda_ms(lambda: histogram_ref(ids, n), 1),
                library_ms=cuda_ms(lambda: torch.bincount(
                    shifted, minlength=n + 1), 1),
                shape=f"W={W} ids, n={n}", **bound(4 * W + 4 * n))
            del shifted
        else:
            values, dst, n = args
            cb = kw.get("count_bound")
            wide = cb is not None and int(cb) > F32_EXACT_MAX
            plain = segment_sum_int_ref if wide else segment_spmv_ref
            got = segment_spmv(values, dst, n, count_bound=cb)
            want = plain(values if wide else values.float(), dst, n)
            err = float((got.double() - want.double()).abs().max()) \
                if n else 0
            E = values.numel()
            spare = torch.where((dst >= 0) & (dst < n), dst, n)
            row = dict(
                ms=device_ms(lambda: segment_spmv(values, dst, n,
                                                  count_bound=cb), 10,
                             *SPMV_KERNELS),
                call_ms=cuda_ms(lambda: segment_spmv(values, dst, n,
                                                     count_bound=cb), 10),
                plain_ms=cuda_ms(lambda: plain(values if wide
                                               else values.float(), dst, n),
                                 2),
                library_ms=cuda_ms(lambda: torch.zeros(
                    n + 1, dtype=torch.int32, device=dst.device).index_add_(
                        0, spare, values), 5),
                shape=f"E={E}, n={n}, integer entry {wide}",
                **bound(8 * E + 4 * n))
            del spare
        check(err == 0, f"{phase} {kernel}: differs from its plain version "
                        f"by {err}")
        row.update(launches=count, max_abs_err=err)
        out[f"{phase} {kernel}"] = row
        log(f"{phase} {kernel}: PASS, exact; {row}")
    return out


def three_phase_checks(label, res, n, K, pi_ref, *, probe=False,
                       gate_topk=True):
    """The three-phase engines' guards: nothing lost (residual, dropped),
    every walk accounted for through Phase 2, coupons used at most once,
    total visits near n*K/eps, Phase 1 within lam rounds and Phase 3 one
    exchange, and the accuracy policy (`accuracy`). Returns the run's
    summary."""
    check(res.residual == 0 and res.dropped == 0,
          f"{label}: residual {res.residual}, dropped {res.dropped}")
    active = n * K
    for t, rec in enumerate(res.phase2_records):
        active -= rec["terminated"] + rec["exhausted"]
        check(rec["active"] == active,
              f"{label}: phase-2 record {t} breaks conservation: {rec}")
    check(active == 0, f"{label}: {active} walks left after phase 2")
    check(res.terminated_by_coupon + res.tail_walks == n * K
          and res.tail_walks == res.exhausted_walks,
          f"{label}: terminated {res.terminated_by_coupon} + tail "
          f"{res.tail_walks} != n*K, or tail != exhausted "
          f"{res.exhausted_walks}")
    stitched = sum(r["stitched"] for r in res.phase2_records)
    check(stitched == res.coupons_used <= res.coupons_created,
          f"{label}: stitched {stitched}, used {res.coupons_used}, created "
          f"{res.coupons_created}")
    if probe:
        check(res.coupons_used == res.coupons_created and res.tail_walks > 0,
              f"{label}: the probe did not exhaust the pools")
    expect = n * K / EPS
    check(abs(res.total_visits - expect) / expect < 0.07,
          f"{label}: {res.total_visits} visits, expected ~{expect:.0f}")
    check(res.phase1_rounds <= res.lam and res.phase3_rounds == 1,
          f"{label}: phase-1 rounds {res.phase1_rounds} (lam {res.lam}), "
          f"phase-3 rounds {res.phase3_rounds}")
    l1, top = accuracy(label, res.pi, pi_ref, n, gate_topk=gate_topk)
    return dict(
        rounds=res.rounds, phase1=res.phase1_rounds, phase2=res.phase2_rounds,
        phase3=res.phase3_rounds, tail=res.tail_rounds, lam=res.lam,
        eta=res.eta, K=K, wire=res.a2a_bytes_by_phase,
        entries=res.a2a_entries_by_site, created=res.coupons_created,
        used=res.coupons_used, exhausted=res.exhausted_walks,
        tail_walks=res.tail_walks, waited=res.waited,
        sampler_s=res.sampler_us / 1e6,
        sampler_ms_a_round=res.sampler_us / 1e3 / max(res.phase1_rounds, 1),
        occupancy=list(res.p1_occupancy), l1=l1, top10=top)


def phase1_cells_check(g, K):
    """The fused sampler's dense-cell mode at the Phase-1 shape of the
    P=4 run on `g`: P x P x n_loc (home, vertex) rows of the first round,
    each owner under its first round key, against its plain version on the
    card and against scatter_cells of the per-bucket round; timed."""
    import math
    import torch
    from repro_torch import prng
    from repro_torch.core import aggregate_sampler as agg
    from repro_torch.core.distributed_improved import plan_three_phase
    from repro_torch.core.improved_pagerank import coupon_pool_sizes
    from repro_torch.kernels.multinomial_rows import multinomial_buckets
    from repro_torch.kernels.multinomial_rows.ref import \
        multinomial_buckets_ref

    P, dev = 4, g.device
    lam = max(1, math.ceil(math.sqrt(math.log(g.n))))
    _, pool = coupon_pool_sizes(g, EPS, K, lam)
    plan = plan_three_phase(g, P, pool, K)
    n_loc, md, lay = plan.n_loc, plan.md, plan.layout
    n_pad = P * n_loc
    # the first round: every coupon at its own vertex, home = owner
    c = torch.zeros((P, P, n_loc), dtype=torch.int32, device=dev)
    psize = torch.from_numpy(plan.psize_sh).to(torch.int32).to(dev)
    for p in range(P):
        c[p, p] = psize[p]
    c = c.reshape(P, n_pad)
    _, k1, _ = prng.split(prng.PRNGKey(0), 3)
    keys = torch.stack([prng.split(k, 3)[1] for k in prng.split(k1, P)])
    deg_row = plan.sg.out_deg.repeat(1, P)
    rid = torch.arange(P * n_pad, dtype=torch.int32, device=dev)
    perm = torch.from_numpy(plan.rows_perm).to(dev)
    args = (c.reshape(-1), deg_row.reshape(-1), rid, keys, perm,
            plan.rows_layout.widths, plan.rows_layout.caps)

    def kernel():
        return multinomial_buckets(*args, eps=EPS, shards=P, cells=md)

    def plain():
        return multinomial_buckets_ref(*args, eps=EPS, shards=P, cells=md)

    lay_t = lay.tile(P)
    offs = torch.arange(P, device=dev).reshape(P, 1) * n_loc
    perms = []
    for p in range(P):
        bp = torch.from_numpy(plan.bperm_np[p]).to(dev)
        perms.append(torch.cat([
            torch.where(bp[None, s:s + cap] < 0, -1,
                        offs + bp[None, s:s + cap]).reshape(-1)
            for s, cap in zip(lay.row_starts, lay.caps)]).to(torch.int32))

    def per_bucket():
        return torch.cat([agg.scatter_cells(agg.sample_buckets(
            c[p], deg_row[p], rid[p * n_pad:(p + 1) * n_pad],
            tuple(keys[p].to(torch.int64).tolist()), perms[p], lay_t,
            eps=EPS)[0], lay_t, md) for p in range(P)])

    got, want, old = kernel(), plain(), per_bucket()
    diff = int((got[0] != want[0]).sum())
    check(diff == 0 and torch.equal(got[0], old),
          f"multinomial_buckets cells: {diff} cells differ from its plain "
          f"version, or it differs from scatter_cells(sample_buckets())")
    check(torch.equal(got[1], want[1]) and int(got[2]) == int(want[2]) == 0,
          "multinomial_buckets cells: occupancy or residual differ")
    cells = want[0].reshape(-1, md + 1)
    cr, dr = c.reshape(-1), deg_row.reshape(-1)
    check(torch.equal(cells.sum(1), cr), "cells: a row's cells do not sum "
                                         "to its count")
    rem = cr[:, None] - cells[:, 0:1] - torch.cumsum(cells[:, 1:], 1) \
        + cells[:, 1:]
    slot = torch.arange(md, device=dev)[None, :]
    draws = int(((cr > 0) & (dr > 0)).sum()) \
        + int(((rem > 0) & (slot < dr[:, None])).sum())
    rows = cr.numel()
    row = dict(
        ms=device_ms(kernel, 10, "multinomial_buckets_kernel"),
        call_ms=cuda_ms(kernel, 10), plain_ms=cuda_ms(plain, 1),
        per_bucket_round_ms=cuda_ms(per_bucket, 2), library_ms=None,
        max_abs_err=diff, launches_a_round=1,
        shape=f"{perm.numel()} slots, {rows} rows (P={P} owners x {P} homes "
              f"x n_loc={n_loc}), md={md}, {len(lay.caps)} buckets, "
              f"{draws} draws",
        **bound(4 * perm.numel() + 12 * rows + 4 * rows * (md + 1),
                MN_OPS_PER_DRAW * draws))
    log(f"multinomial_buckets, dense cells (phase 1): PASS, exact (0 of "
        f"{got[0].numel()} cells differ from its plain version on the card "
        f"and from scatter_cells(sample_buckets())); {row}")
    return row


def three_phase_path(drive, sharded_rounds):
    """Algorithm 2 and Section 5 at full width on the card: the sharded
    three-phase engine at P=4 on erdos_renyi(2^20, 8) beside the sharded
    count engine (Algorithm 1) on the same graph, once more with each
    phase's kernel calls captured and timed at their shapes; the dense-cell
    sampler at that run's Phase-1 shape; the single-device engine on
    erdos_renyi(2^19, 8) beside Algorithm 1's count engine; both Section-5
    engines on doc_link_graph(2^14); and an eta=1 probe whose walks fall
    back to the tail, which launches walk_step."""
    import torch
    from repro_torch import prng
    from repro_torch.analysis.congest import RecordingMesh
    from repro_torch.core import (directed_local_pagerank, improved_pagerank,
                                  power_iteration, simple_pagerank,
                                  walks_per_node_for)
    from repro_torch.core.collectives import StackedMesh
    from repro_torch.core.distributed_counts import \
        distributed_pagerank_counts
    from repro_torch.core.distributed_directed import \
        distributed_directed_pagerank
    from repro_torch.core.distributed_improved import \
        distributed_improved_pagerank
    from repro_torch.graphs import doc_link_graph, erdos_renyi

    out = {}
    three = ["histogram", "segment_spmv", "multinomial_rows"]

    def oracle(g, label):
        (pi, _, iters), secs, _ = drive(
            f"power_iteration[{label}]",
            lambda: power_iteration(g, EPS, tol=1e-7, max_iters=1000),
            ["segment_spmv"])
        return pi.cpu().numpy()

    def report(label, res, secs, peak, summary):
        summary.update(seconds=secs, peak_gib=peak)
        out[label] = summary
        log(f"{label}: {summary}")

    # ---- Algorithm 2, sharded, P=4, erdos_renyi(2^20, 8) ----
    t0 = time.perf_counter()
    g = erdos_renyi(N, 8.0, seed=0)
    K = walks_per_node_for(g.n, EPS)
    log(f"graph: erdos_renyi({N}, 8) n={g.n} m={g.m} max_out_deg="
        f"{g.max_out_deg} in {time.perf_counter() - t0:.2f} s; K={K}")
    pi_ref = oracle(g, f"erdos_renyi({g.n})")
    mesh = StackedMesh(4, g.device)
    res, secs, peak = drive(
        f"distributed_pagerank_counts[erdos_renyi({g.n}), P=4]",
        lambda: distributed_pagerank_counts(g, EPS, K, prng.PRNGKey(0),
                                            mesh=mesh, packed=False),
        ["multinomial_rows", "segment_spmv"])
    l1, top = accuracy("counts on erdos_renyi", res.pi, pi_ref, g.n)
    out["alg1 counts P=4, erdos_renyi"] = dict(
        seconds=secs, rounds=res.rounds, l1=l1, top10=top, peak_gib=peak)
    del res
    torch.cuda.empty_cache()

    def improved():
        return distributed_improved_pagerank(g, EPS, K, prng.PRNGKey(0),
                                             mesh=mesh)

    res, secs, peak = drive("distributed_improved_pagerank[P=4]", improved,
                            three)
    report("improved P=4, erdos_renyi", res, secs, peak,
           three_phase_checks("improved P=4", res, g.n, K, pi_ref))
    zeta = res.zeta
    del res
    torch.cuda.empty_cache()
    log(f"rounds: Algorithm 2 (P=4) "
        f"{out['improved P=4, erdos_renyi']['rounds']} against "
        f"Algorithm 1's count engine "
        f"{out['alg1 counts P=4, erdos_renyi']['rounds']} on erdos_renyi("
        f"{g.n}) and {sharded_rounds} on doc_link_graph({N})")

    # the same run with each phase's kernel calls captured, then timed,
    # and its exchanges recorded for the full-width wire audit
    rec = RecordingMesh(4, g.device, lints=False)
    calls = PhaseCalls()
    with calls.capture():
        again = distributed_improved_pagerank(g, EPS, K, prng.PRNGKey(0),
                                              mesh=rec)
    check(torch.equal(again.zeta, zeta), "improved P=4: a second run with "
                                         "the same key differs")
    three_phase_checks("improved P=4 (recorded)", again, g.n, K, pi_ref)
    out["improved P=4, erdos_renyi"]["audit"] = full_width_audit(
        "improved P=4, erdos_renyi", "improved", g, K, rec, again)
    del rec
    hist_calls = {phase: entry[0] for (phase, kernel), entry
                  in calls.calls.items() if kernel == "histogram"}
    log(f"improved P=4: wall seconds by phase (a second run, the card "
        f"synchronised at each phase's rounds): "
        f"{ {k: round(v, 3) for k, v in calls.seconds.items()} }; "
        f"histogram calls by phase {hist_calls}")
    out["improved P=4, erdos_renyi"]["phase_seconds"] = calls.seconds
    del again, zeta
    torch.cuda.empty_cache()
    phase_rows = phase_kernel_rows(calls.calls)
    del calls
    torch.cuda.empty_cache()
    cells_row = phase1_cells_check(g, K)
    del g, mesh
    torch.cuda.empty_cache()

    # ---- Algorithm 2, single device, erdos_renyi(2^19, 8) ----
    g = erdos_renyi(N_SINGLE_IMPROVED, 8.0, seed=0)
    K2 = walks_per_node_for(g.n, EPS)
    pi_ref = oracle(g, f"erdos_renyi({g.n})")
    res, secs, peak = drive(
        f"simple_pagerank[counts, erdos_renyi({g.n})]",
        lambda: simple_pagerank(g, EPS, engine="counts", traced=True),
        ["multinomial_rows", "segment_spmv"])
    out["alg1 counts single-device, erdos_renyi"] = dict(
        seconds=secs, rounds=res.logical_rounds, peak_gib=peak)
    del res
    res, secs, peak = drive(f"improved_pagerank[erdos_renyi({g.n})]",
                            lambda: improved_pagerank(g, EPS), ["histogram"])
    l1, top = accuracy("improved single-device", res.pi, pi_ref, g.n)
    expect = g.n * K2 / EPS
    visits = int(res.zeta.sum(dtype=torch.int64))
    check(abs(visits - expect) / expect < 0.07
          and res.coupons_used <= res.coupons_created,
          f"improved single-device: {visits} visits, expected ~{expect:.0f}, "
          f"or more coupons used than created")
    report("improved single-device, erdos_renyi", res, secs, peak, dict(
        rounds=res.logical_rounds, phase1=res.phase1_rounds,
        phase2=res.phase2_rounds, phase3=res.phase3_rounds,
        tail=res.tail_rounds, lam=res.lam, eta=res.eta, K=K2,
        created=res.coupons_created, used=res.coupons_used,
        exhausted=res.exhausted_walks, l1=l1, top10=top))
    del res, g
    torch.cuda.empty_cache()

    # ---- Section 5, doc_link_graph(2^14): sharded P=4 and single device --
    g = doc_link_graph(N_DIRECTED, seed=0)
    K3 = walks_per_node_for(g.n, EPS)
    pi_ref = oracle(g, f"doc_link_graph({g.n})")
    res, secs, peak = drive(
        f"distributed_pagerank_counts[doc_link_graph({g.n}), P=4]",
        lambda: distributed_pagerank_counts(
            g, EPS, K3, prng.PRNGKey(0), mesh=StackedMesh(4, g.device),
            packed=False),
        ["multinomial_rows", "segment_spmv"])
    out["alg1 counts P=4, doc_link_graph"] = dict(
        seconds=secs, rounds=res.rounds, peak_gib=peak)
    del res
    res, secs, peak = drive(
        "distributed_directed_pagerank[P=4]",
        lambda: distributed_directed_pagerank(
            g, EPS, K3, prng.PRNGKey(0), mesh=StackedMesh(4, g.device)),
        three)
    summary = three_phase_checks("directed P=4", res, g.n, K3, pi_ref)
    summary.update(uniform_budget=res.uniform_budget,
                   dangling=res.dangling_nodes)
    report("directed P=4, doc_link_graph", res, secs, peak, summary)
    del res
    torch.cuda.empty_cache()
    res, secs, peak = drive(f"directed_local_pagerank[doc_link_graph({g.n})]",
                            lambda: directed_local_pagerank(g, EPS),
                            ["histogram"])
    l1, top = accuracy("directed single-device", res.pi, pi_ref, g.n)
    report("directed single-device, doc_link_graph", res, secs, peak,
           dict(rounds=res.logical_rounds, phase1=res.phase1_rounds,
                phase2=res.phase2_rounds, tail=res.tail_rounds, lam=res.lam,
                eta=res.eta, K=K3, created=res.coupons_created,
                used=res.coupons_used, exhausted=res.exhausted_walks, l1=l1,
                top10=top))
    del res, g
    torch.cuda.empty_cache()

    # ---- the exhaustion probe: eta=1, erdos_renyi(2^16, 8), P=4 ----
    g = erdos_renyi(N_PROBE, 8.0, seed=0)
    K4 = walks_per_node_for(g.n, EPS)
    pi_ref = oracle(g, f"erdos_renyi({g.n})")
    res, secs, peak = drive(
        "distributed_improved_pagerank[eta=1, P=4]",
        lambda: distributed_improved_pagerank(
            g, EPS, K4, prng.PRNGKey(0), mesh=StackedMesh(4, g.device),
            eta=1), three + ["walk_step"])
    report("probe eta=1 P=4, erdos_renyi", res, secs, peak,
           three_phase_checks("probe eta=1", res, g.n, K4, pi_ref,
                              probe=True))
    del res, g
    torch.cuda.empty_cache()
    return out, phase_rows, cells_row


def uniform_phase(W, dev):
    """The uniform kernel at the walk engine's draw, W = n*K float32:
    bit-equal to its plain version on the card, and at 2^20 draws to the
    plain version on the CPU; timed against its bound and the plain
    version. The kernel computes the counter's high word as the plain
    version does, but no check reaches it: a draw of 2^32 elements would
    need over 100 GB of the plain version's int64 temporaries."""
    import torch
    from repro_torch import prng
    from repro_torch.kernels.uniform import uniform
    from repro_torch.kernels.uniform.ref import uniform_ref

    key = prng.PRNGKey(11)
    got = uniform(key, (W,), device=dev)
    want = uniform_ref(key, (W,), device=dev)
    diff = int((got.view(torch.int32) != want.view(torch.int32)).sum())
    check(diff == 0, f"uniform: {diff} of {W} draws differ from its plain "
                     f"version on the card")
    err = float((got - want).abs().max())
    del got, want
    small = 1 << 20
    host = uniform_ref(key, (small,))
    check(torch.equal(uniform(key, (small,), device=dev).cpu().view(
        torch.int32), host.view(torch.int32)),
        "uniform: 2^20 draws differ from the plain version on the CPU")
    del host
    row = dict(
        ms=device_ms(lambda: uniform(key, (W,), device=dev), 10,
                     "uniform_kernel"),
        call_ms=cuda_ms(lambda: uniform(key, (W,), device=dev), 10),
        plain_ms=cuda_ms(lambda: uniform_ref(key, (W,), device=dev), 2),
        library_ms=None, max_abs_err=err,
        torch_rand_ms=cuda_ms(lambda: torch.rand(W, device=dev), 10),
        shape=f"{W} float32 draws",
        **bound(4 * W, THREEFRY_OPS_PER_DRAW * W))
    log(f"uniform: PASS, {W} draws bit-equal to the plain version on the "
        f"card, and 2^20 to it on the CPU; {row} (torch.rand, another "
        f"generator and so not the same function, for scale only)")
    return row


def ppr_queries(n, count, seed=0):
    """Queries drawn as the launch CLI's run_ppr draws them: 1-3 distinct
    uniform sources each, no weights."""
    import numpy as np
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        k = int(rng.integers(1, 4))
        out.append((rng.choice(n, size=k, replace=False), None))
    return out


def ppr_oracle(g, queries, tol=1e-7, max_iters=1000):
    """Personalized power iteration of every query at once, through the
    port's segment_spmv push: x <- eps s + (1-eps) Q^T x until every
    query's L1 change is under `tol`. With no dangling vertex this is the
    system exact_ppr solves densely. Returns [len(queries), n] float64 on
    the host."""
    import numpy as np
    import torch
    from repro_torch.kernels.segment_spmv import hot_list, segment_spmv

    check(int((g.out_deg == 0).sum()) == 0,
          "the PPR oracle needs a graph without dangling vertices")
    n, dev, nq = g.n, g.device, len(queries)
    s = torch.zeros((nq, n), dtype=torch.float32, device=dev)
    for q, (src, w) in enumerate(queries):
        w = np.full(len(src), 1.0 / len(src)) if w is None else \
            np.asarray(w, dtype=np.float64) / np.sum(w)
        s[q, torch.as_tensor(np.asarray(src), device=dev).long()] = \
            torch.as_tensor(w, dtype=torch.float32, device=dev)
    src_e = g.edge_src()
    deg_e = g.out_deg.float().index_select(0, src_e)
    off = torch.arange(nq, dtype=torch.int32, device=dev)[:, None] * n
    dst = (off + g.col_idx[None, :]).reshape(-1)
    hot = hot_list(dst, nq * n)
    x, it, err = s.clone(), 0, float("inf")
    while err > tol and it < max_iters:
        y = segment_spmv((x[:, src_e.long()] / deg_e).reshape(-1), dst,
                         nq * n, hot=hot).reshape(nq, n)
        x_new = EPS * s + (1 - EPS) * y
        err = float((x_new - x).abs().sum(dim=1).max())
        x, it = x_new, it + 1
    log(f"ppr oracle: {nq} queries, {it} iterations, largest final L1 "
        f"change {err:.3e} (tol {tol}, converged {err <= tol})")
    return x.double().cpu().numpy()


def ppr_accuracy(label, est, ref, walks):
    """A PPR estimate against its oracle: total visits within 2% of
    walks/eps (the estimate sums to visits * eps / walks), L1 < 0.15 and
    top-10 overlap >= 0.6."""
    import numpy as np
    from repro_torch.core import l1_error, normalized, topk_overlap
    est = np.asarray(est, dtype=np.float64)
    check(bool(np.isfinite(est).all()) and bool((est >= 0).all()),
          f"{label}: bad estimate")
    mass = float(est.sum())
    check(abs(mass - 1.0) < 0.02, f"{label}: visits {mass * walks / EPS:.0f}"
                                  f", expected ~{walks / EPS:.0f}")
    l1 = l1_error(normalized(est), normalized(ref))
    top = topk_overlap(est, ref)
    check(l1 < 0.15, f"{label}: L1 {l1} vs the PPR oracle")
    check(top >= 0.6, f"{label}: top-10 overlap {top}")
    return l1, top, mass


class PPRCalls:
    """Within `capture()`, keeps the inputs of the first call of each
    kernel that a batched PPR superstep makes through the routing layer
    (shard 0's walk_step, the virtual histogram, the received-lane sum),
    keyed as `PhaseCalls` keys them (phase "ppr"), and counts the calls."""

    NAMES = {"walk_step_keyed": "walk_step", "histogram": "histogram",
             "segment_spmv": "segment_spmv"}

    def __init__(self):
        self.calls = {}

    @contextmanager
    def capture(self):
        from repro_torch.core import routing
        saved = {name: getattr(routing, name) for name in self.NAMES}

        def wrap(name):
            def run(*args, **kw):
                entry = self.calls.setdefault(("ppr", self.NAMES[name]),
                                              [0, args, kw])
                entry[0] += 1
                return saved[name](*args, **kw)
            return run

        for name in self.NAMES:
            setattr(routing, name, wrap(name))
        try:
            yield self
        finally:
            for name, fn in saved.items():
                setattr(routing, name, fn)


def ppr_walk_step_row(count, args, kw):
    """walk_step (b) on one shard's buffer of a batched PPR superstep,
    exact against its plain version and timed beside its bound."""
    from repro_torch.kernels.walk_step import walk_step_keyed
    from repro_torch.kernels.walk_step.ref import walk_step_keyed_ref

    pos, alive, kt, ke, rp, ci, dg = args
    got = walk_step_keyed(*args, **kw)
    want = walk_step_keyed_ref(*args, **kw)
    err = max(int((a - b).abs().max()) for a, b in zip(got, want))
    check(err == 0, f"ppr walk_step: differs from its plain version by {err}")
    deg = dg.index_select(0, pos.long())
    draws = int((alive.bool() & (deg > 0)).sum()) + int(want[1].sum())
    del got, want, deg
    row = dict(
        ms=cuda_ms(lambda: walk_step_keyed(*args, **kw), 10),
        plain_ms=cuda_ms(lambda: walk_step_keyed_ref(*args, **kw), 2),
        library_ms=None, max_abs_err=err, launches=count,
        shape=f"one shard's cap = {pos.numel()} slots, "
              f"{int(alive.sum())} live, {draws} draws",
        **bound(16 * pos.numel() + 4 * (rp.numel() + ci.numel()
                                        + dg.numel()),
                THREEFRY_OPS_PER_DRAW * draws))
    log(f"ppr walk_step: PASS, exact; {row}")
    return row


def ppr_path(g, drive):
    """Personalized PageRank at full width on doc_link_graph(2^20): the
    batched engine at P=4 with 16 queries of 2^21 walks (the kernels of
    its first superstep timed at their shapes, one superstep profiled),
    the single-query engine on query 0, and the service answering 64
    requests on an injected clock with a resize from P=4 to P=2. Each
    query against the personalized power iteration."""
    import torch
    from repro_torch import prng
    from repro_torch.core.collectives import StackedMesh
    from repro_torch.core.personalized import personalized_pagerank
    from repro_torch.core.personalized_batch import (
        BatchedPPREngine, batched_personalized_pagerank)

    out = {}
    dev = g.device
    queries = ppr_queries(g.n, PPR_QUERIES)
    W = PPR_WALKS
    t0 = time.perf_counter()
    ref = ppr_oracle(g, queries)
    out["oracle_s"] = time.perf_counter() - t0
    out["queries"], out["oracle"] = queries, ref
    mesh = StackedMesh(4, dev)

    res, secs, peak = drive(
        "batched_personalized_pagerank[P=4]",
        lambda: batched_personalized_pagerank(g, EPS, queries, W,
                                              prng.PRNGKey(0), mesh=mesh),
        ["walk_step", "histogram", "segment_spmv"])
    check(res.dropped == 0 and res.admit_dropped == 0,
          f"batched PPR: dropped {res.dropped}, admit_dropped "
          f"{res.admit_dropped}")
    tr = res.active_trace
    check(all(b <= a for a, b in zip(tr, tr[1:])) and tr[-1] == 0,
          "batched PPR: live walks increased or did not reach 0")
    accs = [ppr_accuracy(f"batched PPR query {q}", res.ppr[q], ref[q], W)
            for q in range(len(queries))]
    out["batched"] = dict(
        seconds=secs, supersteps=res.rounds, shards=4, queries=len(queries),
        walks_per_query=W, a2a_entries=res.a2a_entries,
        a2a_bytes=res.a2a_bytes, dropped=res.dropped,
        admit_dropped=res.admit_dropped, peak_gib=peak,
        launches=dict(drive.last),
        worst_l1=max(a[0] for a in accs), worst_top10=min(a[1] for a in accs),
        mass_range=[min(a[2] for a in accs), max(a[2] for a in accs)])
    log(f"batched_personalized_pagerank[P=4]: {out['batched']}")
    del res
    torch.cuda.empty_cache()

    # the first superstep's kernels at their shapes, then one profiled
    # superstep (the second) of the same engine
    engine = BatchedPPREngine(g, EPS, num_slots=len(queries),
                              walks_per_query=W, mesh=mesh)
    key = prng.PRNGKey(0)
    engine.reset(prng.fold_in(key, 0xBA7C))
    for i, (src, w) in enumerate(queries):
        engine.admit(i, src, w, key=prng.fold_in(key, i))
    calls = PPRCalls()
    with calls.capture():
        engine.superstep()
    rows = phase_kernel_rows({k: v for k, v in calls.calls.items()
                              if k[1] != "walk_step"})
    rows["ppr walk_step"] = ppr_walk_step_row(*calls.calls[("ppr",
                                                            "walk_step")])
    del calls
    torch.cuda.empty_cache()
    profile_rounds(lambda _: engine.superstep(), None, 1,
                   "batched PPR, superstep 2 (profiled)",
                   groups={"walk_step": "walk_step_keyed_kernel",
                           "histogram": "histogram",
                           "segment_spmv": "segment_sum_kernel"})
    del engine
    torch.cuda.empty_cache()

    src0, w0 = queries[0]
    vec, secs, peak = drive(
        "personalized_pagerank[query 0]",
        lambda: personalized_pagerank(g, EPS, src0, W, key=prng.PRNGKey(0),
                                      weights=w0),
        ["uniform", "histogram"])
    l1, top, mass = ppr_accuracy("single-query PPR", vec.cpu().numpy(),
                                 ref[0], W)
    out["single"] = dict(seconds=secs, rounds=drive.last["histogram"],
                         walks=W, l1=l1, top10=top, mass=mass,
                         peak_gib=peak, launches=dict(drive.last))
    log(f"personalized_pagerank[query 0]: {out['single']}")
    del vec
    torch.cuda.empty_cache()

    out["service"] = drive("PPRService[P=4 -> 2]",
                           lambda: ppr_service_run(g, queries, ref),
                           ["walk_step", "histogram", "segment_spmv"])[0]
    return out, rows


def ppr_service_run(g, batch_queries, batch_ref):
    """The service at P=4: 16 slots of 2^21 walks answering 64 requests on
    an injected clock (one tick a superstep), 48 distinct queries and 16
    repeats of earlier ones; after 20 completions it resizes to P=2. Holds
    cached answers to their stored vectors and the first 16 queries (the
    batched run's) to the oracle."""
    import numpy as np
    from repro_torch import prng
    from repro_torch.core.collectives import StackedMesh
    from repro_torch.serve import PPRService, query_cache_key

    # the first 16 distinct queries are the batched run's
    distinct = ppr_queries(g.n, 48)
    rng = np.random.default_rng(1)
    repeats = [distinct[int(i)] for i in rng.choice(24, 16, replace=False)]
    # four distinct queries a tick for 12 ticks, then the repeats, two a
    # tick, from tick 100 on (after the first waves have completed)
    arrivals = [(t // 4, q) for t, q in enumerate(distinct)] + [
        (100 + t // 2, q) for t, q in enumerate(repeats)]
    svc = PPRService(g, EPS, slots=16, walks_per_query=PPR_WALKS,
                     mesh=StackedMesh(4, g.device), key=prng.PRNGKey(3))
    reqs, tick, resized_at = [], 0, None
    pending = sorted(arrivals, key=lambda a: a[0])
    while pending or svc.busy:
        while pending and pending[0][0] <= tick:
            _, (src, w) = pending.pop(0)
            reqs.append(svc.submit(src, w, now=float(tick)))
        svc.step(now=float(tick))
        tick += 1
        if resized_at is None and svc.stats.completed >= 20:
            svc.resize(shards=2)
            resized_at = tick
        check(tick < 2000, "service: requests still open after 2000 ticks")
    s = svc.stats
    check(s.dropped_walks == 0 and s.admit_dropped == 0 and s.rejected == 0,
          f"service: dropped {s.dropped_walks}, admit_dropped "
          f"{s.admit_dropped}, rejected {s.rejected}")
    check(all(r.done and r.result is not None for r in reqs),
          "service: a request did not complete")
    check(resized_at is not None and svc.engine.shards == 2,
          "service: no resize")
    # a cached answer is the vector stored by the latest completion of its
    # query before it was submitted
    computed = {}
    for r in reqs:
        if not r.cached:
            computed.setdefault((r.sources, r.weights), []).append(r)
    for r in reqs:
        if r.cached:
            before = [c for c in computed.get((r.sources, r.weights), [])
                      if c.t_done < r.t_submit]
            check(bool(before) and np.array_equal(
                r.result, max(before, key=lambda c: c.t_done).result),
                "service: a cached answer is not its stored vector")
    late = [r for r in reqs if not r.cached and r.t_done >= resized_at]
    check(len(late) > 0, "service: no request completed after the resize")
    for q, (src, w) in enumerate(batch_queries):
        ppr_accuracy(f"service query {q}",
                     computed[query_cache_key(src, w, g.n)][0].result,
                     batch_ref[q], PPR_WALKS)
    lat = np.asarray([r.latency for r in reqs])
    info = dict(
        requests=len(reqs), completed=s.completed, cache_hits=s.cache_hits,
        supersteps=s.supersteps, ticks=tick, resized_at_tick=resized_at,
        completed_after_resize=len(late),
        max_active_queries=s.max_active_queries, a2a_bytes=s.a2a_bytes,
        latency_supersteps_p50=float(np.percentile(lat, 50)),
        latency_supersteps_p99=float(np.percentile(lat, 99)),
        latency_computed_p50=float(np.percentile(
            [r.latency for r in reqs if not r.cached], 50)))
    log(f"PPRService[P=4 -> 2]: {info}")
    return info


def full_width_audit(label, engine, g, K, rec, res, **spec_kw):
    """A full-width run recorded by `rec` against its engine's spec at that
    size, with no lints: every program call (site count and order, no site
    twice, payloads exact, psums at most 256 B), count-class lanes within
    their W-free budget, nothing unscoped, and the telemetry bytes equal to
    entries x width. Walk-class sites are held to their runtime lanes
    (payload and telemetry only: their W-scaling is by design). Returns
    a summary: per site the lanes (a walk-class site's at runtime), budget
    and recorded bytes a shard, and where the run's telemetry gives it per
    round, the most entries of a round over all shards (Phase 1's request
    and reply together)."""
    import numpy as np
    from repro_torch.analysis.congest import (audit_engine_spec, spec_for,
                                              telemetry_checks, walk_lanes)
    spec = spec_for(engine, g, rec, eps=EPS, K=K, **spec_kw)
    runtime = walk_lanes(engine, g, rec.shards, K)
    entry = audit_engine_spec(spec, rec.calls, unscoped=rec.unscoped,
                              walk_lanes=runtime, lints=False)
    checks = telemetry_checks(engine, res, spec)
    check(not entry["violations"],
          f"{label}: wire audit violations {entry['violations']}")
    check(all(c["ok"] for c in checks), f"{label}: telemetry {checks}")
    most = {}
    if engine in ("improved", "directed"):
        traces = [t.messages for t in res.report.traces]
        bounds = np.cumsum([0, res.phase1_rounds, res.phase2_rounds,
                            res.phase3_rounds, res.tail_rounds])
        for i, name in enumerate(("phase1", "phase2", "phase3", "tail")):
            part = traces[bounds[i]:bounds[i + 1]]
            most[name] = max(part) if part else 0
    sites = {}
    for row in entry["sites"]:
        sites[row["site"]] = dict(
            lanes=runtime.get(row["site"], row["lane_entries"]),
            budget=row["budget_entries"],
            recorded_bytes=row["recorded_payload_bytes"],
            wire_class=row["wire_class"],
            most_entries_a_round=most.get(row["stage"]))
    summary = dict(program_calls=len(rec.calls), sites=sites,
                   psums_a_call=entry["psum_sites"],
                   psum_max_bytes=entry["psum_max_bytes"],
                   telemetry=[(c["name"], c["runtime_bytes"], c["entries"])
                              for c in checks], violations=0)
    log(f"audit {label}: PASS; {summary}")
    return summary


def audit_path(g, K, drive, pi_ref, ppr_out):
    """The CONGEST wire audit on the card. The fixture audit of the five
    engines at 8 stacked shards, with its lints and the JAX gate's resume
    classes; then, on doc_link_graph(2^20) relabelled by
    degree_balanced_relabel(g, 4), the sharded count engine at P=4
    (unpacked lanes) and the batched PPR engine at P=4 (16 queries x 2^21
    walks), each recorded and held to its spec at full width, with the
    guards of its earlier phase (estimates mapped back through the
    permutation). Sharded Algorithm 2 is recorded in `three_phase_path`."""
    import numpy as np
    import torch
    from repro_torch import prng
    from repro_torch.analysis.congest import (RecordingMesh,
                                              audit_all_engines,
                                              format_wire_table)
    from repro_torch.core.distributed_counts import \
        distributed_pagerank_counts
    from repro_torch.core.personalized_batch import \
        batched_personalized_pagerank
    from repro_torch.graphs.partition import (degree_balanced_relabel,
                                              shard_load_stats)
    from repro_torch.kernels import common

    out = {}
    rep, secs, _ = drive("audit_all_engines[8 shards]", audit_all_engines,
                         list(common.launches))
    log(format_wire_table(rep))
    eng = rep["engines"]
    check(rep["ok"] and rep["violations_total"] == 0,
          f"fixture audit: {rep['violations_total']} violations: "
          f"{[v for e in eng.values() for v in e['violations']]}")
    check(sorted(eng) == ["counts", "directed", "improved", "ppr", "walks"]
          and all(e["telemetry"]["ok"] and e["w_independent"]
                  for e in eng.values()),
          "fixture audit: an engine missing, telemetry off or W-bound")
    resume = {k: e["resume"] for k, e in eng.items()}
    check(resume["counts"]["counts"] == "bit-exact (replicated key)"
          and resume["improved"]["phase2"] == resume["improved"]["phase3"]
          == resume["directed"]["phase2"] == "bit-exact (RNG-free)"
          and all(r.startswith("statistical") for r in (
              resume["improved"]["phase1"], resume["walks"]["walks"],
              resume["ppr"]["serve"])),
          f"fixture audit: resume classes {resume}")
    out["fixture"] = dict(seconds=secs, shards=rep["devices"],
                          rows=sum(len(e["sites"]) for e in eng.values()),
                          notes=sum(len(e["notes"]) for e in eng.values()))
    log(f"fixture audit: PASS {out['fixture']}; resume {resume}")

    t0 = time.perf_counter()
    before = shard_load_stats(g, 4)
    g4, perm = degree_balanced_relabel(g, 4)
    after = shard_load_stats(g4, 4)
    relabel_s = time.perf_counter() - t0
    check(g4.n == g.n and g4.m == g.m, "relabel: n or m changed")
    in_edges = [np.bincount(x.col_idx.cpu().numpy() // (x.n // 4),
                            minlength=4).tolist() for x in (g, g4)]
    out["relabel"] = dict(seconds=relabel_s, out_degree_before=before,
                          out_degree_after=after,
                          in_edges_before=in_edges[0],
                          in_edges_after=in_edges[1])
    log(f"degree_balanced_relabel(doc_link_graph({g.n}), 4): "
        f"{out['relabel']}")

    rec = RecordingMesh(4, g.device, lints=False)
    res, secs, peak = drive(
        "distributed_pagerank_counts[relabelled, P=4]",
        lambda: distributed_pagerank_counts(g4, EPS, K, prng.PRNGKey(0),
                                            mesh=rec, packed=False),
        ["multinomial_rows", "segment_spmv"])
    check(res.overflow == 0 and res.residual == 0,
          f"relabelled counts: overflow {res.overflow}, residual "
          f"{res.residual}")
    l1, top = accuracy("relabelled counts", res.pi[perm], pi_ref, g.n)
    out["counts"] = dict(
        seconds=secs, rounds=res.rounds, a2a_entries=res.a2a_entries_total,
        entries_a_round=res.a2a_entries_total / res.rounds,
        l1=l1, top10=top, peak_gib=peak,
        audit=full_width_audit("counts P=4, relabelled", "counts", g4, K,
                               rec, res, packed=False))
    log(f"relabelled counts P=4: {out['counts']}")
    del res, rec
    torch.cuda.empty_cache()

    queries, ref = ppr_out["queries"], ppr_out["oracle"]
    q4 = [(perm[np.asarray(src)], w) for src, w in queries]
    rec = RecordingMesh(4, g.device, lints=False)
    res, secs, peak = drive(
        "batched_personalized_pagerank[relabelled, P=4]",
        lambda: batched_personalized_pagerank(g4, EPS, q4, PPR_WALKS,
                                              prng.PRNGKey(0), mesh=rec),
        ["walk_step", "histogram", "segment_spmv"])
    check(res.dropped == 0 and res.admit_dropped == 0,
          f"relabelled PPR: dropped {res.dropped}, admit_dropped "
          f"{res.admit_dropped}")
    tr = res.active_trace
    check(all(b <= a for a, b in zip(tr, tr[1:])) and tr[-1] == 0,
          "relabelled PPR: live walks increased or did not reach 0")
    accs = [ppr_accuracy(f"relabelled PPR query {q}", res.ppr[q][perm],
                         ref[q], PPR_WALKS) for q in range(len(queries))]
    out["ppr"] = dict(
        seconds=secs, supersteps=res.rounds, a2a_entries=res.a2a_entries,
        a2a_entries_unrelabelled=ppr_out["batched"]["a2a_entries"],
        a2a_bytes=res.a2a_bytes, peak_gib=peak,
        worst_l1=max(a[0] for a in accs),
        worst_top10=min(a[1] for a in accs),
        audit=full_width_audit("batched PPR P=4, relabelled", "ppr", g4,
                               K, rec, res, num_slots=len(queries),
                               walks_per_query=PPR_WALKS))
    check(out["ppr"]["audit"]["sites"]["ppr"]["lanes"]
          == 4 * (g.n // 4) * len(queries),
          "relabelled PPR: lanes a shard are not P * n_loc * Q")
    log(f"relabelled batched PPR P=4: {out['ppr']}")
    del res, rec, g4
    torch.cuda.empty_cache()
    return out


def cli_phase():
    """The launch CLI's run() on the card: walks at 2 shards and counts at
    4 (packed lanes), each gated on accuracy and each recovering from an
    injected failure to the identical pi."""
    import numpy as np
    from repro_torch.launch.pagerank import run

    ckpt = ROOT / "build" / "smoke_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    out = {}
    for algo, shards in (("walks", 2), ("counts", 4)):
        args = (4096, EPS, 64, "directed_web")
        a = run(*args, None, [], algo=algo, check=True, shards=shards)
        b = run(*args, str(ckpt / algo), [5, 12], algo=algo, check=True,
                shards=shards)
        check(b.restarts >= 1, f"cli {algo}: no restart after a failure")
        check(np.array_equal(a.pi, b.pi),
              f"cli {algo}: the recovered run's pi differs")
        out[algo] = dict(shards=shards, rounds=a.rounds,
                         restarts=b.restarts, l1=a.l1, top10=a.topk)
    shutil.rmtree(ckpt, ignore_errors=True)
    log(f"cli: PASS {out}")
    return out


def small_check():
    """Small graphs on the card against the same runs on the CPU."""
    import torch
    from repro_torch import prng
    from repro_torch.core import (exact_pagerank, l1_error, normalized,
                                  power_iteration, simple_pagerank)
    from repro_torch.core.collectives import StackedMesh
    from repro_torch.core.distributed import distributed_pagerank
    from repro_torch.core.distributed_counts import \
        distributed_pagerank_counts
    from repro_torch.core.distributed_directed import \
        distributed_directed_pagerank
    from repro_torch.core.distributed_improved import \
        distributed_improved_pagerank
    from repro_torch.core.personalized import personalized_pagerank
    from repro_torch.core.personalized_batch import \
        batched_personalized_pagerank
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

    def walks(graph, dev):
        r = distributed_pagerank(graph, EPS, 8, key,
                                 mesh=StackedMesh(8, dev))
        return (r.zeta.cpu().tolist(), r.rounds, r.dropped, r.waited,
                r.round_active, r.a2a_entries_total, r.a2a_bytes_total)

    def counts(graph, dev, packed):
        r = distributed_pagerank_counts(graph, EPS, 8, key, packed=packed,
                                        mesh=StackedMesh(8, dev))
        return (r.zeta.cpu().tolist(), r.rounds, r.a2a_entries_total,
                r.a2a_bytes_total, r.lane_cap, r.overflow, r.occupancy,
                r.residual)

    def three_phase(fn, graph, dev):
        r = fn(graph, EPS, 8, key, mesh=StackedMesh(8, dev))
        return (r.zeta.cpu().tolist(), r.rounds, r.phase1_rounds,
                r.phase2_rounds, r.tail_rounds, r.a2a_bytes_by_phase,
                r.a2a_entries_by_site, r.coupons_used, r.p1_occupancy,
                r.residual, r.dropped)

    check(walks(g, "cuda") == walks(g_cpu, "cpu"),
          "small sharded walks (P=8): card and CPU differ")
    queries = ppr_queries(g.n, 5, seed=2)

    def batched_ppr(graph, dev):
        r = batched_personalized_pagerank(graph, EPS, queries, 3000, key,
                                          mesh=StackedMesh(8, dev))
        return (r.ppr.tolist(), r.rounds, r.active_trace, r.a2a_entries,
                r.a2a_bytes, r.dropped, r.admit_dropped)

    check(batched_ppr(g, "cuda") == batched_ppr(g_cpu, "cpu"),
          "small batched PPR (P=8): card and CPU differ")
    src, w = queries[0]
    check(torch.equal(
        personalized_pagerank(g, EPS, src, 5000, key=key, weights=w).cpu(),
        personalized_pagerank(g_cpu, EPS, src, 5000, key=key, weights=w,
                              device="cpu")),
        "small single-query PPR: card and CPU differ")
    for fn in (distributed_improved_pagerank, distributed_directed_pagerank):
        check(three_phase(fn, g, "cuda") == three_phase(fn, g_cpu, "cpu"),
              f"small {fn.__name__} (P=8): card and CPU differ")
    for packed in (True, False):
        check(counts(g, "cuda", packed) == counts(g_cpu, "cpu", packed),
              f"small sharded counts (P=8, packed={packed}): card and CPU "
              f"differ")
    log(f"small check (erdos_renyi(96)): walks zeta card == CPU, power "
        f"iteration L1 {l1_pi:.2e}, counts L1 vs exact {l1_c:.4f}; sharded "
        f"walks, counts (packed, unpacked), improved and directed, batched "
        f"PPR at P=8 and the single-query PPR engine card == CPU")


# ---------------------------------------------------------------------------
# LM serving (the ten configs' families behind ContinuousBatcher)
# ---------------------------------------------------------------------------

LM_SERVE_ARCH = "qwen2-7b"
LM_SLOTS, LM_MAX_SEQ, LM_REQUESTS = 8, 1024, 32
LM_PROMPT_LEN = (32, 512)         # drawn by numpy.random.default_rng(0)
LM_NEW_TOKENS = (8, 64)
LM_ONE_TOKEN = (5, 17)            # requests whose budget is 1
LM_ISOLATED = 4                   # requests replayed alone at batch 1
LM_FULL_B, LM_FULL_T = 2, 256     # decode against the full forward
LM_DECODE_TOL = 0.05              # tests/test_serve.py's bound
LM_WINDOW_ARCH = "h2o-danube-3-4b"
LM_WINDOW_SLOTS, LM_WINDOW_MAX_SEQ, LM_WINDOW_REQUESTS = 4, 8192, 6
LM_WINDOW_PROMPT_LEN = (4200, 6000)  # past the 4,096 window
LM_WINDOW_NEW_TOKENS = (8, 32)
LM_MOE_ARCHS = ("deepseek-v2-236b", "dbrx-132b")
LM_MOE_LAYERS = 2                 # depth cut: DeepSeek 1 dense + 1 MoE
# (e) Mamba-2: (a)'s traffic; decode vs full at T = 300, not a multiple of
# the 128-position chunk
LM_SSM_ARCH = "mamba2-1.3b"
LM_SSM_FULL_T = 300
# (f) RecurrentGemma: prompts past the 2,048-position local window
LM_HYBRID_ARCH = "recurrentgemma-9b"
LM_HYBRID_SLOTS, LM_HYBRID_MAX_SEQ, LM_HYBRID_REQUESTS = 4, 4096, 6
LM_HYBRID_PROMPT_LEN = (2100, 3000)
LM_HYBRID_NEW_TOKENS = (8, 32)
LM_HYBRID_ISOLATED = 2
# (g) Whisper: max_seq 448, Whisper's published decoder context
LM_AUDIO_ARCH = "whisper-tiny"
LM_AUDIO_SLOTS, LM_AUDIO_MAX_SEQ, LM_AUDIO_REQUESTS = 8, 448, 32
LM_AUDIO_PROMPT_LEN = (4, 64)
LM_AUDIO_NEW_TOKENS = (8, 64)
LM_AUDIO_FULL_T = 64
LM_REDUCED_ARCHS = ("qwen2-7b", "qwen3-32b", "h2o-danube-3-4b",
                    "nemotron-4-340b", "dbrx-132b", "deepseek-v2-236b",
                    "internvl2-1b", "mamba2-1.3b", "recurrentgemma-9b",
                    "whisper-tiny")
# card against CPU on the reduced configs: bf16 matmuls round in other
# places in cuBLAS and on the CPU
LM_CARD_CPU_TOL = 0.05


class TimedModel:
    """Serves through `model`, timing each prefill and decode step between
    synchronisations; each decode step is kept with the number of slots
    of `batcher` that were active."""

    def __init__(self, model):
        self.model = model
        self.device = model.device
        self.batcher = None
        self.prefill_s = 0.0
        self.prefill_tokens = 0
        self.decode_steps = []        # (active slots, seconds)

    def init_cache(self, batch, max_seq):
        return self.model.init_cache(batch, max_seq)

    def prefill(self, tokens, **kw):
        import torch
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.model.prefill(tokens, **kw)
        torch.cuda.synchronize()
        self.prefill_s += time.perf_counter() - t0
        self.prefill_tokens += tokens.numel()
        return out

    def decode_step(self, cache, token):
        import torch
        active = sum(r is not None for r in self.batcher.active)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.model.decode_step(cache, token)
        torch.cuda.synchronize()
        self.decode_steps.append((active, time.perf_counter() - t0))
        return out


def lm_param_bytes(model) -> int:
    return sum(p.numel() * p.element_size() for p in model.parameters())


def lm_tree_leaves(tree):
    """The tensors of a nested LM cache."""
    for t in tree.values():
        if isinstance(t, dict):
            yield from lm_tree_leaves(t)
        else:
            yield t


def lm_idx_leaves(tree, prefix=""):
    """path -> every idx leaf of a nested LM cache, on the CPU."""
    out = {}
    for name, t in tree.items():
        if isinstance(t, dict):
            out.update(lm_idx_leaves(t, f"{prefix}{name}."))
        elif name == "idx":
            out[prefix + name] = t.cpu()
    return out


def lm_release() -> None:
    """Free the card's memory of a phase's deleted models."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def lm_build(cfg):
    """The model of `cfg` on the card, weights from the port's seeded
    init; and the seconds it took."""
    import torch
    from repro_torch.models import get_model
    t0 = time.perf_counter()
    model = get_model(cfg)(cfg, seed=0)
    torch.cuda.synchronize()
    return model, time.perf_counter() - t0


def lm_decode_vs_full(model, tokens, **extra) -> float:
    """max |full - decode| / max |full| of the last position's logits:
    the full forward over tokens [B, T+1] against prefill over the first
    T and one decode step."""
    T = tokens.shape[1] - 1
    full, _ = model.prefill(tokens, **extra)
    _, cache = model.prefill(tokens[:, :T], pad_cache_to=T + 8, **extra)
    dec, _ = model.decode_step(cache, tokens[:, T:])
    a, b = full[:, -1], dec[:, -1]
    check(bool(a.isfinite().all()) and bool(b.isfinite().all()),
          f"{model.cfg.name}: logits not finite")
    return float((a - b).abs().max() / a.abs().max())


def lm_gate_decode_vs_full(drive, model, tokens, **extra) -> float:
    name = model.cfg.name
    err, _, _ = drive(f"{name} decode vs full",
                      lambda: lm_decode_vs_full(model, tokens, **extra), [])
    check(err < LM_DECODE_TOL,
          f"{name}: decode vs full forward {err} >= {LM_DECODE_TOL}")
    return err


def lm_requests(rng, n, prompt_len, new_tokens, vocab, one_token=()):
    from repro_torch.serve import Request
    lens = rng.integers(prompt_len[0], prompt_len[1] + 1, n)
    budgets = rng.integers(new_tokens[0], new_tokens[1] + 1, n)
    budgets[list(one_token)] = 1
    return [Request(rid=i, prompt=rng.integers(0, vocab, int(L)).astype(
        "int32"), max_new_tokens=int(m))
        for i, (L, m) in enumerate(zip(lens, budgets))]


def lm_check_accounting(label, reqs, stats, slots):
    budgets = [r.max_new_tokens for r in reqs]
    check(stats.completed == len(reqs) and stats.prefills == len(reqs),
          f"{label}: completed {stats.completed}, prefills "
          f"{stats.prefills} of {len(reqs)}")
    check(stats.tokens_out == sum(budgets),
          f"{label}: tokens_out {stats.tokens_out} != {sum(budgets)}")
    for r in reqs:
        check(r.done and len(r.generated) == r.max_new_tokens,
              f"{label}: request {r.rid} emitted {len(r.generated)} of "
              f"{r.max_new_tokens}")
    check(stats.max_active <= slots,
          f"{label}: max_active {stats.max_active} > {slots}")


def lm_serve(drive, model, reqs, slots, max_seq):
    """Serve `reqs` through `ContinuousBatcher(slots, max_seq)` with each
    call timed; the accounting gates. Returns (numbers, batcher)."""
    from repro_torch.serve import ContinuousBatcher
    name = model.cfg.name
    timed = TimedModel(model)
    batcher = ContinuousBatcher(timed, slots=slots, max_seq=max_seq)
    timed.batcher = batcher
    stats, serve_s, peak = drive(f"{name} serve", lambda: batcher.run(
        reqs), [])
    timed.batcher = None     # no cycle left to keep the model alive
    lm_check_accounting(name, reqs, stats, slots)
    full = [s for a, s in timed.decode_steps if a == slots]
    check(bool(full), f"{name}: no decode step ran with every slot active")
    decode_s = sum(s for _, s in timed.decode_steps)
    decode_tokens = sum(a for a, _ in timed.decode_steps)
    out = dict(
        requests=len(reqs), stats=dict(vars(stats)), serve_s=serve_s,
        peak_gib=peak, prefill_tokens=timed.prefill_tokens,
        prefill_s=timed.prefill_s,
        prefill_tok_s=timed.prefill_tokens / timed.prefill_s,
        decode_steps=len(timed.decode_steps), full_steps=len(full),
        decode_ms_full=1e3 * sum(full) / len(full),
        decode_ms=1e3 * decode_s / len(timed.decode_steps),
        decode_tok_s=decode_tokens / decode_s)
    return out, batcher


def lm_greedy_isolated(model, prompt, n_new, max_seq):
    """Batch-1 greedy decoding of `prompt` (prefilled as the batcher
    prefills); returns the tokens and each step's top-2 logit margin
    relative to the largest |logit|."""
    import torch
    dev = model.device
    logits, cache = model.prefill(
        torch.as_tensor(prompt[None], dtype=torch.int64, device=dev),
        q_chunk=64, pad_cache_to=max_seq)
    toks, margins = [], []
    for i in range(n_new):
        row = logits[0, -1]
        top2 = torch.topk(row, 2).values
        margins.append(float((top2[0] - top2[1]) / row.abs().max()))
        toks.append(int(row.argmax()))
        if i + 1 < n_new:
            logits, cache = model.decode_step(
                cache, torch.tensor([[toks[-1]]], device=dev))
    return toks, margins


def lm_replay_isolated(model, reqs, n, max_seq, err) -> dict:
    """Batched against isolated greedy decoding of the first `n` requests
    whose budget is more than 1; where they part, the isolated run's
    margin must be below the decode-vs-full error `err`."""
    name = model.cfg.name
    parted = []
    compared = [r for r in reqs if r.max_new_tokens > 1][:n]
    for r in compared:
        alone, margins = lm_greedy_isolated(model, r.prompt,
                                            r.max_new_tokens, max_seq)
        diff = [i for i, (a, b) in enumerate(zip(alone, r.generated))
                if a != b]
        if diff:
            i = diff[0]
            check(margins[i] < err,
                  f"{name}: request {r.rid} parts from batch-1 decoding "
                  f"at step {i} with margin {margins[i]:.5f} >= {err:.5f}")
            parted.append(dict(rid=r.rid, step=i, of=r.max_new_tokens,
                               margin=margins[i]))
    log(f"{name}: {len(compared)} requests replayed at batch 1: "
        f"{len(parted)} parted from the batched tokens {parted} (each at a "
        f"margin below {err:.5f})")
    return dict(compared=len(compared), parted=parted)


def lm_profile_decode(model, batcher, label) -> dict:
    """One decode step over the batcher's cache, profiled."""
    last = batcher.last_token
    model.decode_step(batcher.cache, last)
    stats = {}
    profile_rounds(lambda c: model.decode_step(c, last)[1], batcher.cache,
                   1, label, stats=stats)
    return stats


def lm_serve_qwen(drive, smi):
    """(a) Qwen2-7B at full width behind ContinuousBatcher."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config

    cfg = get_config(LM_SERVE_ARCH)
    model, init_s = lm_build(cfg)
    n_params = sum(p.numel() for p in model.parameters())
    wbytes = lm_param_bytes(model)
    log(f"{cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.num_heads} query heads padded to {cfg.pad_q_heads_to}, "
        f"{cfg.num_kv_heads} KV heads of {cfg.resolved_head_dim}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}: {n_params / 1e9:.3f} B "
        f"parameters (config count {cfg.param_count() / 1e9:.3f} B), "
        f"{wbytes / 2 ** 30:.2f} GiB; init {init_s:.2f} s")

    gen = torch.Generator(device=model.device).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (LM_FULL_B, LM_FULL_T + 1),
                           generator=gen, device=model.device)
    err = lm_gate_decode_vs_full(drive, model, tokens)
    log(f"{cfg.name}: decode vs full forward at B={LM_FULL_B}, "
        f"T={LM_FULL_T}: relative error {err:.5f} (< {LM_DECODE_TOL})")

    rng = np.random.default_rng(0)
    reqs = lm_requests(rng, LM_REQUESTS, LM_PROMPT_LEN, LM_NEW_TOKENS,
                       cfg.vocab_size, LM_ONE_TOKEN)
    served, batcher = lm_serve(drive, model, reqs, LM_SLOTS, LM_MAX_SEQ)
    bound_ms = wbytes / HBM_BYTES_PER_S * 1e3
    out = dict(arch=cfg.name, params=n_params, weight_gib=wbytes / 2 ** 30,
               init_s=init_s, decode_vs_full=err, decode_bound_ms=bound_ms,
               **served)
    log(f"{cfg.name} serve: {served['stats']}; {out['prefill_tokens']} "
        f"prompt tokens prefilled in {out['prefill_s']:.3f} s "
        f"({out['prefill_tok_s']:.0f} tokens/s); decode "
        f"{out['decode_ms_full']:.3f} ms a step at {LM_SLOTS} active slots "
        f"({out['full_steps']} steps) against the weight-read bound "
        f"{bound_ms:.3f} ms ({wbytes / 2 ** 30:.2f} GiB / 3.35 TB/s), "
        f"{out['decode_tok_s']:.0f} decode tokens/s over "
        f"{out['decode_steps']} steps; peak {out['peak_gib']:.2f} GiB "
        f"[{smi}]")
    out["isolated"] = lm_replay_isolated(model, reqs, LM_ISOLATED,
                                         LM_MAX_SEQ, err)
    out["profiled"] = lm_profile_decode(
        model, batcher, f"{cfg.name} decode step, {LM_SLOTS} slots, "
        "profiled")
    del model, batcher
    lm_release()
    return out


def lm_serve_window(drive, smi):
    """(b) H2O-Danube3-4B at full width, prompts past its window."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config

    cfg = get_config(LM_WINDOW_ARCH)
    model, init_s = lm_build(cfg)
    rng = np.random.default_rng(0)
    reqs = lm_requests(rng, LM_WINDOW_REQUESTS, LM_WINDOW_PROMPT_LEN,
                       LM_WINDOW_NEW_TOKENS, cfg.vocab_size)
    tokens = torch.as_tensor(
        np.append(reqs[0].prompt, 7)[None], dtype=torch.int64,
        device=model.device)
    err = lm_gate_decode_vs_full(drive, model, tokens)
    served, batcher = lm_serve(drive, model, reqs, LM_WINDOW_SLOTS,
                               LM_WINDOW_MAX_SEQ)
    ring = batcher.cache["dense"]["k"].shape[2]
    check(ring == cfg.sliding_window, f"{cfg.name}: ring of {ring}")
    out = dict(
        arch=cfg.name, params=sum(p.numel() for p in model.parameters()),
        weight_gib=lm_param_bytes(model) / 2 ** 30, init_s=init_s,
        decode_vs_full=err, prompt_len=int(tokens.shape[1] - 1), **served)
    log(f"{cfg.name}: window {cfg.sliding_window}, "
        f"{out['params'] / 1e9:.3f} B parameters, "
        f"{out['weight_gib']:.2f} GiB, init {init_s:.2f} s; decode vs full "
        f"forward on a {out['prompt_len']}-token prompt {err:.5f}; serve "
        f"{served['stats']} in {out['serve_s']:.3f} s, prompts "
        f"{[len(r.prompt) for r in reqs]}, prefill "
        f"{out['prefill_tok_s']:.0f} tokens/s, decode {out['decode_ms']:.3f}"
        f" ms a step, peak {out['peak_gib']:.2f} GiB [{smi}]")
    del model, batcher
    lm_release()
    return out


def lm_moe_path(drive, smi):
    """(c) DeepSeek-V2 and DBRX at full width, depth cut to 2 layers."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config

    out = {}
    for name in LM_MOE_ARCHS:
        base = dataclasses.replace(get_config(name), num_layers=LM_MOE_LAYERS)
        # drop-free: C >= N at E / k, so the full forward and decode route
        # every assignment (the reduced configs' capacity 4.0 does the same)
        free = dataclasses.replace(
            base, capacity_factor=base.num_experts / base.num_experts_per_tok)
        model, init_s = lm_build(free)
        moes = [b.moe for b in model.moe_layers]
        gen = torch.Generator(device=model.device).manual_seed(2)
        tokens = torch.randint(0, base.vocab_size,
                               (LM_FULL_B, LM_FULL_T + 1), generator=gen,
                               device=model.device)
        for m in moes:
            m.dropped.zero_()
        err, secs, peak = drive(f"{name} decode vs full",
                                lambda: lm_decode_vs_full(model, tokens), [])
        free_drops = sum(int(m.dropped) for m in moes)
        check(free_drops == 0, f"{name}: {free_drops} drops at C >= N")
        check(err < LM_DECODE_TOL,
              f"{name}: decode vs full forward {err} >= {LM_DECODE_TOL}")
        # the configuration's own capacity factor
        model.cfg = base
        for m in moes:
            m.dropped.zero_()
        model.prefill(tokens)
        drops = sum(int(m.dropped) for m in moes)
        err_cf = lm_decode_vs_full(model, tokens)
        assignments = LM_FULL_B * (LM_FULL_T + 1) * base.num_experts_per_tok
        out[name] = dict(
            reduced=["num_layers"], layers=LM_MOE_LAYERS,
            params=sum(p.numel() for p in model.parameters()),
            weight_gib=lm_param_bytes(model) / 2 ** 30, init_s=init_s,
            decode_vs_full=err, seconds=secs, peak_gib=peak,
            capacity_factor=base.capacity_factor, drops=drops,
            assignments=assignments, decode_vs_full_at_cf=err_cf)
        log(f"{name} (reduced: num_layers {LM_MOE_LAYERS}): "
            f"{out[name]['params'] / 1e9:.3f} B parameters, "
            f"{out[name]['weight_gib']:.2f} GiB, init {init_s:.2f} s; "
            f"decode vs full forward at B={LM_FULL_B}, T={LM_FULL_T}, "
            f"capacity factor {free.capacity_factor:.2f} (no drops): "
            f"{err:.5f}; at capacity factor {base.capacity_factor}: "
            f"{drops} of {assignments} assignments dropped in the full "
            f"forward, decode vs full {err_cf:.5f} (not gated); peak "
            f"{peak:.2f} GiB [{smi}]")
        del model, moes
        lm_release()
    return out


def lm_describe(model, init_s) -> dict:
    cfg = model.cfg
    n_params = sum(p.numel() for p in model.parameters())
    wbytes = lm_param_bytes(model)
    log(f"{cfg.name}: {cfg.family}, {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, vocab {cfg.vocab_size}: {n_params:,} parameters "
        f"(config count {cfg.param_count():,}), {wbytes / 2 ** 30:.2f} GiB; "
        f"init {init_s:.2f} s")
    return dict(arch=cfg.name, params=n_params, weight_bytes=wbytes,
                weight_gib=wbytes / 2 ** 30, init_s=init_s)


def lm_serve_ssm(drive, smi):
    """(e) Mamba2-1.3B at full width and depth: (a)'s traffic."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config

    cfg = get_config(LM_SSM_ARCH)
    model, init_s = lm_build(cfg)
    out = lm_describe(model, init_s)
    gen = torch.Generator(device=model.device).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size,
                           (LM_FULL_B, LM_SSM_FULL_T + 1), generator=gen,
                           device=model.device)
    out["decode_vs_full"] = err = lm_gate_decode_vs_full(drive, model,
                                                         tokens)
    rng = np.random.default_rng(0)
    reqs = lm_requests(rng, LM_REQUESTS, LM_PROMPT_LEN, LM_NEW_TOKENS,
                       cfg.vocab_size, LM_ONE_TOKEN)
    served, batcher = lm_serve(drive, model, reqs, LM_SLOTS, LM_MAX_SEQ)
    out.update(served)
    # a decode step reads every weight once and reads and writes the
    # slots' state (the SSM state and the conv history)
    state = sum(t.numel() * t.element_size()
                for t in lm_tree_leaves(batcher.cache))
    out["state_bytes"] = state
    out["decode_bound_ms"] = bound_ms = \
        (out["weight_bytes"] + 2 * state) / HBM_BYTES_PER_S * 1e3
    log(f"{cfg.name}: decode vs full forward at B={LM_FULL_B}, "
        f"T={LM_SSM_FULL_T}: {err:.5f} (< {LM_DECODE_TOL}); serve "
        f"{served['stats']}; prompts {[len(r.prompt) for r in reqs]}; "
        f"prefill {served['prefill_tok_s']:.0f} tokens/s "
        f"({served['prefill_tokens']} in {served['prefill_s']:.3f} s); "
        f"decode {served['decode_ms_full']:.3f} ms a step at {LM_SLOTS} "
        f"active slots ({served['full_steps']} steps) against the bound "
        f"{bound_ms:.3f} ms (weights {out['weight_gib']:.2f} GiB + 2 x "
        f"state {state / 1e6:.1f} MB, at 3.35 TB/s); "
        f"{served['decode_tok_s']:.0f} decode tokens/s; peak "
        f"{served['peak_gib']:.2f} GiB [{smi}]")
    out["isolated"] = lm_replay_isolated(model, reqs, LM_ISOLATED,
                                         LM_MAX_SEQ, err)
    out["profiled"] = lm_profile_decode(
        model, batcher, f"{cfg.name} decode step, {LM_SLOTS} slots, "
        "profiled")
    del model, batcher
    lm_release()
    return out


def lm_serve_hybrid(drive, smi):
    """(f) RecurrentGemma-9B at full width and depth, prompts past its
    local window."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config

    cfg = get_config(LM_HYBRID_ARCH)
    model, init_s = lm_build(cfg)
    out = lm_describe(model, init_s)
    rng = np.random.default_rng(0)
    reqs = lm_requests(rng, LM_HYBRID_REQUESTS, LM_HYBRID_PROMPT_LEN,
                       LM_HYBRID_NEW_TOKENS, cfg.vocab_size)
    tokens = torch.as_tensor(np.append(reqs[0].prompt, 7)[None],
                             dtype=torch.int64, device=model.device)
    out["decode_vs_full"] = err = lm_gate_decode_vs_full(drive, model,
                                                         tokens)
    out["full_prompt_len"] = int(tokens.shape[1] - 1)
    served, batcher = lm_serve(drive, model, reqs, LM_HYBRID_SLOTS,
                               LM_HYBRID_MAX_SEQ)
    out.update(served)
    ring = batcher.cache["groups"]["attn"]["k"].shape[2]
    check(ring == cfg.local_window, f"{cfg.name}: ring of {ring}")
    out["decode_bound_ms"] = bound_ms = \
        out["weight_bytes"] / HBM_BYTES_PER_S * 1e3
    # the float32 copies of w_a and w_x each recurrent block makes a step
    recs = [b for g in model.groups for b in g.rec] + list(model.trailing)
    out["gate_cast_ms"] = cast_ms = cuda_ms(
        lambda: [(b.w_a.float(), b.w_x.float()) for b in recs], 5)
    log(f"{cfg.name}: decode vs full forward on a "
        f"{out['full_prompt_len']}-token prompt (window "
        f"{cfg.local_window}): {err:.5f} (< {LM_DECODE_TOL}); serve "
        f"{served['stats']} in {served['serve_s']:.3f} s; prompts "
        f"{[len(r.prompt) for r in reqs]}; prefill "
        f"{served['prefill_tok_s']:.0f} tokens/s; decode "
        f"{served['decode_ms_full']:.3f} ms a step at {LM_HYBRID_SLOTS} "
        f"active slots ({served['full_steps']} steps) against the "
        f"weight-read bound {bound_ms:.3f} ms; the {2 * len(recs)} float32 "
        f"gate casts alone {cast_ms:.3f} ms "
        f"({cast_ms / served['decode_ms_full']:.1%} of a step); peak "
        f"{served['peak_gib']:.2f} GiB [{smi}]")
    out["isolated"] = lm_replay_isolated(model, reqs, LM_HYBRID_ISOLATED,
                                         LM_HYBRID_MAX_SEQ, err)
    out["profiled"] = prof = lm_profile_decode(
        model, batcher, f"{cfg.name} decode step, {LM_HYBRID_SLOTS} slots, "
        "profiled")
    out["gate_cast_share_of_busy"] = cast_ms / prof["busy_ms"]
    log(f"{cfg.name}: the gate casts {cast_ms:.3f} ms against "
        f"{prof['busy_ms']:.3f} ms of device time a profiled step "
        f"({out['gate_cast_share_of_busy']:.1%})")
    del model, batcher, recs
    lm_release()
    return out


def lm_serve_audio(drive, smi):
    """(g) Whisper-tiny at full width and depth, 1,500 frames."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config

    cfg = get_config(LM_AUDIO_ARCH)
    model, init_s = lm_build(cfg)
    out = lm_describe(model, init_s)
    gen = torch.Generator(device=model.device).manual_seed(3)
    tokens = torch.randint(0, cfg.vocab_size,
                           (LM_FULL_B, LM_AUDIO_FULL_T + 1), generator=gen,
                           device=model.device)
    frames = torch.randn((LM_FULL_B, cfg.encoder_seq, cfg.d_model),
                         generator=gen, device=model.device).to(
                             torch.bfloat16)
    out["decode_vs_full"] = err = lm_gate_decode_vs_full(
        drive, model, tokens, frames=frames)
    rng = np.random.default_rng(0)
    reqs = lm_requests(rng, LM_AUDIO_REQUESTS, LM_AUDIO_PROMPT_LEN,
                       LM_AUDIO_NEW_TOKENS, cfg.vocab_size)
    served, batcher = lm_serve(drive, model, reqs, LM_AUDIO_SLOTS,
                               LM_AUDIO_MAX_SEQ)
    out.update(served)
    # a decode step reads every weight and the slots' self and cross
    # keys and values once
    cache = sum(t.numel() * t.element_size()
                for t in lm_tree_leaves(batcher.cache))
    out["decode_bound_ms"] = bound_ms = \
        (out["weight_bytes"] + cache) / HBM_BYTES_PER_S * 1e3
    log(f"{cfg.name}: decode vs full forward at B={LM_FULL_B}, "
        f"T={LM_AUDIO_FULL_T}, {cfg.encoder_seq} frames from a seed: "
        f"{err:.5f} (< {LM_DECODE_TOL}); serve {served['stats']}; prefill "
        f"(encoder included) {served['prefill_tok_s']:.0f} tokens/s; "
        f"decode {served['decode_ms_full']:.3f} ms a step at "
        f"{LM_AUDIO_SLOTS} active slots ({served['full_steps']} steps) "
        f"against the bound {bound_ms:.4f} ms (weights and cache "
        f"{(out['weight_bytes'] + cache) / 1e6:.1f} MB); "
        f"{served['decode_tok_s']:.0f} decode tokens/s; peak "
        f"{served['peak_gib']:.2f} GiB [{smi}]")
    out["isolated"] = lm_replay_isolated(model, reqs, LM_ISOLATED,
                                         LM_AUDIO_MAX_SEQ, err)
    out["profiled"] = lm_profile_decode(
        model, batcher, f"{cfg.name} decode step, {LM_AUDIO_SLOTS} slots, "
        "profiled")
    del model, batcher
    lm_release()
    return out


def lm_reduced_card_vs_cpu():
    """(d) The reduced configs on the card against the port on the CPU,
    with the same weights."""
    import numpy as np
    import torch
    from repro_torch.configs import reduced_config
    from repro_torch.models import get_model

    out = {}
    rng = np.random.default_rng(3)
    for arch in LM_REDUCED_ARCHS:
        cfg = reduced_config(arch)
        cpu = get_model(cfg)(cfg, device="cpu", seed=0)
        card = get_model(cfg)(cfg, seed=None)
        card.load_state_dict(cpu.state_dict())
        toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 25)))
        extra = {}
        if cfg.family == "vlm":
            extra["img_embeds"] = torch.as_tensor(rng.standard_normal(
                (2, cfg.num_image_tokens, cfg.d_model))).to(torch.bfloat16)
        if cfg.family == "audio":
            extra["frames"] = torch.as_tensor(rng.standard_normal(
                (2, cfg.encoder_seq, cfg.d_model))).to(torch.bfloat16)
        res = []
        for m in (cpu, card):
            dev = m.device
            pre, cache = m.prefill(
                toks[:, :24].to(dev), q_chunk=8, pad_cache_to=72,
                **{k: v.to(dev) for k, v in extra.items()})
            dec, cache = m.decode_step(cache, toks[:, 24:].to(dev))
            res.append((pre.cpu(), dec.cpu(), lm_idx_leaves(cache)))
        errs = [float((a - b).abs().max() / a.abs().max())
                for a, b in zip(res[0][:2], res[1][:2])]
        check(max(errs) < LM_CARD_CPU_TOL,
              f"{arch} reduced: card vs CPU logits {errs}")
        check(res[0][2].keys() == res[1][2].keys()
              and all(torch.equal(res[0][2][k], res[1][2][k])
                      for k in res[0][2]),
              f"{arch} reduced: cache idx differs")
        out[arch] = dict(prefill=errs[0], decode=errs[1])
    log(f"reduced configs, card vs CPU (same weights): relative logit "
        f"errors {out} (< {LM_CARD_CPU_TOL}); cache idx equal")
    return out


LM_SERVE_PG_DIR = ROOT / "build" / "lm_serve_process"
LM_SERVE_PG_ARCHS = ("qwen2-7b", "h2o-danube-3-4b", "deepseek-v2-236b",
                     "internvl2-1b")
# 4 rows of 14 positions (InternVL2: its 8 image positions and 6 tokens)
# padded to 32, then 4 steps: positions 14-17 cross from model rank 0's
# block of 16 into rank 1's, and H2O-Danube3's ring of 16 (8 slots a
# rank) wraps from slot 15 on rank 1 to slot 0 on rank 0
LM_SERVE_PG_B, LM_SERVE_PG_T, LM_SERVE_PG_MAX = 4, 14, 32
LM_SERVE_PG_STEPS = 4
# tests/test_torch_process_group_lm_serve.py's TOL_LOGITS: bf16 products
# round in other places on blocks, and the softmax is combined over
# `model` by log-sum-exp in float32 where one process rounds the
# probabilities to bf16
LM_SERVE_PG_TOL = 0.03
# (h)'s world-1 run: Qwen2-7B at full width cut to 4 layers, 4 x 256
# prompt tokens padded to 512, 8 decode steps
LM_SERVE_ONE_LAYERS, LM_SERVE_ONE_T, LM_SERVE_ONE_STEPS = 4, 256, 8


def lm_serve_inputs(cfg, batch: int, prompt: int, steps: int, seed: int):
    """(tokens [batch, prompt], extra inputs, decode tokens [steps,
    batch]) of `cfg` from a numpy seed, on the CPU; `prompt` counts the
    VLM's image positions."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    extra = {}
    if cfg.family == "vlm":
        prompt -= cfg.num_image_tokens
        extra["img_embeds"] = torch.as_tensor(rng.standard_normal(
            (batch, cfg.num_image_tokens, cfg.d_model))).to(torch.bfloat16)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                          (batch, prompt)))
    feed = torch.as_tensor(rng.integers(0, cfg.vocab_size, (steps, batch)))
    return tokens, extra, feed


def lm_serve_steps(model, tokens, extra, feed, max_seq: int, q_chunk: int):
    """Prefill padded to `max_seq` and a decode step a row of `feed`:
    (the logits of each, on the CPU; the cache; the collectives of the
    first decode step)."""
    from repro_torch.sharding.collectives import CollectiveLog
    dev = model.device
    logits, cache = model.prefill(
        tokens.to(dev), q_chunk=q_chunk, pad_cache_to=max_seq,
        **{k: v.to(dev) for k, v in extra.items()})
    out, first = [logits.float().cpu()], None
    for i in range(feed.shape[0]):
        with CollectiveLog() as log:
            logits, cache = model.decode_step(cache, feed[i][:, None].to(dev))
        first = first or log
        out.append(logits.float().cpu())
    return out, cache, first


def lm_serve_child(spec: dict) -> int:
    """One process of (h)'s group: gloo with card tensors, every process
    on the one card, the (data 2, model 2) process mesh; each config of
    LM_SERVE_PG_ARCHS from the seeded init on blocks, its rows prefilled
    and decoded (`lm_serve_steps`), the cache gathered back to the
    single-process layout (every rank takes part; rank 0 saves it), and
    the dry run's trace of this rank's decode step. Prints JSON."""
    import datetime
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs import reduced_config
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.launch.dryrun import trace_rank
    from repro_torch.launch.mesh import make_process_mesh
    from repro_torch.models import get_model
    from repro_torch.sharding.layout import serve_rows, whole_blocks

    torch.set_num_threads(1)
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dist.init_process_group(
        "gloo", store=dist.FileStore(spec["store"], world), rank=rank,
        world_size=world,
        timeout=datetime.timedelta(seconds=spec["timeout"]))
    out = dict(rank=rank, world=world)
    try:
        mesh = make_process_mesh(LM_PG_MESH, "cuda",
                                 timeout=spec["timeout"])
        rows = serve_rows(LM_SERVE_PG_B, mesh)
        out["rows"] = [rows.start, rows.stop]
        for arch in LM_SERVE_PG_ARCHS:
            t0 = time.perf_counter()
            cfg = reduced_config(arch)
            model = get_model(cfg)(cfg, seed=0, mesh=mesh)
            tokens, extra, feed = lm_serve_inputs(
                cfg, LM_SERVE_PG_B, LM_SERVE_PG_T, LM_SERVE_PG_STEPS, 5)
            logits, cache, log = lm_serve_steps(
                model, tokens[rows], {k: v[rows] for k, v in extra.items()},
                feed[:, rows], LM_SERVE_PG_MAX, 8)
            whole = whole_blocks(
                cache, model.cache_axes(LM_SERVE_PG_B, LM_SERVE_PG_MAX),
                model.cache_shapes(LM_SERVE_PG_B, LM_SERVE_PG_MAX), mesh)
            arrays = {f"logits{i}": t.numpy() for i, t in enumerate(logits)}
            if rank == 0:
                arrays.update({f"{k}/{n}": t.float().cpu().numpy()
                               for k, c in whole.items()
                               for n, t in c.items()})
            np.savez(Path(spec["dir"]) / f"{arch}_r{rank}.npz", **arrays)
            traced = trace_rank(cfg, ShapeConfig(
                "decode", LM_SERVE_PG_MAX, LM_SERVE_PG_B, "decode"),
                LM_PG_MESH, rank, q_chunk=8)
            out[arch] = dict(
                coll=log.bytes, coll_calls=log.calls,
                traced=traced["coll_by_kind"],
                traced_calls=traced["coll_calls"],
                traced_temp=traced["temp_bytes"],
                cache_shapes={f"{k}/{n}": list(t.shape)
                              for k, c in cache.items()
                              for n, t in c.items()},
                device=str(model.device),
                seconds=time.perf_counter() - t0)
            del model, cache, whole
    finally:
        dist.destroy_process_group()
    print(json.dumps(out))
    return 0


def lm_serve_world_one(drive, smi) -> dict:
    """(h) Qwen2-7B x4 at full width served under the local layout (whole
    weights) and then on blocks under an NCCL group of world size 1 (the
    1x1 process mesh): the logits and every cache leaf bit-equal."""
    import dataclasses
    import datetime
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_process_mesh
    from repro_torch.models import get_model

    cfg = dataclasses.replace(get_config(LM_SERVE_ARCH),
                              num_layers=LM_SERVE_ONE_LAYERS)
    tokens, extra, feed = lm_serve_inputs(
        cfg, LM_SERVE_PG_B, LM_SERVE_ONE_T, LM_SERVE_ONE_STEPS, 7)
    runs = {}
    for label in ("whole", "nccl"):
        mesh = None
        if label == "nccl":
            dist.init_process_group(
                "nccl", store=dist.FileStore(
                    str(LM_SERVE_PG_DIR / "store_nccl"), 1),
                rank=0, world_size=1,
                device_id=torch.device("cuda", torch.cuda.current_device()),
                timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
        try:
            if label == "nccl":
                mesh = make_process_mesh({"data": 1, "model": 1})
            model = get_model(cfg)(cfg, seed=0, mesh=mesh)
            (logits, cache, _), secs, peak = drive(
                f"{cfg.name} x{cfg.num_layers} serve, {label}",
                lambda: lm_serve_steps(model, tokens, extra, feed,
                                       2 * LM_SERVE_ONE_T, 512), [])
            check(not any(drive.last.values()),
                  f"lm serve (h) {label} launched kernels: {drive.last}")
            runs[label] = dict(
                seconds=secs, peak_gib=peak,
                digests=[bit_digest(t) for t in logits]
                + [bit_digest(t) for t in lm_tree_leaves(cache)])
            del model, cache
        finally:
            if label == "nccl":
                dist.destroy_process_group()
        lm_release()
    check(not dist.is_initialized(), "the NCCL group was not destroyed")
    a, b = runs["whole"], runs["nccl"]
    check(a["digests"] == b["digests"],
          f"{cfg.name} x{cfg.num_layers}: serving on the NCCL world-1 "
          f"process mesh differs from whole weights in "
          f"{sum(x != y for x, y in zip(a['digests'], b['digests']))} of "
          f"{len(a['digests'])} tensors")
    out = {k: dict(v, digests=len(v["digests"])) for k, v in runs.items()}
    log(f"lm serve (h) world 1, {cfg.name} x{cfg.num_layers}, "
        f"{LM_SERVE_PG_B} x {LM_SERVE_ONE_T} tokens and "
        f"{LM_SERVE_ONE_STEPS} decode steps on {smi}: NCCL process mesh "
        f"(blocks) bit-equal to whole weights: {out}")
    return out


def lm_serve_group(smi) -> dict:
    """(h) Four child processes on the one card over gloo with card
    tensors at (data 2, model 2), against the same serving in this
    process with whole weights."""
    import numpy as np
    import torch
    from repro_torch.configs import reduced_config
    from repro_torch.models import get_model

    world = LM_PG_MESH["data"] * LM_PG_MESH["model"]
    t0 = time.perf_counter()
    outs = run_process_group(world, dict(dir=str(LM_SERVE_PG_DIR)),
                             "lm_serve", flag="--lm-serve-child",
                             where=LM_SERVE_PG_DIR)
    group_s = time.perf_counter() - t0
    res = {}
    for arch in LM_SERVE_PG_ARCHS:
        cfg = reduced_config(arch)
        model = get_model(cfg)(cfg, seed=0)
        tokens, extra, feed = lm_serve_inputs(
            cfg, LM_SERVE_PG_B, LM_SERVE_PG_T, LM_SERVE_PG_STEPS, 5)
        logits, cache, _ = lm_serve_steps(model, tokens, extra, feed,
                                          LM_SERVE_PG_MAX, 8)
        check(all(o[arch]["device"].startswith("cuda") for o in outs),
              f"{arch} at 2x2: not on the card: {[o[arch] for o in outs]}")
        errs = []
        for o in outs:
            got = np.load(LM_SERVE_PG_DIR / f"{arch}_r{o['rank']}.npz")
            rows = slice(*o["rows"])
            for i, want in enumerate(logits):
                w = want[rows].numpy()
                errs.append(float(np.abs(got[f"logits{i}"] - w).max()
                                  / np.abs(w).max()))
            row = o[arch]
            check(row["coll"] == row["traced"]
                  and row["coll_calls"] == row["traced_calls"],
                  f"{arch} at 2x2 rank {o['rank']}: the dry run's decode "
                  f"trace notes {row['traced']} {row['traced_calls']}, the "
                  f"gloo step moved {row['coll']} {row['coll_calls']}")
        got = np.load(LM_SERVE_PG_DIR / f"{arch}_r0.npz")
        cache_err = 0.0
        for k, c in cache.items():
            for n, t in c.items():
                want, mine = t.float().cpu().numpy(), got[f"{k}/{n}"]
                check(want.shape == mine.shape,
                      f"{arch}: gathered {k}/{n} {mine.shape}, one "
                      f"process {want.shape}")
                if n == "idx":
                    check(np.array_equal(want, mine),
                          f"{arch}: gathered {k}/{n} differs")
                    continue
                axes = tuple(range(3, want.ndim))
                check(np.array_equal((want != 0).any(axis=axes),
                                     (mine != 0).any(axis=axes)),
                      f"{arch}: the gathered cache's filled slots differ")
                cache_err = max(cache_err, float(
                    np.abs(want - mine).max() / np.abs(want).max()))
        check(max(errs) <= LM_SERVE_PG_TOL
              and cache_err <= LM_SERVE_PG_TOL,
              f"{arch} at 2x2 vs one process on the card: logits "
              f"{max(errs)}, cache {cache_err} apart")
        res[arch] = dict(logits_err=max(errs), cache_err=cache_err,
                         coll_bytes_a_step=outs[0][arch]["coll"],
                         coll_calls_a_step=outs[0][arch]["coll_calls"],
                         traced_temp=outs[0][arch]["traced_temp"],
                         cache_block=outs[0][arch]["cache_shapes"],
                         child_seconds=[o[arch]["seconds"] for o in outs])
        del model, cache
        torch.cuda.empty_cache()
    log(f"lm serve (h) gloo, {world} processes on the card at "
        f"{LM_PG_MESH}, {group_s:.1f} s on {smi}: {res}")
    return dict(res, group_s=group_s)


def lm_serve_process(drive, smi) -> dict:
    """(h) Prefill and decode over one process a shard."""
    shutil.rmtree(LM_SERVE_PG_DIR, ignore_errors=True)
    LM_SERVE_PG_DIR.mkdir(parents=True)
    try:
        return dict(world_one=lm_serve_world_one(drive, smi),
                    gloo_2x2=lm_serve_group(smi))
    finally:
        shutil.rmtree(LM_SERVE_PG_DIR, ignore_errors=True)


def lm_serve_path(drive, smi):
    """The LM serving path: (a) Qwen2-7B served at full width, (b)
    Danube3 past its window, (c) full-width 2-layer DeepSeek-V2 and DBRX,
    (e) Mamba2-1.3B, (f) RecurrentGemma-9B past its window and (g)
    Whisper-tiny, each at full width and depth, (d) the reduced configs
    on the card against the CPU, (h) serving over one process a shard."""
    log(f"lm serve path on {smi}")
    out = {}
    for key, phase in (("qwen", lm_serve_qwen), ("window", lm_serve_window),
                       ("moe", lm_moe_path), ("ssm", lm_serve_ssm),
                       ("hybrid", lm_serve_hybrid),
                       ("audio", lm_serve_audio)):
        t0 = time.perf_counter()
        out[key] = phase(drive, smi)
        out[key]["phase_s"] = time.perf_counter() - t0
        log(f"lm phase {key}: {out[key]['phase_s']:.2f} s")
    t0 = time.perf_counter()
    out["reduced"] = lm_reduced_card_vs_cpu()
    out["reduced_phase_s"] = time.perf_counter() - t0
    log(f"lm phase reduced: {out['reduced_phase_s']:.2f} s")
    t0 = time.perf_counter()
    out["process"] = lm_serve_process(drive, smi)
    out["process_phase_s"] = time.perf_counter() - t0
    log(f"lm phase process: {out['process_phase_s']:.2f} s")
    log(f"lm serve: {smi} " + json.dumps(out, default=str))
    return out


# ---------------------------------------------------------------------------
# LM training (loss_fn, the microbatched train step, AdamW)
# ---------------------------------------------------------------------------

LM_TRAIN_ARCH = "qwen2-7b"
LM_TRAIN_LAYERS = 8               # reduced: 28 -> 8 (16 B of state a param)
LM_TRAIN_BATCH, LM_TRAIN_SEQ, LM_TRAIN_MICRO = 4, 1024, 2
LM_TRAIN_LR = 3e-4
LM_TRAIN_STEPS = 4                # timed, after one warm-up step
LM_TRAIN_INT8_STEPS = 2
LM_TRAIN_PEAK_GIB = 72.0          # past it: 6 layers
H100_BF16_DENSE = 989e12          # H100 SXM data sheet, dense bf16 FLOP/s
LM_REMAT_ARCH = "deepseek-v2-236b"
# one train step, card against CPU (reduced configs): bf16 matmuls round
# in other places in cuBLAS, and CUDA's atomic index_add_ and embedding
# backward sum in no fixed order
LM_TRAIN_CPU_LR = 1e-3
LM_TRAIN_LOSS_TOL = 1e-2          # relative
LM_TRAIN_MEAN_TOL = 0.05          # mean |master diff| / lr
LM_REMAT_TOL = 1e-2               # card: recomputation is not bit-exact


def lm_matmul_params(cfg) -> int:
    """Parameters that multiply activations in Qwen2's layers and head
    (the real 28 query heads, not the padded 32; no norms or biases)."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    attn = d * cfg.num_heads * hd * 2 + d * cfg.num_kv_heads * hd * 2
    mlp = 3 * d * cfg.d_ff
    return cfg.num_layers * (attn + mlp) + cfg.vocab_size * d


def lm_train_flops(cfg, batch: int, seq: int) -> float:
    """Model FLOPs of one step: 6 x matmul parameters x tokens, plus
    attention's QK^T and PV over the full T x T scores as computed (no
    causal halving), x 3 for forward and backward; remat's recomputed
    forward not counted."""
    tokens = batch * seq
    attn = 3 * 2 * 2 * cfg.num_layers * cfg.num_heads \
        * cfg.resolved_head_dim * seq * tokens
    return 6.0 * lm_matmul_params(cfg) * tokens + attn


def lm_train_steps(model, cfg, adam, batch, n_steps, label, smi):
    """A warm-up step, then `n_steps` timed ones on `batch`; the gates:
    every loss and grad norm finite, the last loss below the first."""
    import torch
    from repro_torch.convert import lm_param_tree
    from repro_torch.train import init_state, make_train_step

    step = make_train_step(cfg, model, adam,
                           num_microbatches=LM_TRAIN_MICRO,
                           loss_kwargs=dict(q_chunk=512))
    state = init_state(lm_param_tree(model), adam)
    losses, norms, times = [], [], []
    for i in range(n_steps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    check(all(math.isfinite(x) for x in losses + norms),
          f"{label}: a loss or grad norm is not finite: {losses} {norms}")
    check(losses[-1] < losses[0],
          f"{label}: the loss did not fall: {losses}")
    log(f"{label} on {smi}: losses {losses}, grad norms {norms}, step "
        f"seconds {times}")
    return state, losses, norms, times, step


def lm_remat_peaks(model, cfg, batch, smi) -> dict:
    """(c) Peak memory of one microbatch's gradients at (a)'s shape under
    each remat policy (no optimizer state held)."""
    import torch
    from repro_torch.convert import lm_param_tree
    from repro_torch.models.common import remat_policy
    from repro_torch.train.train_step import accumulate_grads, \
        split_microbatches

    micro = split_microbatches(batch, LM_TRAIN_MICRO)[0]
    params = lm_param_tree(model.requires_grad_(True))
    out = {}
    for policy in ("full", "dots", "none"):
        lm_release()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated() / 2 ** 30
        with remat_policy(policy):
            grads, loss = accumulate_grads(model, params, micro,
                                           loss_kwargs=dict(q_chunk=512))
        torch.cuda.synchronize()
        out[policy] = dict(peak_gib=torch.cuda.max_memory_allocated()
                           / 2 ** 30, weights_gib=base, loss=float(loss))
        del grads
    lm_release()
    log(f"remat peaks, one microbatch of {tuple(micro['tokens'].shape)} "
        f"on {smi}: {out}")
    return out


def lm_train_full_width(drive, smi, scores):
    """(a) Qwen2-7B at full width, 8 layers, trained on PageRank-weighted
    batches: fp32 moments, then int8 moments from the same weights; (c)'s
    peaks at its shape."""
    import dataclasses
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.convert import lm_param_tree
    from repro_torch.data import DataConfig, PageRankWeightedSampler
    from repro_torch.launch.train import make_batch
    from repro_torch.train import AdamWConfig, apply_updates
    from repro_torch.train.train_step import accumulate_grads

    cfg = dataclasses.replace(get_config(LM_TRAIN_ARCH),
                              num_layers=LM_TRAIN_LAYERS)
    sampler = PageRankWeightedSampler(scores, DataConfig(
        vocab_size=cfg.vocab_size, seq_len=LM_TRAIN_SEQ,
        global_batch=LM_TRAIN_BATCH, seed=0))
    nb = sampler.batch_at(0)
    top = np.argsort(-sampler.p)[:10]
    log(f"lm train batch: PageRank-weighted docs {nb['doc_ids'].tolist()} "
        f"(their score ranks {[int((sampler.p > sampler.p[d]).sum()) for d in nb['doc_ids']]}; "
        f"top-10 docs hold {sampler.p[top].sum():.4f} of the mass)")
    batch = make_batch(cfg, nb, "cuda")
    out = dict(arch=cfg.name, layers=cfg.num_layers, reduced=dict(
        num_layers=[28, cfg.num_layers]), doc_ids=nb["doc_ids"].tolist())

    model, init_s = lm_build(cfg)
    n_params = sum(p.numel() for p in model.parameters())
    out.update(lm_describe(model, init_s), params=n_params)
    out["remat_peaks"] = lm_remat_peaks(model, cfg, batch, smi)

    adam = AdamWConfig(lr=LM_TRAIN_LR)
    (state, losses, norms, times, step), secs, peak = drive(
        f"{cfg.name} x{cfg.num_layers} train, fp32 moments",
        lambda: lm_train_steps(model, cfg, adam, batch, LM_TRAIN_STEPS,
                               "train fp32", smi), [])
    check(peak < LM_TRAIN_PEAK_GIB,
          f"training peak {peak:.2f} GiB >= {LM_TRAIN_PEAK_GIB}")
    profiled = {}
    state = profile_rounds(
        lambda st: step(st, batch)[0], state, 1,
        f"{cfg.name} x{cfg.num_layers} train step, profiled, on {smi}",
        top=12, stats=profiled, groups={
            "GEMMs (nvjet)": "nvjet", "GEMMs (gemm)": "gemm",
            "elementwise": "elementwise_kernel", "reductions": "reduce_kernel",
            "copies": "Memcpy"})
    step_s = sum(times[1:]) / LM_TRAIN_STEPS
    tokens = LM_TRAIN_BATCH * LM_TRAIN_SEQ
    flops = lm_train_flops(cfg, LM_TRAIN_BATCH, LM_TRAIN_SEQ)
    params = lm_param_tree(model)
    grads, _ = accumulate_grads(model, params, batch, LM_TRAIN_MICRO,
                                loss_kwargs=dict(q_chunk=512))
    opt_ms = cuda_ms(lambda: apply_updates(params, grads, state, adam),
                     iters=2)
    dropped = sum(int(b.moe.dropped) for b in model.moe_layers)
    check(dropped == 0, f"{cfg.name}: {dropped} assignments dropped")
    del grads, state
    out["fp32"] = dict(
        losses=losses, grad_norms=norms, step_s=times, step_ms=step_s * 1e3,
        tokens_per_s=tokens / step_s, peak_gib=peak,
        optimizer_ms=opt_ms, optimizer_share=opt_ms / (step_s * 1e3),
        matmul_params=lm_matmul_params(cfg), model_flops=flops,
        model_tflops_per_s=flops / step_s / 1e12,
        share_of_989_tflops=flops / step_s / H100_BF16_DENSE,
        dropped=dropped, profiled=profiled)
    del model, params, step
    lm_release()

    model, _ = lm_build(cfg)
    adam8 = AdamWConfig(lr=LM_TRAIN_LR, int8_moments=True)
    (state, losses8, norms8, times8, _), _, peak8 = drive(
        f"{cfg.name} x{cfg.num_layers} train, int8 moments",
        lambda: lm_train_steps(model, cfg, adam8, batch,
                               LM_TRAIN_INT8_STEPS - 1, "train int8", smi),
        [])
    out["int8"] = dict(losses=losses8, grad_norms=norms8, step_s=times8,
                       peak_gib=peak8, peak_fall_gib=peak - peak8,
                       peak_fall_bytes_per_param=(peak - peak8) * 2 ** 30
                       / n_params)
    del model, state
    lm_release()
    f = out["fp32"]
    log(f"lm train (a) {cfg.name} d={cfg.d_model} x{cfg.num_layers} layers "
        f"({n_params:,} parameters), {LM_TRAIN_BATCH} x {LM_TRAIN_SEQ} "
        f"tokens, {LM_TRAIN_MICRO} microbatches, remat full, on {smi}: "
        f"step {f['step_ms']:.1f} ms, {f['tokens_per_s']:.0f} tokens/s, "
        f"peak {peak:.2f} GiB (int8 moments {peak8:.2f}), optimizer "
        f"{opt_ms:.1f} ms ({f['optimizer_share']:.1%} of a step), "
        f"{flops:.4g} model FLOPs a step = {f['model_tflops_per_s']:.1f} "
        f"TFLOP/s, {f['share_of_989_tflops']:.1%} of the data sheet's "
        f"989 TFLOP/s dense bf16")
    return out


def lm_master_diffs(a, b, lr) -> tuple:
    """(max, mean) |a - b| / lr over two AdamW states' masters."""
    from repro_torch.train.optimizer import tree_leaves
    worst, total, count = 0.0, 0.0, 0
    for x, y in zip(tree_leaves(a.master), tree_leaves(b.master)):
        d = (x.cpu() - y.cpu()).abs()
        worst = max(worst, float(d.max()))
        total, count = total + float(d.sum()), count + d.numel()
    return worst / lr, total / count / lr


def lm_train_reduced_card_vs_cpu(smi):
    """(b) One train step of each reduced config on the card against the
    same step on the CPU, same weights and batch."""
    from repro_torch.configs import reduced_config
    from repro_torch.convert import lm_param_tree
    from repro_torch.data import DataConfig, SyntheticTokens
    from repro_torch.launch.train import make_batch
    from repro_torch.models import get_model
    from repro_torch.train import AdamWConfig, init_state, make_train_step

    out = {}
    adam = AdamWConfig(lr=LM_TRAIN_CPU_LR)
    for arch in LM_REDUCED_ARCHS:
        cfg = reduced_config(arch)
        nb = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size,
                                        seq_len=16, global_batch=4)).batch_at(0)
        res = []
        cpu = get_model(cfg)(cfg, device="cpu", seed=0)
        card = get_model(cfg)(cfg, seed=None)
        card.load_state_dict(cpu.state_dict())
        for m in (cpu, card):
            step = make_train_step(cfg, m, adam, num_microbatches=2,
                                   loss_kwargs=dict(q_chunk=8))
            state, met = step(init_state(lm_param_tree(m), adam),
                              make_batch(cfg, nb, m.device))
            res.append((state, float(met["loss"]), float(met["grad_norm"])))
        loss_err = abs(res[0][1] - res[1][1]) / abs(res[0][1])
        worst, mean = lm_master_diffs(res[0][0], res[1][0], adam.lr)
        check(loss_err < LM_TRAIN_LOSS_TOL and worst <= 2.2
              and mean <= LM_TRAIN_MEAN_TOL,
              f"{arch} reduced train step: card vs CPU loss {loss_err}, "
              f"masters {worst} lr at most, {mean} lr on average")
        out[arch] = dict(loss_rel=loss_err, grad_norm_rel=abs(
            res[0][2] - res[1][2]) / res[0][2], master_max_lr=worst,
            master_mean_lr=mean)
    log(f"reduced configs, one train step card vs CPU on {smi}: {out} "
        f"(loss < {LM_TRAIN_LOSS_TOL}, masters <= 2.2 lr, mean <= "
        f"{LM_TRAIN_MEAN_TOL} lr)")
    return out


def lm_remat_agree(smi):
    """(c) Loss and gradients of one reduced config on the card under the
    three remat policies, against "none"."""
    import torch
    from repro_torch.configs import reduced_config
    from repro_torch.convert import lm_param_tree
    from repro_torch.data import DataConfig, SyntheticTokens
    from repro_torch.launch.train import make_batch
    from repro_torch.models import get_model
    from repro_torch.models.common import remat_policy
    from repro_torch.train.optimizer import tree_leaves
    from repro_torch.train.train_step import accumulate_grads

    cfg = reduced_config(LM_REMAT_ARCH)
    model = get_model(cfg)(cfg, seed=0).requires_grad_(True)
    params = lm_param_tree(model)
    batch = make_batch(cfg, SyntheticTokens(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=32, global_batch=4)).batch_at(0),
        "cuda")
    runs = {}
    for policy in ("none", "full", "dots"):
        with remat_policy(policy):
            grads, loss = accumulate_grads(model, params, batch,
                                           loss_kwargs=dict(q_chunk=8))
        runs[policy] = (float(loss), [
            t.float() for leaf in tree_leaves(grads)
            for t in (leaf if isinstance(leaf, list) else [leaf])])
    out = {}
    for policy in ("full", "dots"):
        loss_err = abs(runs[policy][0] - runs["none"][0]) / runs["none"][0]
        grad_err = max(float((a - b).abs().max() / b.abs().max().clamp(
            min=1e-12)) for a, b in zip(runs[policy][1], runs["none"][1]))
        check(loss_err < LM_REMAT_TOL and grad_err < LM_REMAT_TOL,
              f"remat {policy} vs none: loss {loss_err}, grads {grad_err}")
        out[policy] = dict(loss_rel=loss_err, grad_rel=grad_err)
    log(f"remat policies on {cfg.name} reduced on {smi}, against none: "
        f"{out} (< {LM_REMAT_TOL} of each leaf's largest)")
    return out


LM_PG_DIR = ROOT / "build" / "lm_process"
LM_PG_ARCHS = ("dbrx-132b", "qwen2-7b", "deepseek-v2-236b", "internvl2-1b",
               "mamba2-1.3b", "recurrentgemma-9b", "whisper-tiny")
LM_PG_MESH = {"data": 2, "model": 2}
LM_PG_STEPS, LM_PG_BATCH, LM_PG_SEQ = 2, 4, 16
# tests/test_torch_process_group_lm.py's TOL_PARAM, TOL_LOSS, TOL_UPDATE
# and NOISE_LEAVES: the model ranks' partial outputs and the data ranks'
# gradients add in other orders than one process's; the update of each
# leaf's masters is held in norm to the reference's (`lm_update_errs`),
# but for the key biases (Qwen2's, InternVL2's), whose gradient is noise
LM_PG_PARAM_TOL, LM_PG_LOSS_TOL, LM_PG_UPDATE_TOL = 4e-3, 2e-3, 0.25
LM_NOISE_LEAVES = ("attn/bk",)
# the dry run's gate at 2x2: a Qwen2-7B-shaped model of d_model 1,024,
# 2 layers and a 32,768-token vocabulary (~100 M parameters), 8 x 1,024
# tokens: its logits (268 MB a process) and attention scores dwarf what
# the allocator adds to each block (up to 1 MB a block of a few MB: a
# reduced model's step, ~90 MB, read 26% above its trace); each child's
# allocator peak against `launch.dryrun.trace_rank` of its rank
LM_PG_GATE_ARCH, LM_PG_GATE_BATCH, LM_PG_GATE_SEQ = "qwen2-7b", 8, 1024
LM_PG_GATE = {}          # the children's peaks, for dryrun_path


def lm_gate_config():
    import dataclasses
    from repro_torch.configs import reduced_config
    return dataclasses.replace(reduced_config(LM_PG_GATE_ARCH), d_model=1024,
                               num_heads=8, num_kv_heads=4, head_dim=128,
                               d_ff=4096, vocab_size=32768)


def bit_digest(t) -> tuple:
    """Two int64 sums of a tensor's bits read as integers of its width,
    plain and weighted by position (wrapping): equal bits give equal
    digests, and one changed element changes both."""
    import torch
    v = t.detach().contiguous().view(-1)
    ints = v.view({1: torch.int8, 2: torch.int16, 4: torch.int32,
                   8: torch.int64}[v.element_size()])
    plain = torch.zeros((), dtype=torch.int64, device=v.device)
    weighted = torch.zeros_like(plain)
    step = 1 << 26
    for lo in range(0, ints.numel(), step):
        c = ints[lo:lo + step].to(torch.int64)
        w = torch.arange(lo, lo + c.numel(), dtype=torch.int64,
                         device=v.device) * 0x9E3779B1 + 1
        plain += c.sum()
        weighted += (c * w).sum()
    return int(plain), int(weighted)


def lm_state_tensors(model, state) -> list:
    """The parameters, then every tensor of an AdamW state, in order."""
    from repro_torch.train.optimizer import tree_leaves
    out = list(model.parameters()) + [state.step]
    for field in (state.master, state.m, state.v):
        for leaf in tree_leaves(field):
            out.extend(leaf if isinstance(leaf, tuple) else [leaf])
    return out


def lm_flat_params(model):
    """`model`'s parameters as float32 numpy arrays by '/'-joined JAX
    path; on a model that keeps blocks every rank must call it, and only
    the mesh's writer gets them (None elsewhere)."""
    from repro_torch.convert import lm_params_to_numpy

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from walk(v, f"{prefix}{k}/")
            else:
                yield prefix + k, v
    tree = lm_params_to_numpy(model)
    return None if tree is None else dict(walk(tree, ""))


def lm_masters(state) -> dict:
    """An AdamW state's masters (whole: one process's, or gathered by
    `state_to_host`) as float32 numpy arrays by '/'-joined JAX path."""
    import numpy as np
    from repro_torch.train.optimizer import leaf_paths, tree_leaves
    return {k: np.asarray(t.cpu() if hasattr(t, "cpu") else t)
            for k, t in zip(leaf_paths(state.master),
                            tree_leaves(state.master))}


def lm_update_errs(got: dict, want: dict, init: dict) -> dict:
    """Each leaf's update error: ||got - want|| / ||want - init|| over
    its masters, in float64: 0 for the reference's update, 1 for none, 2
    for one of the other sign, about 1.4 for another leaf's."""
    import numpy as np
    out = {}
    for k, w in want.items():
        w = w.astype(np.float64)
        ref = np.linalg.norm(w - init[k])
        diff = np.linalg.norm(got[k].astype(np.float64) - w)
        out[k] = float(diff / ref) if ref else (0.0 if diff == 0
                                                else float("inf"))
    return out


def lm_updates_close(errs: dict) -> bool:
    """Every leaf's update error within LM_PG_UPDATE_TOL, but those of
    LM_NOISE_LEAVES; at least one leaf held."""
    held = [e for k, e in errs.items() if not k.endswith(LM_NOISE_LEAVES)]
    return bool(held) and max(held) <= LM_PG_UPDATE_TOL


def lm_state_bytes(state) -> int:
    from repro_torch.train.optimizer import tree_leaves
    return sum(t.numel() * t.element_size()
               for field in (state.master, state.m, state.v)
               for leaf in tree_leaves(field)
               for t in (leaf if isinstance(leaf, tuple) else (leaf,)))


def lm_process_world_one(drive, smi) -> dict:
    """(d) Qwen2-7B x8 through `run_training`, 2 steps, under the local
    mesh and then under an NCCL group of world size 1 (the 1x1 process
    mesh): the parameters and the state bit-equal."""
    import dataclasses
    import datetime
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_local_mesh, make_process_mesh
    from repro_torch.launch.train import run_training

    cfg = dataclasses.replace(get_config(LM_TRAIN_ARCH),
                              num_layers=LM_TRAIN_LAYERS)
    kw = dict(steps=LM_PG_STEPS, global_batch=LM_TRAIN_BATCH,
              seq_len=LM_TRAIN_SEQ, q_chunk=512, log_every=10 ** 6)
    runs = {}
    for label in ("local", "nccl"):
        if label == "nccl":
            dist.init_process_group(
                "nccl", store=dist.FileStore(str(LM_PG_DIR / "store_nccl"),
                                             1),
                rank=0, world_size=1,
                device_id=torch.device("cuda", torch.cuda.current_device()),
                timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
        try:
            mesh = (make_local_mesh() if label == "local"
                    else make_process_mesh({"data": 1, "model": 1}))
            (model, state, losses), secs, peak = drive(
                f"{cfg.name} x{cfg.num_layers} run_training, {label} mesh",
                lambda: run_training(cfg, mesh=mesh, **kw), [])
            runs[label] = dict(
                losses=losses, seconds=secs, peak_gib=peak,
                state_bytes=lm_state_bytes(state),
                digests=[bit_digest(t) for t in lm_state_tensors(model,
                                                                 state)])
            del model, state
        finally:
            if label == "nccl":
                dist.destroy_process_group()
        lm_release()
    check(not dist.is_initialized(), "the NCCL group was not destroyed")
    a, b = runs["local"], runs["nccl"]
    check(a["losses"] == b["losses"] and a["digests"] == b["digests"]
          and a["state_bytes"] == b["state_bytes"],
          f"{cfg.name} x{cfg.num_layers}: the NCCL world-1 process mesh "
          f"differs from the local mesh: losses {a['losses']} vs "
          f"{b['losses']}, {sum(x != y for x, y in zip(a['digests'], b['digests']))}"
          f" of {len(a['digests'])} tensors")
    out = {k: dict(v, digests=len(v["digests"])) for k, v in runs.items()}
    log(f"lm process (d) world 1, {cfg.name} x{cfg.num_layers}, "
        f"{LM_PG_STEPS} steps of {LM_TRAIN_BATCH} x {LM_TRAIN_SEQ} tokens on "
        f"{smi}: NCCL process mesh bit-equal to the local mesh "
        f"({len(a['digests'])} tensors): {out}")
    return out


def lm_group_child(spec: dict) -> int:
    """One process of (d)'s group: gloo with card tensors, every process
    on the one card, the (data 2, model 2) process mesh; `run_training`
    of each reduced config (each rank keeping its blocks of the weights).
    Prints its losses, weight and state bytes as JSON; rank 0 saves the
    parameters (gathered leaf by leaf: every rank takes part). Then the
    dry run's gate step (`lm_gate_peak`)."""
    import datetime
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs import reduced_config
    from repro_torch.convert import lm_param_tree
    from repro_torch.launch.mesh import make_process_mesh
    from repro_torch.launch.train import run_training
    from repro_torch.train.optimizer import state_to_host

    torch.set_num_threads(1)
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dist.init_process_group(
        "gloo", store=dist.FileStore(spec["store"], world), rank=rank,
        world_size=world,
        timeout=datetime.timedelta(seconds=spec["timeout"]))
    out = dict(rank=rank, world=world)
    try:
        mesh = make_process_mesh(LM_PG_MESH, "cuda",
                                 timeout=spec["timeout"])
        for arch in LM_PG_ARCHS:
            t0 = time.perf_counter()
            model, state, losses = run_training(
                reduced_config(arch), steps=LM_PG_STEPS,
                global_batch=LM_PG_BATCH, seq_len=LM_PG_SEQ, q_chunk=16,
                log_every=10 ** 6, mesh=mesh)
            host = state_to_host(state, lm_param_tree(model), mesh)
            weights = lm_flat_params(model)
            if rank == 0:
                np.savez(Path(spec["dir"]) / f"{arch}_params.npz",
                         **weights)
                np.savez(Path(spec["dir"]) / f"{arch}_masters.npz",
                         **lm_masters(host))
            out[arch] = dict(losses=losses, state_bytes=lm_state_bytes(state),
                             weight_bytes=sum(
                                 t.numel() * t.element_size()
                                 for t in model.parameters()),
                             device=str(state.step.device),
                             seconds=time.perf_counter() - t0)
            del model, state, host
        out["gate"] = lm_gate_peak(mesh)
    finally:
        dist.destroy_process_group()
    print(json.dumps(out))
    return 0


def lm_gate_peak(mesh) -> dict:
    """The dry run's gate step on this rank of a process mesh: the rise
    of the allocator's peak over what was allocated before the model was
    built, across the second of two steps (the first warms up), as
    `dryrun_vs_card` measures one card's."""
    import torch
    from repro_torch.convert import lm_param_tree
    from repro_torch.data import DataConfig, SyntheticTokens
    from repro_torch.launch.train import make_batch
    from repro_torch.models import get_model
    from repro_torch.sharding import ShardingRules, active_rules, \
        default_rules
    from repro_torch.train import AdamWConfig, init_state, make_train_step

    cfg = lm_gate_config()
    lm_release()        # the runs before it leave nothing in the base
    base = torch.cuda.memory_allocated()
    adam = AdamWConfig()
    dev = mesh.devices[0]
    with active_rules(ShardingRules(mesh, default_rules(False))):
        model = get_model(cfg)(cfg, device=dev, seed=0, mesh=mesh)
        state = init_state(lm_param_tree(model), adam, mesh=mesh)
        step = make_train_step(cfg, model, adam, mesh=mesh,
                               loss_kwargs=dict(q_chunk=512))
        batch = make_batch(cfg, SyntheticTokens(DataConfig(
            vocab_size=cfg.vocab_size, seq_len=LM_PG_GATE_SEQ,
            global_batch=LM_PG_GATE_BATCH, seed=0)).batch_at(0), dev)
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        state, _ = step(state, batch)
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del model, state, step, batch
    return dict(peak_bytes=peak, rank=mesh.coords)


def lm_process_group(smi) -> dict:
    """(d) Four child processes on the one card over gloo with card
    tensors, at (data 2, model 2): each reduced config's 2 steps against
    the same steps in this process under the local mesh."""
    import numpy as np
    from repro_torch.configs import reduced_config
    from repro_torch.launch.train import run_training
    from repro_torch.train.optimizer import QBLOCK, tree_leaves

    world = LM_PG_MESH["data"] * LM_PG_MESH["model"]
    t0 = time.perf_counter()
    outs = run_process_group(world, dict(dir=str(LM_PG_DIR)), "lm",
                             flag="--lm-group-child", where=LM_PG_DIR)
    group_s = time.perf_counter() - t0
    res = {}
    for arch in LM_PG_ARCHS:
        kw = dict(global_batch=LM_PG_BATCH, seq_len=LM_PG_SEQ, q_chunk=16,
                  log_every=10 ** 6)
        init = lm_masters(run_training(reduced_config(arch), steps=0,
                                       **kw)[1])
        model, state, losses = run_training(
            reduced_config(arch), steps=LM_PG_STEPS, **kw)
        whole = lm_state_bytes(state)
        leaves = sum(1 for _ in tree_leaves(state.master))
        rows = [o[arch] for o in outs]
        check(all(r["losses"] == rows[0]["losses"] for r in rows)
              and all(r["device"].startswith("cuda") for r in rows),
              f"{arch} at 2x2: the processes' losses differ: {rows}")
        loss_rel = max(abs(a - b) / abs(b)
                       for a, b in zip(rows[0]["losses"], losses))
        per = [r["state_bytes"] for r in rows]
        slack = leaves * QBLOCK * 12          # a block of master, m, v
        check(all(whole / world <= b <= whole / world + slack for b in per),
              f"{arch} at 2x2: state bytes {per} a process, whole {whole}")
        weights = [r["weight_bytes"] for r in rows]
        whole_w = sum(t.numel() * t.element_size()
                      for t in model.parameters())
        check(all(w <= whole_w / 2 for w in weights),
              f"{arch} at 2x2: weight bytes {weights} a process, whole "
              f"{whole_w}: not blocks")
        got = np.load(LM_PG_DIR / f"{arch}_params.npz")
        want = lm_flat_params(model)
        check(sorted(got.files) == sorted(want),
              f"{arch}: parameter names differ")
        err = max(float(np.abs(got[k] - want[k]).max()) for k in want)
        upd = lm_update_errs(dict(np.load(LM_PG_DIR / f"{arch}_masters.npz")),
                             lm_masters(state), init)
        check(loss_rel <= LM_PG_LOSS_TOL and err <= LM_PG_PARAM_TOL
              and lm_updates_close(upd),
              f"{arch} at 2x2 vs one process on the card: losses "
              f"{rows[0]['losses']} vs {losses} ({loss_rel}), parameters "
              f"{err} apart, update errors {upd}")
        res[arch] = dict(losses=rows[0]["losses"], single_losses=losses,
                         loss_rel=loss_rel, param_max_abs=err,
                         update_err=upd,
                         state_bytes_a_process=per, state_bytes_whole=whole,
                         weight_bytes_a_process=weights,
                         weight_bytes_whole=whole_w,
                         child_seconds=[r["seconds"] for r in rows])
        del model, state
    LM_PG_GATE.clear()
    LM_PG_GATE.update({r: o["gate"] for r, o in enumerate(outs)})
    log(f"lm process (d) gloo, {world} processes on the card at "
        f"{LM_PG_MESH}, {group_s:.1f} s on {smi}: {res}; the dry run's "
        f"gate step's peaks: {LM_PG_GATE}")
    return dict(res, group_s=group_s, gate=dict(LM_PG_GATE))


def lm_train_process(drive, smi) -> dict:
    """(d) The train step over one process a shard."""
    shutil.rmtree(LM_PG_DIR, ignore_errors=True)
    LM_PG_DIR.mkdir(parents=True)
    try:
        return dict(world_one=lm_process_world_one(drive, smi),
                    gloo_2x2=lm_process_group(smi))
    finally:
        shutil.rmtree(LM_PG_DIR, ignore_errors=True)


def lm_train_path(drive, smi, scores):
    """The LM training path: (a) Qwen2-7B at full width on PageRank-
    weighted batches, (b) the reduced configs' train step card vs CPU,
    (c) the remat policies, (d) the step over one process a shard.
    Launches none of the five kernels."""
    log(f"lm train path on {smi}")
    out = {}
    for key, phase in (
            ("full_width", lambda: lm_train_full_width(drive, smi, scores)),
            ("reduced", lambda: lm_train_reduced_card_vs_cpu(smi)),
            ("remat", lambda: lm_remat_agree(smi)),
            ("process", lambda: lm_train_process(drive, smi))):
        t0 = time.perf_counter()
        out[key] = phase()
        out[key + "_phase_s"] = time.perf_counter() - t0
        log(f"lm train phase {key}: {out[key + '_phase_s']:.2f} s")
        lm_release()
    log(f"lm train: {smi} " + json.dumps(out, default=str))
    return out


# The whole sweep takes far more than the 120 s of host time the smoke
# gives it (the >30 B configs' train cells trace 4 or 16 microbatches of
# 40-96 layers, 2.5-13 minutes each on the card's host; PERF.md), so the
# smoke traces these cells: Qwen2-7B's four, every decode_32k and
# long_500k, and the train_4k cells of the hybrid and audio families.
# `python -m repro_torch.launch.dryrun --all` traces all 40.
DRYRUN_SMOKE_CELLS = (
    [("qwen2-7b", s) for s in ("train_4k", "prefill_32k", "decode_32k",
                               "long_500k")]
    + [(a, s) for a in ("deepseek-v2-236b", "dbrx-132b", "nemotron-4-340b",
                        "h2o-danube-3-4b", "qwen3-32b", "mamba2-1.3b",
                        "recurrentgemma-9b", "internvl2-1b", "whisper-tiny")
       for s in ("decode_32k", "long_500k")]
    + [(a, "train_4k") for a in ("recurrentgemma-9b", "whisper-tiny")])
DRYRUN_ARGS_TOL = 0.01            # (b) argument bytes, relative
DRYRUN_PEAK_TOL = 0.20            # (b) peak bytes, relative
MOE_SHARDED_ARCH = "dbrx-132b"
MOE_SHARDED_B, MOE_SHARDED_T = 2, 64
MOE_SHARDED_MESH = {"data": 2, "model": 2}
# the 2x2 mesh against the gather path: each model shard's partial
# output is rounded to bf16 by its own down-projection before the sum
# (the gather path rounds once), as tests/test_torch_moe_sharded.py
MOE_SHARDED_TOL = 2e-2            # relative to the largest |out|


def dryrun_sweep(smi) -> dict:
    """(a) Every (arch x shape) cell of `launch.dryrun` at full width on
    the 1x1 mesh (fake tensors on the card, nothing allocated), with the
    per-device argument bytes at pod16x16 and pod2x16x16; every traced
    cell `ok`, or `skipped` with the JAX package's reason. The cells of
    DRYRUN_SMOKE_CELLS are traced."""
    from repro_torch.configs import ARCHS, SHAPES, get_config, \
        shape_applicable
    from repro_torch.launch import dryrun

    cells = DRYRUN_SMOKE_CELLS
    log(f"dryrun (a): {len(cells)} of {len(ARCHS) * len(SHAPES)} cells "
        f"traced; per-device arguments for all {len(ARCHS) * len(SHAPES)}")
    out, t0 = {}, time.perf_counter()
    for arch in ARCHS:
        cfg = get_config(arch)
        for shape_name, shape in SHAPES.items():
            row = {}
            if shape_applicable(cfg, shape):
                row = {m: dryrun.mesh_argument_bytes(cfg, shape, mp)
                       for m, mp in dryrun.MESHES.items()}
            if (arch, shape_name) not in cells:
                out[f"{arch}__{shape_name}"] = dict(
                    status="not traced", per_device_argument_bytes=row)
                continue
            t1 = time.perf_counter()
            traced = {}

            def trace(cfg=cfg, shape=shape, traced=traced):
                if not traced:
                    traced.update(dryrun.trace_cell(cfg, shape))
                return traced

            # (the rank traces of the production meshes, a few minutes of
            # host time a cell, are the CLI's: PERF.md)
            rec = {m: dryrun.cell_record(arch, shape_name, m, trace)
                   for m in dryrun.MESHES}
            r = rec["pod16x16"]
            check(r["status"] in ("ok", "skipped"),
                  f"dryrun {arch} {shape_name}: {r['status']} "
                  f"{r.get('reason')}")
            if r["status"] == "skipped":
                check("long_500k needs sub-quadratic attention" in
                      r["reason"], f"dryrun {arch} {shape_name}: skipped "
                      f"for {r['reason']}")
                log(f"  [skipped] {arch} {shape_name}: {r['reason']}")
                out[f"{arch}__{shape_name}"] = dict(status="skipped")
                continue
            for m in dryrun.MESHES:
                check(rec[m]["per_device"]["argument_bytes"] == row[m],
                      f"dryrun {arch} {shape_name} {m}: per-device bytes")
            roof = r["roofline"]
            peak = r["memory"]["peak_bytes"]
            row = dict(
                status="ok", flops=r["cost"]["flops"],
                bytes_accessed=r["cost"]["bytes_accessed"],
                argument_gib=r["memory"]["argument_size_in_bytes"] / 2 ** 30,
                peak_gib=peak / 2 ** 30, fits_80gb=r["fits_80gb"],
                bottleneck=roof["bottleneck"], step_s=roof["step_time"],
                model_flops=roof["model_flops"],
                microbatches=r["microbatches"],
                per_device_argument_gib={
                    m: rec[m]["per_device"]["argument_bytes"] / 2 ** 30
                    for m in dryrun.MESHES},
                trace_s=r["t_trace_s"], host_s=time.perf_counter() - t1)
            out[f"{arch}__{shape_name}"] = row
            log(f"  [ok] {arch} {shape_name}: {row['flops']:.4g} FLOPs, "
                f"args {row['argument_gib']:.2f} GiB, peak "
                f"{row['peak_gib']:.2f} GiB (fits 80 GB: "
                f"{row['fits_80gb']}), {row['bottleneck']}-bound, roofline "
                f"step {row['step_s'] * 1e3:.3f} ms; per device "
                f"{row['per_device_argument_gib']['pod16x16']:.3f} GiB "
                f"(16x16), "
                f"{row['per_device_argument_gib']['pod2x16x16']:.3f} GiB "
                f"(2x16x16); traced in {row['trace_s']:.2f} s")
    host_s = time.perf_counter() - t0
    log(f"dryrun (a) on {smi}: {host_s:.1f} s of host time")
    return dict(cells=out, host_s=host_s)


def dryrun_vs_card(smi) -> dict:
    """(b) The dry run of lm_train_path (a)'s step (Qwen2-7B x8, 4 x 1,024
    tokens, 2 microbatches, remat full, fp32 moments) against the card:
    argument bytes against the rise of memory_allocated() across model,
    state and batch init; peak against max_memory_allocated() of a step;
    FLOPs against FlopCounterMode around that real step."""
    import dataclasses
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.device import resolve_device
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.sharding import ShardingRules, active_rules, \
        default_rules

    cfg = dataclasses.replace(get_config(LM_TRAIN_ARCH),
                              num_layers=LM_TRAIN_LAYERS)
    shape = ShapeConfig("lm_train_path", LM_TRAIN_SEQ, LM_TRAIN_BATCH,
                        "train")
    kw = dict(q_chunk=512, microbatches=LM_TRAIN_MICRO, int8_moments=False)
    fake = dryrun.trace_cell(cfg, shape, **kw)
    lm_release()
    base = torch.cuda.memory_allocated()
    cell = dryrun.build_cell(cfg, shape, resolve_device(None), seed=0, **kw)
    torch.cuda.synchronize()
    rise = torch.cuda.memory_allocated() - base
    rules = ShardingRules(make_local_mesh(), default_rules(False))
    with active_rules(rules):
        cell["run"]()                                  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with FlopCounterMode(display=False) as fc:
            cell["run"]()
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    real_flops = fc.get_total_flops()
    del cell
    lm_release()
    out = dict(
        argument_bytes=fake["argument_bytes"], allocated_rise=rise,
        argument_gap=fake["argument_bytes"] / rise - 1,
        peak_bytes=fake["peak_bytes"], max_allocated=peak,
        peak_gap=fake["peak_bytes"] / peak - 1,
        fake_flops=fake["flops"], real_flops=real_flops,
        model_flops=lm_train_flops(cfg, LM_TRAIN_BATCH, LM_TRAIN_SEQ),
        trace_s=fake["trace_s"])
    log(f"dryrun (b) {cfg.name} x{cfg.num_layers}, {LM_TRAIN_BATCH} x "
        f"{LM_TRAIN_SEQ} tokens, {LM_TRAIN_MICRO} microbatches, remat full, "
        f"fp32 moments, on {smi}: arguments {fake['argument_bytes']:,} B "
        f"predicted, {rise:,} B allocated ({out['argument_gap']:+.4%}); "
        f"peak {fake['peak_bytes'] / 2 ** 30:.2f} GiB predicted, "
        f"{peak / 2 ** 30:.2f} GiB max allocated ({out['peak_gap']:+.2%}); "
        f"FLOPs {fake['flops']:.6g} fake, {real_flops:.6g} on the card, "
        f"{out['model_flops']:.4g} model FLOPs (lm_train_flops)")
    check(abs(out["argument_gap"]) <= DRYRUN_ARGS_TOL,
          f"dryrun (b): argument bytes {out['argument_gap']:+.4%} off")
    check(abs(out["peak_gap"]) <= DRYRUN_PEAK_TOL,
          f"dryrun (b): peak {out['peak_gap']:+.2%} off")
    check(fake["flops"] == real_flops,
          f"dryrun (b): {fake['flops']} fake FLOPs, {real_flops} real")
    return out


def dryrun_rank_vs_gloo(smi) -> dict:
    """(d) The dry run's rank trace (`launch.dryrun.trace_rank`) of each
    rank of (d)'s gloo 2x2 group at its gate step (`lm_gate_peak`):
    its peak against the rise of that process's allocator peak, within
    DRYRUN_PEAK_TOL."""
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.launch import dryrun

    check(len(LM_PG_GATE) == LM_PG_MESH["data"] * LM_PG_MESH["model"],
          f"dryrun (d): (d)'s gloo gate peaks missing: {LM_PG_GATE}")
    cfg = lm_gate_config()
    shape = ShapeConfig("lm_pg_gate", LM_PG_GATE_SEQ, LM_PG_GATE_BATCH,
                        "train")
    out = {}
    for rank, real in sorted(LM_PG_GATE.items()):
        fake = dryrun.trace_rank(cfg, shape, LM_PG_MESH, rank, q_chunk=512,
                                 int8_moments=False)
        gap = fake["peak_bytes"] / real["peak_bytes"] - 1
        out[rank] = dict(peak_bytes=fake["peak_bytes"],
                         temp_bytes=fake["temp_bytes"],
                         coll_bytes=fake["coll_bytes"],
                         max_allocated=real["peak_bytes"], peak_gap=gap)
    log(f"dryrun (d) {cfg.name}-shaped, d_model {cfg.d_model}, "
        f"{cfg.num_layers} layers, vocab {cfg.vocab_size}, "
        f"{LM_PG_GATE_BATCH} x {LM_PG_GATE_SEQ} tokens at {LM_PG_MESH}, "
        f"each rank's trace against its gloo process on {smi}: {out}")
    for rank, row in out.items():
        check(abs(row["peak_gap"]) <= DRYRUN_PEAK_TOL,
              f"dryrun (d): rank {rank}'s peak {row['peak_gap']:+.2%} off "
              "gloo's")
    return out


def moe_sharded_check(smi) -> dict:
    """(c) One DBRX-132B MoE layer at full width (capacity E/k: nothing
    can drop): the sharded path on the 1x1 mesh against the gather path,
    bit for bit (deterministic algorithms on: the combine's index_add_
    otherwise sums with atomics in no fixed order); on a stacked 2x2 mesh
    within MOE_SHARDED_TOL; 0 drops; the time of each path."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.device import resolve_device
    from repro_torch.launch.mesh import make_local_mesh, make_stacked_mesh
    from repro_torch.models import moe
    from repro_torch.sharding import ShardingRules, active_rules, \
        default_rules

    base = get_config(MOE_SHARDED_ARCH)
    cfg = dataclasses.replace(base, capacity_factor=base.num_experts
                              / base.num_experts_per_tok)
    dev = resolve_device(None)
    gen = torch.Generator(device=dev).manual_seed(0)
    layer = moe.MoE(cfg, device=dev, gen=gen)
    x = torch.randn((MOE_SHARDED_B, MOE_SHARDED_T, cfg.d_model),
                    generator=gen, device=dev).to(torch.bfloat16)
    local = ShardingRules(make_local_mesh(), default_rules(False))
    stacked = ShardingRules(make_stacked_mesh(MOE_SHARDED_MESH),
                            default_rules(False))

    def run(rules):
        if rules is None:
            return moe.moe_forward(layer, x, cfg)
        with active_rules(rules):
            return moe.moe_forward(layer, x, cfg)

    out = {}
    with torch.no_grad():
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            g_out, g_aux = run(None)
            s_out, s_aux = run(local)
        finally:
            torch.use_deterministic_algorithms(False)
        check(torch.equal(g_out, s_out),
              "moe (c): the 1x1 sharded path differs from the gather path")
        check(abs(float(g_aux) - float(s_aux)) < 1e-5,
              f"moe (c): aux {float(g_aux)} vs {float(s_aux)} at 1x1")
        layer.dropped.zero_()
        t_out, t_aux = run(stacked)
        err = float((t_out.float() - g_out.float()).abs().max()
                    / g_out.float().abs().max())
        out.update(max_rel_err_2x2=err, aux=float(g_aux),
                   aux_2x2=float(t_aux), dropped_2x2=int(layer.dropped))
        layer.dropped.zero_()
        run(None)
        out["dropped_gather"] = int(layer.dropped)
        check(err <= MOE_SHARDED_TOL,
              f"moe (c): 2x2 stacked {err:.3g} off the gather path")
        check(out["dropped_2x2"] == out["dropped_gather"] == 0,
              f"moe (c): drops {out['dropped_2x2']}, "
              f"{out['dropped_gather']}")
        for key, rules in (("gather_ms", None), ("sharded_1x1_ms", local),
                           ("sharded_2x2_ms", stacked)):
            out[key] = cuda_ms(lambda r=rules: run(r), iters=10)
    log(f"moe (c) {cfg.name} layer (d {cfg.d_model}, {cfg.num_experts} "
        f"experts top-{cfg.num_experts_per_tok}, moe_d_ff {cfg.moe_d_ff}), "
        f"B={MOE_SHARDED_B} T={MOE_SHARDED_T} bf16, capacity factor "
        f"{cfg.capacity_factor}, on {smi}: 1x1 sharded == gather bit for "
        f"bit; 2x2 stacked max error {err:.3g} of the largest |out| "
        f"(tolerance {MOE_SHARDED_TOL}), aux {out['aux']:.6g} / "
        f"{out['aux_2x2']:.6g}, drops {out['dropped_gather']} / "
        f"{out['dropped_2x2']}; gather {out['gather_ms']:.3f} ms, sharded "
        f"1x1 {out['sharded_1x1_ms']:.3f} ms, sharded 2x2 "
        f"{out['sharded_2x2_ms']:.3f} ms")
    del layer, x
    lm_release()
    return out


def dryrun_path(drive, smi):
    """The dry run and the sharded MoE: (a) the sweep, (b) the dry run
    against the card, (c) the sharded MoE on the card, (d) the rank
    traces (`launch.dryrun.trace_rank`) against lm_train_path (d)'s gloo
    2x2 processes. Launches none
    of the five kernels: each part is driven with the counters at 0 and
    must leave them there."""
    log(f"dryrun path on {smi}")
    out = {}
    for key, phase in (("sweep", lambda: dryrun_sweep(smi)),
                       ("vs_card", lambda: dryrun_vs_card(smi)),
                       ("moe_sharded", lambda: moe_sharded_check(smi)),
                       ("rank_vs_gloo", lambda: dryrun_rank_vs_gloo(smi))):
        out[key], secs, _ = drive(f"dryrun {key}", phase, [])
        check(not any(drive.last.values()),
              f"dryrun {key} launched kernels: {drive.last}")
        out[key + "_phase_s"] = secs
        log(f"dryrun phase {key}: {secs:.2f} s")
        lm_release()
    log(f"dryrun: {smi} " + json.dumps(out, default=str))
    return out


def main() -> int:
    import torch
    if sys.argv[1:2] == ["--process-group-child"]:
        return process_group_child(json.loads(sys.argv[2]))
    if sys.argv[1:2] == ["--lm-group-child"]:
        return lm_group_child(json.loads(sys.argv[2]))
    if sys.argv[1:2] == ["--lm-serve-child"]:
        return lm_serve_child(json.loads(sys.argv[2]))
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

    t_start = time.perf_counter()
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

    drive = Runner()
    phases = {}
    try:
        t0 = time.perf_counter()
        rows, threefry_ms = kernel_phase(g, K)
        sampler_phase(g, K, rows)
        torch.cuda.empty_cache()
        rows["walk_step"] = walk_step_phase(g, K)
        torch.cuda.empty_cache()
        rows["uniform"] = uniform_phase(g.n * K, g.device)
        torch.cuda.empty_cache()
        phases["kernels"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        runs, pi_ref, counts_zeta = main_path(g, K, drive)
        phases["single_device"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        sharded = sharded_path(g, K, drive, pi_ref, counts_zeta)
        phases["sharded"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        process_group_path(g, K, drive, sharded, counts_zeta)
        phases["process_group"] = time.perf_counter() - t0
        log(f"process group phase: {phases['process_group']:.1f} s")
        t0 = time.perf_counter()
        elastic_path(g, K, sharded["walks"]["K"], drive, pi_ref, counts_zeta,
                     sharded["counts"]["rounds"])
        phases["elastic"] = time.perf_counter() - t0
        log(f"elastic phase: {phases['elastic']:.1f} s")
        del counts_zeta
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        three, phase_rows, cells_row = three_phase_path(
            drive, sharded["counts"]["rounds"])
        rows["multinomial_rows"]["phase1_cells"] = cells_row
        rows["three_phase_calls"] = phase_rows
        phases["three_phase"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        ppr, rows["ppr_superstep"] = ppr_path(g, drive)
        phases["ppr"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        audit = audit_path(g, K, drive, pi_ref, ppr)
        phases["audit"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        cli_phase()
        phases["cli"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        small_check()
        phases["small"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        lm = lm_serve_path(drive, smi)
        phases["lm"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        lm_train_path(drive, smi, runs.pop("scores"))
        phases["lm_train"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        dryrun_path(drive, smi)
        phases["dryrun"] = time.perf_counter() - t0
    except PhaseError as e:
        log(f"FAILED: {e}")
        return 1

    walks = runs["walks"]
    share = 2 * walks["rounds"] * threefry_ms / 1e3 / walks["seconds"]
    log(f"phases: build {build_s:.2f} s, graph {graph_s:.2f} s, power "
        f"iteration {runs['power_iteration']['seconds']:.3f} s, walks "
        f"{walks['seconds']:.3f} s (uniform kernel ~{share:.1%}: 2 draws x "
        f"{walks['rounds']} rounds x {threefry_ms:.3f} ms), counts "
        f"{runs['counts']['seconds']:.3f} s, sharded counts P=4 "
        f"{sharded['counts']['seconds']:.3f} s, sharded walks P=2 "
        f"{sharded['walks']['seconds']:.3f} s; three-phase "
        f"{ {k: round(v['seconds'], 3) for k, v in three.items()} }; PPR "
        f"batched {ppr['batched']['seconds']:.3f} s "
        f"({ppr['batched']['supersteps']} supersteps), single-query "
        f"{ppr['single']['seconds']:.3f} s ({ppr['single']['rounds']} "
        f"rounds), service {ppr['service']['supersteps']} supersteps; by "
        f"phase "
        f"{ {k: round(v, 2) for k, v in phases.items()} }; whole script "
        f"{time.perf_counter() - t_start:.1f} s")

    replaces = {
        "histogram": "src/repro/kernels/histogram/histogram.py:67",
        "segment_spmv": "src/repro/kernels/segment_spmv/segment_spmv.py:66",
        "multinomial_rows":
            "src/repro/kernels/multinomial_rows/multinomial_rows.py:47",
        "walk_step": "src/repro/kernels/walk_step/walk_step.py:69",
        # no TPU kernel: XLA fused jax.random.uniform into its consumers
        "uniform": "src/repro/core/engine_walks.py:59",
    }
    kernels = []
    for name in replaces:
        row = rows[name]
        kernels.append(dict(
            name=name, route="cuda",
            source=str(common.SOURCES[name].relative_to(ROOT)),
            replaces=replaces[name], launches=drive.launches[name],
            max_abs_err=row["max_abs_err"], ms=row["ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"]))
    log("kernel detail: " + json.dumps(rows, default=str))
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
