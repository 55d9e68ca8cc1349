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

3. this script as the LM worker (`--lm-worker`): the LM training step
   with one process a card over NCCL (`launch.mesh.make_process_mesh`,
   ZeRO-1 AdamW state), each card keeping its blocks of the weights
   (`sharding.layout`; "whole" runs keep every weight whole on every
   card, the layout before it, for comparison in the same call): (a)
   Qwen2-7B at its full 28 layers on (data = cards, model = 1), blocks
   then whole, fp32 moments, a global batch of 4 x 1,024 tokens
   (SyntheticTokens, seed 0; one microbatch), a warm-up step and 3 timed
   steps on that batch (step ms between barriers, tokens/s, the peak
   memory and the weight, gradient and state bytes of every card; the
   loss must fall and the peak stay under 80 GiB); (e) the same on
   (data = cards / 2, model = 2); (f) Qwen3-32B on (data = cards, model
   = 1), each layout at 8 layers and at QWEN3_LAYERS, then at the most
   layers whose peak the two runs' per-layer rise puts under
   QWEN3_PEAK_GIB (near the deepest the cards hold); (b) Qwen2-7B cut to 8
   layers on the same
   mesh against the same 8 layers and steps on one card (rank 0's):
   the loss of each step within 2e-3 relative, the parameters within
   4e-3 and each leaf's update of the masters (less their init) within
   0.25 of one card's in norm after 2 steps, Qwen2's key bias excepted
   (tests/test_torch_process_group_lm.py's bounds); (c) DBRX-132B at full
   width cut to 2 layers on (data = cards / 2, model = 2), a warm-up and
   2 timed steps: step ms, peak, the assignments dropped by each data
   shard; (d) Qwen2-7B after one step, saved by
   `launch.train.training_snapshot` (once, by rank 0, ~124 GB under
   build/lm_snapshot/, removed after; cut to the most layers whose
   snapshot the disk holds with a tenth to spare, that writes at most
   LM_SNAPSHOT_MAX_BYTES, within LM_SNAPSHOT_MAX_S at the disk's
   measured rate) and resumed into a fresh model and state on every
   card by `restore_training`: save and restore seconds, each rank's
   host resident set before and its peak (sampled) while saving and
   while restoring; the restored parameters and state bit-equal to the
   saved ones and the next step's loss equal to the one taken without
   the snapshot; the other families, each card keeping its blocks: (g)
   RecurrentGemma-9B on (data = cards, model = 1) at its full 38 layers
   on blocks, and whole at 12 and 24 layers, then at the most layers
   whose peak the two whole runs' per-layer rise puts under
   LM_DEEPEST_GIB; (h) DeepSeek-V2 at full width on (data = cards / 2,
   model = 2) at 2 layers in both layouts, then on blocks at 3 layers and
   at the most whose peak the two blocks runs' rise puts under
   LM_DEEPEST_GIB; (i) Mamba2-1.3B at its full 48 layers on (data =
   cards / 2, model = 2) in both layouts, then on blocks one more step
   under `torch.profiler`: the device time of the all-gathers of
   in_proj's output (`zxbcdt`, the forward's) against the step's; (j)
   serving Qwen3-32B on (data 1, model = cards), each card keeping its
   blocks of the weights and of the KV cache (its block of the sequence,
   every KV head): at 8 layers, 4 prompts of 512 tokens padded to 1,024
   and 8 decode steps against the same on one card with whole weights
   (rank 0's), each step's logits within 0.03 of the largest; then at
   its full 64 layers, 16 prompts of 2,048 tokens padded to 32,768
   positions (the decode_32k cell's cache length; 137 GB of cache in all,
   more than one card holds beside the weights), prefill timed, then 32
   greedy decode steps, each timed: decode ms a step against the bound
   of the card's weight and cache bytes over 3.35 TB/s, tokens/s, each
   card's peak, and one step's collectives by kind (bytes and calls);
   then one more step under `torch.profiler`: rank 0's device time by
   op, NCCL's share, and the step's wall time.

    python3 scripts/multi_card.py --lm     # the LM worker alone
    torchrun --nproc-per-node=4 scripts/multi_card.py --lm-worker d
                                           # some of its parts (a-i)

Prints the card's name and power limit and one JSON line per part; exits
non-zero if a part fails or disagrees.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import signal
import subprocess
import sys
import threading
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
# the LM worker's torchrun command; its group's collectives wait for rank
# 0 to write a snapshot of ~124 GB
LM_TIMEOUT_S = 1560
LM_SNAPSHOT_MAX_S = 120  # the most seconds (d)'s write may take
# the most bytes (d) writes: a host may bound what one command writes to
# its disk, freed blocks included (90 GiB on a four-card H100 host)
LM_SNAPSHOT_MAX_BYTES = 36e9


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


LM_BATCH, LM_SEQ, LM_LR = 4, 1024, 3e-4
LM_PEAK_GIB = 80.0
LM_SMALL_LAYERS = 8
# tests/test_torch_process_group_lm.py's bounds (chip_smoke's LM_PG_*):
# losses, parameters, and each leaf's update of the masters in norm, but
# Qwen2's key bias (its gradient is mostly rounding noise)
LM_LOSS_TOL, LM_PARAM_TOL, LM_UPDATE_TOL = 2e-3, 4e-3, 0.25
LM_SNAPSHOT_DIR = ROOT / "build" / "lm_snapshot"     # (d)'s, removed after
# (f): Qwen3-32B's layers for each layout's second run (whole, blocks),
# about 57 and 45 GiB by the bytes of the 8-layer runs (PERF.md), and
# the allocated peak the deepest run's depth is chosen under. A card has
# 79.18 GiB, of which ~3 go to the context and up to 6.88 were cached
# but unallocated when runs on blocks ran out at 28 layers; and the two
# runs' rise understates a layer's: the optimizer's temporaries of a
# stacked leaf's ZeRO slice grow with the layers and set the peak only
# past them.
QWEN3_LAYERS = {"whole": 12, "blocks": 16}
QWEN3_PEAK_GIB = 64.0
# (g), (h): the allocated peak the deepest run's depth is chosen under
LM_DEEPEST_GIB = 64.0


def host_rss_gib() -> float:
    """This process's resident set (VmRSS), GiB."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 2 ** 20
    raise RuntimeError("no VmRSS in /proc/self/status")


@contextlib.contextmanager
def host_peak(box: list):
    """Sets box[0] to the largest resident set (GiB) this process reaches
    while the `with` block runs, sampled every 5 ms by a thread (a kernel
    may keep no peak of its own)."""
    box[:] = [host_rss_gib()]
    stop = threading.Event()

    def sample():
        while not stop.wait(0.005):
            box[0] = max(box[0], host_rss_gib())
    t = threading.Thread(target=sample, daemon=True)
    t.start()
    try:
        yield box
    finally:
        stop.set()
        t.join()
        box[0] = max(box[0], host_rss_gib())


def bit_digests(tensors) -> list:
    """Two int64 sums of each tensor's bits (plain and weighted by
    position, wrapping): equal bits give equal digests."""
    import torch
    out = []
    for t in tensors:
        v = t.detach().contiguous().view(-1)
        ints = v.view({1: torch.int8, 2: torch.int16, 4: torch.int32,
                       8: torch.int64}[v.element_size()])
        plain = weighted = 0
        step = 1 << 26
        for lo in range(0, ints.numel(), step):
            c = ints[lo:lo + step].to(torch.int64)
            w = torch.arange(lo, lo + c.numel(), dtype=torch.int64,
                             device=v.device) * 0x9E3779B1 + 1
            plain += int(c.sum())
            weighted += int((c * w).sum())
        out.append((plain, weighted))
    return out


def lm_state_tensors(model, state) -> list:
    """The parameters, then every tensor of an AdamW state, in order."""
    from repro_torch.train.optimizer import tree_leaves
    out = list(model.parameters()) + [state.step]
    for field in (state.master, state.m, state.v):
        for leaf in tree_leaves(field):
            out.extend(leaf if isinstance(leaf, tuple) else [leaf])
    return out


def lm_timed_steps(step, state, batch, n_steps: int) -> tuple:
    """A warm-up step, then `n_steps` timed ones, each between barriers
    and synchronized: (state, losses, step seconds after the warm-up)."""
    import torch
    import torch.distributed as dist
    losses, times = [], []
    for i in range(n_steps + 1):
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        dist.barrier()
        if i:
            times.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
    return state, losses, times


def lm_disk() -> tuple:
    """(free bytes, write bytes/s) of the disk under LM_SNAPSHOT_DIR, as
    rank 0 measures them (1 GiB written and synced), on every rank."""
    import shutil
    import torch.distributed as dist
    box = [None]
    if dist.get_rank() == 0:
        LM_SNAPSHOT_DIR.mkdir(parents=True, exist_ok=True)
        free = shutil.disk_usage(LM_SNAPSHOT_DIR).free
        probe = LM_SNAPSHOT_DIR / "probe"
        chunk = os.urandom(1 << 26)
        t0 = time.perf_counter()
        with open(probe, "wb") as f:
            for _ in range(16):
                f.write(chunk)
            f.flush()
            os.fsync(f.fileno())
        box[0] = (free, (1 << 30) / (time.perf_counter() - t0))
        probe.unlink()
    dist.broadcast_object_list(box, src=0)
    return box[0]


def lm_snapshot_bytes(leaves, layers: int) -> int:
    """The bytes of a training snapshot at `layers` layers: float32
    parameters and a float32 master, m and v a padded leaf. `leaves` is
    [(stacked over layers, elements a layer or in all)] a leaf."""
    from repro_torch.train.optimizer import _pad_len
    total = 0
    for stacked, n in leaves:
        n = n * layers if stacked else n
        total += 4 * n + 12 * _pad_len(n)
    return total


def lm_snapshot(mesh, live: list, batch, build) -> tuple:
    """A model's state through a snapshot under LM_SNAPSHOT_DIR: written
    once by rank 0 in the single-device layout
    (`launch.train.training_snapshot`), then resumed into a fresh model
    and state on every card (`restore_training`, leaf by leaf, each rank
    keeping its slice): seconds, bytes, each rank's host resident set
    before and its peak while saving and while restoring; the restored
    parameters and state bit-equal to the saved ones, and the step after
    the resume taking the loss the same step took without it. `live` is
    [model, AdamW state, train step], emptied here so that their card
    memory goes before `build()` makes the fresh ones. Returns (model,
    state, step, the report)."""
    import gc
    import shutil
    import torch
    import torch.distributed as dist
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.convert import lm_param_tree
    from repro_torch.launch.train import restore_training, \
        training_snapshot
    from repro_torch.sharding import ShardingRules, active_rules, \
        default_rules

    model, state, step = live
    live.clear()
    params = lm_param_tree(model)
    where = str(LM_SNAPSHOT_DIR)
    rep = {}
    cards = dist.get_world_size()

    def gather(x):
        out = [None] * cards
        dist.all_gather_object(out, x)
        return out

    saved = bit_digests(lm_state_tensors(model, state))
    k = int(state.step)
    ckpt = Checkpointer(where, mesh=mesh, keep_last=1)
    rss0 = host_rss_gib()
    peak_save, peak_restore = [], []
    t0 = time.perf_counter()
    with host_peak(peak_save):
        ckpt.save(k, training_snapshot(model, params, state, mesh))
    save_s = time.perf_counter() - t0
    if mesh.writer:
        rep["snapshot_bytes"] = sum(
            f.stat().st_size for f in Path(where).rglob("*") if f.is_file())
    with active_rules(ShardingRules(mesh, default_rules(False))):
        state, m = step(state, batch)
    loss_next = float(m["loss"])
    del model, state, step, params, m
    gc.collect()
    torch.cuda.empty_cache()
    model, state, step = build()
    rss1 = host_rss_gib()
    t0 = time.perf_counter()
    with host_peak(peak_restore):
        state, k2 = restore_training(ckpt, model, lm_param_tree(model),
                                     state, mesh)
        torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    same = bit_digests(lm_state_tensors(model, state)) == saved and k2 == k
    with active_rules(ShardingRules(mesh, default_rules(False))):
        state, m = step(state, batch)
    loss_resumed = float(m["loss"])
    dist.barrier()
    if mesh.writer:
        shutil.rmtree(where, ignore_errors=True)
    rep.update(step=k, save_s=gather(save_s), restore_s=gather(restore_s),
               host_rss_before_save_gib=gather(rss0),
               host_peak_save_gib=gather(peak_save[0]),
               host_rss_before_restore_gib=gather(rss1),
               host_peak_restore_gib=gather(peak_restore[0]),
               bit_equal=all(gather(same)), loss_next=loss_next,
               loss_resumed=loss_resumed)
    rep["ok"] = bool(rep["bit_equal"] and abs(loss_resumed - loss_next)
                     <= 1e-6 * abs(loss_next))
    return model, state, step, rep


# (j): Qwen3-32B served at (data 1, model = cards)
SERVE_ARCH = "qwen3-32b"
SERVE_SMALL = dict(layers=8, rows=4, prompt=512, max_seq=1024, steps=8)
SERVE_FULL = dict(rows=16, prompt=2048, max_seq=32768, steps=32)
SERVE_TOL = 0.03          # tests/test_torch_process_group_lm_serve.py's
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet


def serve_run(model, tokens, feed, max_seq: int, greedy: bool = False):
    """Prefill `tokens` padded to `max_seq`, then a decode step for each
    row of `feed` (or, with `greedy`, its count of steps on the argmax):
    (logits of each on the CPU, cache, prefill seconds, each decode
    step's seconds, the collectives of the second step)."""
    import torch
    from repro_torch.sharding.collectives import CollectiveLog
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = model.prefill(tokens, q_chunk=512, pad_cache_to=max_seq)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    out, steps, log = [logits.cpu()], [], None
    for i in range(feed.shape[0]):
        tok = logits.argmax(-1) if greedy else feed[i][:, None]
        with CollectiveLog() as one:
            t0 = time.perf_counter()
            logits, cache = model.decode_step(cache, tok)
            torch.cuda.synchronize()
            steps.append(time.perf_counter() - t0)
        if i == 1:
            log = one
        out.append(logits.cpu())
    return out, cache, prefill_s, steps, log


def serve_profile(model, cache, token, top: int = 12) -> dict:
    """One decode step under `torch.profiler`: its wall ms, the device
    time of its ops (self time, summed over streams), NCCL's part, and
    the `top` ops by device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.decode_step(cache, token)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.self_device_time_total > 0), key=lambda r: -r[1])
    device = sum(ms for _, ms, _ in rows)
    return dict(wall_ms=wall * 1e3, device_ms=device,
                nccl_ms=sum(ms for k, ms, _ in rows if "nccl" in k.lower()),
                top=[dict(op=k, ms=ms, calls=n) for k, ms, n in rows[:top]])


def serve_part(cards: int, rank: int, gather) -> tuple:
    """(j): (ok, the report)."""
    import dataclasses
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_process_mesh
    from repro_torch.models import get_model

    mesh = make_process_mesh({"data": 1, "model": cards},
                             timeout=LM_TIMEOUT_S - 60)
    dev = mesh.devices[0]
    q3 = get_config(SERVE_ARCH)
    rng = np.random.default_rng(0)

    def draw(n):
        return (torch.as_tensor(rng.integers(0, q3.vocab_size,
                                             (n["rows"], n["prompt"]))).to(dev),
                torch.as_tensor(rng.integers(0, q3.vocab_size,
                                             (n["steps"], n["rows"]))).to(dev))

    out, ok = {}, True
    # x8: the cards against one card with whole weights
    small = dataclasses.replace(q3, num_layers=SERVE_SMALL["layers"])
    tokens, feed = draw(SERVE_SMALL)
    model = get_model(small)(small, device=dev, seed=0, mesh=mesh)
    got = serve_run(model, tokens, feed, SERVE_SMALL["max_seq"])[0]
    del model
    torch.cuda.empty_cache()
    if rank == 0:
        one = get_model(small)(small, device=dev, seed=0)
        want = serve_run(one, tokens, feed, SERVE_SMALL["max_seq"])[0]
        del one
        torch.cuda.empty_cache()
        errs = [float((a - b).abs().max() / b.abs().max())
                for a, b in zip(got, want)]
        agree = bool(max(errs) <= SERVE_TOL and all(
            bool(t.isfinite().all()) for t in got))
        out["x8"] = dict(SERVE_SMALL, logits_err=errs, agree=agree)
        print(json.dumps(dict(lm=f"{SERVE_ARCH} serve x8, (1, {cards}) "
                              "blocks vs one card whole", **out["x8"])),
              flush=True)
        ok &= agree
    dist.barrier()

    # x64: every layer, the decode_32k cache length
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = get_model(q3)(q3, device=dev, seed=0, mesh=mesh)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    tokens, feed = draw(SERVE_FULL)
    logits, cache, prefill_s, steps, log = serve_run(
        model, tokens, feed, SERVE_FULL["max_seq"], greedy=True)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    cache_bytes = sum(t.numel() * t.element_size()
                      for c in cache.values() for t in c.values())
    bound_ms = (weight_bytes + cache_bytes) / HBM_BYTES_PER_S * 1e3
    step_ms = [t * 1e3 for t in steps]
    timed = sorted(step_ms[1:])            # the first step warms up
    median = timed[len(timed) // 2]
    finite = all(bool(t.isfinite().all()) for t in logits)
    res = dict(SERVE_FULL, layers=q3.num_layers, mesh=dict(mesh.shape),
               init_s=init_s, prefill_s=prefill_s, step_ms=step_ms,
               median_step_ms=median, bound_ms=bound_ms,
               of_bound=median / bound_ms,
               tokens_per_s=SERVE_FULL["rows"] / (median / 1e3),
               prefill_tokens_per_s=SERVE_FULL["rows"] * SERVE_FULL["prompt"]
               / prefill_s,
               weight_bytes=gather(weight_bytes),
               cache_bytes=gather(cache_bytes), peak_gib=gather(peak),
               coll_bytes_a_step=dict(log.bytes),
               coll_calls_a_step=dict(log.calls),
               cache_block={f"{k}/{n}": list(t.shape)
                            for k, c in cache.items() for n, t in c.items()},
               finite=finite)
    res["profile"] = serve_profile(model, cache, feed[0][:, None])
    out["x64"] = res
    ok &= finite and max(res["peak_gib"]) < LM_PEAK_GIB
    if rank == 0:
        print(json.dumps(dict(lm=f"{SERVE_ARCH} serve x64, (1, {cards}) "
                              "blocks", **res)), flush=True)
    del model, cache, logits
    torch.cuda.empty_cache()
    dist.barrier()
    return ok, out


def lm_worker(parts: str = "abcdefghij") -> int:
    """The LM training step over NCCL, one process a card (see the module
    doc, part 3): the parts named in `parts`."""
    import dataclasses
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.convert import lm_param_tree
    from repro_torch.data import DataConfig, SyntheticTokens
    from repro_torch.launch.mesh import make_local_mesh, make_process_mesh
    from repro_torch.launch.train import make_batch
    from repro_torch.models import get_model
    from repro_torch.models import moe as tmoe
    from repro_torch.models.common import recomputing
    from repro_torch.sharding import ShardingRules, active_rules, \
        default_rules
    from repro_torch.sharding.layout import whole
    from repro_torch.train import AdamWConfig, init_state, make_train_step
    from repro_torch.train.optimizer import (leaf_paths, leaf_size,
                                             state_to_host, tree_leaves)

    cards = int(os.environ["WORLD_SIZE"])
    ok = True
    out = dict(cards=cards)

    def gather(x):
        box = [None] * cards
        dist.all_gather_object(box, x)
        return box

    def build(cfg, mesh, adam, blocks=True):
        with active_rules(ShardingRules(mesh, default_rules(False))):
            model = get_model(cfg)(cfg, device=mesh.devices[0], seed=0,
                                   mesh=mesh if blocks else None)
            state = init_state(lm_param_tree(model), adam, mesh=mesh)
            step = make_train_step(cfg, model, adam, mesh=mesh,
                                   loss_kwargs=dict(q_chunk=512))
        return model, state, step

    def run(cfg, mesh, adam, batch, n_steps, blocks=True):
        rules = ShardingRules(mesh, default_rules(False))
        torch.cuda.reset_peak_memory_stats()
        model, state, step = build(cfg, mesh, adam, blocks)
        with active_rules(rules):
            state, losses, times = lm_timed_steps(step, state, batch,
                                                  n_steps)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        nbytes = sum(t.numel() * t.element_size()
                     for f in (state.master, state.m, state.v)
                     for leaf in tree_leaves(f)
                     for t in (leaf if isinstance(leaf, tuple) else (leaf,)))
        # a microbatch's gradient has each parameter's shape and dtype
        wbytes = sum(t.numel() * t.element_size() for t in model.parameters())
        return model, state, step, dict(losses=losses, step_s=times,
                                        peak_gib=gather(peak),
                                        state_bytes=gather(nbytes),
                                        weight_bytes=gather(wbytes),
                                        grad_bytes=gather(wbytes),
                                        layout="blocks" if blocks
                                        else "whole")

    def measured(cfg, mesh, blocks, label):
        """A warm-up and 3 timed steps of `cfg` on `mesh` in one layout:
        the report (printed by rank 0), the loss falling and the peak
        under LM_PEAK_GIB."""
        batch = batch_for(cfg, dev)
        model, state, step, res = run(cfg, mesh, adam, batch, 3, blocks)
        step_s = sum(res["step_s"]) / len(res["step_s"])
        res.update(layers=cfg.num_layers, mesh=dict(mesh.shape),
                   params=sum(p.numel() for p in get_model(cfg)(
                       cfg, device="meta", seed=None).parameters()),
                   step_ms=step_s * 1e3,
                   tokens_per_s=LM_BATCH * LM_SEQ / step_s,
                   loss_fell=res["losses"][-1] < res["losses"][0],
                   peak_under_80=max(res["peak_gib"]) < LM_PEAK_GIB)
        if rank == 0:
            print(json.dumps(dict(lm=label, **res)), flush=True)
        del model, state, step, batch
        torch.cuda.empty_cache()
        return res

    def batch_for(cfg, dev):
        return make_batch(cfg, SyntheticTokens(DataConfig(
            vocab_size=cfg.vocab_size, seq_len=LM_SEQ,
            global_batch=LM_BATCH, seed=0)).batch_at(0), dev)

    mesh = make_process_mesh({"data": cards, "model": 1},
                             timeout=LM_TIMEOUT_S - 60)
    rank, dev = dist.get_rank(), mesh.devices[0]
    cfg = get_config("qwen2-7b")
    adam = AdamWConfig(lr=LM_LR)

    # (a) Qwen2-7B at its full 28 layers on (data = cards, model = 1), and
    # (e) on (data = cards / 2, model = 2): blocks, then whole
    for part, shape in (("a", {"data": cards, "model": 1}),
                        ("e", {"data": cards // 2, "model": 2})):
        if part not in parts:
            continue
        grid = mesh if shape["model"] == 1 else make_process_mesh(
            shape, timeout=LM_TIMEOUT_S - 60)
        for blocks in (True, False):
            layout = "blocks" if blocks else "whole"
            res = measured(cfg, grid, blocks,
                           f"qwen2-7b x28 {shape} {layout}")
            ok &= res["loss_fell"] and res["peak_under_80"]
            out[f"qwen2_28_{part}_{layout}"] = res

    # (f) Qwen3-32B on (data = cards, model = 1): each layout at 8 layers
    # and at QWEN3_LAYERS, then at the deepest its per-layer rise fits
    if "f" in parts:
        q3 = get_config("qwen3-32b")
        for layout, blocks in (("whole", False), ("blocks", True)):
            peaks = {}
            for n in (8, QWEN3_LAYERS[layout]):
                res = measured(dataclasses.replace(q3, num_layers=n), mesh,
                               blocks, f"qwen3-32b x{n} {layout}")
                ok &= res["loss_fell"] and res["peak_under_80"]
                out[f"qwen3_{n}_{layout}"] = res
                peaks[n] = max(res["peak_gib"])
            lo, hi = sorted(peaks)
            per_layer = (peaks[hi] - peaks[lo]) / (hi - lo)
            deepest = hi if per_layer <= 0 else min(q3.num_layers, hi + int(
                (QWEN3_PEAK_GIB - peaks[hi]) // per_layer))
            out[f"qwen3_deepest_{layout}"] = dict(
                per_layer_gib=per_layer, layers=deepest,
                peak_limit_gib=QWEN3_PEAK_GIB)
            if deepest > hi:
                res = measured(dataclasses.replace(q3, num_layers=deepest),
                               mesh, blocks,
                               f"qwen3-32b x{deepest} {layout} (deepest)")
                ok &= res["loss_fell"] and res["peak_under_80"]
                out[f"qwen3_deepest_{layout}"].update(res)
            if rank == 0:
                print(json.dumps(dict(lm=f"qwen3-32b deepest {layout}",
                                      **out[f"qwen3_deepest_{layout}"])),
                      flush=True)

    # (b) Qwen2-7B x8: these cards against one card
    if "b" in parts:
        small = dataclasses.replace(cfg, num_layers=LM_SMALL_LAYERS)
        batch = batch_for(small, dev)
        model, state, step, res = run(small, mesh, adam, batch, 1)
        # each card's blocks gathered whole (every card takes part)
        params = [whole(p).clone() for p in model.parameters()]
        host = state_to_host(state, lm_param_tree(model), mesh)
        del model, state, step
        torch.cuda.empty_cache()
        if rank == 0:
            one = make_local_mesh(dev)
            model1, state1, step1 = build(small, one, adam)
            paths = list(leaf_paths(state1.master))
            init = [t.cpu().numpy().copy() for t in tree_leaves(state1.master)]
            with active_rules(ShardingRules(one, default_rules(False))):
                losses1 = []
                for _ in range(2):
                    state1, m = step1(state1, batch)
                    losses1.append(float(m["loss"]))
            loss_rel = max(abs(a - b) / abs(b)
                           for a, b in zip(res["losses"], losses1))
            param_err = max(float((a.float() - b.detach().float()).abs().max())
                            for a, b in zip(params, model1.parameters()))
            # each leaf's update error: ||got - want|| / ||want - init||
            upd = {}
            for k, a, b, i0 in zip(paths, tree_leaves(host.master),
                                   tree_leaves(state1.master), init):
                want = b.cpu().numpy().astype(np.float64)
                ref = np.linalg.norm(want - i0)
                diff = np.linalg.norm(np.asarray(a, np.float64) - want)
                upd[k] = float(diff / ref) if ref else (
                    0.0 if diff == 0 else float("inf"))
            held = [e for k, e in upd.items() if not k.endswith("attn/bk")]
            agree = (loss_rel <= LM_LOSS_TOL and param_err <= LM_PARAM_TOL
                     and bool(held) and max(held) <= LM_UPDATE_TOL)
            out["qwen2_8"] = dict(losses=res["losses"], one_card=losses1,
                                  loss_rel=loss_rel, param_max_abs=param_err,
                                  update_err=upd, agree=agree,
                                  step_s=res["step_s"],
                                  peak_gib=res["peak_gib"])
            print(json.dumps(dict(lm="qwen2-7b x8, cards vs one card",
                                  **out["qwen2_8"])), flush=True)
            del model1, state1, step1, init
            ok &= agree
        del params, host
        torch.cuda.empty_cache()
        dist.barrier()

    # (c) DBRX at full width, 2 layers, on (data = cards / 2, model = 2)
    if "c" in parts:
        mesh2 = make_process_mesh({"data": cards // 2, "model": 2},
                                  timeout=LM_TIMEOUT_S - 60)
        dbrx = dataclasses.replace(get_config("dbrx-132b"), num_layers=2)
        drops = []
        real = tmoe._dispatch_compute_combine

        def counted(*a, **k):
            res = real(*a, **k)
            if not recomputing():
                drops.append(res[3])
            return res
        tmoe._dispatch_compute_combine = counted
        try:
            model, state, step, res = run(dbrx, mesh2, adam,
                                          batch_for(dbrx, dev), 2)
        finally:
            tmoe._dispatch_compute_combine = real
        shard_drops = gather([int(d) for d in drops])
        step_s = sum(res["step_s"]) / len(res["step_s"])
        res.update(layers=dbrx.num_layers,
                   params=sum(p.numel() for p in model.parameters()),
                   step_ms=step_s * 1e3,
                   tokens_per_s=LM_BATCH * LM_SEQ / step_s,
                   mesh=dict(mesh2.shape),
                   drops_by_rank=shard_drops,
                   dropped_total=[int(b.moe.dropped)
                                  for b in model.moe_layers])
        ok &= all(math.isfinite(x) for x in res["losses"])
        out["dbrx_2"] = res
        if rank == 0:
            print(json.dumps(dict(lm="dbrx-132b x2", **res)), flush=True)
        del model, state, step
        torch.cuda.empty_cache()

    def deepest(base, mesh, blocks, depths, label, cap=LM_DEEPEST_GIB):
        """`base` in one layout at each of the two `depths`, then at the
        most layers (up to its own) whose peak the two runs' per-layer
        rise puts under `cap` GiB, if deeper: the reports by label."""
        res, peaks = {}, {}
        for n in depths:
            r = measured(dataclasses.replace(base, num_layers=n), mesh,
                         blocks, f"{label} x{n}")
            res[f"x{n}"], peaks[n] = r, max(r["peak_gib"])
        lo, hi = depths
        rise = (peaks[hi] - peaks[lo]) / (hi - lo)
        n = hi if rise <= 0 else min(
            base.num_layers, hi + int((cap - peaks[hi]) // rise))
        res["deepest"] = dict(per_layer_gib=rise, layers=n,
                              peak_limit_gib=cap)
        if n > hi:
            res["deepest"].update(measured(
                dataclasses.replace(base, num_layers=n), mesh, blocks,
                f"{label} x{n} (deepest)"))
        if rank == 0:
            print(json.dumps(dict(lm=f"{label} deepest",
                                  **res["deepest"])), flush=True)
        return res

    def checked(res):
        return res["loss_fell"] and res["peak_under_80"]

    # (g) RecurrentGemma-9B on (data = cards, model = 1): 38 layers on
    # blocks; whole at 12 and 24 layers, then at the deepest under the cap
    if "g" in parts:
        rg = get_config("recurrentgemma-9b")
        res = measured(rg, mesh, True, "recurrentgemma-9b x38 blocks")
        ok &= checked(res)
        out["rgemma_38_blocks"] = res
        out["rgemma_whole"] = deepest(rg, mesh, False, (12, 24),
                                      "recurrentgemma-9b whole")
        ok &= all(checked(r) for r in out["rgemma_whole"].values()
                  if "loss_fell" in r)

    # (h) DeepSeek-V2 at full width on (data = cards / 2, model = 2): 2
    # layers in both layouts; blocks at 3, then at the deepest under the
    # cap
    if "h" in parts:
        mesh2 = make_process_mesh({"data": cards // 2, "model": 2},
                                  timeout=LM_TIMEOUT_S - 60)
        ds = get_config("deepseek-v2-236b")
        res = measured(dataclasses.replace(ds, num_layers=2), mesh2, False,
                       "deepseek-v2-236b x2 whole")
        ok &= checked(res)
        out["deepseek_2_whole"] = res
        out["deepseek_blocks"] = deepest(ds, mesh2, True, (2, 3),
                                         "deepseek-v2-236b blocks")
        ok &= all(checked(r) for r in out["deepseek_blocks"].values()
                  if "loss_fell" in r)

    # (i) Mamba2-1.3B at 48 layers on (data = cards / 2, model = 2), both
    # layouts; then one profiled step on blocks: the forward's
    # all-gathers of zxbcdt against the step, by device time
    if "i" in parts:
        mesh2 = make_process_mesh({"data": cards // 2, "model": 2},
                                  timeout=LM_TIMEOUT_S - 60)
        mb = get_config("mamba2-1.3b")
        for blocks in (True, False):
            layout = "blocks" if blocks else "whole"
            res = measured(mb, mesh2, blocks, f"mamba2-1.3b x48 {layout}")
            ok &= checked(res)
            out[f"mamba2_48_{layout}"] = res
        out["mamba2_48_profile"] = mamba2_profile(mb, mesh2, adam,
                                                  batch_for(mb, dev), build)
        if rank == 0:
            print(json.dumps(dict(lm="mamba2-1.3b x48 blocks profile",
                                  **out["mamba2_48_profile"])), flush=True)

    # (d) Qwen2-7B after a step, saved and resumed: at the most layers
    if "d" in parts:
        # whose snapshot the disk has the room for (a tenth to spare), the
        # bytes and the rate
        one = dataclasses.replace(cfg, num_layers=1)
        leaves = [(isinstance(leaf, list), leaf_size(leaf)) for leaf in
                  tree_leaves(lm_param_tree(get_model(one)(one, device=dev,
                                                           seed=0)))]
        free, rate = lm_disk()
        fits = [n for n in range(1, cfg.num_layers + 1)
                if 1.1 * lm_snapshot_bytes(leaves, n) <= free
                and lm_snapshot_bytes(leaves, n) <= LM_SNAPSHOT_MAX_BYTES
                and lm_snapshot_bytes(leaves, n) / rate <= LM_SNAPSHOT_MAX_S]
        snap = dict(free_bytes=free, disk_write_bytes_per_s=rate,
                    bytes_all_layers=lm_snapshot_bytes(leaves, cfg.num_layers),
                    layers=max(fits, default=0))
        if fits:
            cut = dataclasses.replace(cfg, num_layers=max(fits))
            batch = batch_for(cut, dev)
            live = list(build(cut, mesh, adam))
            with active_rules(ShardingRules(mesh, default_rules(False))):
                live[1], _ = live[2](live[1], batch)
            snap.update(lm_snapshot(mesh, live, batch,
                                    lambda: build(cut, mesh, adam))[3],
                        snapshot_bytes_expected=lm_snapshot_bytes(
                            leaves, max(fits)))
            ok &= snap["ok"]
        out["qwen2_snapshot"] = snap
        if rank == 0:
            print(json.dumps(dict(lm="qwen2-7b snapshot", **snap)),
                  flush=True)
    if "j" in parts:
        served, out["qwen3_serve"] = serve_part(cards, rank, gather)
        ok &= served
    if rank == 0:
        print(json.dumps(dict(lm_ok=bool(ok))), flush=True)
    dist.barrier()
    dist.destroy_process_group()
    return 0 if ok else 1


def mamba2_profile(cfg, mesh, adam, batch, build) -> dict:
    """A warm-up step of `cfg` on blocks, then one under `torch.profiler`
    on every card: this card's device time of the step and of the kernels
    launched inside the forward's all-gathers of in_proj's output over
    `model` (`models.mamba2._split_heads`, marked here by a
    `record_function`); the backward's reduce-scatters are not marked."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.models import mamba2
    from repro_torch.sharding import ShardingRules, active_rules, \
        default_rules

    real = mamba2.coll.all_gather

    def marked(*a, **k):
        with record_function("zxbcdt_all_gather"):
            return real(*a, **k)
    model, state, step = build(cfg, mesh, adam)
    mamba2.coll.all_gather = marked
    try:
        with active_rules(ShardingRules(mesh, default_rules(False))):
            state, _ = step(state, batch)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                state, _ = step(state, batch)
                torch.cuda.synchronize()
    finally:
        mamba2.coll.all_gather = real
    events = prof.key_averages()

    def us(e, name):
        return getattr(e, f"{name}device_time_total", None) or getattr(
            e, f"{name}cuda_time_total", 0)
    # each kernel once (self time); the marked range with its kernels
    total = sum(us(e, "self_") for e in events)
    gather = max((us(e, "") for e in events
                  if e.key == "zxbcdt_all_gather"), default=0)
    del model, state, step
    torch.cuda.empty_cache()
    return dict(step_device_ms=total / 1e3, zxbcdt_gather_ms=gather / 1e3,
                zxbcdt_gather_share=gather / total if total else None)


def torchrun(cards: int, args: list, timeout: float = TIMEOUT_S) -> tuple:
    """(exit code, stdout, stderr, seconds) of one torchrun command, its
    whole process group killed past `timeout` seconds."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={cards}", *args]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="4")
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, cwd=ROOT,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
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
    if sys.argv[1:2] == ["--lm-worker"]:
        return lm_worker(*sys.argv[2:3])
    if sys.argv[1:2] == ["--cli"]:
        return cli(sys.argv[2])
    lm_only = sys.argv[1:] == ["--lm"]
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
    for algo in () if lm_only else ("counts", "walks", "improved", "ppr"):
        code, out, err, secs = torchrun(cards, [
            str(Path(__file__).resolve()), "--cli", algo])
        print(out[-3000:], err[-3000:], flush=True)
        print(json.dumps(dict(cli=algo, cards=cards, seconds=secs,
                              rc=code)), flush=True)
        rc = rc or code
    if not lm_only:
        code, out, err, secs = torchrun(cards, [
            str(Path(__file__).resolve()), "--worker"])
        print(out[-12000:], err[-3000:], flush=True)
        print(json.dumps(dict(worker=cards, seconds=secs, rc=code)),
              flush=True)
        rc = rc or code
    code, out, err, secs = torchrun(cards, [str(Path(__file__).resolve()),
                                            "--lm-worker"], LM_TIMEOUT_S)
    print(out[-12000:], err[-3000:], flush=True)
    print(json.dumps(dict(lm_worker=cards, seconds=secs, rc=code)),
          flush=True)
    return rc or code


if __name__ == "__main__":
    sys.exit(main())
