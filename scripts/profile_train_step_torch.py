"""Where a training step of examples/train_lm_torch.py goes: its ~125M
Qwen2 on global batch 4 of 128 tokens, 2 microbatches, q_chunk 64, AdamW
at lr 1e-3, as the example trains it.

    PYTHONPATH=src python scripts/profile_train_step_torch.py        (card)
    PYTHONPATH=src python scripts/profile_train_step_torch.py --device cpu --reduced

After `--warmup` steps it times `--steps` steps between synchronizations,
then profiles one more (`torch.profiler`) and prints: the ms a step; the
operators the dispatcher ran in it; on the card, the kernels launched
and their summed device time; the step's FLOPs (FlopCounterMode) and
bytes (the weights and the AdamW state, each read once and written once);
and its bound, the larger of the FLOPs over 989 TFLOP/s (dense bf16) and
the bytes over 3.35 TB/s, the H100 SXM data sheet's rates. Returns them
from `main(argv)`.
"""
import argparse
import importlib.util
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.convert import lm_param_tree
from repro_torch.data import DataConfig, SyntheticTokens
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.launch.stages import device_lines, device_or_exit
from repro_torch.launch.train import make_batch
from repro_torch.models import get_model
from repro_torch.sharding.rules import (ShardingRules, active_rules,
                                        default_rules)
from repro_torch.train import AdamWConfig, init_state, make_train_step
from repro_torch.train.optimizer import _state_leaves

PEAK_FLOPS = 989e12        # dense bf16
PEAK_BYTES_S = 3.35e12
EXAMPLE = Path(__file__).resolve().parents[1] / "examples" / "train_lm_torch.py"


def load_example():
    spec = importlib.util.spec_from_file_location("train_lm_torch", EXAMPLE)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced Qwen2-7B in place of the ~125M model")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = device_or_exit(args.device)
    for line in device_lines(device):
        print(line)
    ex = load_example()
    cfg = ex.model_config(args.reduced)
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    mesh = make_local_mesh(device)
    with active_rules(ShardingRules(mesh, default_rules(False))):
        model = get_model(cfg)(cfg, device=device, seed=0)
        adam = AdamWConfig(lr=1e-3)
        params = lm_param_tree(model)
        state = init_state(params, adam)
        step = make_train_step(cfg, model, adam, num_microbatches=2,
                               loss_kwargs=dict(q_chunk=64))
        data = SyntheticTokens(DataConfig(
            vocab_size=cfg.vocab_size, seq_len=ex.SEQ_LEN,
            global_batch=ex.GLOBAL_BATCH, seed=0))
        batches = iter(make_batch(cfg, data.batch_at(i), device)
                       for i in range(args.warmup + args.steps + 2))
        for _ in range(args.warmup):
            state, metrics = step(state, next(batches))
        sync()
        t0 = time.perf_counter()
        for _ in range(args.steps):
            state, metrics = step(state, next(batches))
            float(metrics["loss"])
        sync()
        step_ms = 1e3 * (time.perf_counter() - t0) / args.steps
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])
        with profile(activities=acts) as prof:
            state, metrics = step(state, next(batches))
            sync()
        with FlopCounterMode(display=False) as flops:
            state, metrics = step(state, next(batches))
    events = prof.events()
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    state_bytes = sum(t.numel() * t.element_size()
                      for _, t in _state_leaves(state))
    param_bytes = sum(p.numel() * p.element_size()
                      for p in model.parameters())
    nbytes = 2 * (state_bytes + param_bytes)
    n_flops = flops.get_total_flops()
    bound_ms = 1e3 * max(n_flops / PEAK_FLOPS, nbytes / PEAK_BYTES_S)
    out = dict(device=str(device), params=cfg.param_count(),
               step_ms=step_ms, ops=sum(e.device_type ==
                                        torch.autograd.DeviceType.CPU
                                        for e in events),
               kernels=len(kernels) if cuda else None,
               device_ms=(sum(e.device_time for e in kernels) / 1e3
                          if cuda else None),
               flops=n_flops, bytes=nbytes, bound_ms=bound_ms,
               bound_by=("operations" if n_flops / PEAK_FLOPS
                         > nbytes / PEAK_BYTES_S else "bytes"))
    print(f"train step ({cfg.param_count() / 1e6:.1f}M params, "
          f"{ex.GLOBAL_BATCH} x {ex.SEQ_LEN} tokens): {step_ms:.3f} ms "
          f"wall over {args.steps} steps; {out['ops']} dispatched operators"
          + (f", {out['kernels']} kernels on the card, {out['device_ms']:.3f}"
             f" ms of device time" if cuda else "")
          + f"; {n_flops:.4g} FLOPs, {nbytes:.4g} bytes; bound "
          f"{bound_ms:.3f} ms ({out['bound_by']})")
    return out


if __name__ == "__main__":
    main()
