"""End-to-end training on the port: a ~125M-parameter qwen2-family
model for a few hundred steps through the production code path
(microbatched train step, AdamW, checkpointing, deterministic data
pipeline).

    PYTHONPATH=src python examples/train_lm_torch.py [--steps 200]   (card)
    PYTHONPATH=src python examples/train_lm_torch.py --device cpu --steps 4

The JAX package's examples/train_lm.py on `repro_torch`: Qwen2-7B narrowed
to 12 layers, d_model 768, 12 heads, 4 KV heads, head_dim 64, d_ff 2,048
and a 32,000-word vocabulary; global batch 4 of 128 tokens, lr 1e-3, 2
microbatches, q_chunk 64, a checkpoint every 100 steps. The weights come
from the port's seeded init, or from the latest snapshot in
`--checkpoint-dir` (a temporary directory when not given), which the JAX
package's Checkpointer may have written.
`--reduced` trains the reduced Qwen2-7B instead (a few seconds a step on
the CPU). Beside the JAX example's lines it prints the ms a step,
tokens/s and, on the card, the peak memory. Exits non-zero unless the
last loss is below the first.
"""
import argparse
import dataclasses
import tempfile

import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.launch.stages import Stages, device_lines, device_or_exit
from repro_torch.launch.train import run_training

GLOBAL_BATCH, SEQ_LEN = 4, 128


def model_config(reduced: bool = False):
    """The example's narrowed Qwen2 (~125M parameters), or with `reduced`
    the reduced Qwen2-7B."""
    if reduced:
        return reduced_config("qwen2-7b")
    return dataclasses.replace(
        get_config("qwen2-7b"), num_layers=12, d_model=768, num_heads=12,
        num_kv_heads=4, head_dim=64, d_ff=2048, vocab_size=32000,
        pad_q_heads_to=None)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced Qwen2-7B in place of the ~125M model")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="snapshots every 100 steps, resumed from the "
                         "latest (default: a temporary directory)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = device_or_exit(args.device)
    for line in device_lines(device):
        print(line)
    stages = Stages(device)

    cfg = model_config(args.reduced)
    n = cfg.param_count()
    print(f"model: {cfg.name}-{'reduced' if args.reduced else '100m'}  "
          f"params={n/1e6:.1f}M")

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    step_s = []
    with tempfile.TemporaryDirectory() as tmp, stages("train"):
        _, _, losses = run_training(
            cfg, steps=args.steps, global_batch=GLOBAL_BATCH,
            seq_len=SEQ_LEN, lr=1e-3, num_microbatches=2,
            checkpoint_dir=args.checkpoint_dir or tmp,
            checkpoint_every=100, q_chunk=64,
            log_every=20, device=device, step_seconds=step_s)
    improved = losses[-1] < losses[0]
    print(f"loss: {losses[0]:.4f} -> {losses[-1]:.4f} "
          f"({'improved' if improved else 'NOT improved'})")
    # the first step's time holds the warm-up: leave it out where others ran
    timed = step_s[1:] or step_s
    step_ms = 1e3 * sum(timed) / len(timed)
    tok_s = GLOBAL_BATCH * SEQ_LEN / (step_ms / 1e3)
    peak = (torch.cuda.max_memory_allocated(device) / 2 ** 30
            if device.type == "cuda" else None)
    print(f"steps: {len(losses)}, {step_ms:.2f} ms a step after the first "
          f"({1e3 * step_s[0]:.2f} ms), {tok_s:.0f} tokens/s; peak "
          + (f"{peak:.2f} GiB" if peak is not None else "not measured (CPU)"))
    stages.print()
    launched = stages.total_launches()
    print("kernels: " + ("the LM path launches none of the port's kernels"
                         if not any(launched.values())
                         else f"launched {launched}"))
    out = dict(device=str(device), arch=cfg.name, params=n, losses=losses,
               step_ms=step_ms, first_step_ms=1e3 * step_s[0], tok_s=tok_s,
               peak_gib=peak, **stages.report())
    if not improved:
        raise SystemExit(f"train_lm: check failed: loss {losses[0]:.4f} -> "
                         f"{losses[-1]:.4f}")
    return out


if __name__ == "__main__":
    main()
