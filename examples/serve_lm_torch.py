"""Serve a model with continuous batching (batched requests, staggered
admission, per-slot KV caches), on the port.

    PYTHONPATH=src python examples/serve_lm_torch.py --device cpu
    PYTHONPATH=src python examples/serve_lm_torch.py --full-width \\
        --layers 16 --requests 32 --prompt-len 64 1024 --budget 16 64 \\
        --slots 8 --max-seq 2048                                 (the card)

The JAX package's examples/serve_lm.py on `repro_torch`: reduced Qwen3-32B
with the port's seeded weights (seed 0), 12 requests drawn by
`numpy.random.default_rng(0)` as the JAX example draws them (prompts of
4-24 tokens, budgets of 4-16), served by `ContinuousBatcher(slots=4,
max_seq=64)`. `--full-width` takes Qwen3-32B's own widths, `--layers`
cuts its depth. Beside the JAX example's lines it prints the prefill
tokens/s, the decode ms a step with every slot active (each call timed
between synchronizations on the card), tokens/s and the peak memory.
Exits non-zero unless every request completed with its whole budget.
"""
import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.launch.stages import (Stages, TimedModel, device_lines,
                                       device_or_exit)
from repro_torch.models import get_model
from repro_torch.serve import ContinuousBatcher, Request

ARCH = "qwen3-32b"


def make_requests(vocab: int, count: int, prompt_len, budget, seed=0):
    """`count` requests drawn as the JAX example draws them: a prompt
    length in [prompt_len[0], prompt_len[1]), the prompt, then a budget
    in [budget[0], budget[1]), request by request."""
    rng = np.random.default_rng(seed)
    requests = []
    for i in range(count):
        size = int(rng.integers(*prompt_len))
        prompt = rng.integers(0, vocab, size=size).astype(np.int32)
        requests.append(Request(rid=i, prompt=prompt,
                                max_new_tokens=int(rng.integers(*budget))))
    return requests


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full-width", action="store_true",
                    help="Qwen3-32B's own widths (default: reduced)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the model to this many layers")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--prompt-len", type=int, nargs=2, default=[4, 24],
                    help="prompt lengths drawn in [lo, hi)")
    ap.add_argument("--budget", type=int, nargs=2, default=[4, 16],
                    help="new-token budgets drawn in [lo, hi)")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=64)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = device_or_exit(args.device)
    for line in device_lines(device):
        print(line)
    stages = Stages(device)

    cfg = get_config(ARCH) if args.full_width else reduced_config(ARCH)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    with stages("init"):
        model = get_model(cfg)(cfg, device=device, seed=0)
    params = sum(p.numel() for p in model.parameters())
    print(f"model: {cfg.name} x{cfg.num_layers} d_model {cfg.d_model}, "
          f"{params / 1e6:.1f} M parameters")
    requests = make_requests(cfg.vocab_size, args.requests, args.prompt_len,
                             args.budget)

    timed = TimedModel(model)
    batcher = ContinuousBatcher(timed, slots=args.slots,
                                max_seq=args.max_seq)
    timed.batcher = batcher
    with stages("serve"):
        stats = batcher.run(requests)
    timed.batcher = None
    dt = stages.seconds["serve"]
    print(f"served {stats.completed} requests in {stats.steps} decode steps "
          f"({stats.prefills} prefills), {stats.tokens_out} tokens, "
          f"{dt:.1f}s ({stats.tokens_out/dt:.1f} tok/s on {device.type})")
    for r in requests[:3]:
        print(f"  req {r.rid}: prompt[{len(r.prompt)}] -> "
              f"{r.generated[:8]}{'...' if len(r.generated) > 8 else ''}")

    full = [s for a, s in timed.decode_steps if a == args.slots]
    decode_s = sum(s for _, s in timed.decode_steps)
    peak = (torch.cuda.max_memory_allocated(device) / 2 ** 30
            if device.type == "cuda" else None)
    out = dict(
        device=str(device), arch=cfg.name, layers=cfg.num_layers,
        params=params, requests=len(requests), stats=dict(vars(stats)),
        budgets=sum(r.max_new_tokens for r in requests),
        generated={r.rid: list(r.generated) for r in requests},
        prefill_tokens=timed.prefill_tokens,
        prefill_tok_s=timed.prefill_tokens / timed.prefill_s,
        decode_steps=len(timed.decode_steps), full_steps=len(full),
        decode_ms_full=1e3 * sum(full) / len(full) if full else None,
        tok_s=stats.tokens_out / dt, decode_tok_s=sum(
            a for a, _ in timed.decode_steps) / decode_s if decode_s else None,
        peak_gib=peak, **stages.report())
    print(f"prefill: {out['prefill_tokens']} tokens, "
          f"{out['prefill_tok_s']:.1f} tokens/s; decode: "
          f"{out['decode_steps']} steps, {len(full)} with all "
          f"{args.slots} slots active at "
          + (f"{out['decode_ms_full']:.3f} ms a step" if full else "no step")
          + "; peak "
          + (f"{peak:.2f} GiB" if peak is not None else "not measured (CPU)"))
    stages.print()
    launched = stages.total_launches()
    print("kernels: " + ("the LM path launches none of the port's kernels"
                         if not any(launched.values())
                         else f"launched {launched}"))
    budgets = out["budgets"]
    if not (stats.completed == len(requests) and stats.tokens_out == budgets
            and all(r.done for r in requests)):
        raise SystemExit(f"serve_lm: check failed: completed "
                         f"{stats.completed} of {len(requests)}, tokens out "
                         f"{stats.tokens_out} of {budgets}")
    return out


if __name__ == "__main__":
    main()
