"""End-to-end training loop.

A training loop on one device: the data pipeline -> the microbatched
train step (AdamW, float32 masters) -> checkpoints every
`checkpoint_every` steps, resumed from the latest on a restart. The
JAX package's `repro.launch.train`; a checkpoint either package writes
resumes in the other (the same keys: `params/...` in JAX's tree,
`opt/step`, `opt/master/...`, `opt/m/...`, `opt/v/...`). The weights of
a fresh run come from the port's seeded init, not JAX's.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-7b \
        --reduced --steps 100 --global-batch 8 --seq-len 128 [--device cpu]

Without `--device` it runs on the card. The step runs under the
sharding rules of `mesh` (the 1x1 local mesh by default, on which they
are the identity); `--production-mesh` takes the 16x16 mesh of 256 CUDA
cards, and raises with fewer.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint import Checkpointer, restore_into
from repro_torch.configs import get_config, reduced_config
from repro_torch.convert import (lm_param_tree, lm_params_to_numpy,
                                 load_lm_params)
from repro_torch.data import DataConfig, SyntheticTokens
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
from repro_torch.models import get_model
from repro_torch.models.common import COMPUTE_DTYPE
from repro_torch.sharding.rules import (ShardingRules, active_rules,
                                        default_rules)
from repro_torch.train import AdamWConfig, init_state, make_train_step


def make_batch(cfg, numpy_batch, device) -> dict:
    """A pipeline batch on `device`, with the zero frames or image
    embeddings of the audio and VLM families (as the JAX package's
    `launch/train.py`)."""
    B = numpy_batch["tokens"].shape[0]
    out = {k: torch.from_numpy(numpy_batch[k]).long().to(device)
           for k in ("tokens", "labels")}
    if cfg.family == "audio":
        out["frames"] = torch.zeros((B, cfg.encoder_seq, cfg.d_model),
                                    dtype=COMPUTE_DTYPE, device=device)
    if cfg.family == "vlm":
        out["img_embeds"] = torch.zeros((B, cfg.num_image_tokens,
                                         cfg.d_model), dtype=COMPUTE_DTYPE,
                                        device=device)
    return out


def run_training(cfg, *, steps: int, global_batch: int, seq_len: int,
                 lr: float = 3e-4, num_microbatches: int = 1,
                 checkpoint_dir: str | None = None,
                 checkpoint_every: int = 50, q_chunk: int = 512,
                 log_every: int = 10, seed: int = 0, device=None,
                 mesh=None):
    """Train `cfg`'s model for `steps` steps (counted from 0, a resumed run
    going on from its checkpoint's step) under the sharding rules of
    `mesh` (`make_local_mesh(device)` when None). Returns (model, AdamW
    state, the losses of the steps this call ran)."""
    mesh = mesh or make_local_mesh(device)
    rules = ShardingRules(mesh, default_rules("pod" in mesh.shape))
    with active_rules(rules):
        model = get_model(cfg)(cfg, device=device, seed=seed)
        adam = AdamWConfig(lr=lr)
        opt_state = init_state(lm_param_tree(model), adam)
        step_fn = make_train_step(cfg, model, adam,
                                  num_microbatches=num_microbatches,
                                  loss_kwargs=dict(q_chunk=q_chunk))
        data = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size,
                                          seq_len=seq_len,
                                          global_batch=global_batch,
                                          seed=seed))
        ckpt = Checkpointer(checkpoint_dir) if checkpoint_dir else None
        start_step = 0
        if ckpt and ckpt.latest_step() is not None:
            flat, manifest = ckpt.restore()
            state = restore_into(dict(params=lm_params_to_numpy(model),
                                      opt=opt_state), flat)
            load_lm_params(model, state["params"])
            opt_state = state["opt"]
            start_step = manifest["step"]
            print(f"[train] restored step {start_step}")

        def snapshot():
            return dict(params=lm_params_to_numpy(model), opt=opt_state)

        losses = []
        t0 = time.time()
        for i in range(start_step, steps):
            opt_state, metrics = step_fn(
                opt_state, make_batch(cfg, data.batch_at(i), model.device))
            losses.append(float(metrics["loss"]))
            if (i + 1) % log_every == 0:
                dt = (time.time() - t0) / max(len(losses), 1)
                print(f"[train] step {i+1:5d} loss {losses[-1]:.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f} "
                      f"{dt*1e3:.0f} ms/step", flush=True)
            if ckpt and (i + 1) % checkpoint_every == 0:
                ckpt.save(i + 1, snapshot(), blocking=False)
        if ckpt:
            ckpt.save(steps, snapshot(), blocking=True)
        return model, opt_state, losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-7b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    mesh = make_production_mesh() if args.production_mesh else None

    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    _, _, losses = run_training(
        cfg, steps=args.steps, global_batch=args.global_batch,
        seq_len=args.seq_len, lr=args.lr,
        num_microbatches=args.microbatches,
        checkpoint_dir=args.checkpoint_dir, q_chunk=64, device=args.device,
        mesh=mesh)
    print(f"[train] done. loss {losses[0]:.4f} -> {losses[-1]:.4f}")


if __name__ == "__main__":
    main()
