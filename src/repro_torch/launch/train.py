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

Under `torchrun` each process is one shard of a process mesh
(`launch.mesh.make_process_mesh`: NCCL on `cuda:<LOCAL_RANK>`, gloo with
`--device cpu`): (data = WORLD_SIZE, model = 1), or the 16x16 mesh with
`--production-mesh`, which raises under 256 processes. Each rank keeps
its block of every weight (`sharding.layout`: the JAX package's dry-run
layout, `embed` over the data axes, heads, `ffn` and `vocab` over
`model`, every family) and its ZeRO slice of the AdamW state
on its device, and trains on its data coordinate's rows of each batch;
snapshots are written blocking, once, by rank 0, in the single-device
layout (gathered leaf by leaf), so one from any mesh resumes on any
other, on one device, or in the JAX package; a resume reads key by key,
each rank keeping its block.

    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --arch qwen2-7b --reduced --steps 6 --global-batch 4 --device cpu
"""
from __future__ import annotations

import argparse
import os
import time

import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config, reduced_config
from repro_torch.convert import (lm_param_tree, lm_params_to_numpy,
                                 load_lm_params_flat)
from repro_torch.data import DataConfig, SyntheticTokens
from repro_torch.launch.mesh import (make_local_mesh, make_process_mesh,
                                     make_production_mesh)
from repro_torch.models import get_model
from repro_torch.models.common import COMPUTE_DTYPE
from repro_torch.sharding.rules import (ShardingRules, active_rules,
                                        default_rules)
from repro_torch.train import AdamWConfig, init_state, make_train_step
from repro_torch.train.optimizer import state_from_host, state_to_host


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


def training_snapshot(model, params, opt_state, mesh):
    """The tree a training snapshot holds, in the single-device layout:
    the parameters and the AdamW state, gathered on the mesh's writer
    (None on every other rank; every rank must call it)."""
    weights = lm_params_to_numpy(model)
    opt = state_to_host(opt_state, params, mesh)
    return None if opt is None else dict(params=weights, opt=opt)


def restore_training(ckpt, model, params, opt_state, mesh, step=None):
    """Load `ckpt`'s snapshot at `step` (the latest when None) into
    `model` (of each leaf, its block where it keeps blocks); returns
    (`opt_state` with the snapshot's values, on a process mesh this
    rank's slice of them; the snapshot's step). Leaf by leaf: the host
    holds one array of the snapshot at a time."""
    with ckpt.reading(step) as (flat, manifest):
        load_lm_params_flat(model, flat)
        opt_state = state_from_host(flat, opt_state, params, mesh)
    return opt_state, manifest["step"]


def run_training(cfg, *, steps: int, global_batch: int, seq_len: int,
                 lr: float = 3e-4, num_microbatches: int = 1,
                 checkpoint_dir: str | None = None,
                 checkpoint_every: int = 50, q_chunk: int = 512,
                 log_every: int = 10, seed: int = 0, device=None,
                 mesh=None, step_seconds: list | None = None):
    """Train `cfg`'s model for `steps` steps (counted from 0, a resumed run
    going on from its checkpoint's step) under the sharding rules of
    `mesh` (`make_local_mesh(device)` when None). On a process mesh each
    rank trains on its own device and keeps its block of each weight and
    its ZeRO slice of the state. Returns (model, AdamW state,
    the losses of the steps this call ran); each step's wall seconds,
    its loss read back included, go into `step_seconds` when given."""
    mesh = mesh or make_local_mesh(device)
    process = mesh.process
    if process:
        device = mesh.devices[0]
    rules = ShardingRules(mesh, default_rules("pod" in mesh.shape))
    say = print if mesh.writer else (lambda *a, **k: None)
    with active_rules(rules):
        model = get_model(cfg)(cfg, device=device, seed=seed,
                               mesh=mesh if process else None)
        adam = AdamWConfig(lr=lr)
        params = lm_param_tree(model)
        opt_state = init_state(params, adam, mesh=mesh)
        step_fn = make_train_step(cfg, model, adam,
                                  num_microbatches=num_microbatches,
                                  loss_kwargs=dict(q_chunk=q_chunk),
                                  mesh=mesh)
        data = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size,
                                          seq_len=seq_len,
                                          global_batch=global_batch,
                                          seed=seed))
        ckpt = (Checkpointer(checkpoint_dir, mesh=mesh if process else None)
                if checkpoint_dir else None)
        start_step = 0
        if ckpt and ckpt.latest_step() is not None:
            opt_state, start_step = restore_training(ckpt, model, params,
                                                     opt_state, mesh)
            say(f"[train] restored step {start_step}")

        def snapshot():
            return training_snapshot(model, params, opt_state, mesh)

        losses = []
        t0 = time.time()
        for i in range(start_step, steps):
            t_step = time.time()
            opt_state, metrics = step_fn(
                opt_state, make_batch(cfg, data.batch_at(i), model.device))
            losses.append(float(metrics["loss"]))
            if step_seconds is not None:
                step_seconds.append(time.time() - t_step)
            if (i + 1) % log_every == 0:
                dt = (time.time() - t0) / max(len(losses), 1)
                say(f"[train] step {i+1:5d} loss {losses[-1]:.4f} "
                    f"gnorm {float(metrics['grad_norm']):.3f} "
                    f"{dt*1e3:.0f} ms/step", flush=True)
            if ckpt and (i + 1) % checkpoint_every == 0:
                ckpt.save(i + 1, snapshot(), blocking=process)
        if ckpt and start_step < steps and steps % checkpoint_every == 0:
            ckpt.wait()         # the last step's snapshot, being written
        elif ckpt:
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
    if "WORLD_SIZE" in os.environ:          # under torchrun
        shape = ({"data": 16, "model": 16} if args.production_mesh else
                 {"data": int(os.environ["WORLD_SIZE"]), "model": 1})
        mesh = make_process_mesh(shape, args.device)
    else:
        mesh = make_production_mesh() if args.production_mesh else None

    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    _, _, losses = run_training(
        cfg, steps=args.steps, global_batch=args.global_batch,
        seq_len=args.seq_len, lr=args.lr,
        num_microbatches=args.microbatches,
        checkpoint_dir=args.checkpoint_dir, q_chunk=64, device=args.device,
        mesh=mesh)
    if mesh is None or mesh.writer:
        print(f"[train] done. loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    if mesh is not None and mesh.process:
        import torch.distributed as dist
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
