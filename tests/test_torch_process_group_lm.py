"""The LM training step with one process a shard (`launch.mesh.
make_process_mesh`): the sharded MoE over `torch.distributed`, the
data-parallel step and ZeRO-1 AdamW state, snapshots, and
`compressed_psum` across processes, against the JAX package's
`shard_map` and `run_training` on a 2x2 mesh of 4 forced host devices,
and against the port's own single-device step.

The port's side runs in gloo groups spawned beside two JAX subprocesses
(`devices=4`, meshes built with `jax.sharding.Mesh`; one runs the
collectives and the MoE, the other `run_training`): 4 processes at
(data 2, model 2), 4 at (data 4, model 1) and 1 at (1, 1), each a
`FileStore` in the test's temporary directory, one torch thread a
process, every process killed past `JOIN_TIMEOUT`. The JAX step-0
snapshots the 2x2 group resumes are written in this process by JAX's
init and Checkpointer (JAX's own `run_training` trains from the same
init; it does not resume a snapshot onto a mesh of several devices).

Parity levels:
  * level 1 (bit-exact): each MoE data shard's capacity and drops, and
    `p.dropped` (the sum over the data ranks) on every rank; the world-1
    process mesh against the local mesh (parameters and state, two steps
    of reduced Qwen2-7B and DBRX); the residuals of `compressed_psum`;
    the model ranks of one data row among themselves (outputs and the
    gradients of every leaf computed whole); every rank's parameters
    after a step (one all-gather of one state);
  * level 2: the collectives' values and gradients against `jax.grad`
    through `shard_map` (`TOL_F32` relative: a sum of 4 float32 in
    another order); the MoE's `out` within `TOL_LAYER` of its largest
    magnitude and `aux` within 1e-5 relative (tests/test_torch_moe_sharded.py),
    its gradients of sum(out * r), and of aux alone, with respect to x,
    the router, the expert and the shared weights within `TOL_LAYER` of
    each leaf's
    largest magnitude (bf16 matmuls round in other places in XLA than in
    torch, and the model ranks' partial outputs add in bf16); the
    reduced gradient against the single-device gradient of the global
    batch within `TOL_GRAD` of each leaf's largest (measured at most
    0.016 at 2x2: the same bf16 rounding); training losses within
    `TOL_LOSS` relative and parameters within `TOL_PARAM` (JAX's own 2x2
    and 1x1 runs differ by 0.00195 here, one bf16 step at 0.25-0.5);
    the update itself, each leaf's gathered masters less their init,
    within `TOL_UPDATE` of the reference's in norm (`update_err`: a
    skipped step reads about 0.5 to 1, a step of the other sign 2,
    another leaf's update about 1.4; measured at most 0.15), but for
    `NOISE_LEAVES`.

The MoE inputs are tests/test_torch_moe_sharded.py's: capacity factor
1.0 and seeds whose data shards drop assignments, with every token's
top-k gate margin above `MARGIN`.
"""
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from conftest import REPO_SRC
from repro.checkpoint import Checkpointer as JCheckpointer
from repro.configs import reduced_config as jax_reduced_config
from repro.models import get_model as jax_get_model
from repro.train import AdamWConfig as JAdamWConfig
from repro.train import init_state as jax_init_state
from repro_torch.configs import reduced_config
from repro_torch.convert import lm_params_to_numpy
from repro_torch.launch import train as launch_train
from repro_torch.train import AdamWConfig
from repro_torch.train.optimizer import QBLOCK, _pad_len, zero_share
from test_torch_moe_sharded import (ARCHS as MOE_ARCHS, SEEDS_2X2,
                                    TOL_LAYER, assert_margins, draw, flat)

TRAIN_ARCHS = ("qwen2-7b", "dbrx-132b")
SHAPES = {"2x2": {"data": 2, "model": 2}, "4x1": {"data": 4, "model": 1},
          "1x1": {"data": 1, "model": 1}}
STEPS, BATCH, SEQ, Q_CHUNK = 2, 4, 16, 16
GROUP_TIMEOUT = 60       # seconds, on a group's collectives
FAIL_TIMEOUT = 10        # seconds, on the collectives of the failure case
JOIN_TIMEOUT = 240       # seconds, for a whole group to finish
TOL_F32 = 1e-6
TOL_GRAD = 0.03
TOL_LOSS = 2e-3
TOL_PARAM = 4e-3
TOL_UPDATE = 0.25
# leaves whose update is not held to TOL_UPDATE: Qwen2's key bias, whose
# gradient is mostly below the rounding of the bf16 sums that make it
# (median entry 3.7e-5 against a largest of 0.039 here), so each
# package's Adam step on it follows rounding noise (update error 0.06 to
# 1.03 here, every other leaf at most 0.15)
NOISE_LEAVES = ("attn/bk",)
COLL_N = 6               # columns of the collectives' inputs
# configs whose blocks take the paths the two archs do not: reduced
# Qwen3-32B's qk-norm with one key/value head, which the model ranks of a
# 2x2 mesh replicate (each reads it for its own query heads)
BLOCK_VARIANTS = (("qwen3-32b-kv1", ("qwen3-32b", dict(num_kv_heads=1))),)

JAX_HEAD = """
import dataclasses, json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from repro.configs import reduced_config
from repro.core.routing import shard_map
from repro.launch.train import run_training
from repro.models import moe
from repro.sharding import ShardingRules, default_rules
from repro.train.compression import compressed_psum
TMP, MOE_ARCHS, TRAIN_ARCHS, STEPS, BATCH, SEQ, Q_CHUNK = %(consts)r
devs = jax.devices()[:4]
mesh = Mesh(np.array(devs).reshape(2, 2), ("data", "model"))
line = Mesh(np.array(devs), ("d",))
out = {}
"""
# the layer-level references, beside the training run in a process of
# their own
JAX_LAYER_CODE = JAX_HEAD + """
# collectives over 4 devices: values and jax.grad through shard_map
z = np.load(TMP + "/coll.npz")
x, c, w, cg = (jnp.asarray(z[k]) for k in ("x", "c", "w", "cg"))
sm = lambda f, i, o: shard_map(f, line, i, o)
def f_psum(x):
    y = sm(lambda xl: jax.lax.psum(xl[0], "d") * c, (P("d", None),), P())(x)
    return jnp.sum(y), y
def f_pmean(x):
    y = sm(lambda xl: jax.lax.pmean(xl[0], "d") * c, (P("d", None),),
           P())(x)
    return jnp.sum(y), y
def f_pvary(w):
    y = sm(lambda wl, xl: wl * xl, (P(), P("d", None)), P("d", None))(w, x)
    return jnp.sum(y), y
def f_gather(x):
    y = sm(lambda xl, cl: jnp.sum(jax.lax.all_gather(
        xl, "d", axis=0, tiled=True) * cl[0])[None],
        (P("d", None), P("d", None, None)), P("d"))(x, cg)
    return jnp.sum(y), y
coll = {}
for name, f, arg in (("psum", f_psum, x), ("pmean", f_pmean, x),
                     ("pvary", f_pvary, w), ("all_gather", f_gather, x)):
    g, y = jax.grad(f, has_aux=True)(arg)
    coll[name] = dict(value=np.asarray(y).tolist(),
                      grad=np.asarray(g).tolist())
out["coll"] = coll

# compressed_psum inside shard_map: over data (2) and over all 4
z = np.load(TMP + "/comp.npz")
comp = {}
for axes in (("data",), ("data", "model")):
    spec = P(("data", "model"), None)
    f = shard_map(lambda xl, rl: tuple(
        a[None] for a in compressed_psum(xl[0], axes, rl[0])), mesh,
        (spec, spec), (spec, spec))
    res = jnp.zeros_like(jnp.asarray(z["x"][0]))
    ys, rs = [], []
    for xs in z["x"]:
        y, res = f(jnp.asarray(xs), res)
        ys.append(np.asarray(y))
        rs.append(np.asarray(res))
    np.savez(TMP + "/comp_%%d.npz" %% len(axes), y=np.stack(ys),
             r=np.stack(rs))

# the sharded MoE on 2x2: forward, drops, jax.grad of sum(out*r) and of aux
for name in MOE_ARCHS:
    cfg = dataclasses.replace(reduced_config(name), capacity_factor=1.0)
    z = np.load(TMP + "/moe_" + name + ".npz")
    jp, _ = moe.init_moe(jax.random.PRNGKey(0), cfg)
    def put(path, like):
        key = "p." + ".".join(str(getattr(k, "key", k)) for k in path)
        return jnp.asarray(z[key], like.dtype)
    p = jax.tree_util.tree_map_with_path(put, jp)
    x = jnp.asarray(z["x"], jnp.bfloat16)
    r = jnp.asarray(z["r"])
    rules = ShardingRules(mesh, default_rules(False))
    grads = {}
    for obj in ("g", "a"):      # sum(out * r), then the aux loss alone
        def F(x, p):
            y, aux = moe.moe_forward_sharded(p, x, cfg, rules)
            f = jnp.sum(y.astype(jnp.float32) * r) if obj == "g" else aux
            return f, (y, aux)
        (gx, gp), (y, aux) = jax.jit(jax.grad(F, argnums=(0, 1),
                                              has_aux=True))(x, p)
        grads[obj + "x"] = np.asarray(gx, np.float32)
        grads.update({obj + "." + ".".join(
            str(getattr(k, "key", k)) for k in path): np.asarray(
                v, np.float32)
            for path, v in jax.tree_util.tree_flatten_with_path(gp)[0]})
    drops = []
    for xl in np.split(np.asarray(z["x"]), 2, axis=0):
        xf = jnp.asarray(xl, jnp.bfloat16).reshape(-1, cfg.d_model)
        logits = jnp.einsum("nd,de->ne", xf.astype(jnp.float32), p["router"])
        _, e = jax.lax.top_k(jax.nn.softmax(logits, axis=-1),
                             cfg.num_experts_per_tok)
        rank = moe._rank_within(e.reshape(-1).astype(jnp.int32))
        cap = moe.capacity_for(cfg, xf.shape[0])
        drops.append(int(jnp.sum(rank >= cap)))
    np.savez(TMP + "/moe_" + name + "_jax.npz",
             out=np.asarray(y, np.float32), **grads)
    out["moe_" + name] = dict(aux=float(aux), drops=drops, capacity=cap)

print(json.dumps(out))
"""
# run_training on the 2x2 mesh, from the init of the step-0 snapshot
JAX_TRAIN_CODE = JAX_HEAD + """
for name in TRAIN_ARCHS:
    p, st, losses = run_training(reduced_config(name), steps=STEPS,
                                 global_batch=BATCH, seq_len=SEQ, mesh=mesh,
                                 q_chunk=Q_CHUNK, log_every=10 ** 6)
    np.savez(TMP + "/train_" + name + "_jax.npz", **{
        pre + "/".join(str(getattr(k, "key", k)) for k in path):
        np.asarray(v, np.float32)
        for pre, tree in (("", p), ("master/", st.master))
        for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]})
    out["train_" + name] = [float(l) for l in losses]

# the dry run's program: make_train_step jitted with the parameters and
# the state laid out by the sharding rules (in_ and out_shardings), on
# 2x2 and 4x1, from the same init and batches: each device's shard of the
# init, its bytes, and two steps
from repro.data import DataConfig, SyntheticTokens
from repro.models import get_model
from repro.sharding.rules import active_rules
from repro.train import AdamWConfig, init_state, make_train_step, state_axes
for tag, grid in (("2x2", (2, 2)), ("4x1", (4, 1))):
    m2 = Mesh(np.array(devs).reshape(grid), ("data", "model"))
    rules2 = ShardingRules(m2, default_rules(False))
    for name in TRAIN_ARCHS:
        cfg = reduced_config(name)
        model = get_model(cfg)
        params, axes = model.init_params(cfg, jax.random.PRNGKey(0))
        adam = AdamWConfig()
        opt = init_state(params, adam)
        psh = rules2.tree_shardings(params, axes)
        osh = rules2.tree_shardings(opt, state_axes(axes, False))
        bsh = {k: rules2.sharding(("batch", None), (BATCH, SEQ))
               for k in ("tokens", "labels")}
        p = jax.device_put(params, psh)
        o = jax.device_put(opt, osh)
        arrays, nbytes = {}, [0] * len(devs)
        for path, leaf in jax.tree_util.tree_flatten_with_path(p)[0]:
            key = "/".join(str(getattr(k, "key", k)) for k in path)
            for sh in leaf.addressable_shards:
                d = devs.index(sh.device)
                arrays["init%%d/%%s" %% (d, key)] = np.asarray(sh.data,
                                                            np.float32)
                nbytes[d] += sh.data.nbytes
        with active_rules(rules2):
            step = jax.jit(make_train_step(cfg, model, adam,
                                           loss_kwargs=dict(q_chunk=Q_CHUNK)),
                           in_shardings=(psh, osh, bsh),
                           out_shardings=(psh, osh, None))
            data = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size,
                                              seq_len=SEQ, global_batch=BATCH,
                                              seed=0))
            losses = []
            for i in range(STEPS):
                b = data.batch_at(i)
                p, o, met = step(p, o, dict(tokens=jnp.asarray(b["tokens"]),
                                            labels=jnp.asarray(b["labels"])))
                losses.append(float(met["loss"]))
        for pre, tree in (("", p), ("master/", o.master)):
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
                arrays[pre + "/".join(str(getattr(k, "key", k))
                                      for k in path)] = np.asarray(
                                          v, np.float32)
        np.savez(TMP + "/sharded_%%s_%%s_jax.npz" %% (tag, name), **arrays)
        out["sharded_%%s_%%s" %% (tag, name)] = dict(losses=losses,
                                                   bytes=nbytes)
print(json.dumps(out))
"""

GROUP_START = """
import datetime, json, os, shutil, sys, time
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
RANK, WORLD = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
dist.init_process_group(
    "gloo", store=dist.FileStore(os.environ["PG_STORE"], WORLD), rank=RANK,
    world_size=WORLD, timeout=datetime.timedelta(seconds=%(timeout)d))
"""
GROUP_END = """
for case in %(cases)r:
    out[case] = globals()[case]()
print(json.dumps(out), flush=True)
os._exit(0)       # the failure case leaves the group broken
"""
CHILD = """
import dataclasses
from repro_torch.configs import reduced_config
from repro_torch.convert import lm_param_tree, lm_params_to_numpy
from repro_torch.data import DataConfig, SyntheticTokens
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import make_local_mesh, make_process_mesh
from repro_torch.models import get_model
from repro_torch.models import moe as tmoe
from repro_torch.sharding import ShardingRules, active_rules, default_rules
from repro_torch.sharding import collectives as coll
from repro_torch.train import AdamWConfig, init_state, make_train_step
from repro_torch.train.compression import compressed_psum
from repro_torch.train.optimizer import (leaf_paths, reduce_scatter_grads,
                                         state_to_host, tree_leaves,
                                         _flatten_pad, _pad_len, leaf_size)
from repro_torch.train.train_step import accumulate_grads, rank_grads
TMP, TAG, SHAPE, CONSTS = %(consts)r
(MOE_ARCHS, TRAIN_ARCHS, STEPS, BATCH, SEQ, Q_CHUNK, FAIL_TIMEOUT,
 COLL_N, BLOCK_VARIANTS) = CONSTS
mesh = make_process_mesh(SHAPE, "cpu")
data, model, zero = (mesh.group(a) for a in (("data",), ("model",),
                                             ("data", "model")))
out = dict(rank=RANK, coords=mesh.coords)
rules = ShardingRules(mesh, default_rules(False))

def save(name, **arrays):
    np.savez(f"{TMP}/{TAG}_{name}_r{RANK}.npz", **arrays)

def npflat(tree, prefix=""):
    res = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            res.update(npflat(v, f"{prefix}{k}/"))
        else:
            res[prefix + k] = np.asarray(v)
    return res

def collectives():
    z = np.load(TMP + "/coll.npz")
    res = {}
    def grad_of(fn, arg):
        t = torch.tensor(arg, requires_grad=True)
        y = fn(t)
        y.sum().backward()
        return dict(value=y.detach().numpy().tolist(),
                    grad=t.grad.numpy().tolist())
    c = torch.tensor(z["c"])
    xr = z["x"][RANK]
    res["psum"] = grad_of(lambda t: coll.psum(t, zero) * c, xr)
    res["pmean"] = grad_of(lambda t: coll.pmean(t, zero) * c, xr)
    res["pvary"] = grad_of(lambda t: coll.pvary(t, zero)
                           * torch.tensor(xr), z["w"])
    cg = torch.tensor(z["cg"][RANK])
    res["all_gather"] = grad_of(lambda t: (coll.all_gather(
        t, zero, 0) * cg).sum().reshape(1), z["x"][RANK:RANK + 1])
    return res

def compressed():
    z = np.load(TMP + "/comp.npz")
    res = {}
    for name, group in (("2", data), ("4", zero)):
        r = torch.zeros(1, z["x"].shape[2])
        ys, rs = [], []
        for xs in z["x"]:
            y, r = compressed_psum(torch.tensor(xs[RANK:RANK + 1]), group, r)
            ys.append(y.numpy())
            rs.append(r[0].numpy())
        save("comp" + name, y=np.stack(ys), r=np.stack(rs))
    return True

def moe():
    res = {}
    i = mesh.coords["data"]
    for name in MOE_ARCHS:
        z = np.load(f"{TMP}/moe_{name}.npz")
        cfg = dataclasses.replace(reduced_config(name), capacity_factor=1.0)
        mod = tmoe.MoE(cfg, device="cpu", gen=None)
        with torch.no_grad():
            for k in z.files:
                if k.startswith("p."):
                    mod.get_parameter(k[2:]).copy_(torch.tensor(z[k]))
        B = z["x"].shape[0] // data.shards
        xl = torch.tensor(z["x"][i * B:(i + 1) * B]).to(torch.bfloat16)
        r = torch.tensor(z["r"][i * B:(i + 1) * B])
        xf = xl.reshape(-1, cfg.d_model)
        _, _, _, drop = tmoe._dispatch_compute_combine(
            xf, torch.matmul(xf.float(), mod.router), mod.w_gate, mod.w_up,
            mod.w_down, cfg)
        mod.requires_grad_(True)
        grads = {}
        for obj in ("g", "a"):
            # each data rank's part of sum(out * r), then of the aux loss
            # (the same on every data rank: a 1/dp part each)
            mod.zero_grad(set_to_none=True)
            mod.dropped.zero_()
            x = xl.clone().requires_grad_(True)
            with active_rules(rules):
                y, aux = tmoe.moe_forward(mod, x, cfg)
            (torch.sum(y.float() * r) if obj == "g"
             else aux / data.shards).backward()
            grads[obj + "x"] = x.grad.float().numpy()
            grads.update({obj + "." + k: (
                np.zeros(tuple(p.shape), np.float32) if p.grad is None
                else p.grad.float().numpy())
                for k, p in mod.named_parameters()})
        save("moe_" + name, out=y.detach().float().numpy(), **grads)
        res[name] = dict(aux=float(aux), dropped=int(mod.dropped),
                         drop=int(drop),
                         capacity=tmoe.capacity_for(cfg, xf.shape[0]))
    return res

def train_jax():
    res = {}
    for name in TRAIN_ARCHS:
        d = f"{TMP}/{TAG}_resume_{name}"
        if mesh.writer:
            shutil.copytree(f"{TMP}/start_{name}", d)
        mesh.barrier()
        m, st, losses = launch_train.run_training(
            reduced_config(name), steps=STEPS, global_batch=BATCH,
            seq_len=SEQ, device="cpu", mesh=mesh, checkpoint_dir=d,
            q_chunk=Q_CHUNK, log_every=10 ** 6)
        params = lm_param_tree(m)
        weights = lm_params_to_numpy(m)       # every rank takes part
        host = state_to_host(st, params, mesh)
        if mesh.writer:
            save("train_" + name, **npflat(weights), **{
                "master/" + k: np.asarray(a) for k, a in
                zip(leaf_paths(params), tree_leaves(host.master))})
        res[name] = losses
    return res

def blocks():
    # JAX's init (the step-0 snapshot) loaded onto the blocks: each rank's
    # block of every leaf and its weight bytes; and the seeded init on the
    # blocks against the single-device one
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.convert import load_lm_params_flat
    from repro_torch.sharding.layout import placement
    res = {}
    for name in TRAIN_ARCHS:
        cfg = reduced_config(name)
        m = get_model(cfg)(cfg, device="cpu", seed=None, mesh=mesh)
        with Checkpointer(f"{TMP}/start_{name}").reading(0) as (flat, _):
            load_lm_params_flat(m, flat)
        tree = lm_param_tree(m)
        save("blocks_" + name, **{
            path: (np.stack([t.detach().float().numpy() for t in leaf])
                   if isinstance(leaf, list)
                   else leaf.detach().float().numpy())
            for path, leaf in zip(leaf_paths(tree), tree_leaves(tree))})
        seeded = get_model(cfg)(cfg, device="cpu", seed=0, mesh=mesh)
        one = dict(get_model(cfg)(cfg, device="cpu",
                                  seed=0).named_parameters())
        res[name] = dict(
            bytes=sum(t.numel() * t.element_size() for t in m.parameters()),
            split=sum(tuple(t.shape) != placement(t).shape
                      for t in m.parameters()),
            seeded_equal=all(torch.equal(t, one[k][placement(t).index])
                             for k, t in seeded.named_parameters()))
    return res

def vocab():
    # the vocab-parallel lookup and loss against the whole table's, at a
    # vocab `model` divides and at one it does not (replicated); every
    # rank the same inputs
    from repro_torch.models.common import (Embedding, cross_entropy, embed,
                                           unembed, vocab_split)
    from repro_torch.sharding.layout import keep_blocks_, placement
    res = {}
    for V in (64, 63):
        tables = [Embedding(V, 32, device="cpu",
                            gen=torch.Generator().manual_seed(3))
                  for _ in range(2)]
        keep_blocks_(tables[1], mesh)
        rng = np.random.default_rng(V)
        tokens = torch.tensor(rng.integers(0, V, (2, 8)))
        labels = torch.tensor(rng.integers(0, V, (2, 8)))
        x0 = torch.tensor(rng.standard_normal((2, 8, 32)),
                          dtype=torch.float32).to(torch.bfloat16)
        w = torch.tensor(rng.standard_normal((2, 8, 32)), dtype=torch.float32)
        got = []
        for e in tables:
            e.requires_grad_(True)
            x = x0.clone().requires_grad_(True)
            rows = embed(e, tokens)
            loss = cross_entropy(unembed(e, x), labels, vocab=vocab_split(e))
            (loss + (rows.float() * w).sum()).backward()
            got.append((rows.detach(), loss.detach(), x.grad.float(),
                        e.table.grad.float()))
        (r0, l0, gx0, gt0), (r1, l1, gx1, gt1) = got
        pl = placement(tables[1].table)
        # each data rank's gradient of the same inputs, summed over data
        # by the gather's backward
        want_gt = data.shards * gt0[pl.index]
        res[str(V)] = dict(
            split=vocab_split(tables[1]) is not None,
            rows_equal=bool(torch.equal(r0, r1)),
            loss_err=float(abs(l1 - l0) / abs(l0)),
            gx_err=float((gx1 - gx0).abs().max() / gx0.abs().max()),
            gt_err=float((gt1 - want_gt).abs().max() / want_gt.abs().max()))
    return res

def coll_bytes():
    # the collectives of one real step against the dry run's trace of
    # this rank's step on fake tensors
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.launch.dryrun import trace_rank
    from repro_torch.sharding.collectives import CollectiveLog
    res = {}
    for name in TRAIN_ARCHS:
        cfg = reduced_config(name)
        adam = AdamWConfig()
        with active_rules(rules):
            m = get_model(cfg)(cfg, device="cpu", seed=0, mesh=mesh)
            st = init_state(lm_param_tree(m), adam, mesh=mesh)
            step = make_train_step(cfg, m, adam, mesh=mesh,
                                   loss_kwargs=dict(q_chunk=Q_CHUNK))
            src = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size,
                                             seq_len=SEQ, global_batch=BATCH,
                                             seed=0))
            with CollectiveLog() as log:
                step(st, launch_train.make_batch(cfg, src.batch_at(0), "cpu"))
        traced = trace_rank(cfg, ShapeConfig("t", SEQ, BATCH, "train"), SHAPE,
                            RANK, device="cpu", q_chunk=Q_CHUNK)
        res[name] = dict(real=log.bytes, real_calls=log.calls,
                         traced=traced["coll_by_kind"],
                         traced_calls=traced["coll_calls"],
                         temp=traced["temp_bytes"])
    return res

def zero_steps():
    res = {}
    for name in TRAIN_ARCHS:
        cfg = reduced_config(name)
        for int8 in (False, True):
            adam = AdamWConfig(int8_moments=int8)
            with active_rules(rules):
                m = get_model(cfg)(cfg, device="cpu", seed=0)
                st = init_state(lm_param_tree(m), adam, mesh=mesh)
                step = make_train_step(cfg, m, adam, mesh=mesh,
                                       loss_kwargs=dict(q_chunk=Q_CHUNK))
                src = SyntheticTokens(DataConfig(
                    vocab_size=cfg.vocab_size, seq_len=SEQ,
                    global_batch=BATCH, seed=0))
                losses = []
                for i in range(STEPS):
                    st, met = step(st, launch_train.make_batch(
                        cfg, src.batch_at(i), "cpu"))
                    losses.append(float(met["loss"]))
            params = lm_param_tree(m)
            host = state_to_host(st, params, mesh)
            lens = [dict(n=_pad_len(leaf_size(p)), master=int(a.numel()),
                         m=[int(t.numel()) for t in (b if int8 else (b,))],
                         v=[int(t.numel()) for t in (c if int8 else (c,))])
                    for p, a, b, c in zip(tree_leaves(params),
                                          tree_leaves(st.master),
                                          tree_leaves(st.m),
                                          tree_leaves(st.v))]
            tag = f"{name}_{int(int8)}"
            if mesh.writer:
                save("zero_" + tag, **npflat(lm_params_to_numpy(m)),
                     **{f"master/{i}": np.asarray(a) for i, a in
                        enumerate(tree_leaves(host.master))})
            else:
                save("zero_" + tag, **npflat(lm_params_to_numpy(m)))
            res[tag] = dict(losses=losses, lens=lens)
    return res

def config_of(name):
    # a reduced config, or BLOCK_VARIANTS' one
    if name in dict(BLOCK_VARIANTS):
        base, kw = dict(BLOCK_VARIANTS)[name]
        return dataclasses.replace(reduced_config(base), **kw)
    return reduced_config(name)

def grads(blocks=False):
    # the whole model's parts of the gradient (each model rank computing
    # every dense leaf whole), or with `blocks` each rank's blocks
    res = {}
    for name in TRAIN_ARCHS + ((tuple(n for n, _ in BLOCK_VARIANTS))
                               if blocks else ()):
        cfg = config_of(name)
        src = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size,
                                         seq_len=SEQ, global_batch=8,
                                         seed=0))
        b = launch_train.make_batch(cfg, src.batch_at(0), "cpu")
        kw = dict(q_chunk=Q_CHUNK, aux_coef=1.0)
        for nm in (1, 2):
            m = get_model(cfg)(cfg, device="cpu", seed=0,
                               mesh=mesh if blocks else None)
            m.requires_grad_(True)
            params = lm_param_tree(m)
            with active_rules(rules):
                g, loss = rank_grads(m, params, b, mesh, nm, kw)
            mine = reduce_scatter_grads(params, g, zero, data.shards)
            full = []
            for s in mine:
                f = torch.empty(zero.shards * s.numel())
                dist.all_gather_into_tensor(f, s, group=zero.group)
                full.append(f)
            one = m if not blocks else get_model(cfg)(cfg, device="cpu",
                                                       seed=0)
            one.requires_grad_(True)
            with active_rules(ShardingRules(make_local_mesh("cpu"),
                                            default_rules(False))):
                g1, loss1 = accumulate_grads(one, lm_param_tree(one), b, nm,
                                             kw)
            errs = []
            for f, leaf in zip(full, tree_leaves(g1)):
                ref = _flatten_pad(leaf)
                errs.append(float((f[:ref.numel()] - ref).abs().max()
                                  / ref.abs().max()))
            res[f"{name}_{nm}"] = dict(errs=errs, loss=float(loss),
                                       loss1=float(loss1))
    return res

def block_grads():
    return grads(blocks=True)

def kill():
    cfg = reduced_config("dbrx-132b")
    kw = dict(global_batch=BATCH, seq_len=SEQ, device="cpu",
              q_chunk=Q_CHUNK, log_every=10 ** 6)
    d = f"{TMP}/{TAG}_kill"
    launch_train.run_training(cfg, steps=2, mesh=mesh, checkpoint_dir=d,
                              **kw)
    if mesh.writer:
        shutil.copytree(d, d + "_1")      # for one process, in the test
        shutil.copytree(d, d + "_2x2")
    mesh.barrier()
    m, _, whole = launch_train.run_training(cfg, steps=4, mesh=mesh, **kw)
    weights = lm_params_to_numpy(m)          # every rank takes part
    if mesh.writer:
        save("kill_whole", **npflat(weights))
    other = make_process_mesh({"data": 2, "model": 2}, "cpu")
    m, _, resumed = launch_train.run_training(
        cfg, steps=4, mesh=other, checkpoint_dir=d + "_2x2", **kw)
    weights = lm_params_to_numpy(m)
    if other.writer:
        save("kill_2x2", **npflat(weights))
    return dict(whole=whole, resumed=resumed)

def kill_reverse():
    # reduced Qwen2-7B saved at 2x2 (the same four processes), resumed at
    # 4x1 here, and on one device and in JAX by the test
    cfg = reduced_config("qwen2-7b")
    kw = dict(global_batch=BATCH, seq_len=SEQ, device="cpu",
              q_chunk=Q_CHUNK, log_every=10 ** 6)
    other = make_process_mesh({"data": 2, "model": 2}, "cpu")
    d = f"{TMP}/{TAG}_rev"
    launch_train.run_training(cfg, steps=2, mesh=other, checkpoint_dir=d,
                              **kw)
    if mesh.writer:
        for copy in ("_1", "_jax", "_4x1"):
            shutil.copytree(d, d + copy)
    mesh.barrier()
    m, _, whole = launch_train.run_training(cfg, steps=4, mesh=other, **kw)
    weights = lm_params_to_numpy(m)
    if other.writer:
        save("rev_whole", **npflat(weights))
    m, _, resumed = launch_train.run_training(
        cfg, steps=4, mesh=mesh, checkpoint_dir=d + "_4x1", **kw)
    weights = lm_params_to_numpy(m)
    if mesh.writer:
        save("rev_4x1", **npflat(weights))
    return dict(whole=whole, resumed=resumed)

def world_one():
    res = {}
    for name in TRAIN_ARCHS:
        kw = dict(steps=STEPS, global_batch=BATCH, seq_len=SEQ,
                  device="cpu", q_chunk=Q_CHUNK, log_every=10 ** 6)
        a = launch_train.run_training(reduced_config(name), mesh=mesh, **kw)
        b = launch_train.run_training(reduced_config(name), **kw)
        same = lambda x, y: all(torch.equal(s, t) for s, t in zip(x, y))
        res[name] = dict(
            losses=a[2] == b[2],
            params=same(a[0].parameters(), b[0].parameters()),
            state=all(same(tree_leaves(getattr(a[1], f)),
                           tree_leaves(getattr(b[1], f)))
                      for f in ("master", "m", "v")))
    return res

def cli():
    # the training CLI under a launcher's environment (WORLD_SIZE set):
    # --production-mesh raises short of 256 processes; without it the
    # world is (data = WORLD_SIZE, model = 1); destroys the group: last
    try:
        launch_train.main(["--production-mesh", "--device", "cpu"])
        refused = None
    except RuntimeError as e:
        refused = str(e)
    launch_train.main(["--arch", "qwen2-7b", "--reduced", "--steps", "2",
                       "--global-batch", "4", "--seq-len", "16",
                       "--device", "cpu"])
    return dict(refused=refused, destroyed=not dist.is_initialized())

def failure():
    bad = make_process_mesh(SHAPE, "cpu", timeout=FAIL_TIMEOUT)
    real = launch_train.make_batch
    calls = []
    def make_batch(*a):
        calls.append(1)
        if RANK == 1 and len(calls) == 2:
            raise RuntimeError("injected fault on rank 1")
        return real(*a)
    launch_train.make_batch = make_batch
    t0 = time.monotonic()
    try:
        launch_train.run_training(reduced_config("qwen2-7b"), steps=3,
                                  global_batch=BATCH, seq_len=SEQ,
                                  device="cpu", mesh=bad, q_chunk=Q_CHUNK,
                                  log_every=10 ** 6)
        raised = None
    except Exception as e:
        raised = f"{type(e).__name__}: {e}"[:200]
    return dict(raised=raised, seconds=time.monotonic() - t0)
"""
CASES = {"2x2": ["collectives", "compressed", "moe", "train_jax",
                 "zero_steps", "grads", "blocks", "block_grads", "vocab",
                 "coll_bytes"],
         "4x1": ["collectives", "zero_steps", "grads", "train_jax", "blocks",
                 "block_grads", "kill", "kill_reverse", "failure"],
         "1x1": ["world_one", "cli"]}


def start_group(tag, tmp):
    """Start the processes of the group `tag` (a key of SHAPES); returns
    (processes, their log files)."""
    shape = SHAPES[tag]
    world = int(np.prod(list(shape.values())))
    consts = (str(tmp), tag, shape,
              (MOE_ARCHS, TRAIN_ARCHS, STEPS, BATCH, SEQ, Q_CHUNK,
               FAIL_TIMEOUT, COLL_N, BLOCK_VARIANTS))
    code = (GROUP_START % dict(timeout=GROUP_TIMEOUT)
            + CHILD % dict(consts=consts) + GROUP_END % dict(
                cases=CASES[tag]))
    env = dict(os.environ, PYTHONPATH=REPO_SRC, WORLD_SIZE=str(world),
               PG_STORE=str(tmp / f"store_{tag}"), OMP_NUM_THREADS="1")
    procs, logs = [], []
    for rank in range(world):
        log = open(tmp / f"rank_{tag}_{rank}.log", "w+")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code], env=dict(env, RANK=str(rank)),
            stdout=log, stderr=subprocess.STDOUT, text=True))
    return procs, logs


def join(procs, logs, deadline, what):
    """Each process's JSON, once all have ended (killed past
    `deadline`)."""
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
    outs = []
    for rank, (p, log) in enumerate(zip(procs, logs)):
        log.seek(0)
        text = log.read()
        log.close()
        assert p.returncode == 0, f"{what} rank {rank}:\n{text[-3000:]}"
        outs.append(json.loads(text.strip().splitlines()[-1]))
    return outs


def write_inputs(tmp):
    """The inputs both packages read: the collectives' and compression's
    arrays, the MoE weights and batches, and the step-0 snapshots (JAX's
    init and AdamW state, written by JAX's Checkpointer)."""
    rng = np.random.default_rng(7)
    np.savez(tmp / "coll.npz",
             x=rng.standard_normal((4, COLL_N)).astype(np.float32),
             c=rng.standard_normal(COLL_N).astype(np.float32),
             w=rng.standard_normal(COLL_N).astype(np.float32),
             cg=rng.standard_normal((4, 4, COLL_N)).astype(np.float32))
    np.savez(tmp / "comp.npz",
             x=rng.standard_normal((2, 4, 700)).astype(np.float32))
    for name in MOE_ARCHS:
        p, x = draw(name, seed=SEEDS_2X2[name])
        r = np.random.default_rng(11).standard_normal(x.shape).astype(
            np.float32)
        np.savez(tmp / f"moe_{name}.npz", x=x, r=r,
                 **{"p." + k: v for k, v in flat(p).items()})
    for name in TRAIN_ARCHS:
        cfg = jax_reduced_config(name)
        params, _ = jax_get_model(cfg).init_params(cfg,
                                                   jax.random.PRNGKey(0))
        JCheckpointer(str(tmp / f"start_{name}")).save(
            0, dict(params=params, opt=jax_init_state(params,
                                                      JAdamWConfig())),
            blocking=True)


def single_device_steps(name, int8):
    """The port's single-device step (2 steps, the groups' batches and
    init): (losses, parameters, masters and the masters before the first
    step, by leaf path)."""
    from repro_torch.convert import lm_param_tree
    from repro_torch.data import DataConfig, SyntheticTokens
    from repro_torch.models import get_model
    from repro_torch.train import init_state, make_train_step
    from repro_torch.train.optimizer import leaf_paths, tree_leaves
    cfg = reduced_config(name)
    adam = AdamWConfig(int8_moments=int8)
    m = get_model(cfg)(cfg, device="cpu", seed=0)
    st = init_state(lm_param_tree(m), adam)
    paths = list(leaf_paths(st.master))
    init = {k: t.numpy().copy() for k, t in zip(paths,
                                                 tree_leaves(st.master))}
    step = make_train_step(cfg, m, adam, loss_kwargs=dict(q_chunk=Q_CHUNK))
    src = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                                     global_batch=BATCH, seed=0))
    losses = []
    for i in range(STEPS):
        st, met = step(st, launch_train.make_batch(cfg, src.batch_at(i),
                                                   "cpu"))
        losses.append(float(met["loss"]))
    return (losses, npflat(lm_params_to_numpy(m)),
            dict(zip(paths, (t.numpy() for t in tree_leaves(st.master)))),
            init)


def npflat(tree, prefix=""):
    res = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            res.update(npflat(v, f"{prefix}{k}/"))
        else:
            res[prefix + k] = np.asarray(v)
    return res


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"jax": JAX's JSON, "tmp": the directory, tag: [per-process JSON]},
    and the port's single-device references, computed while the groups
    and JAX run."""
    tmp = tmp_path_factory.mktemp("process_group_lm")
    write_inputs(tmp)
    env = dict(os.environ, PYTHONPATH=REPO_SRC,
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    consts = (str(tmp), MOE_ARCHS, TRAIN_ARCHS, STEPS, BATCH, SEQ, Q_CHUNK)
    jax_runs = {}
    for what, code in (("layer", JAX_LAYER_CODE), ("train", JAX_TRAIN_CODE)):
        log = open(tmp / f"jax_{what}.log", "w+")
        jax_runs[what] = (subprocess.Popen(
            [sys.executable, "-c", code % dict(consts=consts)], env=env,
            stdout=log, stderr=subprocess.STDOUT, text=True), log)
    deadline = time.monotonic() + JOIN_TIMEOUT
    groups = {tag: start_group(tag, tmp) for tag in CASES}
    single = {(name, int8): single_device_steps(name, int8)
              for name in TRAIN_ARCHS for int8 in (False, True)}
    out = dict(tmp=tmp, single=single)
    for tag, (procs, logs) in groups.items():
        out[tag] = join(procs, logs, deadline, tag)
    out["jax"] = {}
    for what, (proc, log) in jax_runs.items():
        try:
            proc.wait(timeout=max(deadline - time.monotonic(), 1))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        log.seek(0)
        text = log.read()
        log.close()
        assert proc.returncode == 0, f"JAX {what}:\n{text[-3000:]}"
        out["jax"].update(json.loads(text.strip().splitlines()[-1]))
    return out


def rank_npz(runs, tag, name, rank):
    return np.load(runs["tmp"] / f"{tag}_{name}_r{rank}.npz")


def update_err(got, want, init) -> float:
    """How far a leaf's update (got - init) is from the reference's (want
    - init): ||got - want|| / ||want - init|| in float64. 0 for the same
    update, 1 for none, 2 for one of the other sign, about 1.4 for
    another leaf's of the same size."""
    ref = np.linalg.norm(want.astype(np.float64) - init)
    diff = np.linalg.norm(got.astype(np.float64) - want)
    return diff / ref if ref else (0.0 if diff == 0 else np.inf)


def assert_updates_close(errs: dict) -> None:
    """Every leaf's update error (by path) within TOL_UPDATE, but those of
    NOISE_LEAVES; at least one leaf checked."""
    held = {k: e for k, e in errs.items() if not k.endswith(NOISE_LEAVES)}
    assert held and max(held.values()) <= TOL_UPDATE, errs


def assert_close_trees(got, want, tol, what):
    assert sorted(got) == sorted(want), what
    for k in want:
        err = np.abs(got[k].astype(np.float64) - want[k]).max()
        assert err <= tol, f"{what} {k}: {err}"


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tag", ["2x2", "4x1"])
@pytest.mark.parametrize("prim", ["psum", "pmean", "pvary", "all_gather"])
def test_collectives_match_jax_grad_through_shard_map(runs, tag, prim):
    """Each collective over the 4 ranks of the ZeRO group: its value and
    the gradient of the sum of its consumers against `jax.grad` through
    `shard_map` over 4 devices. psum and pmean feed a value every rank
    consumes alike (JAX: out_specs P()); pvary a replicated weight each
    rank multiplies by its own row; all_gather each rank's own weights."""
    want = runs["jax"]["coll"][prim]
    for o in runs[tag]:
        r = o["rank"]
        got = o["collectives"][prim]
        if prim in ("psum", "pmean"):
            value, grad = want["value"], np.asarray(want["grad"])[r]
        elif prim == "pvary":
            value, grad = np.asarray(want["value"])[r], want["grad"]
        else:
            value, grad = [want["value"][r]], np.asarray(want["grad"])[r:r + 1]
        np.testing.assert_allclose(got["value"], value, rtol=TOL_F32,
                                   atol=TOL_F32)
        np.testing.assert_allclose(got["grad"], grad, rtol=TOL_F32,
                                   atol=TOL_F32)


@pytest.mark.parametrize("procs", ["2", "4"])
def test_compressed_psum_across_processes(runs, procs):
    """`compressed_psum` over the data axis (2 processes) and over all 4,
    each process its own row and residual, two calls with feedback:
    JAX's inside `shard_map`; residuals bit-exact, sums level 2."""
    ref = np.load(runs["tmp"] / f"comp_{1 if procs == '2' else 2}.npz")
    for o in runs["2x2"]:
        r = o["rank"]
        got = rank_npz(runs, "2x2", "comp" + procs, r)
        assert np.array_equal(got["r"], ref["r"][:, r])
        np.testing.assert_allclose(got["y"], ref["y"][:, r], rtol=TOL_F32,
                                   atol=TOL_F32)


# ---------------------------------------------------------------------------
# the sharded MoE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", MOE_ARCHS)
def test_moe_forward_matches_jax_shard_map(runs, name):
    ref = runs["jax"]["moe_" + name]
    want = np.load(runs["tmp"] / f"moe_{name}_jax.npz")
    z = np.load(runs["tmp"] / f"moe_{name}.npz")
    cfg = dataclasses.replace(reduced_config(name), capacity_factor=1.0)
    assert_margins(cfg, {"router": z["p.router"]}, z["x"])
    by_rank = {o["rank"]: o for o in runs["2x2"]}
    outs = []
    for r, o in sorted(by_rank.items()):
        got = o["moe"][name]
        i = o["coords"]["data"]
        assert got["capacity"] == ref["capacity"]
        assert got["drop"] == ref["drops"][i]
        assert got["dropped"] == sum(ref["drops"]) > 0
        assert abs(got["aux"] - ref["aux"]) <= 1e-5 * abs(ref["aux"])
        out = rank_npz(runs, "2x2", "moe_" + name, r)["out"]
        rows = want["out"].shape[0] // 2
        err = np.abs(out - want["out"][i * rows:(i + 1) * rows]).max()
        assert err <= TOL_LAYER * np.abs(want["out"]).max()
        outs.append((i, out))
    for i in range(2):          # the model ranks of a data row agree
        same = [out for j, out in outs if j == i]
        assert all(np.array_equal(same[0], s) for s in same[1:])


@pytest.mark.parametrize("obj", ["out", "aux"])
@pytest.mark.parametrize("name", MOE_ARCHS)
def test_moe_grads_match_jax_shard_map(runs, name, obj):
    """The gradients of sum(out * r), and of the aux loss alone (where a
    factor of dp in the backward of its data-axis mean would show): each
    rank's x gradient is its data shard's; a leaf computed whole on every
    model rank (router, shared experts) summed over the data ranks from
    model rank 0, equal on the other model rank; the expert weights'
    f-slices summed over every rank."""
    want = np.load(runs["tmp"] / f"moe_{name}_jax.npz")
    pre = "g" if obj == "out" else "a"
    ranks = {o["rank"]: o["coords"] for o in runs["2x2"]}
    got = {r: rank_npz(runs, "2x2", "moe_" + name, r) for r in ranks}
    rows = want[pre + "x"].shape[0] // 2
    for r, c in ranks.items():
        i = c["data"]
        ref = want[pre + "x"][i * rows:(i + 1) * rows]
        assert np.abs(got[r][pre + "x"] - ref).max() <= \
            TOL_LAYER * np.abs(want[pre + "x"]).max()
    keys = [k for k in want.files if k.startswith(pre + ".")]
    assert sorted(keys) == sorted(k for k in got[0].files
                                  if k.startswith(pre + "."))
    for k in keys:
        expert = k[2:] in ("w_up", "w_gate", "w_down")
        if expert:
            total = sum(got[r][k] for r in ranks)
        else:
            total = sum(got[r][k] for r, c in ranks.items()
                        if c["model"] == 0)
            for r, c in ranks.items():
                twin = [q for q, d in ranks.items()
                        if d["data"] == c["data"] and d["model"] == 0][0]
                assert np.array_equal(got[r][k], got[twin][k]), k
        err = np.abs(total - want[k]).max()
        assert err <= TOL_LAYER * np.abs(want[k]).max(), (k, err)


# ---------------------------------------------------------------------------
# the data-parallel step and ZeRO-1
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", TRAIN_ARCHS)
def test_train_matches_jax_run_training_on_2x2(runs, name):
    """The 2x2 group resumes JAX's step-0 snapshot and takes 2 steps: the
    losses and the parameters against JAX's `run_training` on its 2x2
    mesh from the same init, and each leaf's update of the gathered
    masters against JAX's within `TOL_UPDATE`. Every process reports the
    same losses."""
    want = runs["jax"]["train_" + name]
    losses = [o["train_jax"][name] for o in runs["2x2"]]
    assert all(l == losses[0] for l in losses)
    np.testing.assert_allclose(losses[0], want, rtol=TOL_LOSS)
    ref = dict(np.load(runs["tmp"] / f"train_{name}_jax.npz"))
    got = dict(rank_npz(runs, "2x2", "train_" + name, 0))
    init, _ = JCheckpointer(str(runs["tmp"] / f"start_{name}")).restore(0)
    masters = sorted(k for k in ref if k.startswith("master/"))
    assert masters and masters == sorted(k for k in got
                                         if k.startswith("master/"))
    errs = {k: update_err(got.pop(k), ref.pop(k), init["opt/" + k])
            for k in masters}
    assert_updates_close(errs)
    assert_close_trees(got, ref, TOL_PARAM, name)


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("name", TRAIN_ARCHS)
@pytest.mark.parametrize("tag", ["2x2", "4x1"])
def test_zero_step_matches_single_device(runs, tag, name, int8):
    """Two steps from the port's seeded init: losses, parameters (equal on
    every rank) and each leaf's update of the gathered masters against
    the single-device step (within `TOL_UPDATE`); each rank keeps its
    block-aligned 1/Z share of master, m and v."""
    losses, params, masters, init = runs["single"][(name, int8)]
    key = f"{name}_{int(int8)}"
    Z = len(runs[tag])
    outs = [o["zero_steps"][key] for o in runs[tag]]
    assert all(o["losses"] == outs[0]["losses"] for o in outs)
    np.testing.assert_allclose(outs[0]["losses"], losses, rtol=TOL_LOSS)
    for o in outs:
        for leaf in o["lens"]:
            share = zero_share(leaf["n"], Z)
            assert share % QBLOCK == 0
            assert share <= leaf["n"] / Z + QBLOCK
            assert leaf["master"] == share
            want = [share, share // QBLOCK] if int8 else [share]
            assert leaf["m"] == leaf["v"] == want
    first = dict(rank_npz(runs, tag, "zero_" + key, 0))
    for r in range(1, Z):
        other = dict(rank_npz(runs, tag, "zero_" + key, r))
        assert all(np.array_equal(other[k], first[k]) for k in other)
    got = {k: v for k, v in first.items() if not k.startswith("master/")}
    assert_close_trees(got, params, TOL_PARAM, key)
    errs = {path: update_err(first[f"master/{i}"], want, init[path])
            for i, (path, want) in enumerate(masters.items())}
    assert_updates_close(errs)


@pytest.mark.parametrize("name", TRAIN_ARCHS)
@pytest.mark.parametrize("tag", ["2x2", "4x1"])
def test_reduced_gradient_is_the_single_device_one(runs, tag, name):
    """The gradient invariant, at 1 and 2 microbatches, with the aux loss
    weighted 1.0 (so a factor of dp in it would show): the ranks' parts
    summed over the ZeRO group and divided by dp against the
    single-device gradient of the global batch (8 rows), each leaf; the
    reported loss is the global batch's."""
    for nm in (1, 2):
        got = runs[tag][0]["grads"][f"{name}_{nm}"]
        assert max(got["errs"]) <= TOL_GRAD, got["errs"]
        assert got["loss"] == pytest.approx(got["loss1"], rel=TOL_LOSS)


def test_world_one_process_mesh_equals_local_mesh(runs):
    """(data 1, model 1) over a gloo world of one: two steps of reduced
    Qwen2-7B and DBRX equal the local mesh's bit for bit (Z = 1 changes
    no arithmetic)."""
    got = runs["1x1"][0]["world_one"]
    assert got == {name: dict(losses=True, params=True, state=True)
                   for name in TRAIN_ARCHS}


def test_cli_under_a_launcher(runs):
    got = runs["1x1"][0]["cli"]
    assert got["refused"].startswith("need 256 processes, have 1")
    assert got["destroyed"]


def test_constrain_takes_a_ranks_local_block():
    """On a process mesh `constrain` holds a rank's block (1 row of a
    batch split over 4 data ranks) to its dims' count alone."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.sharding import ShardingRules, default_rules
    mesh = Mesh({"data": 4, "model": 1}, (torch.device("cpu"),),
                coords={"data": 1, "model": 0}, groups={})
    rules = ShardingRules(mesh, default_rules(False))
    x = torch.zeros(1, 16, 8)
    assert rules.constrain(x, ("batch", "seq", "embed")) is x
    with pytest.raises(ValueError, match="axes"):
        rules.constrain(x, ("batch", "seq"))


def test_remat_recomputes_under_the_forwards_rules():
    """On the card autograd runs the backward on a thread of its own, where
    the forward's thread-local sharding rules are not: a remat re-run of
    an MoE layer must still take the sharded path (else its f-slices
    come back whole and the checkpoint refuses them). Here the backward
    runs on another thread; its gradients equal the calling thread's."""
    import threading
    from repro_torch.convert import lm_param_tree
    from repro_torch.data import DataConfig, SyntheticTokens
    from repro_torch.launch.mesh import make_stacked_mesh
    from repro_torch.models import get_model
    from repro_torch.sharding import ShardingRules, active_rules, \
        default_rules
    from repro_torch.train.optimizer import tree_leaves
    cfg = reduced_config("dbrx-132b")
    model = get_model(cfg)(cfg, device="cpu", seed=0).requires_grad_(True)
    params = [t for leaf in tree_leaves(lm_param_tree(model))
              for t in (leaf if isinstance(leaf, list) else [leaf])]
    batch = launch_train.make_batch(cfg, SyntheticTokens(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=SEQ, global_batch=BATCH,
        seed=0)).batch_at(0), "cpu")
    rules = ShardingRules(make_stacked_mesh({"data": 2, "model": 2},
                                            "cpu"), default_rules(False))
    grads = {}
    for where in ("here", "thread"):
        with active_rules(rules):
            loss, _ = model.loss_fn(batch, q_chunk=Q_CHUNK)
        box = []

        def backward():
            try:
                box.append(torch.autograd.grad(loss, params))
            except Exception as e:      # reported below
                box.append(e)
        if where == "here":
            backward()
        else:
            t = threading.Thread(target=backward)
            t.start()
            t.join(timeout=120)
            assert not t.is_alive()
        assert not isinstance(box[0], Exception), box[0]
        grads[where] = box[0]
    assert all(torch.equal(a, b)
               for a, b in zip(grads["here"], grads["thread"]))


# ---------------------------------------------------------------------------
# the weights at rest in blocks (the dry run's layout)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", TRAIN_ARCHS)
@pytest.mark.parametrize("tag", ["2x2", "4x1"])
def test_blocks_equal_jax_addressable_shards(runs, tag, name):
    """JAX's init (its step-0 snapshot) loaded onto a process mesh that
    keeps blocks: each rank's block of every leaf equals the shard that
    JAX's dry-run layout (`tree_shardings` of the parameters) puts on the
    device of the same mesh coordinates, bit for bit, and the rank's
    weight bytes JAX's bytes on that device; some leaves are split. The
    seeded init on the blocks equals the single-device one's blocks."""
    want = np.load(runs["tmp"] / f"sharded_{tag}_{name}_jax.npz")
    nbytes = runs["jax"][f"sharded_{tag}_{name}"]["bytes"]
    for o in runs[tag]:
        r = o["rank"]
        got = rank_npz(runs, tag, "blocks_" + name, r)
        keys = sorted(k[len(f"init{r}/"):] for k in want.files
                      if k.startswith(f"init{r}/"))
        assert keys == sorted(got.files)
        for k in keys:
            ref = want[f"init{r}/{k}"]
            assert got[k].shape == ref.shape and np.array_equal(got[k], ref), k
        res = o["blocks"][name]
        assert res["bytes"] == nbytes[r]
        assert res["split"] > 0 and res["seeded_equal"]


@pytest.mark.parametrize("name", TRAIN_ARCHS)
@pytest.mark.parametrize("tag", ["2x2", "4x1"])
def test_train_matches_jax_sharded_program(runs, tag, name):
    """The group resumes JAX's step-0 snapshot onto its blocks and takes 2
    steps (`run_training`): the losses, each leaf's update of the
    gathered masters and the gathered parameters against JAX's
    `make_train_step` jitted with the dry run's `in_shardings` and
    `out_shardings` on the same mesh from the same init."""
    ref = dict(np.load(runs["tmp"] / f"sharded_{tag}_{name}_jax.npz"))
    ref = {k: v for k, v in ref.items() if not k.startswith("init")}
    want = runs["jax"][f"sharded_{tag}_{name}"]["losses"]
    losses = [o["train_jax"][name] for o in runs[tag]]
    assert all(l == losses[0] for l in losses)
    np.testing.assert_allclose(losses[0], want, rtol=TOL_LOSS)
    got = dict(rank_npz(runs, tag, "train_" + name, 0))
    init, _ = JCheckpointer(str(runs["tmp"] / f"start_{name}")).restore(0)
    masters = sorted(k for k in ref if k.startswith("master/"))
    assert masters and masters == sorted(k for k in got
                                         if k.startswith("master/"))
    errs = {k: update_err(got.pop(k), ref.pop(k), init["opt/" + k])
            for k in masters}
    assert_updates_close(errs)
    assert_close_trees(got, ref, TOL_PARAM, name)


@pytest.mark.parametrize("name", TRAIN_ARCHS + tuple(
    n for n, _ in BLOCK_VARIANTS))
@pytest.mark.parametrize("tag", ["2x2", "4x1"])
def test_block_gradient_is_the_single_device_one(runs, tag, name):
    """The gradient invariant on blocks, at 1 and 2 microbatches, the aux
    loss weighted 1.0: each rank's block gradients (already summed over
    the data ranks by the FSDP gathers' backward where the data axes
    split them) handed on once, reduce-scattered into the flat ZeRO
    ranges, gathered, against the single-device gradient of the global
    batch, each leaf."""
    for nm in (1, 2):
        got = runs[tag][0]["block_grads"][f"{name}_{nm}"]
        assert max(got["errs"]) <= TOL_GRAD, got["errs"]
        assert got["loss"] == pytest.approx(got["loss1"], rel=TOL_LOSS)


@pytest.mark.parametrize("vocab", ["64", "63"])
def test_vocab_parallel_lookup_and_loss(runs, vocab):
    """At 2x2 the table's vocab splits over `model` where 2 divides it
    (64) and is replicated where it does not (63): the lookup equals the
    whole table's bit for bit (one rank's rows, zeros summed), the loss
    and the input's gradient within `TOL_F32` relative, the table's
    block gradient the whole one's block summed over the 2 data ranks."""
    for o in runs["2x2"]:
        got = o["vocab"][vocab]
        assert got["split"] == (vocab == "64")
        assert got["rows_equal"]
        assert got["loss_err"] <= TOL_F32
        assert got["gx_err"] <= TOL_LAYER and got["gt_err"] <= TOL_LAYER


@pytest.mark.parametrize("name", TRAIN_ARCHS)
def test_dryrun_rank_trace_records_the_gloo_steps_collectives(runs, name):
    """The dry run's trace of one rank's step on fake tensors
    (`launch.dryrun.trace_rank`, under `make_rank_mesh`) notes the same
    collectives, by kind, count and bytes, as the real step of that rank
    moved over gloo at 2x2."""
    for o in runs["2x2"]:
        got = o["coll_bytes"][name]
        assert got["traced"] == got["real"] and \
            got["traced_calls"] == got["real_calls"], got
        assert got["temp"] > 0


# ---------------------------------------------------------------------------
# snapshots and failures
# ---------------------------------------------------------------------------

def test_snapshot_crosses_meshes_and_one_device(runs):
    """Reduced DBRX under 4 processes stopped after its step-2 snapshot
    (single-device layout, written by rank 0): resumed to step 4 on one
    CPU process here and on a 2x2 process mesh, each within level 2 of
    the 4-process run that was never stopped."""
    whole = dict(rank_npz(runs, "4x1", "kill_whole", 0))
    out = runs["4x1"][0]["kill"]
    tmp = runs["tmp"]
    m, state, losses = launch_train.run_training(
        reduced_config("dbrx-132b"), steps=4, global_batch=BATCH,
        seq_len=SEQ, device="cpu", q_chunk=Q_CHUNK, log_every=10 ** 6,
        checkpoint_dir=str(tmp / "4x1_kill_1"))
    assert int(state.step) == 4
    np.testing.assert_allclose(losses, out["whole"][2:], rtol=TOL_LOSS)
    np.testing.assert_allclose(out["resumed"], out["whole"][2:],
                               rtol=TOL_LOSS)
    assert_close_trees(npflat(lm_params_to_numpy(m)), whole, TOL_PARAM,
                       "one process")
    assert_close_trees(dict(rank_npz(runs, "4x1", "kill_2x2", 0)), whole,
                       TOL_PARAM, "2x2")
    flat, _ = JCheckpointer(str(tmp / "4x1_kill")).restore(2)
    cfg = reduced_config("dbrx-132b")
    from repro_torch.convert import lm_param_tree
    from repro_torch.models import get_model
    from repro_torch.train.optimizer import tree_leaves
    leaves = list(tree_leaves(lm_param_tree(get_model(cfg)(
        cfg, device="cpu", seed=0))))
    n = [_pad_len(sum(t.numel() for t in (l if isinstance(l, list)
                                          else [l]))) for l in leaves]
    masters = sorted(k for k in flat if k.startswith("opt/master/"))
    assert sorted(flat[k].shape[0] for k in masters) == sorted(n)


def test_snapshot_from_2x2_resumes_at_4x1_one_device_and_jax(runs):
    """Reduced Qwen2-7B on blocks at 2x2 stopped after its step-2
    snapshot (single-device layout, gathered leaf by leaf by rank 0):
    resumed to step 4 at 4x1 (blocks cut from it key by key), on one CPU
    process here and by JAX's `run_training` on one device, each within
    level 2 of the 2x2 run that was never stopped."""
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from repro.launch.train import run_training as jax_run_training
    whole = dict(rank_npz(runs, "4x1", "rev_whole", 0))
    out = runs["4x1"][0]["kill_reverse"]
    tmp = runs["tmp"]
    kw = dict(steps=4, global_batch=BATCH, seq_len=SEQ, q_chunk=Q_CHUNK,
              log_every=10 ** 6)
    np.testing.assert_allclose(out["resumed"], out["whole"][2:],
                               rtol=TOL_LOSS)
    assert_close_trees(dict(rank_npz(runs, "4x1", "rev_4x1", 0)), whole,
                       TOL_PARAM, "4x1")
    m, state, losses = launch_train.run_training(
        reduced_config("qwen2-7b"), device="cpu",
        checkpoint_dir=str(tmp / "4x1_rev_1"), **kw)
    assert int(state.step) == 4
    np.testing.assert_allclose(losses, out["whole"][2:], rtol=TOL_LOSS)
    assert_close_trees(npflat(lm_params_to_numpy(m)), whole, TOL_PARAM,
                       "one process")
    one = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    p, _, losses = jax_run_training(
        jax_reduced_config("qwen2-7b"), mesh=one,
        checkpoint_dir=str(tmp / "4x1_rev_jax"), **kw)
    np.testing.assert_allclose(losses, out["whole"][2:], rtol=TOL_LOSS)
    got = {"/".join(str(getattr(k, "key", k)) for k in path):
           np.asarray(jnp.asarray(v, jnp.float32))
           for path, v in jax.tree_util.tree_flatten_with_path(p)[0]}
    assert_close_trees(got, whole, TOL_PARAM, "JAX")


def test_snapshot_from_4x1_resumes_in_jax(runs):
    """The reverse: reduced DBRX on blocks at 4x1 stopped after its step-2
    snapshot (resumed at 2x2 and on one device by
    `test_snapshot_crosses_meshes_and_one_device`) resumed to step 4 by
    JAX's `run_training` on one device, within level 2 of the 4x1 run
    that was never stopped."""
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from repro.launch.train import run_training as jax_run_training
    tmp = runs["tmp"]
    shutil.copytree(tmp / "4x1_kill", tmp / "4x1_kill_jax")
    whole = dict(rank_npz(runs, "4x1", "kill_whole", 0))
    out = runs["4x1"][0]["kill"]
    one = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    p, _, losses = jax_run_training(
        jax_reduced_config("dbrx-132b"), mesh=one, steps=4,
        global_batch=BATCH, seq_len=SEQ, q_chunk=Q_CHUNK, log_every=10 ** 6,
        checkpoint_dir=str(tmp / "4x1_kill_jax"))
    np.testing.assert_allclose(losses, out["whole"][2:], rtol=TOL_LOSS)
    got = {"/".join(str(getattr(k, "key", k)) for k in path):
           np.asarray(jnp.asarray(v, jnp.float32))
           for path, v in jax.tree_util.tree_flatten_with_path(p)[0]}
    assert_close_trees(got, whole, TOL_PARAM, "JAX")


def test_a_failing_rank_makes_every_rank_raise(runs):
    """Rank 1 raises before its second step: every rank raises, within
    the group timeout of its collectives."""
    outs = [o["failure"] for o in runs["4x1"]]
    assert "injected fault" in outs[1]["raised"]
    assert all(o["raised"] for o in outs)
    assert all(o["seconds"] < FAIL_TIMEOUT + 20 for o in outs)
