"""The weights at rest in blocks for the LM families beyond the GQA
transformers: MLA (reduced DeepSeek-V2), the VLM (reduced InternVL2),
Mamba-2, RG-LRU (reduced RecurrentGemma) and Whisper, each rank of a
process mesh (`launch.mesh.make_process_mesh`) keeping its block of
every weight (`sharding.layout`), against the JAX package's dry-run
program on a mesh of 4 forced host devices and against the port's own
single-device step.

The port's side runs in gloo groups spawned beside one JAX subprocess
(`devices=4`): 4 processes at (data 2, model 2), 4 at (data 4, model 1)
and 1 at (1, 1), each a `FileStore` in the test's temporary directory,
one torch thread a process, every process killed past `JOIN_TIMEOUT`.
Each runs all five families. Both packages start from each family's
step-0 snapshot: JAX's init and AdamW state, written by the JAX
subprocess with JAX's Checkpointer. The JAX subprocess lays it out by
the sharding rules (`tree_shardings` of the parameters, as the dry run's
`in_shardings`) at 2x2 and 4x1, saves each device's `addressable_shards`
and bytes, and at 2x2 takes two steps of `make_train_step` jitted with
those `in_shardings`/`out_shardings`, the VLM's image embeddings and
Whisper's frames drawn from a numpy seed; it then resumes the port's
snapshots of `SNAPSHOT_FAMILIES` with the same program.

Parity levels and tolerances are tests/test_torch_process_group_lm.py's:
bit-exact blocks, weight bytes and world 1; losses within `TOL_LOSS`,
parameters within `TOL_PARAM`, updates within `TOL_UPDATE`, gradients
within `TOL_GRAD` of each leaf's largest.
"""
import json
import os
import subprocess
import sys
import time

import jax
import numpy as np
import pytest

from conftest import REPO_SRC
from repro.checkpoint import Checkpointer as JCheckpointer
from repro_torch.configs import reduced_config
from repro_torch.convert import lm_params_to_numpy
from repro_torch.launch import train as launch_train
from test_torch_lm_train import MIN_MARGIN, moe_margins
from test_torch_process_group_lm import (  # noqa: F401 (autouse fixture)
    TOL_GRAD, TOL_LOSS, TOL_PARAM, assert_close_trees, assert_updates_close,
    join, npflat, one_torch_thread, rank_npz, update_err)

FAMILIES = ("deepseek-v2-236b", "internvl2-1b", "mamba2-1.3b",
            "recurrentgemma-9b", "whisper-tiny")
# the families whose snapshot crosses meshes: stacked groups, enc-dec
SNAPSHOT_FAMILIES = ("recurrentgemma-9b", "whisper-tiny")
SHAPES = {"2x2": {"data": 2, "model": 2}, "4x1": {"data": 4, "model": 1},
          "1x1": {"data": 1, "model": 1}}
STEPS, BATCH, SEQ, Q_CHUNK = 2, 4, 16, 16
# the sharded program's data seed of each family (0 otherwise): reduced
# DeepSeek-V2's seed-0 batches hold tokens whose k-th and (k+1)-th gates
# are 3e-4 apart, which bf16 rounding routes to other experts in JAX's
# 2x2 program than in its one-device one; seed 1's are over `MIN_MARGIN`
# (tests/test_torch_lm_train.py)
DATA_SEEDS = {"deepseek-v2-236b": 1}
GROUP_TIMEOUT = 60       # seconds, on a group's collectives
JOIN_TIMEOUT = 300       # seconds, for a whole group to finish

# The JAX side, in one subprocess, a thread a family (XLA compiles
# outside the GIL): JAX's init and AdamW state (jitted) saved as the
# family's step-0 snapshot `start_<name>` (then `start_<name>.done`), the
# 2x2 program's two steps (the extra inputs of `extras_<name>.npz`); then
# each device's shards at 2x2 and 4x1, and the resumes of the port's
# snapshots
JAX_CODE = """
import json, os, time
from concurrent.futures import ThreadPoolExecutor
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.checkpoint import Checkpointer, restore_into
from repro.configs import reduced_config
from repro.data import DataConfig, SyntheticTokens
from repro.models import get_model
from repro.sharding import ShardingRules, default_rules
from repro.sharding.rules import active_rules
from repro.train import AdamWConfig, init_state, make_train_step, state_axes
(TMP, FAMILIES, SNAPSHOT_FAMILIES, DATA_SEEDS, STEPS, BATCH, SEQ, Q_CHUNK,
 WAIT) = __CONSTS__
devs = jax.devices()[:4]
adam = AdamWConfig()
key_of = lambda path: "/".join(str(getattr(k, "key", k)) for k in path)
flat = lambda tree, pre="": {pre + key_of(path): np.asarray(v, np.float32)
                             for path, v in
                             jax.tree_util.tree_flatten_with_path(tree)[0]}
meshes = {tag: Mesh(np.array(devs).reshape(grid), ("data", "model"))
          for tag, grid in (("2x2", (2, 2)), ("4x1", (4, 1)))}
inits, compiled, out = {}, {}, {}

def wait_for(path):
    t0 = time.monotonic()
    while not os.path.exists(path):
        assert time.monotonic() - t0 < WAIT, "no " + path
        time.sleep(0.5)

def program(name, tag, data_seed, extras, steps, state=None):
    # make_train_step jitted with the dry run's shardings on the mesh
    # `tag` (once a family and mesh), from the init or `state`
    cfg, params, axes, opt = inits[name]
    if (name, tag) not in compiled:
        rules = ShardingRules(meshes[tag], default_rules(False))
        psh = rules.tree_shardings(params, axes)
        osh = rules.tree_shardings(opt, state_axes(axes, False))
        bsh = {k: rules.sharding(("batch", None), (BATCH, SEQ))
               for k in ("tokens", "labels")}
        bsh.update({k: rules.sharding(("batch", None, None), v.shape[2:])
                    for k, v in extras.items()})
        with active_rules(rules):
            step = jax.jit(make_train_step(cfg, get_model(cfg), adam,
                                           loss_kwargs=dict(q_chunk=Q_CHUNK)),
                           in_shardings=(psh, osh, bsh),
                           out_shardings=(psh, osh, None))
        compiled[name, tag] = (step, rules, psh, osh)
    step, rules, psh, osh = compiled[name, tag]
    p, o = state or (params, opt)
    p, o = jax.device_put(p, psh), jax.device_put(o, osh)
    data = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                                      global_batch=BATCH, seed=data_seed))
    losses = []
    with active_rules(rules):
        for i in steps:
            b = data.batch_at(i)
            batch = dict(tokens=jnp.asarray(b["tokens"]),
                         labels=jnp.asarray(b["labels"]))
            batch.update({k: jnp.asarray(v[i % len(v)], jnp.bfloat16)
                          for k, v in extras.items()})
            p, o, met = step(p, o, batch)
            losses.append(float(met["loss"]))
    return p, o, losses

def family(name):
    # JAX's init jitted (one compile, not an op at a time), its axes
    # taken while it traces
    cfg, box = reduced_config(name), {}
    def init(key):
        params, box["axes"] = get_model(cfg).init_params(cfg, key)
        return dict(params=params, opt=init_state(params, adam))
    start = jax.jit(init)(jax.random.PRNGKey(0))
    Checkpointer(TMP + "/start_" + name).save(0, start, blocking=True)
    open(TMP + "/start_" + name + ".done", "w").close()
    inits[name] = (cfg, start["params"], box["axes"], start["opt"])
    z = np.load(TMP + "/extras_" + name + ".npz")
    extras = {k: z[k] for k in z.files}
    p, o, losses = program(name, "2x2", DATA_SEEDS.get(name, 0), extras,
                           range(STEPS))
    np.savez(TMP + "/jax_steps_2x2_" + name + ".npz",
             **flat(p), **flat(o.master, "master/"))
    out["losses_2x2_" + name] = losses

with ThreadPoolExecutor(len(FAMILIES)) as pool:
    list(pool.map(family, FAMILIES))

# each device's shard of the init in the dry run's layout, and its bytes
for tag in ("2x2", "4x1"):
    for name in FAMILIES:
        cfg, params, axes, _ = inits[name]
        rules = ShardingRules(meshes[tag], default_rules(False))
        p = jax.device_put(params, rules.tree_shardings(params, axes))
        arrays, nbytes = {}, [0] * len(devs)
        for path, leaf in jax.tree_util.tree_flatten_with_path(p)[0]:
            for sh in leaf.addressable_shards:
                d = devs.index(sh.device)
                arrays["init%d/%s" % (d, key_of(path))] = np.asarray(
                    sh.data, np.float32)
                nbytes[d] += sh.data.nbytes
        np.savez(TMP + "/jax_%s_%s.npz" % (tag, name), **arrays)
        out["bytes_%s_%s" % (tag, name)] = nbytes

# the port's step-2 snapshots from 2x2, once the group has copied them,
# resumed to step 4 by the 2x2 program on run_training's batches (zero
# frames)
for name in SNAPSHOT_FAMILIES:
    cfg, params, _, opt = inits[name]
    d = TMP + "/4x1_snap_" + name + "_jax"
    wait_for(d + "/READY")
    snap, manifest = Checkpointer(d).restore()
    state = restore_into(dict(params=params, opt=opt), snap)
    z = np.load(TMP + "/extras_" + name + ".npz")
    extras = {k: np.zeros_like(z[k]) for k in z.files}
    p, _, losses = program(name, "2x2", 0, extras,
                           range(manifest["step"], 2 * STEPS),
                           (state["params"], state["opt"]))
    np.savez(TMP + "/jax_resumed_" + name + ".npz", **flat(p))
    out["resumed_" + name] = losses
print(json.dumps(out))
"""

GROUP_CODE = """
import datetime, json, os, shutil, sys, time
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
RANK, WORLD = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
dist.init_process_group(
    "gloo", store=dist.FileStore(os.environ["PG_STORE"], WORLD), rank=RANK,
    world_size=WORLD, timeout=datetime.timedelta(seconds=__TIMEOUT__))
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import reduced_config
from repro_torch.convert import (lm_param_tree, lm_params_to_numpy,
                                 load_lm_params_flat)
from repro_torch.data import DataConfig, SyntheticTokens
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import make_local_mesh, make_process_mesh
from repro_torch.models import get_model
from repro_torch.sharding import ShardingRules, active_rules, default_rules
from repro_torch.sharding.layout import placement
from repro_torch.train import AdamWConfig, init_state, make_train_step
from repro_torch.train.optimizer import (leaf_paths, reduce_scatter_grads,
                                         state_to_host, tree_leaves,
                                         _flatten_pad)
from repro_torch.train.train_step import accumulate_grads, rank_grads
TMP, TAG, SHAPE, FAMILIES, SNAPSHOT_FAMILIES, DATA_SEEDS, STEPS, BATCH, \\
    SEQ, Q_CHUNK = __CONSTS__
mesh = make_process_mesh(SHAPE, "cpu")
zero = mesh.group(("data", "model"))
dp = mesh.group(("data",)).shards
rules = ShardingRules(mesh, default_rules(False))
out = dict(rank=RANK, coords=mesh.coords)

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

def batch_of(cfg, i, global_batch=BATCH):
    # the pipeline's batch i with the extra inputs of `extras_<name>.npz`
    # (step i's, the sharded program's data seed), or of
    # `grad_extras_<name>.npz` at another batch size
    seed = DATA_SEEDS.get(cfg.name, 0) if global_batch == BATCH else 0
    src = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                                     global_batch=global_batch, seed=seed))
    b = launch_train.make_batch(cfg, src.batch_at(i), "cpu")
    pre = "" if global_batch == BATCH else "grad_"
    z = np.load(f"{TMP}/{pre}extras_{cfg.name}.npz")
    b.update({k: torch.tensor(z[k] if pre else z[k][i]).to(torch.bfloat16)
              for k in z.files})
    return b

def wait_for(path):
    t0 = time.monotonic()
    while not os.path.exists(path):
        assert time.monotonic() - t0 < __WAIT__, "no " + path
        time.sleep(0.5)

def blocks():
    # JAX's init (the step-0 snapshot) (the step-0 snapshot) loaded onto the blocks: each rank's
    # block of every leaf and its weight bytes; and the seeded init on the
    # blocks against the single-device one
    res = {}
    for name in FAMILIES:
        wait_for(f"{TMP}/start_{name}.done")
        cfg = reduced_config(name)
        m = get_model(cfg)(cfg, device="cpu", seed=None, mesh=mesh)
        with Checkpointer(f"{TMP}/start_{name}").reading(0) as (flat, _):
            load_lm_params_flat(m, flat)
        tree = lm_param_tree(m)
        save("blocks_" + name, **{
            path: (np.stack([t.detach().float().numpy() for t in leaf])
                   .reshape(leaf.lead + tuple(leaf[0].shape))
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

def sharded_steps():
    # JAX's step-0 snapshot resumed onto the blocks, two steps with the
    # sharded program's batches (extra inputs included)
    res = {}
    for name in FAMILIES:
        wait_for(f"{TMP}/start_{name}.done")
        cfg = reduced_config(name)
        adam = AdamWConfig()
        with active_rules(rules):
            m = get_model(cfg)(cfg, device="cpu", seed=None, mesh=mesh)
            params = lm_param_tree(m)
            st = init_state(params, adam, mesh=mesh)
            st, _ = launch_train.restore_training(
                Checkpointer(f"{TMP}/start_{name}", mesh=mesh), m, params,
                st, mesh)
            step = make_train_step(cfg, m, adam, mesh=mesh,
                                   loss_kwargs=dict(q_chunk=Q_CHUNK))
            losses = []
            for i in range(STEPS):
                st, met = step(st, batch_of(cfg, i))
                losses.append(float(met["loss"]))
        weights = lm_params_to_numpy(m)       # every rank takes part
        host = state_to_host(st, params, mesh)
        if mesh.writer:
            save("steps_" + name, **npflat(weights), **{
                "master/" + k: np.asarray(a) for k, a in
                zip(leaf_paths(params), tree_leaves(host.master))})
        res[name] = losses
    return res

def block_grads():
    # each rank's block gradients handed on once, summed into the ZeRO
    # ranges by the optimizer's exchange and gathered, against the single-device gradient of
    # the global batch (8 rows, random extra inputs), at 1 and 2
    # microbatches
    res = {}
    for name in FAMILIES:
        cfg = reduced_config(name)
        b = batch_of(cfg, 0, global_batch=2 * BATCH)
        kw = dict(q_chunk=Q_CHUNK, aux_coef=1.0)
        m = get_model(cfg)(cfg, device="cpu", seed=0, mesh=mesh)
        m.requires_grad_(True)
        params = lm_param_tree(m)
        one = get_model(cfg)(cfg, device="cpu", seed=0)
        one.requires_grad_(True)
        for nm in (1, 2):
            with active_rules(rules):
                g, loss = rank_grads(m, params, b, mesh, nm, kw)
            mine = reduce_scatter_grads(params, g, zero, dp)
            with active_rules(ShardingRules(make_local_mesh("cpu"),
                                            default_rules(False))):
                g1, loss1 = accumulate_grads(one, lm_param_tree(one), b, nm,
                                             kw)
            errs = {}
            for path, s, leaf in zip(leaf_paths(params), mine,
                                     tree_leaves(g1)):
                f = torch.empty(zero.shards * s.numel())
                dist.all_gather_into_tensor(f, s, group=zero.group)
                ref = _flatten_pad(leaf)
                errs[path] = float((f[:ref.numel()] - ref).abs().max()
                                   / ref.abs().max())
            res[f"{name}_{nm}"] = dict(errs=errs, loss=float(loss),
                                       loss1=float(loss1))
    return res

def snapshot():
    # each family of SNAPSHOT_FAMILIES on blocks at 2x2 (these processes)
    # stopped after its step-2 snapshot, then resumed to step 4 at 4x1 here
    # and on one device and in JAX by the test
    res = {}
    two = make_process_mesh({"data": 2, "model": 2}, "cpu")
    kw = dict(global_batch=BATCH, seq_len=SEQ, device="cpu",
              q_chunk=Q_CHUNK, log_every=10 ** 6)
    for name in SNAPSHOT_FAMILIES:
        cfg = reduced_config(name)
        d = f"{TMP}/{TAG}_snap_{name}"
        launch_train.run_training(cfg, steps=2, mesh=two, checkpoint_dir=d,
                                  **kw)
        if mesh.writer:
            for copy in ("_1", "_jax", "_4x1"):
                shutil.copytree(d, d + copy)
            open(d + "_jax/READY", "w").close()
        mesh.barrier()
        m, _, whole = launch_train.run_training(cfg, steps=4, mesh=two, **kw)
        weights = lm_params_to_numpy(m)
        if two.writer:
            save("snap_whole_" + name, **npflat(weights))
        m, _, resumed = launch_train.run_training(
            cfg, steps=4, mesh=mesh, checkpoint_dir=d + "_4x1", **kw)
        weights = lm_params_to_numpy(m)
        if mesh.writer:
            save("snap_4x1_" + name, **npflat(weights))
        res[name] = dict(whole=whole, resumed=resumed)
    return res

def coll_bytes():
    # the collectives of one real step against the dry run's trace of
    # this rank's step on fake tensors
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.launch.dryrun import trace_rank
    from repro_torch.sharding.collectives import CollectiveLog
    res = {}
    for name in FAMILIES:
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
        # a cell's length counts the VLM's image prefix (`input_specs`)
        seq = SEQ + (cfg.num_image_tokens if cfg.family == "vlm" else 0)
        traced = trace_rank(cfg, ShapeConfig("t", seq, BATCH, "train"), SHAPE,
                            RANK, device="cpu", q_chunk=Q_CHUNK)
        res[name] = dict(real=log.bytes, real_calls=log.calls,
                         traced=traced["coll_by_kind"],
                         traced_calls=traced["coll_calls"],
                         temp=traced["temp_bytes"])
    return res

def world_one():
    res = {}
    same = lambda x, y: all(torch.equal(s, t) for s, t in zip(x, y))
    for name in FAMILIES:
        kw = dict(steps=STEPS, global_batch=BATCH, seq_len=SEQ,
                  device="cpu", q_chunk=Q_CHUNK, log_every=10 ** 6)
        a = launch_train.run_training(reduced_config(name), mesh=mesh, **kw)
        b = launch_train.run_training(reduced_config(name), **kw)
        res[name] = dict(
            losses=a[2] == b[2],
            params=same(a[0].parameters(), b[0].parameters()),
            state=all(same(tree_leaves(getattr(a[1], f)),
                           tree_leaves(getattr(b[1], f)))
                      for f in ("master", "m", "v")))
    return res

for case in __CASES__:
    t0 = time.monotonic()
    out[case] = globals()[case]()
    out[case + "_s"] = time.monotonic() - t0
print(json.dumps(out), flush=True)
os._exit(0)
"""
CASES = {"2x2": ["block_grads", "blocks", "sharded_steps", "coll_bytes"],
         "4x1": ["snapshot", "blocks", "block_grads"],
         "1x1": ["world_one"]}


def start_group(tag, tmp):
    """Start the processes of the group `tag` (a key of SHAPES); returns
    (processes, their log files)."""
    shape = SHAPES[tag]
    world = int(np.prod(list(shape.values())))
    consts = (str(tmp), tag, shape, FAMILIES, SNAPSHOT_FAMILIES, DATA_SEEDS,
              STEPS, BATCH, SEQ, Q_CHUNK)
    code = (GROUP_CODE.replace("__TIMEOUT__", str(GROUP_TIMEOUT))
            .replace("__WAIT__", str(JOIN_TIMEOUT))
            .replace("__CONSTS__", repr(consts))
            .replace("__CASES__", repr(CASES[tag])))
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


def write_inputs(tmp):
    """The extra inputs (bf16 values from a seed) of the sharded program's
    steps and of the gradient batch."""
    rng = np.random.default_rng(5)

    def bf16(shape):
        return np.asarray(jax.numpy.asarray(rng.standard_normal(shape),
                                            jax.numpy.bfloat16), np.float32)

    for name in FAMILIES:
        cfg = reduced_config(name)
        extras = {}
        if cfg.family == "audio":
            extras["frames"] = (cfg.encoder_seq, cfg.d_model)
        if cfg.family == "vlm":
            extras["img_embeds"] = (cfg.num_image_tokens, cfg.d_model)
        np.savez(tmp / f"extras_{name}.npz", **{
            k: bf16((STEPS, BATCH) + s) for k, s in extras.items()})
        np.savez(tmp / f"grad_extras_{name}.npz", **{
            k: bf16((2 * BATCH,) + s) for k, s in extras.items()})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"jax": JAX's JSON, "tmp": the directory, tag: [per-process
    JSON]}: the JAX subprocess and the three groups run side by side."""
    tmp = tmp_path_factory.mktemp("process_group_lm_families")
    write_inputs(tmp)
    env = dict(os.environ, PYTHONPATH=REPO_SRC,
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    consts = (str(tmp), FAMILIES, SNAPSHOT_FAMILIES, DATA_SEEDS, STEPS,
              BATCH, SEQ, Q_CHUNK, JOIN_TIMEOUT)
    log = open(tmp / "jax.log", "w+")
    proc = subprocess.Popen(
        [sys.executable, "-c", JAX_CODE.replace("__CONSTS__", repr(consts))],
        env=env, stdout=log, stderr=subprocess.STDOUT, text=True)
    deadline = time.monotonic() + JOIN_TIMEOUT
    groups = {tag: start_group(tag, tmp) for tag in CASES}
    out = dict(tmp=tmp)
    for tag, (procs, logs) in groups.items():
        out[tag] = join(procs, logs, deadline, tag)
    try:
        proc.wait(timeout=max(deadline - time.monotonic(), 1))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    log.seek(0)
    text = log.read()
    log.close()
    assert proc.returncode == 0, f"JAX:\n{text[-3000:]}"
    out["jax"] = json.loads(text.strip().splitlines()[-1])
    return out


def assert_routing_margins(tmp, name):
    """Every token of the sharded program's two batches, at every MoE
    layer of the init, has its k-th gate over `MIN_MARGIN` above its
    (k+1)-th: both packages, and each's layouts, route it alike."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.convert import load_lm_params_flat
    from repro_torch.data import DataConfig, SyntheticTokens
    from repro_torch.models import get_model
    cfg = reduced_config(name)
    model = get_model(cfg)(cfg, device="cpu", seed=None)
    with Checkpointer(str(tmp / f"start_{name}")).reading(0) as (flat, _):
        load_lm_params_flat(model, flat)
    src = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                                     global_batch=BATCH,
                                     seed=DATA_SEEDS[name]))
    for i in range(STEPS):
        batch = launch_train.make_batch(cfg, src.batch_at(i), "cpu")
        assert moe_margins(model, batch) > MIN_MARGIN


@pytest.mark.parametrize("name", FAMILIES)
@pytest.mark.parametrize("tag", ["2x2", "4x1"])
def test_blocks_equal_jax_addressable_shards(runs, tag, name):
    """JAX's init (its step-0 snapshot) loaded onto a process mesh: each
    rank's block of every leaf equals the shard that JAX's dry-run layout
    puts on the device of the same mesh coordinates, bit for bit, and the
    rank's weight bytes JAX's bytes on that device; some leaves are
    split. The seeded init on the blocks equals the single-device one's
    blocks."""
    want = np.load(runs["tmp"] / f"jax_{tag}_{name}.npz")
    nbytes = runs["jax"][f"bytes_{tag}_{name}"]
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


@pytest.mark.parametrize("name", FAMILIES)
def test_train_matches_jax_sharded_program(runs, name):
    """The 2x2 group resumes JAX's step-0 snapshot onto its blocks and
    takes 2 steps (the VLM's image embeddings and Whisper's frames drawn
    from a seed): the losses, each leaf's update of the gathered masters
    and the gathered parameters against JAX's `make_train_step` jitted
    with the dry run's `in_shardings` and `out_shardings` on the 2x2 mesh
    from the same init and batches (the MoE's routing batches asserted
    clear of ties)."""
    tmp = runs["tmp"]
    if name in DATA_SEEDS:
        assert_routing_margins(tmp, name)
    ref = dict(np.load(tmp / f"jax_steps_2x2_{name}.npz"))
    want = runs["jax"][f"losses_2x2_{name}"]
    losses = [o["sharded_steps"][name] for o in runs["2x2"]]
    assert all(l == losses[0] for l in losses)
    np.testing.assert_allclose(losses[0], want, rtol=TOL_LOSS)
    got = dict(rank_npz(runs, "2x2", "steps_" + name, 0))
    init, _ = JCheckpointer(str(tmp / f"start_{name}")).restore(0)
    masters = sorted(k for k in ref if k.startswith("master/"))
    assert masters and masters == sorted(k for k in got
                                         if k.startswith("master/"))
    errs = {k: update_err(got.pop(k), ref.pop(k), init["opt/" + k])
            for k in masters}
    assert_updates_close(errs)
    assert_close_trees(got, ref, TOL_PARAM, name)


@pytest.mark.parametrize("name", FAMILIES)
@pytest.mark.parametrize("tag", ["2x2", "4x1"])
def test_block_gradient_is_the_single_device_one(runs, tag, name):
    """The gradient invariant on blocks, at 1 and 2 microbatches: each
    rank's block gradients handed on once (a leaf the model ranks hold
    alike, such as MLA's latent projections and norms or the VLM's
    `vision_proj`, by model rank 0), summed into the flat ZeRO ranges by
    the optimizer's exchange and gathered, against the single-device gradient of the
    global batch, each leaf; the reported loss is the global batch's."""
    for nm in (1, 2):
        got = runs[tag][0]["block_grads"][f"{name}_{nm}"]
        worst = max(got["errs"], key=got["errs"].get)
        assert got["errs"][worst] <= TOL_GRAD, (worst, got["errs"])
        assert got["loss"] == pytest.approx(got["loss1"], rel=TOL_LOSS)


@pytest.mark.parametrize("name", FAMILIES)
def test_dryrun_rank_trace_records_the_gloo_steps_collectives(runs, name):
    """The dry run's trace of one rank's step on fake tensors
    (`launch.dryrun.trace_rank`) notes the same collectives, by kind,
    count and bytes, as the real step of that rank moved over gloo at
    2x2: Mamba-2's all-gathered in_proj output, RG-LRU's gate psums and
    the float32 row-parallel sums included."""
    for o in runs["2x2"]:
        got = o["coll_bytes"][name]
        assert got["traced"] == got["real"] and \
            got["traced_calls"] == got["real_calls"], got
        assert got["temp"] > 0


@pytest.mark.parametrize("name", FAMILIES)
def test_world_one_process_mesh_equals_local_mesh(runs, name):
    """(data 1, model 1) over a gloo world of one: two steps equal the
    local mesh's bit for bit (a 1x1 spec is whole)."""
    got = runs["1x1"][0]["world_one"][name]
    assert got == dict(losses=True, params=True, state=True)


@pytest.mark.parametrize("name", SNAPSHOT_FAMILIES)
def test_snapshot_from_2x2_resumes_at_4x1_one_device_and_jax(runs, name):
    """Reduced RecurrentGemma (stacked groups) and Whisper (encoder and
    decoder stacks) on blocks at 2x2 stopped after the step-2 snapshot
    (single-device layout, gathered leaf by leaf by rank 0): resumed to
    step 4 at 4x1 (blocks cut from it key by key), on one CPU process
    here, and by JAX's sharded program at 2x2 (`make_train_step` with
    the dry run's shardings, the snapshot restored by JAX's
    `restore_into`), each within level 2 of the 2x2 run that was never
    stopped."""
    whole = dict(rank_npz(runs, "4x1", "snap_whole_" + name, 0))
    out = runs["4x1"][0]["snapshot"][name]
    np.testing.assert_allclose(out["resumed"], out["whole"][2:],
                               rtol=TOL_LOSS)
    assert_close_trees(dict(rank_npz(runs, "4x1", "snap_4x1_" + name, 0)),
                       whole, TOL_PARAM, "4x1")
    m, state, losses = launch_train.run_training(
        reduced_config(name), device="cpu", steps=2 * STEPS,
        global_batch=BATCH, seq_len=SEQ, q_chunk=Q_CHUNK, log_every=10 ** 6,
        checkpoint_dir=str(runs["tmp"] / f"4x1_snap_{name}_1"))
    assert int(state.step) == 2 * STEPS
    np.testing.assert_allclose(losses, out["whole"][2:], rtol=TOL_LOSS)
    assert_close_trees(npflat(lm_params_to_numpy(m)), whole, TOL_PARAM,
                       "one process")
    np.testing.assert_allclose(runs["jax"]["resumed_" + name],
                               out["whole"][2:], rtol=TOL_LOSS)
    assert_close_trees(dict(np.load(runs["tmp"] / f"jax_resumed_{name}.npz")),
                       whole, TOL_PARAM, "JAX")
