"""Prefill and decode of the decoder-only transformers over a process mesh,
in the JAX package's dry-run serving layout: each rank of
`launch.mesh.make_process_mesh` keeps its blocks of the weights
(`sharding.layout`) and its block of the KV cache, its rows over the data
axes and its block of the sequence over `model` (`cache_seq`: the
flash-decoding split, every KV head whole), against JAX's dry-run
programs on a mesh of 4 forced host devices and against the port's own
single-device model.

The port's side runs in gloo groups spawned beside one JAX subprocess
(`devices=4`): 4 processes at (data 2, model 2), 4 at (data 4, model 1)
(which also form a (1, 4) mesh for reduced InternVL2, whose 2 KV heads
are fewer than `model`), and 1 at (1, 1), each a `FileStore` in the
test's temporary directory, one torch thread a process, every process
killed past `JOIN_TIMEOUT`. Both packages serve reduced Qwen2-7B,
H2O-Danube3 (sliding window 16), DeepSeek-V2 (MLA and the MoE) and
InternVL2 (the image prefix) from JAX's init, carried over by
`convert.load_lm_params_flat`: a prefill padded to `MAX_SEQ` (the ring's
16 slots for H2O-Danube3), every row's position then moved back by
`IDX_OFFSET` (rows advance independently, so two rows of one rank write
on different `model` ranks in one step), then `STEPS` greedy decode
steps. JAX runs its dry run's programs with the rules'
`tree_shardings` as `in_shardings`: prefill (`pad_cache_to`), its cache
laid out by `cache_sh`, and decode with `cache_sh` in and out and
`donate_argnums=(1,)`.

Parity: each rank's cache block shapes, which positions hold a value and
`idx` equal to JAX's `addressable_shards` of the device at the same mesh
coordinates (level 1); the cache values and the logits within
`TOL_LOGITS` of JAX's largest (level 2, tests/test_torch_lm_serve.py's
bound: bf16 products round in other places, and the softmax is combined
over `model` in float32 by log-sum-exp where one device rounds the
probabilities to bf16); the greedy tokens equal (DeepSeek-V2's routing
margins over `MIN_MARGIN`); world 1 bit-equal to the single-device model;
the dry run's rank trace of prefill and of a decode step noting the
collectives that a gloo rank moved.
"""
import json
import os
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from conftest import REPO_SRC
from repro.configs import reduced_config as jax_reduced_config
from repro.models import get_model as jax_get_model
from repro.models.moe import capacity_for as jax_capacity_for
from repro_torch.configs import reduced_config
from repro_torch.convert import load_lm_params_flat
from repro_torch.launch.mesh import make_rank_mesh
from repro_torch.models import get_model
from repro_torch.models import transformer as ttransformer
from repro_torch.models.moe import capacity_for
from repro_torch.sharding.layout import cut_blocks
from test_torch_lm_train import MIN_MARGIN
from test_torch_process_group_lm import (  # noqa: F401 (autouse fixture)
    join, one_torch_thread)

ARCHS = ("qwen2-7b", "h2o-danube-3-4b", "deepseek-v2-236b", "internvl2-1b")
SHAPES = {"2x2": {"data": 2, "model": 2}, "4x1": {"data": 4, "model": 1},
          "1x4": {"data": 1, "model": 4}, "1x1": {"data": 1, "model": 1}}
# the meshes each group of processes forms, and the configs each serves
GROUPS = {"2x2": ("2x2",), "4x1": ("4x1", "1x4"), "1x1": ("1x1",)}
MESH_ARCHS = {"2x2": ARCHS, "4x1": ARCHS, "1x4": ("internvl2-1b",),
              "1x1": ARCHS}
SHARDED = ("2x2", "4x1", "1x4")
B, MAX_SEQ, STEPS, Q_CHUNK = 4, 32, 8, 4
# prompt tokens (InternVL2's 8 image positions come first): 14 positions
# of 32, so decoding crosses from model rank 0's block into rank 1's;
# H2O-Danube3's 12 of its 16-slot ring, so decoding wraps from rank 1's
# slots 8-15 to rank 0's 0-7
PROMPT = {"qwen2-7b": 14, "h2o-danube-3-4b": 12, "deepseek-v2-236b": 14,
          "internvl2-1b": 6}
IDX_OFFSET = (0, -4, 0, -4)
# each config's prompt seed (0 otherwise): reduced DeepSeek-V2's seed-0
# prompts and greedy tokens hold a token whose k-th and (k+1)-th gates
# are 8e-4 apart; seed 6's smallest gap is over MIN_MARGIN
DATA_SEEDS = {"deepseek-v2-236b": 6}
TOL_LOGITS = 0.03
GROUP_TIMEOUT = 60       # seconds, on a group's collectives
JOIN_TIMEOUT = 240       # seconds, for a whole group to finish

# The JAX side: each sharded mesh's prefill and decode programs, each
# device's shards of the cache after prefill and after the last step
JAX_CODE = """
import json
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.configs import reduced_config
from repro.models import get_model
from repro.sharding import ShardingRules, default_rules
from repro.sharding.rules import active_rules
TMP, MESH_ARCHS, SHAPES, SHARDED, B, MAX_SEQ, STEPS, Q_CHUNK, IDX_OFFSET = \\
    __CONSTS__
devs = jax.devices()[:4]
key_of = lambda path: "/".join(str(getattr(k, "key", k)) for k in path)
flat = lambda tree: jax.tree_util.tree_flatten_with_path(tree)[0]

def host(x):
    return np.asarray(x if x.dtype == jnp.int32 else x.astype(jnp.float32))

def shards(tree, pre):
    res = {}
    for path, leaf in flat(tree):
        res[pre + "whole/" + key_of(path)] = host(leaf)
        for sh in leaf.addressable_shards:
            res["%s%d/%s" % (pre, devs.index(sh.device),
                             key_of(path))] = host(sh.data)
    return res

def serve(tag, arch):
    cfg, box = reduced_config(arch), {}
    model = get_model(cfg)
    def init(k):
        p, box["axes"] = model.init_params(cfg, k)
        return p
    params = jax.jit(init)(jax.random.PRNGKey(0))
    z = np.load(TMP + "/params_" + arch + ".npz")
    assert all(np.array_equal(host(v), z[key_of(p)]) for p, v in flat(params))
    d = np.load(TMP + "/inputs_" + arch + ".npz")
    tokens = jnp.asarray(d["tokens"])
    extra = ({"img_embeds": jnp.asarray(d["img_embeds"], jnp.bfloat16)}
             if "img_embeds" in d.files else {})
    mesh = Mesh(np.array(devs).reshape(tuple(SHAPES[tag].values())),
                ("data", "model"))
    rules = ShardingRules(mesh, default_rules(False))
    psh = rules.tree_shardings(params, box["axes"])
    tok_sh = rules.sharding(("batch", None), tokens.shape)
    one_sh = rules.sharding(("batch", None), (B, 1))
    ex_sh = {k: rules.sharding(("batch", None, None), v.shape)
             for k, v in extra.items()}
    cache_axes = model.init_cache(cfg, B, MAX_SEQ)[1]
    res = {}
    with active_rules(rules):
        pre = jax.jit(lambda p, t, ex: model.prefill(
            p, t, cfg, q_chunk=Q_CHUNK, pad_cache_to=MAX_SEQ, **ex),
            in_shardings=(psh, tok_sh, ex_sh))
        logits, cache = pre(params, tokens, extra)
        cache_sh = rules.tree_shardings(cache, cache_axes)
        cache = jax.device_put(cache, cache_sh)
        res.update(shards(cache, "pre"))
        res["pre_logits"] = host(logits)
        off = jnp.asarray(IDX_OFFSET, jnp.int32)[None, :]
        cache = jax.device_put({k: dict(c, idx=c["idx"] + off)
                                for k, c in cache.items()}, cache_sh)
        dec = jax.jit(lambda p, c, t: model.decode_step(p, c, t, cfg),
                      in_shardings=(psh, cache_sh, one_sh),
                      out_shardings=(None, cache_sh), donate_argnums=(1,))
        own = [host(jnp.argmax(logits, -1))]
        for i in range(STEPS):
            tok = jnp.asarray(d["feed"][i])[:, None]
            logits, cache = dec(params, cache, tok)
            res["logits%d" % i] = host(logits)
            own.append(host(jnp.argmax(logits, -1)))
        res.update(shards(cache, "dec"))
    res["argmax"] = np.concatenate(own, axis=1).T
    np.savez(TMP + "/jax_%s_%s.npz" % (tag, arch), **res)

for tag in SHARDED:
    for arch in MESH_ARCHS[tag]:
        serve(tag, arch)
print(json.dumps({}))
"""

GROUP_CODE = """
import datetime, json, os
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
RANK, WORLD = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
dist.init_process_group(
    "gloo", store=dist.FileStore(os.environ["PG_STORE"], WORLD), rank=RANK,
    world_size=WORLD, timeout=datetime.timedelta(seconds=__TIMEOUT__))
from repro_torch.configs import reduced_config
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.convert import load_lm_params_flat
from repro_torch.launch.dryrun import trace_rank
from repro_torch.launch.mesh import make_process_mesh
from repro_torch.models import get_model
from repro_torch.models.moe import capacity_for
from repro_torch.sharding.collectives import CollectiveLog
from repro_torch.sharding.layout import serve_rows, whole_blocks
TMP, GROUP, TAGS, SHAPES, MESH_ARCHS, B, MAX_SEQ, STEPS, Q_CHUNK, \\
    IDX_OFFSET = __CONSTS__

def flat(tree, pre):
    # copies: decode writes the cache in place
    return {pre + k + "/" + n: t.float().numpy() if t.is_floating_point()
            else t.clone().numpy() for k, c in tree.items()
            for n, t in c.items()}

def build(arch, mesh):
    cfg = reduced_config(arch)
    m = get_model(cfg)(cfg, device="cpu", seed=None, mesh=mesh)
    load_lm_params_flat(m, np.load(f"{TMP}/params_{arch}.npz"), prefix="")
    return m

def inputs(arch, rows):
    d = np.load(f"{TMP}/inputs_{arch}.npz")
    extra = ({"img_embeds": torch.tensor(d["img_embeds"]).to(
        torch.bfloat16)[rows]} if "img_embeds" in d.files else {})
    return (torch.tensor(d["tokens"]).long()[rows], extra,
            torch.tensor(d["feed"]).long()[:, rows])

def serve(m, tokens, extra, feed, rows):
    # prefill padded to MAX_SEQ, the rows' positions moved back by
    # IDX_OFFSET, then STEPS steps fed the teacher's greedy tokens: the
    # arrays (each step's own argmax too), the cache, the collectives of
    # the first step
    logits, cache = m.prefill(tokens, q_chunk=Q_CHUNK, pad_cache_to=MAX_SEQ,
                              **extra)
    arrays = dict(flat(cache, "pre/"), pre_logits=logits.numpy())
    with torch.inference_mode():
        for c in cache.values():
            c["idx"] += torch.tensor(IDX_OFFSET, dtype=torch.int32)[rows]
    own, first = [logits.argmax(-1)], None
    for i in range(STEPS):
        with CollectiveLog() as log:
            logits, cache = m.decode_step(cache, feed[i][:, None])
        first = first or log
        arrays[f"logits{i}"] = logits.numpy()
        own.append(logits.argmax(-1))
    arrays["argmax"] = torch.cat(own, dim=1).T.numpy()
    arrays.update(flat(cache, "dec/"))
    return arrays, cache, first

def dropped(m):
    return int(sum(int(b.moe.dropped) for b in m.moe_layers))

def sharded(tag, mesh):
    res = {}
    rows = serve_rows(B, mesh)
    for arch in MESH_ARCHS[tag]:
        m = build(arch, mesh)
        tokens, extra, feed = inputs(arch, rows)
        arrays, cache, dec_log = serve(m, tokens, extra, feed, rows)
        whole = whole_blocks(cache, m.cache_axes(B, MAX_SEQ),
                             m.cache_shapes(B, MAX_SEQ), mesh)
        if mesh.writer:
            arrays.update(flat(whole, "decwhole/"))
        np.savez(f"{TMP}/{tag}_{arch}_r{RANK}.npz", **arrays)
        T = tokens.shape[1] + (m.cfg.num_image_tokens if extra else 0)
        r = dict(dropped=dropped(m), tokens=T, rows=tokens.shape[0],
                 dec=dec_log.bytes, dec_calls=dec_log.calls)
        if tag == "2x2":
            # prefill unpadded (its cache of T positions splits over
            # model) and a decode step against the dry run's rank traces
            with CollectiveLog() as log:
                m.prefill(tokens, q_chunk=Q_CHUNK, **extra)
            traced = {kind: trace_rank(
                m.cfg, ShapeConfig("s", n, B, kind), SHAPES[tag], RANK,
                device="cpu", q_chunk=Q_CHUNK)
                for kind, n in (("prefill", T), ("decode", MAX_SEQ))}
            r.update(pre=log.bytes, pre_calls=log.calls,
                     traced={k: dict(bytes=t["coll_by_kind"],
                                     calls=t["coll_calls"],
                                     temp=t["temp_bytes"])
                             for k, t in traced.items()})
        res[arch] = r
    return res

def world_one(tag, mesh):
    # the 1x1 process mesh against the single-device model, bit for bit
    res = {}
    rows = serve_rows(B, mesh)
    for arch in MESH_ARCHS[tag]:
        tokens, extra, feed = inputs(arch, rows)
        a = serve(build(arch, mesh), tokens, extra, feed, rows)[0]
        b = serve(build(arch, None), tokens, extra, feed, rows)[0]
        res[arch] = sorted(k for k in b if not np.array_equal(a[k], b[k]))
    return res

out = dict(rank=RANK)
for tag in TAGS:
    mesh = make_process_mesh(SHAPES[tag], "cpu")
    out["coords_" + tag] = mesh.coords
    out[tag] = (world_one if tag == "1x1" else sharded)(tag, mesh)
print(json.dumps(out), flush=True)
os._exit(0)
"""


def start_group(group, tmp):
    """Start the processes of the group `group` (a key of GROUPS);
    returns (processes, their log files)."""
    shape = SHAPES[group]
    world = int(np.prod(list(shape.values())))
    consts = (str(tmp), group, GROUPS[group], SHAPES, MESH_ARCHS, B, MAX_SEQ,
              STEPS, Q_CHUNK, IDX_OFFSET)
    code = (GROUP_CODE.replace("__TIMEOUT__", str(GROUP_TIMEOUT))
            .replace("__CONSTS__", repr(consts)))
    env = dict(os.environ, PYTHONPATH=REPO_SRC, WORLD_SIZE=str(world),
               PG_STORE=str(tmp / f"store_{group}"), OMP_NUM_THREADS="1")
    procs, logs = [], []
    for rank in range(world):
        log = open(tmp / f"rank_{group}_{rank}.log", "w+")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code], env=dict(env, RANK=str(rank)),
            stdout=log, stderr=subprocess.STDOUT, text=True))
    return procs, logs


def key_of(path):
    return "/".join(str(getattr(k, "key", k)) for k in path)


def write_inputs(tmp):
    """JAX's init of each config (jitted; float32 leaves by '/'-joined
    path), the prompts (tokens from a numpy seed of `DATA_SEEDS`,
    InternVL2's image embeddings bf16 values) and the tokens every run is
    fed: the greedy tokens of the port's single-device model on JAX's
    weights (`teach`).
    Returns DeepSeek-V2's smallest routing margin there."""
    margins = {}
    for arch in ARCHS:
        rng = np.random.default_rng(DATA_SEEDS.get(arch, 0))
        cfg = jax_reduced_config(arch)
        model = jax_get_model(cfg)
        params = jax.jit(lambda k: model.init_params(cfg, k)[0])(
            jax.random.PRNGKey(0))
        np.savez(tmp / f"params_{arch}.npz", **{
            key_of(path): np.asarray(v, np.float32) for path, v in
            jax.tree_util.tree_flatten_with_path(params)[0]})
        arrays = dict(tokens=rng.integers(0, cfg.vocab_size,
                                          (B, PROMPT[arch])).astype(np.int32))
        if cfg.num_image_tokens:
            arrays["img_embeds"] = np.asarray(jax.numpy.asarray(
                rng.standard_normal((B, cfg.num_image_tokens, cfg.d_model)),
                jax.numpy.bfloat16), np.float32)
        arrays["feed"], margins[arch] = teach(tmp, arch, arrays)
        np.savez(tmp / f"inputs_{arch}.npz", **arrays)
    return margins


def teach(tmp, arch, arrays):
    """(the greedy tokens [STEPS, B] of the single-device port on JAX's
    weights, prefilled and moved back by IDX_OFFSET as the runs are; the
    smallest gap between the k-th and (k+1)-th gate of any token at any
    MoE layer on the way, inf without MoE)."""
    cfg = reduced_config(arch)
    model = get_model(cfg)(cfg, device="cpu", seed=None)
    load_lm_params_flat(model, np.load(tmp / f"params_{arch}.npz"),
                        prefix="")
    margins = [np.inf]
    orig = ttransformer.moe_forward

    def hook(p, x, cfg):
        xf = x.float().reshape(-1, x.shape[-1])
        g = torch.sort(torch.softmax(xf @ p.router, -1), -1).values
        k = cfg.num_experts_per_tok
        margins.append(float((g[:, -k] - g[:, -k - 1]).min()))
        return orig(p, x, cfg)

    extra = ({"img_embeds": torch.tensor(arrays["img_embeds"]).to(
        torch.bfloat16)} if "img_embeds" in arrays else {})
    ttransformer.moe_forward = hook
    try:
        logits, cache = model.prefill(torch.tensor(arrays["tokens"]).long(),
                                      q_chunk=Q_CHUNK, pad_cache_to=MAX_SEQ,
                                      **extra)
        with torch.inference_mode():
            for c in cache.values():
                c["idx"] += torch.tensor(IDX_OFFSET, dtype=torch.int32)
        feed = []
        for _ in range(STEPS):
            feed.append(logits.argmax(-1))
            logits, cache = model.decode_step(cache, feed[-1])
    finally:
        ttransformer.moe_forward = orig
    return torch.cat(feed, dim=1).T.numpy().astype(np.int32), min(margins)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"tmp": the directory, group: [per-process JSON]}: the JAX
    subprocess and the three groups run side by side."""
    tmp = tmp_path_factory.mktemp("process_group_lm_serve")
    margins = write_inputs(tmp)
    env = dict(os.environ, PYTHONPATH=REPO_SRC,
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    consts = (str(tmp), MESH_ARCHS, SHAPES, SHARDED, B, MAX_SEQ, STEPS,
              Q_CHUNK, IDX_OFFSET)
    log = open(tmp / "jax.log", "w+")
    proc = subprocess.Popen(
        [sys.executable, "-c", JAX_CODE.replace("__CONSTS__", repr(consts))],
        env=env, stdout=log, stderr=subprocess.STDOUT, text=True)
    deadline = time.monotonic() + JOIN_TIMEOUT
    groups = {g: start_group(g, tmp) for g in GROUPS}
    out = dict(tmp=tmp, margins=margins)
    for g, (procs, logs) in groups.items():
        out[g] = join(procs, logs, deadline, g)
    try:
        proc.wait(timeout=max(deadline - time.monotonic(), 1))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    log.seek(0)
    text = log.read()
    log.close()
    assert proc.returncode == 0, f"JAX:\n{text[-3000:]}"
    return out


def group_of(tag):
    return next(g for g, tags in GROUPS.items() if tag in tags)


def ranks(runs, tag):
    """(rank, its coordinates) of each process of the mesh `tag`: JAX's
    device d sits at the coordinates of rank d."""
    for o in runs[group_of(tag)]:
        yield o["rank"], o["coords_" + tag]


def rel_err(ref, got) -> float:
    """max |ref - got| over the largest |ref|."""
    assert ref.shape == got.shape, (ref.shape, got.shape)
    return float(np.abs(ref - got).max() / (np.abs(ref).max() + 1e-12))


def filled(a):
    """Which slots of a cache leaf [L, B, S, ...] hold a value."""
    return (a != 0).any(axis=tuple(range(3, a.ndim)))


CASES = [(tag, arch) for tag in SHARDED for arch in MESH_ARCHS[tag]]


@pytest.mark.parametrize("tag,arch", CASES)
def test_cache_blocks_match_jax_addressable_shards(runs, tag, arch):
    """After prefill (padded to decode capacity, the ring rolled) and
    after the last decode step: each rank's block of every cache leaf has
    the shape of JAX's shard on the device of the same mesh coordinates
    (its rows, its block of the sequence, every KV head), the same idx
    and the same filled slots (level 1), and values within TOL_LOGITS of
    the whole leaf's largest."""
    jx = np.load(runs["tmp"] / f"jax_{tag}_{arch}.npz")
    for r, _ in ranks(runs, tag):
        got = np.load(runs["tmp"] / f"{tag}_{arch}_r{r}.npz")
        for stage in ("pre", "dec"):
            paths = sorted(k[len(f"{stage}{r}/"):] for k in jx.files
                           if k.startswith(f"{stage}{r}/"))
            assert paths == sorted(k[len(stage) + 1:] for k in got.files
                                   if k.startswith(stage + "/"))
            for p in paths:
                ref, mine = jx[f"{stage}{r}/{p}"], got[f"{stage}/{p}"]
                where = (tag, arch, r, stage, p)
                assert ref.shape == mine.shape, where
                if p.endswith("idx"):
                    assert mine.dtype == np.int32, where
                    assert np.array_equal(ref, mine), where
                    continue
                assert np.array_equal(filled(ref), filled(mine)), where
                scale = np.abs(jx[f"{stage}whole/{p}"]).max()
                assert np.abs(ref - mine).max() <= TOL_LOGITS * scale, where


@pytest.mark.parametrize("tag,arch", CASES)
def test_logits_and_greedy_tokens_match_jax(runs, tag, arch):
    """Each rank's rows, both packages fed the same greedy tokens: the
    prefill's last-position logits and those of every decode step (whole
    vocabulary, gathered from the vocab-parallel head) within TOL_LOGITS
    of JAX's, and each step's own greedy token JAX's, or, where bf16
    logits tie or nearly tie, JAX's token's logit within TOL_LOGITS of
    the port's top (tests/test_torch_lm_serve.py's rule). DeepSeek-V2's
    routing margins clear MIN_MARGIN, so both route every token alike."""
    if arch == "deepseek-v2-236b":
        assert runs["margins"][arch] > MIN_MARGIN
    jx = np.load(runs["tmp"] / f"jax_{tag}_{arch}.npz")
    keys = ["pre_logits"] + [f"logits{i}" for i in range(STEPS)]
    for r, coords in ranks(runs, tag):
        got = np.load(runs["tmp"] / f"{tag}_{arch}_r{r}.npz")
        rows = rows_of(tag, coords)
        want = jx["argmax"][:, rows]
        for i, k in enumerate(keys):
            assert got[k].shape == jx[k][rows].shape
            assert rel_err(jx[k][rows], got[k]) <= TOL_LOGITS, (r, k)
            for b, (own, tok) in enumerate(zip(got["argmax"][i], want[i])):
                row = got[k][b, -1]
                gap = (row.max() - row[tok]) / np.abs(row).max()
                assert own == tok or gap <= TOL_LOGITS, (r, k, b, own, tok)


def rows_of(tag, coords):
    dp = SHAPES[tag]["data"]
    n = B // dp
    return slice(coords["data"] * n, (coords["data"] + 1) * n)


@pytest.mark.parametrize("tag,arch", CASES)
def test_cut_and_whole_blocks_round_trip_jax_layout(runs, tag, arch):
    """`layout.cut_blocks` of JAX's whole prefill cache gives, for each
    rank of the mesh (`make_rank_mesh`), JAX's shards of that device bit
    for bit; `layout.whole_blocks` gathers the ranks' decoded blocks into
    the single-device layout, within TOL_LOGITS of JAX's whole cache."""
    jx = np.load(runs["tmp"] / f"jax_{tag}_{arch}.npz")
    cfg = reduced_config(arch)
    model = get_model(cfg)(cfg, device="meta", seed=None)
    axes = model.cache_axes(B, MAX_SEQ)
    whole = {k: {n: torch.tensor(jx[f"prewhole/{k}/{n}"]) for n in c}
             for k, c in axes.items()}
    for r in range(int(np.prod(list(SHAPES[tag].values())))):
        blocks = cut_blocks(whole, axes, make_rank_mesh(SHAPES[tag], r,
                                                        "cpu"))
        for k, c in blocks.items():
            for n, t in c.items():
                assert np.array_equal(t.numpy(), jx[f"pre{r}/{k}/{n}"]), \
                    (r, k, n)
    got = np.load(runs["tmp"] / f"{tag}_{arch}_r0.npz")
    for k, c in axes.items():
        for n in c:
            ref, mine = jx[f"decwhole/{k}/{n}"], got[f"decwhole/{k}/{n}"]
            if n == "idx":
                assert np.array_equal(ref, mine)
            else:
                assert np.array_equal(filled(ref), filled(mine))
                assert rel_err(ref, mine) <= TOL_LOGITS, (k, n)


@pytest.mark.parametrize("arch", ARCHS)
def test_world_one_process_mesh_equals_single_device(runs, arch):
    """(data 1, model 1) over a gloo world of one: prefill, the caches
    and every decode step's logits and tokens equal the single-device
    model's bit for bit."""
    assert runs["1x1"][0]["1x1"][arch] == []


def test_sliding_window_ring_wraps_across_model_ranks(runs):
    """H2O-Danube3 at 2x2: the 16-slot ring is 8 slots a model rank; row
    0 decodes positions 12-19, writing slots 12-15 on model rank 1 and
    then 0-3 on model rank 0, and row 1 (moved back to position 8) slots
    8-15 on rank 1: each model rank's written slots equal JAX's."""
    arch, tag = "h2o-danube-3-4b", "2x2"
    jx = np.load(runs["tmp"] / f"jax_{tag}_{arch}.npz")
    seen = {}
    for r, coords in ranks(runs, tag):
        got = np.load(runs["tmp"] / f"{tag}_{arch}_r{r}.npz")
        assert got["dec/dense/k"].shape[2] == 8
        written = (got["dec/dense/k"] != got["pre/dense/k"]).any(
            axis=(0, 3, 4))                               # [B_loc, 8]
        want = (jx[f"dec{r}/dense/k"] != jx[f"pre{r}/dense/k"]).any(
            axis=(0, 3, 4))
        assert np.array_equal(written, want), r
        seen[coords["model"]] = written[0]
        assert (got["dec/dense/idx"][:, 0] == 20).all()
    assert seen[0][:4].all() and not seen[0][4:].any()
    assert seen[1][4:].all() and not seen[1][:4].any()


@pytest.mark.parametrize("arch", ARCHS)
def test_rank_trace_collectives_equal_gloo(runs, arch):
    """The dry run's trace of each 2x2 rank's prefill (unpadded) and of
    one decode step on fake tensors (`launch.dryrun.trace_rank`) notes
    the collectives that rank moved over gloo, by kind, bytes and count:
    the FSDP gathers, the re-layout's all_to_all, the gathered queries
    and new keys, the softmax's max and sums, the row-parallel sums and
    the gathered logits."""
    for o in runs["2x2"]:
        got = o["2x2"][arch]
        tr = got["traced"]
        assert tr["prefill"]["bytes"] == got["pre"], (o["rank"], got)
        assert tr["prefill"]["calls"] == got["pre_calls"]
        assert tr["decode"]["bytes"] == got["dec"], (o["rank"], got)
        assert tr["decode"]["calls"] == got["dec_calls"]
        assert tr["prefill"]["temp"] > 0 and tr["decode"]["temp"] > 0
    kinds = runs["2x2"][0]["2x2"][arch]["pre_calls"]
    if arch != "deepseek-v2-236b":     # MLA's latent is whole on each rank
        assert kinds.get("all_to_all", 0) > 0, kinds


@pytest.mark.parametrize("tag", ["2x2", "4x1"])
def test_moe_capacity_and_drops_match_jax(runs, tag):
    """DeepSeek-V2's MoE on a process mesh routes each data rank's own
    tokens (its rows: T of them at prefill, one at decode), its capacity
    JAX's `capacity_for` at the same count, as JAX's data-local program
    sets it; at capacity factor 4 nothing is dropped on any rank."""
    arch = "deepseek-v2-236b"
    jcfg, cfg = jax_reduced_config(arch), reduced_config(arch)
    for o in runs[group_of(tag)]:
        got = o[tag][arch]
        assert got["rows"] == B // SHAPES[tag]["data"]
        for n in (got["rows"] * got["tokens"], got["rows"]):
            assert capacity_for(cfg, n) == jax_capacity_for(jcfg, n)
        assert got["dropped"] == 0
