"""The port's sharded MoE (`models.moe.moe_forward_sharded`) on the CPU.

- On the 1x1 mesh the sharded path equals the gather path bit for bit,
  and `aux` within 1e-5 (as tests/test_moe.py:21), for reduced DBRX
  (gated experts) and reduced DeepSeek-V2 (shared experts).
- On a stacked {"data": 2, "model": 2} mesh, against the JAX package's
  `shard_map` version on a 2x2 mesh of 4 forced host devices (one
  subprocess for the file), both configs at capacity factor 1.0 so that
  some assignments drop: each data shard's capacity and drops bit-exact
  (level 1); `out` within `TOL_LAYER` of the largest magnitude (level 2:
  the expert matmuls are bf16 and round in other places in XLA's CPU dots
  than in torch's, as tests/test_torch_lm_layers.py's MoE cases); `aux`
  within 1e-5 relative. The batch's top-k gate margins are asserted
  above `MARGIN`, so that both packages route every token alike.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import run_forced_devices
from repro.configs import reduced_config as jax_reduced_config
from repro.models import moe as jmoe
from repro_torch.configs import reduced_config
from repro_torch.launch.mesh import make_local_mesh, make_stacked_mesh
from repro_torch.models import moe as tmoe
from repro_torch.sharding import ShardingRules, active_rules, default_rules

ARCHS = ("dbrx-132b", "deepseek-v2-236b")
TOL_LAYER = 2e-2
MARGIN = 1e-3
B, T = 4, 12
MESH = {"data": 2, "model": 2}
SEEDS_2X2 = {"dbrx-132b": 2, "deepseek-v2-236b": 3}   # drops in a shard


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def bf16(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def draw(name, seed):
    """numpy weights (bf16 values; the router float32) in the JAX tree of
    `init_moe`, and a batch x [B, T, d], for `name` at capacity 1.0."""
    jcfg = dataclasses.replace(jax_reduced_config(name), capacity_factor=1.0)
    jp, _ = jmoe.init_moe(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(seed)

    def leaf(x):
        fan_in = x.shape[-2]
        a = rng.standard_normal(x.shape) / np.sqrt(fan_in)
        return bf16(a) if x.dtype == jnp.bfloat16 else a.astype(np.float32)
    p = jax.tree_util.tree_map(leaf, jp)
    x = bf16(rng.standard_normal((B, T, jcfg.d_model)))
    return p, x


def flat(p, prefix=""):
    out = {}
    for k, v in p.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def port_moe(name, p):
    cfg = dataclasses.replace(reduced_config(name), capacity_factor=1.0)
    mod = tmoe.MoE(cfg, device="cpu", gen=None)
    with torch.no_grad():
        for k, v in flat(p).items():
            mod.get_parameter(k).copy_(torch.tensor(v))
    return cfg, mod


def shard_drops(cfg, mod, x):
    """(capacity, drops) of each data shard, by the port's dispatch."""
    out = []
    for xl in x.reshape(MESH["data"], -1, cfg.d_model):
        _, _, _, d = tmoe._dispatch_compute_combine(
            xl, torch.matmul(xl.float(), mod.router), mod.w_gate, mod.w_up,
            mod.w_down, cfg)
        out.append(int(d))
    return tmoe.capacity_for(cfg, B * T // MESH["data"]), out


def assert_margins(cfg, p, x):
    """Each token's k-th gate above its (k+1)-th by MARGIN."""
    logits = x.reshape(-1, cfg.d_model).astype(np.float64) @ p["router"]
    g = np.exp(logits - logits.max(-1, keepdims=True))
    g = np.sort(g / g.sum(-1, keepdims=True), axis=-1)[:, ::-1]
    k = cfg.num_experts_per_tok
    assert (g[:, k - 1] - g[:, k]).min() > MARGIN


@pytest.mark.parametrize("name", ARCHS)
def test_sharded_1x1_equals_gather(name):
    p, x = draw(name, seed=1)
    cfg, mod = port_moe(name, p)
    xt = torch.tensor(x).to(torch.bfloat16)
    out_g, aux_g = tmoe.moe_forward(mod, xt, cfg)
    dropped_g = int(mod.dropped)
    rules = ShardingRules(make_local_mesh("cpu"), default_rules(False))
    with active_rules(rules):
        out_s, aux_s = tmoe.moe_forward(mod, xt, cfg)
    assert torch.equal(out_g, out_s)
    assert abs(float(aux_g) - float(aux_s)) < 1e-5
    assert int(mod.dropped) == 2 * dropped_g > 0


JAX_CODE = """
import dataclasses, json, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import reduced_config
from repro.models import moe
from repro.sharding import ShardingRules, default_rules
out = {}
for name in %(archs)r:
    cfg = dataclasses.replace(reduced_config(name), capacity_factor=1.0)
    jp, _ = moe.init_moe(jax.random.PRNGKey(0), cfg)
    z = np.load(%(path)r + name + ".npz")
    def put(path, like):
        key = "p." + ".".join(str(getattr(k, "key", k)) for k in path)
        return jnp.asarray(z[key], like.dtype)
    p = jax.tree_util.tree_map_with_path(put, jp)
    x = jnp.asarray(z["x"], jnp.bfloat16)
    mesh = jax.make_mesh((2, 2), ("data", "model"))
    rules = ShardingRules(mesh, default_rules(False))
    y, aux = jax.jit(lambda p, x: moe.moe_forward_sharded(p, x, cfg,
                                                          rules))(p, x)
    drops = []
    for xl in np.split(np.asarray(z["x"]), 2, axis=0):
        xf = jnp.asarray(xl, jnp.bfloat16).reshape(-1, cfg.d_model)
        logits = jnp.einsum("nd,de->ne", xf.astype(jnp.float32), p["router"])
        _, e = jax.lax.top_k(jax.nn.softmax(logits, axis=-1),
                             cfg.num_experts_per_tok)
        rank = moe._rank_within(e.reshape(-1).astype(jnp.int32))
        cap = moe.capacity_for(cfg, xf.shape[0])
        drops.append(int(jnp.sum(rank >= cap)))
    np.save(%(path)r + name + "_out.npy",
            np.asarray(y.astype(jnp.float32)))
    out[name] = dict(aux=float(aux), drops=drops, capacity=cap)
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_2x2(tmp_path_factory):
    """JAX's sharded MoE on a 2x2 mesh of 4 forced host devices, for both
    configs, in one subprocess: (inputs, outputs) by arch."""
    d = tmp_path_factory.mktemp("moe2x2")
    inputs = {}
    for name in ARCHS:
        p, x = draw(name, seed=SEEDS_2X2[name])
        inputs[name] = (p, x)
        np.savez(d / f"{name}.npz", x=x,
                 **{"p." + k: v for k, v in flat(p).items()})
    res = run_forced_devices(JAX_CODE % dict(archs=ARCHS, path=f"{d}/"),
                             devices=4, timeout=600)
    for name in ARCHS:
        res[name]["out"] = np.load(d / f"{name}_out.npy")
    return inputs, res


@pytest.mark.parametrize("name", ARCHS)
def test_stacked_2x2_matches_jax_shard_map(name, jax_2x2):
    inputs, res = jax_2x2
    p, x = inputs[name]
    ref = res[name]
    cfg, mod = port_moe(name, p)
    assert_margins(cfg, p, x)
    xt = torch.tensor(x).to(torch.bfloat16)

    cap, drops = shard_drops(cfg, mod, xt)
    assert cap == ref["capacity"]
    assert drops == ref["drops"] and sum(drops) > 0

    rules = ShardingRules(make_stacked_mesh(MESH, "cpu"),
                          default_rules(False))
    mod.dropped.zero_()
    with active_rules(rules):
        out, aux = tmoe.moe_forward(mod, xt, cfg)
    assert int(mod.dropped) == sum(ref["drops"])
    err = np.abs(out.float().numpy() - ref["out"]).max()
    assert err <= TOL_LAYER * np.abs(ref["out"]).max()
    assert abs(float(aux) - ref["aux"]) <= 1e-5 * abs(ref["aux"])


def test_sharded_refuses_what_it_cannot_run():
    """A mesh of several cards needs collectives the port does not have;
    an expert hidden dim that does not split over `model` would sum tp
    whole outputs (the reference's shard_map does)."""
    from repro_torch.launch.mesh import Mesh
    p, x = draw("dbrx-132b", seed=1)
    cfg, mod = port_moe("dbrx-132b", p)
    xt = torch.tensor(x).to(torch.bfloat16)
    cards = Mesh(dict(MESH), (torch.device("cpu"),) * 4)
    with pytest.raises(NotImplementedError, match="NCCL"):
        tmoe.moe_forward_sharded(mod, xt, cfg,
                                 ShardingRules(cards, default_rules(False)))
    odd = ShardingRules(make_stacked_mesh({"data": 1, "model": 3}, "cpu"),
                        default_rules(False))
    with pytest.raises(ValueError, match="does not split"):
        tmoe.moe_forward_sharded(mod, xt, cfg, odd)
