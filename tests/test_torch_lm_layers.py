"""The port's LM layers against the JAX package's, on the CPU.

Each case draws its inputs and weights with numpy from a seed, rounds them
to bf16 and hands the same values to `repro.models.*` and
`repro_torch.models.*`.

Parity levels (ROADMAP): bit-exact (level 1) for every integer path: MoE
ranks, capacities, chosen experts, buffer drops, the cache's idx and the
roll/pad of `pad_stacked_cache`. Tolerance (level 2) for float outputs:
`TOL_F32` absolute for the float32 RoPE tables and gate weights
(measured at most 2.4e-7); relative to the largest magnitude of the JAX
output, `TOL_BF16` for a bf16 result of float32 math (one bf16 rounding
apart) and `TOL_LAYER` for the outputs of a layer of bf16 matmuls, where
XLA's CPU dots and torch's round in different places (measured at most
0.008).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced_config
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import mlp as jmlp
from repro.models import moe as jmoe
from repro_torch.configs import reduced_config
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import moe as tmoe
from repro_torch.models.mlp import MLP, mlp_forward

TOL_F32 = 1e-5
TOL_BF16 = 2 ** -7
TOL_LAYER = 2e-2


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small tensor ops: under parallel test workers torch's thread
    pool oversubscribes the cores (100x slower); one thread keeps serial
    speed."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def bf16(a) -> np.ndarray:
    """float32 numpy holding bf16-representable values."""
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def to_jax(a, dtype=jnp.bfloat16):
    return jnp.asarray(a, dtype)


def to_torch(a, dtype=torch.bfloat16):
    return torch.from_numpy(np.array(a)).to(dtype)


def as_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.is_floating_point() else x.numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32)) \
        if jnp.issubdtype(x.dtype, jnp.floating) else np.asarray(x)


def rel_err(ref, got) -> float:
    ref, got = as_np(ref), as_np(got)
    assert ref.shape == got.shape, (ref.shape, got.shape)
    return float(np.abs(ref - got).max() / (np.abs(ref).max() + 1e-12))


def random_params(jax_params, rng, scale=1.0):
    """numpy bf16-valued leaves of the shapes of a JAX param tree (biases
    and norm scales drawn too, so they matter)."""
    def draw(x):
        fan_in = x.shape[-2] if x.ndim >= 2 else 1
        a = rng.standard_normal(x.shape) * scale / np.sqrt(
            fan_in if x.ndim >= 2 else 10.0)
        return bf16(a) if x.dtype == jnp.bfloat16 else a.astype(np.float32)
    return jax.tree_util.tree_map(draw, jax_params)


def load(module, params, prefix=""):
    """Copy a nested dict of numpy leaves into the module's parameters."""
    for name, a in params.items():
        if isinstance(a, dict):
            load(module, a, f"{prefix}{name}.")
        else:
            p = module.get_parameter(prefix + name)
            assert p.shape == a.shape, (name, p.shape, a.shape)
            with torch.no_grad():
                p.copy_(torch.from_numpy(np.array(a)))


def jax_tree(params, like):
    """The numpy leaves as JAX arrays of the dtypes of the tree `like`."""
    return jax.tree_util.tree_map(lambda a, ref: jnp.asarray(a, ref.dtype),
                                  params, like)


def configs(name, **reps):
    return (dataclasses.replace(jax_reduced_config(name), **reps),
            dataclasses.replace(reduced_config(name), **reps))


# ---------------------------------------------------------------- common
def test_rms_norm_matches_jax():
    rng = np.random.default_rng(0)
    x = bf16(rng.standard_normal((3, 7, 128)) * 3)
    scale = bf16(rng.standard_normal(128) * 0.3)
    ref = jcommon.rms_norm(to_jax(x), to_jax(scale), 1e-6)
    got = tcommon.rms_norm(to_torch(x), to_torch(scale), 1e-6)
    assert got.dtype == torch.bfloat16
    assert rel_err(ref, got) <= TOL_BF16


def test_rope_tables_match_jax():
    pos = np.array([[0, 1, 17, 4095, 6001]], np.int32)
    for dim, theta in ((32, 1e4), (128, 1e6), (16, 1e4)):
        jc, js = jcommon.rope_tables(jnp.asarray(pos), dim, theta)
        tc, ts = tcommon.rope_tables(torch.tensor(pos), dim, theta)
        assert tc.dtype == torch.float32 and tc.shape == (1, 5, dim // 2)
        assert np.abs(as_np(jc) - as_np(tc)).max() <= TOL_F32
        assert np.abs(as_np(js) - as_np(ts)).max() <= TOL_F32


def test_apply_rope_matches_jax():
    rng = np.random.default_rng(1)
    x = bf16(rng.standard_normal((2, 9, 4, 32)))
    ang = rng.uniform(-3, 3, (2, 9, 16)).astype(np.float32)
    c, s = np.cos(ang), np.sin(ang)
    ref = jcommon.apply_rope(to_jax(x), jnp.asarray(c), jnp.asarray(s))
    got = tcommon.apply_rope(to_torch(x), torch.tensor(c),
                             torch.tensor(s))
    assert rel_err(ref, got) <= TOL_BF16


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "squared_relu", "gelu"])
def test_mlp_matches_jax(kind):
    rng = np.random.default_rng(2)
    jp, _ = jmlp.init_mlp(jax.random.PRNGKey(0), 128, 256, kind)
    p = random_params(jp, rng)
    x = bf16(rng.standard_normal((2, 5, 128)))
    ref = jax.jit(lambda p, x: jmlp.mlp_forward(p, x, kind))(
        jax_tree(p, jp), to_jax(x))
    mod = MLP(128, 256, kind, device="cpu", gen=None)
    load(mod, p)
    got = mlp_forward(mod, to_torch(x), kind)
    assert rel_err(ref, got) <= TOL_LAYER


# ---------------------------------------------------------------- GQA
GQA_CASES = {
    # QKV bias and query heads padded 4 -> 8 (masked before wo)
    "bias_padded": ("qwen2-7b", dict(pad_q_heads_to=8)),
    "qk_norm": ("qwen3-32b", {}),
    # window 16 under T = 24: the mask and the ring buffer both bite
    "window": ("h2o-danube-3-4b", {}),
    "plain": ("nemotron-4-340b", {}),
}


def gqa_setup(case, seed):
    name, reps = GQA_CASES[case]
    jcfg, tcfg = configs(name, **reps)
    rng = np.random.default_rng(seed)
    jp, _ = jattn.init_gqa(jax.random.PRNGKey(0), jcfg)
    p = random_params(jp, rng)
    mod = tattn.GQA(tcfg, device="cpu", gen=None)
    load(mod, p)
    return jcfg, tcfg, jax_tree(p, jp), mod, rng


@pytest.mark.parametrize("q_chunk", [8, 7])
@pytest.mark.parametrize("case", sorted(GQA_CASES))
def test_gqa_prefill_matches_jax(case, q_chunk):
    """q_chunk 8 runs three chunks of T = 24; 7 does not divide T, so the
    whole sequence is one chunk."""
    jcfg, tcfg, p, mod, rng = gqa_setup(case, 3)
    T = 24
    x = bf16(rng.standard_normal((2, T, 128)))
    pos = np.arange(T, dtype=np.int32)
    ref = jax.jit(lambda p, x: jattn.gqa_forward(
        p, x, jcfg, jnp.asarray(pos), q_chunk=q_chunk))(p, to_jax(x))
    got, k, v = tattn.gqa_forward(mod, to_torch(x), tcfg,
                                  torch.tensor(pos), q_chunk=q_chunk)
    assert rel_err(ref, got) <= TOL_LAYER
    _, jk, jv = jax.jit(lambda p, x: jattn._qkv(
        p, x, jcfg, jnp.asarray(pos)[None]))(p, to_jax(x))
    assert rel_err(jk, k) <= TOL_LAYER and rel_err(jv, v) <= TOL_LAYER


@pytest.mark.parametrize("case", sorted(GQA_CASES))
def test_gqa_decode_matches_jax(case):
    """One decode step over a filled cache: slot 0 early, slot 1 past the
    cache's length (a ring wraps; a full cache writes its last slot)."""
    jcfg, tcfg, p, mod, rng = gqa_setup(case, 4)
    B, S = 2, 16 if tcfg.sliding_window else 32
    KV, hd = tcfg.num_kv_heads, tcfg.resolved_head_dim
    k = bf16(rng.standard_normal((B, S, KV, hd)))
    v = bf16(rng.standard_normal((B, S, KV, hd)))
    idx = np.array([5, S + 7], np.int32)
    x = bf16(rng.standard_normal((B, 1, 128)))
    ref, jc = jax.jit(lambda p, x, c: jattn.gqa_decode(p, x, jcfg, c))(
        p, to_jax(x),
        dict(k=to_jax(k), v=to_jax(v), idx=jnp.asarray(idx)))
    cache = dict(k=to_torch(k), v=to_torch(v), idx=torch.tensor(idx))
    got = tattn.gqa_decode(mod, to_torch(x), tcfg, cache)
    assert rel_err(ref, got) <= TOL_LAYER
    assert np.array_equal(as_np(jc["idx"]), cache["idx"].numpy())
    # the same slot written, every other slot untouched
    for name, before in (("k", k), ("v", v)):
        jchanged = (as_np(jc[name]) != before).any(axis=(2, 3))
        tchanged = (as_np(cache[name]) != before).any(axis=(2, 3))
        assert np.array_equal(jchanged, tchanged), name
        assert rel_err(jc[name], cache[name]) <= TOL_LAYER


@pytest.mark.parametrize("kind", ["window_roll", "window_pad", "full",
                                  "mla"])
def test_pad_stacked_cache_matches_jax(kind):
    """Pure data movement: bit-exact."""
    name = {"window_roll": "h2o-danube-3-4b", "window_pad": "h2o-danube-3-4b",
            "full": "qwen3-32b", "mla": "deepseek-v2-236b"}[kind]
    jcfg, tcfg = configs(name)
    rng = np.random.default_rng(5)
    S, prompt_len = {"window_roll": (16, 21), "window_pad": (11, 11),
                     "full": (11, 11), "mla": (11, 11)}[kind]
    if kind == "mla":
        cache = dict(c_kv=bf16(rng.standard_normal((2, 3, S, 32))),
                     k_rope=bf16(rng.standard_normal((2, 3, S, 16))))
    else:
        cache = dict(k=bf16(rng.standard_normal((2, 3, S, 2, 32))),
                     v=bf16(rng.standard_normal((2, 3, S, 2, 32))))
    cache["idx"] = np.full((2, 3), prompt_len, np.int32)
    ref = jattn.pad_stacked_cache(
        {n: jnp.asarray(a) for n, a in cache.items()}, 40, jcfg, prompt_len)
    got = tattn.pad_stacked_cache(
        {n: torch.tensor(a) for n, a in cache.items()}, 40, tcfg,
        prompt_len)
    assert sorted(ref) == sorted(got)
    for n in ref:
        assert np.array_equal(as_np(ref[n]), as_np(got[n])), n


# ---------------------------------------------------------------- MLA
def mla_setup(seed):
    jcfg, tcfg = configs("deepseek-v2-236b")
    rng = np.random.default_rng(seed)
    jp, _ = jattn.init_mla(jax.random.PRNGKey(0), jcfg)
    p = random_params(jp, rng)
    mod = tattn.MLA(tcfg, device="cpu", gen=None)
    load(mod, p)
    return jcfg, tcfg, jax_tree(p, jp), mod, rng


@pytest.mark.parametrize("q_chunk", [8, 512])
def test_mla_prefill_matches_jax(q_chunk):
    """The prefill form: keys decompressed from the latent."""
    jcfg, tcfg, p, mod, rng = mla_setup(6)
    T = 24
    x = bf16(rng.standard_normal((2, T, 128)))
    pos = np.arange(T, dtype=np.int32)
    ref = jax.jit(lambda p, x: jattn.mla_forward(
        p, x, jcfg, jnp.asarray(pos), q_chunk=q_chunk))(p,
                                                        to_jax(x))
    got, c_kv, k_rope = tattn.mla_forward(
        mod, to_torch(x), tcfg, torch.tensor(pos), q_chunk=q_chunk)
    assert rel_err(ref, got) <= TOL_LAYER
    jc, jk = jax.jit(lambda p, x: jattn._mla_kv_latent(
        p, x, jcfg, jnp.asarray(pos)[None]))(p, to_jax(x))
    assert rel_err(jc, c_kv) <= TOL_LAYER and rel_err(jk, k_rope) <= TOL_LAYER


def test_mla_decode_matches_jax():
    """The absorbed form, scoring against the latent cache."""
    jcfg, tcfg, p, mod, rng = mla_setup(7)
    B, S = 2, 32
    c_kv = bf16(rng.standard_normal((B, S, 32)))
    k_rope = bf16(rng.standard_normal((B, S, 16)))
    idx = np.array([4, 19], np.int32)
    x = bf16(rng.standard_normal((B, 1, 128)))
    ref, jc = jax.jit(lambda p, x, c: jattn.mla_decode(p, x, jcfg, c))(
        p, to_jax(x),
        dict(c_kv=to_jax(c_kv), k_rope=to_jax(k_rope),
             idx=jnp.asarray(idx)))
    cache = dict(c_kv=to_torch(c_kv), k_rope=to_torch(k_rope),
                 idx=torch.tensor(idx))
    got = tattn.mla_decode(mod, to_torch(x), tcfg, cache)
    assert rel_err(ref, got) <= TOL_LAYER
    assert np.array_equal(as_np(jc["idx"]), cache["idx"].numpy())
    for name in ("c_kv", "k_rope"):
        assert rel_err(jc[name], cache[name]) <= TOL_LAYER


# ---------------------------------------------------------------- MoE
def test_rank_within_bit_exact():
    rng = np.random.default_rng(8)
    for n, e in ((1, 1), (37, 4), (600, 16), (4096, 160)):
        ids = rng.integers(0, e, n).astype(np.int32)
        ref = np.asarray(jax.jit(jmoe._rank_within)(jnp.asarray(ids)))
        got = tmoe._rank_within(torch.tensor(ids)).numpy()
        assert got.dtype == np.int32 and np.array_equal(ref, got)


def test_capacity_for_bit_exact():
    for name in ("dbrx-132b", "deepseek-v2-236b"):
        for cf in (1.0, 1.25, 4.0):
            jcfg = dataclasses.replace(jax_reduced_config(name),
                                       capacity_factor=cf)
            tcfg = dataclasses.replace(reduced_config(name),
                                       capacity_factor=cf)
            for full in (False, True):
                if full:  # the full-width expert counts
                    jcfg = dataclasses.replace(jcfg, num_experts=160,
                                               num_experts_per_tok=6)
                    tcfg = dataclasses.replace(tcfg, num_experts=160,
                                               num_experts_per_tok=6)
                for tokens in (1, 2, 8, 48, 512, 4096, 100_000, 1 << 20):
                    assert tmoe.capacity_for(tcfg, tokens) == \
                        jmoe.capacity_for(jcfg, tokens)


def test_moe_expert_choice_bit_exact():
    """The top-k experts of float32 router logits; the renormalised
    weights within float32 rounding."""
    rng = np.random.default_rng(9)
    for N, E, k in ((48, 4, 2), (512, 16, 4), (512, 160, 6)):
        logits = rng.standard_normal((N, E)).astype(np.float32)
        gates = jax.nn.softmax(jnp.asarray(logits), axis=-1)
        jw, je = jax.lax.top_k(gates, k)
        _, tw, te = tmoe.route(torch.tensor(logits), k)
        assert np.array_equal(np.asarray(je), te.numpy())
        jw = jw / jnp.maximum(jnp.sum(jw, -1, keepdims=True), 1e-9)
        assert np.abs(np.asarray(jw) - tw.numpy()).max() <= TOL_F32


@pytest.mark.parametrize("name", ["dbrx-132b", "deepseek-v2-236b"])
def test_moe_with_drops_matches_jax(name):
    """capacity_factor 1.0 forces drops: the dropped assignments and the
    assignments each expert got bit-exact, the output (shared experts included for
    DeepSeek) within TOL_LAYER."""
    jcfg, tcfg = configs(name, capacity_factor=1.0)
    rng = np.random.default_rng(10)
    jp, _ = jmoe.init_moe(jax.random.PRNGKey(0), jcfg)
    p = random_params(jp, rng)
    B, T = 2, 24
    x = bf16(rng.standard_normal((B, T, 128)))
    jx = to_jax(x)
    jptree = jax_tree(p, jp)
    ref, jaux = jax.jit(lambda p, x: jmoe.moe_forward(p, x, jcfg))(jptree, jx)

    @jax.jit
    def jax_load_and_drops(p, x):
        xf = x.reshape(B * T, -1)
        logits = jnp.einsum("nd,de->ne", xf.astype(jnp.float32), p["router"])
        _, load, _ = jmoe._dispatch_compute_combine(
            xf, logits, p.get("w_gate"), p["w_up"], p["w_down"], jcfg,
            f_slice_partial=False)
        _, experts = jax.lax.top_k(jax.nn.softmax(logits, axis=-1),
                                   jcfg.num_experts_per_tok)
        rank = jmoe._rank_within(experts.reshape(-1).astype(jnp.int32))
        return load, jnp.sum(rank >= jmoe.capacity_for(jcfg, B * T))

    jload, j_dropped = jax_load_and_drops(jptree, jx)
    j_dropped = int(j_dropped)
    assert j_dropped > 0, "capacity 1.0 should drop some assignments"

    mod = tmoe.MoE(tcfg, device="cpu", gen=None)
    load(mod, p)
    got, taux = tmoe.moe_forward(mod, to_torch(x), tcfg)
    assert int(mod.dropped) == j_dropped
    xf = to_torch(x).reshape(B * T, -1)
    _, tload, _, _ = tmoe._dispatch_compute_combine(
        xf, torch.matmul(xf.float(), mod.router), mod.w_gate, mod.w_up,
        mod.w_down, tcfg)
    # the assignments an expert got, from load = count / (N k)
    nk = B * T * tcfg.num_experts_per_tok
    assert np.array_equal(np.rint(np.asarray(jload) * nk),
                          np.rint(tload.numpy() * nk))
    assert rel_err(ref, got) <= TOL_LAYER
    assert abs(float(jaux) - float(taux)) <= 1e-5 * abs(float(jaux))
