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
0.008). `TOL_SCAN`, relative, for float32 results summed or scanned in
another order than XLA's: Mamba-2's SSD contractions and RG-LRU's scan
(level 2).
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
from repro.models import encdec as jencdec
from repro.models import mamba2 as jmamba
from repro.models import mlp as jmlp
from repro.models import moe as jmoe
from repro.models import rglru as jrglru
from repro_torch.configs import reduced_config
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import encdec as tencdec
from repro_torch.models import mamba2 as tmamba
from repro_torch.models import moe as tmoe
from repro_torch.models import rglru as trglru
from repro_torch.models.mlp import MLP, mlp_forward

TOL_F32 = 1e-5
TOL_SCAN = 1e-5
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


# ---------------------------------------------------------------- Mamba-2
def mamba_setup(seed):
    jcfg, tcfg = configs("mamba2-1.3b")
    rng = np.random.default_rng(seed)
    jp, _ = jmamba.init_block(jax.random.PRNGKey(0), jcfg)
    p = random_params(jp, rng)
    mod = tmamba.Mamba2Block(tcfg, device="cpu", gen=None)
    load(mod, p)
    return jcfg, tcfg, jax_tree(p, jp), mod, rng


def test_segsum_matches_jax():
    """-inf above the diagonal bit-exact, the cumsum differences within
    float32 rounding."""
    rng = np.random.default_rng(11)
    x = (0.3 * rng.standard_normal((2, 3, 16))).astype(np.float32)
    ref = np.asarray(jax.jit(jmamba._segsum)(jnp.asarray(x)))
    got = tmamba._segsum(torch.tensor(x)).numpy()
    assert np.array_equal(np.isneginf(ref), np.isneginf(got))
    finite = np.isfinite(ref)
    assert np.abs(ref[finite] - got[finite]).max() <= TOL_F32


@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("chunks", [1, 3])
def test_ssd_chunked_matches_jax(chunks, init):
    """The dual form over 1 and 3 chunks of 16, from a zero and a given
    state: float32 contractions in another order (`TOL_SCAN`)."""
    rng = np.random.default_rng(12)
    b, Q, h, pd, n = 2, 16, 4, 8, 16
    L = chunks * Q
    x = rng.standard_normal((b, L, h, pd)).astype(np.float32)
    dtA = -rng.uniform(0.01, 0.5, (b, L, h)).astype(np.float32)
    Bm = rng.standard_normal((b, L, n)).astype(np.float32)
    Cm = rng.standard_normal((b, L, n)).astype(np.float32)
    s0 = rng.standard_normal((b, h, pd, n)).astype(np.float32) \
        if init else None
    jy, js = jax.jit(lambda *a: jmamba.ssd_chunked(*a[:4], Q, a[4]))(
        x, dtA, Bm, Cm, s0)
    ty, ts = tmamba.ssd_chunked(
        torch.tensor(x), torch.tensor(dtA), torch.tensor(Bm),
        torch.tensor(Cm), Q, None if s0 is None else torch.tensor(s0))
    assert rel_err(jy, ty) <= TOL_SCAN and rel_err(js, ts) <= TOL_SCAN


@pytest.mark.parametrize("T", [32, 24, 2])
def test_mamba2_block_forward_matches_jax(T):
    """T a multiple of the chunk (16), T padded to one (24 -> 32), and
    T = 2 < k-1, whose conv state holds zero rows of the padding."""
    jcfg, tcfg, p, mod, rng = mamba_setup(13)
    x = bf16(rng.standard_normal((2, T, 128)))
    ref, (jconv, jssm) = jax.jit(lambda p, x: jmamba.block_forward(
        p, x, jcfg, want_state=True))(p, to_jax(x))
    got, conv, ssm = tmamba.block_forward(mod, to_torch(x), tcfg)
    assert rel_err(ref, got) <= TOL_LAYER
    assert rel_err(jconv, conv) <= TOL_LAYER
    assert np.array_equal(as_np(jconv) == 0, as_np(conv) == 0)
    assert ssm.dtype == torch.float32 and rel_err(jssm, ssm) <= TOL_LAYER


def test_mamba2_block_decode_matches_jax():
    """One recurrent step over a given conv history and state: the kept
    history rows bit-exact, the rest within TOL_LAYER."""
    jcfg, tcfg, p, mod, rng = mamba_setup(14)
    conv = bf16(rng.standard_normal((2, 3, 288)))
    ssm = rng.standard_normal((2, 8, 32, 16)).astype(np.float32)
    idx = np.array([5, 40], np.int32)
    x = bf16(rng.standard_normal((2, 1, 128)))
    ref, jc = jax.jit(lambda p, x, c: jmamba.block_decode(p, x, jcfg, c))(
        p, to_jax(x), dict(conv=to_jax(conv), ssm=jnp.asarray(ssm),
                           idx=jnp.asarray(idx)))
    cache = dict(conv=to_torch(conv), ssm=torch.tensor(ssm),
                 idx=torch.tensor(idx))
    got = tmamba.block_decode(mod, to_torch(x), tcfg, cache)
    assert rel_err(ref, got) <= TOL_LAYER
    assert np.array_equal(as_np(jc["idx"]), cache["idx"].numpy())
    assert np.array_equal(as_np(cache["conv"])[:, :2], conv[:, 1:])
    assert rel_err(jc["conv"], cache["conv"]) <= TOL_LAYER
    assert rel_err(jc["ssm"], cache["ssm"]) <= TOL_LAYER


# ---------------------------------------------------------------- RG-LRU
def rglru_setup(seed):
    jcfg, tcfg = configs("recurrentgemma-9b")
    rng = np.random.default_rng(seed)
    jp, _ = jrglru.init_recurrent_block(jax.random.PRNGKey(0), jcfg)
    p = random_params(jp, rng)
    # JAX's init range, so a = sigmoid(lam) is near 1 and the scan carries
    # its state far
    p["lam"] = rng.uniform(2.2, 6.9, p["lam"].shape).astype(np.float32)
    mod = trglru.RecurrentBlock(tcfg, device="cpu", gen=None)
    load(mod, p)
    return jcfg, tcfg, jax_tree(p, jp), mod, rng


@pytest.mark.parametrize("h0", [False, True])
def test_rglru_scan_matches_jax(h0):
    """The doubling scan against `jax.lax.associative_scan` (another
    association order) over T = 37, with and without an initial state."""
    rng = np.random.default_rng(15)
    a = rng.uniform(0.5, 1.0, (2, 37, 16)).astype(np.float32)
    x = rng.standard_normal((2, 37, 16)).astype(np.float32)
    h = rng.standard_normal((2, 16)).astype(np.float32) if h0 else None
    ref = jax.jit(jrglru._rglru_scan)(x, a, h)
    got = trglru._rglru_scan(torch.tensor(x), torch.tensor(a),
                             None if h is None else torch.tensor(h))
    assert rel_err(ref, got) <= TOL_SCAN


@pytest.mark.parametrize("T", [1, 24])
def test_recurrent_branch_matches_jax(T):
    """The conv over a given history, the float32 gates and the scan from
    a given state (T = 1 is decode's step)."""
    jcfg, tcfg, p, mod, rng = rglru_setup(16)
    hist = bf16(rng.standard_normal((2, 3, 128)))
    h0 = rng.standard_normal((2, 128)).astype(np.float32)
    xw = bf16(rng.standard_normal((2, T, 128)))
    jy, (jhist, jh) = jax.jit(lambda p, x, c, h: jrglru._recurrent_branch(
        p, x, jcfg, conv_hist=c, h0=h))(p, to_jax(xw), to_jax(hist),
                                        jnp.asarray(h0))
    ty, thist, th = trglru._recurrent_branch(
        mod, to_torch(xw), tcfg, to_torch(hist), torch.tensor(h0))
    assert rel_err(jy, ty) <= TOL_BF16
    assert np.array_equal(as_np(jhist), as_np(thist))     # data movement
    assert th.dtype == torch.float32 and rel_err(jh, th) <= TOL_SCAN


def test_recurrent_block_decode_matches_jax():
    jcfg, tcfg, p, mod, rng = rglru_setup(17)
    c = dict(conv=bf16(rng.standard_normal((2, 3, 128))),
             h=rng.standard_normal((2, 128)).astype(np.float32),
             idx=np.array([3, 70], np.int32))
    x = bf16(rng.standard_normal((2, 1, 128)))
    ref, jc = jax.jit(lambda p, x, c: jrglru.recurrent_block_decode(
        p, x, jcfg, c))(p, to_jax(x), {n: jnp.asarray(
            a, jnp.bfloat16 if n == "conv" else a.dtype)
            for n, a in c.items()})
    cache = {n: to_torch(a) if n == "conv" else torch.tensor(a)
             for n, a in c.items()}
    got = trglru.recurrent_block_decode(mod, to_torch(x), tcfg, cache)
    assert rel_err(ref, got) <= TOL_LAYER
    assert np.array_equal(as_np(jc["idx"]), cache["idx"].numpy())
    assert np.array_equal(as_np(cache["conv"])[:, :2], c["conv"][:, 1:])
    for name in ("conv", "h"):
        assert rel_err(jc[name], cache[name]) <= TOL_LAYER, name


# ---------------------------------------------------------------- enc-dec
def test_enc_layer_matches_jax():
    """Bidirectional self-attention (RoPE, no mask) and the MLP."""
    jcfg, tcfg = configs("whisper-tiny")
    rng = np.random.default_rng(18)
    jp, _ = jencdec.init_enc_layer(jax.random.PRNGKey(0), jcfg)
    p = random_params(jp, rng)
    mod = tencdec.EncLayer(tcfg, device="cpu", gen=None)
    load(mod, p)
    x = bf16(rng.standard_normal((2, 24, 128)))
    pos = np.arange(24, dtype=np.int32)
    ref = jax.jit(lambda p, x: jencdec.enc_layer_forward(
        p, x, jcfg, jnp.asarray(pos)))(jax_tree(p, jp), to_jax(x))
    got = tencdec.enc_layer_forward(mod, to_torch(x), tcfg,
                                    torch.tensor(pos))
    assert rel_err(ref, got) <= TOL_LAYER


def test_cross_attention_matches_jax():
    """Cross keys and values from the encoder states, then attention of
    the decoder's queries over them (no RoPE, no mask)."""
    jcfg, tcfg = configs("whisper-tiny")
    rng = np.random.default_rng(19)
    jp, _ = jencdec.init_cross_attn(jax.random.PRNGKey(0), jcfg)
    p = random_params(jp, rng)
    jptree = jax_tree(p, jp)
    mod = tattn.GQA(tcfg, device="cpu", gen=None)
    load(mod, p)
    x = bf16(rng.standard_normal((2, 5, 128)))
    enc = bf16(rng.standard_normal((2, 24, 128)))
    jkv = jax.jit(lambda p, e: jencdec.cross_kv(p, e, jcfg))(
        jptree, to_jax(enc))
    tkv = tencdec.cross_kv(mod, to_torch(enc))
    for j, t in zip(jkv, tkv):
        assert rel_err(j, t) <= TOL_LAYER
    ref = jax.jit(lambda p, x, k, v: jencdec.cross_attn_forward(
        p, x, (k, v), jcfg))(jptree, to_jax(x), *jkv)
    got = tencdec.cross_attn_forward(
        mod, to_torch(x), tuple(to_torch(as_np(t)) for t in jkv))
    assert rel_err(ref, got) <= TOL_LAYER
