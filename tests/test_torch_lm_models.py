"""The port's LMs against the JAX package's, on the CPU.

For each of the ten architectures (the six of `models/transformer.py`,
the VLM, Mamba-2, RecurrentGemma and the Whisper encoder-decoder), the
JAX model's `init_params` weights are carried over by
`convert.lm_params_from_numpy`, and the same tokens (and image
embeddings, or audio frames) go through both packages' `prefill` and one
`decode_step` at the reduced config, B=2, T=24. The JAX side runs once an
architecture, under `jax.jit`, in a module fixture.

Parity: logits of the last position within `TOL_LOGITS` of the largest
JAX logit (level 2: bf16 matmuls round in other places in XLA's CPU dots
and in torch, and XLA rounds each step of a bf16 GeLU, torch once;
measured at most 0.014 over the decoder-only seven, 0.028 over the
other three, RecurrentGemma's decode the largest); the cache's idx and which of its slots hold a value (the
ring's slots included) bit-exact (level 1), its float leaves (attention
keys and values, the SSM and RG-LRU states, the conv histories, the
cross keys and values) within `TOL_LOGITS`.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import reduced_config as jax_reduced_config
from repro.models import get_model as jax_get_model
from repro_torch.configs import ARCHS, get_config, reduced_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import get_model
from repro_torch.models.transformer import Transformer

TOL_LOGITS = 0.03
LM_ARCHS = ["dbrx-132b", "deepseek-v2-236b", "h2o-danube-3-4b",
            "internvl2-1b", "nemotron-4-340b", "qwen2-7b", "qwen3-32b",
            "mamba2-1.3b", "recurrentgemma-9b", "whisper-tiny"]
# float32 parameters: the MoE router, Mamba-2's A_log, dt_bias and D, and
# RG-LRU's lam; every other parameter is bf16
F32_PARAMS = ("router", "A_log", "dt_bias", "D", "lam")
B, T, PAD = 2, 24, 72


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small tensor ops: under parallel test workers torch's thread
    pool oversubscribes the cores (100x slower); one thread keeps serial
    speed."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def to_np(x) -> np.ndarray:
    """float32 (widened from bf16, exactly) or the integer array."""
    x = jnp.asarray(x)
    return np.asarray(x.astype(jnp.float32) if jnp.issubdtype(
        x.dtype, jnp.floating) else x)


def jax_reference(arch):
    cfg = jax_reduced_config(arch)
    model = jax_get_model(cfg)
    params = jax.jit(lambda k: model.init_params(cfg, k)[0])(
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(LM_ARCHS.index(arch))
    toks = rng.integers(0, cfg.vocab_size, (B, T + 1)).astype(np.int32)
    extra = {}
    if cfg.family == "vlm":
        extra["img_embeds"] = to_np(jnp.asarray(rng.standard_normal(
            (B, cfg.num_image_tokens, cfg.d_model)), jnp.bfloat16))
    if cfg.family == "audio":
        extra["frames"] = to_np(jnp.asarray(rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)), jnp.bfloat16))
    jextra = {k: jnp.asarray(v, jnp.bfloat16) for k, v in extra.items()}
    prefill = jax.jit(lambda p, t, e: model.prefill(
        p, t, cfg, q_chunk=8, pad_cache_to=PAD, **e))
    decode = jax.jit(lambda p, c, t: model.decode_step(p, c, t, cfg))
    logits, cache = prefill(params, toks[:, :T], jextra)
    dec_logits, dec_cache = decode(params, cache, toks[:, T:])
    tree = jax.tree_util.tree_map(to_np, params)
    return dict(tree=tree, toks=toks, extra=extra,
                prefill=to_np(logits), cache=jax.tree_util.tree_map(
                    to_np, cache),
                decode=to_np(dec_logits),
                dec_cache=jax.tree_util.tree_map(to_np, dec_cache))


@pytest.fixture(scope="module")
def refs():
    """arch -> the JAX reference and the port's run on its weights, each
    computed at first use."""
    done = {}

    def get(arch):
        if arch not in done:
            ref = jax_reference(arch)
            cfg = reduced_config(arch)
            model = lm_params_from_numpy(cfg, ref["tree"], device="cpu")
            extra = {k: torch.tensor(v).to(torch.bfloat16)
                     for k, v in ref["extra"].items()}
            toks = torch.tensor(ref["toks"]).long()
            logits, cache = model.prefill(toks[:, :T], q_chunk=8,
                                          pad_cache_to=PAD, **extra)
            pre_cache = clone_tree(cache)
            dec, cache = model.decode_step(cache, toks[:, T:])
            port = dict(model=model, prefill=logits, cache=pre_cache,
                        decode=dec, dec_cache=cache)
            done[arch] = (ref, port)
        return done[arch]
    return get


def clone_tree(cache):
    return {n: clone_tree(t) if isinstance(t, dict) else t.clone()
            for n, t in cache.items()}


def rel_err(ref: np.ndarray, got: torch.Tensor) -> float:
    got = got.float().numpy()
    assert ref.shape == got.shape, (ref.shape, got.shape)
    return float(np.abs(ref - got).max() / (np.abs(ref).max() + 1e-12))


def check_cache(jcache, tcache, path=""):
    """Leaf by leaf through the nested cache."""
    assert sorted(jcache) == sorted(tcache), path
    for name, ref in jcache.items():
        got, where = tcache[name], path + name
        if isinstance(ref, dict):
            check_cache(ref, got, where + ".")
            continue
        if name == "idx":
            assert got.dtype == torch.int32
            assert np.array_equal(ref, got.numpy()), where
            continue
        # which slots hold a value: [L, B, S] of a stacked attention
        # cache (the ring's slots), [L, B, k-1] of a conv history
        axes = tuple(range(3, ref.ndim))
        assert np.array_equal((ref != 0).any(axis=axes),
                              (got.float().numpy() != 0).any(axis=axes)), \
            where
        assert rel_err(ref, got) <= TOL_LOGITS, where


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_prefill_logits_match_jax(arch, refs):
    ref, port = refs(arch)
    assert port["prefill"].shape == (B, 1, reduced_config(arch).vocab_size)
    assert port["prefill"].dtype == torch.float32
    assert rel_err(ref["prefill"][:, -1], port["prefill"][:, -1]) \
        <= TOL_LOGITS


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_decode_logits_match_jax(arch, refs):
    ref, port = refs(arch)
    assert rel_err(ref["decode"][:, -1], port["decode"][:, -1]) \
        <= TOL_LOGITS


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_cache_matches_jax(arch, refs):
    """After prefill (padded to decode capacity, or the ring rolled) and
    after one decode step."""
    ref, port = refs(arch)
    check_cache(ref["cache"], port["cache"])
    check_cache(ref["dec_cache"], port["dec_cache"])


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_decode_matches_full_forward(arch, refs):
    """The port's incremental decode against its full forward over T+1
    tokens: the bound of tests/test_serve.py."""
    ref, port = refs(arch)
    model = port["model"]
    toks = torch.tensor(ref["toks"]).long()
    extra = {k: torch.tensor(v).to(torch.bfloat16)
             for k, v in ref["extra"].items()}
    full, _ = model.prefill(toks, q_chunk=8, **extra)
    _, cache = model.prefill(toks[:, :T], q_chunk=8, pad_cache_to=T + 48,
                             **extra)
    dec, _ = model.decode_step(cache, toks[:, T:])
    a, b = full[:, -1], dec[:, -1]
    assert float((a - b).abs().max() / a.abs().max()) < 0.05


@pytest.mark.parametrize("fault", ["missing", "extra", "misshapen",
                                   "bf16_dtype"])
def test_converter_refuses_bad_trees(fault, refs):
    ref, _ = refs("deepseek-v2-236b")
    cfg = reduced_config("deepseek-v2-236b")
    tree = jax.tree_util.tree_map(lambda a: a, ref["tree"])
    if fault == "missing":
        del tree["moe_layers"]["moe"]["shared"]["w_gate"]
    elif fault == "extra":
        tree["moe_layers"]["attn"]["wq_c"] = tree["moe_layers"]["attn"]["wq_a"]
    elif fault == "misshapen":
        tree["dense_layers"]["attn"]["wo"] = \
            tree["dense_layers"]["attn"]["wo"][..., :-1]
    else:  # a JAX bf16 leaf not widened: refused, not guessed at
        tree["final_norm"] = np.asarray(jnp.asarray(tree["final_norm"],
                                                    jnp.bfloat16))
    with pytest.raises((ValueError, TypeError), match={
            "missing": "missing", "extra": "wq_c", "misshapen": "shape",
            "bf16_dtype": "float32"}[fault]):
        lm_params_from_numpy(cfg, tree, device="cpu")


def test_converter_splits_stacked_layers(refs):
    """Each layer's module holds its own slice of JAX's stacked leaf, and
    each recurrent block of an RG-LRU group its slice of the double stack
    [G, n_rec, ...]."""
    ref, port = refs("qwen3-32b")
    model = port["model"]
    wq = ref["tree"]["dense_layers"]["attn"]["wq"]
    for i, block in enumerate(model.dense_layers):
        assert np.array_equal(block.attn.wq.float().numpy(), wq[i])
    assert model.moe_layers is not None and len(model.moe_layers) == 0

    ref, port = refs("recurrentgemma-9b")
    model, tree = port["model"], ref["tree"]
    groups = tree["groups"]
    assert groups["rec"]["w_a"].shape[:2] == (1, 2)
    for g, group in enumerate(model.groups):
        for r, block in enumerate(group.rec):
            assert np.array_equal(block.w_a.float().numpy(),
                                  groups["rec"]["w_a"][g, r])
            assert np.array_equal(block.lam.numpy(),
                                  groups["rec"]["lam"][g, r])
        assert np.array_equal(group.attn.attn.wk.float().numpy(),
                              groups["attn"]["attn"]["wk"][g])
    for i, block in enumerate(model.trailing):
        assert np.array_equal(block.w_x.float().numpy(),
                              tree["trailing"]["w_x"][i])


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_get_model_serves_every_config(arch):
    """All ten configs have a model with the serving API."""
    cfg = reduced_config(arch)
    model = get_model(cfg)(cfg, device="cpu", seed=0)
    for method in ("init_cache", "prefill", "decode_step"):
        assert callable(getattr(model, method)), method
    assert model.device == torch.device("cpu")


def test_entry_points_need_a_card_or_cpu(monkeypatch, refs):
    """No fallback: without a card, the model and the converter raise
    unless device='cpu' is passed."""
    ref, _ = refs("qwen2-7b")
    cfg = reduced_config("qwen2-7b")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Transformer(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm_params_from_numpy(cfg, ref["tree"])
    assert Transformer(cfg, device="cpu").device == torch.device("cpu")
    for arch in ("mamba2-1.3b", "recurrentgemma-9b", "whisper-tiny"):
        cfg = reduced_config(arch)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            get_model(cfg)(cfg)
    ref, _ = refs("mamba2-1.3b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm_params_from_numpy(reduced_config("mamba2-1.3b"), ref["tree"])


def test_configs_match_jax():
    """The ten configs, their reduced forms and their parameter counts."""
    assert sorted(ARCHS) == sorted(JAX_ARCHS)
    for name in ARCHS:
        assert dataclasses.asdict(get_config(name)) == \
            dataclasses.asdict(JAX_ARCHS[name])
        assert dataclasses.asdict(reduced_config(name)) == \
            dataclasses.asdict(jax_reduced_config(name))
        cfg, jcfg = get_config(name), JAX_ARCHS[name]
        assert cfg.param_count() == jcfg.param_count()
        assert cfg.active_param_count() == jcfg.active_param_count()
        assert cfg.resolved_head_dim == jcfg.resolved_head_dim
        assert cfg.is_subquadratic == jcfg.is_subquadratic


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_port_params_match_jax_tree(arch, refs):
    """The port's own init builds the parameters the JAX tree has, of the
    same shapes, bf16 but for the float32 ones (`F32_PARAMS`)."""
    ref, port = refs(arch)
    cfg = reduced_config(arch)
    own = get_model(cfg)(cfg, device="cpu", seed=1)
    theirs = dict(port["model"].named_parameters())
    mine = dict(own.named_parameters())
    assert sorted(mine) == sorted(theirs)
    for name, p in mine.items():
        assert p.shape == theirs[name].shape
        f32 = name.rsplit(".", 1)[-1] in F32_PARAMS
        assert p.dtype == (torch.float32 if f32 else torch.bfloat16), name
