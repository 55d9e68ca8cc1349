"""The port's LM training against the JAX package's, on the CPU.

For each of the ten architectures at its reduced config, the JAX model's
`init_params` weights are carried over by `convert.lm_params_from_numpy`
and the same batch (B=2, T=16; tokens drawn with numpy from a seed; the
VLM's image embeddings drawn and rounded to bf16; Whisper's frames zero,
as JAX's `make_batch`) goes through `jax.value_and_grad(loss_fn)` (under
`jax.jit`, once an architecture, in a module fixture) and the port's
`loss_fn` with `torch.autograd.grad`.

Parity (level 2, ROADMAP's levels): the loss within `TOL_LOSS` relative;
each parameter leaf's gradient within `TOL_GRAD` of the leaf's largest
JAX magnitude (measured at most 0.049, RecurrentGemma's conv bias; JAX's
own microbatch bound, tests/test_models_smoke.py, is 0.08; the loss
measured at most 6.2e-4 apart): bf16 matmuls round in other places in
XLA's CPU dots and in torch. Top-k routing is
discontinuous at ties: bf16 rounding moves an MoE layer's gates by ~1e-3,
enough to send a token whose k-th and (k+1)-th gates are that close to
another expert in one package (measured: gradients 0.13-0.30 apart at
margins 0.0011-0.0016). The MoE configs' batches are drawn from seeds
whose smallest margin, asserted here, is above `MIN_MARGIN`, so both
packages route every token alike.

One full train step against JAX's (`make_train_step`, two microbatches,
fp32 and int8 moments): loss (measured 7e-6 apart) and grad norm
(`TOL_GNORM`, measured 7e-4) level 2; the masters within `2.2 lr` of
JAX's (an element whose gradient is near 0 may take its first Adam step,
of size lr, the other way: measured 2.0 lr at most), and on average
within `TOL_STEP_MEAN` lr (measured 0.0064 lr).

Ports of tests/test_models_smoke.py (all ten: a train step lowers the
loss; microbatched gradients match the full batch's; padded heads get
exactly zero gradients), the MoE drop count under remat, the remat
policies (bit-exact on the CPU), and `run_training`: killed and resumed
bit-exact against an uninterrupted run, and resuming a checkpoint written
by the JAX package's training step and Checkpointer.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import Checkpointer as JCheckpointer
from repro.configs import reduced_config as jax_reduced_config
from repro.models import get_model as jax_get_model
from repro.train import AdamWConfig as JAdamWConfig
from repro.train import init_state as jax_init_state
from repro.train import make_train_step as jax_make_train_step
from repro_torch.configs import ARCHS, reduced_config
from repro_torch.convert import (adam_state_from_numpy, lm_param_tree,
                                 lm_params_from_numpy, lm_params_to_numpy,
                                 lm_tree_to_numpy)
from repro_torch.launch import train as launch_train
from repro_torch.models import get_model
from repro_torch.models import transformer as ttransformer
from repro_torch.models.common import remat_policy
from repro_torch.train import AdamWConfig, init_state, make_train_step
from repro_torch.train.optimizer import tree_leaves
from repro_torch.train.train_step import accumulate_grads

TOL_LOSS = 2e-3
TOL_GRAD = 0.06
TOL_STEP_MEAN = 0.02
TOL_GNORM = 5e-3
MIN_MARGIN = 0.005
LM_ARCHS = sorted(ARCHS)
B, T = 2, 16
TOKEN_SEEDS = {"deepseek-v2-236b": 2, "dbrx-132b": 4}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small tensor ops: under parallel test workers torch's thread
    pool oversubscribes the cores; one thread keeps serial speed."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def to_np(x) -> np.ndarray:
    x = jnp.asarray(x)
    return np.asarray(x.astype(jnp.float32) if jnp.issubdtype(
        x.dtype, jnp.floating) else x)


def np_batch(cfg, seed, b=B, t=T):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, t + 1)).astype(np.int32)
    out = dict(tokens=toks[:, :-1], labels=toks[:, 1:])
    if cfg.family == "vlm":
        out["img_embeds"] = to_np(jnp.asarray(rng.standard_normal(
            (b, cfg.num_image_tokens, cfg.d_model)), jnp.bfloat16))
    if cfg.family == "audio":
        out["frames"] = np.zeros((b, cfg.encoder_seq, cfg.d_model),
                                 np.float32)
    return out


def jax_batch(nb):
    return {k: jnp.asarray(v) if k in ("tokens", "labels")
            else jnp.asarray(v, jnp.bfloat16) for k, v in nb.items()}


def port_batch(nb, device="cpu"):
    return {k: torch.tensor(v).long() if k in ("tokens", "labels")
            else torch.tensor(v).to(torch.bfloat16) for k, v in nb.items()}


def moe_margins(model, batch):
    """The smallest gap between the k-th and (k+1)-th gate of any token at
    any MoE layer, in the port's forward."""
    margins = []
    orig = ttransformer.moe_forward

    def hook(p, x, cfg):
        xf = x.detach().float().reshape(-1, x.shape[-1])
        g = torch.sort(torch.softmax(xf @ p.router.detach(), -1), -1).values
        k = cfg.num_experts_per_tok
        margins.append(float((g[:, -k] - g[:, -k - 1]).min()))
        return orig(p, x, cfg)

    ttransformer.moe_forward = hook
    try:
        with torch.no_grad():
            model.loss_fn(batch, q_chunk=8)
    finally:
        ttransformer.moe_forward = orig
    return min(margins)


@pytest.fixture(scope="module")
def refs():
    """arch -> (JAX params tree, numpy batch, JAX loss, JAX grads tree,
    the port's model on JAX's weights), each computed at first use."""
    done = {}

    def get(arch):
        if arch not in done:
            cfg = jax_reduced_config(arch)
            model = jax_get_model(cfg)
            params = jax.jit(lambda k: model.init_params(cfg, k)[0])(
                jax.random.PRNGKey(0))
            nb = np_batch(cfg, TOKEN_SEEDS.get(arch, 0))
            vg = jax.jit(jax.value_and_grad(
                lambda p, b: model.loss_fn(p, b, cfg, q_chunk=8),
                has_aux=True))
            (loss, metrics), grads = vg(params, jax_batch(nb))
            tree = jax.tree_util.tree_map(to_np, params)
            port = lm_params_from_numpy(reduced_config(arch), tree,
                                        device="cpu")
            done[arch] = dict(
                tree=tree, batch=nb, loss=float(loss),
                aux=float(metrics["aux"]),
                grads=jax.tree_util.tree_map(to_np, grads), model=port,
                params=params)
        return done[arch]
    return get


def leaf_errors(ref: dict, got: dict, path=""):
    """path -> max |got - ref| / max |ref| of each leaf."""
    assert sorted(ref) == sorted(got), path
    out = {}
    for k, a in ref.items():
        if isinstance(a, dict):
            out.update(leaf_errors(a, got[k], f"{path}{k}/"))
            continue
        b = got[k]
        assert a.shape == b.shape, (path + k, a.shape, b.shape)
        out[path + k] = float(np.abs(a - b).max()
                              / max(np.abs(a).max(), 1e-12))
    return out


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_loss_and_grads_match_jax(arch, refs):
    ref = refs(arch)
    model = ref["model"]
    batch = port_batch(ref["batch"])
    if model.cfg.num_experts:
        assert moe_margins(model, batch) > MIN_MARGIN
    model.requires_grad_(True)
    params = lm_param_tree(model)
    grads, loss = accumulate_grads(model, params, batch,
                                   loss_kwargs=dict(q_chunk=8))
    model.requires_grad_(False)
    assert abs(float(loss) - ref["loss"]) <= TOL_LOSS * abs(ref["loss"])
    errs = leaf_errors(ref["grads"], lm_tree_to_numpy(grads))
    worst = max(errs, key=errs.get)
    assert errs[worst] <= TOL_GRAD, (worst, errs[worst])


def test_param_tree_round_trip(refs):
    """`lm_params_to_numpy` gives back JAX's tree exactly (stacks
    re-stacked, RG-LRU's [G, n_rec, ...] included)."""
    for arch in ("recurrentgemma-9b", "deepseek-v2-236b"):
        ref = refs(arch)
        back = lm_params_to_numpy(ref["model"])
        errs = leaf_errors(ref["tree"], back)
        assert max(errs.values()) == 0.0, arch


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
def test_train_step_matches_jax(int8, refs):
    """One step of both packages' `make_train_step` (two microbatches)
    from JAX's weights, then a second, with the state carried over from
    JAX by `adam_state_from_numpy`."""
    arch = "qwen2-7b"
    ref = refs(arch)
    jcfg = jax_reduced_config(arch)
    jmodel = jax_get_model(jcfg)
    lr = 1e-2
    jadam = JAdamWConfig(lr=lr, int8_moments=int8)
    jstep = jax.jit(jax_make_train_step(jcfg, jmodel, jadam,
                                        num_microbatches=2,
                                        loss_kwargs=dict(q_chunk=8)))
    nb = np_batch(jcfg, 1, b=4)
    jp, jst, jm = jstep(ref["params"], jax_init_state(ref["params"], jadam),
                        jax_batch(nb))

    cfg = reduced_config(arch)
    model = lm_params_from_numpy(cfg, ref["tree"], device="cpu")
    adam = AdamWConfig(lr=lr, int8_moments=int8)
    step = make_train_step(cfg, model, adam, num_microbatches=2,
                           loss_kwargs=dict(q_chunk=8))
    state, m = step(init_state(lm_param_tree(model), adam), port_batch(nb))
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]),
                                             rel=TOL_LOSS)
    assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                  rel=TOL_GNORM)
    assert int(state.step) == 1
    jmaster = jax.tree_util.tree_map(np.asarray, jst.master)
    diffs = leaf_errors(jmaster, jax.tree_util.tree_map(
        lambda t: t.numpy(), state.master))
    assert sorted(diffs) == sorted(leaf_errors(jmaster, jmaster))
    total, count = 0.0, 0
    for path in diffs:
        a, b = jmaster, state.master
        for k in path.split("/"):
            a, b = a[k], b[k]
        d = np.abs(a - b.numpy())
        assert d.max() <= 2.2 * lr, path
        total, count = total + d.sum(), count + d.size
    assert total / count <= TOL_STEP_MEAN * lr

    # JAX's state carried over: the second step from the same point
    load = lm_params_from_numpy(cfg, jax.tree_util.tree_map(to_np, jp),
                                device="cpu")
    carried = adam_state_from_numpy(
        load, jax.tree_util.tree_map(np.asarray, jst))
    step2 = make_train_step(cfg, load, adam, num_microbatches=2,
                            loss_kwargs=dict(q_chunk=8))
    nb2 = np_batch(jcfg, 2, b=4)
    _, _, jm2 = jstep(jp, jst, jax_batch(nb2))
    _, m2 = step2(carried, port_batch(nb2))
    assert float(m2["loss"]) == pytest.approx(float(jm2["loss"]),
                                              rel=TOL_LOSS)


def smoke_batch(cfg, b=2, t=16):
    """tests/test_models_smoke.py's batch: all-ones tokens and labels."""
    out = dict(tokens=torch.ones((b, t), dtype=torch.long),
               labels=torch.ones((b, t), dtype=torch.long))
    if cfg.family == "audio":
        out["frames"] = torch.zeros((b, cfg.encoder_seq, cfg.d_model),
                                    dtype=torch.bfloat16)
    if cfg.family == "vlm":
        out["img_embeds"] = torch.zeros((b, cfg.num_image_tokens,
                                         cfg.d_model), dtype=torch.bfloat16)
    return out


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_forward_and_train_step(arch):
    """One optimizer step on the same batch lowers the loss (the port's
    own seeded weights)."""
    cfg = reduced_config(arch)
    model = get_model(cfg)(cfg, device="cpu", seed=0)
    batch = smoke_batch(cfg)
    with torch.no_grad():
        loss, metrics = model.loss_fn(batch, q_chunk=8)
    assert bool(torch.isfinite(loss)) and set(metrics) == {"ce", "aux"}
    adam = AdamWConfig(lr=1e-2)
    step = make_train_step(cfg, model, adam, loss_kwargs=dict(q_chunk=8))
    state, m = step(init_state(lm_param_tree(model), adam), batch)
    assert float(m["loss"]) == pytest.approx(float(loss), rel=1e-6)
    with torch.no_grad():
        loss2, _ = model.loss_fn(batch, q_chunk=8)
    assert bool(torch.isfinite(m["grad_norm"]))
    assert float(loss2) < float(loss), (arch, float(loss), float(loss2))


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_microbatched_grads_match_full(arch):
    """Accumulation over two microbatches == the full batch's gradients
    (JAX's bound: 0.08 of the largest entry)."""
    cfg = reduced_config(arch)
    model = get_model(cfg)(cfg, device="cpu", seed=0).requires_grad_(True)
    params = lm_param_tree(model)
    batch = smoke_batch(cfg, b=4, t=8)
    full, _ = accumulate_grads(model, params, batch,
                               loss_kwargs=dict(q_chunk=8))
    acc, _ = accumulate_grads(model, params, batch, 2,
                              loss_kwargs=dict(q_chunk=8))
    a = np.concatenate([v.reshape(-1) for v in tree_leaves(
        lm_tree_to_numpy(full))])
    b = np.concatenate([v.reshape(-1) for v in tree_leaves(
        lm_tree_to_numpy(acc))])
    assert np.abs(a - b).max() / max(np.abs(a).max(), 1e-6) < 0.08


def test_microbatch_grads_accumulate_in_float32():
    """The accumulator is JAX's: each microbatch's bf16 gradients widened
    and summed in float32, then divided by the count (level 1 against
    that sum taken by hand); never a bf16 sum."""
    cfg = reduced_config("qwen3-32b")
    model = get_model(cfg)(cfg, device="cpu", seed=0).requires_grad_(True)
    params = lm_param_tree(model)
    batch = port_batch(np_batch(cfg, 3, b=4, t=8))
    halves = [{k: v[i:i + 2] for k, v in batch.items()} for i in (0, 2)]
    parts = [lm_tree_to_numpy(accumulate_grads(
        model, params, h, loss_kwargs=dict(q_chunk=8))[0]) for h in halves]
    acc, _ = accumulate_grads(model, params, batch, 2,
                              loss_kwargs=dict(q_chunk=8))
    assert all(t.dtype == torch.float32 for leaf in tree_leaves(acc)
               for t in (leaf if isinstance(leaf, list) else [leaf]))
    want = jax.tree_util.tree_map(
        lambda a, b: (a.astype(np.float32) + b) / np.float32(2), *parts)
    assert max(leaf_errors(want, lm_tree_to_numpy(acc)).values()) == 0.0


def test_padded_heads_exact():
    """Head padding (28 -> 32 style) is exact: padded query slots and
    out-projection rows get exactly zero gradients, and stay zero after
    a step."""
    cfg = dataclasses.replace(reduced_config("qwen2-7b"), num_heads=3,
                              num_kv_heads=1, head_dim=16)
    cfgp = dataclasses.replace(cfg, pad_q_heads_to=4)
    model = get_model(cfgp)(cfgp, device="cpu", seed=0)
    rng = np.random.default_rng(0)
    toks = torch.tensor(rng.integers(0, cfg.vocab_size, (2, 17)))
    batch = dict(tokens=toks[:, :-1], labels=toks[:, 1:])
    model.requires_grad_(True)
    grads, _ = accumulate_grads(model, lm_param_tree(model), batch,
                                loss_kwargs=dict(q_chunk=8))
    g = grads["dense_layers"]["attn"]
    for wq, wo in zip(g["wq"], g["wo"]):
        assert float(wq[:, 3:].abs().max()) == 0.0
        assert float(wo[3:].abs().max()) == 0.0
    adam = AdamWConfig(lr=1e-2)
    step = make_train_step(cfgp, model, adam, loss_kwargs=dict(q_chunk=8))
    step(init_state(lm_param_tree(model), adam), batch)
    for block in model.dense_layers:
        assert float(block.attn.wq.detach()[:, 3:].abs().max()) == 0.0
        assert float(block.attn.wo.detach()[3:].abs().max()) == 0.0


@pytest.mark.parametrize("policy", ["full", "dots", "none"])
def test_moe_dropped_counts_one_forward(policy):
    """After a train step, `dropped` holds the drops of one forward pass,
    whatever the remat policy (the full and dots policies re-run the MoE
    layers in the backward pass)."""
    cfg = dataclasses.replace(reduced_config("dbrx-132b"),
                              capacity_factor=0.5)
    model = get_model(cfg)(cfg, device="cpu", seed=0)
    rng = np.random.default_rng(0)
    toks = torch.tensor(rng.integers(0, cfg.vocab_size, (2, 33)))
    batch = dict(tokens=toks[:, :-1], labels=toks[:, 1:])
    with torch.no_grad():
        model.loss_fn(batch, q_chunk=8)
    fwd = [int(layer.moe.dropped) for layer in model.moe_layers]
    assert min(fwd) > 0
    for layer in model.moe_layers:
        layer.moe.dropped.zero_()
    adam = AdamWConfig(lr=1e-2)
    with remat_policy(policy):
        step = make_train_step(cfg, model, adam, loss_kwargs=dict(q_chunk=8))
        step(init_state(lm_param_tree(model), adam), batch)
    assert [int(layer.moe.dropped) for layer in model.moe_layers] == fwd


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "mamba2-1.3b",
                                  "recurrentgemma-9b", "whisper-tiny"])
def test_remat_policies_agree(arch):
    """"full", "dots" and "none" give the same loss and gradients,
    bit for bit on the CPU (level 1)."""
    cfg = reduced_config(arch)
    model = get_model(cfg)(cfg, device="cpu", seed=0).requires_grad_(True)
    params = lm_param_tree(model)
    nb = np_batch(cfg, 0)
    out = {}
    for policy in ("full", "dots", "none"):
        with remat_policy(policy):
            grads, loss = accumulate_grads(model, params, port_batch(nb),
                                           loss_kwargs=dict(q_chunk=8))
        out[policy] = (float(loss), lm_tree_to_numpy(grads))
    for policy in ("dots", "none"):
        assert out[policy][0] == out["full"][0]
        assert max(leaf_errors(out["full"][1], out[policy][1]).values()) \
            == 0.0, policy


def test_remat_policy_rejects_unknown():
    with pytest.raises(ValueError, match="remat"):
        with remat_policy("everything"):
            pass


def _state_arrays(model, state):
    return dict(params=lm_params_to_numpy(model),
                opt=jax.tree_util.tree_map(
                    lambda t: t.numpy(), tuple(state)))


def test_run_training_killed_and_resumed_bit_exact(tmp_path, monkeypatch):
    """Killed after step 3 (a snapshot at step 2), then resumed: the
    weights and state after 5 steps equal an uninterrupted run's."""
    cfg = reduced_config("deepseek-v2-236b")
    kw = dict(steps=5, global_batch=4, seq_len=16, num_microbatches=2,
              checkpoint_every=2, q_chunk=8, log_every=100, device="cpu")
    model, state, losses = launch_train.run_training(cfg, **kw)

    real = launch_train.SyntheticTokens.batch_at

    def dies_at_3(self, step):
        if step == 3:
            raise KeyboardInterrupt("killed")
        return real(self, step)

    monkeypatch.setattr(launch_train.SyntheticTokens, "batch_at", dies_at_3)
    with pytest.raises(KeyboardInterrupt):
        launch_train.run_training(cfg, checkpoint_dir=str(tmp_path), **kw)
    monkeypatch.setattr(launch_train.SyntheticTokens, "batch_at", real)
    model2, state2, losses2 = launch_train.run_training(
        cfg, checkpoint_dir=str(tmp_path), **kw)
    assert losses2 == losses[2:]
    a, b = _state_arrays(model, state), _state_arrays(model2, state2)
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(
        np.array_equal, a, b))


def test_jax_checkpoint_resumes_in_port(tmp_path):
    """A snapshot of the JAX package's training state (its init, two
    steps of its `make_train_step`, saved by its Checkpointer as its
    `run_training` saves) resumes in the port's `run_training`: the
    weights and state restored exactly, the next step's loss as JAX's.
    (JAX's `run_training` itself builds a mesh whose sharding hints this
    JAX version refuses on the CPU: tests/test_sharding.py's failure.)"""
    arch, steps = "mamba2-1.3b", 2
    jcfg = jax_reduced_config(arch)
    jmodel = jax_get_model(jcfg)
    params = jmodel.init_params(jcfg, jax.random.PRNGKey(0))[0]
    adam = JAdamWConfig(lr=3e-4)
    opt = jax_init_state(params, adam)
    jstep = jax.jit(jax_make_train_step(jcfg, jmodel, adam,
                                        loss_kwargs=dict(q_chunk=8)))
    data = launch_train.SyntheticTokens(launch_train.DataConfig(
        vocab_size=jcfg.vocab_size, seq_len=16, global_batch=2))
    jlosses = []
    for i in range(steps + 1):
        b = data.batch_at(i)
        if i == steps:
            JCheckpointer(str(tmp_path)).save(
                steps, dict(params=params, opt=opt), blocking=True)
        params, opt, m = jstep(params, opt, dict(
            tokens=jnp.asarray(b["tokens"]), labels=jnp.asarray(b["labels"])))
        jlosses.append(float(m["loss"]))

    cfg = reduced_config(arch)
    kw = dict(global_batch=2, seq_len=16, q_chunk=8, device="cpu",
              checkpoint_dir=str(tmp_path))
    model, state, losses = launch_train.run_training(cfg, steps=steps, **kw)
    assert losses == []
    flat, _ = JCheckpointer(str(tmp_path)).restore(steps)
    mine = _state_arrays(model, state)
    assert np.array_equal(mine["opt"][0], flat["opt/step"])
    assert np.array_equal(mine["opt"][1]["layers"]["A_log"],
                          flat["opt/master/layers/A_log"])
    assert np.array_equal(mine["params"]["layers"]["in_proj"],
                          flat["params/layers/in_proj"])
    _, _, losses = launch_train.run_training(cfg, steps=steps + 1, **kw)
    assert losses[0] == pytest.approx(jlosses[steps], rel=TOL_LOSS)


def test_cli_trains_on_cpu(capsys, tmp_path):
    launch_train.main(["--arch", "qwen2-7b", "--reduced", "--steps", "2",
                       "--global-batch", "2", "--seq-len", "16",
                       "--device", "cpu", "--checkpoint-dir",
                       str(tmp_path)])
    assert "[train] done. loss" in capsys.readouterr().out
    assert (tmp_path / "step_000000002" / "manifest.json").exists()
    with pytest.raises(RuntimeError, match="need 256 devices, have"):
        launch_train.main(["--reduced", "--production-mesh"])


def test_training_needs_a_card_or_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_train.run_training(reduced_config("qwen2-7b"), steps=1,
                                  global_batch=2, seq_len=8)
