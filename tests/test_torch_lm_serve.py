"""Continuous batching on the port (`repro_torch.serve.ContinuousBatcher`).

The four batcher tests of tests/test_serve.py, on the port with its own
weights (seed 0, on the CPU): greedy decode token by token equal to
teacher-forced full forwards, batched decoding equal to isolated decoding
on danube's sliding-window ring (and on Mamba-2, RecurrentGemma and
Whisper), exact token accounting, and max_new_tokens=1 completing at
admission. Admission writes each leaf of a nested cache along its batch
axis, and nothing else. Then the port's batcher against the JAX
package's on the reduced configs of qwen3-32b and the three families
with JAX's weights: ServeStats equal (level 1), and each step's argmax
equal to JAX's token (level 1), teacher-forced so that one flipped
argmax cannot cascade.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced_config
from repro.models import get_model as jax_get_model
from repro.serve import ContinuousBatcher as JaxBatcher
from repro.serve import Request as JaxRequest
from repro_torch.configs import reduced_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import get_model
from repro_torch.serve import ContinuousBatcher, Request

# the state-space, hybrid and encoder-decoder families
FAMILY_ARCHS = ["mamba2-1.3b", "recurrentgemma-9b", "whisper-tiny"]
# tests/test_torch_lm_models.py's bound on the logits (level 2)
TOL_LOGITS = 0.03


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small tensor ops: under parallel test workers torch's thread
    pool oversubscribes the cores (100x slower); one thread keeps serial
    speed."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def port_model(arch, seed=0):
    cfg = reduced_config(arch)
    return get_model(cfg)(cfg, device="cpu", seed=seed)


def greedy_ref(model, prompt, n_new, max_seq=64):
    """Batch-1 greedy decoding, prefilled as the batcher prefills."""
    logits, cache = model.prefill(torch.tensor(prompt[None]).long(),
                                  q_chunk=64, pad_cache_to=max_seq)
    out = [int(torch.argmax(logits[0, -1]))]
    for _ in range(n_new - 1):
        logits, cache = model.decode_step(cache, torch.tensor([[out[-1]]]))
        out.append(int(torch.argmax(logits[0, -1])))
    return out


def test_multi_step_decode_consistency():
    """Greedy decode token-by-token == teacher-forced full forwards."""
    model = port_model("qwen3-32b")
    rng = np.random.default_rng(0)
    T, n_new = 10, 5
    toks = torch.tensor(rng.integers(0, model.cfg.vocab_size, (1, T)))
    _, cache = model.prefill(toks, q_chunk=8, pad_cache_to=T + n_new + 8)
    seq = toks[0].tolist()
    pre_logits, _ = model.prefill(toks, q_chunk=8)
    nxt = int(torch.argmax(pre_logits[0, -1]))
    for _ in range(n_new):
        seq.append(nxt)
        full_logits, _ = model.prefill(torch.tensor([seq]), q_chunk=8)
        want = int(torch.argmax(full_logits[0, -1]))
        step_logits, cache = model.decode_step(cache, torch.tensor([[nxt]]))
        got = int(torch.argmax(step_logits[0, -1]))
        assert got == want
        nxt = got


def test_continuous_batching_matches_isolated():
    """danube's window is 16: prompts of 21 and 30 tokens are trimmed and
    rolled into the ring at admission, and every request decodes past
    the window."""
    model = port_model("h2o-danube-3-4b")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, model.cfg.vocab_size, size=L).astype(np.int32)
               for L in (5, 21, 9, 30)]
    reqs = [Request(rid=i, prompt=p, max_new_tokens=14)
            for i, p in enumerate(prompts)]
    batcher = ContinuousBatcher(model, slots=2, max_seq=64)
    assert batcher.cache["dense"]["k"].shape[2] == 16   # the ring
    stats = batcher.run(reqs)
    assert stats.completed == 4
    for r, p in zip(reqs, prompts):
        assert len(r.generated) == 14, r.rid      # exactly the budget
        assert r.generated == greedy_ref(model, p, 14), r.rid


def test_batcher_exact_token_accounting():
    """Every request emits exactly max_new_tokens tokens (completion is
    checked after every append, admission included) and the counters
    reflect only work actually done."""
    model = port_model("qwen3-32b")
    rng = np.random.default_rng(1)
    budgets = [1, 3, 2, 1]
    reqs = [Request(rid=i,
                    prompt=rng.integers(0, model.cfg.vocab_size,
                                        size=4 + i).astype(np.int32),
                    max_new_tokens=m)
            for i, m in enumerate(budgets)]
    stats = ContinuousBatcher(model, slots=2, max_seq=64).run(reqs)
    for r in reqs:
        assert len(r.generated) == r.max_new_tokens, r.rid
        assert r.done
    assert stats.completed == len(reqs)
    assert stats.prefills == len(reqs)
    assert stats.tokens_out == sum(budgets)
    # the longest chain (3 tokens -> 2 decodes) bounds the step count; the
    # two max_new_tokens=1 requests never occupy a decode slot
    assert stats.steps == 2
    assert stats.max_active <= 2


def test_batcher_mnt1_completes_at_admission():
    """A max_new_tokens=1 request is satisfied by the prefill-argmax token:
    no decode step runs at all and no slot is ever held."""
    model = port_model("qwen3-32b")
    req = Request(rid=0, prompt=np.arange(6, dtype=np.int32),
                  max_new_tokens=1)
    b = ContinuousBatcher(model, slots=1, max_seq=64)
    stats = b.run([req])
    assert req.done and len(req.generated) == 1
    assert stats.steps == 0
    assert stats.tokens_out == 1
    assert stats.max_active == 0
    assert stats.completed == 1
    assert all(r is None for r in b.active)


def test_batcher_decodes_every_slot():
    """Freed slots decode too (their stale tokens take MoE capacity in
    JAX as well), and admission writes the prefill cache into its slot."""
    model = port_model("dbrx-132b")
    shapes = []

    class Spy:
        device = model.device

        def init_cache(self, *a):
            return model.init_cache(*a)

        def prefill(self, tokens, **kw):
            return model.prefill(tokens, **kw)

        def decode_step(self, cache, token):
            shapes.append(tuple(token.shape))
            return model.decode_step(cache, token)

    rng = np.random.default_rng(2)
    reqs = [Request(rid=i, prompt=rng.integers(0, 512, 7).astype(np.int32),
                    max_new_tokens=m) for i, m in enumerate((2, 6, 3))]
    b = ContinuousBatcher(Spy(), slots=3, max_seq=32)
    b.submit(reqs[0])
    _, pre = model.prefill(torch.tensor(reqs[0].prompt[None]).long(),
                           q_chunk=64, pad_cache_to=32)
    for name, t in b.cache["moe"].items():
        assert torch.equal(t[:, 0], pre["moe"][name][:, 0]), name
        assert not t[:, 1:].any(), name
    b.run(reqs[1:])
    assert shapes and set(shapes) == {(3, 1)}


class Recorder:
    """Serves through `model`, keeping the logits of its last call."""

    def __init__(self, model):
        self.model = model
        self.device = model.device
        self.logits = None

    def init_cache(self, *a):
        return self.model.init_cache(*a)

    def prefill(self, tokens, **kw):
        self.logits, cache = self.model.prefill(tokens, **kw)
        return self.logits, cache

    def decode_step(self, cache, token):
        self.logits, cache = self.model.decode_step(cache, token)
        return self.logits, cache


class TeacherForced(ContinuousBatcher):
    """Emits the given tokens (JAX's) in place of its own argmax, so every
    step's input is JAX's; keeps its own argmax in `own`, and in `gaps`
    how far below its own top logit JAX's token's logit was, relative to
    its largest |logit|."""

    def __init__(self, model, forced, **kw):
        super().__init__(Recorder(model), **kw)
        self.forced = forced
        self.own = {}
        self.gaps = {}
        self._admitted = None

    def _finished(self, req, tok):
        forced = self.forced[req.rid][len(req.generated) - 1]
        self.own.setdefault(req.rid, []).append(tok)
        req.generated[-1] = forced
        slot = next((s for s, r in enumerate(self.active) if r is req),
                    None)
        row = self.model.logits[0 if slot is None else slot, -1]
        self.gaps.setdefault(req.rid, []).append(
            float((row.max() - row[forced]) / row.abs().max()))
        if slot is None:           # admission: the token _write_slot takes
            self._admitted = forced
        else:                      # a decode step: the next step's input
            self.last_token[slot, 0] = forced
        return super()._finished(req, forced)

    def _write_slot(self, slot, pre_cache, tok):
        super()._write_slot(slot, pre_cache, self._admitted)


def batcher_against_jax(arch, prompt_lens, budgets, max_seq, seed=3):
    """JAX's batcher and the teacher-forced port on JAX's weights, 2
    slots: (the port's stats, JAX's, the port's requests, JAX's, the
    teacher-forced batcher)."""
    jcfg = jax_reduced_config(arch)
    jmodel = jax_get_model(jcfg)
    params = jax.jit(lambda k: jmodel.init_params(jcfg, k)[0])(
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, jcfg.vocab_size, size=L).astype(np.int32)
               for L in prompt_lens]

    jreqs = [JaxRequest(rid=i, prompt=p, max_new_tokens=m)
             for i, (p, m) in enumerate(zip(prompts, budgets))]
    jstats = JaxBatcher(jmodel, params, jcfg, slots=2,
                        max_seq=max_seq).run(jreqs)

    tree = jax.tree_util.tree_map(
        lambda a: np.asarray(a.astype(jnp.float32)), params)
    model = lm_params_from_numpy(reduced_config(arch), tree, device="cpu")
    reqs = [Request(rid=i, prompt=p, max_new_tokens=m)
            for i, (p, m) in enumerate(zip(prompts, budgets))]
    forced = {r.rid: r.generated for r in jreqs}
    b = TeacherForced(model, forced, slots=2, max_seq=max_seq)
    stats = b.run(reqs)
    return stats, jstats, reqs, jreqs, b


def check_against_jax(stats, jstats, reqs, jreqs, b, near_ties=False):
    """Stats and emitted tokens equal (level 1); each step's own argmax
    equal to JAX's token, or with `near_ties`, JAX's token's logit within
    TOL_LOGITS of the port's top (the logits' level-2 bound, as
    tests/test_torch_lm_models.py holds them)."""
    assert vars(stats) == vars(jstats)
    for r, jr in zip(reqs, jreqs):
        assert len(jr.generated) == r.max_new_tokens
        assert r.generated == jr.generated
        if not near_ties:
            assert b.own[r.rid] == jr.generated, r.rid
        for own, tok, gap in zip(b.own[r.rid], jr.generated,
                                 b.gaps[r.rid]):
            assert own == tok or gap <= TOL_LOGITS, (r.rid, own, tok, gap)


def test_batcher_matches_jax_teacher_forced():
    check_against_jax(*batcher_against_jax(
        "qwen3-32b", (6, 11, 6, 11, 6), [4, 6, 1, 3, 5], 32))


# prompts past Mamba-2's chunk (16) and not a multiple of it, and past
# RecurrentGemma's window (32), so its ring is trimmed and rolled
FAMILY_PROMPTS = {"mamba2-1.3b": ((6, 21, 6, 17, 11), 32),
                  "recurrentgemma-9b": ((6, 40, 6, 35, 11), 64),
                  "whisper-tiny": ((6, 11, 6, 11, 6), 32)}


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_batcher_matches_jax_teacher_forced(arch):
    """As for qwen3, but each own argmax may part from JAX's token at a
    near-tie: the logits agree at level 2 only (RecurrentGemma's request
    1 parts at its sixth token, where JAX's top two logits are 1.1%
    apart and the port's two round to the same bf16 value)."""
    lens, max_seq = FAMILY_PROMPTS[arch]
    check_against_jax(*batcher_against_jax(arch, lens, [4, 6, 1, 3, 5],
                                           max_seq), near_ties=True)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_batching_matches_isolated(arch):
    """Each request's tokens from the batcher equal its batch-1 greedy
    decoding: a slot's state stays its own."""
    model = port_model(arch)
    lens, max_seq = FAMILY_PROMPTS[arch]
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, model.cfg.vocab_size, size=L).astype(
        np.int32) for L in lens[:4]]
    reqs = [Request(rid=i, prompt=p, max_new_tokens=9)
            for i, p in enumerate(prompts)]
    stats = ContinuousBatcher(model, slots=2, max_seq=max_seq).run(reqs)
    assert stats.completed == 4
    for r, p in zip(reqs, prompts):
        assert r.generated == greedy_ref(model, p, 9, max_seq), r.rid


def leaves(tree, prefix=""):
    for name, t in tree.items():
        if isinstance(t, dict):
            yield from leaves(t, f"{prefix}{name}.")
        else:
            yield prefix + name, t


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_write_slot_changes_only_its_slot(arch):
    """A batch-1 prefill written into slot 1 of 3 lands in slot 1 of every
    leaf, along dim 2 of RecurrentGemma's [G, n_rec, B, ...] recurrent
    leaves and dim 1 of the rest (Whisper's top-level cross_k/cross_v
    among them), and changes no other slot."""
    model = port_model(arch)
    b = ContinuousBatcher(model, slots=3, max_seq=40)
    with torch.inference_mode():
        for _, t in leaves(b.cache):
            t.fill_(7)
        prompt = torch.arange(3, 14)[None]
        _, pre = model.prefill(prompt, q_chunk=64, pad_cache_to=40)
        b._write_slot(1, pre, 5)
    pre = dict(leaves(pre))
    live = dict(leaves(b.cache))
    assert sorted(pre) == sorted(live)
    if arch == "whisper-tiny":
        assert {"cross_k", "cross_v"} <= set(live)
    for path, t in live.items():
        axis = 2 if path.startswith("groups.rec.") else 1
        assert pre[path].shape[axis] == 1 and t.shape[axis] == 3, path
        assert torch.equal(t.select(axis, 1), pre[path].select(axis, 0)), \
            path
        for other in (0, 2):
            assert (t.select(axis, other) == 7).all(), (path, other)
    assert int(b.last_token[1, 0]) == 5
