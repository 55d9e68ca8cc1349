"""Continuous batching on the port (`repro_torch.serve.ContinuousBatcher`).

The four batcher tests of tests/test_serve.py, on the port with its own
weights (seed 0, on the CPU): greedy decode token by token equal to
teacher-forced full forwards, batched decoding equal to isolated decoding
on danube's sliding-window ring, exact token accounting, and
max_new_tokens=1 completing at admission. Then the port's batcher against
the JAX package's on qwen3-32b's reduced config with JAX's weights:
ServeStats equal (level 1), and each step's argmax equal to JAX's token
(level 1), teacher-forced so that one flipped argmax cannot cascade.
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


class TeacherForced(ContinuousBatcher):
    """Emits the given tokens (JAX's) in place of its own argmax, so every
    step's input is JAX's; keeps its own argmax in `own`."""

    def __init__(self, model, forced, **kw):
        super().__init__(model, **kw)
        self.forced = forced
        self.own = {}
        self._admitted = None

    def _finished(self, req, tok):
        forced = self.forced[req.rid][len(req.generated) - 1]
        self.own.setdefault(req.rid, []).append(tok)
        req.generated[-1] = forced
        slot = next((s for s, r in enumerate(self.active) if r is req),
                    None)
        if slot is None:           # admission: the token _write_slot takes
            self._admitted = forced
        else:                      # a decode step: the next step's input
            self.last_token[slot, 0] = forced
        return super()._finished(req, forced)

    def _write_slot(self, slot, pre_cache, tok):
        super()._write_slot(slot, pre_cache, self._admitted)


def test_batcher_matches_jax_teacher_forced():
    jcfg = jax_reduced_config("qwen3-32b")
    jmodel = jax_get_model(jcfg)
    params = jax.jit(lambda k: jmodel.init_params(jcfg, k)[0])(
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, jcfg.vocab_size, size=L).astype(np.int32)
               for L in (6, 11, 6, 11, 6)]
    budgets = [4, 6, 1, 3, 5]

    jreqs = [JaxRequest(rid=i, prompt=p, max_new_tokens=m)
             for i, (p, m) in enumerate(zip(prompts, budgets))]
    jstats = JaxBatcher(jmodel, params, jcfg, slots=2, max_seq=32).run(jreqs)

    tree = jax.tree_util.tree_map(
        lambda a: np.asarray(a.astype(jnp.float32)), params)
    model = lm_params_from_numpy(reduced_config("qwen3-32b"), tree,
                                 device="cpu")
    reqs = [Request(rid=i, prompt=p, max_new_tokens=m)
            for i, (p, m) in enumerate(zip(prompts, budgets))]
    forced = {r.rid: r.generated for r in jreqs}
    b = TeacherForced(model, forced, slots=2, max_seq=32)
    stats = b.run(reqs)
    assert vars(stats) == vars(jstats)
    for r, jr in zip(reqs, jreqs):
        assert len(jr.generated) == r.max_new_tokens
        assert r.generated == jr.generated
        assert b.own[r.rid] == jr.generated, r.rid
