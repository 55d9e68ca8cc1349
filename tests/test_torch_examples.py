"""The port's examples and audit script (`examples/*_torch.py`,
`scripts/audit_engines_torch.py`) against the JAX package's examples, on
the CPU.

Each JAX example is imported by path and its `main()` runs with its
output captured; where a number is not printed, the object that holds it
is captured by a recording subclass put in the example module's namespace
(nothing of the JAX examples is edited). Each port example's `main()`
runs with `--device cpu` at its default sizes, the JAX example's, and
returns its numbers. Parity levels (ROADMAP's):

  * quickstart: level 1, both engines being bit-exact: K, logical and
    CONGEST rounds, max bits/edge/round, lambda, stitch iterations,
    Algorithm 2's CONGEST rounds, coupons used/created, L1 and top-10 as
    the JAX example prints them (its lines verbatim); power iteration
    level 2: iterations within 1, pi within 1e-6 L1;
  * data weighting: the top 5, batch 0's doc ids, every document's draw
    frequency and the top-20 overlap equal (level 1); the scores level 2
    (JAX normalizes in float32, the port in float64: 6e-9 apart), so the
    correlation within 1e-6 of JAX's (level 2), printed equal;
  * serve_lm: JAX's init (PRNGKey(0)) carried into the port's model;
    requests, completed, steps, prefills and tokens out equal (level 1);
    each request's tokens equal up to the first that differs, where the
    port's top-2 logit margin must be under TOL_LOGITS, the two packages'
    logit agreement of tests/test_torch_lm_serve.py (level 2); past it
    the request decodes another context;
  * cluster: the clean pi at 8 stacked shards equal, bit for bit, to the
    JAX launcher's `run` with the example's arguments at 8 forced host
    devices (level 1; one JAX subprocess started with the module), and
    the recovered pi equal to the clean pi after 2 restarts;
  * train_lm: JAX's `run_training` fails on this JAX version (its mesh's
    sharding hints: tests/test_sharding.py's failure), so the example's
    training, at the reduced Qwen2-7B's widths with its settings, resumes
    a step-0 snapshot of JAX's init and is held to JAX's jitted
    `make_train_step` on the same batches: 3 losses within TOL_LOSS
    (level 2, as tests/test_torch_lm_train.py);
  * the audit script: exit codes and the report (its parity with the JAX
    report is tests/test_torch_congest_audit.py's job);
  * every port file, with no card and no `--device`, exits non-zero with
    `resolve_device`'s message.

One torch thread: many small tensor ops under parallel test workers.
"""
import contextlib
import copy
import importlib.util
import io
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import REPO_SRC
from repro.checkpoint import Checkpointer as JCheckpointer
from repro.configs import reduced_config as jax_reduced_config
from repro.core import power_iteration as jax_power_iteration
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticTokens as JSyntheticTokens
from repro.graphs import barabasi_albert as jax_barabasi_albert
from repro.models import get_model as jax_get_model
from repro.train import AdamWConfig as JAdamWConfig
from repro.train import init_state as jax_init_state
from repro.train import make_train_step as jax_make_train_step
from repro_torch.analysis import congest
from repro_torch.configs import reduced_config
from repro_torch.convert import lm_params_from_numpy

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = ["examples/quickstart_torch.py",
              "examples/pagerank_cluster_torch.py",
              "examples/pagerank_data_weighting_torch.py",
              "examples/serve_lm_torch.py", "examples/train_lm_torch.py",
              "scripts/audit_engines_torch.py",
              "scripts/profile_train_step_torch.py"]
CPU = ["--device", "cpu"]
TOL_LOGITS = 0.03       # tests/test_torch_lm_serve.py's logit agreement
TOL_LOSS = 2e-3         # tests/test_torch_lm_train.py's, relative
CLUSTER_ARGS = dict(n=256, eps=0.2, walks_per_node=64,
                    graph_kind="erdos_renyi", checkpoint_dir=None,
                    fail_at=[])

JAX_CLUSTER = """
import numpy as np
from repro.launch.pagerank import run
np.save(%r, np.asarray(run(**%r)))
"""


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module", autouse=True)
def jax_cluster(tmp_path_factory):
    """The JAX launcher's clean run with the cluster example's arguments
    at 8 forced host devices, started in a subprocess as the module
    starts: (the process, where it saves pi)."""
    where = str(tmp_path_factory.mktemp("jax_cluster") / "pi.npy")
    env = dict(os.environ, PYTHONPATH=REPO_SRC,
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    proc = subprocess.Popen(
        [sys.executable, "-c", JAX_CLUSTER % (where, CLUSTER_ARGS)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    yield proc, where
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def load(path: str):
    """The module of the file `path` of the repository, imported anew."""
    name = "example_" + re.sub(r"\W", "_", path)
    spec = importlib.util.spec_from_file_location(name, ROOT / path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def captured(fn, *args):
    """(fn(*args), what it printed)."""
    with contextlib.redirect_stdout(io.StringIO()) as said:
        result = fn(*args)
    return result, said.getvalue()


def test_quickstart_matches_jax():
    _, said = captured(load("examples/quickstart.py").main)
    got, mine = captured(load("examples/quickstart_torch.py").main, CPU)
    keep = ("graph:", "SIMPLE-PAGERANK:", "  L1 vs baseline:",
            "IMPROVED-PAGERANK:")
    lines = [line for line in said.splitlines() if line.startswith(keep)]
    assert len(lines) == 5
    for line in lines:
        assert line in mine.splitlines(), line
    simple = re.search(r"K=(\d+) walks/node, (\d+) logical rounds, (\d+) "
                       r"CONGEST rounds, max bits/edge/round=(\d+)", said)
    assert [int(v) for v in simple.groups()] == [
        got["K"], got["logical_rounds"], got["congest_rounds"],
        got["max_bits"]]
    improved = re.search(r"lambda=(\d+), (\d+) stitch iters, (\d+) CONGEST "
                         r"rounds.*coupons used/created: (\d+)/(\d+)", said,
                         re.S)
    assert [int(v) for v in improved.groups()] == [
        got["lam"], got["stitch_iterations"], got["congest_rounds_2"],
        got["coupons_used"], got["coupons_created"]]
    l1s = re.findall(r"L1 vs baseline: ([\d.]+)", said)
    assert l1s == [f"{got['l1']:.4f}", f"{got['l1_2']:.4f}"]
    top = re.search(r"top-10 overlap: ([\d.]+)", said).group(1)
    assert top == f"{got['top10']:.2f}"

    iters = int(re.search(r"power iteration: (\d+) iterations", said)[1])
    assert abs(got["power_iterations"] - iters) <= 1
    pi, _, _ = jax_power_iteration(jax_barabasi_albert(512, 3, seed=0), 0.2)
    assert np.abs(got["power_pi"] - np.asarray(pi)).sum() <= 1e-6


def recording_sampler(base, into: dict):
    """A `PageRankWeightedSampler` that keeps its scores and the
    frequencies it returns in `into`."""
    class Recording(base):
        def __init__(self, scores, cfg):
            into["scores"] = np.array(scores)
            super().__init__(scores, cfg)

        def empirical_doc_freq(self, steps=50):
            into["freq"] = super().empirical_doc_freq(steps)
            return into["freq"]
    return Recording


def test_data_weighting_matches_jax(monkeypatch):
    jex, mine = load("examples/pagerank_data_weighting.py"), load(
        "examples/pagerank_data_weighting_torch.py")
    ref, rec = {}, {}
    monkeypatch.setattr(jex, "PageRankWeightedSampler", recording_sampler(
        jex.PageRankWeightedSampler, ref))
    monkeypatch.setattr(mine, "PageRankWeightedSampler", recording_sampler(
        mine.PageRankWeightedSampler, rec))
    _, said = captured(jex.main)
    got, printed = captured(mine.main, CPU)
    for line in said.splitlines():
        assert line in printed.splitlines(), line
    assert got["steps"] == 200 and got["top_docs"] == 400
    assert got["draws"] == 6400
    np.testing.assert_allclose(rec["scores"], ref["scores"], rtol=0,
                               atol=1e-6 * ref["scores"].max())
    np.testing.assert_array_equal(rec["freq"], ref["freq"])
    corr = np.corrcoef(ref["freq"], ref["scores"])[0, 1]
    assert abs(got["corr"] - corr) <= 1e-6
    assert got["top5"] == json.loads(re.search(r"top-5: (\[.*\])", said)[1])
    assert got["top20_overlap"] == int(re.search(r"overlap: (\d+)/20",
                                                 said)[1])


def top2_gap(logits) -> float:
    top = torch.topk(logits.float(), 2).values
    return float(top[0] - top[1])


def margin_batcher(base, batchers: list):
    """A `ContinuousBatcher` that keeps, for each request, the top-2 logit
    margin of each token it emits (`margins[rid]`)."""
    class Margins(base):
        def __init__(self, model, **kw):
            super().__init__(model, **kw)
            batchers.append(self)
            self.margins = {}
            prefill, decode = model.prefill, model.decode_step

            def keep_prefill(tokens, **k):
                logits, cache = prefill(tokens, **k)
                self.last = logits[:, -1]
                return logits, cache

            def keep_decode(cache, token):
                logits, cache = decode(cache, token)
                self.last = logits[:, -1]
                return logits, cache
            model.prefill, model.decode_step = keep_prefill, keep_decode

        def submit(self, req):
            before = len(req.generated)
            ok = super().submit(req)
            if len(req.generated) > before:
                self.margins.setdefault(req.rid, []).append(
                    top2_gap(self.last[0]))
            return ok

        def step(self):
            active = list(self.active)
            ran = super().step()
            for slot, req in enumerate(active):
                if ran and req is not None:
                    self.margins.setdefault(req.rid, []).append(
                        top2_gap(self.last[slot]))
            return ran
    return Margins


def test_serve_lm_matches_jax(monkeypatch):
    jex, mine = load("examples/serve_lm.py"), load(
        "examples/serve_lm_torch.py")
    ref = {}

    class Recording(jex.ContinuousBatcher):
        def __init__(self, model, params, cfg, **kw):
            ref["params"] = params
            super().__init__(model, params, cfg, **kw)

        def run(self, requests, *a, **k):
            ref["requests"] = requests
            ref["stats"] = super().run(requests, *a, **k)
            return ref["stats"]

    monkeypatch.setattr(jex, "ContinuousBatcher", Recording)
    _, said = captured(jex.main)
    tree = jax.tree_util.tree_map(
        lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32)),
        ref["params"])
    monkeypatch.setattr(mine, "get_model", lambda cfg: (
        lambda cfg, device, seed: lm_params_from_numpy(cfg, tree,
                                                       device=device)))
    batchers = []
    monkeypatch.setattr(mine, "ContinuousBatcher", margin_batcher(
        mine.ContinuousBatcher, batchers))
    got, printed = captured(mine.main, CPU)

    mine_reqs = mine.make_requests(reduced_config("qwen3-32b").vocab_size,
                                   12, (4, 24), (4, 16))
    assert len(ref["requests"]) == len(mine_reqs) == 12
    for a, b in zip(ref["requests"], mine_reqs):
        np.testing.assert_array_equal(a.prompt, b.prompt)
        assert a.max_new_tokens == b.max_new_tokens
    assert got["stats"] == vars(ref["stats"])
    head = re.search(r"served .* tokens,", said)[0]
    assert head in printed
    margins = batchers[0].margins
    for r in ref["requests"]:
        own = got["generated"][r.rid]
        assert len(own) == len(r.generated) == r.max_new_tokens
        parted = next((i for i, (a, b) in enumerate(zip(own, r.generated))
                       if a != b), None)
        if parted is not None:
            assert margins[r.rid][parted] < TOL_LOGITS, (r.rid, parted)


def test_cluster_matches_jax(jax_cluster):
    got, printed = captured(load("examples/pagerank_cluster_torch.py").main,
                            CPU)
    assert "recovered run bit-exact with clean run: True" in printed
    assert got["shards"] == 8 and got["restarts"] == 2 and got["exact"]
    np.testing.assert_array_equal(got["pi_recovered"], got["pi_clean"])
    proc, where = jax_cluster
    _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-3000:]
    np.testing.assert_array_equal(got["pi_clean"], np.load(where))


def test_train_lm_matches_jax_train_step(tmp_path):
    """The example at the reduced Qwen2-7B's widths resumes JAX's init,
    saved as JAX's `run_training` saves a snapshot, and trains 3 steps;
    JAX's jitted train step takes the same 3 steps on the same batches."""
    jcfg = jax_reduced_config("qwen2-7b")
    jmodel = jax_get_model(jcfg)
    params = jax.jit(lambda k: jmodel.init_params(jcfg, k)[0])(
        jax.random.PRNGKey(0))
    adam = JAdamWConfig(lr=1e-3)
    opt = jax_init_state(params, adam)
    JCheckpointer(str(tmp_path)).save(0, dict(params=params, opt=opt),
                                      blocking=True)
    jstep = jax.jit(jax_make_train_step(jcfg, jmodel, adam,
                                        num_microbatches=2,
                                        loss_kwargs=dict(q_chunk=64)))
    data = JSyntheticTokens(JDataConfig(vocab_size=jcfg.vocab_size,
                                        seq_len=128, global_batch=4))
    jlosses = []
    for i in range(3):
        b = data.batch_at(i)
        params, opt, m = jstep(params, opt, dict(
            tokens=jnp.asarray(b["tokens"]), labels=jnp.asarray(b["labels"])))
        jlosses.append(float(m["loss"]))

    got, printed = captured(load("examples/train_lm_torch.py").main, [
        "--reduced", "--steps", "3", "--checkpoint-dir", str(tmp_path)]
        + CPU)
    assert "[train] restored step 0" in printed
    assert got["losses"] == pytest.approx(jlosses, rel=TOL_LOSS)


def test_audit_script_exit_codes(tmp_path, monkeypatch):
    script = load("scripts/audit_engines_torch.py")
    out = tmp_path / "AUDIT.json"
    report, printed = captured(script.main, [
        "--shards", "8", "--no-telemetry", "--strict", "--out", str(out)]
        + CPU)
    assert "total violations: 0 — PASS" in printed
    saved = json.loads(out.read_text())
    assert saved["ok"] and saved["devices"] == 8 and report["ok"]
    assert sorted(saved["engines"]) == ["counts", "directed", "improved",
                                        "ppr", "walks"]

    bad = copy.deepcopy(saved)
    bad["engines"]["walks"]["violations"].append(dict(
        engine="walks", kind="budget/lanes", where="route",
        message="lanes over budget"))
    bad.update(violations_total=1, ok=False)
    monkeypatch.setattr(congest, "audit_all_engines", lambda *a, **k: bad)
    argv = ["--out", str(tmp_path / "bad.json")] + CPU
    line = "VIOLATION [walks] budget/lanes at route: lanes over budget"
    with pytest.raises(SystemExit) as e:
        captured(script.main, argv + ["--strict"])
    assert e.value.code == 1
    report, printed = captured(script.main, argv)
    assert line in printed and "FAIL" in printed and not report["ok"]
    assert not json.loads((tmp_path / "bad.json").read_text())["ok"]


def test_profile_train_step_counts():
    """The training example's step profiled at the reduced widths: its
    bytes are the bf16 weights and the float32 master, m and v, each read
    and written once (28 bytes a parameter, the state's padding aside),
    and its bound the larger of its two times."""
    script = load("scripts/profile_train_step_torch.py")
    got, printed = captured(script.main, [
        "--reduced", "--warmup", "1", "--steps", "1"] + CPU)
    assert got["bytes"] == pytest.approx(28 * got["params"], rel=2e-2)
    assert got["bound_ms"] == pytest.approx(1e3 * max(
        got["flops"] / script.PEAK_FLOPS, got["bytes"] / script.PEAK_BYTES_S))
    assert got["flops"] > 0 and got["ops"] > 0 and got["kernels"] is None
    assert "dispatched operators" in printed


@pytest.mark.parametrize("path", PORT_FILES)
def test_needs_a_card_or_cpu(path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        load(path).main([])
    assert "no CUDA device is available" in str(e.value.code)
