"""The port's launch CLI (`repro_torch.launch.pagerank`) on the CPU.

Parity levels:
  * `run()` at one shard against the JAX package's `run()` at one device
    (the in-process JAX has one CPU device) — pi bit-exact, every algo;
  * `fail_at` recovery and `--resume` after a kill — pi bit-exact with the
    uninterrupted run;
  * `--resume` with `--shards` unlike the snapshot's (killed at 8 shards)
    — pi bit-exact with the JAX launcher resuming the same directory at
    one device;
  * the accuracy gate (`check=True`) at 4 shards — statistical: L1 < 0.15
    and top-10 >= 0.6 against power iteration.
`--algo improved|directed` run the three-phase engines on the CPU and
print their telemetry; `--fail-at` and `--resume` give their pi bit for
bit. `--algo ppr` gives the JAX launcher's `run_ppr` matrix bit for bit
at one shard and refuses `--check` above n = 4096 (a dense solve per
query). `--audit --device cpu` prints the wire table, writes AUDIT.json
with all five engines and exits 0 (its parity with the JAX report is
tests/test_torch_congest_audit.py's job).
"""
import json
import shutil

import numpy as np
import pytest
import torch

from repro.launch.pagerank import run as jax_run

from repro_torch.launch.pagerank import main, run
from repro_torch.runtime import SimulatedFailure

ARGS = (128, 0.2, 16, "directed_web")


@pytest.mark.parametrize("algo", ["walks", "counts", "improved",
                                  "directed"])
def test_run_matches_jax_launcher(algo):
    want = jax_run(*ARGS, None, [], seed=3, algo=algo, shards=1)
    got = run(*ARGS, None, [], seed=3, algo=algo, shards=1, device="cpu")
    np.testing.assert_array_equal(got.pi, np.asarray(want))


@pytest.mark.parametrize("algo", ["walks", "counts"])
def test_run_check_and_fail_at(tmp_path, algo):
    a = run(*ARGS, None, [], algo=algo, check=True, shards=4, device="cpu")
    assert a.l1 < 0.15 and a.topk >= 0.6 and a.shards == 4
    b = run(*ARGS, str(tmp_path), [4, 9], algo=algo, check=True, shards=4,
            device="cpu")
    assert a.restarts == 0 and b.restarts == 2
    np.testing.assert_array_equal(a.pi, b.pi)
    assert a.rounds == b.rounds


@pytest.mark.parametrize("algo", ["walks", "counts"])
def test_resume_after_kill(tmp_path, algo):
    a = run(*ARGS, None, [], algo=algo, shards=3, device="cpu")
    with pytest.raises(SimulatedFailure):
        run(*ARGS, str(tmp_path), [12], algo=algo, shards=3,
            max_restarts=0, device="cpu")
    b = run(*ARGS, str(tmp_path), [], algo=algo, shards=3, resume=True,
            device="cpu")
    np.testing.assert_array_equal(a.pi, b.pi)


@pytest.mark.parametrize("algo,shards", [("walks", 1), ("counts", 1),
                                         ("counts", 3)])
def test_resume_at_other_shard_count_matches_jax(tmp_path, algo, shards):
    """A run killed at 8 shards continues at `shards` from its snapshot
    directory: pi bit-exact with the JAX launcher resuming a copy of the
    same directory at one device (the walk state's re-layout and its
    re-derived keys are JAX's; the count engine's trajectory does not
    depend on the shard count)."""
    with pytest.raises(SimulatedFailure):
        run(*ARGS, str(tmp_path / "killed"), [12], algo=algo, shards=8,
            max_restarts=0, device="cpu")
    for name in ("port", "jax"):
        shutil.copytree(tmp_path / "killed", tmp_path / name)
    got = run(*ARGS, str(tmp_path / "port"), [], algo=algo, shards=shards,
              resume=True, device="cpu")
    want = jax_run(*ARGS, str(tmp_path / "jax"), [], algo=algo, shards=1,
                   resume=True)
    assert got.shards == shards and got.restarts == 0
    np.testing.assert_array_equal(got.pi, np.asarray(want))


def test_resume_needs_checkpoint_dir():
    with pytest.raises(SystemExit, match="--checkpoint-dir"):
        run(*ARGS, None, [], resume=True, device="cpu")


def test_audit_runs_on_the_cpu(capsys, tmp_path, monkeypatch):
    """`--audit` prints the 13-row wire table and PASS, writes AUDIT.json
    in the working directory with `ok` and the five engines, and returns
    (exit 0)."""
    monkeypatch.chdir(tmp_path)
    # many small tensor ops: one thread keeps serial speed under parallel
    # test workers
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        main(["--audit", "--device", "cpu"])
    finally:
        torch.set_num_threads(threads)
    out = capsys.readouterr().out
    assert "CONGEST wire audit — 8 shards" in out
    assert "total violations: 0 — PASS" in out
    rows = [line for line in out.splitlines()
            if line.split()[:1] and line.split()[0] in
            ("walks", "counts", "improved", "directed", "ppr")]
    assert len(rows) == 13
    report = json.loads((tmp_path / "AUDIT.json").read_text())
    assert report["ok"] and report["violations_total"] == 0
    assert sorted(report["engines"]) == ["counts", "directed", "improved",
                                         "ppr", "walks"]


@pytest.mark.parametrize("algo,graph", [("improved", "erdos_renyi"),
                                        ("directed", "directed_web")])
def test_three_phase_algos_run_on_the_cpu(capsys, algo, graph):
    """`--algo improved|directed` run the three-phase engines and print
    the JAX launcher's telemetry lines; `--check` gates on accuracy."""
    main(["--device", "cpu", "--shards", "8", "--n", "128", "--walks", "16",
          "--algo", algo, "--graph", graph, "--check"])
    out = capsys.readouterr().out
    assert f"algo={algo} n=128 shards=8" in out and "report=0" in out
    assert "p3=1" in out and "coupons created=" in out
    assert "dropped=0" in out and "residual=0" in out
    assert ("uniform budget=" in out) == (algo == "directed")
    assert "L1 vs power-iter" in out


@pytest.mark.parametrize("algo", ["improved", "directed"])
def test_three_phase_fail_at_and_resume(tmp_path, algo):
    """Recovery from injected failures, and a cold resume of a killed run,
    give the uninterrupted run's pi bit for bit."""
    args = (64, 0.2, 8, "directed_web")
    a = run(*args, None, [], algo=algo, shards=3, device="cpu")
    b = run(*args, None, [2, 7], algo=algo, shards=3, device="cpu")
    assert b.restarts == 2 and b.rounds == a.rounds
    np.testing.assert_array_equal(a.pi, b.pi)
    with pytest.raises(SimulatedFailure):
        run(*args, str(tmp_path), [6], algo=algo, shards=3, max_restarts=0,
            device="cpu")
    c = run(*args, str(tmp_path), [], algo=algo, shards=3, resume=True,
            device="cpu")
    np.testing.assert_array_equal(a.pi, c.pi)


def test_main_runs_on_the_cpu(capsys):
    main(["--device", "cpu", "--shards", "8", "--n", "64", "--walks", "8",
          "--algo", "counts", "--graph", "directed_web"])
    out = capsys.readouterr().out
    assert "algo=counts n=64 shards=8" in out and "residual=0" in out
    assert "L1 vs power-iter" in out


def test_ppr_matches_jax_launcher(capsys):
    """`--algo ppr` at one shard: the [queries, n] estimator matrix of the
    JAX launcher's `run_ppr`, bit for bit, each query checked against its
    own exact_ppr."""
    args = (96, 0.2, 20, "directed_web", None, [])
    want = jax_run(*args, seed=5, algo="ppr", num_queries=3, shards=1)
    got = run(*args, seed=5, algo="ppr", num_queries=3, shards=1,
              check=True, device="cpu")
    assert got.shape == (3, 96)
    np.testing.assert_array_equal(got, np.asarray(want))
    main(["--device", "cpu", "--shards", "4", "--n", "96", "--walks", "20",
          "--algo", "ppr", "--queries", "2", "--graph", "directed_web",
          "--check"])
    out = capsys.readouterr().out
    assert "algo=ppr n=96 shards=4 queries=2 walks/query=1920" in out
    assert "dropped=0 admit_dropped=0" in out
    assert out.count("L1 vs exact_ppr") == 2 + 3 + 3


def test_ppr_check_refused_above_dense_limit():
    with pytest.raises(SystemExit, match="above 4096") as e:
        main(["--device", "cpu", "--n", "4097", "--walks", "1", "--algo",
              "ppr", "--check"])
    assert e.value.code != 0
