"""The port's CONGEST auditor and lints against the JAX package's.

The lints run in process on small recorded programs, twins of the
in-process lint tests of tests/test_congest_audit.py; `schema_lint` and
`classify_resume` are also held to the JAX functions on the same inputs.
Negative controls each plant one fault in a recorded program and must be
flagged with its own kind. The parity test runs the JAX auditor once, in
a forced-8-device subprocess, and the port's `audit_all_engines` on 8
stacked CPU shards.

Parity levels:
  * bit-exact: every wire-table row (stage, program, site, width, lanes,
    budget, capacity and budget bytes, recorded payload against the JAX
    trace's payload, wire class, formula), the resume classes,
    W-independence, the telemetry checks field by field (the engine runs
    are bit-exact, so bytes and entries are equal, not only consistent),
    and 0 violations on both sides;
  * bounded only: the psums. The port sums some control counters in
    int64 (`core/distributed_improved.py`, `_p2_local`'s stats), so its
    psums move 8 B where JAX's move 4 B; both stay at most 256 B.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro.analysis.lint import classify_resume as j_classify_resume
from repro.analysis.lint import schema_lint as j_schema_lint

from conftest import run_forced_devices
from repro_torch import prng
from repro_torch.analysis.congest import (PSUM_CONTROL_BYTES,
                                          RecordingMesh, audit_all_engines,
                                          audit_engine_spec, audit_program,
                                          pinned_superstep)
from repro_torch.analysis.lint import (classify_resume, dtype_lint,
                                       funnel_mode, rng_lint, schema_lint)
from repro_torch.core.accounting import (EngineAuditSpec, ExchangeSite,
                                         StageProgram)
from repro_torch.core.collectives import StackedMesh
from repro_torch.core.distributed import audit_spec as walks_audit_spec
from repro_torch.graphs import erdos_renyi

KEY = prng.PRNGKey(3)
ENGINES = ["counts", "directed", "improved", "ppr", "walks"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small tensor ops: under parallel test workers torch's thread
    pool oversubscribes the cores; one thread keeps serial speed."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _record(fn, shards=1):
    """Run `fn(mesh)` as one call of a program of a recording mesh;
    returns (the call, the mesh)."""
    mesh = RecordingMesh(shards, "cpu")
    with mesh.program("toy", "p") as call:
        fn(mesh)
    return call, mesh


# ---------------------------------------------------------------------------
# RNG-key discipline
# ---------------------------------------------------------------------------

def test_rng_lint_flags_key_reuse():
    call, _ = _record(lambda m: prng.uniform(KEY, (4,))
                      + prng.uniform(KEY, (4,)))
    findings, consumed = rng_lint(call.rng, where="bad")
    assert consumed >= 2
    assert any(f.severity == "violation" for f in findings)


def test_rng_lint_accepts_split_discipline():
    def good(mesh):
        k1, k2 = prng.split(KEY)
        return prng.uniform(k1, (4,)) + prng.uniform(k2, (4,))

    call, _ = _record(good)
    findings, consumed = rng_lint(call.rng, where="good")
    assert findings == []
    assert consumed >= 3  # the split itself + one draw per sub-key


def test_rng_lint_fold_in_derives_fresh_lineage():
    call, _ = _record(lambda m: prng.uniform(prng.fold_in(KEY, 1), (4,))
                      + prng.uniform(prng.fold_in(KEY, 2), (4,)))
    findings, _ = rng_lint(call.rng, where="fold")
    assert findings == []


def test_rng_lint_zero_consumption_means_rng_free():
    call, _ = _record(lambda m: torch.arange(4, dtype=torch.int32) * 2)
    findings, consumed = rng_lint(call.rng)
    assert findings == [] and consumed == 0


# ---------------------------------------------------------------------------
# dtype funnels
# ---------------------------------------------------------------------------

def _funnel_sum():
    sink = set()
    with funnel_mode(sink):
        torch.arange(8, dtype=torch.int32).to(torch.float32).sum()
    return sink


def test_dtype_lint_flags_overflowing_funnel():
    bad = [v for v in dtype_lint(_funnel_sum(), count_bound=2 ** 25,
                                 where="f")
           if v.severity == "violation"]
    assert len(bad) == 1 and "2^24" in bad[0].message


def test_dtype_lint_accepts_bounded_counts():
    sink = _funnel_sum()
    assert [v for v in dtype_lint(sink, count_bound=1000)
            if v.severity == "violation"] == []
    # and with no declared bound the funnel is at most a note
    assert [v for v in dtype_lint(sink) if v.severity == "violation"] == []


# ---------------------------------------------------------------------------
# elastic schema and resume classes, against the JAX functions
# ---------------------------------------------------------------------------

def test_schema_lint_both_directions():
    spec = types.SimpleNamespace(kind="vertex")
    cases = [({"s": ("a", "b")}, {"s": {"a": spec, "b": spec}}),
             ({"s": ("a", "b")}, {"s": {"a": spec}}),
             ({"s": ("a",)}, {"s": {"a": spec, "ghost": spec}}),
             ({"s": ("a",)}, {})]
    ok, missing, dangling, nostage = (schema_lint(*c) for c in cases)
    assert ok == []
    assert len(missing) == 1 and "'b'" in missing[0].message
    assert len(dangling) == 1 and "'ghost'" in dangling[0].message
    assert len(nostage) == 1 and "no LayoutSpec schema" in nostage[0].message
    for c in cases:
        assert [f.to_dict() for f in schema_lint(*c)] == \
            [f.to_dict() for f in j_schema_lint(*c)]


def test_classify_resume_matrix():
    key = types.SimpleNamespace(kind="key")
    rkey = types.SimpleNamespace(kind="replicated_key")
    vert = types.SimpleNamespace(kind="vertex")
    cases = [(0, {"zeta": vert}), (3, {"key": rkey, "zeta": vert}),
             (3, {"key": key, "zeta": vert}), (3, {"zeta": vert})]
    got = [classify_resume("s", n, lay) for n, lay in cases]
    assert got[0][0].startswith("bit-exact") and not got[0][1]
    assert got[1] == ("bit-exact (replicated key)", [])
    assert got[2][0].startswith("statistical") and not got[2][1]
    assert got[3][0] == "unresumable" and len(got[3][1]) == 1
    for (n, lay), (cls, findings) in zip(cases, got):
        j_cls, j_findings = j_classify_resume("s", n, lay)
        assert cls == j_cls
        assert [f.to_dict() for f in findings] == \
            [f.to_dict() for f in j_findings]


# ---------------------------------------------------------------------------
# negative controls: each planted fault flagged with its own kind
# ---------------------------------------------------------------------------

S = 4
LANES = torch.zeros((S, S * 3), dtype=torch.int32)
SITE = ExchangeSite(site="x", entry_nbytes=4, lane_entries=S * 3,
                    budget_entries=S * 3, budget_formula="P * 3")


def _undeclared_all_to_all():
    call, _ = _record(lambda m: m.all_to_all(LANES), S)
    prog = StageProgram(stage="toy", program="p", sites=())
    return audit_program(prog, [call], "toy")[3]


def _tampered_width():
    g = erdos_renyi(96, 5.0, seed=1, device="cpu")
    spec = walks_audit_spec(g, StackedMesh(8, "cpu"))
    p0 = spec.programs[0]
    bad = dataclasses.replace(p0, sites=(dataclasses.replace(
        p0.sites[0], entry_nbytes=8),))
    calls = pinned_superstep(g, 8, "cpu", eps=0.2, stage="walks").calls
    return audit_program(bad, calls, "walks")[3]


def _site_fired_twice():
    def twice(mesh):
        for _ in range(2):
            mesh.all_to_all(LANES)

    call, _ = _record(twice, S)
    prog = StageProgram(stage="toy", program="p", sites=(SITE,))
    return audit_program(prog, [call], "toy")[3]


def _wide_psum():
    call, _ = _record(lambda m: m.psum(torch.zeros((S, 128),
                                                   dtype=torch.int32)), S)
    prog = StageProgram(stage="toy", program="p", sites=())
    return audit_program(prog, [call], "toy")[3]


def _gather_inside_program():
    call, _ = _record(lambda m: m.gather_rows(LANES), S)
    prog = StageProgram(stage="toy", program="p", sites=())
    return audit_program(prog, [call], "toy")[3]


def _processes_differ():
    from repro_torch.analysis.congest import _merge_processes
    mine = dict(engine="toy", sites=[dict(site="a", lane_entries=4)],
                violations=[])
    other = dict(mine, sites=[dict(site="a", lane_entries=5)])
    return [types.SimpleNamespace(**v) for v in
            _merge_processes([mine, other])["violations"]]


def _all_to_all_outside_programs():
    mesh = RecordingMesh(S, "cpu")
    mesh.all_to_all(LANES)
    spec = EngineAuditSpec(engine="toy", programs=[], stage_arrays={},
                           layouts={})
    return [types.SimpleNamespace(**v) for v in audit_engine_spec(
        spec, mesh.calls, unscoped=mesh.unscoped)["violations"]]


@pytest.mark.parametrize("plant,kind", [
    (_undeclared_all_to_all, "budget/site-count"),
    (_tampered_width, "budget/payload"),
    (_site_fired_twice, "budget/loop"),
    (_wide_psum, "budget/psum"),
    (_all_to_all_outside_programs, "budget/unscoped"),
    (_gather_inside_program, "budget/gather"),
    (_processes_differ, "budget/ranks-differ"),
], ids=lambda x: getattr(x, "__name__", x))
def test_auditor_catches_violations(plant, kind):
    kinds = {v.kind for v in plant()}
    assert kind in kinds, kinds


def test_psum_control_limit_is_the_jax_one():
    from repro.analysis.congest import PSUM_CONTROL_BYTES as j_limit
    assert PSUM_CONTROL_BYTES == j_limit == 256


# ---------------------------------------------------------------------------
# parity: the full audit of both packages at 8 shards
# ---------------------------------------------------------------------------

JAX_AUDIT = """
import json
from repro.analysis.congest import audit_all_engines
print(json.dumps(audit_all_engines()))
"""


@pytest.fixture(scope="module")
def reports():
    jax_report = run_forced_devices(JAX_AUDIT, devices=8)
    port_report = audit_all_engines(StackedMesh(8, "cpu"))
    return jax_report, port_report


def test_full_audit_clean_on_both(reports):
    j, p = reports
    assert j["ok"] and p["ok"], p["violations_total"]
    assert j["violations_total"] == p["violations_total"] == 0
    assert sorted(j["engines"]) == sorted(p["engines"]) == ENGINES
    assert (j["devices"], j["eps"], j["walks_per_node"]) == \
        (p["devices"], p["eps"], p["walks_per_node"])


@pytest.mark.parametrize("engine", ENGINES)
def test_engine_report_matches_jax(reports, engine):
    j, p = (r["engines"][engine] for r in reports)
    want = []
    for row in j["sites"]:
        row = dict(row)
        row["recorded_payload_bytes"] = row.pop("traced_payload_bytes")
        want.append(row)
    assert p["sites"] == want
    assert p["resume"] == j["resume"]
    assert p["w_independent"] == j["w_independent"] is True
    assert p["telemetry"] == j["telemetry"]
    assert p["telemetry"]["ok"]
    assert p["violations"] == j["violations"] == []
    assert p["meta"] == j["meta"]
    assert p["fixture"] == j["fixture"]
    # psums are control state: bounded, not equal (see the module doc)
    assert p["psum_max_bytes"] <= PSUM_CONTROL_BYTES
    assert j["psum_max_bytes"] <= PSUM_CONTROL_BYTES


def test_resume_classes_are_the_jax_gate(reports):
    """The classes tests/test_congest_audit.py asserts for JAX."""
    eng = reports[1]["engines"]
    assert eng["counts"]["resume"]["counts"] == "bit-exact (replicated key)"
    assert eng["improved"]["resume"]["phase2"] == \
        eng["improved"]["resume"]["phase3"] == \
        eng["directed"]["resume"]["phase2"] == "bit-exact (RNG-free)"
    assert eng["improved"]["resume"]["phase1"].startswith("statistical")
    assert eng["walks"]["resume"]["walks"].startswith("statistical")
    assert eng["ppr"]["resume"]["serve"].startswith("statistical")
    assert np.all([eng[k]["w_independent"] for k in ENGINES])
