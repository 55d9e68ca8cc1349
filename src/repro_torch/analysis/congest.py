"""CONGEST auditor: per-call wire-budget verification of the sharded engines.

The paper's efficiency theorems are statements about per-round wire: in
CONGEST every edge carries B = polylog(n) bits per round, and Lemma 1 is
what makes the walk phases fit: counts of anonymous walks are exchanged,
so the payload is bounded by *distinct vertices*, never by the walk
multiplicity W. The engines encode that bound in their lane sizing; this
module checks it against the collectives the engines launch.

The JAX package traces each stage program to a jaxpr. The port has no
trace, so it RUNS each engine on a fixture graph under a `RecordingMesh`:

  1. Every engine runs the programs of its stages inside
     `mesh.program(stage, name)`; the recording mesh, which wraps a
     stacked mesh or a process group's, keeps, for each program call,
     every all_to_all, psum and pmax with its bytes per shard
     (`x.numel() // S * x.element_size()`, from shapes, no device sync)
     and its call path (the source lines from the collective up).
  2. Each engine's `audit_spec(graph, mesh, ...)` declares its programs,
     with one `ExchangeSite` per all_to_all a call must launch, carrying
     the per-entry width and a W-free lane budget.
  3. The budget checks, on every call of every declared program: its
     all_to_all sites equal the declared ones in number and order
     (`budget/site-count`); no site runs twice in one call
     (`budget/loop`: the same call path recorded twice); each moves
     exactly `lane_entries * entry_nbytes` bytes (`budget/payload`);
     its lane count fits the declared budget (`budget/exceeded`). psums
     and pmaxes are control-plane and stay under `PSUM_CONTROL_BYTES`
     (`budget/psum`). A collective outside every program
     (`budget/unscoped`), a program the spec does not declare
     (`budget/undeclared-program`) and a declared count-class program
     the run never called (`budget/not-run`) are violations too. The
     mesh's only other data motion, `gather_rows`, serves result reads
     and snapshots between rounds; inside a program it is a violation
     (`budget/gather`), so all data motion of a round is on the checked
     wire.
  4. Walk-class sites (`route`, `tail`) have runtime lane caps that scale
     with W/P. The spec pins them at P * n_loc, as JAX's does; the
     auditor runs one extra superstep at route_cap = n_loc, on a state
     of one walk per owned vertex, and holds it to the pinned
     declaration, while the engine run's own calls are held to their
     runtime capacity, P * route_cap * 4 B.
  5. W-independence: the spec is rebuilt at 2x the walk multiplicity and
     every site must declare the identical budget.
  6. Telemetry cross-check: each engine's runtime byte counters must
     equal its runtime entry counters times the declared widths.

The lints (`analysis.lint`) read the same run: RNG-key uses and
int->float funnels recorded within each program call, and the elastic
schema. What this cannot see: a reduction over the stacked shard
dimension done outside the mesh (a whole-tensor sum, a host read of all
shards) is plain tensor code here; under a one-shard-per-rank backend it
would have to become a collective. No engine has one left: each runs
under a `ProcessGroupMesh` as well.

The psum bound: `ProcessGroupMesh.psum` reduces int32 as int64 unless
the caller names the wire's dtype, so the engines hand it int64 or name
int32, and the recorded bytes are the wire's. The PPR superstep psums
the live walks of each query as int32 [Q], 4Q bytes, as JAX's does (256 B
at Q = 64), and the round's entries, bytes and dropped walks in a second
psum, int64 [3]; its admission psums one int64.

Over a process group, each process records its own shard's program calls
and audits them against the same spec; `audit_all_engines` then merges
the processes' reports, and flags any row on which they differ
(`budget/ranks-differ`).

`launch/pagerank.py --audit` drives `audit_all_engines` and renders
`format_wire_table` and AUDIT.json.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import sys
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import prng
from repro_torch.analysis.lint import (LintFinding, classify_resume,
                                       dtype_lint, funnel_mode, rng_lint,
                                       schema_lint)
from repro_torch.core.accounting import EngineAuditSpec, StageProgram
from repro_torch.core.collectives import StackedMesh

__all__ = [
    "PSUM_CONTROL_BYTES", "CollectiveCall", "ProgramCall", "AuditViolation",
    "RecordingMesh", "audit_program", "audit_engine_spec",
    "check_w_independence", "audit_all_engines", "format_wire_table",
    "ENGINES",
]

# psums move O(1) scalars / tiny per-bucket vectors of control state
# (active counters, conservation tripwires, occupancy) — bounded by a
# constant, not by n or W.
PSUM_CONTROL_BYTES = 256
_PATH_DEPTH = 16     # source frames kept of a collective's call path


@dataclasses.dataclass(frozen=True)
class CollectiveCall:
    """One collective launched through the mesh."""

    prim: str                 # all_to_all | psum | pmax | gather
    payload_bytes: int        # bytes per shard of the operand
    path: Tuple[str, ...]     # "file:line" frames from the call up


@dataclasses.dataclass
class ProgramCall:
    """What one call of a program launched and consumed."""

    stage: str
    program: str
    collectives: List[CollectiveCall] = dataclasses.field(
        default_factory=list)
    rng: List[Tuple[Tuple[int, int], str]] = dataclasses.field(
        default_factory=list)
    funnels: set = dataclasses.field(default_factory=set)


@dataclasses.dataclass(frozen=True)
class AuditViolation:
    engine: str
    kind: str            # "budget/..." | "lint/rng" | "lint/dtype" | ...
    where: str           # "stage/program" (or stage for schema findings)
    message: str

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _call_path() -> Tuple[str, ...]:
    f = sys._getframe(3)          # the caller of all_to_all / psum
    path = []
    while f is not None and len(path) < _PATH_DEPTH:
        path.append(f"{f.f_code.co_filename}:{f.f_lineno}")
        f = f.f_back
    return tuple(path)


class RecordingMesh:
    """A mesh that records every program call and the collectives it
    launches (`calls`), and the collectives outside every program
    (`unscoped`), then runs them on the mesh it wraps: `mesh`, or a
    `StackedMesh` of `mesh` shards on `device`. With `lints`, each call
    also records its PRNG key uses (`prng.RNG_RECORDER`) and its
    int->float funnels (`funnel_mode`)."""

    def __init__(self, mesh, device=None, *, lints: bool = True):
        self.inner = (StackedMesh(mesh, device) if isinstance(mesh, int)
                      else mesh)
        self.shards, self.device = self.inner.shards, self.inner.device
        self.lints = lints
        self.calls: List[ProgramCall] = []
        self.unscoped: List[CollectiveCall] = []
        self._open: Optional[ProgramCall] = None

    @contextlib.contextmanager
    def program(self, stage: str, name: str):
        if self._open is not None:
            raise RuntimeError(
                f"program {stage}/{name} opened inside "
                f"{self._open.stage}/{self._open.program}")
        call = ProgramCall(stage, name)
        self.calls.append(call)
        self._open = call
        saved = prng.RNG_RECORDER
        try:
            if self.lints:
                prng.RNG_RECORDER = lambda words, what: call.rng.append(
                    (words, what))
                with funnel_mode(call.funnels):
                    yield call
            else:
                yield call
        finally:
            self._open = None
            prng.RNG_RECORDER = saved

    def _record(self, prim: str, x: torch.Tensor, dtype=None) -> None:
        width = (x.element_size() if dtype is None
                 else torch.empty((), dtype=dtype).element_size())
        rec = CollectiveCall(prim=prim,
                             payload_bytes=x.numel() // x.shape[0] * width,
                             path=_call_path())
        if self._open is None:
            self.unscoped.append(rec)
        else:
            self._open.collectives.append(rec)

    def __getattr__(self, name):
        # the mesh's other members (shard_ids, local_rows, barrier, ...)
        return getattr(self.inner, name)

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        self._record("all_to_all", x)
        return self.inner.all_to_all(x)

    def psum(self, x: torch.Tensor, dtype=None) -> torch.Tensor:
        self._record("psum", x, dtype)
        return self.inner.psum(x, dtype)

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        self._record("pmax", x)
        return self.inner.pmax(x)

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        if self._open is not None:
            self._record("gather", x)
        return self.inner.gather_rows(x)


# ---------------------------------------------------------------------------
# the budget checks
# ---------------------------------------------------------------------------

def audit_program(prog: StageProgram, calls: Sequence[ProgramCall],
                  engine: str, *, lanes: Optional[Dict[str, int]] = None
                  ) -> Tuple[List[Optional[int]], int, int,
                             List[AuditViolation]]:
    """Hold every recorded call of one program to its declared
    `ExchangeSite`s. `lanes` overrides a site's declared lane count for
    the payload check (the runtime capacity of a walk-class site).

    Returns (the first call's bytes per shard of each declared site, None
    where it launched none; the most psums of one call; the largest psum
    in bytes; the violations, each once)."""
    where = f"{prog.stage}/{prog.program}"
    out: Dict[Tuple[str, str], AuditViolation] = {}

    def flag(kind, message):
        out.setdefault((kind, message), AuditViolation(
            engine=engine, kind=kind, where=where, message=message))

    for site in prog.sites:
        if site.lane_entries > site.budget_entries:
            flag("budget/exceeded",
                 f"site '{site.site}' lane capacity {site.lane_entries} "
                 f"exceeds its W-free budget {site.budget_entries} "
                 f"({site.budget_formula})")
    recorded: List[Optional[int]] = [None] * len(prog.sites)
    psums = psum_max = 0
    for i, call in enumerate(calls):
        a2a = [c for c in call.collectives if c.prim == "all_to_all"]
        runs = collections.Counter(c.path for c in a2a)
        sites_run = list({c.path: c for c in a2a}.values())
        if len(sites_run) != len(prog.sites):
            flag("budget/site-count",
                 f"a call launched {len(sites_run)} all_to_all sites but "
                 f"{len(prog.sites)} are declared "
                 f"({[s.site for s in prog.sites]})")
        for j, (c, site) in enumerate(zip(sites_run, prog.sites)):
            if runs[c.path] != 1:
                flag("budget/loop",
                     f"site '{site.site}' ({c.path[0]}) ran {runs[c.path]} "
                     f"times in one call — a per-round budget only bounds "
                     f"a collective that runs once per program call")
            n_lanes = (lanes or {}).get(site.site, site.lane_entries)
            expected = n_lanes * site.entry_nbytes
            if c.payload_bytes != expected:
                flag("budget/payload",
                     f"site '{site.site}' recorded payload is "
                     f"{c.payload_bytes} B but the declaration says "
                     f"{n_lanes} lanes x {site.entry_nbytes} B = "
                     f"{expected} B")
            if i == 0:
                recorded[j] = c.payload_bytes
        ps = [c for c in call.collectives if c.prim in ("psum", "pmax")]
        psums = max(psums, len(ps))
        for c in ps:
            psum_max = max(psum_max, c.payload_bytes)
            if c.payload_bytes > PSUM_CONTROL_BYTES:
                flag("budget/psum",
                     f"a {c.prim} ({c.path[0]}) moves {c.payload_bytes} B "
                     f"— control psums must stay under "
                     f"{PSUM_CONTROL_BYTES} B (data belongs on the counted "
                     f"all_to_all wire)")
        for c in call.collectives:
            if c.prim == "gather":
                flag("budget/gather",
                     f"a gather of {c.payload_bytes} B a shard "
                     f"({c.path[0]}) inside a program moves data off the "
                     f"checked wire")
    return recorded, psums, psum_max, list(out.values())


def _lint_to_violation(engine: str, f: LintFinding) -> AuditViolation:
    return AuditViolation(engine=engine, kind=f"lint/{f.lint}",
                          where=f.where, message=f.message)


def _by_program(calls: Sequence[ProgramCall]
                ) -> Dict[Tuple[str, str], List[ProgramCall]]:
    out: Dict[Tuple[str, str], List[ProgramCall]] = {}
    for c in calls:
        out.setdefault((c.stage, c.program), []).append(c)
    return out


def audit_engine_spec(spec: EngineAuditSpec, calls: Sequence[ProgramCall],
                      *, unscoped: Sequence[CollectiveCall] = (),
                      pinned: Optional[Sequence[ProgramCall]] = None,
                      walk_lanes: Optional[Dict[str, int]] = None,
                      lints: bool = True) -> Dict[str, Any]:
    """Audit one engine's recorded run (`calls`, `unscoped`) against its
    spec: the budget checks, and with `lints` the RNG, dtype and schema
    lints and the resume classification.

    Walk-class sites: the run's own calls are held to `walk_lanes` (site
    -> runtime lanes a shard), and, where `pinned` is given, the calls of
    the auditor's pinned superstep to the declaration; the site rows then
    show the pinned call's bytes."""
    engine = spec.engine
    violations: List[AuditViolation] = []
    notes: List[dict] = []
    site_rows: List[dict] = []
    rng_by_stage: Dict[str, int] = {}
    psum_sites = psum_max = 0

    run = _by_program(calls)
    held = _by_program(pinned or ())
    declared = {(p.stage, p.program) for p in spec.programs}
    for stage, program in sorted((set(run) | set(held)) - declared):
        violations.append(AuditViolation(
            engine=engine, kind="budget/undeclared-program",
            where=f"{stage}/{program}",
            message="the engine ran a program its audit_spec does not "
                    "declare, so its wire is unchecked"))
    for c in unscoped:
        violations.append(AuditViolation(
            engine=engine, kind="budget/unscoped", where=c.path[0],
            message=f"{c.prim} of {c.payload_bytes} B a shard outside "
                    f"every program"))

    for prog in spec.programs:
        key = (prog.stage, prog.program)
        where = f"{prog.stage}/{prog.program}"
        walk = any(s.wire_class == "walk" for s in prog.sites)
        if not run.get(key) and not walk:
            # (a walk-class program runs as the data needs: the tail only
            # when pools run dry; the pinned call holds its declaration)
            violations.append(AuditViolation(
                engine=engine, kind="budget/not-run", where=where,
                message="the engine run never called this program"))
        recorded, ps, pmax, vs = audit_program(
            prog, run.get(key, []), engine,
            lanes=walk_lanes if walk else None)
        violations.extend(vs)
        psum_sites += ps
        psum_max = max(psum_max, pmax)
        uses = run.get(key, [])
        if walk and pinned is not None:
            if not held.get(key):
                violations.append(AuditViolation(
                    engine=engine, kind="budget/not-run", where=where,
                    message="no pinned call holds the walk-class "
                            "declaration"))
            recorded, ps, pmax, vs = audit_program(prog, held.get(key, []),
                                                   engine)
            violations.extend(vs)
            psum_max = max(psum_max, pmax)
            uses = uses + held.get(key, [])

        if lints:
            consumed = 0
            for call in uses:
                findings, n = rng_lint(call.rng, where=where)
                violations.extend(_lint_to_violation(engine, f)
                                  for f in findings)
                consumed = max(consumed, n)
            rng_by_stage[prog.stage] = rng_by_stage.get(prog.stage, 0) \
                + consumed
            funnels = set().union(*(c.funnels for c in uses))
            for f in dtype_lint(funnels, count_bound=prog.count_bound,
                                where=where):
                if f.severity == "violation":
                    violations.append(_lint_to_violation(engine, f))
                else:
                    notes.append(f.to_dict())

        for site, nbytes in zip(prog.sites, recorded):
            site_rows.append(dict(
                stage=prog.stage, program=prog.program, site=site.site,
                entry_nbytes=site.entry_nbytes,
                lane_entries=site.lane_entries,
                budget_entries=site.budget_entries,
                capacity_bytes=site.capacity_bytes,
                budget_bytes=site.budget_bytes,
                recorded_payload_bytes=nbytes,
                wire_class=site.wire_class,
                budget_formula=site.budget_formula, note=site.note))

    resume: Dict[str, str] = {}
    if lints:
        violations.extend(_lint_to_violation(engine, f)
                          for f in schema_lint(spec.stage_arrays,
                                               spec.layouts))
        for stage in spec.stage_arrays:
            cls, findings = classify_resume(stage, rng_by_stage.get(stage, 0),
                                            spec.layouts.get(stage, {}))
            resume[stage] = cls
            violations.extend(_lint_to_violation(engine, f)
                              for f in findings)

    return dict(
        engine=engine, sites=site_rows,
        psum_sites=psum_sites, psum_max_bytes=psum_max,
        rng_consumed_by_stage=rng_by_stage, resume=resume, notes=notes,
        violations=[v.to_dict() for v in violations],
        meta={k: (int(v) if isinstance(v, (np.integer,)) else v)
              for k, v in spec.meta.items()})


def check_w_independence(spec_lo: EngineAuditSpec, spec_hi: EngineAuditSpec
                         ) -> List[AuditViolation]:
    """Rebuild the spec at double the walk multiplicity: every matched site
    must declare the identical W-free budget (lane capacities may grow
    toward the budget — e.g. the phase-1 reply lane saturates at
    n_loc*(max_deg+1) — but must stay within it at both multiplicities)."""
    violations: List[AuditViolation] = []
    lo = [(p.stage, p.program, s) for p in spec_lo.programs for s in p.sites]
    hi = [(p.stage, p.program, s) for p in spec_hi.programs for s in p.sites]
    if [(st, pr, s.site) for st, pr, s in lo] != \
       [(st, pr, s.site) for st, pr, s in hi]:
        violations.append(AuditViolation(
            engine=spec_lo.engine, kind="budget/w-dependence", where="*",
            message="site list changes with walk multiplicity"))
        return violations
    for (stage, program, a), (_, _, b) in zip(lo, hi):
        where = f"{stage}/{program}"
        if (a.entry_nbytes, a.budget_entries, a.budget_formula,
                a.wire_class) != (b.entry_nbytes, b.budget_entries,
                                  b.budget_formula, b.wire_class):
            violations.append(AuditViolation(
                engine=spec_lo.engine, kind="budget/w-dependence",
                where=where,
                message=(f"site '{a.site}' budget changes with walk "
                         f"multiplicity: {a.budget_entries} x "
                         f"{a.entry_nbytes} B -> {b.budget_entries} x "
                         f"{b.entry_nbytes} B — budgets must depend on the "
                         f"partition and polylog(n) only, never on W")))
        if b.lane_entries > b.budget_entries:
            violations.append(AuditViolation(
                engine=spec_lo.engine, kind="budget/w-dependence",
                where=where,
                message=(f"site '{a.site}' lane capacity grows past its "
                         f"budget at 2x walks: {b.lane_entries} > "
                         f"{b.budget_entries}")))
    return violations


# ---------------------------------------------------------------------------
# runtime telemetry cross-check — declared widths vs entry counters
# ---------------------------------------------------------------------------

def _check(name: str, runtime_bytes: int, entries: int, width: int) -> dict:
    return dict(name=name, runtime_bytes=int(runtime_bytes),
                entries=int(entries), entry_nbytes=int(width),
                expected_bytes=int(entries) * int(width),
                ok=int(runtime_bytes) == int(entries) * int(width))


def _site_widths(spec: EngineAuditSpec) -> Dict[str, int]:
    return {s.site: s.entry_nbytes for p in spec.programs for s in p.sites}


def telemetry_checks(engine: str, res: Any, spec: EngineAuditSpec
                     ) -> List[dict]:
    """An engine result's runtime byte counters against its entry counters
    times the declared widths."""
    w = _site_widths(spec)
    if engine == "walks":
        return [_check("route", res.a2a_bytes_total, res.a2a_entries_total,
                       w["route"])]
    if engine == "counts":
        return [_check("counts", res.a2a_bytes_total,
                       res.a2a_entries_total, w["counts"])]
    if engine == "ppr":
        return [_check("ppr", res.a2a_bytes, res.a2a_entries, w["ppr"])]
    wire, ent = res.a2a_bytes_by_phase, res.a2a_entries_by_site
    p1 = (ent.get("phase1_req", 0) * w["phase1_req"]
          + ent.get("phase1_rep", 0) * w["phase1_rep"])
    return [
        dict(name="phase1", runtime_bytes=int(wire.get("phase1", 0)),
             entries=int(ent.get("phase1_req", 0) + ent.get("phase1_rep", 0)),
             entry_nbytes=0, expected_bytes=p1,
             ok=int(wire.get("phase1", 0)) == p1),
        _check("phase2", wire.get("phase2", 0), ent.get("phase2", 0),
               w["phase2"]),
        _check("phase3", wire.get("phase3", 0), ent.get("phase3", 0),
               w["phase3"]),
        _check("tail", wire.get("tail", 0), ent.get("tail", 0), w["tail"]),
        dict(name="report", runtime_bytes=int(wire.get("report", 0)),
             entries=0, entry_nbytes=0, expected_bytes=0,
             ok=int(wire.get("report", 0)) == 0),
    ]


# ---------------------------------------------------------------------------
# the full audit
# ---------------------------------------------------------------------------

ENGINES = ("walks", "counts", "improved", "directed", "ppr")
PPR_QUERIES = [([0], None), ([1, 2], None)]


def _fixture_for(engine: str, device):
    from repro_torch.graphs import directed_web, erdos_renyi
    if engine == "directed":
        return (directed_web(96, 5.0, seed=3, device=device),
                "directed_web(96, 5.0, seed=3)")
    return (erdos_renyi(96, 5.0, seed=1, device=device),
            "erdos_renyi(96, 5.0, seed=1)")


def spec_for(engine: str, graph, mesh, *, eps: float, K: int,
             **kw) -> EngineAuditSpec:
    """The engine's audit spec, `kw` passed on; the PPR engine gets 4K
    walks a query unless `kw` says otherwise, as the JAX auditor gives
    it."""
    if engine == "walks":
        from repro_torch.core.distributed import audit_spec
        return audit_spec(graph, mesh, eps=eps, walks_per_node=K)
    if engine == "counts":
        from repro_torch.core.distributed_counts import audit_spec
        return audit_spec(graph, mesh, eps=eps, walks_per_node=K, **kw)
    if engine == "improved":
        from repro_torch.core.distributed_improved import audit_spec
        return audit_spec(graph, mesh, eps=eps, walks_per_node=K)
    if engine == "directed":
        from repro_torch.core.distributed_directed import audit_spec
        return audit_spec(graph, mesh, eps=eps, walks_per_node=K)
    if engine == "ppr":
        from repro_torch.core.personalized_batch import audit_spec
        return audit_spec(graph, mesh, eps=eps,
                          **{"walks_per_query": 4 * K, **kw})
    raise ValueError(f"unknown engine '{engine}' (one of {ENGINES})")


def walk_lanes(engine: str, graph, shards: int, K: int) -> Dict[str, int]:
    """The runtime lanes a shard of each walk-class site when the engine
    runs with its default caps."""
    if engine == "walks":
        from repro_torch.core.distributed import default_route_cap
        return {"route": shards * default_route_cap(graph.n * K, shards)}
    if engine in ("improved", "directed"):
        from repro_torch.core.distributed_improved import tail_route_cap
        return {"tail": shards * tail_route_cap(graph.n * K, shards)}
    return {}


def _run_engine(engine: str, graph, mesh, *, eps: float, K: int,
                spec: EngineAuditSpec):
    key = prng.PRNGKey(0)
    if engine == "walks":
        from repro_torch.core.distributed import distributed_pagerank
        return distributed_pagerank(graph, eps, K, key, mesh=mesh)
    if engine == "counts":
        from repro_torch.core.distributed_counts import \
            distributed_pagerank_counts
        return distributed_pagerank_counts(graph, eps, K, key, mesh=mesh)
    if engine == "improved":
        from repro_torch.core.distributed_improved import \
            distributed_improved_pagerank
        return distributed_improved_pagerank(graph, eps, K, key, mesh=mesh)
    if engine == "directed":
        from repro_torch.core.distributed_directed import \
            distributed_directed_pagerank
        return distributed_directed_pagerank(graph, eps, K, key, mesh=mesh)
    from repro_torch.core.personalized_batch import \
        batched_personalized_pagerank
    return batched_personalized_pagerank(
        graph, eps, queries=PPR_QUERIES,
        walks_per_query=spec.meta["walks_per_query"],
        key=prng.PRNGKey(1), mesh=mesh)


def pinned_superstep(graph, mesh, device=None, *, eps: float, stage: str,
                     lints: bool = True) -> RecordingMesh:
    """One superstep at the pinned walk-class cap, route_cap = cap =
    n_loc, on a state holding one walk per owned vertex, as the program
    `stage/step`, over `mesh` (or a `StackedMesh` of `mesh` shards on
    `device`). Returns its recording mesh."""
    from repro_torch.core.distributed import (DistState, shard_graph,
                                              superstep)
    mesh = RecordingMesh(mesh, device, lints=lints)
    shards = mesh.shards
    sg = shard_graph(graph, shards, mesh=mesh)
    n_loc = sg.n_loc
    vid = torch.arange(shards * n_loc, dtype=torch.int32,
                       device=mesh.device)
    pos = mesh.local_rows(torch.where(vid < graph.n, vid, -1).reshape(
        shards, n_loc))
    state = DistState(pos=pos, zeta=torch.zeros_like(pos),
                      key=mesh.local_rows(prng.split(prng.PRNGKey(0),
                                                     shards)),
                      round=0, dropped=0, waited=0)
    superstep(sg, state, mesh=mesh, eps=eps, route_cap=n_loc, stage=stage)
    return mesh


def audit_all_engines(mesh: Optional[StackedMesh] = None, *, device=None,
                      run_telemetry: bool = True, eps: float = 0.2,
                      walks_per_node: int = 2,
                      engines: Optional[Tuple[str, ...]] = None
                      ) -> Dict[str, Any]:
    """Audit every sharded engine; returns the AUDIT.json dict.

    Each engine runs on its fixture graph under a `RecordingMesh` over
    `mesh` (8 stacked shards on `device`, the card when None, if no mesh
    is given), and every recorded program call is held to the engine's
    spec; with `run_telemetry` the run's byte counters are also checked
    against its entry counters times the declared widths. Over a process
    group every process audits its own shard's calls, and the returned
    report, the same on every process, merges theirs."""
    mesh = mesh or StackedMesh(8, device)
    shards, dev = mesh.shards, mesh.device
    K = walks_per_node
    report: Dict[str, Any] = dict(devices=shards, device=str(dev), eps=eps,
                                  walks_per_node=K, engines={})
    total = 0
    for engine in (engines or ENGINES):
        graph, fixture = _fixture_for(engine, dev)
        spec = spec_for(engine, graph, mesh, eps=eps, K=K)
        rec = RecordingMesh(mesh)
        res = _run_engine(engine, graph, rec, eps=eps, K=K, spec=spec)
        pinned = None
        walk_stage = {"walks": "walks", "improved": "tail",
                      "directed": "tail"}.get(engine)
        if walk_stage:
            pinned = pinned_superstep(graph, mesh, eps=eps,
                                      stage=walk_stage).calls
        entry = audit_engine_spec(spec, rec.calls, unscoped=rec.unscoped,
                                  pinned=pinned,
                                  walk_lanes=walk_lanes(engine, graph,
                                                        shards, K))
        entry["fixture"] = fixture

        spec_hi = spec_for(engine, graph, mesh, eps=eps, K=2 * K)
        w_violations = check_w_independence(spec, spec_hi)
        entry["w_independent"] = not w_violations
        entry["violations"].extend(v.to_dict() for v in w_violations)

        if run_telemetry:
            checks = telemetry_checks(engine, res, spec)
            entry["telemetry"] = dict(checks=checks,
                                      ok=all(c["ok"] for c in checks))
            for c in checks:
                if not c["ok"]:
                    entry["violations"].append(AuditViolation(
                        engine=engine, kind="telemetry/mismatch",
                        where=c["name"],
                        message=(f"runtime wire {c['runtime_bytes']} B != "
                                 f"{c['entries']} entries x declared width "
                                 f"(expected {c['expected_bytes']} B)")
                    ).to_dict())
        entry = _merge_processes(mesh.gather_objects(entry))
        total += len(entry["violations"])
        report["engines"][engine] = entry
    report["violations_total"] = total
    report["ok"] = total == 0
    return report


def _merge_processes(entries: List[dict]) -> dict:
    """One engine's report from every process's: the first process's rows,
    the union of the violations, and a violation for each field on which
    a process differs from the first."""
    first = dict(entries[0])
    seen = {repr(v) for v in first["violations"]}
    first["violations"] = list(first["violations"])
    for rank, other in enumerate(entries[1:], start=1):
        for v in other["violations"]:
            if repr(v) not in seen:
                seen.add(repr(v))
                first["violations"].append(v)
        for field in sorted(set(first) | set(other)):
            if field != "violations" and first.get(field) != other.get(field):
                first["violations"].append(AuditViolation(
                    engine=first["engine"], kind="budget/ranks-differ",
                    where=field,
                    message=f"process {rank}'s {field} differs from "
                            f"process 0's").to_dict())
    return first


def format_wire_table(report: Dict[str, Any]) -> str:
    """Render the per-engine wire-budget table for --audit logs."""
    hdr = (f"{'engine':<9} {'stage/site':<22} {'B/ent':>5} {'lanes':>7} "
           f"{'budget':>7} {'cap B':>8} {'rec. B':>8} {'class':<6} "
           f"{'resume':<16}")
    lines = [f"CONGEST wire audit — {report['devices']} shards, "
             f"eps={report['eps']}, K={report['walks_per_node']}",
             hdr, "-" * len(hdr)]
    for name, e in report["engines"].items():
        for row in e["sites"]:
            resume = e["resume"].get(row["stage"], "?").split(" (")[0]
            lines.append(
                f"{name:<9} {row['stage'] + '/' + row['site']:<22} "
                f"{row['entry_nbytes']:>5} {row['lane_entries']:>7} "
                f"{row['budget_entries']:>7} {row['capacity_bytes']:>8} "
                f"{str(row['recorded_payload_bytes']):>8} "
                f"{row['wire_class']:<6} {resume:<16}")
        tele = e.get("telemetry", {}).get("ok")
        tele_s = "-" if tele is None else ("ok" if tele else "MISMATCH")
        lines.append(
            f"{'':<9} {'psums: ' + str(e['psum_sites']):<22} "
            f"max {e['psum_max_bytes']:>3} B   telemetry {tele_s}   "
            f"w-free {'yes' if e['w_independent'] else 'NO'}   "
            f"violations {len(e['violations'])}")
    lines.append("-" * len(hdr))
    lines.append(f"total violations: {report['violations_total']} — "
                 f"{'PASS' if report['ok'] else 'FAIL'}")
    return "\n".join(lines)
