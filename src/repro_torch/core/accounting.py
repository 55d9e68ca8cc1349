"""CONGEST-model accounting.

The paper's efficiency claims are about *rounds* of an n-processor network
with B = polylog(n) bits per edge per round. The engines execute
bulk-synchronous super-steps instead, so the theorems are validated through
a pure accounting layer: every engine reports, per logical round, the
maximum count value sent over any edge and aggregate message statistics;
this module converts those traces into CONGEST(B) round counts.

Message encoding model (matches the paper):
  a coupon-count message of value T costs ceil(log2(T+1)) + O(1) bits; an
  edge carries one count per direction per round (Lemma 1 — counts, never
  walk identities).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple


@dataclasses.dataclass
class RoundTrace:
    """Statistics of one logical round of a walk engine."""

    active_walks: int          # walks alive at the start of the round
    messages: int              # number of (edge, direction) count messages
    max_edge_count: int        # largest count carried by any single edge
    total_count: int           # sum of all counts moved (== surviving walks)

    @property
    def max_edge_bits(self) -> int:
        # ceil(log2(T+1)) payload + 8-bit header
        return int(math.ceil(math.log2(self.max_edge_count + 1))) + 8 if self.max_edge_count else 0


@dataclasses.dataclass
class CongestReport:
    traces: List[RoundTrace]
    n: int
    bandwidth_bits: int  # B

    @property
    def logical_rounds(self) -> int:
        return len(self.traces)

    @property
    def congest_rounds(self) -> int:
        """Rounds after splitting any over-B edge payload across rounds."""
        total = 0
        for t in self.traces:
            total += max(1, math.ceil(max(t.max_edge_bits, 1) / self.bandwidth_bits))
        return total

    @property
    def max_bits_per_edge_per_round(self) -> int:
        return max((t.max_edge_bits for t in self.traces), default=0)

    @property
    def total_message_bits(self) -> int:
        return sum(t.messages * max(t.max_edge_bits, 1) for t in self.traces)

    def summary(self) -> dict:
        return dict(
            n=self.n,
            logical_rounds=self.logical_rounds,
            congest_rounds=self.congest_rounds,
            max_bits_per_edge_per_round=self.max_bits_per_edge_per_round,
            bandwidth_bits=self.bandwidth_bits,
        )


def default_bandwidth(n: int) -> int:
    """B = Theta(log^2 n) bits — a standard CONGEST(polylog) instantiation."""
    return max(32, int(math.ceil(math.log2(max(n, 2)) ** 2)))


def phase_rounds_constant(num_events: int) -> List[RoundTrace]:
    """O(1)-round direct-communication events (Phase-2 stitches): each event
    is one token message of O(log n) bits, under B by construction."""
    return [RoundTrace(active_walks=num_events, messages=num_events,
                       max_edge_count=1, total_count=num_events)]


# ---------------------------------------------------------------------------
# Static wire-budget declarations (consumed by `analysis.congest`)
#
# Every sharded engine exposes an `audit_spec(graph, mesh, ...)` that
# returns an `EngineAuditSpec`: the programs of its stages, each with one
# `ExchangeSite` per all_to_all the program is *supposed* to launch,
# carrying the declared per-entry width and a W-free lane budget (a
# function of distinct vertices and polylog(n) factors, never of the walk
# multiplicity W). The auditor runs the engine under a recording mesh and
# checks the declarations against the collectives each program call
# launched. These types live here (not in analysis/) so the engines can
# declare budgets without importing the analyzer.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ExchangeSite:
    """One declared all_to_all exchange of a stage program.

    `lane_entries` is the per-shard-per-round lane capacity (total slots of
    the a2a operand); `budget_entries` is the W-free bound it must never
    exceed, with `budget_formula` naming the closed form. `wire_class` is
    "count" for Lemma-1 (vertex, count) payloads and "walk" for the
    per-walk lanes of the naive engines, whose runtime caps scale with
    W/P: the declaration pins those at n_loc, and the auditor runs one
    extra call at that cap, so the *checked* capacity stays W-free.
    """

    site: str                  # telemetry key, e.g. "phase1_rep"
    entry_nbytes: int          # declared wire bytes per lane entry
    lane_entries: int          # lane slots per shard per round
    budget_entries: int        # W-free bound on lane_entries
    budget_formula: str        # human-readable closed form of the budget
    wire_class: str = "count"  # "count" (Lemma 1) | "walk" (naive lanes)
    note: str = ""

    @property
    def capacity_bytes(self) -> int:
        return self.entry_nbytes * self.lane_entries

    @property
    def budget_bytes(self) -> int:
        return self.entry_nbytes * self.budget_entries


@dataclasses.dataclass(frozen=True)
class StageProgram:
    """One program of a `runtime.Stage`: the code an engine runs inside
    `mesh.program(stage, program)`.

    `sites` lists the expected all_to_all launches of one call, in program
    order. `count_bound` declares the largest integer count the program
    can move: the dtype lint flags int->float funnels only when this bound
    exceeds the target float's exact-integer range.
    """

    stage: str                          # runtime.Stage name
    program: str                        # program within the stage
    sites: Tuple[ExchangeSite, ...] = ()
    count_bound: Optional[int] = None


@dataclasses.dataclass
class EngineAuditSpec:
    """A sharded engine's complete audit declaration: every stage program
    with its wire budgets, plus the `StagedState` array names and
    `checkpoint.LayoutSpec` schema per stage (kept opaque here: the
    elastic-schema lint compares them structurally)."""

    engine: str
    programs: List[StageProgram]
    stage_arrays: Dict[str, Tuple[str, ...]]
    layouts: Dict[str, Dict[str, Any]]
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)
