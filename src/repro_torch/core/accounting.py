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
from typing import List


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
