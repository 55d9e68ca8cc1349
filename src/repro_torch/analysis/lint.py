"""Engine lints: RNG-key discipline, dtype funnels, elastic schema.

The JAX package's lints walk the jaxprs its auditor traces. The port has
no trace: the CONGEST auditor (`analysis.congest`) runs each engine under
a `RecordingMesh`, which records, within every program call, each
consumption of a PRNG key (through `prng.RNG_RECORDER`) and each
integer->float op (through `funnel_mode`). The passes here read those
records, so what they certify holds for the programs the run executed:

  rng_lint     — no key is consumed twice within one program call. The
                 consumers are `prng.split`, `prng.uniform`, the keyed
                 entry of `walk_step` and `multinomial_buckets` (whose
                 counter hashes take the key words directly); `fold_in`
                 derives a key without consuming one, as in JAX. A record
                 is keyed by the key words' value, so two uses of equal
                 words are reuse whatever tensor carried them. Key reuse
                 correlates draws that should be independent, and it
                 breaks the elastic-resume contract. Stages that consume
                 no RNG are what the resume classifier certifies bit-exact.

  dtype_lint   — integer counts funneled through float ops: every aten op
                 with an integer tensor input and a floating output,
                 `_to_copy` included. A float32 holds integers exactly only
                 up to 2^24 (float64 to 2^53): a funnel is a violation when
                 the program's declared `count_bound` exceeds that, and a
                 note otherwise. The kernels are bound through ctypes
                 (`kernels/common.py`), so the dispatch mode does not see
                 inside them on the card; on the CPU the ops of their plain
                 versions (anything issued from `repro_torch/kernels/`) are
                 skipped too, so the records do not depend on the device.
                 The kernels' integer sums (`segment_sum_int`, `histogram`)
                 are exact by construction.

  schema_lint  — elastic-schema completeness: every device buffer of a
                 `runtime.StagedState` stage is covered by exactly one
                 `checkpoint.LayoutSpec` entry, and no spec dangles.

`schema_lint` and `classify_resume` are plain Python over layout specs and
match the JAX package's line for line. All passes return `LintFinding`
rows; `severity == "violation"` fails the audit, `"note"` informs.
"""
from __future__ import annotations

import dataclasses
import os
import sys
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = [
    "LintFinding", "rng_lint", "funnel_mode", "dtype_lint", "schema_lint",
    "classify_resume",
]


@dataclasses.dataclass(frozen=True)
class LintFinding:
    lint: str       # "rng" | "dtype" | "schema"
    severity: str   # "violation" | "note"
    where: str      # program (or stage) the finding anchors to
    message: str

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


# ---------------------------------------------------------------------------
# RNG-key discipline
# ---------------------------------------------------------------------------

def rng_lint(uses: Sequence[Tuple[Tuple[int, int], str]], *,
             where: str = "") -> Tuple[List[LintFinding], int]:
    """Check PRNG-key discipline on the key uses of one program call, each
    ((k0, k1), what) in the order they happened.

    Returns `(findings, consumed)`: one violation per key consumed more
    than once, plus the number of consumptions (0 means the program is
    RNG-free, and therefore bit-exact under elastic resume)."""
    seen: Dict[Tuple[int, int], List[str]] = {}
    for words, what in uses:
        seen.setdefault(tuple(words), []).append(what)
    findings = [
        LintFinding(lint="rng", severity="violation", where=where,
                    message=(f"key ({k0:#010x}, {k1:#010x}) consumed "
                             f"{len(whats)} times (by {', '.join(whats)}) "
                             f"— correlated draws; derive sub-keys with "
                             f"split/fold_in instead"))
        for (k0, k1), whats in seen.items() if len(whats) > 1]
    return findings, len(uses)


# ---------------------------------------------------------------------------
# dtype funnels
# ---------------------------------------------------------------------------

_MANTISSA_BITS = {torch.float64: 53, torch.float32: 24, torch.float16: 11,
                  torch.bfloat16: 8}
_KERNELS_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "kernels")


def _is_int(dtype: torch.dtype) -> bool:
    return not (dtype.is_floating_point or dtype.is_complex
                or dtype == torch.bool)


def _in_kernel() -> bool:
    """Whether the op was issued from a kernel's module (its plain version
    on the CPU)."""
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_filename.startswith(_KERNELS_DIR):
            return True
        f = f.f_back
    return False


class _FunnelMode(TorchDispatchMode):
    def __init__(self, sink: set):
        super().__init__()
        self.sink = sink

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ins = [t for t in pytree.tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor) and _is_int(t.dtype)]
        if ins:
            floats = [t for t in pytree.tree_leaves(out)
                      if isinstance(t, torch.Tensor)
                      and t.dtype.is_floating_point]
            if floats and not _in_kernel():
                self.sink.add((str(func.overloadpacket.__name__),
                               str(ins[0].dtype).removeprefix("torch."),
                               str(floats[0].dtype).removeprefix("torch.")))
        return out


def funnel_mode(sink: set) -> TorchDispatchMode:
    """A context that adds (op, integer dtype, float dtype) to `sink` for
    every aten op run inside it with an integer tensor input and a
    floating output, outside the kernels' modules."""
    return _FunnelMode(sink)


def dtype_lint(funnels: Iterable[Tuple[str, str, str]], *,
               count_bound: Optional[int] = None,
               where: str = "") -> List[LintFinding]:
    """Flag integer->float funnels whose declared count bound exceeds the
    target float's exact-integer range (2^mantissa); the others are
    notes."""
    out: List[LintFinding] = []
    for op, src, dst in sorted(set(funnels)):
        mant = _MANTISSA_BITS.get(getattr(torch, dst, None), 53)
        if count_bound is not None and count_bound > (1 << mant):
            out.append(LintFinding(
                lint="dtype", severity="violation", where=where,
                message=(f"{op}: {src}->{dst} funnel with declared "
                         f"count_bound={count_bound} > 2^{mant} — counts "
                         f"above 2^{mant} truncate silently; widen or use "
                         f"an exact integer path")))
        else:
            out.append(LintFinding(
                lint="dtype", severity="note", where=where,
                message=(f"{op}: {src}->{dst} funnel (count_bound "
                         f"{count_bound} within 2^{mant})")))
    return out


# ---------------------------------------------------------------------------
# elastic-schema completeness
# ---------------------------------------------------------------------------

def schema_lint(stage_arrays: Dict[str, Tuple[str, ...]],
                layouts: Dict[str, Dict[str, Any]]) -> List[LintFinding]:
    """Every `StagedState` device buffer covered by exactly one
    `LayoutSpec`, and no spec without a buffer."""
    out: List[LintFinding] = []
    for stage, arrays in stage_arrays.items():
        specs = layouts.get(stage)
        if specs is None:
            out.append(LintFinding(
                lint="schema", severity="violation", where=stage,
                message=f"stage '{stage}' has no LayoutSpec schema at all"))
            continue
        for name in sorted(set(arrays) - set(specs)):
            out.append(LintFinding(
                lint="schema", severity="violation", where=stage,
                message=(f"device buffer '{name}' of stage '{stage}' has no "
                         f"LayoutSpec — it would resume as garbage on a "
                         f"resized mesh")))
        for name in sorted(set(specs) - set(arrays)):
            out.append(LintFinding(
                lint="schema", severity="violation", where=stage,
                message=(f"LayoutSpec '{name}' of stage '{stage}' covers no "
                         f"device buffer — dangling schema entry")))
    return out


# ---------------------------------------------------------------------------
# elastic-resume classification (consumes rng_lint + schema info)
# ---------------------------------------------------------------------------

def classify_resume(stage: str, rng_consumed: int,
                    layouts_for_stage: Dict[str, Any]
                    ) -> Tuple[str, List[LintFinding]]:
    """Classify a stage's elastic-resume guarantee from its RNG usage and
    how its key buffers are laid out.

      no RNG consumed                  -> bit-exact (RNG-free)
      RNG + all keys replicated        -> bit-exact (round-replicated key:
                                          the same per-round key is
                                          re-derived on any mesh size)
      RNG + per-shard key buffers      -> statistical (per-shard keys are
                                          re-derived on resize, so resumed
                                          draws differ bit-for-bit but not
                                          in distribution)
      RNG but no key buffer in schema  -> violation (the stage draws from
                                          state the checkpoint never saves)
    """
    key_kinds = sorted({getattr(s, "kind", "?")
                        for s in (layouts_for_stage or {}).values()
                        if getattr(s, "kind", "") in ("key", "replicated_key")})
    if rng_consumed == 0:
        return "bit-exact (RNG-free)", []
    if not key_kinds:
        return "unresumable", [LintFinding(
            lint="rng", severity="violation", where=stage,
            message=(f"stage '{stage}' consumes RNG but its layout schema "
                     f"holds no key buffer — resumed runs would replay "
                     f"with lost randomness"))]
    if key_kinds == ["replicated_key"]:
        return "bit-exact (replicated key)", []
    return "statistical (per-shard keys re-derived on resize)", []
