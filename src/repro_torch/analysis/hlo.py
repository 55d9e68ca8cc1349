"""HLO text parsing: collective byte extraction for the roofline model.

The port's own copy of the JAX package's `repro.analysis.hlo`, a pure
text parser: XLA's cost analysis reports FLOPs and memory traffic but not
collective volume, so the optimized HLO is parsed for all-gather /
all-reduce / reduce-scatter / all-to-all / collective-permute ops and
their payload sizes summed. Shapes are parsed from the op's result type
string. The port compiles no HLO: its dry run passes `""` to
`roofline.build_roofline`, as the JAX package's calibrated path does.

Async pairs: `op-start` returns a tuple `(operands..., results...)` and
`op-done` returns the result again, so a naive sum over every shape in
every matched line double counts twice over — once by summing the operand
halves of the start tuples, once by counting the done ops. Here the
`-start`/`-done` suffix is parsed structurally (no substring matching on
the argument list), `-done` lines are skipped, and `-start` tuples only
charge their result half.
"""
from __future__ import annotations

import re
from collections import defaultdict
from typing import Dict, List

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16,
}

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

# e.g.  f32[16,128]{1,0}  or bf16[4096]  or (f32[2], s32[3]) tuples
_SHAPE_RE = re.compile(r"(pred|s8|u8|s16|u16|bf16|f16|s32|u32|f32|s64|u64|f64|c64|c128)\[([0-9,]*)\]")

# "  %name = TYPE op-name(...)" — capture result type text + op + async
# suffix (captured, so "-done" is detected on the op itself rather than by
# substring-matching the whole line, which misfires on operand names)
_OP_RE = re.compile(
    r"^\s*(?:ROOT\s+)?%?[\w\.\-]+\s*=\s*(.+?)\s+"
    r"(all-gather|all-reduce|reduce-scatter|all-to-all|collective-permute)"
    r"(-start|-done)?\(", )


def _shape_bytes_list(type_text: str) -> List[int]:
    sizes = []
    for dt, dims in _SHAPE_RE.findall(type_text):
        n = 1
        if dims:
            for d in dims.split(","):
                if d:
                    n *= int(d)
        sizes.append(n * _DTYPE_BYTES[dt])
    return sizes


def _shape_bytes(type_text: str) -> int:
    return sum(_shape_bytes_list(type_text))


def _payload_bytes(type_text: str, suffix: str) -> int:
    sizes = _shape_bytes_list(type_text)
    if suffix == "-start" and len(sizes) >= 2:
        # async start result = (operands..., results...): the operand half
        # aliases the inputs, only the result half is collective payload
        sizes = sizes[len(sizes) // 2:]
    return sum(sizes)


def collective_bytes(hlo_text: str) -> Dict[str, int]:
    """Sum of payload bytes per collective kind.

    `-done` ops are skipped and `-start` tuple results only count their
    result half, so async pairs are charged exactly once.
    """
    out: Dict[str, int] = defaultdict(int)
    for line in hlo_text.splitlines():
        m = _OP_RE.match(line)
        if not m:
            continue
        type_text, kind, suffix = m.group(1), m.group(2), m.group(3) or ""
        if suffix == "-done":
            continue
        out[kind] += _payload_bytes(type_text, suffix)
    return dict(out)


def count_ops(hlo_text: str) -> Dict[str, int]:
    counts: Dict[str, int] = defaultdict(int)
    for line in hlo_text.splitlines():
        m = _OP_RE.match(line)
        if m and (m.group(3) or "") != "-done":
            counts[m.group(2)] += 1
    return dict(counts)
