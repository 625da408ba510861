"""Parse collective-communication bytes out of lowered/compiled HLO text
(a copy of the JAX package's ``utils/hlo.py``, which is plain Python), and
name the port's own collectives by the same kinds.

``compiled.cost_analysis()`` does not report collective traffic, so the
roofline's collective term is derived here: we scan the (stable)HLO /
HLO text for ``all-gather`` / ``all-reduce`` / ``reduce-scatter`` /
``all-to-all`` / ``collective-permute`` ops and sum their operand bytes.

The port issues its collectives as ``torch.ops._c10d_functional`` ops
(DTensor's redistributions); ``FUNCTIONAL_KINDS`` names each by the kind
its HLO op has (any other under its own name), and ``launch.dryrun``'s
counter adds each one to a
``CollectiveStats`` with the bytes of its result, the size this module
reads off an HLO line (what the op materialises on each participant).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict

# dtype name -> bytes per element, for both HLO and stableHLO spellings.
_DTYPE_BYTES = {
    "pred": 1,
    "s8": 1, "u8": 1, "i8": 1, "ui8": 1,
    "s16": 2, "u16": 2, "i16": 2, "ui16": 2,
    "s32": 4, "u32": 4, "i32": 4, "ui32": 4,
    "s64": 8, "u64": 8, "i64": 8, "ui64": 8,
    "f8e4m3fn": 1, "f8e5m2": 1,
    "bf16": 2, "f16": 2, "f32": 4, "f64": 8,
    "c64": 8, "c128": 16,
}

# HLO: bf16[8,128,4096]{2,1,0}   stableHLO: tensor<8x128x4096xbf16>
_HLO_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
_COLLECTIVE_OPS = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
    "collective-broadcast",
)
# stableHLO spellings
_STABLEHLO_OPS = {
    "stablehlo.all_gather": "all-gather",
    "stablehlo.all_reduce": "all-reduce",
    "stablehlo.reduce_scatter": "reduce-scatter",
    "stablehlo.all_to_all": "all-to-all",
    "stablehlo.collective_permute": "collective-permute",
    "stablehlo.collective_broadcast": "collective-broadcast",
}
_TENSOR_RE = re.compile(r"tensor<([0-9x]*)x?(\w+)>")
# torch.ops._c10d_functional op name -> the HLO kind of the same collective
FUNCTIONAL_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_reduce": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}


@dataclass
class CollectiveStats:
    """Bytes moved per collective kind, summed over all ops in the module."""

    bytes_by_kind: Dict[str, int] = field(default_factory=dict)
    count_by_kind: Dict[str, int] = field(default_factory=dict)

    @property
    def total_bytes(self) -> int:
        return int(sum(self.bytes_by_kind.values()))

    @property
    def total_count(self) -> int:
        return int(sum(self.count_by_kind.values()))

    def add(self, kind: str, nbytes: int) -> None:
        self.bytes_by_kind[kind] = self.bytes_by_kind.get(kind, 0) + int(nbytes)
        self.count_by_kind[kind] = self.count_by_kind.get(kind, 0) + 1

    def summary(self) -> str:
        parts = [
            f"{k}: n={self.count_by_kind[k]} bytes={self.bytes_by_kind[k]:,}"
            for k in sorted(self.bytes_by_kind)
        ]
        return "; ".join(parts) if parts else "none"


def _hlo_line_bytes(line: str) -> int:
    """Sum the bytes of the *result* shape(s) on an HLO op line.

    For collectives, result size == operand size (all-gather result is the
    gathered size; we count the line's first (result) shape which is the
    amount of data materialized by the op on each participant).
    """
    total = 0
    # Result shape(s) are on the LHS before '=' when present; fall back to
    # first shape on the line.
    lhs = line.split("=", 1)[0] if "=" in line else line
    matches = _HLO_SHAPE_RE.findall(lhs) or _HLO_SHAPE_RE.findall(line)
    for dtype, dims in matches:
        if dtype not in _DTYPE_BYTES:
            continue
        n = 1
        if dims.strip():
            for d in dims.split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES[dtype]
    return total


def parse_collectives(hlo_text: str) -> CollectiveStats:
    """Extract collective traffic from HLO or stableHLO module text."""
    stats = CollectiveStats()
    for raw in hlo_text.splitlines():
        line = raw.strip()
        if not line or line.startswith(("//", "#")):
            continue
        # HLO form:  %x = bf16[...] all-gather(...)
        matched_kind = None
        for kind in _COLLECTIVE_OPS:
            # Avoid matching 'all-reduce-scatter' fragments: exact op token.
            if re.search(rf"(?<![\w-]){re.escape(kind)}(?:-start|-done)?\(", line):
                matched_kind = kind
                break
        if matched_kind is not None:
            if f"{matched_kind}-done(" in line:
                continue  # counted at -start
            stats.add(matched_kind, _hlo_line_bytes(line))
            continue
        # stableHLO form: %x = "stablehlo.all_gather"(...) ... -> tensor<..>
        for op, kind in _STABLEHLO_OPS.items():
            if op in line:
                total = 0
                for dims, dtype in _TENSOR_RE.findall(line.split("->")[-1]):
                    if dtype not in _DTYPE_BYTES:
                        continue
                    n = 1
                    if dims:
                        for d in dims.split("x"):
                            if d:
                                n *= int(d)
                    total += n * _DTYPE_BYTES[dtype]
                stats.add(kind, total)
                break
    return stats
