"""Structured diagnostics for the static plan/kernel verifier.

Every check in :mod:`repro_torch.analysis` reports through one vocabulary: a
:class:`Diagnostic` with a *stable code* (documented in README §Static
verification and pinned by the negative-test suite), a severity, a
human-readable message, and the provenance of the rule — which pass or
kernel owns the contract that was violated.  The code, not the message, is
the machine interface: messages may be reworded, codes may not.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

ERROR = "error"        # plan would miscompile, crash, or silently fall back
WARNING = "warning"    # plan compiles but a declared contract degrades
SEVERITIES = (ERROR, WARNING)

# code -> one-line meaning; the README table and ``launch/check.py --codes``
# render this, and the negative-test suite asserts every entry fires.
DIAGNOSTIC_CODES: Dict[str, str] = {
    # cross-pass plan coherence (X)
    "X001": "folding units do not partition the graph blocks exactly once",
    "X002": "a selected tile dim does not divide its problem dim (rule 2)",
    "X003": "stream plan stage boundaries/counts are out of range",
    "X004": "a PartitionSpec shards a param dim the mesh axes do not divide",
    "X005": "a PartitionSpec references an axis missing from the mesh",
    "X006": "kernel table references an unknown op or backend",
    "X007": "graph IR is invalid (undefined read, block not ending in 'h')",
    "X008": "tile table carries a key no kernel or pass consumes",
    # pass-pipeline ordering (P)
    "P101": "a pass reads a plan artifact before any pass writes it",
    "P102": "pipeline never writes a required plan artifact",
    # kernel contracts (K)
    "K201": "plan resolves an op to a backend with no registered impl",
    "K202": "kernel working set exceeds a block's shared memory (227 KiB) "
            "or the flow's budget",
    "K203": "donated state reaches a kernel declared donation-unsafe",
    "K204": "capability predicate statically rejects; op falls back to ref",
    "K205": "paged pool too small for one slot's block chain (gather bounds)",
    # serving invariants (S) — shared with EngineConfig/ServingProfile
    "S301": "block_size does not divide every prompt bucket",
    "S302": "chunk-bucket ladder malformed (rung 1 / final rung / positive)",
    "S303": "fori_seg must be 0 (off) or >= 2",
    "S304": "batch-bucket ladder malformed (positive / ends at max_batch)",
    "S305": "prompt-bucket ladder malformed (positive / within max_seq_len)",
    "S306": "chunk_size outside [1, max_seq_len]",
    "S307": "speculation config invalid (drafter kind / draft_k / "
            "draft cfg / fori_seg clash)",
    # mesh-split divisibility (M) — shared with split_rejection_reason
    "M401": "global batch not divisible by the dp factor",
    "M402": "tp factor divides none of the tp-shardable dims",
    "M403": "pp factor invalid for this cell (non-train or uneven layers)",
    # flow-level knob screen (F) — the DSE's pre-plan static pruner
    "F501": "flow knob holds a value no pass or registry accepts",
    # persistent autotune store (T) — repro_torch.tunedb records
    "T601": "tunedb record no longer verifies against the current plan "
            "(stale knobs / search space / code version); re-measuring",
}


@dataclass(frozen=True)
class Diagnostic:
    """One verifier finding.  ``where`` names the owning pass (``tiling``,
    ``sharding``, ...) or kernel (``attention``); ``op`` narrows to the
    graph op or config field when one is implicated."""
    code: str
    severity: str
    message: str
    where: str = ""
    op: str = ""

    def __post_init__(self) -> None:
        if self.code not in DIAGNOSTIC_CODES:
            raise ValueError(f"unknown diagnostic code {self.code!r}")
        if self.severity not in SEVERITIES:
            raise ValueError(f"unknown severity {self.severity!r}")

    def format(self) -> str:
        loc = self.where + (f":{self.op}" if self.op else "")
        return f"[{self.code}] {self.severity} {loc}: {self.message}"


@dataclass
class VerificationResult:
    """The outcome of one :func:`repro_torch.analysis.verify_plan` run."""
    diagnostics: List[Diagnostic] = field(default_factory=list)
    n_checks: int = 0                    # checker functions executed

    @property
    def errors(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == ERROR]

    @property
    def warnings(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == WARNING]

    @property
    def ok(self) -> bool:
        return not self.errors

    def codes(self) -> Tuple[str, ...]:
        return tuple(d.code for d in self.diagnostics)

    def summary_line(self) -> str:
        """One deterministic line for ``plan.describe()`` / the check CLI."""
        if not self.diagnostics:
            return f"ok ({self.n_checks} checks)"
        e, w = self.errors, self.warnings
        parts = []
        if e:
            parts.append(f"{len(e)} errors [" +
                         " ".join(sorted({d.code for d in e})) + "]")
        if w:
            parts.append(f"{len(w)} warnings [" +
                         " ".join(sorted({d.code for d in w})) + "]")
        status = "FAIL" if e else "ok"
        return f"{status} ({self.n_checks} checks, " + ", ".join(parts) + ")"

    def describe(self) -> str:
        lines = [self.summary_line()]
        lines += ["  " + d.format() for d in self.diagnostics]
        return "\n".join(lines)


class PlanVerificationError(ValueError):
    """Raised by ``flow.compile(verify=True)`` before any weight is made
    when the plan fails static verification; carries the full result."""

    def __init__(self, result: VerificationResult) -> None:
        self.result = result
        super().__init__("plan failed static verification:\n"
                         + result.describe())
