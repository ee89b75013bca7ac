"""Findings, reports, and the verifier's error type (the JAX package's
``analysis/report.py``: the same fields, JSON form and severities).

Every checker in ``repro_torch.analysis`` speaks one vocabulary: a ``Finding``
is a single violated (or suspect) invariant with a machine-readable
``code`` (``"plan.group-straddle"``, ``"index.write-race"``, ...), a
``where`` locating the offending object (layer name, node name, grid
point), and a human-actionable ``message``.  A ``Report`` aggregates
findings; ``FoldLintError`` carries them when the engine-side verifier
(``compile_network(verify=True)``) refuses a schedule.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Iterable, Iterator, List, Tuple

from repro_torch.core.graph import GraphError

__all__ = ["ERROR", "WARNING", "Finding", "FoldLintError", "Report"]

ERROR = "error"
WARNING = "warning"


@dataclasses.dataclass(frozen=True)
class Finding:
    """One violated invariant.

    code     — stable machine-readable id, ``<checker>.<invariant>``.
    severity — ``"error"`` (schedule is wrong / unsafe) or ``"warning"``
               (legal but suspect, e.g. a graph node the output never
               reads).
    where    — what the finding is about (layer/node name, grid point).
    message  — human-actionable diagnostic.
    """
    code: str
    severity: str
    where: str
    message: str

    def __str__(self) -> str:
        return f"{self.severity}[{self.code}] {self.where}: {self.message}"

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class Report:
    """An ordered collection of findings from one or more checkers."""
    findings: List[Finding] = dataclasses.field(default_factory=list)

    def add(self, code: str, where: str, message: str,
            severity: str = ERROR) -> None:
        self.findings.append(Finding(code=code, severity=severity,
                                     where=where, message=message))

    def extend(self, other: "Report") -> None:
        self.findings.extend(other.findings)

    @property
    def errors(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == ERROR]

    @property
    def warnings(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == WARNING]

    @property
    def ok(self) -> bool:
        """No error-severity findings (warnings do not fail a run)."""
        return not self.errors

    def codes(self) -> List[str]:
        return [f.code for f in self.findings]

    def has(self, code: str) -> bool:
        return any(f.code == code for f in self.findings)

    def __iter__(self) -> Iterator[Finding]:
        return iter(self.findings)

    def __len__(self) -> int:
        return len(self.findings)

    def as_dict(self) -> dict:
        return {"ok": self.ok,
                "errors": len(self.errors),
                "warnings": len(self.warnings),
                "findings": [f.as_dict() for f in self.findings]}

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.as_dict(), indent=indent)

    def summary(self) -> str:
        return (f"{len(self.errors)} error(s), "
                f"{len(self.warnings)} warning(s)")


class FoldLintError(GraphError):
    """A schedule/graph failed static verification.

    Raised by ``compile_network(verify=True)``; carries the findings so
    callers (and tests) can inspect exactly which invariants broke.
    Subclasses ``GraphError`` because a lint refusal *is* a compile-time
    graph rejection — callers that already catch ``GraphError`` around
    ``compile_network`` keep working with ``verify=True``.
    """

    def __init__(self, findings: Iterable[Finding]):
        self.findings: Tuple[Finding, ...] = tuple(findings)
        lines = "\n".join(f"  {f}" for f in self.findings)
        super().__init__(
            f"foldlint: {len(self.findings)} invariant violation(s):\n"
            f"{lines}")
