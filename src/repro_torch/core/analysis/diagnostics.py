"""Typed diagnostics emitted by the workflow linter.

Every finding carries a stable ``CLR0xx`` code (the public contract —
tests, the CI lint gate and ``docs/diagnostics.md`` key on it), a
severity, the offending job and a one-line fix hint. ``LintResult``
aggregates one lint run; ``WorkflowLintError`` is what a submission-time
``lint="error"`` gate raises.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Dict, List


class Severity(str, Enum):
    ERROR = "error"       # rejects the workflow under lint="error"
    WARNING = "warning"   # recorded in wf.configs["lint_warnings"]
    INFO = "info"         # advisory only

    def __str__(self) -> str:  # noqa: D105
        return self.value


#: code -> (default severity, short meaning). The authoritative
#: code/severity/meaning/fix table lives in docs/diagnostics.md.
CODES: Dict[str, tuple] = {
    "CLR001": (Severity.ERROR, "dependency cycle"),
    "CLR002": (Severity.WARNING, "isolated step (no edges in or out)"),
    "CLR003": (Severity.ERROR, "condition on an artifact nothing produces"),
    "CLR004": (Severity.ERROR, "chunk-wise consumer with >1 streamed input"),
    "CLR005": (Severity.ERROR, "resource request fits no cluster"),
    "CLR006": (Severity.ERROR, "streaming pipeline deeper than the "
                               "in-flight step bound"),
    "CLR007": (Severity.WARNING, "nondeterministic source in a cacheable "
                                 "step"),
    "CLR008": (Severity.ERROR, "input artifact has no producing step"),
    "CLR009": (Severity.INFO, "chunk-wise consumer over a non-streamed "
                              "source"),
}


@dataclass(frozen=True)
class Diagnostic:
    code: str
    severity: Severity
    message: str
    job: str = ""          # offending step name; "" = whole-workflow
    fix: str = ""          # one-line fix hint

    def as_dict(self) -> Dict[str, Any]:
        return {"code": self.code, "severity": self.severity.value,
                "job": self.job, "message": self.message, "fix": self.fix}

    def __str__(self) -> str:
        where = f" [{self.job}]" if self.job else ""
        hint = f" (fix: {self.fix})" if self.fix else ""
        return f"{self.code} {self.severity}{where}: {self.message}{hint}"


@dataclass
class LintResult:
    """All diagnostics from one ``lint(wf)`` run."""
    workflow: str
    diagnostics: List[Diagnostic] = field(default_factory=list)

    @property
    def errors(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity is Severity.ERROR]

    @property
    def warnings(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics
                if d.severity is Severity.WARNING]

    @property
    def infos(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity is Severity.INFO]

    def codes(self) -> set:
        return {d.code for d in self.diagnostics}

    def ok(self) -> bool:
        return not self.errors

    def raise_on_error(self) -> "LintResult":
        if self.errors:
            raise WorkflowLintError(self)
        return self

    def summary(self) -> str:
        if not self.diagnostics:
            return f"{self.workflow}: clean"
        return f"{self.workflow}: " + "; ".join(str(d)
                                                for d in self.diagnostics)


class WorkflowLintError(ValueError):
    """Raised at submission time when lint="error" finds ERROR diagnostics.

    Carries the full ``LintResult`` as ``.result``.
    """

    def __init__(self, result: LintResult):
        self.result = result
        errs = "; ".join(str(d) for d in result.errors)
        super().__init__(
            f"workflow {result.workflow!r} rejected by lint "
            f"({len(result.errors)} error(s)): {errs} — "
            f"pass lint='warn' or lint='off' to submit anyway")
