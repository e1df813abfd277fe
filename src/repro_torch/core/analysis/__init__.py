"""Workflow static analysis: pre-submission lint + executable event spec.

Two independent layers share this package:

* **Linter** — ``lint(wf)`` runs a pass pipeline over a ``WorkflowIR``
  and returns a ``LintResult`` of typed ``Diagnostic``s with stable
  ``CLR0xx`` codes (see ``docs/diagnostics.md`` for the full table).
  Structural passes catch dependency cycles, isolated steps, conditions
  on artifacts nothing produces, streaming misuse (chunk-wise fan-in,
  pipelines deeper than the in-flight step bound) and resource requests
  no cluster can ever satisfy; an AST pass flags nondeterministic
  (unseeded RNG / wall-clock / uuid) sources inside ``cacheable=True``
  step functions before they can poison the artifact cache. Engines run
  ``lint_gate`` at submission time: errors reject the workflow (opt out
  with ``lint="warn"`` or ``lint="off"``), warnings land in
  ``wf.configs["lint_warnings"]``.

* **Trace checker** — ``TraceChecker`` is the executable specification
  of the gateway's six event-ordering invariants
  (``repro_torch.core.gateway``): a linear-time automaton consuming
  ``WorkflowEvent``s incrementally, either post-hoc
  (``TraceChecker.check(events, wf=...)``) or inline as a sanitizer
  (``WorkflowGateway(check_events=True)`` attaches one per run). A
  breach raises ``TraceViolation`` naming the invariant.
"""
from repro_torch.core.analysis.diagnostics import (CODES, Diagnostic, LintResult,
                                             Severity, WorkflowLintError)
from repro_torch.core.analysis.lint import lint, lint_gate
from repro_torch.core.analysis.ndet import nondeterminism_findings
from repro_torch.core.analysis.trace import TraceChecker, TraceViolation

__all__ = ["CODES", "Diagnostic", "LintResult", "Severity",
           "WorkflowLintError", "lint", "lint_gate",
           "nondeterminism_findings", "TraceChecker", "TraceViolation"]
