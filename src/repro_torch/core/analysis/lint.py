"""Lint orchestrator + the submission-time gate.

``lint(wf)`` is the user-facing entry (also exported as ``couler.lint``);
``lint_gate`` is what engines call on every fresh submission: it lints,
records warnings in the workflow's configs, and raises
``WorkflowLintError`` under the default ``lint="error"`` mode.
"""
from __future__ import annotations

from typing import Optional, Sequence

from repro_torch.core.analysis.diagnostics import LintResult, Severity
from repro_torch.core.analysis.passes import ALL_PASSES, LintContext
from repro_torch.core.ir import WorkflowIR

LINT_MODES = ("error", "warn", "off")


def lint(wf: WorkflowIR, *, engine=None,
         clusters: Optional[Sequence] = None,
         max_inflight_steps: Optional[int] = None) -> LintResult:
    """Run every analysis pass over ``wf`` and return the diagnostics.

    Capacity-dependent passes (CLR005 cluster fit, CLR006 streaming
    depth vs. the in-flight bound) only fire when the corresponding
    context is supplied — either explicitly or via ``engine``, whose
    ``lint_context()`` contributes what it knows about its deployment.
    """
    if engine is not None:
        ctx_kw = dict(engine.lint_context())
        if clusters is not None:
            ctx_kw["clusters"] = clusters
        if max_inflight_steps is not None:
            ctx_kw["max_inflight_steps"] = max_inflight_steps
        ctx = LintContext(**ctx_kw)
    else:
        ctx = LintContext(clusters=clusters,
                          max_inflight_steps=max_inflight_steps)
    res = LintResult(workflow=wf.name)
    diags = res.diagnostics
    for p in ALL_PASSES:
        found = p(wf, ctx)
        if found:
            diags.extend(found)
    return res


def lint_gate(wf: WorkflowIR, mode: str = "error",
              **context) -> Optional[LintResult]:
    """Submission-time gate. ``mode``:

    * ``"error"`` (default) — ERROR diagnostics raise
      ``WorkflowLintError``; warnings/infos are recorded in
      ``wf.configs["lint_warnings"]``.
    * ``"warn"`` — nothing raises; all diagnostics are recorded.
    * ``"off"`` — no analysis at all (returns None).
    """
    if mode == "off":
        return None
    if mode not in LINT_MODES:
        raise ValueError(f"lint mode must be one of {LINT_MODES}, "
                         f"got {mode!r}")
    res = lint(wf, **context)
    if res.diagnostics:
        non_err = [d.as_dict() for d in res.diagnostics
                   if d.severity is not Severity.ERROR]
        if non_err:
            wf.configs["lint_warnings"] = non_err
        if mode == "error":
            res.raise_on_error()
    return res
