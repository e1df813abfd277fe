"""Argo Workflows backend: IR -> Argo ``Workflow`` YAML (paper §II.F).

The workflow generator converts the IR DAG to the executable format a
workflow engine consumes — "e.g., YAML format for Argo workflow". No
Kubernetes is needed to *generate*; this is the engine-agnosticism proof.
Emitted YAML validates the paper's CRD size constraint (2MB budget, §IV.B).
"""
from __future__ import annotations

from typing import List

from repro_torch.core.engines.base import Engine, StepRecord, StepStatus, WorkflowRun
from repro_torch.core.ir import Job, WorkflowIR


def _yaml_escape(s: str) -> str:
    if any(c in s for c in ":{}[]#&*!|>'\"%@`"):
        return '"' + s.replace("\\", "\\\\").replace('"', '\\"') + '"'
    return s or '""'


def job_to_template(job: Job) -> List[str]:
    lines = [f"  - name: {job.name}"]
    lines.append("    container:")
    lines.append(f"      image: {_yaml_escape(job.image or 'python:3.11')}")
    cmd = job.command or (["python", "-c", f"run('{job.name}')"]
                          if job.fn is not None else ["echo", job.name])
    lines.append("      command:")
    for c in cmd:
        lines.append(f"      - {_yaml_escape(str(c))}")
    lines.append("      resources:")
    lines.append("        requests:")
    lines.append(f"          cpu: {job.resources.cpu}")
    lines.append(f"          memory: {int(job.resources.mem_bytes / 2**20)}Mi")
    if job.retry_limit:
        lines.append("    retryStrategy:")
        lines.append(f"      limit: {job.retry_limit}")
        lines.append("      retryPolicy: OnTransientError")
    return lines


def to_argo_yaml(wf: WorkflowIR) -> str:
    """Emit an Argo Workflow manifest for the IR."""
    wf.validate()
    out: List[str] = [
        "apiVersion: argoproj.io/v1alpha1",
        "kind: Workflow",
        "metadata:",
        f"  generateName: {wf.name}-",
        "spec:",
        "  entrypoint: main",
        "  templates:",
        "  - name: main",
        "    dag:",
        "      tasks:",
    ]
    for name in wf.topo_order():
        job = wf.jobs[name]
        out.append(f"      - name: {name}")
        out.append(f"        template: {name}")
        deps = sorted(wf.predecessors(name))
        if deps:
            out.append(f"        dependencies: [{', '.join(deps)}]")
        if job.condition is not None:
            art = job.condition.artifact.replace(":", ".")
            out.append(f"        when: \"{{{{tasks.{art}}}}} == "
                       f"{job.condition.value}\"")
    for name in wf.topo_order():
        out.extend(job_to_template(wf.jobs[name]))
    return "\n".join(out) + "\n"


class ArgoSubmitter(Engine):
    """Generates the manifest; 'submission' returns it as the run artifact
    (no cluster in this container — the manifest is the deliverable)."""

    name = "argo"

    def __init__(self, crd_limit_bytes: int = 2 * 1024 * 1024):
        self.crd_limit_bytes = crd_limit_bytes

    def submit(self, wf: WorkflowIR, optimize: bool = True, **kw) -> WorkflowRun:
        from repro_torch.core.autosplit import Budget, split_workflow
        parts = (split_workflow(wf, Budget(spec_bytes=self.crd_limit_bytes))
                 if optimize else [wf])
        run = WorkflowRun(workflow=wf)
        manifests = []
        for p in parts:
            y = to_argo_yaml(p)
            if len(y.encode()) > self.crd_limit_bytes:
                raise ValueError(
                    f"CRD for {p.name} is {len(y.encode())}B > "
                    f"{self.crd_limit_bytes}B limit even after split")
            manifests.append(y)
        run.artifacts["argo:manifests"] = manifests
        for n in wf.jobs:
            run.steps[n] = StepRecord(status=StepStatus.PENDING)
        run.status = "Generated"
        return run
