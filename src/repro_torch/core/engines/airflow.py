"""Apache Airflow backend: IR -> Airflow DAG python source (paper §II.F, §V).

Couler reports ~40-50% Airflow API coverage; this generator covers the DAG
structure, PythonOperator tasks, retries and trigger rules — the subset the
unified interface exercises.
"""
from __future__ import annotations

from typing import List

from repro_torch.core.engines.base import Engine, StepRecord, StepStatus, WorkflowRun
from repro_torch.core.ir import WorkflowIR


def to_airflow_dag(wf: WorkflowIR) -> str:
    wf.validate()
    lines: List[str] = [
        "from datetime import datetime",
        "from airflow import DAG",
        "from airflow.operators.python import PythonOperator",
        "",
        f"with DAG(dag_id={wf.name!r}, start_date=datetime(2024, 1, 1),",
        "         schedule=None, catchup=False) as dag:",
    ]
    ids = {}
    for name in wf.topo_order():
        job = wf.jobs[name]
        var = "t_" + name.replace("-", "_").replace(":", "_")
        ids[name] = var
        fn_name = getattr(job.fn, "__name__", "noop") if job.fn else "noop"
        lines.append(f"    {var} = PythonOperator(")
        lines.append(f"        task_id={name!r},")
        lines.append(f"        python_callable=lambda: {fn_name!r},")
        lines.append(f"        retries={job.retry_limit},")
        if job.condition is not None:
            lines.append("        trigger_rule='none_failed_min_one_success',")
        lines.append("    )")
    for s, d in sorted(wf.edges):
        lines.append(f"    {ids[s]} >> {ids[d]}")
    return "\n".join(lines) + "\n"


class AirflowSubmitter(Engine):
    name = "airflow"

    def submit(self, wf: WorkflowIR, optimize: bool = True, **kw) -> WorkflowRun:
        run = WorkflowRun(workflow=wf)
        run.artifacts["airflow:dag.py"] = to_airflow_dag(wf)
        for n in wf.jobs:
            run.steps[n] = StepRecord(status=StepStatus.PENDING)
        run.status = "Generated"
        return run
