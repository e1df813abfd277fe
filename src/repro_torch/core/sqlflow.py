"""SQLFlow interface (paper §V.E): SQL -> COULER workflow.

COULER is SQLFlow's default backend; a statement like

    SELECT * FROM iris.train
    TO TRAIN DNNClassifier
    WITH model.n_classes = 3, model.hidden_units = [10]
    COLUMN sepal_len, sepal_width
    LABEL class
    INTO sqlflow_models.my_dnn_model;

compiles to a select -> train -> save workflow, and

    SELECT * FROM iris.test
    TO PREDICT iris.predict.class
    USING sqlflow_models.my_dnn_model;

compiles to select -> load-model -> predict -> write. This module parses
that dialect (the subset the paper shows) and emits the IR through the
unified API — the same IR every other frontend produces.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from repro_torch.core import api as couler
from repro_torch.core.ir import WorkflowIR


@dataclass
class TrainStatement:
    table: str
    estimator: str
    attrs: Dict[str, Any] = field(default_factory=dict)
    columns: List[str] = field(default_factory=list)
    label: str = ""
    into: str = ""


@dataclass
class PredictStatement:
    table: str
    output: str
    model: str


_TRAIN_RE = re.compile(
    r"SELECT\s+(?P<cols>.+?)\s+FROM\s+(?P<table>[\w.]+)\s+"
    r"TO\s+TRAIN\s+(?P<est>[\w.]+)"
    r"(?:\s+WITH\s+(?P<with>.*?))?"
    r"(?:\s+COLUMN\s+(?P<column>[\w,\s]+?))?"
    r"(?:\s+LABEL\s+(?P<label>\w+))?"
    r"\s+INTO\s+(?P<into>[\w.]+)\s*;?\s*$",
    re.IGNORECASE | re.DOTALL)

_PREDICT_RE = re.compile(
    r"SELECT\s+(?P<cols>.+?)\s+FROM\s+(?P<table>[\w.]+)\s+"
    r"TO\s+PREDICT\s+(?P<out>[\w.]+)\s+"
    r"USING\s+(?P<model>[\w.]+)\s*;?\s*$",
    re.IGNORECASE | re.DOTALL)


def parse(sql: str):
    """Parse one SQLFlow statement -> TrainStatement | PredictStatement."""
    sql = " ".join(sql.split())
    m = _TRAIN_RE.match(sql)
    if m:
        attrs: Dict[str, Any] = {}
        if m.group("with"):
            for part in re.split(r",(?![^\[]*\])", m.group("with")):
                if "=" not in part:
                    continue
                k, v = part.split("=", 1)
                v = v.strip()
                try:
                    attrs[k.strip()] = eval(v, {}, {})  # noqa: S307 literals
                except Exception:
                    attrs[k.strip()] = v
        cols = ([c.strip() for c in m.group("column").split(",")]
                if m.group("column") else [])
        return TrainStatement(table=m.group("table"), estimator=m.group("est"),
                              attrs=attrs, columns=cols,
                              label=m.group("label") or "",
                              into=m.group("into"))
    m = _PREDICT_RE.match(sql)
    if m:
        return PredictStatement(table=m.group("table"), output=m.group("out"),
                                model=m.group("model"))
    raise ValueError(f"unsupported SQLFlow statement: {sql[:80]}")


# ---------------------------------------------------------------------------
# lowering to the unified interface
# ---------------------------------------------------------------------------

class _SqlSteps:
    """Default step payloads (real tiny numpy compute)."""

    @staticmethod
    def select(table, columns=None, **kw):
        import numpy as np
        rng = np.random.default_rng(abs(hash(table)) % 2**31)
        n_cols = max(1, len(columns or []) or 4)
        return {"table": table, "X": rng.standard_normal((64, n_cols)),
                "y": rng.integers(0, 3, 64)}

    @staticmethod
    def train(data, estimator="", attrs=None, label="", **kw):
        import numpy as np
        X, y = data["X"], data["y"]
        n_classes = int((attrs or {}).get("model.n_classes", 3))
        W = np.zeros((X.shape[1], n_classes))
        for _ in range(20):                      # tiny softmax regression
            logits = X @ W
            p = np.exp(logits - logits.max(1, keepdims=True))
            p /= p.sum(1, keepdims=True)
            onehot = np.eye(n_classes)[y % n_classes]
            W -= 0.1 * X.T @ (p - onehot) / len(y)
        return {"estimator": estimator, "weights": W}

    @staticmethod
    def save_model(model, into="", **kw):
        return {"saved_as": into, **model}

    @staticmethod
    def load_model(name, registry=None, **kw):
        if registry and name in registry:
            return registry[name]
        return {"estimator": "unknown", "weights": None, "saved_as": name}

    @staticmethod
    def predict(data, model, output="", **kw):
        import numpy as np
        W = model.get("weights")
        if W is None:
            return {"output": output, "preds": []}
        preds = np.argmax(data["X"][:, : W.shape[0]] @ W, axis=1)
        return {"output": output, "preds": preds.tolist()}


def to_workflow(sql: str, name: str = "sqlflow",
                model_registry: Optional[Dict[str, Any]] = None) -> WorkflowIR:
    """One SQLFlow statement -> WorkflowIR via the unified API."""
    stmt = parse(sql)
    with couler.workflow(name) as ir:
        if isinstance(stmt, TrainStatement):
            data = couler.run_step(_SqlSteps.select, stmt.table,
                                   stmt.columns, step_name="select")
            model = couler.run_step(_SqlSteps.train, data,
                                    estimator=stmt.estimator,
                                    attrs=stmt.attrs, label=stmt.label,
                                    step_name="train")
            couler.run_step(_SqlSteps.save_model, model, into=stmt.into,
                            step_name="save-model")
        else:
            data = couler.run_step(_SqlSteps.select, stmt.table, None,
                                   step_name="select")
            model = couler.run_step(_SqlSteps.load_model, stmt.model,
                                    registry=model_registry,
                                    step_name="load-model")
            couler.run_step(_SqlSteps.predict, data, model,
                            output=stmt.output, step_name="predict")
    return ir


def run_sql(sql: str, engine=None, model_registry: Optional[Dict] = None):
    """Parse, lower and execute one statement; returns the WorkflowRun."""
    from repro_torch.core.engines.local import LocalEngine
    ir = to_workflow(sql, model_registry=model_registry)
    if engine is None:
        # throwaway engine: release its gateway threads after the run
        engine = LocalEngine()
        try:
            return engine.submit(ir)
        finally:
            engine.close()
    return engine.submit(ir)
