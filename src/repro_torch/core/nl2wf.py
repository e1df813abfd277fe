"""NL -> unified programming interface (paper §III, Algorithm 1).

Step 1  Modular decomposition — a chain-of-thought pass segments the NL
        description into task modules classified against predefined task
        types (paper: "a series of predefined task types ... established to
        identify and extract pertinent tasks").
Step 2  Code generation — per subtask, retrieve reference code from the
        Code Lake and generate via the LLM interface.
Step 3  Self-calibration — LLM scores its own code; regenerate while
        s_i < S_b (bounded rounds; users may lower S_b, paper line 8 note).
Step 4  User feedback — optional callback revises the description and
        triggers regeneration.

``generated -> exec`` against ``repro_torch.core.api`` builds a real WorkflowIR;
the pass@k benchmark grades structural properties of that IR.
"""
from __future__ import annotations

import re
import textwrap
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

from repro_torch.core import api as couler_api
from repro_torch.core.ir import WorkflowIR
from repro_torch.core.llm import LLM, TemplateLLM

KNOWN_MODELS = ["resnet", "vit", "densenet", "lstm", "xgboost", "lightgbm",
                "bert", "gpt", "nanogpt", "cnn", "transformer", "mlp"]

TASK_TYPES = [
    ("load", ["load", "ingest", "read", "import", "fetch"]),
    ("preprocess", ["preprocess", "clean", "normalize", "tokenize",
                    "transform"]),
    ("augment", ["augment", "augmentation"]),
    ("split", ["split"]),
    ("train_multi", ["models", "each", "respectively", "candidates",
                     "compare"]),
    ("train", ["train", "fit", "fine-tune", "finetune", "fine tune"]),
    ("tune", ["hyperparameter", "tune", "search", "sweep"]),
    ("evaluate", ["evaluate", "validate", "validation", "metric", "assess"]),
    ("select", ["select", "choose", "best", "pick"]),
    ("deploy", ["deploy", "serve", "push", "release"]),
    ("report", ["report", "summary", "summarize"]),
    ("loop", ["until", "repeat", "repeatedly", "while"]),
    ("checkpoint", ["checkpoint", "save"]),
    ("concurrent", ["concurrently", "parallel", "same time"]),
]


def extract_entities(text: str) -> Dict[str, str]:
    t = text.lower()
    models = [m for m in KNOWN_MODELS if m in t]
    ents: Dict[str, str] = {}
    if models:
        ents["models"] = repr(models)
    m = re.search(r"(\d+)\s+(?:models|configurations|candidates|jobs|runs)", t)
    ents["count"] = m.group(1) if m else "3"
    m = re.search(r"dataset\s+(?:named\s+)?['\"]?([\w\-]+)", t)
    if m:
        ents["dataset"] = repr(m.group(1))
    for metric in ("accuracy", "f1", "auc", "loss", "perplexity"):
        if metric in t:
            ents["metric"] = repr(metric)
            break
    return ents


@dataclass
class Subtask:
    kind: str
    text: str


# canonical pipeline rank for the module spine ("predefined task types",
# paper §III step 1) — decomposition orders modules by ML-pipeline stage
_CANON = ["load", "preprocess", "augment", "split", "tune", "train_multi",
          "train", "loop", "concurrent", "evaluate", "select", "checkpoint",
          "deploy", "report"]


def decompose(description: str) -> List[Subtask]:
    """Step 1: chain-of-thought modular decomposition (rule-based CoT).

    Clauses are segmented aggressively (sentences, commas, connectives),
    classified against the predefined task types, de-duplicated by kind and
    re-ordered into the canonical pipeline spine."""
    many_models = len([m for m in KNOWN_MODELS
                       if m in description.lower()]) >= 2
    clauses = re.split(
        r"(?:[.;\n]|,|\b(?:then|and then|after that|next|finally)\b)",
        description)
    found: Dict[str, str] = {}
    for clause in clauses:
        c = clause.strip()
        if not c:
            continue
        cl = c.lower()
        for kind, kws in TASK_TYPES:
            if not any(k in cl for k in kws):
                continue
            if kind == "train_multi" and not many_models:
                continue
            if kind == "train":
                if many_models and ("each" in cl or "models" in cl
                                    or len([m for m in KNOWN_MODELS
                                            if m in cl]) >= 2):
                    kind = "train_multi"
            if kind not in found:
                found[kind] = c
            break
    if "train_multi" in found:
        found.pop("train", None)     # multi-model subsumes single train
    if "load" not in found:
        found["load"] = "load data from the dataset"
    if ("evaluate" not in found and ("select" in found
                                     or "train_multi" in found)):
        found["evaluate"] = "evaluate each trained model"
    if "preprocess" not in found and ("train" in found
                                      or "train_multi" in found):
        found["preprocess"] = "preprocess the raw data"
    return [Subtask(k, found[k]) for k in _CANON if k in found]


PRELUDE = textwrap.dedent("""\
    # auto-generated COULER workflow (NL -> unified interface)
    data = None; prep = None; trained = None; evals = []; best = None
""")


@dataclass
class GenerationResult:
    code: str
    subtask_codes: List[str]
    scores: List[float]
    rounds: List[int]
    tokens_used: int
    workflow: Optional[WorkflowIR] = None
    error: Optional[str] = None


def _assemble(subtask_codes: Sequence[str]) -> str:
    body = "".join(subtask_codes)
    # make sure identifiers exist even if a generation dropped a line
    return PRELUDE + body


def nl_to_workflow(description: str, llm: Optional[LLM] = None, *,
                   baseline_score: float = 0.55, max_rounds: int = 4,
                   temperature: float = 0.2, seed: int = 0,
                   feedback: Optional[Callable[[str, str], str]] = None,
                   execute: bool = True) -> GenerationResult:
    """Algorithm 1 end-to-end."""
    llm = llm or TemplateLLM("gpt-4")
    subtasks = decompose(description)                       # step 1
    codes, scores, rounds = [], [], []
    for i, st in enumerate(subtasks):
        prompt = (f"task: {st.kind}. {st.text}. "
                  f"||| context: {description[:300]}")
        best_code, best_score = "", -1.0
        r = 0
        for r in range(max_rounds):                         # steps 2-3
            code = llm.complete(prompt, temperature=temperature,
                                seed=seed * 131 + i * 17 + r)
            s = llm.score(prompt, code)
            if s > best_score:
                best_code, best_score = code, s
            if best_score >= baseline_score:
                break
        codes.append(best_code)
        scores.append(best_score)
        rounds.append(r + 1)

    code = _assemble(codes)
    if feedback is not None:                                # step 4
        revised = feedback(description, code)
        if revised and revised != description:
            return nl_to_workflow(revised, llm,
                                  baseline_score=baseline_score,
                                  max_rounds=max_rounds,
                                  temperature=temperature, seed=seed + 1,
                                  execute=execute)

    result = GenerationResult(code=code, subtask_codes=codes, scores=scores,
                              rounds=rounds,
                              tokens_used=getattr(llm, "tokens_used", 0))
    if execute:
        try:
            result.workflow = execute_generated(code)
        except Exception as e:  # noqa: BLE001
            result.error = f"{type(e).__name__}: {e}"
    return result


# ---------------------------------------------------------------------------
# execution sandbox for generated code
# ---------------------------------------------------------------------------

class _Steps:
    """Step zoo targeted by generated code (paper's 'step zoo')."""

    @staticmethod
    def load_data(dataset="data", **kw):
        return {"dataset": dataset, "rows": 1000}

    @staticmethod
    def preprocess(data=None, **kw):
        return {"prep": True}

    @staticmethod
    def augment(data=None, **kw):
        return {"aug": True}

    @staticmethod
    def split_data(data=None, **kw):
        return {"train": 0.8, "val": 0.2}

    @staticmethod
    def train_model(data=None, model="m", **kw):
        return {"model": str(model)}

    @staticmethod
    def finetune(data=None, model="m", **kw):
        return {"model": str(model), "finetuned": True}

    @staticmethod
    def evaluate(trained=None, metric="accuracy", **kw):
        return {"metric": metric, "value": 0.9}

    @staticmethod
    def select_best(*evals, **kw):
        return True

    @staticmethod
    def deploy(best=None, **kw):
        return "deployed"

    @staticmethod
    def report(best=None, **kw):
        return "report"

    @staticmethod
    def check(data=None, **kw):
        return True

    @staticmethod
    def save_checkpoint(trained=None, **kw):
        return "ckpt"

    @staticmethod
    def hp_grid(n=3):
        return [{"lr": 10 ** -(2 + i)} for i in range(int(n))]


def execute_generated(code: str, name: str = "generated") -> WorkflowIR:
    """Run generated COULER code in a sandbox; returns the built IR."""
    with couler_api.workflow(name) as ir:
        ns = {"couler": couler_api, "steps": _Steps}
        exec(compile(code, "<generated>", "exec"), ns)   # noqa: S102
    ir.validate()
    return ir
