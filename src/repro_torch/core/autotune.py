"""Automatic hyperparameter tuning (paper §IV.C, Algorithm 4).

Data Card (Gebru et al.) + Model Card (Mitchell et al.) + a candidate
hyperparameter set H -> the LLM predicts a training log per h_i (no real
hardware), and the tuner picks h_t with the best predicted performance.
``validate_on_real_model`` then ACTUALLY trains a small JAX model with the
chosen h_t vs the baselines (our Fig. 8 analog in benchmarks).
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

from repro_torch.core.llm import SurrogateLLM


@dataclass
class DataCard:
    """Paper: dataset name, input type, label space, default eval metrics."""
    name: str
    input_type: str = "text"
    label_space: str = "tokens"
    eval_metric: str = "loss"
    n_examples: int = 100_000
    seq_len: int = 256

    def as_dict(self) -> Dict[str, Any]:
        return self.__dict__.copy()


@dataclass
class ModelCard:
    """Paper: model name, structure, descriptions, architecture hparams."""
    name: str
    structure: str = "decoder-transformer"
    description: str = ""
    n_params: int = 10_000_000
    arch_hparams: Dict[str, Any] = field(default_factory=dict)

    def as_dict(self) -> Dict[str, Any]:
        d = self.__dict__.copy()
        d.pop("arch_hparams")
        d.update(self.arch_hparams)
        return d


def default_search_space() -> List[Dict[str, Any]]:
    lrs = [1e-4, 3e-4, 1e-3, 3e-3]
    batch = [16, 32, 64]
    wd = [0.0, 0.1]
    return [{"learning_rate": lr, "batch_size": b, "weight_decay": w}
            for lr, b, w in itertools.product(lrs, batch, wd)]


@dataclass
class TuneResult:
    best: Dict[str, Any]
    predicted_logs: List[Dict[str, Any]]
    ranking: List[Dict[str, Any]]


def tune(data_card: DataCard, model_card: ModelCard,
         search_space: Optional[Sequence[Dict[str, Any]]] = None,
         llm: Optional[SurrogateLLM] = None, steps: int = 200) -> TuneResult:
    """Algorithm 4: predicted log per h_i; pick best final metric."""
    llm = llm or SurrogateLLM()
    space = list(search_space or default_search_space())
    logs = [llm.predict_training_log(data_card.as_dict(),
                                     model_card.as_dict(), h, steps=steps)
            for h in space]                                      # lines 3-6
    ranked = sorted(logs, key=lambda d: d["final_loss"])         # lines 7-8
    return TuneResult(best=ranked[0]["hparams"], predicted_logs=logs,
                      ranking=[r["hparams"] for r in ranked])


# ---------------------------------------------------------------------------
# real-model validation (drives the Fig. 8 analog)
# ---------------------------------------------------------------------------

def train_real_model(hparams: Dict[str, Any], *, steps: int = 60,
                     d_model: int = 64, vocab: int = 256, seed: int = 0,
                     device: str = "cuda", init_state=None) -> Dict[str, Any]:
    """Actually train a tiny LM of the port with the given hyperparameters
    on ``device`` and return its measured loss curve (no surrogate). The
    model, data and hparams keys are those of the JAX package's function.
    ``init_state(cfg, tcfg)``, when given, returns the train state to start
    from in place of the port's own init of ``seed`` (the port cannot
    reproduce ``jax.random``: a test starts both from JAX's init, bridged)."""
    from repro_torch.configs import get_arch, reduced
    from repro_torch.training import train as TR
    from repro_torch.data.pipeline import synthetic_batches

    spec = get_arch("stablelm-1.6b")
    cfg = reduced(spec.model).replace(
        d_model=d_model, vocab_size=vocab, pad_vocab_multiple=16,
        param_dtype="float32", compute_dtype="float32")
    tcfg = spec.train.__class__(
        optimizer="adamw",
        learning_rate=float(hparams.get("learning_rate", 3e-4)),
        weight_decay=float(hparams.get("weight_decay", 0.1)),
        remat="none")
    bs = int(hparams.get("batch_size", 16))
    state = (TR.init_train_state(cfg, tcfg, seed, device=device)
             if init_state is None else init_state(cfg, tcfg))
    step = TR.make_train_step(cfg, tcfg)
    losses = []
    for i, batch in enumerate(synthetic_batches(
            batch=bs, seq=32, vocab=cfg.vocab_size, seed=seed, n=steps)):
        state, m = step(state, TR.to_device(batch, device))
        losses.append(float(m["loss"]))
    return {"hparams": dict(hparams), "losses": losses,
            "final_loss": sum(losses[-5:]) / 5}
