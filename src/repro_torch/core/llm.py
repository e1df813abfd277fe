"""LLM interface + deterministic surrogates (DESIGN.md §2.4).

No network access in this container, so ChatGPT-3.5/4 are replaced by a
pluggable ``LLM`` interface with two seeded surrogates:

* ``TemplateLLM`` — code generation by retrieval + template filling over the
  Code Lake, with a temperature-controlled error model (drops lines, picks
  the 2nd-best template, corrupts an argument). The error rates differ per
  simulated model tier ("gpt-3.5" noisier than "gpt-4"). pass@k numbers
  measured against the executable grader are therefore *real measurements of
  this error model*, not transcribed paper numbers.

* ``SurrogateLLM`` — hyperparameter -> predicted-training-log oracle
  (paper Alg. 4 "Predicted Training Log") built from scaling-law heuristics:
  loss(step) = L_inf + A * step^-0.3, penalized by distance of lr from a
  size-derived optimum and by batch/warmup mismatches.
"""
from __future__ import annotations

import hashlib
import math
import random
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple


def _seed_from(*parts) -> int:
    h = hashlib.sha256("|".join(str(p) for p in parts).encode()).hexdigest()
    return int(h[:12], 16)


class LLM:
    name = "llm"

    def complete(self, prompt: str, temperature: float = 0.2,
                 seed: int = 0) -> str:
        raise NotImplementedError

    def score(self, prompt: str, code: str) -> float:
        raise NotImplementedError

    def count_tokens(self, text: str) -> int:
        return max(1, len(text) // 4)


# ---------------------------------------------------------------------------
# retrieval + template generation with an explicit error model
# ---------------------------------------------------------------------------

def _bow(text: str) -> Dict[str, float]:
    words = re.findall(r"[a-zA-Z_]+", text.lower())
    d: Dict[str, float] = {}
    for w in words:
        d[w] = d.get(w, 0.0) + 1.0
    return d


def cosine(a: Dict[str, float], b: Dict[str, float]) -> float:
    num = sum(v * b.get(k, 0.0) for k, v in a.items())
    na = math.sqrt(sum(v * v for v in a.values()))
    nb = math.sqrt(sum(v * v for v in b.values()))
    return num / (na * nb) if na and nb else 0.0


@dataclass
class ModelTier:
    name: str
    miss_rate: float          # chance of picking a worse template
    corrupt_rate: float       # chance of corrupting a filled argument
    drop_rate: float          # chance of dropping a code line
    cost_per_1k_tokens: float


TIERS = {
    "gpt-3.5": ModelTier("gpt-3.5", miss_rate=0.38, corrupt_rate=0.22,
                         drop_rate=0.12, cost_per_1k_tokens=0.0015),
    "gpt-4": ModelTier("gpt-4", miss_rate=0.25, corrupt_rate=0.14,
                       drop_rate=0.07, cost_per_1k_tokens=0.036),
}


class TemplateLLM(LLM):
    """Generation = nearest-template retrieval + slot filling + noise."""

    def __init__(self, tier: str = "gpt-4",
                 codelake: Optional[Sequence[Tuple[str, str]]] = None,
                 use_references: bool = True):
        self.tier = TIERS[tier]
        self.name = tier
        from repro_torch.core.codelake import SNIPPETS
        self.lake = list(codelake) if codelake is not None else list(SNIPPETS)
        self.use_references = use_references
        self.tokens_used = 0

    def _retrieve(self, query: str, k: int = 3) -> List[Tuple[float, str, str]]:
        q = _bow(query.split("|||")[0])   # retrieval ignores fill-context
        scored = sorted(((cosine(q, _bow(desc + " " + code)), desc, code)
                         for desc, code in self.lake), reverse=True)
        return scored[:k]

    def complete(self, prompt: str, temperature: float = 0.2,
                 seed: int = 0) -> str:
        rng = random.Random(_seed_from(prompt, temperature, seed, self.name))
        self.tokens_used += self.count_tokens(prompt)
        cands = self._retrieve(prompt, k=3)
        if not cands:
            return "# no reference found\n"
        # error model: temperature and tier drive template misses
        idx = 0
        p_miss = self.tier.miss_rate * (0.5 + temperature)
        if not self.use_references:
            p_miss = min(0.95, p_miss * 2.2)   # no Code Lake -> blind guess
        if len(cands) > 1 and rng.random() < p_miss:
            idx = rng.randint(1, len(cands) - 1)
        code = cands[idx][2]
        code = self._fill(code, prompt, rng)
        lines = code.splitlines()
        out_lines = []
        for ln in lines:
            if (ln.strip() and not ln.strip().startswith("#")
                    and rng.random() < self.tier.drop_rate * (0.4 + temperature)):
                continue                        # dropped line
            out_lines.append(ln)
        out = "\n".join(out_lines) + "\n"
        self.tokens_used += self.count_tokens(out)
        return out

    def _fill(self, code: str, prompt: str, rng: random.Random) -> str:
        """Fill {slot} placeholders from entities found in the prompt."""
        from repro_torch.core.nl2wf import extract_entities
        ents = extract_entities(prompt)
        def sub(m):
            slot = m.group(1)
            val = ents.get(slot)
            if val is None:
                val = {"models": "['model-a']", "dataset": "'data'",
                       "count": "2", "metric": "'accuracy'",
                       "name": "'step'"}.get(slot, "'x'")
            if rng.random() < self.tier.corrupt_rate * 0.5:
                val = "'???'"                   # corrupted argument
            return str(val)
        return re.sub(r"\{(\w+)\}", sub, code)

    def score(self, prompt: str, code: str) -> float:
        """Self-calibration scorer (paper step 3): template compliance +
        syntactic validity. Compliance compares the step-zoo calls in the
        generated code against the best-matching reference template —
        sharper than raw token cosine (templates share most surface tokens)."""
        self.tokens_used += self.count_tokens(prompt + code)
        try:
            compile(code, "<gen>", "exec")
            syn = 1.0
        except SyntaxError:
            syn = 0.0
        best = self._retrieve(prompt, k=1)
        if best:
            want = set(re.findall(r"steps\.(\w+)|couler\.(\w+)", best[0][2]))
            got = set(re.findall(r"steps\.(\w+)|couler\.(\w+)", code))
            union = want | got
            sim = len(want & got) / len(union) if union else 0.0
        else:
            sim = 0.0
        bad = 1.0 if "'???'" in code else 0.0
        return max(0.0, 0.4 * syn + 0.6 * sim - 0.4 * bad)

    def cost_usd(self) -> float:
        return self.tokens_used / 1000.0 * self.tier.cost_per_1k_tokens


# ---------------------------------------------------------------------------
# hyperparameter -> predicted training log (Alg. 4)
# ---------------------------------------------------------------------------

class SurrogateLLM(LLM):
    """Predicts a training log for (DataCard, ModelCard, hyperparams)."""

    name = "surrogate"

    def predict_training_log(self, data_card: Dict, model_card: Dict,
                             hparams: Dict, steps: int = 200) -> Dict:
        n_params = float(model_card.get("n_params", 1e8))
        n_data = float(data_card.get("n_examples", 1e5))
        lr = float(hparams.get("learning_rate", 3e-4))
        bs = float(hparams.get("batch_size", 32))
        wd = float(hparams.get("weight_decay", 0.1))

        lr_opt = 0.003 * (n_params / 1e8) ** -0.25
        bs_opt = 32.0 * (n_data / 1e5) ** 0.5
        lr_pen = math.exp(0.45 * (math.log(lr / lr_opt)) ** 2) - 1.0
        bs_pen = 0.08 * abs(math.log(bs / bs_opt))
        wd_pen = 0.05 * abs(math.log(max(wd, 1e-4) / 0.1))
        l_inf = 1.8 + 0.25 * math.log10(1e9 / n_params)

        log_lines, losses = [], []
        for s in range(1, steps + 1):
            base = l_inf + 4.0 * s ** -0.3
            loss = base * (1.0 + 0.15 * lr_pen + bs_pen + wd_pen)
            if lr > 8 * lr_opt:                     # divergence regime
                loss = base * (1.0 + 0.05 * s * lr / lr_opt * 0.01)
            losses.append(loss)
            if s % max(1, steps // 10) == 0:
                log_lines.append(f"step {s} loss {loss:.4f} lr {lr:.2e}")
        acc = max(0.0, min(0.97, 1.25 - 0.18 * losses[-1]))
        return {"hparams": dict(hparams), "final_loss": losses[-1],
                "final_accuracy": acc, "losses": losses,
                "log": "\n".join(log_lines)}

    def complete(self, prompt: str, temperature: float = 0.2, seed: int = 0):
        return "surrogate-llm"

    def score(self, prompt: str, code: str) -> float:
        return 1.0
