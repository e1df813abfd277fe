"""Fig. 8 analog on the port: automatic hyperparameter configuration.

The twin of ``benchmarks/bench_autotune.py``: HP:Ours (Alg. 4: surrogate-
predicted logs over the search space, ``repro_torch.core.autotune.tune``)
against HP-baseline1 ("expert pick") and HP-baseline2 ("literature
defaults"), each validated by training the port's small LM
(``repro_torch.core.autotune.train_real_model``) and reporting the measured
final losses. On the card unless ``--device cpu`` is given:

    PYTHONPATH=src python scripts/bench_autotune_torch.py [--device cpu] [--steps 60]
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Dict, List

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core.autotune import DataCard, ModelCard, train_real_model, tune  # noqa: E402

HP_BASELINE1 = {"learning_rate": 1e-4, "batch_size": 64,
                "weight_decay": 0.0}          # conservative expert pick
HP_BASELINE2 = {"learning_rate": 3e-4, "batch_size": 32,
                "weight_decay": 0.1}          # literature defaults


def run(steps: int = 60, device: str = "cuda") -> List[Dict]:
    dc = DataCard("synthetic-lm", n_examples=50_000, seq_len=32)
    mc = ModelCard("reduced-stablelm", n_params=600_000)
    ours = tune(dc, mc, llm=None).best
    rows = []
    for name, hp in (("HP:Ours", ours), ("HP-baseline1", HP_BASELINE1),
                     ("HP-baseline2", HP_BASELINE2)):
        out = train_real_model(hp, steps=steps, device=device)
        rows.append({"config": name, **{k: v for k, v in hp.items()},
                     "final_loss": round(out["final_loss"], 4),
                     "first_loss": round(out["losses"][0], 4)})
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=60)
    args = ap.parse_args(argv)
    print(json.dumps(run(args.steps, args.device), indent=1))


if __name__ == "__main__":
    main()
