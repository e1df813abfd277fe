"""Token batches from the seed: a frozen copy of the program's synthetic
corpus (``repro_torch/data/pipeline.py``: a noisy affine chain), so every
seed gives the same number of rows of the same length, only other tokens."""
from __future__ import annotations

from typing import Dict, List

import numpy as np


def _chain(rng: np.random.Generator, n: int, vocab: int) -> np.ndarray:
    a, c = 31, 17
    x = np.empty(n, dtype=np.int32)
    x[0] = rng.integers(0, vocab)
    noise = rng.random(n)
    rand = rng.integers(0, vocab, n)
    for i in range(1, n):
        x[i] = (a * x[i - 1] + c) % vocab if noise[i] > 0.15 else rand[i]
    return x


def batches(seed: int, n: int, rows: int, seq: int, vocab: int) -> List[Dict[str, np.ndarray]]:
    """``n`` distinct batches of ``rows`` sequences: tokens and the targets
    one position on, int64, from their own stream of the seed."""
    rng = np.random.default_rng([seed % (1 << 64), 1])
    out = []
    for _ in range(n):
        toks = _chain(rng, rows * (seq + 1), vocab).reshape(rows, seq + 1).astype(np.int64)
        out.append({"tokens": toks[:, :-1], "targets": toks[:, 1:]})
    return out
