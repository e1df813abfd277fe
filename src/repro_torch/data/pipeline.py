"""Deterministic synthetic corpus: own copies of ``_chain`` and
``synthetic_batches`` from ``repro/data/pipeline.py`` (numpy only).

The corpus is a noisy affine token chain, learnable structure so that
training losses genuinely decrease. ``tests/test_torch_train.py`` holds the
copies equal to the originals. ``ShardedCorpus`` and ``CachedShardReader``
read through ``repro.core``'s artifact cache and come with the workflow
seams.
"""
from __future__ import annotations

from typing import Dict, Iterator

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


def synthetic_batches(batch: int, seq: int, vocab: int, seed: int = 0,
                      n: int = 100) -> Iterator[Dict[str, np.ndarray]]:
    rng = np.random.default_rng(seed)
    for _ in range(n):
        toks = _chain(rng, batch * (seq + 1), vocab).reshape(batch, seq + 1)
        yield {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
