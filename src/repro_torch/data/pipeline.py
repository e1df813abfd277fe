"""Data pipeline: deterministic synthetic corpus and a sharded file reader
with artifact-cache integration (paper App. D.C: table/file caching). Own
copies of ``repro/data/pipeline.py``'s ``_chain``, ``synthetic_batches``,
``ShardedCorpus`` and ``CachedShardReader`` (numpy only), the reader over
the port's copy of the workflow layer, ``repro_torch.core.caching``.

The synthetic corpus is a noisy affine token chain, learnable structure so
that training losses genuinely decrease. ``ShardedCorpus`` materializes
shards on disk (the "remote storage" stand-in); ``CachedShardReader`` reads
them through a ``CacheStore``, so repeated epochs and other consumers hit
the cache. ``tests/test_torch_train.py`` and ``tests/test_torch_workflow.py``
hold the copies equal to the originals.
"""
from __future__ import annotations

import threading
import time
from pathlib import Path
from queue import Queue
from typing import Dict, Iterator, List, Optional

import numpy as np

from repro_torch.core.caching import CacheStore


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


class ShardedCorpus:
    """Deterministic on-disk shard files (the 'remote' store)."""

    def __init__(self, root: str, n_shards: int = 8, tokens_per_shard: int = 65536,
                 vocab: int = 512, seed: int = 0, read_delay_s: float = 0.0):
        self.root = Path(root)
        self.n_shards = n_shards
        self.tokens_per_shard = tokens_per_shard
        self.vocab = vocab
        self.seed = seed
        self.read_delay_s = read_delay_s   # emulated remote-storage latency
        self.root.mkdir(parents=True, exist_ok=True)

    def shard_path(self, i: int) -> Path:
        return self.root / f"shard-{i:05d}.npy"

    def materialize(self) -> List[Path]:
        out = []
        for i in range(self.n_shards):
            p = self.shard_path(i)
            if not p.exists():
                rng = np.random.default_rng(self.seed * 1000 + i)
                np.save(p, _chain(rng, self.tokens_per_shard, self.vocab))
            out.append(p)
        return out

    def read_shard(self, i: int) -> np.ndarray:
        if self.read_delay_s:
            time.sleep(self.read_delay_s)      # remote round-trip
        return np.load(self.shard_path(i))


class CachedShardReader:
    """Reads shards through the artifact cache + background prefetch."""

    def __init__(self, corpus: ShardedCorpus, cache: Optional[CacheStore] = None,
                 prefetch: int = 2):
        self.corpus = corpus
        self.cache = cache or CacheStore(capacity_bytes=1 << 28)
        self.prefetch = prefetch
        self.read_times: List[float] = []

    def _key(self, i: int) -> str:
        return f"shard:{self.corpus.root.name}:{i}"

    def read(self, i: int) -> np.ndarray:
        t0 = time.time()
        hit = self.cache.get(self._key(i))
        if hit is not None:
            self.read_times.append(time.time() - t0)
            return hit.value
        arr = self.corpus.read_shard(i)
        dur = time.time() - t0
        self.read_times.append(dur)
        self.cache.offer(self._key(i), arr, compute_time_s=dur,
                         producer=f"shard-{i}")
        return arr

    def epoch(self, order: Optional[List[int]] = None) -> Iterator[np.ndarray]:
        order = order if order is not None else list(range(self.corpus.n_shards))
        q: Queue = Queue(maxsize=max(1, self.prefetch))
        done = object()

        def worker():
            for i in order:
                q.put(self.read(i))
            q.put(done)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is done:
                break
            yield item

    def batches(self, batch: int, seq: int, epochs: int = 1
                ) -> Iterator[Dict[str, np.ndarray]]:
        need = batch * (seq + 1)
        for _ in range(epochs):
            buf = np.empty(0, dtype=np.int32)
            for arr in self.epoch():
                buf = np.concatenate([buf, arr])
                while len(buf) >= need:
                    chunk, buf = buf[:need], buf[need:]
                    toks = chunk.reshape(batch, seq + 1)
                    yield {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
