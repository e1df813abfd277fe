"""Tiered artifact cache subsystem (paper §IV.A, Eq. 3-6, Algorithm 2).

Layout:
  scoring.py   Eq. 3-6 math (+ the documented Eq. 4 literal/deviation flag)
               and the ``CachedArtifact`` record
  policies.py  NONE/ALL/FIFO/LRU/COULER admission+eviction policies and the
               ``promotion_scores`` ranking hook
  tiers.py     ``CacheTier`` capacity/bandwidth/latency cost models and the
               cross-cluster ``SharedRemoteTier``
  store.py     ``TieredCacheStore`` (MEM→SSD→REMOTE cascade, Eq. 6-driven
               background promotion) and the single-tier ``CacheStore``
               facade

``repro_torch.core.caching`` re-exports this package's public names for backward
compatibility; new code should import from here.
"""
from repro_torch.core.cache.scoring import (CachedArtifact, importance,
                                      predecessor_subgraph,
                                      reconstruction_cost, reuse_value,
                                      sizeof, successor_subgraph)
from repro_torch.core.cache.policies import (POLICIES, CacheAll, CachePolicy,
                                       CoulerPolicy, FIFOPolicy, LRUPolicy,
                                       NoCache)
from repro_torch.core.cache.tiers import (CacheTier, SharedRemoteTier, TierSpec,
                                    mem_spec, remote_spec, ssd_spec)
from repro_torch.core.cache.store import (CacheStore, TieredCacheStore,
                                    default_tiers)

__all__ = [
    "CachedArtifact", "importance", "predecessor_subgraph",
    "reconstruction_cost", "reuse_value", "sizeof", "successor_subgraph",
    "POLICIES", "CacheAll", "CachePolicy", "CoulerPolicy", "FIFOPolicy",
    "LRUPolicy", "NoCache",
    "CacheTier", "SharedRemoteTier", "TierSpec", "mem_spec", "remote_spec",
    "ssd_spec",
    "CacheStore", "TieredCacheStore", "default_tiers",
]
