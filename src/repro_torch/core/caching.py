"""Automatic artifact caching (paper §IV.A, Eq. 3-6, Algorithm 2) — facade.

The implementation lives in the ``repro_torch.core.cache`` package:

  * Eq. 3-6 scoring (``cache/scoring.py``) — note ``reuse_value``'s
    documented Eq. 4 choice: the default weights by |zeta_ui| so direct
    successors count most; ``literal_eq4=True`` gives the equation exactly
    as printed (which zeroes direct successors). See that module's
    docstring; both behaviors are pinned by tests.
  * Policies NONE/ALL/FIFO/LRU/COULER (``cache/policies.py``) with the
    memoized Eq. 3/4 hot path described there.
  * ``TieredCacheStore`` — MEM/SSD/REMOTE tiers, demotion cascade, Eq. 6
    background promotion, cross-cluster ``SharedRemoteTier``
    (``cache/tiers.py`` + ``cache/store.py``).

``CacheStore`` here is the legacy single-tier API, now a facade over the
tiered machinery: one MEM-like tier, so Algorithm 2 behaves exactly as the
pre-tier implementation (engines call ``store.offer(...)`` when a job
finishes and ``store.get(...)`` before running one; eviction re-scores
remaining items through lazily invalidated heaps + policy memos).

This module re-exports every public name so existing imports keep working.
"""
from repro_torch.core.cache import (  # noqa: F401
    POLICIES, CacheAll, CachePolicy, CacheStore, CacheTier, CachedArtifact,
    CoulerPolicy, FIFOPolicy, LRUPolicy, NoCache, SharedRemoteTier,
    TierSpec, TieredCacheStore, default_tiers, importance, mem_spec,
    predecessor_subgraph, reconstruction_cost, remote_spec, reuse_value,
    sizeof, ssd_spec, successor_subgraph,
)

__all__ = [
    "POLICIES", "CacheAll", "CachePolicy", "CacheStore", "CacheTier",
    "CachedArtifact", "CoulerPolicy", "FIFOPolicy", "LRUPolicy", "NoCache",
    "SharedRemoteTier", "TierSpec", "TieredCacheStore", "default_tiers",
    "importance", "mem_spec", "predecessor_subgraph", "reconstruction_cost",
    "remote_spec", "reuse_value", "sizeof", "ssd_spec",
    "successor_subgraph",
]
