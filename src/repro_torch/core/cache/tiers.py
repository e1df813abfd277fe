"""Cache tiers: capacity + bandwidth + access-latency cost models.

A ``CacheTier`` is one level of the tiered artifact store (paper §IV.A
generalized beyond the single Alluxio tier): it holds artifacts up to
``capacity_bytes`` and charges ``access_time_s(nbytes) = latency_s +
nbytes / bandwidth_bytes_s`` per fetch. Default specs model a node-local
memory tier, a node-local NVMe tier and a remote object/Alluxio tier.

``SharedRemoteTier`` is a ``CacheTier`` that may be attached as the last
tier of *multiple* ``TieredCacheStore``s (one per engine/cluster): demoted
artifacts become visible to every attached store, and hits are accounted
per client so cross-cluster reuse is measurable. All tier mutations go
through ``put``/``remove`` which keep a byte ledger (``bytes_in`` /
``bytes_out``) — ``TieredCacheStore.check_invariants`` asserts the ledger
matches ``used_bytes`` so demotions conserve bytes.
"""
from __future__ import annotations

import dataclasses
import threading
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from repro_torch.core.cache.scoring import CachedArtifact


@dataclass(frozen=True)
class TierSpec:
    name: str
    capacity_bytes: int
    bandwidth_bytes_s: float = 8e9
    latency_s: float = 0.0
    shared: bool = False


def mem_spec(capacity_bytes: int = 64 << 20) -> TierSpec:
    """Node-local memory: ~8 GB/s effective, microsecond latency."""
    return TierSpec("MEM", capacity_bytes, 8e9, 2e-6)


def ssd_spec(capacity_bytes: int = 512 << 20) -> TierSpec:
    """Node-local NVMe: ~1.2 GB/s, sub-millisecond latency."""
    return TierSpec("SSD", capacity_bytes, 1.2e9, 2.5e-4)


def remote_spec(capacity_bytes: int = 4 << 30) -> TierSpec:
    """Remote object store / Alluxio master: ~120 MB/s, 20 ms RTT."""
    return TierSpec("REMOTE", capacity_bytes, 1.2e8, 2e-2, shared=True)


# put/remove reasons -> tier stat counters
_IN_KEYS = {"admitted": "admissions", "demoted": "demotions_in",
            "promoted": "promotions_in"}
_OUT_KEYS = {"evicted": "evictions", "demoted": "demotions_out",
             "promoted": "promotions_out", "stale": "stale_drops"}


class CacheTier:
    """One capacity-bounded level of a tiered store.

    ``version`` is bumped on every mutation (including hit bookkeeping,
    which moves ``last_used`` and therefore LRU scores) so stores can
    lazily invalidate their per-tier eviction heaps — required for shared
    tiers, where another store's mutations are otherwise invisible.
    """

    def __init__(self, spec: TierSpec):
        self.spec = spec
        self.items: Dict[str, CachedArtifact] = {}
        self.used_bytes = 0
        self.version = 0
        self._lock = threading.RLock()
        self.stats = {"hits": 0, "admissions": 0, "demotions_in": 0,
                      "demotions_out": 0, "promotions_in": 0,
                      "promotions_out": 0, "evictions": 0, "stale_drops": 0,
                      "replaced": 0, "bytes_in": 0, "bytes_out": 0}

    @property
    def name(self) -> str:
        return self.spec.name

    @property
    def capacity_bytes(self) -> int:
        return self.spec.capacity_bytes

    @property
    def shared(self) -> bool:
        return self.spec.shared

    def access_time_s(self, nbytes: int) -> float:
        return self.spec.latency_s + nbytes / self.spec.bandwidth_bytes_s

    def fits(self, nbytes: int) -> bool:
        return nbytes <= self.spec.capacity_bytes

    def put(self, art: CachedArtifact, reason: str) -> Optional[CachedArtifact]:
        """Insert (replacing any same-key occupant); returns the replaced
        artifact so the store can count a refresh."""
        with self._lock:
            old = self.items.pop(art.name, None)
            if old is not None:
                self.used_bytes -= old.bytes
                self.stats["bytes_out"] += old.bytes
                self.stats["replaced"] += 1
            self.items[art.name] = art
            self.used_bytes += art.bytes
            self.stats["bytes_in"] += art.bytes
            self.stats[_IN_KEYS[reason]] += 1
            self.version += 1
            return old

    def put_if_fits(self, art: CachedArtifact,
                    reason: str) -> Tuple[bool, Optional[CachedArtifact]]:
        """Atomic capacity-check + insert — required for shared tiers,
        where another store may fill the tier between a caller's fit check
        and its put. Returns (inserted, replaced_occupant)."""
        with self._lock:
            old = self.items.get(art.name)
            freed = old.bytes if old is not None else 0
            if self.used_bytes - freed + art.bytes > self.spec.capacity_bytes:
                return False, None
            return True, self.put(art, reason)

    def snapshot_items(self) -> Dict[str, CachedArtifact]:
        """Point-in-time copy taken under the tier lock; iterate THIS, not
        ``items``, when the tier may be shared with other stores."""
        with self._lock:
            return dict(self.items)

    def remove(self, name: str, reason: str) -> Optional[CachedArtifact]:
        with self._lock:
            art = self.items.pop(name, None)
            if art is None:
                return None
            self.used_bytes -= art.bytes
            self.stats["bytes_out"] += art.bytes
            self.stats[_OUT_KEYS[reason]] += 1
            self.version += 1
            return art

    def record_hit(self, client: Optional[str] = None) -> None:
        with self._lock:
            self.stats["hits"] += 1
            self.version += 1          # hit moved last_used (LRU scores)

    def check_ledger(self) -> None:
        with self._lock:
            s = sum(a.bytes for a in self.items.values())
            assert s == self.used_bytes, \
                (self.name, "item bytes != used_bytes", s, self.used_bytes)
            net = self.stats["bytes_in"] - self.stats["bytes_out"]
            assert net == self.used_bytes, \
                (self.name, "byte ledger leak", net, self.used_bytes)
            assert self.used_bytes <= self.capacity_bytes, \
                (self.name, "over capacity", self.used_bytes,
                 self.capacity_bytes)


class SharedRemoteTier(CacheTier):
    """REMOTE tier shareable across engines/clusters.

    Attach the same instance as the last tier of several stores (one per
    cluster); ``hits_by_client`` records which cluster's store served each
    hit so cross-cluster artifact reuse is visible in benchmarks.
    """

    def __init__(self, spec: Optional[TierSpec] = None):
        spec = spec or remote_spec()
        if not spec.shared:            # normalize: sharing implies shared
            spec = dataclasses.replace(spec, shared=True)
        super().__init__(spec)
        self.hits_by_client: Dict[str, int] = {}

    def record_hit(self, client: Optional[str] = None) -> None:
        with self._lock:
            super().record_hit(client)
            c = client or "?"
            self.hits_by_client[c] = self.hits_by_client.get(c, 0) + 1
