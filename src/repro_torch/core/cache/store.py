"""Tiered artifact store: Algorithm 2 generalized to MEM/SSD/REMOTE.

``TieredCacheStore`` composes an ordered list of ``CacheTier``s (fastest
first). Behavior per paper §IV.A, extended for multi-stage caching:

* **Admission** lands in the highest tier that can hold the artifact
  (normally MEM) and follows Algorithm 2 within that tier: if the tier is
  full, the newcomer's Eq. 6 score is compared against the tier's
  lowest-scored occupants.
* **Demotion cascades**: an occupant displaced from tier *t* is offered to
  tier *t+1* under the same contest rather than dropped; only artifacts
  displaced off the LAST tier are truly evicted. A newcomer that loses its
  contest cascades down the same way and is only ``rejected`` when it
  loses at the last tier.
* **Promotion** is a background pass (``promote()``, optionally automatic
  every ``auto_promote_every`` hits): every artifact is re-ranked by the
  policy's ``promotion_scores`` — for ``CoulerPolicy`` the Eq. 6 factor
  with observed hits folded into Eq. 4's reuse events and V(u) normalized
  per tier — and the ranking is greedily re-packed into the tiers, so hot
  artifacts climb back toward MEM and cold ones sink.
* **Sharing**: a ``SharedRemoteTier`` may be attached to several stores;
  ``promote()`` never steals from it — promoting a shared artifact into a
  private tier *copies* it up, leaving the remote replica for other
  clusters.

Eviction candidates come from per-tier lazily invalidated min-heaps keyed
on (store epoch, tier version): mutations only bump counters, and a heap
is rebuilt — through the policy's Eq. 3/4 memos, so unchanged items cost
O(1) — the next time a victim is actually needed.

``CacheStore`` (the legacy single-tier API from ``repro_torch.core.caching``) is
a facade: one MEM-like tier, so Algorithm 2 degenerates to exactly the
pre-tier behavior — losing newcomers are rejected, displaced occupants are
evicted — with the same ``offer``/``get``/stats surface.

Chunk-granular entries (streaming pipelines)
--------------------------------------------
A streaming step with cache key ``K`` offers each chunk *i* under
``"K#c{i}"`` and, after the stream closes, a manifest ``"K#n"`` holding the
chunk count. The store itself treats these as ordinary artifacts — they are
admitted, demoted, promoted, and evicted independently, so the byte
ledger and Eq. 6 scoring need no special cases and a chunk run may span
MEM/SSD/REMOTE. The *contract* lives in the key scheme: the manifest is
offered last, so its presence promises the full run was offered once; a
replaying engine probes ``K#c0, K#c1, …`` until the first miss and
recomputes only the tail (chunks evicted mid-run simply shorten the
replayable prefix). Chunk streams are deterministic — equal key implies
equal chunk sequence — which is what makes a cached prefix + recomputed
tail equivalent to a full recompute.

Concurrent scoring contexts
---------------------------
``attach_workflow`` registers (not replaces) a workflow: many concurrent
runs may share one store, and each offered artifact carries a weakref to
its own producer DAG (``CachedArtifact.wf_ref``), which the Couler policy
scores against — so interleaved workflows no longer thrash the Eq. 3/4
memo or each other's frontier. ``store.workflow`` remains the most
recently attached DAG, used only as the fallback for artifacts offered
without a workflow.
"""
from __future__ import annotations

import heapq
import time
import weakref
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.cache.policies import CachePolicy, CoulerPolicy
from repro_torch.core.cache.scoring import CachedArtifact, sizeof
from repro_torch.core.cache.tiers import (CacheTier, TierSpec, mem_spec,
                                    remote_spec, ssd_spec)
from repro_torch.core.ir import WorkflowIR
from repro_torch.core.obs.metrics import MetricsRegistry, StatsView


class _TierView:
    """Legacy ``CacheStore`` surface handed to policies when scoring one
    tier: V(u) normalizes to the TIER capacity, while ``items`` spans the
    whole store so Eq. 3's cached frontier sees every tier."""

    __slots__ = ("items", "capacity_bytes", "workflow")

    def __init__(self, items: Dict[str, CachedArtifact],
                 capacity_bytes: int, workflow: Optional[WorkflowIR]):
        self.items = items
        self.capacity_bytes = capacity_bytes
        self.workflow = workflow


class TieredCacheStore:
    """Multi-tier artifact store; see module docstring for semantics."""

    _STAT_KEYS = ("hits", "misses", "evictions", "admitted", "rejected",
                  "refreshed", "demotions", "promotions", "promote_passes",
                  "fetch_s", "score_time_s")

    def __init__(self, tiers: Optional[Sequence[CacheTier]] = None,
                 policy: Optional[CachePolicy] = None, name: str = "store",
                 auto_promote_every: int = 0,
                 registry: Optional[MetricsRegistry] = None):
        import threading
        self.name = name
        self.tiers: List[CacheTier] = (list(tiers) if tiers is not None
                                       else default_tiers())
        if not self.tiers:
            raise ValueError("need at least one tier")
        self.policy = policy or CoulerPolicy()
        self.workflow: Optional[WorkflowIR] = None
        self.auto_promote_every = auto_promote_every
        self._hits_since_promote = 0
        # hits THIS store served from shared tiers, by artifact name —
        # gates promote()'s copy-up so only locally hot replicas copy up
        self._shared_uses: Dict[str, int] = {}
        self._insertions = 0
        self._lock = threading.RLock()      # engines offer() from workers
        # per-event counters live in a metrics registry (fetch_s /
        # score_time_s are float counters there too); ``stats`` is a
        # dict-compatible view so the legacy surface survives unchanged
        self.registry = registry if registry is not None \
            else MetricsRegistry("cache")
        self._m = {k: self.registry.counter(
                       f"cache_{k}_total" if k not in ("fetch_s",
                                                       "score_time_s")
                       else f"cache_{k}", store=self.name)
                   for k in self._STAT_KEYS}
        self.registry.gauge_fn(f"cache_used_bytes{{store={self.name}}}",
                               lambda: self.used_bytes)
        for t in self.tiers:
            self.registry.gauge_fn(
                f"cache_tier_used_bytes{{store={self.name},tier={t.name}}}",
                (lambda tier: lambda: tier.used_bytes)(t))
        if hasattr(self.policy, "bind_metrics"):
            self.policy.bind_metrics(self.registry)
        self._epoch = 0                     # bumped on score-moving changes
        # per-tier lazily invalidated (score, insertion, name) min-heaps
        self._heaps: List[List[Tuple[float, int, str]]] = \
            [[] for _ in self.tiers]
        self._heap_keys: List[Optional[Tuple[int, int]]] = \
            [None for _ in self.tiers]
        self._wf_versions: Optional[Tuple] = None
        # every workflow whose artifacts may live here (weak: a finished
        # run's DAG must not be pinned by the cache); scoring contexts are
        # per-artifact via CachedArtifact.wf_ref
        self._workflows: "weakref.WeakValueDictionary[int, WorkflowIR]" = \
            weakref.WeakValueDictionary()

    @property
    def stats(self) -> StatsView:
        return StatsView(self._m)

    # -- legacy surface ----------------------------------------------------
    @property
    def items(self) -> Dict[str, CachedArtifact]:
        """Merged name → artifact view across tiers (upper tiers win)."""
        merged: Dict[str, CachedArtifact] = {}
        for t in reversed(self.tiers):
            merged.update(t.snapshot_items() if t.shared else t.items)
        return merged

    @property
    def used_bytes(self) -> int:
        return sum(t.used_bytes for t in self.tiers)

    @property
    def capacity_bytes(self) -> int:
        return sum(t.capacity_bytes for t in self.tiers)

    def attach_workflow(self, wf: WorkflowIR) -> None:
        """Register ``wf`` as a scoring context (additive — concurrent
        workflows sharing the store do not displace each other; re-attaching
        an already-registered workflow is free and bumps nothing)."""
        with self._lock:
            self.workflow = wf
            k = id(wf)
            if self._workflows.get(k) is not wf:
                self._workflows[k] = wf
                self._epoch += 1

    def hit_ratio(self) -> float:
        h = self._m["hits"].value
        tot = h + self._m["misses"].value
        return h / tot if tot else 0.0

    def contains(self, name: str) -> bool:
        return any(name in t.items for t in self.tiers)

    def find_tier(self, name: str) -> Optional[CacheTier]:
        """Highest tier holding `name`; no stats mutation (placement
        planners use this to price a fetch without recording a hit)."""
        for t in self.tiers:
            if name in t.items:
                return t
        return None

    # -- access ------------------------------------------------------------
    def get(self, name: str) -> Optional[CachedArtifact]:
        with self._lock:
            for t in self.tiers:
                art = t.items.get(name)
                if art is None:
                    continue
                art.last_used = time.time()
                art.uses += 1
                t.record_hit(self.name)
                if t.shared:
                    # per-STORE use count: art.uses aggregates every
                    # attached cluster, so promote()'s copy-up eligibility
                    # must not key on it (a cluster would replicate
                    # artifacts only its siblings ever touched)
                    if len(self._shared_uses) >= 4096:
                        self._shared_uses.clear()
                    self._shared_uses[name] = \
                        self._shared_uses.get(name, 0) + 1
                self._m["hits"].inc()
                self._m["fetch_s"].inc(t.access_time_s(art.bytes))
                self._epoch += 1            # last_used moved (LRU scores)
                if self.auto_promote_every:
                    self._hits_since_promote += 1
                    if self._hits_since_promote >= self.auto_promote_every:
                        self._hits_since_promote = 0
                        self.promote()
                return art
            self._m["misses"].inc()
            return None

    def offer(self, name: str, value: Any, compute_time_s: float,
              producer: str, nbytes: Optional[int] = None,
              workflow: Optional[WorkflowIR] = None) -> bool:
        """Algorithm 2: try to admit a newly produced artifact, demoting or
        evicting lower-importance items while capacity is exceeded.
        ``workflow`` (optional) pins the artifact's scoring context to its
        own producer DAG; without it scoring falls back to the most
        recently attached workflow."""
        b = nbytes if nbytes is not None else sizeof(value)
        with self._lock:
            if workflow is not None:
                k = id(workflow)
                if self._workflows.get(k) is not workflow:
                    self._workflows[k] = workflow
                    self._epoch += 1
            art = CachedArtifact(name=name, value=value, bytes=b,
                                 compute_time_s=compute_time_s,
                                 producer=producer, insertion=self._insertions,
                                 wf_ref=(weakref.ref(workflow)
                                         if workflow is not None else None))
            self._insertions += 1

            if not self.policy.admit(art):
                self._m["rejected"].inc()
                return False
            start = next((i for i, t in enumerate(self.tiers) if t.fits(b)),
                         None)
            if start is None:
                self._m["rejected"].inc()
                return False
            placed = self._place(art, start, "admitted")
            if placed is None:
                self._m["rejected"].inc()
                return False
            self._drop_stale(name, keep_idx=placed)
            return True

    # -- placement / cascade -----------------------------------------------
    def _place(self, art: CachedArtifact, idx: int,
               reason: str) -> Optional[int]:
        """Place `art` into tier `idx` per Algorithm 2, cascading it (and
        any displaced occupants) downward. Returns the tier index it landed
        in, or None if it fell off the last tier."""
        tier = self.tiers[idx]
        b = art.bytes
        down = idx + 1 if idx + 1 < len(self.tiers) else None
        if not tier.fits(b):
            if down is None:
                return None
            return self._place(art, down, reason)

        new_score: Optional[float] = None
        while True:
            # lines 10-11: fits -> cache it (atomically for shared tiers:
            # a sibling store may fill the tier between check and put)
            if tier.used_bytes + b <= tier.capacity_bytes:
                if self._try_insert(art, idx, reason):
                    return idx
                continue                   # lost the race; contest again
            if not tier.items:
                # unreachable for private tiers (empty => used==0 => the
                # fit branch above would have fired); under shared-tier
                # races just retry the atomic fit path
                if self._try_insert(art, idx, reason):
                    return idx
                continue
            # lines 16-31 (NodeSelection): compare vs lowest-scored items
            if new_score is None:
                self._sync_workflow_versions()
                t0 = time.perf_counter()
                new_score = self.policy.score(art, self._view(idx))
                self._m["score_time_s"].inc(time.perf_counter() - t0)
            ms = self._min_scored(idx)
            if ms is None:
                continue               # shared tier drained under us; retry
            k_min, s_min = ms
            if s_min >= new_score:
                if down is None:
                    return None            # loses at the last tier: drop
                return self._place(art, down, reason)   # cascade the loser
            self._displace(idx, k_min)
            # paper: re-evaluate remaining items after every removal — the
            # epoch bump invalidates the heap; the rebuild is cheap because
            # untouched items hit the policy memos

    def _displace(self, idx: int, name: str) -> None:
        """Remove `name` from tier `idx`; demote it downward, evicting it
        only when displaced off the last tier. Tolerates the victim having
        vanished (a sibling store racing on a shared tier)."""
        tier = self.tiers[idx]
        down = idx + 1 if idx + 1 < len(self.tiers) else None
        if down is None:
            if tier.remove(name, "evicted") is not None:
                self._m["evictions"].inc()
        else:
            victim = tier.remove(name, "demoted")
            if victim is not None and \
                    self._place(victim, down, "demoted") is None:
                self._m["evictions"].inc()
        self._epoch += 1

    def _try_insert(self, art: CachedArtifact, idx: int, reason: str) -> bool:
        """Insert into tier `idx`; for shared tiers the capacity re-check
        and put are one atomic step under the tier lock."""
        tier = self.tiers[idx]
        if not tier.shared:
            self._insert(art, idx, reason)
            return True
        ok, old = tier.put_if_fits(art, reason)
        if ok:
            self._count_insert(old, reason)
        return ok

    def _insert(self, art: CachedArtifact, idx: int, reason: str) -> None:
        self._count_insert(self.tiers[idx].put(art, reason), reason)

    def _count_insert(self, old: Optional[CachedArtifact],
                      reason: str) -> None:
        if old is not None:
            # same-key refresh: replace in place — NOT an eviction (and not
            # a second admission), so policy stats stay comparable
            self._m["refreshed"].inc()
        elif reason == "admitted":
            self._m["admitted"].inc()
        elif reason == "demoted":
            self._m["demotions"].inc()
        elif reason == "promoted":
            self._m["promotions"].inc()
        self._epoch += 1

    def _drop_stale(self, name: str, keep_idx: int) -> None:
        """A fresh version of `name` landed in tier `keep_idx`; any copy in
        another tier (e.g. a previously demoted one) is now stale."""
        for i, t in enumerate(self.tiers):
            if i != keep_idx and name in t.items:
                t.remove(name, "stale")
                self._epoch += 1

    # -- scoring machinery ---------------------------------------------------
    def _view(self, idx: int) -> _TierView:
        return _TierView(self.items, self.tiers[idx].capacity_bytes,
                         self.workflow)

    def _sync_workflow_versions(self) -> None:
        # heaps cache policy scores, which read every registered live
        # workflow's structure/weights versions — any drift invalidates
        wfs: Dict[int, WorkflowIR] = dict(self._workflows)
        if self.workflow is not None:
            wfs[id(self.workflow)] = self.workflow
        v = tuple(sorted((k, w.structure_version, w.weights_version)
                         for k, w in wfs.items()))
        if v != self._wf_versions:
            self._wf_versions = v
            self._epoch += 1

    def _min_scored(self, idx: int) -> Optional[Tuple[str, float]]:
        """Current lowest-scored item of tier `idx`; re-validates the heap
        if the store epoch or the tier version moved. Returns None if the
        tier turned out empty (a sibling store may drain a shared tier
        between the caller's non-empty check and the snapshot here)."""
        tier = self.tiers[idx]
        key = (self._epoch, tier.version)
        if self._heap_keys[idx] != key:
            arts = list((tier.snapshot_items() if tier.shared
                         else tier.items).values())
            t0 = time.perf_counter()
            scores = self.policy.score_many(arts, self._view(idx))
            self._m["score_time_s"].inc(time.perf_counter() - t0)
            heap = [(s, a.insertion, a.name) for s, a in zip(scores, arts)]
            heapq.heapify(heap)
            self._heaps[idx] = heap
            self._heap_keys[idx] = key
        if not self._heaps[idx]:
            return None
        s, _, name = self._heaps[idx][0]
        return name, s

    # -- background promotion ------------------------------------------------
    def promote(self) -> Dict[str, int]:
        """Re-rank all visible artifacts by the policy's promotion score
        and greedily re-pack them into the tiers (best first, highest tier
        with room). Shared-tier artifacts are never displaced by this pass:
        they are only *copied* up (when hot and used here) — the remote
        replica stays for other clusters. Returns {'promoted': n, ...}."""
        moved = {"promoted": 0, "demoted": 0, "copied_up": 0}
        with self._lock:
            self._sync_workflow_versions()
            self._m["promote_passes"].inc()
            entries: List[Tuple[CachedArtifact, int, float]] = []
            private_names = set()
            for i, t in enumerate(self.tiers):
                if not t.shared:
                    private_names.update(t.items)
            t0 = time.perf_counter()
            for i, t in enumerate(self.tiers):
                pool = t.snapshot_items() if t.shared else t.items
                arts = [a for a in pool.values()
                        if not t.shared
                        # shared replicas: only rank copy-up candidates —
                        # served to THIS store and not already private
                        or (a.name in self._shared_uses
                            and a.name not in private_names)]
                if not arts:
                    continue
                scores = self.policy.promotion_scores(arts, self._view(i))
                entries.extend(zip(arts, [i] * len(arts), scores))
            self._m["score_time_s"].inc(time.perf_counter() - t0)

            # plan capacity: each tier's free space plus whatever this
            # store's ranked PRIVATE entries currently occupy in it (shared
            # replicas never leave their tier, so they free nothing)
            plan_free = [t.capacity_bytes - t.used_bytes for t in self.tiers]
            for art, i, _ in entries:
                if not self.tiers[i].shared:
                    plan_free[i] += art.bytes
            entries.sort(key=lambda e: (-e[2], e[0].insertion))

            assign: List[Tuple[CachedArtifact, int, int]] = []
            for art, cur, _ in entries:
                if self.tiers[cur].shared:
                    # copy-up candidate: only tiers above the replica
                    tgt = next((i for i in range(cur)
                                if plan_free[i] >= art.bytes), cur)
                    if tgt != cur:
                        plan_free[tgt] -= art.bytes
                else:
                    tgt = next((i for i in range(len(self.tiers))
                                if plan_free[i] >= art.bytes), cur)
                    plan_free[tgt] -= art.bytes
                assign.append((art, cur, tgt))

            # execute downward moves first so upward moves land in freed
            # space; a move whose target is still full at execution time
            # (plan fragmentation: an artifact that fit nowhere stayed put)
            # is skipped — the pass is a heuristic, capacity is a contract
            assign = ([m for m in assign if m[2] > m[1]]
                      + [m for m in assign if m[2] < m[1]])
            for art, cur, tgt in assign:
                src = self.tiers[cur]
                dst = self.tiers[tgt]
                if src.shared:
                    if (tgt < cur and art.name not in dst.items
                            and dst.used_bytes + art.bytes
                            <= dst.capacity_bytes):
                        dst.put(art, "promoted")   # copy up, keep replica
                        self._m["promotions"].inc()
                        moved["copied_up"] += 1
                    continue                       # shared replicas never sink
                if dst.shared:
                    # demotion into the shared tier: fit-check + put are
                    # atomic (siblings race); replacing an existing replica
                    # of the same key is a net-zero byte refresh
                    ok, _old = dst.put_if_fits(art, "demoted")
                    if not ok:
                        continue
                    src.remove(art.name, "demoted")
                    self._m["demotions"].inc()
                    moved["demoted"] += 1
                    continue
                if dst.used_bytes + art.bytes > dst.capacity_bytes:
                    continue
                kind = "promoted" if tgt < cur else "demoted"
                src.remove(art.name, kind)
                dst.put(art, kind)
                self._m["promotions" if tgt < cur else "demotions"].inc()
                moved[kind] += 1
            if any(m for m in moved.values()):
                self._epoch += 1
        return moved

    # -- invariants ----------------------------------------------------------
    def check_invariants(self) -> None:
        """Tier-consistency assertions: per-tier byte ledgers balance
        (bytes are conserved across demotions/promotions), capacity is
        respected, and a key lives in at most one private tier (plus at
        most one shared replica)."""
        with self._lock:
            seen: Dict[str, str] = {}
            for t in self.tiers:
                t.check_ledger()
                if t.shared:
                    continue
                for n in t.items:
                    assert n not in seen, \
                        (n, "duplicated in private tiers", seen[n], t.name)
                    seen[n] = t.name

    def tier_stats(self) -> Dict[str, Dict[str, int]]:
        return {t.name: dict(t.stats) for t in self.tiers}


def default_tiers(mem_bytes: int = 64 << 20, ssd_bytes: int = 512 << 20,
                  remote: Optional[CacheTier] = None) -> List[CacheTier]:
    """MEM + SSD + REMOTE; pass a SharedRemoteTier as `remote` to share the
    last tier across stores."""
    return [CacheTier(mem_spec(mem_bytes)), CacheTier(ssd_spec(ssd_bytes)),
            remote if remote is not None else CacheTier(remote_spec())]


class CacheStore(TieredCacheStore):
    """Single-tier facade (models the Alluxio tier, §IV.A.1) — the legacy
    ``repro_torch.core.caching.CacheStore`` API over the tiered machinery. With
    one tier there is nowhere to demote: displaced occupants are evicted
    and losing newcomers rejected, exactly Algorithm 2 as before."""

    def __init__(self, capacity_bytes: int = 1 << 30,
                 policy: Optional[CachePolicy] = None):
        tier = CacheTier(TierSpec("MEM", capacity_bytes, 8e9, 2e-6))
        super().__init__(tiers=[tier], policy=policy)

    # direct (live-dict) views: tests index store.items after mutations
    @property
    def items(self) -> Dict[str, CachedArtifact]:
        return self.tiers[0].items

    @property
    def used_bytes(self) -> int:
        return self.tiers[0].used_bytes

    @property
    def capacity_bytes(self) -> int:
        return self.tiers[0].capacity_bytes
