"""Cache admission/eviction policies (paper Algorithm 2 + RQ2 baselines).

Baselines for the paper's RQ2 comparison: NONE, ALL, FIFO, LRU; the paper
policy is ``CoulerPolicy`` (score = Eq. 6 importance factor).

Policies are store-agnostic: ``score``/``score_many`` receive any object
with the legacy ``CacheStore`` surface — ``items`` (name → CachedArtifact),
``capacity_bytes`` and ``workflow`` — which is either a single-tier store
or a per-tier view of a ``TieredCacheStore`` (tier capacity, store-wide
contents so Eq. 3's cached frontier spans tiers).

``promotion_scores`` is the background-promotion hook: the default reuses
``score_many``, while ``CoulerPolicy`` extends Eq. 6 with the observed
reuse events — each cache hit is one of Eq. 4's ``r`` events, so the
re-rank uses (F(u) + uses)² in the beta term and hot artifacts climb back
toward MEM even when their structural reuse value is modest.
"""
from __future__ import annotations

import logging
import weakref
from collections import OrderedDict
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

from repro_torch.core.cache.scoring import (CachedArtifact, importance,
                                      reconstruction_cost, reuse_value)
from repro_torch.core.ir import WorkflowIR


class CachePolicy:
    name = "base"

    def admit(self, art: CachedArtifact) -> bool:
        return True

    def score(self, art: CachedArtifact, store) -> float:
        raise NotImplementedError

    def score_many(self, arts: Sequence[CachedArtifact],
                   store) -> List[float]:
        """Batch scoring hook; policies with shared per-batch state
        (CoulerPolicy's frontier) override this."""
        return [self.score(a, store) for a in arts]

    def promotion_scores(self, arts: Sequence[CachedArtifact],
                         store) -> List[float]:
        """Ranking used by TieredCacheStore.promote(); defaults to the
        eviction score (higher = keep closer to MEM)."""
        return self.score_many(arts, store)

    def invalidate(self, wf: Optional[WorkflowIR]) -> None:
        """Called when the store's attached workflow changes."""


class NoCache(CachePolicy):
    name = "none"

    def admit(self, art):
        return False

    def score(self, art, store):
        return 0.0


class CacheAll(CachePolicy):
    """Admit everything; evict nothing until forced, then oldest-first."""
    name = "all"

    def score(self, art, store):
        return -art.insertion        # forced eviction: oldest first

    def promotion_scores(self, arts, store):
        # oldest-first eviction, but promotion should still favor recency
        return [a.last_used for a in arts]


class FIFOPolicy(CachePolicy):
    name = "fifo"

    def score(self, art, store):
        return art.insertion          # lowest = first in = evicted first


class LRUPolicy(CachePolicy):
    name = "lru"

    def score(self, art, store):
        return art.last_used


class _WfScoringCtx:
    """Eq. 3/4 memo state for ONE workflow: per-producer predecessor reach,
    reuse value, and frontier-keyed reconstruction cost. Holding these per
    workflow (instead of for the single attached one) is what lets
    concurrent runs share a store without dropping each other's memos."""

    __slots__ = ("ref", "struct_v", "weights_v", "pred_reach", "reuse",
                 "recon")

    def __init__(self, wf: WorkflowIR):
        self.ref = weakref.ref(wf)    # weak: dead ids may be reused
        self.struct_v = wf.structure_version
        self.weights_v = wf.weights_version
        self.pred_reach: Dict[str, FrozenSet[str]] = {}
        self.reuse: Dict[str, float] = {}
        self.recon: Dict[Tuple[str, FrozenSet[str]], float] = {}


class CoulerPolicy(CachePolicy):
    """Paper Algorithm 2: score = caching importance factor I(u).

    Eq. 3/4 are memoized per producer within a per-workflow context
    (LRU-bounded): F(u) depends only on workflow structure, and L(u)
    additionally on est_time_s weights plus the part of the cached
    frontier that falls inside u's untruncated n-layer predecessor reach —
    so re-scoring after an unrelated eviction is a dict lookup instead of
    a BFS + adjacency-matrix rebuild. Each artifact scores against its own
    DAG (``CachedArtifact.wf_ref``, falling back to ``store.workflow``),
    and the Eq. 3 frontier only counts cached items of the SAME workflow,
    so concurrent runs neither thrash the memos nor leak producers into
    each other's frontiers."""
    name = "couler"

    # distinct live workflows whose memos we keep; LRU past this
    _MAX_CONTEXTS = 16

    def __init__(self, alpha: float = 1.5, beta: float = 1.0,
                 n_layers: int = 3, literal_eq4: bool = False):
        self.alpha, self.beta, self.n_layers = alpha, beta, n_layers
        self.literal_eq4 = literal_eq4
        self._ctxs: "OrderedDict[int, _WfScoringCtx]" = OrderedDict()
        # rotations that evicted a LIVE workflow's memos — each one means
        # more than _MAX_CONTEXTS workflows share this policy and Eq. 3/4
        # will be recomputed from scratch on that workflow's next score
        self.ctx_rotations_live = 0
        self._m_rotations = None

    def bind_metrics(self, registry) -> None:
        """Attach registry instruments (``TieredCacheStore`` calls this):
        a live-eviction counter plus a scoring-context occupancy gauge."""
        self._m_rotations = registry.counter("cache_ctx_rotated_live_total")
        registry.gauge_fn("cache_scoring_ctxs", lambda: len(self._ctxs))

    def invalidate(self, wf: Optional[WorkflowIR]) -> None:
        self._ctxs.clear()

    def _ctx_for(self, wf: WorkflowIR) -> _WfScoringCtx:
        key = id(wf)
        ctx = self._ctxs.get(key)
        if ctx is None or ctx.ref() is not wf \
                or wf.structure_version != ctx.struct_v:
            ctx = _WfScoringCtx(wf)
            self._ctxs[key] = ctx
        elif wf.weights_version != ctx.weights_v:
            ctx.weights_v = wf.weights_version
            ctx.recon.clear()                        # Eq. 3 reads w_i
        self._ctxs.move_to_end(key)
        while len(self._ctxs) > self._MAX_CONTEXTS:
            _, evicted = self._ctxs.popitem(last=False)
            live = evicted.ref()
            if live is not None:
                # the workflow is still alive — its memos will be rebuilt
                # from scratch next time it scores (O(V+E) per producer
                # instead of O(1)); sustained rotation is a working-set
                # smell worth surfacing, not just a silent slowdown
                self.ctx_rotations_live += 1
                if self._m_rotations is not None:
                    self._m_rotations.inc()
                logging.getLogger(__name__).warning(
                    "CoulerPolicy: rotated out scoring context for live "
                    "workflow %r (>%d concurrent workflows share this "
                    "policy; Eq. 3/4 memos for it will be recomputed)",
                    getattr(live, "name", "?"), self._MAX_CONTEXTS)
        return ctx

    def _reach(self, ctx: _WfScoringCtx, wf: WorkflowIR,
               producer: str) -> FrozenSet[str]:
        """Untruncated n-layer predecessor reach of `producer` — the only
        nodes whose cached-status can alter Eq. 3's truncated BFS."""
        s = ctx.pred_reach.get(producer)
        if s is None:
            frontier = [producer]
            seen = {producer}
            for _ in range(self.n_layers):
                nxt = []
                for j in frontier:
                    for p in wf.predecessors(j):
                        if p not in seen:
                            seen.add(p)
                            nxt.append(p)
                frontier = nxt
                if not frontier:
                    break
            s = frozenset(seen)
            ctx.pred_reach[producer] = s
        return s

    # frontier-sig entries accumulate as the cached set churns even when
    # the workflow never changes; past this bound a wholesale reset is
    # cheaper than unbounded growth (misses just recompute)
    _RECON_MEMO_CAP = 4096

    def _lf(self, ctx: _WfScoringCtx, wf: WorkflowIR, art: CachedArtifact,
            frontier_sig: FrozenSet[str]) -> Tuple[float, float]:
        """Memoized (L(u), F(u)) for art's producer under the frontier."""
        key = (art.producer, frontier_sig)
        l = ctx.recon.get(key)
        if l is None:
            if len(ctx.recon) >= self._RECON_MEMO_CAP:
                ctx.recon.clear()
            l = reconstruction_cost(wf, art.producer, frontier_sig,
                                    self.n_layers)
            ctx.recon[key] = l
        f = ctx.reuse.get(art.producer)
        if f is None:
            f = reuse_value(wf, art.producer, self.n_layers,
                            literal_eq4=self.literal_eq4)
            ctx.reuse[art.producer] = f
        return l, f

    def score(self, art: CachedArtifact, store) -> float:
        return self.score_many([art], store)[0]

    def _batch(self, arts: Sequence[CachedArtifact], store,
               reuse_boost: bool) -> List[float]:
        default_wf = store.workflow
        items = store.items
        # per-workflow cached-producer counts: Eq. 3's frontier must not
        # mix producers of unrelated concurrent workflows
        prod_count: Dict[int, Dict[str, int]] = {}
        wf_of: Dict[str, Optional[WorkflowIR]] = {}
        for a in items.values():
            w = a.wf_ref() if a.wf_ref is not None else None
            if w is None:
                w = default_wf
            wf_of[a.name] = w
            if w is None:
                continue
            d = prod_count.setdefault(id(w), {})
            d[a.producer] = d.get(a.producer, 0) + 1
        out = []
        for art in arts:
            wf = art.wf_ref() if art.wf_ref is not None else None
            if wf is None:
                wf = default_wf
            if wf is None:
                out.append(art.last_used)
                continue
            if art.producer not in wf.jobs:
                # orphaned producer (workflow edited since caching). For
                # EVICTION keep the legacy LRU-style fallback; for the
                # promotion re-rank a raw epoch timestamp would dwarf every
                # Eq. 6 score and pin dead artifacts into MEM — rank
                # orphans below everything so they sink instead
                out.append(float("-inf") if reuse_boost else art.last_used)
                continue
            ctx = self._ctx_for(wf)
            pc = prod_count.get(id(wf), {})
            # cached frontier = producers of stored items of THIS workflow
            # minus the item stored under this artifact's own key
            # (Algorithm 2's k != u), restricted to the predecessor reach
            # (the rest cannot matter)
            own = items.get(art.name)
            own_producer = (own.producer
                            if own is not None and wf_of.get(art.name) is wf
                            else None)
            sig = frozenset(
                p for p in self._reach(ctx, wf, art.producer)
                if pc.get(p, 0) - (1 if p == own_producer else 0) > 0)
            l, f = self._lf(ctx, wf, art, sig)
            if reuse_boost:
                f = f + art.uses       # observed hits are Eq. 4's r events
            v = art.bytes / max(store.capacity_bytes, 1)
            out.append(importance(l, f, v, self.alpha, self.beta))
        return out

    def score_many(self, arts: Sequence[CachedArtifact],
                   store) -> List[float]:
        return self._batch(arts, store, reuse_boost=False)

    def promotion_scores(self, arts: Sequence[CachedArtifact],
                         store) -> List[float]:
        return self._batch(arts, store, reuse_boost=True)


POLICIES = {"none": NoCache, "all": CacheAll, "fifo": FIFOPolicy,
            "lru": LRUPolicy, "couler": CoulerPolicy}
