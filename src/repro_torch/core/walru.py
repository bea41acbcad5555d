"""Workflow-Aware LRU eviction (paper §4.1, Eq. 1-3).

    P_evict(s) = alpha * R_hat(s) + beta * (1 - P_reuse(s)) + gamma * S_hat(s)

with alpha=0.3, beta=0.5, gamma=0.2 (Table 9) and all terms normalized
to [0,1].  Under memory pressure the pool evicts the max-P_evict entry
until the requested bytes fit.  Graceful degradation (§1.5(6)): with no
AEG available P_reuse falls back to 0.5, collapsing WA-LRU toward
size-tie-broken LRU.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple


@dataclass
class EvictionWeights:
    alpha: float = 0.3     # recency
    beta: float = 0.5      # workflow-predicted reuse (dominant)
    gamma: float = 0.2     # size (tiebreaker)


@dataclass
class CacheEntry:
    session_id: str
    size_bytes: float
    t_last: float                    # last access time (s)
    tokens: float = 0.0              # cached context tokens
    node_id: int = 0                 # current AEG node of the session
    ttl_deadline: Optional[float] = None   # tool-call TTL (§4.2)
    pinned: bool = False             # actively decoding -> not evictable
    completed: bool = False          # task finished -> dead weight


class WALRUCache:
    """One worker's KV pool under WA-LRU.

    The pool tracks bytes only — actual KV block tables live in the
    serving engine; the simulator uses this class directly.  ``p_reuse_fn``
    is injected by the coordinator: (entry) -> probability from the AEG
    (Eq. 4).  Entries inside their tool-call TTL get their predicted
    reuse honored; expired entries lose the workflow bonus.
    """

    def __init__(self, capacity_bytes: float,
                 weights: EvictionWeights = EvictionWeights(),
                 p_reuse_fn: Optional[Callable[[CacheEntry], float]] = None):
        self.capacity = capacity_bytes
        self.weights = weights
        self.p_reuse_fn = p_reuse_fn
        self.entries: Dict[str, CacheEntry] = {}
        self.used = 0.0
        # instrumentation
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.bytes_evicted = 0.0
        self.tokens_regenerated = 0.0

    # -- bookkeeping ----------------------------------------------------
    def lookup(self, session_id: str, now: float) -> Optional[CacheEntry]:
        e = self.entries.get(session_id)
        if e is not None:
            e.t_last = now
            self.hits += 1
            return e
        self.misses += 1
        return None

    def contains(self, session_id: str) -> bool:
        return session_id in self.entries

    def insert(self, entry: CacheEntry, now: float) -> List[CacheEntry]:
        """Insert (or grow) an entry, evicting as needed.  Returns the
        evicted entries (the caller charges regeneration cost when an
        evicted session later resumes)."""
        evicted: List[CacheEntry] = []
        old = self.entries.pop(entry.session_id, None)
        if old is not None:
            self.used -= old.size_bytes
        need = entry.size_bytes
        while self.used + need > self.capacity and self.entries:
            victim = self.select_victim(now)
            if victim is None:
                break
            self.remove(victim.session_id)
            self.evictions += 1
            self.bytes_evicted += victim.size_bytes
            evicted.append(victim)
        if self.used + need <= self.capacity:
            self.entries[entry.session_id] = entry
            self.used += need
        return evicted

    def remove(self, session_id: str) -> Optional[CacheEntry]:
        e = self.entries.pop(session_id, None)
        if e is not None:
            self.used -= e.size_bytes
        return e

    def utilization(self) -> float:
        return self.used / self.capacity if self.capacity else 0.0

    # -- Eq. 1-3 ----------------------------------------------------------
    def p_evict(self, e: CacheEntry, now: float, tau_max: float,
                size_max: float) -> float:
        w = self.weights
        r_hat = min(1.0, max(0.0, (now - e.t_last) / max(tau_max, 1e-9)))
        s_hat = e.size_bytes / max(size_max, 1e-9)
        p_reuse = self._p_reuse(e, now)
        return w.alpha * r_hat + w.beta * (1.0 - p_reuse) + w.gamma * s_hat

    def _p_reuse(self, e: CacheEntry, now: float) -> float:
        if e.completed:
            return 0.0
        if e.ttl_deadline is not None and now > e.ttl_deadline:
            # TTL expired: drop the workflow bonus, keep a floor
            return 0.1
        if self.p_reuse_fn is not None:
            return max(0.0, min(1.0, self.p_reuse_fn(e)))
        return 0.5    # no AEG: graceful degradation toward LRU

    def select_victim(self, now: float) -> Optional[CacheEntry]:
        # Two indexed passes over the live dict — no candidate-list
        # rebuilds.  Eviction loops call this once per victim, so the
        # three list allocations the old version made per call dominated
        # eviction storms on big pools.  First pass: normalizers.
        tau_max = 0.0
        size_max = 0.0
        n = 0
        for e in self.entries.values():
            if e.pinned:
                continue
            n += 1
            age = now - e.t_last
            if age > tau_max:
                tau_max = age
            if e.size_bytes > size_max:
                size_max = e.size_bytes
        if n == 0:
            return None
        tau_max = tau_max or 1.0
        size_max = size_max or 1.0
        best: Optional[CacheEntry] = None
        best_p = -1.0
        for e in self.entries.values():
            if e.pinned:
                continue
            p = self.p_evict(e, now, tau_max, size_max)
            if best is None or p > best_p:
                best, best_p = e, p
        return best


# --- baseline policies (for Table 2 / ablations) ---------------------------
def _lru_victim(entries) -> Optional[CacheEntry]:
    """Single-pass oldest-unpinned scan (shared by the LRU variants)."""
    best: Optional[CacheEntry] = None
    for e in entries.values():
        if not e.pinned and (best is None or e.t_last < best.t_last):
            best = e
    return best


class LRUCache(WALRUCache):
    """Standard LRU: evict the least-recently-used entry."""

    def select_victim(self, now: float):
        return _lru_victim(self.entries)


class PrefixLRUCache(WALRUCache):
    """LRU + prefix caching (vLLM-APC-like): shared prefixes (system
    prompt + tool definitions) are modelled as a protected fraction of
    each entry; eviction is LRU over the session-specific remainder, and
    a re-admitted session only regenerates its non-prefix tokens.  The
    simulator applies the regeneration discount via ``prefix_fraction``.
    """

    def __init__(self, *args, prefix_fraction: float = 0.35, **kw):
        super().__init__(*args, **kw)
        self.prefix_fraction = prefix_fraction

    def select_victim(self, now: float):
        return _lru_victim(self.entries)
