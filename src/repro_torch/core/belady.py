"""Bélády-optimal offline replay + empirical competitive ratio (§7).

Definition 3: CR(A) = Cost_A(sigma) / Cost_OPT(sigma) where cost is the
total KV regeneration (tokens prefilled).  Bélády's policy evicts the
entry whose next access lies farthest in the future [Belady 1966]; we
replay recorded traces against it and against the online policies
(WA-LRU / LRU / prefix-LRU) to produce Table 2.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

from repro_torch.core.walru import CacheEntry, WALRUCache


@dataclass
class Access:
    """One cache touch: session s needs its context at time t.

    tokens: context tokens that must exist (regeneration cost if the
    entry was evicted).  bytes_: entry size after this step.  tool: tool
    type entered after this step (drives TTL).  node_id: AEG position.
    """
    t: float
    session: str
    tokens: float
    bytes_: float
    node_id: int = 0
    tool: str = "unknown"
    last: bool = False
    prefix_tokens: float = 0.0      # tokens recoverable via shared prefix


INF = float("inf")


class BeladyOracle:
    """Offline-optimal eviction with full future knowledge."""

    def __init__(self, capacity_bytes: float):
        self.capacity = capacity_bytes

    def replay(self, trace: Sequence[Access]) -> float:
        # next use index per access
        next_use: List[float] = [INF] * len(trace)
        last_seen: Dict[str, int] = {}
        for i in range(len(trace) - 1, -1, -1):
            s = trace[i].session
            next_use[i] = last_seen.get(s, INF)
            last_seen[s] = i

        cached: Dict[str, float] = {}          # session -> size
        nxt: Dict[str, float] = {}             # session -> next access idx
        used = 0.0
        cost = 0.0
        for i, a in enumerate(trace):
            if a.session in cached:
                used -= cached[a.session]
                del cached[a.session]
            else:
                cost += a.tokens               # full regeneration
            if a.last:
                nxt.pop(a.session, None)
                continue
            # insert with Bélády eviction
            need = a.bytes_
            nxt[a.session] = next_use[i]
            while used + need > self.capacity and cached:
                victim = max(cached, key=lambda s: nxt.get(s, INF))
                if nxt.get(victim, INF) <= i:   # shouldn't happen
                    nxt[victim] = INF
                used -= cached.pop(victim)
            if used + need <= self.capacity:
                cached[a.session] = need
                used += need
        return cost


def replay_policy(trace: Sequence[Access], cache: WALRUCache,
                  ttl_policy=None, stats=None, aeg_lookup=None) -> float:
    """Replay an access trace through an online cache policy.

    Returns total regeneration cost in tokens.  If the cache is a
    PrefixLRUCache, a re-prefill only pays the non-prefix tokens (shared
    system-prompt/tool-definition prefix survives in the radix tree).
    """
    from repro_torch.core.walru import PrefixLRUCache
    prefix_aware = isinstance(cache, PrefixLRUCache)

    cost = 0.0
    for a in trace:
        hit = cache.lookup(a.session, a.t)
        if hit is None:
            regen = a.tokens
            if prefix_aware:
                regen = max(0.0, a.tokens - a.prefix_tokens)
            cost += regen
            cache.tokens_regenerated += regen
        # NOTE: completed sessions are NOT removed — in a real serving
        # system the final step's cache lingers until evicted.  This is
        # the paper's central asymmetry (§4.1): recency-driven LRU keeps
        # completed sessions (they are the most recent!), while WA-LRU
        # knows completion => P_reuse = 0 and evicts them first.
        entry = CacheEntry(session_id=a.session, size_bytes=a.bytes_,
                           t_last=a.t, tokens=a.tokens, node_id=a.node_id,
                           completed=a.last)
        if ttl_policy is not None and not a.last:
            used_frac = cache.utilization()
            from repro_torch.core.ttl import memory_pressure
            entry.ttl_deadline = ttl_policy.deadline(
                a.tool, a.t, memory_pressure(used_frac))
        cache.insert(entry, a.t)
    return cost


def competitive_ratio(policy_cost: float, opt_cost: float) -> float:
    if opt_cost <= 0:
        return 1.0 if policy_cost <= 0 else INF
    return policy_cost / opt_cost
