"""Session-affinity routing (paper §5.1, Eq. 7).

    route(r) = w_s*                 if load(w_s*) < theta and cached(w_s*, s)
             = argmin_w load(w)     otherwise

theta = 0.8 reserves 20% headroom (Table 9: TCT varies <5% for
theta in [0.6, 0.95]).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence


class SessionRouter:
    def __init__(self, theta: float = 0.8):
        self.theta = theta
        self.home: Dict[str, int] = {}          # session -> worker id
        # instrumentation
        self.affinity_hits = 0
        self.affinity_misses = 0

    def route(self, session_id: str, loads: Sequence[float],
              cached: Callable[[int, str], bool]) -> int:
        """Eq. 7.  loads[w] in [0,1]; cached(w, s) checks the KV pool."""
        w_star = self.home.get(session_id)
        if (w_star is not None and w_star < len(loads)
                and loads[w_star] < self.theta
                and cached(w_star, session_id)):
            self.affinity_hits += 1
            return w_star
        self.affinity_misses += 1
        if hasattr(loads, "argmin"):        # numpy load vector: C argmin
            w = int(loads.argmin())
        else:
            w = min(range(len(loads)), key=lambda i: loads[i])
        self.home[session_id] = w
        return w

    def set_home(self, session_id: str, worker: int) -> None:
        self.home[session_id] = worker

    def forget(self, session_id: str) -> None:
        self.home.pop(session_id, None)

    def evict_worker(self, worker: int) -> Sequence[str]:
        """Worker died / removed: drop its affinities (fault tolerance)."""
        dropped = [s for s, w in self.home.items() if w == worker]
        for s in dropped:
            del self.home[s]
        return dropped
