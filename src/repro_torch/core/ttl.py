"""Tool-call-aware TTL (paper §4.2, Algorithm 1) + memory pressure (Eq. 6).

Algorithm 1:
  1. (mu, sigma) <- FitLogNormal(H_t)        # tool latencies are log-normal
  2. ttl_base    <- Percentile(H_t, p)       # default p = 95
  3. pressure_factor <- 1 - 0.5 * m
  4. ttl_adaptive <- ttl_base * pressure_factor
  5. return min(ttl_adaptive, TTL_max)       # TTL_max = 300 s

Eq. 6:  m = max(0, (used - th_low) / (th_high - th_low)),
        th_low = 0.7, th_high = 0.9 of pool capacity.
"""
from __future__ import annotations

import math
from bisect import bisect_left, insort
from typing import Dict, List, Sequence, Tuple


def memory_pressure(used_fraction: float, th_low: float = 0.7,
                    th_high: float = 0.9) -> float:
    m = (used_fraction - th_low) / max(th_high - th_low, 1e-9)
    return max(0.0, min(1.0, m))


def fit_lognormal(history: Sequence[float]) -> Tuple[float, float]:
    """MLE fit of (mu, sigma) for a log-normal over positive samples."""
    logs = [math.log(max(x, 1e-6)) for x in history]
    n = len(logs)
    if n == 0:
        return 0.0, 1.0
    mu = sum(logs) / n
    if n == 1:
        return mu, 1.0
    var = sum((x - mu) ** 2 for x in logs) / (n - 1)
    return mu, math.sqrt(max(var, 1e-12))


def _pct_index(n: int, p: float) -> int:
    return min(n - 1, max(0, int(math.ceil(p / 100.0 * n)) - 1))


def percentile(history: Sequence[float], p: float) -> float:
    if not history:
        return 0.0
    xs = sorted(history)
    return xs[_pct_index(len(xs), p)]


class ToolTTLPolicy:
    """Per-tool-type TTL with empirical latency histories.

    The paper maintains EMAs of per-tool latency distributions; we keep a
    bounded history window (equivalent information, exact percentiles).
    When a tool type has too little history, the log-normal fit supplies
    the percentile analytically (mu + z_p * sigma in log space).
    """

    Z95 = 1.6448536269514722

    def __init__(self, p: float = 95.0, ttl_max_s: float = 300.0,
                 min_samples: int = 8):
        self.p = p
        self.ttl_max = ttl_max_s
        self.min_samples = min_samples
        self._hist: Dict[str, List[float]] = {}
        # incrementally-maintained sorted view of each history.  TTL
        # queries interleave 1:1 with observations on the step hot
        # path, so re-sorting per query was O(n log n) per LLM step.
        # Wholesale ``hist`` assignment (checkpoint restore, tests)
        # clears the cache via the property setter; each entry also
        # holds the backing list and compares it by identity (``is``),
        # so per-key replacement — even one that reuses a freed list's
        # address — can never serve a stale sort.
        self._sorted: Dict[str, Tuple[List[float], List[float]]] = {}

    @property
    def hist(self) -> Dict[str, List[float]]:
        return self._hist

    @hist.setter
    def hist(self, value: Dict[str, List[float]]) -> None:
        self._hist = value
        self._sorted.clear()

    def _sorted_hist(self, tool: str, h: List[float]) -> List[float]:
        cached = self._sorted.get(tool)
        if cached is not None and cached[0] is h \
                and len(cached[1]) == len(h):
            return cached[1]
        s = sorted(h)
        self._sorted[tool] = (h, s)
        return s

    def observe(self, tool: str, latency_s: float,
                max_hist: int = 4096) -> None:
        h = self.hist.setdefault(tool, [])
        s = self._sorted_hist(tool, h)   # sync BEFORE mutating h
        h.append(latency_s)
        insort(s, latency_s)
        if len(h) > max_hist:
            for x in h[:len(h) - max_hist]:
                s.pop(bisect_left(s, x))
            del h[:len(h) - max_hist]
        self._sorted[tool] = (h, s)

    def ttl(self, tool: str, mem_pressure: float,
            default_s: float = 30.0) -> float:
        """Algorithm 1.  mem_pressure = Eq. 6's m in [0,1]."""
        h = self.hist.get(tool, [])
        if len(h) >= self.min_samples:
            xs = self._sorted_hist(tool, h)
            ttl_base = xs[_pct_index(len(xs), self.p)]
        elif h:
            mu, sigma = fit_lognormal(h)
            z = self.Z95 * (self.p / 95.0)
            ttl_base = math.exp(mu + z * sigma)
        else:
            ttl_base = default_s
        pressure_factor = 1.0 - 0.5 * max(0.0, min(1.0, mem_pressure))
        return min(ttl_base * pressure_factor, self.ttl_max)

    def deadline(self, tool: str, now: float, mem_pressure: float) -> float:
        return now + self.ttl(tool, mem_pressure)
