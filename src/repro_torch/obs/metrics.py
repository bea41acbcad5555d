"""Deterministic metrics registry: counters, gauges (virtual-time
series) and virtual-time-bucketed histograms.

The registry is sampled at the coordinator's epoch tick (§6's 100 ms
cadence) by both substrates: per-engine queue depth, KV pool occupancy
split resident/parked/free, batch occupancy, AFS deviation and lag,
and cumulative regeneration bytes.  Histograms additionally bucket
their observations into fixed-width virtual-time windows so a latency
distribution can be read *over the run* (did p99 round latency spike
during the preemption storm?), not only in aggregate.

Determinism: metrics are keyed ``(name, sorted(labels))`` in an
insertion-ordered dict; exports sort by key; values are ints/floats
recorded off the virtual clock — ``to_prometheus()`` /
``canonical_bytes()`` output is byte-identical across processes and
``PYTHONHASHSEED`` for identical-seed runs.
"""
from __future__ import annotations

import bisect
import json
from typing import Dict, List, Tuple

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, object]) -> LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _label_str(key: LabelKey) -> str:
    if not key:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in key)
    return "{" + inner + "}"


class Counter:
    """Monotone counter."""
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        self.value += v

    def to_json(self):
        return self.value


class Gauge:
    """Virtual-time series of point samples; Prometheus export keeps
    the last value, JSON export keeps the whole series."""
    __slots__ = ("samples",)

    def __init__(self) -> None:
        self.samples: List[Tuple[float, float]] = []

    def set(self, t: float, v: float) -> None:
        self.samples.append((float(t), float(v)))

    @property
    def last(self) -> float:
        return self.samples[-1][1] if self.samples else 0.0

    def to_json(self):
        return [[t, v] for t, v in self.samples]


class Histogram:
    """Value-bucketed histogram whose observations carry a virtual
    timestamp: alongside the cumulative value buckets, each observation
    is assigned to a fixed-width virtual-time window (``window_s``) so
    per-window count/sum expose how the distribution evolved."""
    __slots__ = ("edges", "counts", "count", "sum", "window_s",
                 "windows")

    def __init__(self, edges, window_s: float = 1.0) -> None:
        self.edges: Tuple[float, ...] = tuple(float(e) for e in edges)
        self.counts = [0] * (len(self.edges) + 1)
        self.count = 0
        self.sum = 0.0
        self.window_s = float(window_s)
        self.windows: Dict[int, List[float]] = {}   # win -> [n, sum]

    def observe(self, t: float, v: float) -> None:
        v = float(v)
        self.counts[bisect.bisect_left(self.edges, v)] += 1
        self.count += 1
        self.sum += v
        win = int(float(t) // self.window_s)
        cell = self.windows.setdefault(win, [0, 0.0])
        cell[0] += 1
        cell[1] += v

    def quantile(self, q: float) -> float:
        """Bucket-upper-bound quantile estimate (0 <= q <= 1)."""
        if self.count == 0:
            return 0.0
        target = q * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            cum += c
            if cum >= target and c:
                return self.edges[i] if i < len(self.edges) \
                    else self.edges[-1] if self.edges else 0.0
        return self.edges[-1] if self.edges else 0.0

    def to_json(self):
        return {
            "edges": list(self.edges),
            "counts": list(self.counts),
            "count": self.count,
            "sum": self.sum,
            "window_s": self.window_s,
            "windows": {str(k): list(v)
                        for k, v in sorted(self.windows.items())},
        }


class MetricsRegistry:
    """Get-or-create registry of labelled metrics."""

    def __init__(self) -> None:
        self._metrics: Dict[Tuple[str, LabelKey], object] = {}
        self._types: Dict[str, str] = {}

    def _get(self, kind: str, name: str, labels: Dict[str, object],
             factory):
        prev = self._types.setdefault(name, kind)
        if prev != kind:
            raise ValueError(
                f"metric {name!r} registered as {prev}, requested as "
                f"{kind}")
        key = (name, _label_key(labels))
        m = self._metrics.get(key)
        if m is None:
            m = factory()
            self._metrics[key] = m
        return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get("counter", name, labels, Counter)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get("gauge", name, labels, Gauge)

    def histogram(self, name: str, edges=(0.01, 0.025, 0.05, 0.1,
                                          0.25, 0.5, 1.0, 2.5, 5.0),
                  window_s: float = 1.0, **labels) -> Histogram:
        return self._get("histogram", name, labels,
                         lambda: Histogram(edges, window_s=window_s))

    # -- export ---------------------------------------------------------
    def to_json(self) -> dict:
        out: Dict[str, dict] = {}
        for (name, key), m in sorted(self._metrics.items()):
            out.setdefault(name, {"type": self._types[name],
                                  "series": {}})
            out[name]["series"][_label_str(key) or "{}"] = m.to_json()
        return out

    def canonical_bytes(self) -> bytes:
        return json.dumps(self.to_json(), sort_keys=True,
                          separators=(",", ":")).encode("utf-8")

    def to_prometheus(self) -> str:
        """Prometheus text exposition (last value for gauges,
        cumulative ``le`` buckets for histograms)."""
        lines: List[str] = []
        seen_type: Dict[str, bool] = {}
        for (name, key), m in sorted(self._metrics.items()):
            kind = self._types[name]
            if name not in seen_type:
                seen_type[name] = True
                lines.append(f"# TYPE {name} {kind}")
            ls = _label_str(key)
            if isinstance(m, Counter):
                lines.append(f"{name}{ls} {m.value:g}")
            elif isinstance(m, Gauge):
                lines.append(f"{name}{ls} {m.last:g}")
            else:
                cum = 0
                for edge, c in zip(m.edges, m.counts):
                    cum += c
                    el = _label_str(key + (("le", f"{edge:g}"),))
                    lines.append(f"{name}_bucket{el} {cum}")
                el = _label_str(key + (("le", "+Inf"),))
                lines.append(f"{name}_bucket{el} {m.count}")
                lines.append(f"{name}_sum{ls} {m.sum:g}")
                lines.append(f"{name}_count{ls} {m.count}")
        return "\n".join(lines) + ("\n" if lines else "")
