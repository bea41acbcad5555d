"""Arithmetic the metric readers share, over a run's ``harness.Record``."""
from __future__ import annotations

from typing import List

import numpy as np


def in_window(rec, t: float) -> bool:
    t0, t1 = rec.t_window
    return t0 < t <= t1


def itl_gaps(rec) -> List[float]:
    """Every gap between consecutive tokens of one step whose both tokens
    came inside the window: the wall from the end of the round that
    emitted the one to the end of the round that emitted the next, with
    whatever prefills and host work ran in between."""
    gaps = []
    for steps in rec.steps.values():
        for s in steps:
            ts = [t for t in s.times if in_window(rec, t)]
            gaps.extend(b - a for a, b in zip(ts, ts[1:]))
    return gaps


def percentile(values: List[float], q: float) -> float:
    """The ``q``-th percentile, linear between order statistics."""
    return float(np.percentile(np.asarray(values, np.float64), q))


def kernel_seconds(rec, needle: str) -> float:
    """Device seconds of the traced kernels whose name holds ``needle``."""
    return sum(s for name, s in rec.trace.kernel_s.items() if needle in name)


def least_seconds(rec, work) -> float:
    """The least time of (operations, bytes) on the card's published
    bf16 and HBM peaks."""
    flops, nbytes = work
    return max(flops / rec.peaks["bf16_flops"],
               nbytes / rec.peaks["hbm_bytes_per_s"])
