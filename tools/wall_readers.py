"""Readers of the engine's wall spans (``Engine.wall``) over a benchmark
window: four per-layer metrics (``METRICS``) and the diagnostics that
``tools/engine_walls.py`` prints beside them.

They read a ``Walls``, which holds the window's spans and the benchmark's
own view of the same window (its rounds and admissions, in order, each
with whether the profiler ran through it, and the device's busy
intervals), so they depend on no file of the benchmark.  Each returns None
where the window holds no spans to read.  Spans are in seconds on the
clock ``torch.profiler`` stamps its events with; busy intervals in its
nanoseconds.
"""
from __future__ import annotations

import dataclasses
import statistics
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.obs.tracer import ROOT as TOP

HOST_PHASES = ("round.prep", "round.model", "round.commit")


@dataclasses.dataclass
class Walls:
    spans: Sequence            # the window's engine spans, in order
    rounds: Sequence           # its rounds: .t_call, .t_end, .profiled
    admissions: Sequence       # its admissions in call order: .profiled
    busy: Optional[List[Tuple[int, int]]] = None   # sorted, disjoint


def _children(spans) -> Dict[int, List]:
    kids: Dict[int, List] = {}
    for sp in spans:
        kids.setdefault(sp.parent_id, []).append(sp)
    return kids


def _rounds(w: Walls) -> List[Tuple[object, List, object]]:
    """(round span, its phase spans, the benchmark's round) of each window
    round, paired by index; [] where there are no spans."""
    if not w.spans:
        return []
    kids = _children(w.spans)
    rounds = [sp for sp in kids[TOP] if sp.name == "round"]
    if len(rounds) != len(w.rounds):
        raise ValueError(f"{len(rounds)} round spans for {len(w.rounds)} "
                         f"window rounds")
    return [(sp, kids.get(sp.span_id, []), r)
            for sp, r in zip(rounds, w.rounds)]


def _wait(phases) -> float:
    return sum(c.dur for c in phases if c.name == "round.wait")


def round_host_ms_mean(w: Walls) -> Optional[float]:
    """Mean of a round's wall less its ``round.wait``, over the window's
    rounds outside the profiled sub-window: the host's cost of a round."""
    calm = [(sp, ph) for sp, ph, r in _rounds(w) if not r.profiled]
    if not calm:
        return None
    return 1e3 * statistics.fmean(sp.dur - _wait(ph) for sp, ph in calm)


def round_wait_ms_mean(w: Walls) -> Optional[float]:
    """Mean ``round.wait`` over the same rounds: device work the host did
    not overlap."""
    calm = [ph for _, ph, r in _rounds(w) if not r.profiled]
    if not calm:
        return None
    return 1e3 * statistics.fmean(_wait(ph) for ph in calm)


def _idle_ns(busy, a: int, b: int) -> int:
    """Nanoseconds of [a, b] that no busy interval covers."""
    covered = sum(max(0, min(e, b) - max(s, a)) for s, e in busy
                  if s < b and e > a)
    return (b - a) - covered


def _ns(t: float) -> int:
    return round(t * 1e9)


def idle_by_phase(w: Walls) -> Optional[Dict[str, float]]:
    """Device idle seconds inside each phase of the profiled rounds, and
    of the admissions whose span meets the busy range."""
    pairs = _rounds(w)
    if not w.busy or not pairs:
        return None
    lo, hi = w.busy[0][0], w.busy[-1][1]
    kids = _children(w.spans)
    phases = [c for _, ph, r in pairs if r.profiled for c in ph]
    phases += [c for sp in kids[TOP] if sp.name == "admit"
               and _ns(sp.t0) < hi and _ns(sp.t1) > lo
               for c in kids.get(sp.span_id, [])]
    out: Dict[str, float] = {}
    for c in phases:
        idle = _idle_ns(w.busy, _ns(c.t0), _ns(c.t1)) / 1e9
        out[c.name] = out.get(c.name, 0.0) + idle
    return dict(sorted(out.items()))


def profiled_rounds(w: Walls) -> Optional[Dict[str, float]]:
    """The profiled rounds beside the others: their number, mean walls (the
    profiler's own host work lengthens a profiled round), and the device
    idle inside their ``HOST_PHASES``, per round and as a share of their
    wall.  The idle carries the profiler's inflation."""
    pairs = _rounds(w)
    prof = [(sp, ph) for sp, ph, r in pairs if r.profiled]
    calm = [sp.dur for sp, _, r in pairs if not r.profiled]
    if not w.busy or not prof or not calm:
        return None
    wall = sum(sp.dur for sp, _ in prof)
    idle = sum(_idle_ns(w.busy, _ns(c.t0), _ns(c.t1))
               for _, ph in prof for c in ph if c.name in HOST_PHASES) / 1e9
    return {"n": len(prof), "wall_ms_mean": 1e3 * wall / len(prof),
            "unprofiled_wall_ms_mean": 1e3 * statistics.fmean(calm),
            "host_idle_ms_mean": 1e3 * idle / len(prof),
            "host_idle_share": 100.0 * idle / wall}


def _top_level(w: Walls) -> List[Tuple[object, bool]]:
    """(admit or round span, whether the profiler ran through it) in
    order: rounds paired with the window's rounds, admissions with its
    admissions in call order."""
    pairs = _rounds(w)
    if not pairs:
        return []
    kids = _children(w.spans)
    admits = [sp for sp in kids[TOP] if sp.name == "admit"]
    if len(admits) != len(w.admissions):
        raise ValueError(f"{len(admits)} admit spans for "
                         f"{len(w.admissions)} window admissions")
    flags = {sp.span_id: r.profiled for sp, _, r in pairs}
    flags.update((sp.span_id, a.profiled)
                 for sp, a in zip(admits, w.admissions))
    return [(sp, flags[sp.span_id]) for sp in kids[TOP]]


def runtime_host_share(w: Walls) -> Optional[float]:
    """The share of the wall between engine calls (no ``admit`` or
    ``round`` span open): the runtime's events, the coordinator and the
    benchmark's loop, in %.  Over the window's stretches outside the
    profiled sub-window: the profiler's start and stop run between two
    engine calls, and its teardown takes seconds."""
    top = _top_level(w)
    covered = sum(sp.dur for sp, prof in top if not prof)
    gaps = sum(b.t0 - a.t1 for (a, pa), (b, pb) in zip(top, top[1:])
               if not (pa or pb))
    return 100.0 * gaps / (gaps + covered) if covered else None


def resume_regen_share(w: Walls) -> Optional[float]:
    """Of the prefill tokens of the window's resumed admissions (the
    ``admit`` spans of kind hit or regen), the share regenerated, in %."""
    resumed = [sp.meta for sp in w.spans
               if sp.name == "admit" and sp.meta["kind"] != "first"]
    total = sum(m["prefill"] for m in resumed)
    if not total:
        return None
    return 100.0 * sum(m["prefill"] for m in resumed
                       if m["kind"] == "regen") / total


METRICS = {"round_host_ms_mean": round_host_ms_mean,
           "round_wait_ms_mean": round_wait_ms_mean,
           "runtime_host_share": runtime_host_share,
           "resume_regen_share": resume_regen_share}


def round_wall_gaps_ms(w: Walls) -> Optional[Dict[str, float]]:
    """How far a ``round`` span's wall lies from the benchmark's wall of
    the same round, in ms: the largest and the 99th percentile over
    unprofiled and profiled rounds, and the rounds past 0.5 ms."""
    pairs = _rounds(w)
    if not pairs:
        return None
    out: Dict[str, float] = {}
    for name, want in (("unprofiled", False), ("profiled", True)):
        gaps = sorted(1e3 * abs(sp.dur - (r.t_end - r.t_call))
                      for sp, _, r in pairs if r.profiled == want)
        if gaps:
            out[f"{name}_max"] = gaps[-1]
            out[f"{name}_p99"] = gaps[int(0.99 * (len(gaps) - 1))]
            out[f"{name}_over_0.5"] = sum(g > 0.5 for g in gaps)
    return out


def host_gaps(w: Walls, top: int = 5) -> Optional[List[Tuple[float, float,
                                                            bool]]]:
    """The ``top`` longest walls between two engine calls: (seconds into
    the window's engine spans, length in s, next to a profiled call)."""
    spans = _top_level(w)
    if not spans:
        return None
    t0 = spans[0][0].t0
    gaps = [(a.t1 - t0, b.t0 - a.t1, pa or pb)
            for (a, pa), (b, pb) in zip(spans, spans[1:])]
    return sorted(gaps, key=lambda g: -g[1])[:top]


def wall_line(w: Walls) -> Dict:
    return {"metrics": {k: f(w) for k, f in METRICS.items()},
            "profiled_rounds": profiled_rounds(w),
            "idle_by_phase_s": idle_by_phase(w),
            "round_wall_gaps_ms": round_wall_gaps_ms(w),
            "host_gaps": host_gaps(w),
            "n_round_spans": len(_rounds(w)),
            "n_window_rounds": len(w.rounds)}
