"""Trace exporters: Chrome/Perfetto ``trace_event`` JSON and the
per-run ``report()`` latency breakdown.

::

    PYTHONPATH=src python -m repro_torch.obs.export trace.json

runs a small traced simulator demo (SAGA policy, SWE-bench-style mix),
writes a Perfetto-loadable trace to the given path, and prints the
per-phase breakdown — load the JSON at https://ui.perfetto.dev or
chrome://tracing.  Programmatic use: ``chrome_trace(tracer, metrics)``
returns the trace dict; ``report(tracer)`` returns the breakdown
(per-phase TCT decomposition, TTFT-on-resume, p50/p99 decode-round
latency) that ``fig1_breakdown.py`` and the workflow smoke consume.

Determinism: pids/tids are assigned in first-seen span order, events
are emitted in span-id order, and timestamps are virtual microseconds
— identical-seed runs export byte-identical traces.
"""
from __future__ import annotations

import json
import sys
from typing import Dict, List, Optional, Sequence

from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.tracer import ROOT, Span, Tracer

# phases that decompose a session's TCT (disjoint by construction:
# queue_wait ends at admit, prefill/resume ends at the decode join,
# decode ends at the round that finishes the step, tool_gap spans the
# virtual tool latency, migration covers the steal transfer window).
# ``handoff`` (disaggregated prefill->decode transfer) is session-level
# and OVERLAPS the tool gap, so it is reported but never subtracted
# from the unattributed remainder.
PHASES = ("queue_wait", "prefill", "resume", "decode", "tool_gap",
          "migration", "handoff")


def percentile(xs: Sequence[float], p: float) -> float:
    """Sorted-index percentile with the repo's summarize() convention:
    ``xs_sorted[min(n-1, int(p * n))]`` — matches the committed
    fingerprint math exactly so traced reports and summaries agree."""
    xs = sorted(xs)
    if not xs:
        return 0.0
    return float(xs[min(len(xs) - 1, int(p * len(xs)))])


def latency_summary(xs: Sequence[float]) -> dict:
    xs = sorted(float(x) for x in xs)
    if not xs:
        return {"n": 0, "mean": 0.0, "p50": 0.0, "p99": 0.0,
                "max": 0.0}
    return {
        "n": len(xs),
        "mean": sum(xs) / len(xs),
        "p50": percentile(xs, 0.50),
        "p99": percentile(xs, 0.99),
        "max": xs[-1],
    }


# -- Chrome/Perfetto trace_event --------------------------------------
def chrome_trace(tracer: Tracer,
                 metrics: Optional[MetricsRegistry] = None) -> dict:
    """Build a ``trace_event``-format dict (Perfetto / chrome://tracing
    loadable): complete ("X") events for spans, instant ("i") events,
    thread-name metadata per track, and counter ("C") events from the
    registry's gauge series."""
    tids: Dict[str, int] = {}
    events: List[dict] = []
    for sp in tracer.spans:
        tid = tids.get(sp.track)
        if tid is None:
            tid = len(tids) + 1
            tids[sp.track] = tid
            events.append({"ph": "M", "name": "thread_name", "pid": 1,
                           "tid": tid, "args": {"name": sp.track}})
        args = dict(sp.meta)
        args["status"] = sp.status
        args["span_id"] = sp.span_id
        if sp.parent_id != ROOT:
            args["parent_id"] = sp.parent_id
        if sp.kind == "instant":
            events.append({"ph": "i", "name": sp.name, "pid": 1,
                           "tid": tid, "ts": sp.t0 * 1e6, "s": "t",
                           "args": args})
        else:
            events.append({"ph": "X", "name": sp.name, "pid": 1,
                           "tid": tid, "ts": sp.t0 * 1e6,
                           "dur": sp.dur * 1e6, "args": args})
    if metrics is not None:
        for name, m in sorted(metrics.to_json().items()):
            if m["type"] != "gauge":
                continue
            for labels, series in sorted(m["series"].items()):
                cname = name + ("" if labels == "{}" else " " + labels)
                for t, v in series:
                    events.append({"ph": "C", "name": cname, "pid": 1,
                                   "ts": t * 1e6,
                                   "args": {"value": v}})
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(tracer: Tracer, path: str,
                       metrics: Optional[MetricsRegistry] = None) -> None:
    with open(path, "w") as f:
        json.dump(chrome_trace(tracer, metrics), f, indent=1)


# -- per-run latency breakdown ----------------------------------------
def report(tracer: Tracer) -> dict:
    """Per-phase TCT decomposition off the span tree.

    For every finished session span: TCT = span duration; each phase
    child's duration is attributed to its name (``resume`` is the
    cache-hit twin of ``prefill``); the unattributed remainder is
    ``other`` (event-grain slack, e.g. a round boundary the session
    waited on).  TTFT-on-resume is measured per resumed step: tool
    return (step span start) to the first decoded token of the resumed
    attempt.  Decode-round latency summarizes the engine-track round
    spans (runtime substrate only; the simulator models decode as one
    interval)."""
    kids = tracer.children()
    sessions = [sp for sp in tracer.spans
                if sp.name == "session" and sp.closed]
    tcts: List[float] = []
    phase_tot = {p: 0.0 for p in PHASES}
    per_session_other: List[float] = []
    ttft_resume: List[float] = []
    for ses in sessions:
        tcts.append(ses.dur)
        attributed = 0.0
        for step in kids.get(ses.span_id, ()):
            if step.name == "handoff":
                # disagg transfer window: runs concurrently with the
                # tool gap (off the critical path), so it contributes
                # to its own phase bucket without reducing ``other``
                if step.kind == "span":
                    phase_tot["handoff"] += step.dur
                continue
            phases = kids.get(step.span_id, ())
            for ph in phases:
                if ph.name in phase_tot and ph.kind == "span":
                    phase_tot[ph.name] += ph.dur
                    attributed += ph.dur
            resumed = [p for p in phases if p.name == "resume"]
            if resumed and resumed[-1].status == "ok":
                decodes = [p for p in phases if p.name == "decode"
                           and p.status == "ok"]
                if decodes:
                    first_tok = decodes[-1].meta.get("first_token_t",
                                                     decodes[-1].t0)
                    ttft_resume.append(float(first_tok) - step.t0)
        per_session_other.append(max(0.0, ses.dur - attributed))
    rounds = [sp.dur for sp in tracer.spans
              if sp.name == "round" and sp.closed]
    tct_total = sum(tcts)
    phase_tot["other"] = sum(per_session_other)
    denom = max(tct_total, 1e-12)
    cancelled = sum(1 for sp in tracer.spans
                    if sp.status == "cancelled")
    return {
        "n_sessions": len(sessions),
        "tct": latency_summary(tcts),
        "phase_totals_s": {k: v for k, v in sorted(phase_tot.items())},
        "phase_frac": {k: v / denom
                       for k, v in sorted(phase_tot.items())},
        "ttft_on_resume": latency_summary(ttft_resume),
        "round_latency": latency_summary(rounds),
        "span_counts": tracer.counts(),
        "cancelled_spans": cancelled,
    }


def format_report(rep: dict, title: str = "trace report") -> str:
    lines = [f"{title}: {rep['n_sessions']} sessions, "
             f"tct mean={rep['tct']['mean']:.3f}s "
             f"p99={rep['tct']['p99']:.3f}s"]
    for name, frac in rep["phase_frac"].items():
        tot = rep["phase_totals_s"][name]
        lines.append(f"  {name:<11s} {tot:9.3f}s  {100 * frac:5.1f}%")
    tr = rep["ttft_on_resume"]
    if tr["n"]:
        lines.append(f"  ttft-on-resume mean={tr['mean']:.3f}s "
                     f"p99={tr['p99']:.3f}s over {tr['n']} resumes")
    rl = rep["round_latency"]
    if rl["n"]:
        lines.append(f"  decode round p50={rl['p50'] * 1e3:.1f}ms "
                     f"p99={rl['p99'] * 1e3:.1f}ms over {rl['n']} rounds")
    if rep["cancelled_spans"]:
        lines.append(f"  {rep['cancelled_spans']} cancelled span(s) "
                     "(fault retries)")
    return "\n".join(lines)


def _demo(out_path: str) -> None:
    """Traced simulator demo for the CLI: a small SWE-bench-style run
    under the SAGA policy, exported to ``out_path``."""
    # imported lazily: the simulator imports this package's tracer
    from repro_torch.cluster.baselines import saga
    from repro_torch.cluster.simulator import ClusterSim
    from repro_torch.cluster.workload import swebench_workload

    tasks = swebench_workload(n_tasks=40, rate_per_min=5.0, seed=0)
    sim = ClusterSim(tasks, saga(), n_workers=8, seed=0, trace=True)
    sim.run(horizon_s=86400)
    sim.check_conservation()
    sim.tracer.check_closed()
    write_chrome_trace(sim.tracer, out_path, sim.obs_metrics)
    print(format_report(report(sim.tracer),
                        title="demo (40 swebench tasks, saga)"))
    print(f"wrote {out_path} — load it at https://ui.perfetto.dev")


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) != 1 or argv[0].startswith("-"):
        print("usage: python -m repro_torch.obs.export <trace.json>\n"
              "runs a traced simulator demo and writes a Perfetto-"
              "loadable trace_event JSON", file=sys.stderr)
        return 2
    _demo(argv[0])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
