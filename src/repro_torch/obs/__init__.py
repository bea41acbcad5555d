"""Deterministic observability layer for both execution substrates.

Every headline claim in the paper is an observability claim — 1.64x
task-completion time, 1.22x memory utilization, 99.2% SLO attainment,
bounded AFS deviation (§6) — and this package is where those numbers
become inspectable while a run happens instead of a single
``summarize()`` dict after it:

  * ``tracer.Tracer`` — virtual-time span tracer.  The runtime and the
    simulator emit one span tree per session (session → step →
    queue_wait / prefill / resume / decode / tool_gap / migration, with
    engine-track decode-round spans and instants for preemption, park,
    prefetch, faults and cancellations), stamped with ``(step, attempt)``
    so fault retries and AFS preemptions are first-class visible events.
  * ``metrics.MetricsRegistry`` — counters, gauges (virtual-time
    series) and virtual-time-bucketed histograms sampled each epoch
    tick: per-engine queue depth, KV pool occupancy (resident / parked /
    free blocks), AFS deviation, batch occupancy, regeneration bytes.
    Prometheus-text and JSON export.
  * ``export`` — Chrome/Perfetto ``trace_event`` JSON
    (``python -m repro_torch.obs.export trace.json``) and a per-run
    ``report()`` latency breakdown (per-phase TCT decomposition,
    TTFT-on-resume, p50/p99 decode-round latency).

Zero-perturbation contract (the sanitizer's contract, inherited):
tracing is read-only and gated (``SAGA_TRACE=1`` /
``ServingRuntime(trace=True)`` / ``ClusterSim(trace=True)``), uses only
virtual time and deterministic ordering — no wall clock, no
``id()``-keyed dicts, no iteration over sets — so a traced run's
``summarize()`` stays byte-identical to the untraced run and the trace
bytes themselves are byte-identical across processes and
``PYTHONHASHSEED``.  See ``docs/OBSERVABILITY.md``.
"""
from repro_torch.obs.metrics import Counter, Gauge, Histogram, MetricsRegistry
from repro_torch.obs.tracer import Span, Tracer

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "Span", "Tracer",
]
