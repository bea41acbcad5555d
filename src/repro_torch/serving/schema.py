"""The stats() / summarize() key vocabulary, as one documented schema.

The counters grew organically across PRs 5-9 (copy-byte accounting,
fault/preemption keys, disagg handoff keys); this module is now the
single source of truth.  Contracts:

  * ``ServingRuntime.summarize()`` is the BYTE-IDENTITY surface — its
    repr is pinned by committed fingerprints.  Base keys appear always;
    ``fault`` keys only when a fault plan or preemption is active and
    ``disagg`` keys only in disaggregated mode, so pre-existing pins
    never see new keys.  Changing this schema means regenerating pins.
  * ``ServingRuntime.stats()`` is additive-only: consumers read by
    name, keys may be added freely (``validate_stats`` checks presence
    + type of the documented set, tolerating extras).
  * ``AsyncServingDriver.wall_stats`` is the wall-clock sidecar — new
    keys land here, never in ``summarize()``.

``tests/test_schema.py`` holds a live runtime to this file, so a key
added in code without a schema row fails CI before it can drift.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

#: condition labels for summarize() keys
ALWAYS = "always"
FAULT = "fault_or_preempt"     # fault_plan given or enable_preemption
DISAGG = "disagg"              # SAGAConfig.disaggregate


@dataclass(frozen=True)
class KeySpec:
    """One documented stats/summary key."""
    name: str
    type: type                 # int | float
    when: str                  # ALWAYS / FAULT / DISAGG
    doc: str


STATS_SCHEMA: Tuple[KeySpec, ...] = (
    KeySpec("prefill_tokens", int, ALWAYS,
            "tokens prefilled across engines (incl. regeneration)"),
    KeySpec("regen_tokens", int, ALWAYS,
            "prefill tokens that were pure cache-miss regeneration"),
    KeySpec("decode_steps", int, ALWAYS,
            "batched decode rounds executed across engines"),
    KeySpec("coordinator_hits", int, ALWAYS,
            "admissions whose KV was found (WA-LRU hit)"),
    KeySpec("coordinator_misses", int, ALWAYS,
            "admissions that had to regenerate"),
    KeySpec("park_copy_bytes", int, ALWAYS,
            "device bytes copied parking KV (0 in paged mode)"),
    KeySpec("resume_copy_bytes", int, ALWAYS,
            "device bytes copied resuming KV (0 in paged mode)"),
    KeySpec("migration_copy_bytes", int, ALWAYS,
            "device bytes moved pool-to-pool by work stealing"),
    KeySpec("steals", int, ALWAYS, "accepted work-steal decisions"),
    KeySpec("migrations", int, ALWAYS, "completed KV migrations"),
    KeySpec("prefetch_copies", int, ALWAYS,
            "speculative prefetch block replications"),
    KeySpec("faults_injected", int, ALWAYS,
            "engine fail/recover events applied"),
    KeySpec("cancelled_attempts", int, ALWAYS,
            "in-flight steps cancelled by faults/preemption"),
    KeySpec("preemptions", int, ALWAYS,
            "running decodes parked by AFS preemption"),
    KeySpec("afs_dev_max", float, ALWAYS,
            "max |service - fair target| over the run (seconds)"),
    KeySpec("kv_handoff_bytes", int, ALWAYS,
            "bytes moved prefill-pool -> decode-pool (disagg)"),
    KeySpec("handoff_count", int, ALWAYS, "completed KV handoffs"),
    KeySpec("handoffs_cancelled", int, ALWAYS,
            "handoffs cancelled by faults/capacity races"),
    KeySpec("prefetch_role_rejected", int, ALWAYS,
            "prefetches refused because the target was prefill-role"),
)

SUMMARY_SCHEMA: Tuple[KeySpec, ...] = (
    KeySpec("n_sessions", int, ALWAYS, "sessions submitted"),
    KeySpec("n_done", int, ALWAYS, "sessions finished"),
    KeySpec("tct_mean", float, ALWAYS, "mean task completion time (s)"),
    KeySpec("tct_p50", float, ALWAYS, "median TCT (s)"),
    KeySpec("tct_p99", float, ALWAYS, "p99 TCT (s)"),
    KeySpec("makespan", float, ALWAYS, "last finish time (virtual s)"),
    KeySpec("prefill_tokens", int, ALWAYS, "see stats()"),
    KeySpec("regen_tokens", int, ALWAYS, "see stats()"),
    KeySpec("decode_rounds", int, ALWAYS, "stats() decode_steps"),
    KeySpec("decoded_tokens", int, ALWAYS,
            "tokens emitted across all step outputs"),
    KeySpec("cache_hits", int, ALWAYS, "stats() coordinator_hits"),
    KeySpec("cache_misses", int, ALWAYS, "stats() coordinator_misses"),
    KeySpec("steals", int, ALWAYS, "see stats()"),
    KeySpec("migrations", int, ALWAYS, "see stats()"),
    KeySpec("prefetch_issued", int, ALWAYS, "prefetches scheduled"),
    KeySpec("prefetch_correct", int, ALWAYS,
            "prefetches whose prediction was used"),
    KeySpec("prefetch_copies", int, ALWAYS, "see stats()"),
    KeySpec("prefetch_wasted_bytes", float, ALWAYS,
            "replicated bytes never used"),
    KeySpec("faults_injected", int, FAULT, "see stats()"),
    KeySpec("cancelled_attempts", int, FAULT, "see stats()"),
    KeySpec("preemptions", int, FAULT, "see stats()"),
    KeySpec("afs_dev_max", float, FAULT, "see stats()"),
    KeySpec("handoffs", int, DISAGG, "stats() handoff_count"),
    KeySpec("handoff_bytes", float, DISAGG, "stats() kv_handoff_bytes"),
    KeySpec("handoffs_cancelled", int, DISAGG, "see stats()"),
    KeySpec("prefill_jobs", int, DISAGG,
            "prefill-pool jobs submitted"),
    KeySpec("speculative_prefills", int, DISAGG,
            "prefills started inside tool gaps"),
    KeySpec("prefill_deferred", int, DISAGG,
            "prefill jobs deferred for capacity"),
    KeySpec("prefetch_role_rejected", int, DISAGG, "see stats()"),
)

WALL_SCHEMA: Tuple[KeySpec, ...] = (
    KeySpec("events", int, ALWAYS, "events dispatched by the driver"),
    KeySpec("max_lag_s", float, ALWAYS,
            "worst wall lag behind the pacing deadline"),
    KeySpec("wall_elapsed_s", float, ALWAYS, "wall duration of the run"),
    KeySpec("submitted", int, ALWAYS,
            "submissions through the driver (not the runtime total)"),
)

_BOOLS_OK = {int: (int,), float: (float, int)}


def _check(schema: Tuple[KeySpec, ...], d: Dict[str, object],
           what: str) -> None:
    errs = []
    by_name = {k.name: k for k in schema}
    for name in sorted(d):
        spec = by_name.get(name)
        if spec is None:
            errs.append(f"{name!r} present but not in the schema")
        elif not isinstance(d[name], _BOOLS_OK[spec.type]) \
                or isinstance(d[name], bool):
            errs.append(f"{name!r} is {type(d[name]).__name__}, schema "
                        f"says {spec.type.__name__}")
    if errs:
        raise AssertionError(f"{what} diverges from "
                             "repro_torch.serving.schema: " + "; ".join(errs))


def validate_stats(stats: Dict[str, object]) -> None:
    """Every documented stats() key present with the documented type;
    undocumented keys are an error (add a KeySpec when adding a key)."""
    missing = sorted(set(k.name for k in STATS_SCHEMA) - set(stats))
    if missing:
        raise AssertionError(f"stats() missing documented keys {missing}")
    _check(STATS_SCHEMA, stats, "stats()")


def validate_summary(summary: Dict[str, object], *,
                     fault: bool = False, disagg: bool = False) -> None:
    """summarize() keys must be EXACTLY the schema rows whose condition
    is active — order included (the repr is the byte-pin)."""
    want = [k.name for k in SUMMARY_SCHEMA
            if k.when == ALWAYS or (fault and k.when == FAULT)
            or (disagg and k.when == DISAGG)]
    got = list(summary)
    if got != want:
        raise AssertionError(
            f"summarize() keys {got} != schema expectation {want}")
    _check(SUMMARY_SCHEMA, summary, "summarize()")


def validate_wall_stats(ws: Dict[str, object]) -> None:
    _check(WALL_SCHEMA, ws, "wall_stats")
