"""Disaggregated prefill/decode engine pools (ROADMAP item 2).

In the unified pool a 1000-token agent-context resume shares an engine
with latency-critical decode rounds, so one long prefill stalls a whole
batch.  With ``SAGAConfig.disaggregate`` on, the serving runtime splits
its engines into roles:

  * **prefill** engines never hold decode slots, never appear in Eq. 7
    routing or the work stealer's idle set, and own no coordinator pool
    metadata.  Their ``PagedKVPool`` is a *staging area*: a prefill job
    computes the step's delta (or full-context) KV standalone — the
    causal mask makes a delta prefill independent of where the parked
    prefix lives, so the staged blocks are bit-identical to what the
    decode engine would have produced — and parks it awaiting handoff.
  * **decode** engines run the classic runtime lifecycle (slots, queues,
    batched rounds, park-on-tool, WA-LRU/TTL, stealing, prefetch).
    Eq. 7 affinity routing decides decode placement only.

The :class:`PrefillScheduler` owns the prefill pool: jobs are placed on
the least-backlogged live prefill engine (a per-engine serial virtual
server, ``avail_at``), gated on staging capacity so ``stage_prefill``
can never fail; jobs that do not fit wait in a FIFO and drain as
handoffs release staged blocks.  Completed prefill KV hands off to the
routed decode engine over the block-granular ``export_kv`` /
``import_handoff`` path; the transfer window is deterministic
(bytes / ``handoff_bytes_per_s`` + a latency floor — no RNG, so disagg
runs stay byte-identical across processes and ``PYTHONHASHSEED``).

Speculative *prefill*: the next step's prompt is resolved at the park
boundary (``resolve_next``), so the runtime submits the prefill job at
tool-gap START — prefill and handoff overlap the gap, generalizing
speculative prefetch, and a resume whose handoff already landed joins a
decode slot with zero prefill on the critical path.

Fault matrix (see ``docs/DISAGG.md``): every job is attempt-stamped, so
a prefill engine dying mid-handoff invalidates the pending
``pf_done`` / ``handoff_done`` events, reclaims staged blocks on both
sides, and the session re-prefills on a live engine — token-identical,
because the staged KV is a pure function of the context tokens.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

ROLE_PREFILL = "prefill"
ROLE_DECODE = "decode"
ROLE_UNIFIED = "unified"

ROLES = (ROLE_PREFILL, ROLE_DECODE, ROLE_UNIFIED)


def default_roles(n_workers: int) -> List[str]:
    """Default disagg split: one prefill engine per four workers (at
    least one), the rest decode.  Prefill engines take the LOW indices
    so a fault plan targeting worker 0 exercises the prefill-death
    path."""
    n_prefill = max(1, n_workers // 4)
    if n_prefill >= n_workers:
        raise ValueError(
            f"disaggregation needs >= 2 engines, got {n_workers}")
    return [ROLE_PREFILL] * n_prefill \
        + [ROLE_DECODE] * (n_workers - n_prefill)


@dataclasses.dataclass
class HandoffJob:
    """One step's prefill-pool work item: compute KV for
    ``tokens[start:]`` on a prefill engine, stage it, hand the blocks
    off to decode engine ``d_engine``.  ``attempt`` stamps the job's
    ``pf_done``/``handoff_done`` events — a fault bumps the registry,
    and stale events no longer match (the runtime's inflight-registry
    pattern, applied to the handoff lifecycle)."""
    session_id: str
    attempt: int
    d_engine: int                 # Eq. 7 decode placement (routed at admit)
    start: int                    # first token to prefill (0 = full regen)
    tokens: List[int]             # full step context snapshot
    pf_tokens: float              # policy-visible prefill length (virtual)
    speculative: bool             # submitted at tool-gap start
    p_engine: int = -1            # assigned prefill engine (-1 = pending)
    state: str = "pending"        # pending | prefill | staged
    waiting: bool = False         # gap over: dispatch as soon as KV lands

    @property
    def n_stage(self) -> int:
        """Tokens staged on the prefill engine (delta or full ctx)."""
        return len(self.tokens) - self.start


class PrefillScheduler:
    """Deterministic prefill-pool scheduler.

    Placement: among alive prefill engines whose staging pool can hold
    the job (counting blocks already reserved by admitted-but-unstaged
    jobs), pick the earliest ``(avail_at, engine_id)`` — a serial
    virtual server per engine, mirroring how ``RuntimePerf`` models one
    prefill stream per worker.  Jobs that fit nowhere wait in
    ``pending`` (FIFO) and are re-tried whenever staged blocks are
    released.  All state is plain dicts/lists keyed by session id and
    engine id — no hash-order or RNG dependence anywhere."""

    def __init__(self, prefill_engines: Sequence[int]) -> None:
        self.prefill_engines: List[int] = sorted(prefill_engines)
        self.avail_at: Dict[int, float] = {p: 0.0
                                           for p in self.prefill_engines}
        # blocks promised to admitted jobs that have not staged yet
        self.reserved: Dict[int, int] = {p: 0
                                         for p in self.prefill_engines}
        self.jobs: Dict[str, HandoffJob] = {}
        self.pending: List[str] = []
        # counters (surfaced via ServingRuntime.stats / summarize)
        self.submitted = 0
        self.speculative = 0
        self.deferred = 0

    # -- job lifecycle ---------------------------------------------------
    def submit(self, job: HandoffJob) -> None:
        assert job.session_id not in self.jobs, \
            f"duplicate prefill job for {job.session_id!r}"
        self.jobs[job.session_id] = job
        self.submitted += 1
        if job.speculative:
            self.speculative += 1

    def place(self, job: HandoffJob, now: float, pools,
              alive: Sequence[bool]) -> Optional[Tuple[int, float]]:
        """Assign ``job`` to a prefill engine.  Returns (engine,
        start_time) and reserves the staging blocks, or None when no
        live prefill engine has capacity (caller queues the job in
        ``pending``)."""
        best: Optional[Tuple[float, int]] = None
        need = 0
        for p in self.prefill_engines:
            if not alive[p]:
                continue
            pool = pools[p]
            need = pool._blocks_for(job.n_stage)
            if self.reserved[p] + need > \
                    pool.num_blocks - pool.used_blocks():
                continue
            key = (max(self.avail_at[p], now), p)
            if best is None or key < best:
                best = key
        if best is None:
            return None
        t0, p = best
        self.reserved[p] += pools[p]._blocks_for(job.n_stage)
        job.p_engine = p
        job.state = "prefill"
        return p, t0

    def defer(self, job: HandoffJob) -> None:
        """No capacity anywhere: FIFO-queue the job for the next staged
        -block release."""
        assert job.state == "pending" and job.p_engine == -1
        self.pending.append(job.session_id)
        self.deferred += 1

    def note_busy_until(self, p: int, t: float) -> None:
        self.avail_at[p] = t

    def staged(self, job: HandoffJob, pools) -> None:
        """The job's KV landed in the staging pool: its reservation is
        now real ``used_blocks`` and must stop double-counting."""
        assert job.state == "prefill"
        self.unreserve(job, pools)
        job.state = "staged"

    def unreserve(self, job: HandoffJob, pools) -> None:
        """Return an un-staged job's block reservation (cancel path, or
        the moment staging converts it to real usage).  Staged jobs hold
        no reservation — their blocks are freed through the pool."""
        if job.state == "prefill" and job.p_engine in self.reserved:
            self.reserved[job.p_engine] = max(
                0, self.reserved[job.p_engine]
                - pools[job.p_engine]._blocks_for(job.n_stage))

    def pop(self, sid: str) -> Optional[HandoffJob]:
        """Remove a job from the registry (handoff complete or
        cancelled) and from the pending FIFO if it never placed."""
        job = self.jobs.pop(sid, None)
        if job is not None and sid in self.pending:
            self.pending.remove(sid)
        return job

    def drain(self, now: float, pools,
              alive: Sequence[bool]) -> List[Tuple[HandoffJob, int,
                                                   float]]:
        """Re-try every pending job in FIFO order after staged blocks
        were released (or a prefill engine recovered).  Returns the
        newly-placed (job, engine, start_time) triples; unplaced jobs
        keep their FIFO position."""
        placed: List[Tuple[HandoffJob, int, float]] = []
        still: List[str] = []
        for sid in self.pending:
            job = self.jobs.get(sid)
            if job is None:
                continue
            got = self.place(job, now, pools, alive)
            if got is None:
                still.append(sid)
            else:
                placed.append((job, got[0], got[1]))
        self.pending = still
        return placed

    def jobs_touching(self, w: int) -> List[HandoffJob]:
        """Jobs whose prefill OR decode engine is ``w`` — the fault
        path's cancellation set, deterministic order."""
        return [self.jobs[sid] for sid in sorted(self.jobs)
                if self.jobs[sid].p_engine == w
                or self.jobs[sid].d_engine == w]

    def staged_on(self, w: int) -> set:
        """Session ids whose staged (in-transit) blocks live on engine
        ``w`` — the sanitizer's cross-pool exemption set: these parked
        blocks deliberately have no coordinator pool metadata."""
        return {sid for sid, job in self.jobs.items()
                if job.p_engine == w and job.state == "staged"}
