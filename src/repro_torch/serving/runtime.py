"""Event-driven concurrent serving runtime: whole agent workflows
interleaved on real engines (the paper's serving layer, §3-§6).

``ServingRuntime`` executes MANY concurrent multi-step agent sessions
across multiple real ``Engine``s (actual jitted JAX forward passes —
tiny zoo models on CPU, same code on TPU pods) under the same
``GlobalCoordinator`` that drives the discrete-event simulator:

  * **AFS-priority admission** — when an engine's decode slots are full,
    sessions wait in a per-engine ``SessionQueue`` ordered by tenant
    Agent-Fair-Share (§6), not FIFO.
  * **Continuous batching** — all decode-phase sessions co-resident on
    an engine advance together, one batched ``decode_step`` per virtual
    decode round; sessions join/leave the batch mid-flight as prefills
    complete and steps finish (per-slot rows are independent, so
    interleaving is token-for-token identical to serial execution).
  * **Park-on-tool with TTL** — a session entering a tool call parks its
    slot KV into the engine's paged pool; the coordinator stamps the
    entry with a tool-aware TTL (§4.2) and WA-LRU (§4.1) decides who
    survives memory pressure.  Eviction decisions propagate to the real
    block tables through an event-driven callback (the evicted-entry
    list from ``on_step_end``), never a per-step scan of all sessions.
  * **Resume with delta-only prefill** — a returning session that still
    holds pool KV prefills only the new tokens (tool observation + next
    user turn); a victim of eviction regenerates its whole context, the
    paper's central cost.
  * **Affinity routing + work stealing** — Eq. 7 routes a resuming
    session to its KV home unless overloaded; the 100 ms epoch tick
    (ported from the simulator's O(changes) incremental form: integer
    load vector, indexed idle set, nonempty-queue victim index) lets an
    idle engine steal a queued session, migrating its parked KV blocks
    pool-to-pool.
  * **Speculative prefetch with real copies** — during a tool gap the
    prefetcher (§4.3) predicts the next step; if the home engine looks
    overloaded for the resume, the parked KV is *replicated* to the
    likely overflow target so the resume still hits cache.  Copies are
    real block transfers that overlap the (virtual-time) tool gap.
  * **Disaggregated prefill/decode pools** (opt-in via
    ``SAGAConfig.disaggregate``; ``repro_torch.serving.disagg``) — engines
    split into prefill/decode roles: new-session and tool-resume
    prefills run on the prefill pool (speculatively, overlapping the
    tool gap) and the staged KV hands off block-granularly to the
    Eq. 7-routed decode engine, so decode rounds run prefill-free.

Fault tolerance and preemption (the simulator's lifecycle, on real
engines):

  * **Engine fault injection** — ``cluster.faults`` plans (chaos /
    straggler / preemption storms; ("fail"|"recover"|"scale_up"|"slow"|
    "heal", worker) events) drive the runtime through virtual-time
    events.  Every admitted step lives in an attempt-stamped in-flight
    registry; a ``fail`` cancels the dead engine's attempts (stale
    ``prefill_done``/``round`` events are dropped by attempt/generation
    stamps), reclaims slot KV, releases pool blocks, refunds partially-
    charged AFS work, and re-dispatches each session to a live engine,
    which regenerates from its last parked prefix (§3.1).  If every
    engine is down, sessions park in an orphan buffer until a recover /
    scale-up.
  * **AFS preemption of running decodes** (§6.2) — admission ordering
    alone cannot enforce Theorem 2's bounded deviation once a victim
    holds a slot, so when a queued session's fair-share deficit against
    the lowest-priority running decode exceeds ``preempt_deficit`` for
    longer than ``preempt_block_s`` (hysteresis), the victim is parked
    at the next batched-decode round boundary: slot KV exported to the
    pool with a TTL entry, the starved session admitted, and the victim
    later resumed with a delta-only prefill mid-step — token-for-token
    identical to an unpreempted run while the parked copy survives.

Time is virtual (``repro_torch.serving.events.EventLoop``): tool gaps cost
nothing on the wall clock, and identical-seed runs produce byte-identical
``summarize()`` output even across processes with different
``PYTHONHASHSEED`` — the same determinism contract as the simulator,
preserved under fault plans and preemption.  Real compute (prefill,
decode, KV copies) runs eagerly as its event is processed.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import os
import random
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core.coordinator import GlobalCoordinator, SAGAConfig
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.tracer import ROOT, as_tracer
from repro_torch.serving.disagg import (HandoffJob, PrefillScheduler,
                                  ROLE_DECODE, ROLE_PREFILL, ROLE_UNIFIED,
                                  default_roles)
from repro_torch.serving.engine import Engine
from repro_torch.serving.events import EventLoop, SessionQueue, _RuntimeQueueView
from repro_torch.serving.sanitizer import RuntimeSanitizer
from repro_torch.workflow.program import WorkflowInstance, as_instance

INF = float("inf")


@dataclasses.dataclass
class AgentRequest:
    """One agent task: steps of (new prompt tokens, n decode tokens,
    tool type, tool gap seconds).  ``arrival_s`` places the request on
    the runtime's virtual clock (0 = immediately).

    Backward-compat adapter format: ``submit`` compiles it to a
    scripted ``repro_torch.workflow.AgentProgram`` (byte-identical execution);
    graph / dynamic programs are submitted directly."""
    session_id: str
    tenant: str
    steps: List[Tuple[List[int], int, str, float]]
    arrival_s: float = 0.0


@dataclasses.dataclass
class RuntimePerf:
    """Virtual-time service model (per engine).  Real compute runs
    eagerly; these rates only advance the deterministic clock, mirroring
    ``cluster.perf.PerfModel`` at serving granularity."""
    prefill_tokens_per_s: float = 8000.0
    decode_round_s: float = 0.025        # one batched decode step
    epoch_s: float = 0.100               # coordinator tick (§6)
    migration_mean_s: float = 0.230      # Llumnix-style KV move (Table 7)
    migration_p95_s: float = 0.890
    # prefill/decode interference: each in-flight prefill on an engine
    # stretches its concurrent batched decode rounds by this fraction
    # (chunked-prefill contention — the cost disaggregation removes).
    # 0.0 keeps every committed fingerprint byte-identical.
    prefill_round_interference: float = 0.0
    # the symmetric half of chunked-prefill contention: a prefill
    # admitted to an engine already running decode rounds is itself
    # chunked into the round schedule, stretching by this fraction per
    # active decode slot.  Dedicated prefill engines have no decode
    # slots, so the disaggregated pool runs prefill at full rate —
    # the capacity argument for disaggregation.  Default 0.0 keeps
    # every committed fingerprint byte-identical.
    prefill_decode_interference: float = 0.0
    # disaggregated handoff transport (prefill -> decode pool): a
    # deterministic bandwidth + latency-floor window, like migration but
    # RNG-free so disagg summaries stay byte-identical across processes
    handoff_bytes_per_s: float = 8.0e9
    handoff_latency_s: float = 0.002

    def sample_migration_s(self, rng: random.Random) -> float:
        mu = math.log(self.migration_mean_s) - 0.3
        sigma = math.log(self.migration_p95_s /
                         self.migration_mean_s) / 1.645 + 0.3
        return min(math.exp(mu + sigma * rng.gauss(0, 1)), 5.0)


@dataclasses.dataclass
class SessionState:
    """Mutable runtime record for one submitted agent session."""
    inst: WorkflowInstance
    session_id: str
    arrival: float
    ctx: List[int] = dataclasses.field(default_factory=list)
    step_idx: int = 0
    engine: int = -1                 # engine owning the current step
    slot: int = -1
    remaining: int = 0               # decode tokens left this step
    next_token: int = 0
    state: str = "new"               # queued|prefill|decode|tool|migrating|done
    cached_hit: bool = False         # admission's hit verdict (pinned)
    regen_tokens: int = 0
    finished_at: float = -1.0
    step_outputs: List[List[int]] = dataclasses.field(default_factory=list)
    # fault/preemption lifecycle: the ctx length at step start (prompt
    # included) so a cancelled attempt can roll the decoded tail back,
    # whether the session is mid-step (preempted: remaining survives the
    # park), and the AFS progress already charged for the current step
    # (refunded if a fault forces a full retry)
    attempt: int = -1
    step_start_len: int = 0
    mid_step: bool = False
    work_charged: float = 0.0
    # disaggregated handoff rendezvous (serving/disagg.py): the step's
    # prefilled KV landed on decode engine ``handoff_dst`` and admission
    # there needs zero critical-path prefill; ``handoff_lost`` marks a
    # fault/capacity casualty that must regenerate on the decode engine
    # WITHOUT re-counting the step's hit/miss verdict
    handoff_ready: bool = False
    handoff_dst: int = -1
    handoff_lost: bool = False
    # front-end extensions (serving/frontend, SagaClient): a one-shot
    # engine preference consumed on the session's FIRST dispatch only
    # (later steps follow Eq. 7 affinity as usual), and an explicit SLO
    # deadline offset registered with the coordinator.  Both default
    # off, so virtual-time byte-pins never see them.
    route_hint: Optional[int] = None
    slo_s: Optional[float] = None

    @property
    def tct(self) -> float:
        return self.finished_at - self.arrival


@dataclasses.dataclass
class _QueueTicket:
    """One enqueue = one ticket.  The tombstone flag lives HERE, not on
    the shared SessionState: a stolen session that re-enqueues elsewhere
    must not resurrect its lazily-deleted entry in the victim's heap."""
    session_id: str
    cancelled: bool = False


class WorkflowHandle:
    """Client-facing handle for one submitted workflow (returned by
    ``ServingRuntime.submit``): inspect ``status`` / ``step_outputs`` /
    ``path`` while the runtime interleaves, or block on ``result()``."""

    def __init__(self, runtime: "ServingRuntime", ses: "SessionState"):
        self._rt = runtime
        self._ses = ses

    @property
    def session_id(self) -> str:
        return self._ses.session_id

    @property
    def status(self) -> str:
        """new|queued|prefill|decode|tool|migrating|done"""
        return self._ses.state

    @property
    def done(self) -> bool:
        return self._ses.finished_at >= 0

    @property
    def step_outputs(self) -> List[List[int]]:
        """Decoded token ids per executed step (so far)."""
        return [list(o) for o in self._ses.step_outputs]

    @property
    def path(self) -> List[int]:
        """AEG node ids of the executed steps (so far) — shows which
        branches / retry edges the workflow actually took."""
        return list(self._ses.inst.path)

    @property
    def truncated(self) -> bool:
        """True when the engine's context cap ended the workflow before
        its graph/callback did — the taken path is then a strict prefix
        of what an unconstrained substrate would execute."""
        return self._ses.inst.truncated

    @property
    def tct(self) -> float:
        if not self.done:
            raise RuntimeError(f"workflow {self.session_id} not finished")
        return self._ses.tct

    def result(self, horizon_s: float = INF) -> List[List[int]]:
        """Drive the runtime's virtual clock until this workflow
        finishes, then return its per-step decoded token ids.  Other
        concurrent sessions keep interleaving while we wait."""
        if not self.done:
            self._rt._run_until_done(self._ses.session_id, horizon_s)
        if not self.done:
            raise RuntimeError(
                f"workflow {self.session_id} did not finish "
                f"(state={self.status})")
        return self.step_outputs


class ServingRuntime:
    """Deterministic virtual-time event loop over ``n_workers`` real
    engines.  ``submit`` accepts ``AgentProgram``s (scripted / graph /
    dynamic) and legacy ``AgentRequest``s, then ``run`` to completion;
    the ``MultiWorkerServer`` wraps this serially for the legacy API."""

    def __init__(self, cfg: ModelConfig, params, *, n_workers: int = 2,
                 saga: Optional[SAGAConfig] = None, n_slots: int = 4,
                 max_len: int = 512, pool_blocks: int = 48,
                 perf: Optional[RuntimePerf] = None, seed: int = 0,
                 engines: Optional[List[Engine]] = None,
                 fault_plan: Optional[Sequence[Tuple[float, str,
                                                     int]]] = None,
                 straggler_slowdown: float = 4.0,
                 sanitize: Optional[bool] = None,
                 paged: bool = True,
                 roles: Optional[Sequence[str]] = None,
                 trace=None):
        self.cfg = cfg
        self.params = params
        self.engines = engines if engines is not None else [
            Engine(cfg, params, n_slots=n_slots, max_len=max_len,
                   pool_blocks=pool_blocks, paged=paged)
            for _ in range(n_workers)]
        self.n_workers = len(self.engines)
        self.n_slots = self.engines[0].n_slots
        pool = self.engines[0].pool
        self.kv_bytes_per_token = pool.bytes_per_block / pool.block
        pool_bytes = pool.num_blocks * pool.bytes_per_block
        self.co = GlobalCoordinator(saga or SAGAConfig(), self.n_workers,
                                    pool_bytes)
        # disaggregated prefill/decode pools (serving/disagg.py):
        # opt-in via SAGAConfig.disaggregate — the unified pool stays
        # the default so every committed fingerprint is unchanged
        self.disagg = bool(self.co.cfg.disaggregate)
        if self.disagg:
            if roles is None:
                roles = default_roles(self.n_workers)
            assert all(self.engines[w].paged
                       for w in range(self.n_workers)
                       if roles[w] == ROLE_PREFILL), \
                "disaggregation needs paged engines (block handoff)"
        self.roles: List[str] = list(roles) if roles is not None \
            else [ROLE_UNIFIED] * self.n_workers
        # role/disagg coherence lives with every other config check in
        # SAGAConfig.validate (the GlobalCoordinator ctor above already
        # validated the role-free invariants)
        self.co.cfg.validate(roles=self.roles, n_workers=self.n_workers)
        self._prefill_ids = [w for w, r in enumerate(self.roles)
                             if r == ROLE_PREFILL]
        for w in self._prefill_ids:
            self.co.set_worker_role(w, ROLE_PREFILL)
        self._pf = PrefillScheduler(self._prefill_ids)
        self.perf = perf or RuntimePerf()
        self.perf = dataclasses.replace(self.perf,
                                        epoch_s=self.co.cfg.epoch_s)
        self.rng = random.Random(seed)
        self.ev = EventLoop()
        self.sessions: Dict[str, SessionState] = {}
        self.n_done = 0
        # per-engine scheduling state (incremental epoch-tick structures
        # ported from the simulator: integer load counts, nonempty-queue
        # victim index, persistent stealer queue views)
        self.queues: List[SessionQueue] = [SessionQueue()
                                           for _ in range(self.n_workers)]
        self._queue_views = [_RuntimeQueueView(lambda w=w: self.queues[w])
                             for w in range(self.n_workers)]
        self._active: List[set] = [set() for _ in range(self.n_workers)]
        self._resident = [0] * self.n_workers    # prefill + decode sessions
        self._round_live = [False] * self.n_workers
        self._loadnum = np.zeros(self.n_workers, dtype=np.int64)
        self._nonempty: set = set()
        self._alive = [True] * self.n_workers
        self._epoch_live = False
        self.migrating: Dict[str, Tuple[int, int]] = {}
        # fault-correct lifecycle (the simulator's registry, runtime
        # twin): sid -> (engine, attempt) for every admitted step; the
        # matching prefill_done event carries the attempt and a mismatch
        # at delivery means a fault cancelled the step in the meantime.
        # Round events are generation-stamped per engine the same way.
        self.inflight: Dict[str, Tuple[int, int]] = {}
        self._attempt = itertools.count()
        self._gen = [0] * self.n_workers
        self._slow: Dict[int, float] = {}
        self.straggler_slowdown = straggler_slowdown
        self._orphans: List[str] = []
        self.fault_plan = list(fault_plan or [])
        for t, kind, w in self.fault_plan:
            self.ev.schedule(t, "fault", (kind, w))
        # AFS preemption of running decodes (§6.2): decided at the epoch
        # tick, executed at the next round boundary.  Thm. 2 deviation is
        # measured against constant workload-proportional fair rates
        # (mu_i ∝ W_i, the lyapunov_v convention), so per-tenant
        # submitted work is accumulated at registration.
        self._preempt_pending: Dict[int, str] = {}
        self._last_preempt = [-INF] * self.n_workers
        self._tenant_workload: Dict[str, float] = {}
        # per-event conservation audit (repro_torch.serving.sanitizer):
        # read-only, so summaries are byte-identical with it on or off.
        # The env gate is a debug opt-in that never alters scheduling.
        if sanitize is None:
            # sagalint: ok(det-env) sanitize toggles assertions only, never a scheduling decision — replay is unaffected
            sanitize = os.environ.get("SAGA_SANITIZE", "") not in ("",
                                                                   "0")
        self._san = RuntimeSanitizer(self) if sanitize else None
        # virtual-time span tracer + metrics registry (repro_torch.obs):
        # read-only like the sanitizer — a traced run's summarize() is
        # byte-identical to the untraced run, and the trace bytes are
        # byte-identical across PYTHONHASHSEED (docs/OBSERVABILITY.md).
        # ``trace`` accepts True (fresh tracer) or a Tracer instance.
        if trace is None:
            # sagalint: ok(det-env) trace toggles recording only, never a scheduling decision — replay is unaffected
            trace = os.environ.get("SAGA_TRACE", "") not in ("", "0")
        self.tracer = as_tracer(trace)
        self.obs_metrics = MetricsRegistry() if self.tracer is not None \
            else None
        # per-session open-span ids keyed by role ("session" / "step" /
        # "queue" / "phase" / "gap" / "migr"); plain string keys, never
        # id() — part of the determinism contract
        self._tr_open: Dict[str, Dict[str, int]] = {}
        # metric sampling is decimated to every 10th epoch tick (1 s of
        # virtual time) with per-engine gauge handles cached — same
        # rationale as the simulator (table7's trace-overhead row)
        self._obs_tick = 0
        self._obs_engine_g: List[tuple] = []
        # instrumentation
        self.migrations = 0
        self.prefetch_copies = 0
        self.prefetch_copy_bytes = 0.0
        self.faults_injected = 0
        self.cancelled_attempts = 0
        self.preempted = 0
        self.afs_dev_max = 0.0
        # disaggregated-handoff instrumentation (stats / summarize; the
        # obs counters kv_handoff_bytes / handoff_count mirror these on
        # traced runs)
        self.handoffs = 0
        self.kv_handoff_bytes = 0
        self.handoffs_cancelled = 0
        self.prefetch_role_rejected = 0
        for w in range(self.n_workers):
            self.co.on_worker_idle(w, 0.0)

    # -- load reporting (shared with MultiWorkerServer._loads) ----------
    def loads(self) -> np.ndarray:
        """Queue-depth + slot-occupancy load vector in slot units: one
        C-level division of the incrementally-maintained integer counts
        (replaces the old binary free-slot hack)."""
        return self._loadnum / self.n_slots

    def _load_delta(self, w: int, d: int) -> None:
        self._loadnum[w] += d

    # -- tracing helpers (no-ops when tracing is off) -------------------
    def _tr_begin(self, sid: str, key: str, name: str,
                  parent_key: Optional[str] = None,
                  t: Optional[float] = None, **meta) -> None:
        if self.tracer is None:
            return
        o = self._tr_open.setdefault(sid, {})
        parent = o.get(parent_key, ROOT) if parent_key else ROOT
        o[key] = self.tracer.begin(f"session/{sid}", name,
                                   self.ev.now if t is None else t,
                                   parent=parent, **meta)

    def _tr_end(self, sid: str, key: str, status: str = "ok",
                t: Optional[float] = None, **meta) -> None:
        if self.tracer is None:
            return
        o = self._tr_open.get(sid)
        if o is None or key not in o:
            return
        self.tracer.end(o.pop(key), self.ev.now if t is None else t,
                        status=status, **meta)

    def _tr_instant(self, track: str, name: str, **meta) -> None:
        if self.tracer is not None:
            self.tracer.instant(track, name, self.ev.now, **meta)

    # -- submission -----------------------------------------------------
    def submit(self, req,
               arrival: Optional[float] = None, *,
               route_hint: Optional[int] = None,
               slo_s: Optional[float] = None) -> "WorkflowHandle":
        """Submit a workflow: an ``AgentProgram`` (scripted / graph /
        dynamic) or a legacy ``AgentRequest`` (compiled to a scripted
        program, byte-identical execution).  Graph and dynamic programs
        resolve their branches at park/resume boundaries on the virtual
        clock; unspecified prompt ids are realized deterministically
        from the program's seed against this model's vocab.  Returns a
        ``WorkflowHandle`` (``result()`` / ``step_outputs`` /
        ``status``)."""
        inst = as_instance(req, vocab=self.cfg.vocab,
                           max_ctx_tokens=self.engines[0].max_len)
        sid = inst.task_id
        if sid in self.sessions:
            raise ValueError(f"duplicate session id {sid!r}")
        t = max(self.ev.now,
                inst.arrival_s if arrival is None else arrival)
        ses = SessionState(inst, sid, t)
        ses.route_hint = route_hint
        ses.slo_s = slo_s
        self.sessions[sid] = ses
        self.ev.schedule(t, "arrival", (sid,))
        if not self._epoch_live:
            self._epoch_live = True
            self.ev.schedule(self.ev.now + self.perf.epoch_s, "epoch")
        return WorkflowHandle(self, ses)

    def run(self, horizon_s: float = INF) -> Dict[str, SessionState]:
        """Advance the virtual clock until every submitted session has
        finished (or ``horizon_s``).  Resumable: later submits + runs
        continue on the same clock."""
        while self.ev:
            if self.ev.peek_time() > horizon_s:
                break
            t, kind, args = self.ev.pop()
            getattr(self, "_on_" + kind)(*args)
            if self._san is not None:
                self._san.after_event(t, kind, args)
            if kind != "epoch" and self.n_done == len(self.sessions):
                break
        return self.sessions

    def _run_until_done(self, sid: str, horizon_s: float = INF) -> None:
        """Advance the clock until session ``sid`` finishes (the
        ``WorkflowHandle.result`` path) — other sessions keep
        interleaving normally."""
        ses = self.sessions[sid]
        while ses.finished_at < 0 and self.ev:
            if self.ev.peek_time() > horizon_s:
                break
            t, kind, args = self.ev.pop()
            getattr(self, "_on_" + kind)(*args)
            if self._san is not None:
                self._san.after_event(t, kind, args)

    # -- step lifecycle -------------------------------------------------
    def _on_arrival(self, sid: str) -> None:
        ses = self.sessions[sid]
        inst = ses.inst
        counts = inst.nominal_rt_counts()
        tools = [t for _, _, t in counts]
        work_est = sum(np_ / self.perf.prefill_tokens_per_s
                       + n * self.perf.decode_round_s
                       for np_, n, _ in counts)
        aeg = inst.declared_aeg()
        self._tenant_workload[inst.tenant] = \
            self._tenant_workload.get(inst.tenant, 0.0) + work_est
        step_cost = work_est / max(len(counts), 1) \
            if aeg is not None else 0.0
        slo = ses.slo_s if ses.slo_s is not None else 3600.0
        self.co.register_task(sid, inst.tenant, tools,
                              deadline=self.ev.now + slo,
                              work_est_s=work_est, now=self.ev.now,
                              prefix_tokens=0, aeg=aeg,
                              step_cost_s=step_cost,
                              entry_node=inst.path[0] if inst.path else 0)
        self._tr_begin(sid, "session", "session", tenant=inst.tenant)
        self._begin_step(sid)

    def _begin_step(self, sid: str) -> None:
        ses = self.sessions[sid]
        prompt = ses.inst.rt_step(ses.step_idx)[0]
        ses.ctx.extend(int(t) for t in prompt)
        ses.step_start_len = len(ses.ctx)
        self._tr_begin(sid, "step", "step", parent_key="session",
                       step=ses.step_idx)
        self._redispatch(sid)

    def _decode_alive(self) -> bool:
        """Any engine that can hold decode slots up?  (Prefill-role
        engines cannot: a cluster where only they survive is DOWN for
        dispatch purposes — ``route`` masks them, so routing with no
        live decode engine would orphan sessions onto index 0.)"""
        return any(self._alive[w] for w in range(self.n_workers)
                   if self.roles[w] != ROLE_PREFILL)

    def _redispatch(self, sid: str) -> None:
        """Route to a live engine, or park in the orphan buffer when the
        whole cluster is down (readmitted on the next recover/scale-up,
        same as the simulator).  Disaggregated mode first checks the
        handoff rendezvous: landed KV dispatches straight to its decode
        engine, an in-flight job flips to ``waiting`` (the handoff event
        dispatches the session the moment the blocks arrive), and a
        fresh step submits to the prefill pool."""
        ses = self.sessions[sid]
        if not (self._decode_alive() if self.disagg
                else any(self._alive)):
            ses.state = "queued"
            self._orphans.append(sid)
            # the whole cluster is down: the wait still counts as queue
            # time (engine=-1); a pre-existing queue span keeps running
            if self.tracer is not None \
                    and "queue" not in self._tr_open.get(sid, {}):
                self._tr_begin(sid, "queue", "queue_wait",
                               parent_key="step", engine=-1)
            return
        if self.disagg and not ses.mid_step:
            d = ses.handoff_dst
            if ses.handoff_ready and 0 <= d < self.n_workers \
                    and self._alive[d] and self.engines[d].has_cache(sid):
                self._dispatch_to(sid, d)
                return
            job = self._pf.jobs.get(sid)
            if job is not None:
                # tool gap ended before the staged KV landed: wait at
                # the rendezvous (no decode queue slot consumed)
                ses.state = "queued"
                ses.engine = -1
                ses.slot = -1
                if self.tracer is not None \
                        and "queue" not in self._tr_open.get(sid, {}):
                    self._tr_begin(sid, "queue", "queue_wait",
                                   parent_key="step", engine=-1)
                job.waiting = True
                return
            if not ses.handoff_ready and not ses.handoff_lost:
                self._begin_prefill(sid)
                return
            # stale rendezvous (dst died, or the import lost the
            # capacity race): classic decode-pool dispatch below — the
            # target engine regenerates (§3.1); _admit sees the
            # handoff_lost flag and skips re-counting the verdict
            ses.handoff_ready = False
            ses.handoff_dst = -1
            ses.handoff_lost = True
        hint, ses.route_hint = ses.route_hint, None   # one-shot
        if hint is not None and 0 <= hint < self.n_workers \
                and self._alive[hint] \
                and self.roles[hint] != ROLE_PREFILL:
            # the hint bypasses co.route, so record the placement as the
            # session's home or Eq. 7 affinity can never find it on resume
            self.co.router.set_home(sid, hint)
            self._dispatch_to(sid, hint)
            return
        w = self.co.route(sid, self.loads(), self.ev.now)
        self._dispatch_to(sid, w)

    def _readmit_orphans(self) -> None:
        orphans, self._orphans = self._orphans, []
        for sid in orphans:
            self._redispatch(sid)
        if orphans and not self._epoch_live \
                and self.n_done < len(self.sessions):
            self._epoch_live = True
            self.ev.schedule(self.ev.now + self.perf.epoch_s, "epoch")

    def _dispatch_to(self, sid: str, w: int) -> None:
        if not self._alive[w]:
            self._redispatch(sid)
        elif self._resident[w] < self.n_slots and not self.queues[w]:
            self._admit(sid, w)
        else:
            self._enqueue(sid, w)

    def _enqueue(self, sid: str, w: int) -> None:
        ses = self.sessions[sid]
        ses.state = "queued"
        ses.engine = w
        # a re-enqueue (fault drain, preemption) closes the old wait
        # before opening the new one; first enqueues no-op the end
        self._tr_end(sid, "queue", status="requeued")
        self._tr_begin(sid, "queue", "queue_wait", parent_key="step",
                       engine=w)
        prio = -self.co.afs.priority(ses.inst.tenant)
        if not self.queues[w]:           # empty -> nonempty transition
            self._nonempty.add(w)
            self.co.on_worker_busy(w)
        self.queues[w].push(prio, self.ev.now, _QueueTicket(sid))
        self._load_delta(w, 1)
        self.co.afs.note_blocked(sid, self.ev.now)

    def _queue_pop(self, w: int) -> Optional[SessionState]:
        ticket = self.queues[w].pop()
        if ticket is not None:
            self._load_delta(w, -1)
            if not self.queues[w]:
                self._queue_went_empty(w)
            return self.sessions[ticket.session_id]
        return None

    def _queue_remove(self, w: int, sid: str) -> Optional[SessionState]:
        ticket = self.queues[w].remove(sid)
        if ticket is not None:
            self._load_delta(w, -1)
            if not self.queues[w]:
                self._queue_went_empty(w)
            return self.sessions[sid]
        return None

    def _queue_went_empty(self, w: int) -> None:
        self._nonempty.discard(w)
        self.co.on_worker_idle(w, self.ev.now)

    def _drain_queue(self, w: int) -> None:
        if not self._alive[w]:
            return
        while self.queues[w] and self._resident[w] < self.n_slots:
            ses = self._queue_pop(w)
            if ses is not None:
                self._admit(ses.session_id, w)

    def _admit(self, sid: str, w: int) -> None:
        """Slot admission: resolve cache hit vs regeneration against both
        the coordinator's policy view and the engine's real block table,
        then schedule the decode-phase join for when the (virtual)
        prefill completes.  The REAL prefill + slot write happen at that
        event — a written slot is immediately part of every decode round,
        so no round can touch a half-admitted session's cache
        (``decode_step`` writes KV for every batch row)."""
        ses = self.sessions[sid]
        eng = self.engines[w]
        ctx_len = len(ses.ctx)
        self.co.afs.note_unblocked(sid)
        if self.disagg and ses.handoff_ready and eng.has_cache(sid) \
                and int(eng.pool.lens.get(sid, -1)) == ctx_len:
            # the step's KV already landed via the prefill pool: the
            # hit/miss verdict was counted when the handoff job was
            # created, so admission here is a zero-prefill slot join
            # (mark_resident + empty delta)
            real_hit = True
            virt_prefill = 0.0
        elif self.disagg and (ses.handoff_ready or ses.handoff_lost):
            # rendezvous went stale between landing and admission (dst
            # died / import lost the capacity race): regenerate the
            # missing suffix here WITHOUT re-counting the step's verdict
            real_hit = eng.has_cache(sid)
            n_have = int(eng.pool.lens.get(sid, 0)) if real_hit else 0
            if not real_hit:
                ses.regen_tokens += ctx_len
            virt_prefill = float(ctx_len - n_have)
        else:
            hit, pf_tokens, bg_tokens = self.co.on_step_start(
                sid, w, float(ctx_len), self.ev.now)
            real_hit = hit and eng.has_cache(sid)
            if hit and not real_hit:
                # policy says cached but the blocks are gone (force-freed
                # making room for a park): heal the metadata
                self.co.drop_entry(sid, w, count_eviction=False)
            if not hit and eng.has_cache(sid):
                eng.evict_session(sid)       # policy evicted it earlier
            if real_hit:
                virt_prefill = float(pf_tokens)
            else:
                ses.regen_tokens += ctx_len
                # a correct, warm speculative prefetch regenerated
                # ``bg_tokens`` during the tool gap — off the critical
                # path
                virt_prefill = float(ctx_len) - float(bg_tokens)
        ses.handoff_ready = False
        ses.handoff_dst = -1
        ses.handoff_lost = False
        ses.state = "prefill"
        ses.engine = w
        ses.slot = -1                        # assigned at prefill_done
        ses.cached_hit = real_hit
        ses.attempt = next(self._attempt)
        self.inflight[sid] = (w, ses.attempt)
        self._resident[w] += 1
        self._load_delta(w, 1)
        pf_s = max(0.0, virt_prefill) * self._speed_factor(w) \
            / self.perf.prefill_tokens_per_s \
            * (1.0 + self.perf.prefill_decode_interference
               * len(self._active[w]))
        self._tr_end(sid, "queue")
        # span naming: "resume" is reserved for resumed steps so the
        # report's TTFT-on-resume counts the same population in unified
        # and disagg runs — a first-step admission whose KV landed via
        # the prefill pool is still an (off-engine) prefill, not a resume
        self._tr_begin(sid, "phase",
                       "resume" if real_hit and ses.step_idx > 0
                       else "prefill",
                       parent_key="step", engine=w, attempt=ses.attempt)
        if self.obs_metrics is not None:
            self.obs_metrics.histogram("prefill_s").observe(
                self.ev.now, pf_s)
        # service accrues as GPU time is actually consumed (prefill here,
        # decode per round) so Thm. 2 deviation sees starvation while it
        # is happening, not at completion granularity
        self.co.afs.note_service(ses.inst.tenant, pf_s)
        self.ev.schedule(self.ev.now + pf_s, "prefill_done",
                         (sid, ses.attempt))

    def _speed_factor(self, w: int) -> float:
        """Straggler slowdown factor for engine ``w`` (>1 = slow)."""
        return self._slow.get(w, 1.0)

    def _round_s(self, w: int) -> float:
        """Duration of the next batched decode round on ``w``: base rate
        x straggler factor x chunked-prefill interference — each session
        in prefill phase on the engine (``_resident`` minus the decode
        set) stretches the round by ``prefill_round_interference``.  The
        default coefficient 0.0 keeps every committed fingerprint
        byte-identical; the disagg A/B turns it on in BOTH arms, and the
        prefill pool wins exactly because its decode engines run
        (nearly) prefill-free rounds."""
        stretch = 1.0 + self.perf.prefill_round_interference \
            * max(0, self._resident[w] - len(self._active[w]))
        return self.perf.decode_round_s * self._speed_factor(w) * stretch

    def _on_prefill_done(self, sid: str, attempt: int = -1) -> None:
        rec = self.inflight.get(sid)
        if rec is None or rec[1] != attempt:
            return       # stale: the attempt was cancelled by a fault
        ses = self.sessions[sid]
        w = ses.engine
        slot = self.engines[w].start_session(
            sid, np.asarray(ses.ctx, np.int32), cached_hit=ses.cached_hit)
        if slot is None:                     # _resident bounds admissions
            raise RuntimeError(f"engine {w} slot accounting drifted")
        ses.slot = slot
        ses.state = "decode"
        if ses.mid_step:
            # resuming a preempted decode: ``remaining`` tokens of the
            # interrupted step are still owed; its partial output list
            # is already in place
            ses.mid_step = False
        else:
            ses.remaining = int(ses.inst.rt_step(ses.step_idx)[1])
            ses.step_outputs.append([])
        ses.next_token = int(ses.ctx[-1])
        self._tr_end(sid, "phase")
        self._tr_begin(sid, "phase", "decode", parent_key="step",
                       engine=w, attempt=attempt)
        if self.tracer is not None:
            # flag key alongside span ids: the next round stamps the
            # first decoded token's time onto the decode span (TTFT)
            self._tr_open[sid]["ttft_pending"] = 1
        self._active[w].add(sid)
        if not self._round_live[w]:
            self._round_live[w] = True
            dur = self._round_s(w)
            self.ev.schedule(self.ev.now + dur, "round",
                             (w, self._gen[w], dur))

    def _on_round(self, w: int, gen: int = 0, dur: float = -1.0) -> None:
        """One continuous-batching decode round: every decode-phase
        session on engine ``w`` advances one token in a single batched
        forward pass.  Sessions whose step completed leave the batch
        (their slot frees, the queue drains into it) while the rest keep
        decoding — no barrier between sessions.  ``gen`` stamps the
        engine incarnation: a round scheduled before a failure must not
        touch the recovered engine's fresh batch.  The round boundary is
        also where a pending AFS preemption parks its victim — never
        mid-forward-pass, so the decode batch stays internally
        consistent."""
        if gen != self._gen[w]:
            return                   # stale: engine died since scheduling
        active = sorted(self._active[w],
                        key=lambda s: (self.sessions[s].slot, s))
        if not active:
            self._round_live[w] = False
            return
        eng = self.engines[w]
        slot_tokens = {self.sessions[s].slot: self.sessions[s].next_token
                       for s in active}
        out = eng.decode(slot_tokens, n_steps=1)
        # the round's duration was fixed at schedule time (interference
        # snapshot); the legacy fallback covers replayed two-arg events
        round_s = dur if dur > 0.0 \
            else self.perf.decode_round_s * self._speed_factor(w)
        finished: List[str] = []
        for sid in active:
            ses = self.sessions[sid]
            tok = int(out[ses.slot][0])
            ses.ctx.append(tok)
            ses.step_outputs[-1].append(tok)
            ses.next_token = tok
            ses.remaining -= 1
            self.co.afs.note_service(ses.inst.tenant, round_s)
            if ses.remaining == 0:
                finished.append(sid)
        if self.tracer is not None:
            for sid in active:
                o = self._tr_open.get(sid)
                if o is not None \
                        and o.pop("ttft_pending", None) is not None \
                        and "phase" in o:
                    self.tracer.note(o["phase"],
                                     first_token_t=self.ev.now)
            self.tracer.complete(f"engine/{w}", "round",
                                 self.ev.now - round_s, self.ev.now,
                                 engine=w, batch=len(active),
                                 finished=len(finished))
            self.obs_metrics.histogram("decode_round_s").observe(
                self.ev.now, round_s)
        for sid in finished:
            self._active[w].discard(sid)
            self._finish_decode(sid)
        victim = self._preempt_pending.pop(w, None)
        if victim is not None and victim in self._active[w]:
            self._preempt_now(victim, w)
        if self._active[w]:
            nxt = self._round_s(w)
            self.ev.schedule(self.ev.now + nxt, "round",
                             (w, self._gen[w], nxt))
        else:
            self._round_live[w] = False
        self._drain_queue(w)

    def _step_work_s(self, prompt_len: int, n_out: int) -> float:
        """Nominal GPU-seconds of one step (Eq. 9 granularity): virtual
        prefill + one decode round per token.  Straggler factors are
        deliberately excluded so AFS charges demand, not slowness."""
        return prompt_len / self.perf.prefill_tokens_per_s \
            + n_out * self.perf.decode_round_s

    def _finish_decode(self, sid: str) -> None:
        ses = self.sessions[sid]
        w = ses.engine
        eng = self.engines[w]
        self.inflight.pop(sid, None)
        self._tr_end(sid, "phase")
        prompt, n_out, tool, gap_s = ses.inst.rt_step(ses.step_idx)
        work = self._step_work_s(len(prompt), n_out)
        # a preemption park part-charged this step already; charge only
        # the tail so the step's total AFS progress is exact
        self.co.afs.note_progress(sid, max(0.0, work - ses.work_charged))
        ses.work_charged = 0.0
        # park boundary: resolve the taken edge / dynamic callback (the
        # callback sees the real decoded token ids).  Deterministic on
        # the virtual clock; memoized per step index.
        if ses.inst.resolve_next(ses.step_idx,
                                 outputs=ses.step_outputs) is None:
            self._finish_task(sid)
            return
        ctx_len = len(ses.ctx)
        entry_bytes = ctx_len * self.kv_bytes_per_token
        evicted = self.co.on_step_end(
            sid, w, float(ctx_len), entry_bytes, tool, self.ev.now,
            next_node=ses.inst.next_node_hint(ses.step_idx + 1))
        # event-driven WA-LRU reconciliation: only the victims the policy
        # actually picked lose their real blocks (the old server rescanned
        # every cached session per step)
        for evd in evicted:
            eng.evict_session(evd.session_id)
        if self.co.pools[w].contains(sid):
            if not self._park_real(sid, w):
                self.co.drop_entry(sid, w, count_eviction=False)
                eng.release_session(sid)
        else:
            eng.release_session(sid)
        ses.slot = -1
        self._resident[w] -= 1
        self._load_delta(w, -1)
        ses.state = "tool"
        self._tr_begin(sid, "gap", "tool_gap", parent_key="step",
                       tool=tool, parked=self.co.pools[w].contains(sid))
        job = self.co.prefetcher.inflight.get(sid)
        if job is not None and job.issued_at == self.ev.now:
            self.ev.schedule(job.ready_at, "prefetch", (sid, w))
        self.ev.schedule(self.ev.now + float(gap_s), "tool_done", (sid,))
        if self.disagg:
            # speculative PREFILL: the park boundary just resolved the
            # next step (``resolve_next`` above), so its prompt is known
            # — submit the prefill job now and overlap compute + handoff
            # with the tool gap (generalizes speculative prefetch)
            self._begin_prefill(sid, speculative=True)

    def _park_real(self, sid: str, w: int) -> bool:
        """Move the session's slot KV into the engine pool, evicting
        WA-LRU victims (policy + real blocks together) until it fits."""
        eng = self.engines[w]
        n = len(self.sessions[sid].ctx)
        while not eng.pool.can_fit(n):
            victim = self.co.pools[w].select_victim(self.ev.now)
            if victim is None or victim.session_id == sid:
                return False
            self.co.drop_entry(victim.session_id, w)
            eng.evict_session(victim.session_id)
        return eng.park_session(sid)

    def _preempt_now(self, sid: str, w: int) -> None:
        """Execute a pending AFS preemption at the round boundary: park
        the victim's slot KV into the pool mid-step (TTL entry via
        ``preempt_park`` — the AEG cursor does not advance) and requeue
        it AFS-ordered behind the starved session, which the round's
        trailing ``_drain_queue`` admits into the freed slot.  The
        victim resumes later with a delta-only prefill and finishes the
        interrupted step token-for-token identically."""
        ses = self.sessions[sid]
        eng = self.engines[w]
        self._active[w].discard(sid)
        self.inflight.pop(sid, None)
        self._tr_end(sid, "phase", status="preempted")
        self._tr_instant(f"engine/{w}", "preempt", sid=sid)
        # charge the executed part of the step now (prompt prefill +
        # decoded rounds); _finish_decode later charges only the tail
        prompt = ses.inst.rt_step(ses.step_idx)[0]
        decoded = len(ses.ctx) - ses.step_start_len
        done_work = self._step_work_s(len(prompt), decoded)
        self.co.afs.note_progress(
            sid, max(0.0, done_work - ses.work_charged))
        ses.work_charged = done_work
        ctx_len = len(ses.ctx)
        evicted = self.co.preempt_park(
            sid, w, float(ctx_len), ctx_len * self.kv_bytes_per_token,
            self.ev.now)
        for evd in evicted:
            eng.evict_session(evd.session_id)
        if self.co.pools[w].contains(sid):
            if not self._park_real(sid, w):
                self.co.drop_entry(sid, w, count_eviction=False)
                eng.release_session(sid)
        else:
            eng.release_session(sid)
        ses.slot = -1
        ses.mid_step = True
        self._resident[w] -= 1
        self._load_delta(w, -1)
        self.preempted += 1
        self._last_preempt[w] = self.ev.now
        # admit the starved queue head into the freed slot FIRST, then
        # requeue the victim behind it — queue priorities are stamped at
        # push time, so re-enqueueing the victim before the admission
        # could let a stale (pre-recompute) priority re-admit the victim
        # straight back into the slot it was just parked from
        starved = self._queue_pop(w)
        self._enqueue(sid, w)
        if starved is not None:
            self._admit(starved.session_id, w)

    def _finish_task(self, sid: str) -> None:
        ses = self.sessions[sid]
        w = ses.engine
        self.inflight.pop(sid, None)
        self.engines[w].release_session(sid)
        ses.slot = -1
        self._resident[w] -= 1
        self._load_delta(w, -1)
        sites = self.co.cached_sites(sid)
        self.co.task_finished(sid, self.ev.now)
        for site in sites:                   # replicas included
            self.engines[site].evict_session(sid)
        ses.state = "done"
        ses.finished_at = self.ev.now
        self.n_done += 1
        self._tr_end(sid, "step")
        self._tr_end(sid, "session")
        self._tr_open.pop(sid, None)
        self._drain_queue(w)

    def _on_tool_done(self, sid: str) -> None:
        ses = self.sessions[sid]
        if ses.state != "tool":
            return
        prompt, _, tool, gap_s = ses.inst.rt_step(ses.step_idx)
        self.co.on_tool_done(sid, tool, float(gap_s), float(len(prompt)),
                             self.ev.now)
        self._tr_end(sid, "gap")
        self._tr_end(sid, "step")
        ses.step_idx += 1
        self._begin_step(sid)

    # -- disaggregated prefill pool (serving/disagg.py) -----------------
    def _begin_prefill(self, sid: str, speculative: bool = False) -> None:
        """Submit one step's prefill to the prefill pool.  Speculative
        (park boundary): the next step's prompt is already resolved, so
        the job covers ctx + next prompt and the compute + handoff
        overlap the tool gap.  Non-speculative (gap over, nothing in
        flight): the session waits at the rendezvous while the pool
        computes.  The Eq. 7 route taken HERE is the step's decode
        placement; the hit/miss verdict is counted once, now.  Falls
        back to classic decode-pool dispatch when the prefill pool is
        down or the context cannot fit any staging pool."""
        ses = self.sessions[sid]
        if speculative:
            if sid in self._pf.jobs:
                return                        # already in flight
            nxt = ses.inst.rt_step(ses.step_idx + 1)[0]
            tokens = list(ses.ctx) + [int(t) for t in nxt]
        else:
            tokens = list(ses.ctx)
        pools = [e.pool for e in self.engines]
        fits = any(self._alive[p] and pools[p]._blocks_for(len(tokens))
                   <= pools[p].num_blocks for p in self._prefill_ids)
        if not fits:
            # whole prefill pool down (or context larger than every
            # staging pool): unified-style dispatch keeps sessions
            # moving instead of stalling on the rendezvous
            if not speculative:
                w = self.co.route(sid, self.loads(), self.ev.now)
                self._dispatch_to(sid, w)
            return
        d = self.co.route(sid, self.loads(), self.ev.now)
        self.co.afs.note_unblocked(sid)
        hit, pf_tokens, bg_tokens = self.co.on_step_start(
            sid, d, float(len(tokens)), self.ev.now)
        eng_d = self.engines[d]
        real_hit = hit and eng_d.has_cache(sid)
        if hit and not real_hit:
            self.co.drop_entry(sid, d, count_eviction=False)
        if not hit and eng_d.has_cache(sid):
            eng_d.evict_session(sid)
        if real_hit:
            start = int(eng_d.pool.lens[sid])
            virt = float(pf_tokens)
        else:
            start = 0
            ses.regen_tokens += len(tokens)
            virt = float(len(tokens)) - float(bg_tokens)
        job = HandoffJob(session_id=sid, attempt=next(self._attempt),
                         d_engine=d, start=start, tokens=tokens,
                         pf_tokens=max(0.0, virt),
                         speculative=speculative,
                         waiting=not speculative)
        self._pf.submit(job)
        if not speculative:
            ses.state = "queued"
            ses.engine = -1
            ses.slot = -1
            if self.tracer is not None \
                    and "queue" not in self._tr_open.get(sid, {}):
                self._tr_begin(sid, "queue", "queue_wait",
                               parent_key="step", engine=-1)
        self._pf_place(job)

    def _pf_place(self, job: HandoffJob) -> None:
        got = self._pf.place(job, self.ev.now,
                             [e.pool for e in self.engines], self._alive)
        if got is None:
            self._pf.defer(job)       # retried as staged blocks release
            return
        self._pf_launch(job, got[0], got[1])

    def _pf_launch(self, job: HandoffJob, p: int, t0: float) -> None:
        """Open the (virtual) prefill compute window on engine ``p``;
        the REAL forward pass runs when ``pf_done`` is processed, so a
        fault before then loses no staged blocks."""
        ses = self.sessions[job.session_id]
        pf_s = job.pf_tokens * self._speed_factor(p) \
            / self.perf.prefill_tokens_per_s
        self._pf.note_busy_until(p, t0 + pf_s)
        self.co.afs.note_service(ses.inst.tenant, pf_s)
        self.ev.schedule(t0 + pf_s, "pf_done",
                         (job.session_id, job.attempt))

    def _pf_drain(self) -> None:
        """Re-try deferred prefill jobs (staged blocks released, or a
        prefill engine recovered) — FIFO, deterministic."""
        for job, p, t0 in self._pf.drain(self.ev.now,
                                         [e.pool for e in self.engines],
                                         self._alive):
            self._pf_launch(job, p, t0)

    def _on_pf_done(self, sid: str, attempt: int = -1) -> None:
        """The prefill compute window elapsed: run the REAL delta
        prefill on the prefill engine, stage the blocks in its pool, and
        open the deterministic transfer window to the decode engine."""
        job = self._pf.jobs.get(sid)
        if job is None or job.attempt != attempt:
            return       # stale: cancelled by a fault in the meantime
        p = job.p_engine
        if not self.engines[p].stage_prefill(
                sid, np.asarray(job.tokens, np.int32), job.start):
            raise RuntimeError(
                f"staging pool reservation drifted on engine {p}")
        self._pf.staged(job, [e.pool for e in self.engines])
        tr_s = job.n_stage * self.kv_bytes_per_token \
            / self.perf.handoff_bytes_per_s + self.perf.handoff_latency_s
        self._tr_begin(sid, "handoff", "handoff", parent_key="session",
                       src=p, dst=job.d_engine, tokens=job.n_stage)
        self.ev.schedule(self.ev.now + tr_s, "handoff_done",
                         (sid, attempt))

    def _handoff_abort(self, job: HandoffJob, status: str) -> None:
        """Reclaim both sides of a dead handoff attempt: staged blocks
        on a live prefill engine free through its pool (a dead one's
        were already wiped by ``Engine.fail``), an unstaged job returns
        its block reservation, and the registry forgets the attempt so
        its pending pf_done/handoff_done events go stale."""
        sid = job.session_id
        if job.state == "staged" and 0 <= job.p_engine < self.n_workers \
                and self._alive[job.p_engine] \
                and self.engines[job.p_engine].has_cache(sid):
            self.engines[job.p_engine].evict_session(sid)
        self._pf.unreserve(job, [e.pool for e in self.engines])
        self._pf.pop(sid)
        self.handoffs_cancelled += 1
        self._tr_end(sid, "handoff", status=status)

    def _on_handoff_done(self, sid: str, attempt: int = -1) -> None:
        """The transfer window elapsed: move the staged blocks into the
        decode engine's pool (evicting WA-LRU victims to make room) and
        arm the rendezvous — or unwind the attempt if the decode side
        changed underneath it."""
        job = self._pf.jobs.get(sid)
        if job is None or job.attempt != attempt:
            return       # stale: cancelled by a fault in the meantime
        ses = self.sessions[sid]
        p = job.p_engine
        d = job.d_engine
        if not self._alive[d]:
            if job.start == 0 and self._decode_alive():
                # full-context KV is placement-free: land it on a live
                # decode engine instead (Eq. 7 re-route)
                d = job.d_engine = self.co.route(sid, self.loads(),
                                                 self.ev.now)
            else:
                # the delta's prefix died with its decode engine (or no
                # decode engine survives): reclaim both sides; a waiting
                # session re-prefills on a live engine via _redispatch
                self._handoff_abort(job, "cancelled")
                self._pf_drain()
                if job.waiting:
                    self._redispatch(sid)
                return
        eng_d = self.engines[d]
        append = job.start > 0
        if append and int(eng_d.pool.lens.get(sid, -1)) != job.start:
            # the parked prefix this delta extends was evicted mid-
            # flight: the staged KV no longer lines up — re-prefill
            self._handoff_abort(job, "cancelled")
            self._pf_drain()
            if job.waiting:
                self._redispatch(sid)
            return
        k, v, n = self.engines[p].export_kv(sid)
        while not eng_d.import_handoff(sid, k, v, n, append=append):
            victim = self.co.pools[d].select_victim(self.ev.now)
            if victim is None or victim.session_id == sid:
                # no evictable room at the decode engine: drop the
                # attempt, the session regenerates there (§3.1)
                self._handoff_abort(job, "lost")
                ses.handoff_lost = True
                self._pf_drain()
                if job.waiting:
                    self._dispatch_to(sid, d)
                return
            self.co.drop_entry(victim.session_id, d)
            eng_d.evict_session(victim.session_id)
        self.engines[p].evict_session(sid)    # release the source side
        if not append:
            # miss-path landing: create the decode-side TTL entry (hit
            # landings extend the existing pinned entry's blocks)
            inserted, evicted = self.co.handoff_land(
                sid, d, float(len(job.tokens)),
                len(job.tokens) * self.kv_bytes_per_token, self.ev.now)
            for evd in evicted:
                eng_d.evict_session(evd.session_id)
            if not inserted:
                # only pinned victims at d: the landed blocks must not
                # outlive their metadata (the migration-landing rule)
                eng_d.evict_session(sid)
                self._handoff_abort(job, "lost")
                ses.handoff_lost = True
                self._pf_drain()
                if job.waiting:
                    self._dispatch_to(sid, d)
                return
        hbytes = n * self.kv_bytes_per_token
        self.handoffs += 1
        self.kv_handoff_bytes += hbytes
        if self.obs_metrics is not None:
            self.obs_metrics.counter("handoff_count").inc(1)
            self.obs_metrics.counter("kv_handoff_bytes").inc(hbytes)
        self._tr_end(sid, "handoff", tokens=n)
        self._pf.pop(sid)
        ses.handoff_ready = True
        ses.handoff_dst = d
        self._pf_drain()
        if job.waiting:
            self._dispatch_to(sid, d)

    def _pf_fail_engine(self, w: int) -> None:
        """A dead engine's side of the handoff lifecycle: every job
        computing on or staged on ``w`` is cancelled (``Engine.fail``
        already freed the blocks; the attempt-stamped registry makes the
        pending pf_done/handoff_done events stale) and waiting sessions
        re-prefill on a live engine.  Jobs whose DECODE side is ``w``
        are resolved lazily at handoff_done (re-route or cancel)."""
        waiting: List[str] = []
        for job in self._pf.jobs_touching(w):
            if job.p_engine != w:
                continue
            self._handoff_abort(job, "cancelled")
            if job.waiting:
                waiting.append(job.session_id)
        for sid in sorted(waiting):
            self._redispatch(sid)
        self._pf_drain()

    def _handoff_staged(self, w: int) -> set:
        """Sessions whose in-transit handoff blocks live on engine ``w``
        (staged in the prefill pool — deliberately carrying no
        coordinator pool metadata): the sanitizer / mirror-check
        exemption set."""
        return self._pf.staged_on(w) if self.disagg else set()

    # -- epoch tick: AFS shares + work stealing + preemption ------------
    def _on_epoch(self) -> None:
        if self.obs_metrics is not None:
            if self._obs_tick % 10 == 0:
                self._obs_sample()
            self._obs_tick += 1
        decision, shares = self.co.epoch_tick(
            self.ev.now, self.loads(), self._queue_views,
            alive=self._alive, victim_candidates=self._nonempty,
            scan_queues=False)
        if decision is not None and self.co.stealer.accept(
                decision, len(self.queues[decision.victim]), self.ev.now,
                thief_alive=self._alive[decision.thief]):
            ses = self._queue_remove(decision.victim, decision.session_id)
            if ses is not None:
                ses.state = "migrating"
                self._tr_end(ses.session_id, "queue", status="stolen")
                self._tr_begin(ses.session_id, "migr", "migration",
                               parent_key="step", src=decision.victim,
                               dst=decision.thief)
                self.migrating[ses.session_id] = (decision.victim,
                                                  decision.thief)
                self.migrations += 1
                mig = self.perf.sample_migration_s(self.rng)
                self.ev.schedule(self.ev.now + mig, "migr_done",
                                 (ses.session_id, decision.victim,
                                  decision.thief))
        if self.co.cfg.enable_preemption:
            self._preempt_scan()
        if shares:
            self._note_afs_deviation()
        if self.n_done < len(self.sessions):
            if any(self._alive) or self.ev:
                self.ev.schedule(self.ev.now + self.perf.epoch_s, "epoch")
            else:
                # whole cluster dead and nothing scheduled could revive
                # it: stop ticking so run() returns and conservation
                # reports the stranded sessions (simulator semantics)
                self._epoch_live = False
        else:
            self._epoch_live = False

    def _fair_targets(self) -> Optional[List[Tuple[str, float, float]]]:
        """(tenant, service_s, fair_target_s) rows under the Thm. 2
        convention: each tenant's fair target is its share of TOTAL
        submitted workload (mu_i ∝ W_i, constant — ``lyapunov_v``'s
        weights) scaled by the service actually delivered so far, so
        targets track realized throughput and converge to W_i exactly
        when everything completes."""
        w_tot = sum(self._tenant_workload.values())
        if w_tot <= 0.0:
            return None
        tens = self.co.afs.tenants
        tot = sum(t.service_s for t in tens.values())
        if tot <= 0.0:
            return None
        return [(name, tens[name].service_s if name in tens else 0.0,
                 w / w_tot * tot)
                for name, w in sorted(self._tenant_workload.items())]

    def _preempt_scan(self) -> None:
        """§6.2 step 4 on the serving path: for every engine whose slots
        are full while sessions queue, preempt the lowest-priority
        running decode iff (a) the queue head's fair-share deficit
        exceeds the configured threshold, (b) it has been blocked longer
        than ``preempt_block_s``, and (c) the blocked tenant is actually
        UNDER-served and the victim OVER-served against their
        workload-proportional fair targets — (c) is the Thm. 2
        restoring-force condition and the anti-flap hysteresis: once
        service ratios cross their fair rates, preemption stops instead
        of starving the former hog in turn.  A per-engine cooldown of
        ``preempt_block_s`` adds rate-limiting.  The decision is made
        here; the park happens at the engine's next round boundary."""
        cfg = self.co.cfg
        now = self.ev.now
        targets = self._fair_targets()
        lag = {name: tgt - srv
               for name, srv, tgt in (targets or ())}
        for w in sorted(self._nonempty):
            if not self._alive[w] or w in self._preempt_pending:
                continue
            if self._resident[w] < self.n_slots or not self._active[w]:
                continue
            if now - self._last_preempt[w] < cfg.preempt_block_s:
                continue
            head = self.queues[w].peek()
            if head is None:
                continue
            blocked = head.session_id
            b_ten = self.sessions[blocked].inst.tenant
            victim = min(self._active[w], key=lambda s: (
                self.co.afs.priority(self.sessions[s].inst.tenant), s))
            v_ten = self.sessions[victim].inst.tenant
            if self.co.afs.deficit(b_ten, v_ten) <= cfg.preempt_deficit:
                continue
            if targets is not None and not (lag.get(b_ten, 0.0) > 0.0
                                            and lag.get(v_ten, 0.0) < 0.0):
                continue
            if not self.co.afs.should_preempt(blocked, victim, now):
                continue
            self._preempt_pending[w] = victim

    def _note_afs_deviation(self) -> None:
        """Track the max fair-share deviation max_i |S_i - mu_i| under
        the workload-proportional Thm. 2 targets.  Preemption should
        keep this strictly tighter than admission-only ordering — the
        serve-bench preemption gate asserts exactly that."""
        targets = self._fair_targets()
        if targets is None or len(targets) < 2:
            return
        dev = max(abs(srv - tgt) for _, srv, tgt in targets)
        if dev > self.afs_dev_max:
            self.afs_dev_max = dev

    def _obs_sample(self) -> None:
        """Decimated epoch-tick metric sampling (traced runs only):
        per-engine queue depth, batch occupancy, KV pool occupancy
        split parked/resident/free, cumulative regeneration bytes, and
        the Thm. 2 fair-share deviation/lag.  Read-only off structures
        the scheduler already maintains; per-engine gauge handles are
        cached (grown lazily on scale-up) so the hot loop skips the
        registry's label-key construction."""
        m = self.obs_metrics
        now = self.ev.now
        while len(self._obs_engine_g) < len(self.engines):
            w = len(self._obs_engine_g)
            self._obs_engine_g.append((
                m.gauge("queue_depth", engine=w),
                m.gauge("batch_occupancy", engine=w),
                m.gauge("kv_blocks", engine=w, state="parked"),
                m.gauge("kv_blocks", engine=w, state="resident"),
                m.gauge("kv_blocks", engine=w, state="free"),
                m.gauge("regen_bytes", engine=w)))
        for w, eng in enumerate(self.engines):
            gq, gb, gp, gr_, gf, gg = self._obs_engine_g[w]
            gq.set(now, len(self.queues[w]))
            gb.set(now, len(self._active[w]))
            parked = eng.pool.used_blocks()
            gp.set(now, parked)
            gr_.set(now, eng.pool.physical_used_blocks() - parked)
            gf.set(now, len(eng.pool.free))
            gg.set(now, eng.regen_tokens * self.kv_bytes_per_token)
        targets = self._fair_targets()
        if targets is not None:
            m.gauge("afs_deviation_max").set(
                now, max(abs(srv - tgt) for _, srv, tgt in targets))
            for name, srv, tgt in targets:
                m.gauge("afs_lag_s", tenant=name).set(now, tgt - srv)

    def _copy_kv(self, sid: str, src: int, dst: int) -> bool:
        """Real pool-to-pool block copy (export, make room, import)."""
        kv = self.engines[src].export_kv(sid)
        if kv is None:
            return False
        k, v, n = kv
        dst_eng = self.engines[dst]
        while not dst_eng.pool.can_fit(n):
            victim = self.co.pools[dst].select_victim(self.ev.now)
            if victim is None or victim.session_id == sid:
                return False
            self.co.drop_entry(victim.session_id, dst)
            dst_eng.evict_session(victim.session_id)
        return dst_eng.import_kv(sid, k, v, n)

    def _on_migr_done(self, sid: str, src: int, dst: int) -> None:
        """A stolen session's KV transfer window elapsed: move the real
        blocks and the cache entry (TTL state travels with it, §3.1),
        then admit on the thief."""
        if self.migrating.pop(sid, None) is None:
            return
        ses = self.sessions[sid]
        if ses.state != "migrating":
            self._tr_end(sid, "migr", status="stale")
            return
        if not self._alive[dst]:
            # thief died while the KV was in transit: drop the copy and
            # re-route to a live engine (the home entry, if the source
            # survives, is still intact for a later resume)
            self._tr_end(sid, "migr", status="dropped")
            self._redispatch(sid)
            return
        if self.engines[src].has_cache(sid):
            if self._copy_kv(sid, src, dst):
                self.engines[src].evict_session(sid)
                _, evicted = self.co.migrate_session(sid, src, dst,
                                                     self.ev.now)
                for evd in evicted:
                    self.engines[dst].evict_session(evd.session_id)
                if not self.co.pools[dst].contains(sid):
                    # metadata didn't land (only pinned victims at the
                    # thief): the imported blocks must not outlive it
                    self.engines[dst].evict_session(sid)
            # else: no room at the thief — the entry (and its blocks)
            # stay home; this step runs on the thief and regenerates
            # (§3.1), later steps may still resume the intact home copy
        else:
            self.co.router.set_home(sid, dst)
        self._tr_end(sid, "migr")
        self._dispatch_to(sid, dst)

    def _on_prefetch(self, sid: str, src: int) -> None:
        """Speculative prefetch landing (§4.3): the bandwidth-delayed
        copy window elapsed mid-tool-gap.  If the home engine looks too
        loaded to take the resume (Eq. 7 would divert), replicate the
        parked KV to the likely overflow target so the diverted resume
        still hits cache."""
        ses = self.sessions.get(sid)
        if ses is None or ses.state != "tool":
            return
        if sid not in self.co.prefetcher.inflight:
            return                            # superseded or resolved
        if not self._alive[src]:
            return                            # source died mid-gap
        loads = self.loads()
        if float(loads[src]) < self.co.cfg.theta:
            return                            # home will take the resume
        masked = loads.astype(float).copy()
        masked[src] = INF
        for i, alive in enumerate(self._alive):
            if not alive:                     # a dead engine's zero load
                masked[i] = INF               # must not attract replicas
        if self.disagg and self._prefill_ids:
            # decode-pool KV must never replicate into a prefill
            # engine's staging pool — and prefill engines idle at load 0
            # would otherwise win every argmin below
            had_live = math.isfinite(float(masked.min()))
            for i in self._prefill_ids:
                masked[i] = INF
            if not math.isfinite(float(masked.min())):
                if had_live:
                    # the only overflow candidates were prefill engines:
                    # the prediction is unusable — count it as waste
                    self.co.prefetcher.cancel(sid)
                    self.prefetch_role_rejected += 1
                return
        if not math.isfinite(float(masked.min())):
            return
        dst = int(masked.argmin())
        if dst == src or not self.engines[src].has_cache(sid):
            return
        inserted, evicted = self.co.replicate_entry(sid, src, dst,
                                                    self.ev.now)
        for evd in evicted:
            self.engines[dst].evict_session(evd.session_id)
        if not inserted:
            return
        if self._copy_kv(sid, src, dst):
            self.prefetch_copies += 1
            self.prefetch_copy_bytes += \
                len(ses.ctx) * self.kv_bytes_per_token
            self._tr_instant(f"engine/{src}", "prefetch", sid=sid,
                             dst=dst)
        else:
            self.co.drop_entry(sid, dst, count_eviction=False)

    # -- faults / elasticity (cluster.faults plans, runtime twin) -------
    def _on_fault(self, kind: str, w: int) -> None:
        """One ``cluster.faults`` plan event on the virtual clock.  The
        same plans drive both substrates: (t, "fail"|"recover"|
        "scale_up"|"slow"|"heal", worker)."""
        self._tr_instant("run", "fault", kind=kind, engine=w)
        if kind == "fail":
            self._fail_engine(w)
        elif kind == "recover":
            self._recover_engine(w)
        elif kind == "scale_up":
            self._scale_up()
        elif kind == "slow":
            self._slow[w] = self.straggler_slowdown
        elif kind == "heal":
            self._slow.pop(w, None)
        else:
            raise ValueError(f"unknown fault event {kind!r}")

    def _fail_engine(self, w: int) -> None:
        """Engine dies mid-decode: cancel its in-flight attempts via the
        attempt-stamped registry (stale prefill_done/round events no
        longer match), reclaim slots, release pool blocks, requeue its
        pending queue on live engines, and wipe policy state
        (coordinator pool metadata, affinities, idle-set membership).
        Cancelled sessions retry from their last parked prefix —
        regenerating if the prefix died with this engine (§3.1)."""
        if w >= self.n_workers or not self._alive[w]:
            return                           # already down
        self._alive[w] = False
        self.faults_injected += 1
        self._gen[w] += 1                    # invalidate pending rounds
        self._round_live[w] = False
        self._preempt_pending.pop(w, None)
        self.co.worker_failed(w)
        # real replication copies sourced from the dead pool die with it
        self.co.prefetcher.cancel_worker(w)
        self.engines[w].fail()
        if self.disagg:
            # handoff jobs computing/staged on the dead engine cancel,
            # reclaim both sides, and re-prefill on a live engine
            self._pf_fail_engine(w)
        tickets = self.queues[w].drain()
        if tickets:
            self._load_delta(w, -len(tickets))
            self._queue_went_empty(w)
        victims = sorted(sid for sid, (ew, _) in self.inflight.items()
                         if ew == w)
        for sid in victims:
            self._cancel_attempt(sid, w)
        if self._resident[w] != 0:
            raise RuntimeError(
                f"engine {w} lifecycle leak at failure: "
                f"resident={self._resident[w]}")
        for t in tickets:
            self._redispatch(t.session_id)

    def _cancel_attempt(self, sid: str, w: int) -> None:
        """Cancel one in-flight step attempt on a dead engine: roll the
        context back to the step start (the decoded tail's KV died with
        the slots), refund any partially-charged AFS progress so the
        full retry is owed again, and re-dispatch."""
        ses = self.sessions[sid]
        del self.inflight[sid]
        self.cancelled_attempts += 1
        self._active[w].discard(sid)
        self._tr_end(sid, "phase", status="cancelled")
        self._tr_instant(f"engine/{w}", "cancel", sid=sid)
        # decode rounds that executed before the crash were real service
        # and stay charged (per-round note_service already saw them —
        # sim semantics: work lost to a crash was still work), but any
        # partially-charged Eq. 9 progress is refunded: the retry runs
        # the whole step again
        if ses.work_charged > 0.0:
            self.co.afs.refund_work(sid, ses.work_charged)
            ses.work_charged = 0.0
        del ses.ctx[ses.step_start_len:]
        if len(ses.step_outputs) > ses.step_idx:
            ses.step_outputs.pop()
        ses.mid_step = False
        ses.slot = -1
        self._resident[w] -= 1
        self._load_delta(w, -1)
        self._redispatch(sid)

    def _recover_engine(self, w: int) -> None:
        if w >= self.n_workers or self._alive[w]:
            return                           # already up (storm overlap)
        self._alive[w] = True
        self.co.worker_recovered(w, self.ev.now)
        if self.disagg:
            self._pf_drain()     # deferred jobs may fit the pool again
        self._readmit_orphans()

    def _scale_up(self) -> None:
        """Elastic scale-out: a fresh engine joins, sharing the zoo
        model's jitted functions (module ``_JIT_CACHE``) so joining
        costs no recompilation."""
        ref = self.engines[0]
        eng = Engine(self.cfg, self.params, n_slots=ref.n_slots,
                     max_len=ref.max_len,
                     pool_blocks=ref.pool.num_blocks,
                     block_size=ref.pool.block, env=ref.env,
                     paged=ref.paged)
        self.engines.append(eng)
        # elastic capacity always joins the DECODE side: prefill-pool
        # sizing is a deployment-time choice (roles at construction)
        self.roles.append(ROLE_DECODE if self.disagg else ROLE_UNIFIED)
        w = self.co.add_worker(self.ev.now)
        self.queues.append(SessionQueue())
        self._queue_views.append(
            _RuntimeQueueView(lambda w=w: self.queues[w]))
        self._active.append(set())
        self._resident.append(0)
        self._round_live.append(False)
        self._gen.append(0)
        self._loadnum = np.append(self._loadnum, 0)
        self._alive.append(True)
        self._last_preempt.append(-INF)
        self.n_workers += 1
        self._readmit_orphans()

    # -- reporting ------------------------------------------------------
    def stats(self) -> dict:
        return {
            "prefill_tokens": sum(e.prefill_tokens for e in self.engines),
            "regen_tokens": sum(e.regen_tokens for e in self.engines),
            "decode_steps": sum(e.decode_steps for e in self.engines),
            "coordinator_hits": self.co.cache_hits,
            "coordinator_misses": self.co.cache_misses,
            # device bytes moved by park/resume/migration; paged mode's
            # park/resume are metadata-only so the first two stay 0.
            # (stats-only: summarize() stays byte-pinned either way)
            "park_copy_bytes": sum(e.park_copy_bytes
                                   for e in self.engines),
            "resume_copy_bytes": sum(e.resume_copy_bytes
                                     for e in self.engines),
            "migration_copy_bytes": sum(e.migration_copy_bytes
                                        for e in self.engines),
            # lifecycle counters (steal/migration, prefetch, faults,
            # preemption) so server.stats() surfaces them per worker —
            # additive keys only: every consumer reads by name
            "steals": int(self.co.stealer.steals),
            "migrations": int(self.migrations),
            "prefetch_copies": int(self.prefetch_copies),
            "faults_injected": int(self.faults_injected),
            "cancelled_attempts": int(self.cancelled_attempts),
            "preemptions": int(self.preempted),
            "afs_dev_max": float(self.afs_dev_max),
            # disaggregated prefill/decode handoff (0s in unified mode)
            "kv_handoff_bytes": int(sum(e.handoff_copy_bytes
                                        for e in self.engines)),
            "handoff_count": int(self.handoffs),
            "handoffs_cancelled": int(self.handoffs_cancelled),
            "prefetch_role_rejected": int(self.prefetch_role_rejected),
        }

    def summarize(self) -> dict:
        """Deterministic run summary (the cross-process byte-identity
        contract covers this dict's ``repr``)."""
        done = [s for s in self.sessions.values() if s.finished_at >= 0]
        tcts = sorted(s.tct for s in done)
        n = len(tcts)
        st = self.stats()
        out = {
            "n_sessions": len(self.sessions),
            "n_done": n,
            "tct_mean": float(sum(tcts) / n) if n else 0.0,
            "tct_p50": float(tcts[n // 2]) if n else 0.0,
            "tct_p99": float(tcts[min(n - 1, int(0.99 * n))]) if n else 0.0,
            "makespan": float(max((s.finished_at for s in done),
                                  default=0.0)),
            "prefill_tokens": int(st["prefill_tokens"]),
            "regen_tokens": int(st["regen_tokens"]),
            "decode_rounds": int(st["decode_steps"]),
            "decoded_tokens": int(sum(len(o) for s in self.sessions.values()
                                      for o in s.step_outputs)),
            "cache_hits": int(self.co.cache_hits),
            "cache_misses": int(self.co.cache_misses),
            "steals": int(self.co.stealer.steals),
            "migrations": int(self.migrations),
            "prefetch_issued": int(self.co.prefetcher.issued),
            "prefetch_correct": int(self.co.prefetcher.correct),
            "prefetch_copies": int(self.prefetch_copies),
            "prefetch_wasted_bytes": float(self.co.prefetcher.wasted_bytes),
        }
        if self.fault_plan or self.co.cfg.enable_preemption:
            # fault/preemption keys only when those modes are active, so
            # every pre-existing golden byte-pin of the default summary
            # stays valid
            out["faults_injected"] = int(self.faults_injected)
            out["cancelled_attempts"] = int(self.cancelled_attempts)
            out["preemptions"] = int(self.preempted)
            out["afs_dev_max"] = float(self.afs_dev_max)
        if self.disagg:
            # disagg keys only in disagg mode (same rule as above): the
            # unified summary's byte-pins stay valid
            out["handoffs"] = int(self.handoffs)
            out["handoff_bytes"] = float(self.kv_handoff_bytes)
            out["handoffs_cancelled"] = int(self.handoffs_cancelled)
            out["prefill_jobs"] = int(self._pf.submitted)
            out["speculative_prefills"] = int(self._pf.speculative)
            out["prefill_deferred"] = int(self._pf.deferred)
            out["prefetch_role_rejected"] = \
                int(self.prefetch_role_rejected)
        return out

    # -- invariants -----------------------------------------------------
    def check_conservation(self) -> None:
        """Post-run lifecycle invariants: every submitted session
        finished, no session stuck queued/migrating, every engine's
        slots and pool blocks returned to free, the incremental load /
        nonempty indices agree with ground truth, and the coordinator's
        pool metadata mirrors the real block tables.  Raises listing
        every violation."""
        bad: List[str] = []
        unfinished = sorted(s for s, st in self.sessions.items()
                            if st.finished_at < 0)
        if unfinished:
            bad.append(f"sessions never finished: {unfinished[:5]}")
        if self.n_done != len(self.sessions):
            bad.append(f"n_done={self.n_done} != {len(self.sessions)}")
        if self.migrating:
            bad.append(f"migrations in limbo: {sorted(self.migrating)[:5]}")
        if self.inflight:
            bad.append(f"attempts still in flight: "
                       f"{sorted(self.inflight)[:5]}")
        if self._orphans:
            bad.append(f"orphaned sessions never re-admitted: "
                       f"{sorted(self._orphans)[:5]}")
        if self._preempt_pending:
            bad.append(f"preemptions never executed: "
                       f"{sorted(self._preempt_pending.items())[:5]}")
        for w, eng in enumerate(self.engines):
            if self.queues[w]:
                bad.append(f"engine {w} queue not drained")
            if self._active[w]:
                bad.append(f"engine {w} decode set not empty")
            if eng.used_slots() != 0:
                bad.append(f"engine {w} leaked {eng.used_slots()} slots")
            if self._resident[w] != 0:
                bad.append(f"engine {w} resident count "
                           f"{self._resident[w]} != 0")
            if self._loadnum[w] != 0:
                bad.append(f"engine {w} load index drifted: "
                           f"{self._loadnum[w]}")
            if (w in self._nonempty):
                bad.append(f"engine {w} nonempty index stale")
            if eng.pool.tables:
                bad.append(f"engine {w} leaked blocks for "
                           f"{sorted(eng.pool.tables)[:5]}")
            if len(set(eng.pool.free)) != eng.pool.total_blocks:
                bad.append(f"engine {w} free list corrupt")
            if self.co.pools[w].entries:
                bad.append(f"engine {w} pool metadata not empty")
        if abs(self.co.pools_used) > 1e-6:
            bad.append(f"pools_used={self.co.pools_used}")
        if self.disagg:
            if self._pf.jobs:
                bad.append(f"handoff jobs in limbo: "
                           f"{sorted(self._pf.jobs)[:5]}")
            if self._pf.pending:
                bad.append(f"prefill jobs never placed: "
                           f"{self._pf.pending[:5]}")
            resv = {p: r for p, r in sorted(self._pf.reserved.items())
                    if r}
            if resv:
                bad.append(f"staging reservations leaked: {resv}")
            stuck = sorted(s for s, st in self.sessions.items()
                           if st.handoff_ready or st.handoff_lost)
            if stuck:
                bad.append(f"handoff flags never consumed: {stuck[:5]}")
        if bad:
            raise RuntimeError("runtime conservation violated: "
                               + "; ".join(bad))

    def verify_pool_mirrors(self) -> None:
        """Mid-run cross-check: every engine's real parked sessions must
        be a subset of the coordinator's pool entries (a metadata entry
        may transiently outlive its blocks during a resume, never the
        reverse).  Resident sessions are exempt: a cache-miss admit
        holds blocks from admit to finish with no coordinator entry
        until its first park.  In-transit handoff blocks staged on a
        prefill engine are likewise exempt — the cross-pool transfer
        deliberately carries no coordinator metadata until it lands."""
        for w, eng in enumerate(self.engines):
            extra = (set(eng.pool.tables) - set(self.co.pools[w].entries)
                     - eng.pool.resident - self._handoff_staged(w))
            if extra:
                raise RuntimeError(
                    f"engine {w} holds blocks with no pool entry: "
                    f"{sorted(extra)[:5]}")
