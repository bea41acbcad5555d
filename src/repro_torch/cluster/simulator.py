"""Discrete-event simulator of the 64-GPU (16-worker) serving cluster.

Reproduces the paper's evaluation harness: agent tasks move through
  arrival -> [route -> queue -> LLM step -> tool call]* -> done
with per-worker continuous-batching slots, a WA-LRU/LRU/prefix KV pool,
tool-aware TTLs, session-affinity routing, work stealing (with Llumnix
migration costs), AFS fairness, optional fault injection and elastic
scaling.  The GlobalCoordinator (repro_torch.core) makes every policy
decision; the simulator only advances time.

Submission is the unified ``repro_torch.workflow.AgentProgram`` API: legacy
``Task`` lists compile to scripted programs (byte-identical execution),
while explicit-graph and dynamic programs resolve their branches at
park boundaries (``WorkflowInstance.resolve_next`` inside
``_on_llm_done``) — retry loops and conditionals execute, the taken
edge is threaded into the coordinator (``on_step_end(next_node=...)``),
and a declared AEG reaches admission (``register_task(aeg=...)``) so
reuse probability, prefetch targeting and Eq. 9 work estimates see the
true branch structure.

Routing modes (baseline matrix, §9.1 "Baselines"):
  session — Eq. 7 affinity (SAGA, SGLang-like cache-aware)
  least   — least-loaded per request (vLLM FCFS)
  group   — prefix-hash affinity (vLLM+APC PrefixCacheAffinityRouter)
  sticky  — always the home worker (KVFlow / TRT-LLM single-node)

Execution lifecycle & failure semantics
---------------------------------------
Every running LLM step is tracked in an explicit in-flight registry
(``ClusterSim.inflight``): task, step index, worker, start/finish time,
KV bytes held, and a monotonically increasing *attempt* id.  Completion
events (``llm_done``) carry the attempt id and validate against the
registry, so an event for a step that was cancelled in the meantime is
recognised as stale and dropped instead of firing blindly.

When a worker fails (``fail`` event):
  * its queued steps are drained and re-enqueued on live workers;
  * its in-flight steps are *cancelled*: the un-executed tail of their
    charged compute is refunded (end-first: decode before prefill, so
    regeneration time/tokens are only un-charged if the prefill that
    held them never ran), their KV reservation is released, and the
    steps are re-enqueued from scratch.  The failed
    worker's KV pool is wiped (GlobalCoordinator.worker_failed), so the
    retried step misses cache and pays full regeneration — the §3.1
    cache-loss accounting.  Compute already executed on the aborted
    attempt stays charged (work lost to a crash was still real work).
  * in-flight migrations targeting the dead worker are re-routed to a
    live worker when their ``migr_done`` event arrives.

Work stealing, routing and migration all consult worker liveness
through the same flags (``WorkerState.alive`` here, mirrored into
``GlobalCoordinator.alive`` by the fail/recover/scale handlers), so a
dead worker can never be picked as a thief, a victim, a routing target
or a migration destination.  If *every* worker is dead, steps park in
an orphan buffer and re-enqueue on the next recover/scale-up.

Incremental epoch tick
----------------------
The 100 ms epoch tick (AFS shares + steal decision) is O(changes), not
O(cluster size).  Every structure it consumes is maintained at the
event sites that mutate it:

  * ``_loadnum`` — integer active+queued count per worker, turned into
    the float load vector by one C-level numpy division (exact: same
    IEEE result as ``WorkerState.load``), dead workers masked to inf;
  * the stealer's ``idle_since`` dict — the indexed idle-worker set,
    entered/left on queue-depth transitions (empty<->nonempty), with
    exact transition times instead of epoch-quantized ones;
  * ``_nonempty`` — the victim-candidate index (workers with pending
    queue work), so the steal scan never walks all workers;
  * persistent ``_QueueView``/alive lists — zero per-epoch allocation;
  * AFS columns — persistent, delta-updated (see ``repro_torch.core.afs``).

``check_conservation`` cross-checks every mirror against ground truth,
so index drift fails loudly rather than skewing scheduling silently.

Straggler injection: a ``StragglerInjector`` (static) and/or
``("slow", w)`` / ``("heal", w)`` plan events (dynamic) scale worker
``w``'s service rates by ``straggler_slowdown``; work stealing is the
paper's own mitigation (§5.2).

Determinism: all randomness flows through one seeded ``random.Random``;
string hashing (``group`` routing) uses a stable FNV-1a hash, so two
identical-seed runs produce byte-identical ``summarize()`` output even
across processes with different ``PYTHONHASHSEED``.
"""
from __future__ import annotations

import heapq
import itertools
import os
import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

try:
    import numpy as np
except ImportError:          # pragma: no cover - numpy ships with repo
    np = None

from repro_torch.core.coordinator import GlobalCoordinator, SAGAConfig
from repro_torch.cluster.perf import PerfModel
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.tracer import ROOT, as_tracer
from repro_torch.workflow.program import WorkflowInstance, as_instance

INF = float("inf")

_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_FNV_MASK = 0xFFFFFFFFFFFFFFFF


def _fnv1a(s: str) -> int:
    """Stable 64-bit FNV-1a string hash.  Python's builtin ``hash`` is
    randomized per process (PYTHONHASHSEED), which made ``group``
    routing — and therefore every baseline number — irreproducible."""
    h = _FNV_OFFSET
    for b in s.encode("utf-8"):
        h ^= b
        h = (h * _FNV_PRIME) & _FNV_MASK
    return h


@dataclass
class SimPolicy:
    """Scheduler variant = SAGAConfig + routing/admission knobs."""
    name: str = "saga"
    saga: SAGAConfig = field(default_factory=SAGAConfig)
    routing: str = "session"          # session | least | group | sticky
    admission_max_tasks: Optional[int] = None   # DFS/BFS knob (Table 8)
    queue_discipline: str = "afs"     # afs | fcfs


@dataclass
class StepJob:
    task: WorkflowInstance
    step_idx: int
    enqueued_at: float
    worker: int = -1
    cancelled: bool = False           # lazy-deletion flag (StepQueue)


class StepQueue:
    """Per-worker pending-step priority queue.

    A lazy-deletion binary heap keyed by ``(priority, enqueued_at,
    seq)`` — O(log n) push/pop instead of the previous
    sort-per-enqueue O(n log n) list.  Stealing removes arbitrary
    sessions by tombstoning (``StepJob.cancelled``); dead entries are
    skipped on the next peek/pop.  ``seq`` is a global monotone counter
    so ties break deterministically (FIFO), never by object identity.
    """

    __slots__ = ("_heap", "_live")

    def __init__(self) -> None:
        self._heap: List[Tuple[float, float, int, StepJob]] = []
        self._live = 0

    def __len__(self) -> int:
        return self._live

    def __bool__(self) -> bool:
        return self._live > 0

    def push(self, prio: float, seq: int, job: StepJob) -> None:
        heapq.heappush(self._heap, (prio, job.enqueued_at, seq, job))
        self._live += 1

    def peek(self) -> Optional[StepJob]:
        h = self._heap
        while h and h[0][3].cancelled:
            heapq.heappop(h)
        return h[0][3] if h else None

    def pop(self) -> Optional[StepJob]:
        job = self.peek()
        if job is not None:
            heapq.heappop(self._heap)
            self._live -= 1
        return job

    def remove(self, session_id: str) -> Optional[StepJob]:
        """Tombstone and return the queued step of ``session_id`` (the
        steal path; O(n) scan, but steals are epoch-rate events)."""
        for _, _, _, job in self._heap:
            if not job.cancelled and job.task.task_id == session_id:
                job.cancelled = True
                self._live -= 1
                return job
        return None

    def drain(self) -> List[StepJob]:
        """Remove and return all live jobs (worker-failure requeue),
        oldest-first for deterministic re-enqueue order."""
        jobs = [j for _, _, _, j in self._heap if not j.cancelled]
        jobs.sort(key=lambda j: (j.enqueued_at, j.task.task_id,
                                 j.step_idx))
        self._heap.clear()
        self._live = 0
        return jobs

    def snapshot(self) -> List[Tuple[float, str]]:
        """(enqueued_at, session_id) pairs oldest-first, as the work
        stealer expects."""
        return sorted((j.enqueued_at, j.task.task_id)
                      for _, _, _, j in self._heap if not j.cancelled)


class _QueueView:
    """Lazy stealer-facing view of a worker's StepQueue.  Built once per
    worker at sim construction (the epoch tick reuses the same list
    every 100 ms — zero per-epoch allocation); emptiness checks are
    O(1) and the sorted (enqueued_at, session_id) dump is built only if
    the stealer actually iterates this worker's queue (i.e. it became
    the victim).  Wraps the WorkerState, not the queue object, so
    benchmark harnesses that swap ``ws.queue`` stay visible."""

    __slots__ = ("_ws",)

    def __init__(self, ws) -> None:
        self._ws = ws

    def __len__(self) -> int:
        return len(self._ws.queue)

    def __bool__(self) -> bool:
        return bool(self._ws.queue)

    def __iter__(self):
        return iter(self._ws.queue.snapshot())


@dataclass
class WorkerState:
    active: int = 0                    # busy batch slots
    queue: StepQueue = field(default_factory=StepQueue)
    busy_s: float = 0.0                # cumulative compute-busy seconds
    regen_s: float = 0.0               # of which: cache regeneration
    prefill_free_at: float = 0.0       # serial prefill pipeline head
    active_kv: float = 0.0             # bytes held by running requests
    alive: bool = True

    def load(self, max_batch: int) -> float:
        if not self.alive:
            return INF
        return (self.active + len(self.queue)) / max_batch


@dataclass
class InFlightStep:
    """Registry record for one running LLM step (one per task, max).

    ``attempt`` stamps the matching ``llm_done`` event; a mismatch at
    delivery time means the step was cancelled (worker fault) and the
    event is stale.  ``busy_charged`` / ``regen_s_charged`` /
    ``regen_tokens`` record what was charged to the worker and task at
    start, so cancellation can refund the un-executed tail of each."""
    job: StepJob
    attempt: int
    worker: int
    started: float
    finish: float
    kv_bytes: float
    busy_charged: float
    decode_s: float = 0.0        # tail of busy_charged (prefill runs first)
    regen_s_charged: float = 0.0
    regen_tokens: float = 0.0


@dataclass
class TaskMetrics:
    task_id: str
    tenant: str
    arrival: float
    finish: float = -1.0
    ideal_s: float = 0.0               # no-queue no-regen time incl tools
    regen_tokens: float = 0.0
    migrations: int = 0
    steps: int = 0

    @property
    def tct(self) -> float:
        return self.finish - self.arrival


class ClusterSim:
    def __init__(self, tasks: Sequence[object], policy: SimPolicy,
                 n_workers: int = 16, perf: Optional[PerfModel] = None,
                 seed: int = 0,
                 fault_plan: Optional[Sequence[Tuple[float, str, int]]] = None,
                 straggler: Optional[object] = None,
                 straggler_slowdown: float = 4.0,
                 trace=None):
        # one submission API (repro_torch.workflow): legacy Tasks compile to
        # scripted AgentPrograms (byte-identical execution), explicit
        # graph / dynamic programs resolve their branches as they run
        insts = [as_instance(t) for t in tasks]
        self.tasks: Dict[str, WorkflowInstance] = \
            {t.task_id: t for t in insts}
        self.policy = policy
        self.perf = perf or PerfModel()
        self.rng = random.Random(seed)
        self.n_workers = n_workers
        cap = self.perf.kv_pool_bytes
        self.co = GlobalCoordinator(policy.saga, n_workers, cap)
        self.workers = [WorkerState() for _ in range(n_workers)]
        self.metrics: Dict[str, TaskMetrics] = {}
        self.events: List[Tuple[float, int, str, tuple]] = []
        self._eid = itertools.count()
        self._seq = itertools.count()        # queue FIFO tie-break
        self._attempt = itertools.count()    # in-flight step attempt ids
        self.now = 0.0
        self.active_tasks = 0
        self.admission_queue: List[WorkflowInstance] = []
        self.mem_samples: List[Tuple[float, float]] = []   # (dt, util)
        self._last_mem_t = 0.0
        self._mem_min_dt = self.perf.epoch_s   # sampling granularity
        self.migrations = 0
        self.fault_plan = list(fault_plan or [])
        self.events_processed = 0
        # float-dust tolerance for KV-byte conservation checks (entries
        # are ~1e10 bytes; long runs accumulate rounding in the sums)
        self._kv_tol = 1e-6 * self.co.capacity
        # execution-lifecycle registries (see module docstring)
        self.inflight: Dict[str, InFlightStep] = {}
        self.migrating: Dict[str, int] = {}    # task_id -> dst worker
        self._orphans: List[StepJob] = []      # steps with no live worker
        # group routing: stable FNV-1a hash of the session prefix
        self._group_worker: Dict[str, int] = {}
        # incremental epoch-tick state (O(changes) instead of O(cluster)):
        #   _loadnum[w]   int active+queued steps, mirrored at every
        #                 slot/queue transition (ints: no float drift)
        #   _nonempty     indexed set of workers with pending queue work
        #                 (the stealer's victim candidates)
        #   _queue_views  persistent stealer-facing views (no per-epoch
        #                 list builds)
        #   _active_kv_total  running sum of in-flight KV reservations
        self._max_batch = self.perf.max_batch
        if np is not None:
            self._loadnum = np.zeros(n_workers, dtype=np.int64)
            self._alive_np = np.ones(n_workers, dtype=bool)
        self._alive_list = [True] * n_workers
        self._n_dead = 0
        self._nonempty: set = set()
        self._queue_views = [_QueueView(ws) for ws in self.workers]
        self._active_kv_total = 0.0
        # straggler injection: static injector (factor(w) >= 1 slows
        # worker w) composed with dynamic ("slow"/"heal") plan events
        self.straggler = straggler
        self.straggler_slowdown = straggler_slowdown
        self._slow: Dict[int, float] = {}
        # virtual-time span tracer + metrics registry (repro_torch.obs):
        # read-only — a traced run's summarize() is byte-identical to
        # the untraced run and the trace bytes are byte-identical
        # across PYTHONHASHSEED (docs/OBSERVABILITY.md).  ``trace``
        # accepts True (fresh tracer) or a Tracer instance; the
        # simulator's own TaskMetrics dict keeps the ``metrics`` name.
        if trace is None:
            # sagalint: ok(det-env) trace toggles recording only, never a scheduling decision — replay is unaffected
            trace = os.environ.get("SAGA_TRACE", "") not in ("", "0")
        self.tracer = as_tracer(trace)
        self.obs_metrics = MetricsRegistry() if self.tracer is not None \
            else None
        # per-task open-span ids keyed by role ("session" / "step" /
        # "queue" / "pf" / "dec" / "gap" / "migr"); plain string keys,
        # never id() — part of the determinism contract
        self._tr_open: Dict[str, Dict[str, int]] = {}
        # metric sampling is decimated to every 10th epoch tick (1 s of
        # virtual time) with per-worker gauge handles cached — sampling
        # the full worker set at the 100 ms tick rate dominated traced
        # wall time (table7's trace-overhead row measures this)
        self._obs_tick = 0
        self._obs_worker_g: list = []
        self._started = False
        # all queues start empty: seed the indexed idle set at t=0
        for w in range(n_workers):
            self.co.on_worker_idle(w, 0.0)

    # -- event plumbing ----------------------------------------------------
    def _push(self, t: float, kind: str, args: tuple = ()) -> None:
        heapq.heappush(self.events, (t, next(self._eid), kind, args))

    def run(self, horizon_s: float = INF) -> Dict[str, TaskMetrics]:
        """Advance the event loop up to ``horizon_s``.  Resumable: an
        event past the horizon stays queued, so a later ``run`` call
        with a larger horizon continues where this one stopped."""
        if not self._started:
            self._started = True
            for task in self.tasks.values():
                self._push(task.arrival_s, "arrival", (task.task_id,))
            self._push(self.perf.epoch_s, "epoch")
            for t, kind, w in self.fault_plan:
                self._push(t, kind, (w,))
        elif self._all_done():
            # completed sim: the final break leaves one epoch event
            # queued; processing it here would shift now/mem_samples and
            # make resumed runs diverge from one-shot runs
            return self.metrics
        while self.events:
            if self.events[0][0] > horizon_s:
                break
            t, _, kind, args = heapq.heappop(self.events)
            self._sample_mem(t)
            self.now = t
            self.events_processed += 1
            getattr(self, f"_on_{kind}")(*args)
            if kind != "epoch" and self._all_done():
                break
        return self.metrics

    def _all_done(self) -> bool:
        return all(m.finish >= 0 for m in self.metrics.values()) and \
            len(self.metrics) == len(self.tasks) and not self.admission_queue

    def _sample_mem(self, t: float) -> None:
        # Throttled to the epoch period, and O(1): the coordinator keeps
        # a running total of cached pool bytes (``pools_used``) and the
        # sim a running total of in-flight KV reservations, so sampling
        # no longer sums over every worker (which re-dominated the event
        # loop at 256 workers once the epoch tick went incremental).
        dt = t - self._last_mem_t
        if dt < self._mem_min_dt - 1e-9:   # tolerance: epoch times are
            return                         # accumulated floats
        util = (self.co.pools_used + self._active_kv_total) / \
            (self.co.capacity * self.n_workers)
        self.mem_samples.append((dt, util))
        self._last_mem_t = t

    # -- helpers -------------------------------------------------------------
    def _loads(self):
        """Per-worker load vector.  With numpy: one C-level division of
        the incrementally-maintained integer slot+queue counts (exact —
        bit-identical to ``WorkerState.load``); dead workers masked to
        inf.  Fallback: the legacy python list comprehension."""
        if np is None:
            return [w.load(self._max_batch) for w in self.workers]
        loads = self._loadnum / self._max_batch
        if self._n_dead:
            loads[~self._alive_np] = INF
        return loads

    def _load_delta(self, w: int, delta: int) -> None:
        if np is not None:
            self._loadnum[w] += delta

    def _least_loaded(self, loads) -> int:
        """Deterministic least-loaded pick: seeded-RNG tie-break among
        exact-minimum workers (spreads equal-load ties without the
        per-candidate RNG draws the old ``min(key=...)`` made)."""
        if np is not None and isinstance(loads, np.ndarray):
            ties = np.flatnonzero(loads == loads.min())
            if len(ties) == 1:
                return int(ties[0])
            return int(ties[self.rng.randrange(len(ties))])
        lo = min(loads)
        ties = [i for i, l in enumerate(loads) if l == lo]
        if len(ties) == 1:
            return ties[0]
        return ties[self.rng.randrange(len(ties))]

    def _speed_factor(self, w: int) -> float:
        """Straggler slowdown for worker ``w`` (1.0 = healthy).  Static
        injector factors compose with dynamic slow/heal plan events."""
        f = self._slow.get(w, 1.0)
        if self.straggler is not None:
            f *= self.straggler.factor(w)
        return f

    # -- tracing helpers (no-ops when tracing is off) ---------------------
    def _tr_begin(self, tid: str, key: str, name: str,
                  parent_key: Optional[str] = None,
                  t: Optional[float] = None, **meta) -> None:
        if self.tracer is None:
            return
        o = self._tr_open.setdefault(tid, {})
        parent = o.get(parent_key, ROOT) if parent_key else ROOT
        o[key] = self.tracer.begin(f"session/{tid}", name,
                                   self.now if t is None else t,
                                   parent=parent, **meta)

    def _tr_end(self, tid: str, key: str, status: str = "ok",
                t: Optional[float] = None, **meta) -> None:
        if self.tracer is None:
            return
        o = self._tr_open.get(tid)
        if o is None or key not in o:
            return
        self.tracer.end(o.pop(key), self.now if t is None else t,
                        status=status, **meta)

    def _tr_instant(self, track: str, name: str, **meta) -> None:
        if self.tracer is not None:
            self.tracer.instant(track, name, self.now, **meta)

    # -- queue transitions (the indexed idle/victim bookkeeping) ----------
    def _queue_pop(self, w: int) -> Optional[StepJob]:
        job = self.workers[w].queue.pop()
        if job is not None:
            self._load_delta(w, -1)
            if not self.workers[w].queue:
                self._queue_went_empty(w)
        return job

    def _queue_remove(self, w: int, session_id: str) -> Optional[StepJob]:
        job = self.workers[w].queue.remove(session_id)
        if job is not None:
            self._load_delta(w, -1)
            if not self.workers[w].queue:
                self._queue_went_empty(w)
        return job

    def _queue_drain(self, w: int) -> List[StepJob]:
        jobs = self.workers[w].queue.drain()
        if jobs:
            self._load_delta(w, -len(jobs))
        self._nonempty.discard(w)
        # no idle-set entry: draining only happens on worker failure,
        # and the coordinator evicts dead workers from the idle set
        return jobs

    def _queue_went_empty(self, w: int) -> None:
        self._nonempty.discard(w)
        if self.workers[w].alive:
            self.co.on_worker_idle(w, self.now)

    def _route(self, task: WorkflowInstance) -> int:
        mode = self.policy.routing
        sid = task.task_id
        loads = self._loads()
        if mode == "least":
            return self._least_loaded(loads)
        if mode == "group":
            # PrefixCacheAffinityRouter: load-blind consistent hash of the
            # request prefix.  An agent session's prompt keeps its own
            # prefix, so the hash is stable per session — but the router
            # cannot rebalance (hotspots) and overflows when the preferred
            # worker saturates.
            if sid not in self._group_worker:
                self._group_worker[sid] = (_fnv1a(sid) * 2654435761) \
                    % self.n_workers
            w = self._group_worker[sid]
            if loads[w] < self.policy.saga.theta and self.workers[w].alive:
                return w
            return self._least_loaded(loads)
        if mode == "sticky":
            home = self.co.router.home.get(sid)
            if home is not None and self.workers[home].alive:
                return home
            w = self._least_loaded(loads)
            self.co.router.set_home(sid, w)
            return w
        return self.co.route(sid, loads, self.now)

    def _ideal_time(self, task: WorkflowInstance) -> float:
        """No-queue no-regen estimate over the workflow's nominal path
        (scripted: the actual steps, so legacy Tasks are unchanged;
        graph/dynamic: the expected path — branches resolve at run
        time, so this is an estimate by construction)."""
        t = 0.0
        for s in task.nominal_steps():
            t += self.perf.step_compute_s(0.0, s.new_prompt_tokens,
                                          s.out_tokens)
            t += s.tool_latency_s
        return t

    # -- events ----------------------------------------------------------------
    def _on_arrival(self, task_id: str) -> None:
        task = self.tasks[task_id]
        self.metrics[task_id] = TaskMetrics(
            task_id, task.tenant, task.arrival_s,
            ideal_s=self._ideal_time(task),
            steps=len(task.nominal_steps()))
        self._tr_begin(task_id, "session", "session", tenant=task.tenant)
        cap = self.policy.admission_max_tasks
        if cap is not None and self.active_tasks >= cap:
            self.admission_queue.append(task)
            return
        self._admit(task)

    def _admit(self, task: WorkflowInstance) -> None:
        self.active_tasks += 1
        work_est = self._ideal_time(task)
        deadline = self.now + 1.5 * work_est
        aeg = task.declared_aeg()
        step_cost = 0.0
        if aeg is not None:
            # mean GPU-seconds per step over the nominal path: the unit
            # Eq. 9's work_remaining_steps is priced in
            nom = task.nominal_steps()
            gpu = sum(self.perf.step_compute_s(0.0, s.new_prompt_tokens,
                                               s.out_tokens) for s in nom)
            step_cost = gpu / max(len(nom), 1)
        self.co.register_task(task.task_id, task.tenant, task.tools(),
                              deadline, work_est, self.now,
                              prefix_tokens=task.prefix_tokens,
                              aeg=aeg, step_cost_s=step_cost,
                              entry_node=task.path[0] if task.path else 0)
        self._enqueue_step(StepJob(task, 0, self.now))

    def _can_admit(self, w: int, job: StepJob) -> bool:
        """Slot AND memory admission: a decode starts only if its KV fits
        beside the running requests (idle cache is evictable)."""
        ws = self.workers[w]
        if not ws.alive or ws.active >= self.perf.max_batch:
            return False
        ctx_bytes = job.task.context_before(job.step_idx) * \
            self.perf.kv_bytes_per_token
        return ws.active_kv + ctx_bytes <= self.co.capacity

    def _queue_push(self, w: int, job: StepJob) -> None:
        """Insert a pending step in priority order.  One code path for
        every producer (enqueue, migration landing, fault requeue), so
        AFS ordering can't be bypassed with a hardcoded priority."""
        if self.policy.queue_discipline == "afs":
            prio = -self.co.afs.priority(job.task.tenant)
        else:
            prio = job.enqueued_at
        ws = self.workers[w]
        if not ws.queue:               # empty -> nonempty transition
            self._nonempty.add(w)
            self.co.on_worker_busy(w)
        ws.queue.push(prio, next(self._seq), job)
        self._load_delta(w, 1)

    def _enqueue_step(self, job: StepJob,
                      worker: Optional[int] = None) -> None:
        """Place a step on ``worker`` (or route it), starting it
        immediately when a slot + KV headroom are free.  A dead
        explicit target falls back to routing; if no worker is alive
        the step parks in the orphan buffer until recover/scale-up."""
        tid = job.task.task_id
        if self.tracer is not None \
                and "step" not in self._tr_open.get(tid, {}):
            # first placement of this step opens the step span; fault
            # requeues and migration landings re-enter with it open
            self._tr_begin(tid, "step", "step", parent_key="session",
                           step=job.step_idx)
        w = worker if worker is not None and self.workers[worker].alive \
            else self._route(job.task)
        if not self.workers[w].alive:
            self._orphans.append(job)
            # the whole cluster is down: the wait still counts as queue
            # time (worker=-1); a pre-existing queue span keeps running
            if self.tracer is not None \
                    and "queue" not in self._tr_open.get(tid, {}):
                self._tr_begin(tid, "queue", "queue_wait",
                               parent_key="step", worker=-1)
            return
        job.worker = w
        job.cancelled = False
        ws = self.workers[w]
        if self._can_admit(w, job):
            ws.active += 1
            self._load_delta(w, 1)
            self._start_step(job)
        else:
            # a re-enqueue (fault drain) closes the old wait first
            self._tr_end(tid, "queue", status="requeued")
            self._tr_begin(tid, "queue", "queue_wait",
                           parent_key="step", worker=w)
            self._queue_push(w, job)

    def _start_step(self, job: StepJob) -> None:
        task, i, w = job.task, job.step_idx, job.worker
        step = task.steps[i]
        ctx = task.context_before(i)
        ws = self.workers[w]
        self.co.ensure_headroom(w, ws.active_kv,
                                ctx * self.perf.kv_bytes_per_token, self.now)
        hit, pf_extra, bg_tokens = self.co.on_step_start(
            task.task_id, w, ctx, self.now)
        # straggler injection: a slow worker serves both phases at
        # rate / factor (§5.2 — stealing should drain it)
        factor = self._speed_factor(w)
        rate = self.perf.prefill_tokens_per_s / factor
        # prefill is compute-bound and serializes per worker; decode slots
        # run in parallel (continuous batching is memory-bound).
        pf_tokens = pf_extra if hit else pf_extra + step.new_prompt_tokens
        regen = 0.0 if hit else pf_extra
        if bg_tokens > 0.0:
            # speculative prefetch: the suffix regeneration ran during
            # the tool gap IF the prefill server had idle time; compute
            # is charged either way (speculation is never free work).
            bg_dur = bg_tokens / rate
            if ws.prefill_free_at + bg_dur <= self.now:
                ws.busy_s += bg_dur          # hidden off the critical path
            else:
                pf_tokens += bg_tokens       # server busy: regen on path
                regen += bg_tokens
        pf_start = max(self.now, ws.prefill_free_at)
        pf_dur = pf_tokens / rate
        ws.prefill_free_at = pf_start + pf_dur
        decode_dur = step.out_tokens * factor / self.perf.decode_tokens_per_s
        done = pf_start + pf_dur + decode_dur
        busy = pf_dur + decode_dur
        ws.busy_s += busy
        ws.regen_s += regen / rate
        kv_bytes = ctx * self.perf.kv_bytes_per_token
        ws.active_kv += kv_bytes
        self._active_kv_total += kv_bytes
        self.metrics[task.task_id].regen_tokens += regen
        attempt = next(self._attempt)
        self.inflight[task.task_id] = InFlightStep(
            job, attempt, w, self.now, done, kv_bytes, busy,
            decode_s=decode_dur, regen_s_charged=regen / rate,
            regen_tokens=regen)
        # the prefill span starts at admission and so absorbs the serial
        # prefill pipeline's backlog wait (pipeline_wait in meta) — that
        # wait is caused by prefill/regeneration load, which is where a
        # TCT decomposition should attribute it.  The decode span is
        # future-dated (pf end); a cancellation landing earlier clamps
        # to a zero-duration span rather than a negative one.
        self._tr_end(task.task_id, "queue")
        self._tr_begin(task.task_id, "pf",
                       "resume" if hit else "prefill", parent_key="step",
                       worker=w, attempt=attempt,
                       tokens=float(pf_tokens), regen=float(regen),
                       pipeline_wait=pf_start - self.now)
        self._tr_begin(task.task_id, "dec", "decode", parent_key="step",
                       t=pf_start + pf_dur, worker=w, attempt=attempt)
        if self.obs_metrics is not None:
            self.obs_metrics.histogram("prefill_s").observe(
                self.now, pf_dur)
        self._push(done, "llm_done", (task.task_id, i, w, attempt))

    def _on_llm_done(self, task_id: str, i: int, w: int,
                     attempt: int) -> None:
        rec = self.inflight.get(task_id)
        if rec is None or rec.attempt != attempt:
            return   # stale: the step was cancelled by a worker fault
        del self.inflight[task_id]
        self._tr_end(task_id, "pf", t=rec.finish - rec.decode_s)
        self._tr_end(task_id, "dec", first_token_t=rec.finish
                     - rec.decode_s)
        task = self.tasks[task_id]
        ws = self.workers[w]
        ws.active -= 1
        self._load_delta(w, -1)
        ws.active_kv -= rec.kv_bytes
        self._active_kv_total -= rec.kv_bytes
        if ws.active < 0 or ws.active_kv < -self._kv_tol:
            raise RuntimeError(
                f"conservation violated on worker {w}: "
                f"active={ws.active} active_kv={ws.active_kv}")
        ws.active_kv = max(0.0, ws.active_kv)   # float dust
        self._drain_queue(w)
        step = task.steps[i]
        ctx_after = task.context_after(i)
        # park boundary: resolve the taken edge (graph: seeded branch
        # draw; dynamic: client callback; scripted: next listed step).
        # Memoized, so fault-retried steps never re-roll the path.
        if task.resolve_next(i) is None:
            # terminal: the workflow's last action is "finish" — no
            # tool wait
            m = self.metrics[task_id]
            if m.finish >= 0:
                raise RuntimeError(f"task {task_id} finished twice")
            self.co.task_finished(task_id, self.now)
            m.finish = self.now
            m.steps = task.n_steps          # actual executed path length
            self.active_tasks -= 1
            self._tr_end(task_id, "step")
            self._tr_end(task_id, "session")
            self._tr_open.pop(task_id, None)
            if self.admission_queue:
                self._admit(self.admission_queue.pop(0))
            return
        # the tool observation has not arrived yet: the cached context
        # covers everything up to and including this step's output
        ctx_cached = ctx_after - step.obs_tokens
        entry_bytes = ctx_cached * self.perf.kv_bytes_per_token
        self.co.on_step_end(task_id, w, ctx_cached, entry_bytes,
                            step.tool, self.now,
                            next_node=task.next_node_hint(i + 1))
        self._tr_begin(task_id, "gap", "tool_gap", parent_key="step",
                       tool=step.tool)
        self._push(self.now + step.tool_latency_s, "tool_done",
                   (task_id, i, w))

    def _on_tool_done(self, task_id: str, i: int, w: int) -> None:
        task = self.tasks[task_id]
        step = task.steps[i]
        self.co.on_tool_done(task_id, step.tool, step.tool_latency_s,
                             step.obs_tokens, self.now)
        self._tr_end(task_id, "gap")
        self._tr_end(task_id, "step")
        self._enqueue_step(StepJob(task, i + 1, self.now))

    def _drain_queue(self, w: int) -> None:
        ws = self.workers[w]
        while True:
            job = ws.queue.peek()
            if job is None or not self._can_admit(w, job):
                break
            self._queue_pop(w)
            ws.active += 1
            self._load_delta(w, 1)
            self._start_step(job)

    # -- epoch: AFS + work stealing ------------------------------------------
    def _epoch_decide(self):
        """O(changes) epoch tick: the load vector is one C division of
        incrementally-maintained counts, the stealer consults the
        indexed idle set and the nonempty-queue index (no cluster-wide
        scans), queue views and the alive list are persistent, and the
        AFS recompute runs over persistent delta-updated columns.
        Overridable hook: ``benchmarks/scale_sweep.py`` swaps in the
        legacy O(n_workers) variant as the A/B baseline."""
        loads = self._loads()
        decision, _ = self.co.epoch_tick(
            self.now, loads, self._queue_views, alive=self._alive_list,
            victim_candidates=self._nonempty, scan_queues=False)
        return decision

    def _on_epoch(self) -> None:
        if self.obs_metrics is not None:
            if self._obs_tick % 10 == 0:
                self._obs_sample()
            self._obs_tick += 1
        decision = self._epoch_decide()
        if decision is not None:
            vq = self.workers[decision.victim].queue
            if self.co.stealer.accept(
                    decision, len(vq), self.now,
                    thief_alive=self.workers[decision.thief].alive):
                job = self._queue_remove(decision.victim,
                                         decision.session_id)
                if job is not None:
                    mig = self.perf.sample_migration_s(self.rng)
                    self.migrations += 1
                    self.metrics[job.task.task_id].migrations += 1
                    self._tr_end(job.task.task_id, "queue",
                                 status="stolen")
                    self._tr_begin(job.task.task_id, "migr", "migration",
                                   parent_key="step",
                                   src=decision.victim,
                                   dst=decision.thief)
                    self.migrating[job.task.task_id] = decision.thief
                    self._push(self.now + mig, "migr_done",
                               (job.task.task_id, job.step_idx,
                                decision.victim, decision.thief))
        if self.events or not self._all_done():
            if not self.events and not any(w.alive for w in self.workers):
                # every worker is dead and nothing is scheduled that
                # could revive one (no recover/scale-up left): ticking
                # forever cannot make progress, so let run() return —
                # unfinished tasks stay visible and
                # check_conservation() reports them
                return
            self._push(self.now + self.perf.epoch_s, "epoch")

    def _obs_sample(self) -> None:
        """Decimated epoch-tick metric sampling (traced runs only):
        per-worker queue depth, batch occupancy, in-flight KV bytes and
        cumulative regeneration seconds, plus cluster memory
        utilization (same formula as ``_sample_mem``), cached pool
        bytes, and per-tenant AFS service.  Read-only off structures
        the scheduler already maintains; the per-worker gauge handles
        are cached (grown lazily on scale-up) so the hot loop skips the
        registry's label-key construction."""
        m = self.obs_metrics
        now = self.now
        while len(self._obs_worker_g) < len(self.workers):
            w = len(self._obs_worker_g)
            self._obs_worker_g.append((
                m.gauge("queue_depth", worker=w),
                m.gauge("batch_occupancy", worker=w),
                m.gauge("kv_active_bytes", worker=w),
                m.gauge("regen_s", worker=w)))
        for w, ws in enumerate(self.workers):
            gq, gb, gk, gr = self._obs_worker_g[w]
            gq.set(now, len(ws.queue))
            gb.set(now, ws.active)
            gk.set(now, ws.active_kv)
            gr.set(now, ws.regen_s)
        m.gauge("pool_bytes_cached").set(now, self.co.pools_used)
        m.gauge("mem_util").set(
            now, (self.co.pools_used + self._active_kv_total)
            / (self.co.capacity * self.n_workers))
        for name in sorted(self.co.afs.tenants):
            m.gauge("afs_service_s", tenant=name).set(
                now, self.co.afs.tenants[name].service_s)

    def _on_migr_done(self, task_id: str, step_idx: int, src: int,
                      dst: int) -> None:
        """A stolen session's KV transfer completed.  Validates against
        live state: if the destination died while the transfer was in
        flight, the KV is dropped and the step re-routes to a live
        worker (it regenerates there — §3.1 accounting) instead of
        parking forever on the dead worker's queue."""
        self.migrating.pop(task_id, None)
        m = self.metrics.get(task_id)
        if m is None or m.finish >= 0:
            self._tr_end(task_id, "migr", status="stale")
            return
        job = StepJob(self.tasks[task_id], step_idx, self.now)
        if not self.workers[dst].alive:
            self._tr_end(task_id, "migr", status="dropped")
            self._enqueue_step(job)          # re-route, cache lost
            return
        self._tr_end(task_id, "migr")
        self.co.migrate_session(task_id, src, dst, self.now)
        self._enqueue_step(job, worker=dst)

    # -- faults / elasticity ---------------------------------------------------
    def _cancel_inflight_on(self, w: int) -> List[StepJob]:
        """Cancel every in-flight step on worker ``w``: refund the
        un-executed tail of the charged compute, release the KV
        reservation, and invalidate the pending ``llm_done`` events
        (their attempt ids no longer match the registry).  The refund
        is taken end-first — decode before prefill, since prefill
        (where regeneration runs) executes first — so regeneration
        time/tokens are only refunded for the prefill portion that
        never ran, keeping regen <= busy per worker while never
        un-charging regeneration that actually executed."""
        ws = self.workers[w]
        victims = sorted(tid for tid, rec in self.inflight.items()
                         if rec.worker == w)
        jobs: List[StepJob] = []
        for tid in victims:
            rec = self.inflight.pop(tid)
            self._tr_end(tid, "pf", status="cancelled")
            self._tr_end(tid, "dec", status="cancelled")
            self._tr_instant(f"worker/{w}", "cancel", task=tid,
                             attempt=rec.attempt)
            ws.active -= 1
            self._load_delta(w, -1)
            ws.active_kv -= rec.kv_bytes
            self._active_kv_total -= rec.kv_bytes
            refund = min(rec.busy_charged,
                         max(0.0, rec.finish - self.now))
            ws.busy_s -= refund
            pf_dur = rec.busy_charged - rec.decode_s
            into_prefill = max(0.0, refund - rec.decode_s)
            if pf_dur > 0.0 and into_prefill > 0.0 \
                    and rec.regen_s_charged > 0.0:
                frac = into_prefill / pf_dur
                ws.regen_s -= rec.regen_s_charged * frac
                self.metrics[tid].regen_tokens -= rec.regen_tokens * frac
            jobs.append(rec.job)
        return jobs

    def _on_fail(self, w: int) -> None:
        """Worker dies: cancel its in-flight steps, requeue them plus
        its queued steps on live workers, wipe its KV pool/affinities.
        Nothing completes on a dead node; retried steps pay cache-loss
        regeneration."""
        self._tr_instant("run", "fault", kind="fail", worker=w)
        ws = self.workers[w]
        if not ws.alive:
            return                           # already down
        ws.alive = False
        self._alive_list[w] = False
        self._n_dead += 1
        if np is not None:
            self._alive_np[w] = False
        self.co.worker_failed(w)
        requeue = self._queue_drain(w)
        requeue.extend(self._cancel_inflight_on(w))
        if ws.active != 0 or abs(ws.active_kv) > self._kv_tol:
            raise RuntimeError(
                f"worker {w} lifecycle leak at failure: "
                f"active={ws.active} active_kv={ws.active_kv}")
        self._active_kv_total -= ws.active_kv    # float dust parity
        ws.active = 0
        ws.active_kv = 0.0
        ws.prefill_free_at = 0.0             # prefill pipeline dies too
        for job in requeue:
            self._enqueue_step(StepJob(job.task, job.step_idx, self.now))

    def _on_recover(self, w: int) -> None:
        self._tr_instant("run", "fault", kind="recover", worker=w)
        if self.workers[w].alive:
            return                           # already up (storm overlap)
        self.workers[w].alive = True
        self._alive_list[w] = True
        self._n_dead -= 1
        if np is not None:
            self._alive_np[w] = True
        self.co.worker_recovered(w, self.now)
        self._readmit_orphans()

    def _on_scale_up(self, _unused: int = 0) -> None:
        self._tr_instant("run", "fault", kind="scale_up",
                         worker=_unused)
        self.co.add_worker(self.now)
        ws = WorkerState()
        self.workers.append(ws)
        self._alive_list.append(True)
        if np is not None:
            self._loadnum = np.append(self._loadnum, 0)
            self._alive_np = np.append(self._alive_np, True)
        self._queue_views.append(_QueueView(ws))
        self.n_workers += 1
        self._readmit_orphans()

    # -- straggler injection ---------------------------------------------------
    def _on_slow(self, w: int) -> None:
        """Plan event: worker ``w`` becomes a straggler (its service
        rates divide by ``straggler_slowdown``).  Steps already in
        flight keep their original finish times — slowdowns hit new
        admissions, like a thermal throttle between batches."""
        self._tr_instant("run", "fault", kind="slow", worker=w)
        self._slow[w] = self.straggler_slowdown

    def _on_heal(self, w: int) -> None:
        self._tr_instant("run", "fault", kind="heal", worker=w)
        self._slow.pop(w, None)

    def _readmit_orphans(self) -> None:
        orphans, self._orphans = self._orphans, []
        for job in orphans:
            self._enqueue_step(StepJob(job.task, job.step_idx, self.now))

    # -- invariants -------------------------------------------------------
    def check_conservation(self) -> None:
        """Check the workflow-atomic lifecycle invariants after a run:
        every admitted task finished exactly once (double finishes raise
        during the run), no step is still queued / in flight / mid-
        migration / orphaned, and per-worker slot and KV accounting
        returned to zero.  Raises RuntimeError listing every violation
        (explicit raises, not asserts, so ``python -O`` cannot compile
        the gate away).  Used by the fault tests and scale benchmark."""
        bad: List[str] = []
        unfinished = [t for t, m in self.metrics.items() if m.finish < 0]
        if unfinished:
            bad.append(f"tasks never finished: {unfinished[:5]}")
        if len(self.metrics) != len(self.tasks):
            bad.append("tasks never admitted")
        if self.admission_queue:
            bad.append("tasks stuck in admission")
        if self.active_tasks != 0:
            bad.append(f"active_tasks={self.active_tasks}")
        if self.inflight:
            bad.append(f"steps still in flight: {sorted(self.inflight)[:5]}")
        if self.migrating:
            bad.append(f"migrations in limbo: {sorted(self.migrating)[:5]}")
        if self._orphans:
            bad.append("orphaned steps never re-admitted")
        for w, ws in enumerate(self.workers):
            if len(ws.queue) != 0:
                bad.append(f"worker {w} queue not drained")
            if ws.active != 0:
                bad.append(f"worker {w} active={ws.active}")
            if abs(ws.active_kv) >= self._kv_tol:
                bad.append(f"worker {w} active_kv={ws.active_kv}")
            # incremental-index invariants: the O(1) mirrors must agree
            # with ground truth at quiescence
            if np is not None and \
                    self._loadnum[w] != ws.active + len(ws.queue):
                bad.append(f"worker {w} load index drifted: "
                           f"{self._loadnum[w]} != "
                           f"{ws.active + len(ws.queue)}")
            if (w in self._nonempty) != bool(ws.queue):
                bad.append(f"worker {w} nonempty index stale")
            if self._alive_list[w] != ws.alive:
                bad.append(f"worker {w} alive mirror stale")
        if abs(self._active_kv_total) >= self._kv_tol * self.n_workers:
            bad.append(f"active_kv_total={self._active_kv_total}")
        if bad:
            raise RuntimeError("conservation violated: " + "; ".join(bad))


# --- summary ----------------------------------------------------------------
def summarize(sim: ClusterSim) -> dict:
    ms = [m for m in sim.metrics.values() if m.finish >= 0]
    if not ms:
        return {}
    tcts = sorted(m.tct for m in ms)
    slo = sum(1 for m in ms if m.tct <= 1.5 * m.ideal_s) / len(ms)
    total_busy = sum(w.busy_s for w in sim.workers) or 1.0
    regen_frac = sum(w.regen_s for w in sim.workers) / total_busy
    mem_num = sum(dt * u for dt, u in sim.mem_samples)
    mem_den = sum(dt for dt, u in sim.mem_samples) or 1.0
    span = (max(m.finish for m in ms) - min(m.arrival for m in ms)) or 1.0
    pool = sim.co.pools[0]
    hits = sim.co.cache_hits
    miss = sim.co.cache_misses
    by_tenant: Dict[str, List[TaskMetrics]] = {}
    for m in ms:
        by_tenant.setdefault(m.tenant.split("-")[0], []).append(m)
    slo_by = {k: sum(1 for m in v if m.tct <= 1.5 * m.ideal_s) / len(v)
              for k, v in by_tenant.items()}
    evictions = sum(p.evictions for p in sim.co.pools)
    inserts = evictions + sum(len(p.entries) for p in sim.co.pools) + hits
    return {
        "n_tasks": len(ms),
        "tct_mean": sum(tcts) / len(tcts),
        "tct_p50": tcts[len(tcts) // 2],
        "tct_p99": tcts[min(len(tcts) - 1, int(0.99 * len(tcts)))],
        "ideal_mean": sum(m.ideal_s for m in ms) / len(ms),
        "slo_attainment": slo,
        "slo_by_tenant": slo_by,
        "mem_util": mem_num / mem_den,
        "regen_time_frac": regen_frac,
        "throughput_tasks_per_min": len(ms) / span * 60.0,
        "cache_hit_rate": hits / max(hits + miss, 1),
        "migrations_per_task": sim.migrations / len(ms),
        "evict_rate": evictions / max(inserts, 1),
        "regen_tokens_total": sum(m.regen_tokens for m in ms),
    }
