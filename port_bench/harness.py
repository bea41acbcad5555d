"""One run of a cell: the program under test driven by a closed population
of agents, timed on the wall clock.

The system under test is ``repro_torch.serving.runtime.ServingRuntime``
with one paged ``Engine`` on the card and ``SAGAConfig()`` as shipped.
The runtime orders its events on a virtual clock; its ``RuntimePerf`` rates
are the cell's, set once from measured walls so that tool gaps interleave
with compute about as they would on the wall.  The harness advances that
clock in short slices until ``--seconds`` of wall time have passed.

Wall timestamps come from the harness's wrappers around the engine
instance's ``start_session`` and ``decode``.  Every decode round ends when
its ids reach the host, a point the device has reached, so a round's end
is a device-synchronised time; the untraced run adds no synchronisation.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import random
import time
from typing import Dict, List, Optional, Tuple

import torch

from port_bench import spec, traffic
from port_bench.trace import Profile, TraceSummary
from port_bench.weights import make_params

SLICE_S = 0.5             # virtual seconds the runtime advances per slice
WARMUP_VIRTUAL_S = 3600.0
TRACE_AT = 0.4            # share of the window before the profiler may start
TRACE_LATEST = 0.75       # share by which it starts whatever comes next
TRACE_MIN_S = 6.0         # shortest profiled sub-window (wall s)


@dataclasses.dataclass
class StepLog:
    kind: str                 # first | hit | regen
    t_call: float
    ctx_len: int              # tokens handed to start_session
    prefill: int              # tokens the engine prefills
    n_out: int                # tokens the step decodes
    window: bool              # admitted inside the measured window
    profiled: bool
    t_ret: float = 0.0        # start_session returned (synchronised when
                              # traced)
    slot: int = -1            # the engine's slot that served the step
    tokens: List[int] = dataclasses.field(default_factory=list)
    times: List[float] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Round:
    t_call: float
    t_end: float
    rows: List[Tuple[str, int]]    # (session, position) of each live row
    window: bool
    profiled: bool


@dataclasses.dataclass
class Record:
    """What a run measured; the metric readers read it."""
    m: Dict
    sizing: Dict
    peaks: Dict
    seconds: float
    setup_s: float = 0.0
    t_window: Tuple[float, float] = (0.0, 0.0)
    rounds: List[Round] = dataclasses.field(default_factory=list)
    steps: Dict[str, List[StepLog]] = dataclasses.field(default_factory=dict)
    prefills: List[Tuple[int, int, bool]] = dataclasses.field(
        default_factory=list)      # (tokens, kernel length, profiled)
    trace: Optional[TraceSummary] = None
    n_slots: int = 0
    max_nb: int = 0
    memory_peak: int = 0
    tasks: Dict[str, traffic.AgentTask] = dataclasses.field(
        default_factory=dict)
    params: Optional[Dict] = None       # the weights, for the reference

    # -- views the readers share ----------------------------------------
    def window_steps(self) -> List[StepLog]:
        return [s for steps in self.steps.values() for s in steps
                if s.window]

    def window_rounds(self) -> List[Round]:
        return [r for r in self.rounds if r.window]


class Recorder:
    """Wraps the engine instance's ``start_session`` and ``decode``: the
    wall times, rows and tokens of each, and in a traced run a profiler
    span around each (and a synchronisation after each admission, so a
    round's wall holds its own work alone)."""

    def __init__(self, engine, rec: Record, traced: bool):
        self.engine = engine
        self.traced = traced
        self.in_window = False
        self.profile: Optional[Profile] = None
        self.decoded_slots = set()
        self.n_out: Dict[str, List[int]] = {}
        served_start, served_decode = engine.start_session, engine.decode

        def start_session(sid, tokens, cached_hit):
            pool = engine.pool
            hit = bool(cached_hit) and pool.has(sid)
            old = rec.steps.get(sid)
            kind = "first" if old is None else ("hit" if hit else "regen")
            n = len(tokens)
            prefill = n - int(pool.lens[sid]) if hit else n
            step = len(old) if old else 0
            log = StepLog(kind, time.perf_counter(), n, prefill,
                          self.n_out[sid][step], self.in_window,
                          self.profiling)
            rec.steps.setdefault(sid, []).append(log)
            with self._span("bench.start_session"):
                slot = served_start(sid, tokens, cached_hit)
                if self.traced and self.in_window \
                        and engine.device.type == "cuda":
                    torch.cuda.synchronize()
            log.t_ret = time.perf_counter()
            log.slot = -1 if slot is None else int(slot)
            if prefill:
                rec.prefills.append((prefill, self._kernel_len(prefill),
                                     self.profiling))
            return slot

        def decode(slot_tokens, n_steps=1):
            rows = [(engine.slots[s].session_id, engine.slots[s].length)
                    for s in sorted(slot_tokens)]
            t = time.perf_counter()
            with self._span("bench.decode"):
                out = served_decode(slot_tokens, n_steps)
            t_end = time.perf_counter()
            rec.rounds.append(Round(t, t_end, rows, self.in_window,
                                    self.profiling))
            for s in sorted(slot_tokens):
                log = rec.steps[engine.slots[s].session_id][-1]
                log.tokens.extend(out[s])
                log.times.extend([t_end] * len(out[s]))
            self.decoded_slots.update(slot_tokens)
            return out

        engine.start_session = start_session
        engine.decode = decode

    @property
    def profiling(self) -> bool:
        return self.profile is not None and self.profile.active

    def _span(self, name):
        if self.traced:
            return torch.profiler.record_function(name)
        return contextlib.nullcontext()

    def _kernel_len(self, n: int) -> int:
        """The padded length ``flash_prefill`` runs at: the engine pads a
        prefill to its quantum (``Engine._prefill_quantum``), at most
        ``max_len``."""
        q = self.engine._prefill_quantum
        return max(n, min(self.engine.max_len, -(-n // q) * q))


class Population:
    """The closed loop: whenever an agent's task has finished, its next
    task is submitted at the runtime's current virtual time."""

    def __init__(self, rt, agents: traffic.Agents, recorder: Recorder):
        self.rt = rt
        self.agents = agents
        self.recorder = recorder
        self.handles: List = [None] * agents.n
        self.next_round = [0] * agents.n
        self.tasks: Dict[str, traffic.AgentTask] = {}

    def refill(self) -> None:
        from repro_torch.serving.runtime import AgentRequest
        for a, h in enumerate(self.handles):
            if h is not None and not h.done:
                continue
            r = self.next_round[a]
            if r >= len(self.agents.rounds):
                raise RuntimeError(f"agent {a} ran out of tasks: raise "
                                   f"the traffic's tasks_per_agent")
            task = self.agents.task(a, r)
            self.next_round[a] = r + 1
            self.tasks[task.session_id] = task
            self.recorder.n_out[task.session_id] = [n for _, n, _, _
                                                    in task.steps]
            self.handles[a] = self.rt.submit(
                AgentRequest(task.session_id, "tenant0", task.steps),
                arrival=self.rt.ev.now)


def _admission_due(rt, horizon: float) -> bool:
    """Whether the runtime's event heap holds an admission's prefill due by
    ``horizon`` (read only): the profiler then starts before a slice that
    runs a prefill, so the trace holds one as well as decode rounds."""
    return any(kind == "prefill_done" and t <= horizon
               for t, _, kind, _ in rt.ev._heap)


def run(cell_name: str, seed: int, seconds: float, traced: bool,
        t_process: float, peaks: Dict, device: str = "cuda",
        root=spec.ROOT) -> Tuple[Record, Dict]:
    """Set up, warm up, and measure one cell.  Returns the record and the
    runtime's host state of every session (context, outputs per step, and
    the length of KV its engine holds, -1 for none), with the program's
    state freed."""
    from repro_torch.core.coordinator import SAGAConfig
    from repro_torch.serving.runtime import RuntimePerf, ServingRuntime

    on_card = torch.device(device).type == "cuda"
    c = spec.cell(cell_name, root)
    m = spec.model_sizes(c["config"])
    sz = c["sizing"]
    cfg = spec.model_config(m)
    if on_card:
        from repro_torch.kernels import build
        build.build_all(["flash_attention", "paged_attention"])
    params = make_params(m, seed, device)
    rt = ServingRuntime(
        cfg, params, n_workers=1, saga=SAGAConfig(), n_slots=sz["n_slots"],
        max_len=c["traffic"]["max_len"], pool_blocks=sz["pool_blocks"],
        perf=RuntimePerf(**sz["perf"]), seed=seed, sanitize=False,
        trace=False)
    eng = rt.engines[0]
    rec = Record(m, sz, peaks, seconds, n_slots=eng.n_slots,
                 max_nb=eng.max_nb)
    recorder = Recorder(eng, rec, traced)
    pop = Population(rt, traffic.Agents(c["traffic"], seed, m["vocab"]),
                     recorder)

    def slice_():
        pop.refill()
        with recorder._span("bench.slice"):
            rt.run(rt.ev.now + SLICE_S)

    # warm-up, set-up that the traffic needs: until every slot has decoded
    while len(recorder.decoded_slots) < eng.n_slots:
        if rt.ev.now > WARMUP_VIRTUAL_S:
            raise RuntimeError("warm-up did not fill every slot")
        slice_()
    if on_card:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    rec.setup_s = t0 - t_process
    recorder.in_window = True
    while True:
        now = time.perf_counter() - t0
        if now >= seconds:
            break
        if traced and recorder.profile is None and (
                now >= TRACE_LATEST * seconds
                or now >= TRACE_AT * seconds
                and _admission_due(rt, rt.ev.now + SLICE_S)):
            recorder.profile = Profile()
            recorder.profile.start()
        elif recorder.profiling and (
                time.perf_counter() - recorder.profile.t0 >= TRACE_MIN_S
                and any(p[2] for p in rec.prefills)):
            recorder.profile.stop()
        slice_()
    rec.t_window = (t0, time.perf_counter())
    recorder.in_window = False
    if recorder.profiling:
        recorder.profile.stop()
    host = {sid: (list(ses.ctx), [list(o) for o in ses.step_outputs],
                  int(eng.pool.lens.get(sid, -1)))
            for sid, ses in rt.sessions.items()}
    rec.memory_peak = torch.cuda.max_memory_allocated() if on_card else 0
    if recorder.profile is not None:
        rec.trace = recorder.profile.summary()
        recorder.profile = None
    rec.tasks = pop.tasks
    rec.params = params
    # free the program's state before the reference runs
    del rt, eng, recorder, pop
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return rec, host


def sample_steps(rec: Record, seed: int, n: int) -> List[Tuple[str, int]]:
    """(session, step) pairs to compare, from the steps that served a token
    inside the window (a step still decoding when the window closed is
    compared on the tokens it had served): the one with the longest
    context, then, drawn from ``seed``, a resumed step that hit its parked
    KV and one that regenerated its context wherever the window has them,
    then others, from slots not yet covered first, until there are ``n``
    and more than half of the engine's slots are covered wherever the
    window allows (so a fault in half of the batch cannot be missed)."""
    t0, t1 = rec.t_window
    cands = sorted((sid, j) for sid, steps in rec.steps.items()
                   for j, s in enumerate(steps)
                   if s.times and t0 < s.times[-1] <= t1)
    if not cands:
        return []

    def log(d):
        return rec.steps[d[0]][d[1]]

    rng = random.Random(traffic.seed_int("sample", seed))
    picked = [max(cands, key=lambda d: (log(d).ctx_len + len(log(d).tokens),
                                        d))]
    for kind in ("hit", "regen"):
        pool = [d for d in cands if log(d).kind == kind and d not in picked]
        if pool and all(log(p).kind != kind for p in picked):
            picked.append(pool[rng.randrange(len(pool))])
    rest = [d for d in cands if d not in picked]
    rng.shuffle(rest)
    while rest:
        slots = {log(p).slot for p in picked}
        fresh = [d for d in rest if log(d).slot not in slots]
        if len(picked) >= n and not (fresh
                                     and len(slots) <= rec.n_slots // 2):
            break
        d = (fresh or rest)[0]
        rest.remove(d)
        picked.append(d)
    return sorted(picked)
