"""AgentProgram: graph-structured, dynamically-resolved agent workflows
as the schedulable unit (paper §3.1-§3.3).

See ``repro_torch.workflow`` for the flavor overview.  Determinism contract:
every random choice a program makes flows through two per-instance
seeded streams derived from a stable FNV-1a hash of the program id —

  * the **path stream** resolves taken edges (graph flavor) and feeds
    the dynamic callback's ``ctx.rng``, so the executed node path for a
    given (program_id, seed) is identical across processes AND across
    the two execution substrates;
  * the **realization stream** samples unspecified tool latencies and
    generates prompt token ids (runtime), so realization draws never
    perturb the path.

Nothing here touches Python's builtin ``hash`` or global RNG state, so
identical-seed runs stay byte-identical across ``PYTHONHASHSEED``.
"""
from __future__ import annotations

import math
import random
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.cluster.workload import (TOOL_LATENCY_TABLE, Step,
                                    lognormal_params, sample_tool_latency)
from repro_torch.core.aeg import AEG

_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_FNV_MASK = 0xFFFFFFFFFFFFFFFF


def _fnv1a(s: str) -> int:
    h = _FNV_OFFSET
    for b in s.encode("utf-8"):
        h ^= b
        h = (h * _FNV_PRIME) & _FNV_MASK
    return h


def _median_latency(tool: str) -> float:
    mu, _ = lognormal_params(tool)
    return math.exp(mu)


@dataclass
class StepSpec:
    """Declared parameters of one workflow step (one AEG node).

    Carries both representations so one spec drives both substrates:
    the simulator's float token economics (``new_prompt_tokens`` /
    ``out_tokens`` / ``obs_tokens``) and the serving runtime's real
    realization (``prompt_ids`` / ``n_out``).  Whichever side is
    omitted is derived from the other; ``tool_latency_s=None`` samples
    a fresh Table-1 log-normal latency per *execution* (a retry edge
    revisiting the node re-rolls the tool)."""
    tool: str
    new_prompt_tokens: Optional[float] = None
    out_tokens: Optional[float] = None
    obs_tokens: float = 0.0
    tool_latency_s: Optional[float] = None
    prompt_ids: Optional[List[int]] = None
    n_out: Optional[int] = None

    def __post_init__(self) -> None:
        if self.new_prompt_tokens is None and self.prompt_ids is None:
            raise ValueError(
                f"StepSpec({self.tool}): need new_prompt_tokens or "
                f"prompt_ids")
        if self.out_tokens is None and self.n_out is None:
            raise ValueError(
                f"StepSpec({self.tool}): need out_tokens or n_out")

    # -- derived views ---------------------------------------------------
    def sim_prompt_tokens(self) -> float:
        if self.new_prompt_tokens is not None:
            return self.new_prompt_tokens
        return float(len(self.prompt_ids))

    def sim_out_tokens(self) -> float:
        if self.out_tokens is not None:
            return self.out_tokens
        return float(self.n_out)

    def rt_n_out(self) -> int:
        if self.n_out is not None:
            return self.n_out
        return max(1, int(round(self.out_tokens)))

    def rt_n_prompt(self) -> int:
        if self.prompt_ids is not None:
            return len(self.prompt_ids)
        return max(1, int(round(self.new_prompt_tokens)))


@dataclass
class DynamicContext:
    """What a dynamic program's callback sees when deciding the next
    step: the executed history, per-step outputs (runtime: decoded
    token-id lists; simulator: ``out_tokens`` floats), the completed
    step's tool observation size, and the instance's seeded path RNG
    (use it — not global randomness — to keep replays byte-identical)."""
    step_idx: int                  # index of the step that just finished
    history: Sequence[Step]        # executed steps, economics view
    outputs: Sequence[object]      # per-step outputs so far
    last_tool: str                 # tool the finished step invokes
    last_obs_tokens: float         # its observation size
    rng: random.Random             # deterministic per-instance stream


@dataclass
class AgentProgram:
    """One agent workflow submission, consumed by BOTH ``ClusterSim``
    and ``ServingRuntime``.  Use the ``scripted`` / ``graph`` /
    ``dynamic`` constructors (or the ``from_task`` / ``from_request``
    backward-compat adapters) rather than filling fields by hand."""
    program_id: str
    tenant: str
    kind: str                              # scripted | graph | dynamic
    arrival_s: float = 0.0
    prefix_tokens: float = 0.0
    seed: int = 0
    max_steps: int = 64                    # cycle guard for graph/dynamic
    workload: str = "program"
    steps: Optional[List[StepSpec]] = None             # scripted
    nodes: Optional[Dict[int, StepSpec]] = None        # graph
    edges: Optional[List[Tuple[int, int, float]]] = None
    entry: int = 0
    next_step_fn: Optional[Callable[[DynamicContext],
                                    Optional[StepSpec]]] = None
    planned_tools: Optional[List[str]] = None          # dynamic hint

    # -- constructors ----------------------------------------------------
    @classmethod
    def scripted(cls, program_id: str, tenant: str,
                 steps: Sequence[StepSpec], *, arrival_s: float = 0.0,
                 prefix_tokens: float = 0.0, seed: int = 0,
                 workload: str = "program") -> "AgentProgram":
        if not steps:
            raise ValueError("scripted program needs at least one step")
        return cls(program_id, tenant, "scripted", arrival_s,
                   prefix_tokens, seed, len(steps), workload,
                   steps=list(steps))

    @classmethod
    def graph(cls, program_id: str, tenant: str,
              nodes: Dict[int, StepSpec],
              edges: Sequence[Tuple[int, int, float]], *,
              entry: int = 0, arrival_s: float = 0.0,
              prefix_tokens: float = 0.0, seed: int = 0,
              max_steps: int = 64,
              workload: str = "program") -> "AgentProgram":
        """Explicit-AEG flavor: ``edges`` are (u, v, p) with p the
        probability of taking u->v; residual mass at a node (1 - sum of
        its out-edge probabilities) terminates the workflow there.  A
        node with no out-edges is terminal after it executes."""
        if entry not in nodes:
            raise ValueError(f"entry node {entry} not in nodes")
        out: Dict[int, float] = {}
        for u, v, p in edges:
            if u not in nodes or v not in nodes:
                raise ValueError(f"edge ({u},{v}) references unknown node")
            if p < 0.0:
                raise ValueError(f"edge ({u},{v}) probability {p} < 0")
            out[u] = out.get(u, 0.0) + p
        for u, tot in out.items():
            if tot > 1.0 + 1e-9:
                raise ValueError(
                    f"node {u} out-probabilities sum to {tot} > 1")
        return cls(program_id, tenant, "graph", arrival_s, prefix_tokens,
                   seed, max_steps, workload, nodes=dict(nodes),
                   edges=list(edges), entry=entry)

    @classmethod
    def dynamic(cls, program_id: str, tenant: str,
                next_step_fn: Callable[[DynamicContext],
                                       Optional[StepSpec]], *,
                planned_tools: Optional[Sequence[str]] = None,
                arrival_s: float = 0.0, prefix_tokens: float = 0.0,
                seed: int = 0, max_steps: int = 64,
                workload: str = "program") -> "AgentProgram":
        """Callback flavor: ``next_step_fn(ctx)`` returns the next
        ``StepSpec`` (or None to finish).  Called once before the first
        step (empty history) and once at each park boundary."""
        return cls(program_id, tenant, "dynamic", arrival_s,
                   prefix_tokens, seed, max_steps, workload,
                   next_step_fn=next_step_fn,
                   planned_tools=list(planned_tools or []))

    # -- backward-compat adapters ---------------------------------------
    @classmethod
    def from_task(cls, task) -> "AgentProgram":
        """Compile a ``cluster.workload.Task`` into a scripted program.
        The instance reuses the task's ``Step`` objects directly, so the
        simulator sees bit-identical economics."""
        prog = cls(task.task_id, task.tenant, "scripted", task.arrival_s,
                   task.prefix_tokens, 0, max(len(task.steps), 1),
                   task.workload)
        prog._raw_steps = task.steps          # shared, never mutated
        return prog

    @classmethod
    def from_request(cls, req) -> "AgentProgram":
        """Compile a ``serving.runtime.AgentRequest`` into a scripted
        program.  The instance reuses the request's step tuples, so the
        runtime prefills bit-identical token ids."""
        prog = cls(req.session_id, req.tenant, "scripted", req.arrival_s,
                   0.0, 0, max(len(req.steps), 1), "request")
        prog._raw_rt_steps = req.steps        # shared, never mutated
        return prog

    # -- instantiation ---------------------------------------------------
    def instantiate(self, *, vocab: Optional[int] = None,
                    max_ctx_tokens: Optional[int] = None,
                    max_gap_s: Optional[float] = None
                    ) -> "WorkflowInstance":
        return WorkflowInstance(self, vocab=vocab,
                                max_ctx_tokens=max_ctx_tokens,
                                max_gap_s=max_gap_s)


class WorkflowInstance:
    """Execution cursor for one submitted program: materializes the
    taken path lazily and presents BOTH substrate surfaces.

    Simulator surface (Task-shaped): ``task_id`` / ``tenant`` /
    ``workload`` / ``arrival_s`` / ``prefix_tokens`` / ``steps`` (the
    materialized ``workload.Step`` list, grows as branches resolve) /
    ``n_steps`` / O(1) ``context_before`` / ``context_after`` /
    ``tools()``.

    Runtime surface: ``rt_step(i)`` -> (prompt token ids, n_out, tool,
    gap seconds), materialized alongside ``steps`` when the instance
    was created with ``vocab``.

    Advancement: ``resolve_next(i, outputs=...)`` is called exactly once
    per executed step at the park boundary (LLM step i finished, its
    tool about to run); it resolves the taken edge / calls the dynamic
    callback, materializes step i+1, and returns it — or None when the
    workflow terminates.  Memoized, so fault-retried steps never re-roll
    the path.
    """

    def __init__(self, program: AgentProgram, *,
                 vocab: Optional[int] = None,
                 max_ctx_tokens: Optional[int] = None,
                 max_gap_s: Optional[float] = None):
        self.program = program
        self.task_id = program.program_id
        self.tenant = program.tenant
        self.workload = program.workload
        self.arrival_s = program.arrival_s
        self.prefix_tokens = program.prefix_tokens
        self._vocab = vocab
        self._max_ctx = max_ctx_tokens
        self._max_gap_s = max_gap_s
        base = _fnv1a(program.program_id) ^ (program.seed & _FNV_MASK)
        self._rng_path = random.Random(base)
        self._rng_real = random.Random((base * _FNV_PRIME + 1) & _FNV_MASK)
        self.steps: List[Step] = []
        self.rt_steps: List[Tuple[List[int], int, str, float]] = []
        self.path: List[int] = []              # node id per executed step
        self._terminated = False
        self.truncated = False                 # ended by the context cap,
        self._rt_ctx = 0                       # not by the graph/callback
        self._cum: List[float] = [self.prefix_tokens]
        self._succs: Dict[int, List[Tuple[int, float]]] = {}
        self._nominal: Optional[List[Step]] = None
        self._aeg: Optional[AEG] = None
        if program.kind == "graph":
            for u, v, p in program.edges:
                self._succs.setdefault(u, []).append((v, p))
            tools = {nid: s.tool for nid, s in program.nodes.items()}
            self._aeg = AEG.from_edges(tools, program.edges)
            self._materialize(program.nodes[program.entry], program.entry)
        elif program.kind == "dynamic":
            first = program.next_step_fn(self._ctx(-1, []))
            if first is None:
                raise ValueError(
                    f"dynamic program {self.task_id}: first callback "
                    f"returned None (a program needs >= 1 step)")
            self._materialize(first, 0)
        else:                                  # scripted
            raw = getattr(program, "_raw_steps", None)
            raw_rt = getattr(program, "_raw_rt_steps", None)
            if raw is not None and vocab is None:
                # Task adapter on the simulator: share the Step objects
                # so execution is bit-identical to the pre-API path
                self.steps = raw
                self.path = list(range(len(raw)))
            elif raw is not None:
                # Task adapter on the serving runtime: realize token
                # ids from the realization stream; the context cap
                # truncates (flagged) rather than crashing mid-run
                for s in raw:
                    ids = [self._rng_real.randrange(1, vocab)
                           for _ in range(max(1,
                                              int(round(s.new_prompt_tokens))))]
                    n_out = max(1, int(round(s.out_tokens)))
                    if self._max_ctx is not None and \
                            self._rt_ctx + len(ids) + n_out > self._max_ctx:
                        if not self.steps:
                            raise ValueError(
                                f"program {self.task_id}: first step "
                                f"({len(ids)}+{n_out} tokens) does not "
                                f"fit max_ctx={self._max_ctx}")
                        self._terminated = True
                        self.truncated = True
                        break
                    self._rt_ctx += len(ids) + n_out
                    self.steps.append(s)
                    self.rt_steps.append((ids, n_out, s.tool,
                                          s.tool_latency_s))
                    self.path.append(len(self.path))
            elif raw_rt is not None:           # AgentRequest adapter
                for p, n, tool, gap in raw_rt:
                    self.steps.append(Step(float(len(p)), float(n), tool,
                                           0.0, float(gap)))
                self.rt_steps = raw_rt
                self.path = list(range(len(raw_rt)))
            else:
                for i, spec in enumerate(program.steps):
                    self._materialize(spec, i)

    # -- materialization -------------------------------------------------
    def _ctx(self, step_idx: int, outputs: Sequence[object]
             ) -> DynamicContext:
        last_tool = self.steps[step_idx].tool if 0 <= step_idx else ""
        last_obs = self.steps[step_idx].obs_tokens if 0 <= step_idx \
            else 0.0
        return DynamicContext(step_idx, self.steps, outputs, last_tool,
                              last_obs, self._rng_path)

    def _materialize(self, spec: StepSpec, node_id: int) -> bool:
        """Realize one StepSpec as the next executed step.  Returns
        False (and terminates the workflow) when the runtime context cap
        would be exceeded — the realization-side twin of the graph's
        ``max_steps`` cycle guard."""
        gap = spec.tool_latency_s
        if gap is None:
            gap = sample_tool_latency(spec.tool, self._rng_real)
            if self._max_gap_s is not None:
                gap = min(gap, self._max_gap_s)
        step = Step(spec.sim_prompt_tokens(), spec.sim_out_tokens(),
                    spec.tool, spec.obs_tokens, gap)
        if self._vocab is not None:
            ids = spec.prompt_ids
            if ids is None:
                ids = [self._rng_real.randrange(1, self._vocab)
                       for _ in range(spec.rt_n_prompt())]
            n_out = spec.rt_n_out()
            if self._max_ctx is not None and \
                    self._rt_ctx + len(ids) + n_out > self._max_ctx:
                if not self.steps:
                    raise ValueError(
                        f"program {self.task_id}: first step "
                        f"({len(ids)}+{n_out} tokens) does not fit "
                        f"max_ctx={self._max_ctx}")
                # flagged: a truncated run's taken path is a PREFIX of
                # the unconstrained path, so cross-substrate path
                # identity only holds while ``truncated`` is False
                self._terminated = True
                self.truncated = True
                return False
            self._rt_ctx += len(ids) + n_out
            self.rt_steps.append((list(ids), n_out, spec.tool, gap))
        self.steps.append(step)
        self.path.append(node_id)
        return True

    # -- advancement (the park-boundary resolver) ------------------------
    def resolve_next(self, i: int,
                     outputs: Optional[Sequence[object]] = None
                     ) -> Optional[Step]:
        if i + 1 < len(self.steps):
            return self.steps[i + 1]           # memoized (fault retry)
        if self._terminated or i + 1 >= self.program.max_steps:
            self._terminated = True
            return None
        kind = self.program.kind
        if kind == "scripted":
            self._terminated = True            # all steps prematerialized
            return None
        if kind == "graph":
            node = self.path[i]
            succs = self._succs.get(node, ())
            u = self._rng_path.random()
            acc = 0.0
            for v, p in succs:
                acc += p
                if u < acc:
                    if self._materialize(self.program.nodes[v], v):
                        return self.steps[-1]
                    return None
            self._terminated = True            # residual mass: finish
            return None
        if outputs is None:
            # simulator-side default: the economics view of each
            # executed step's output (the runtime passes real token ids)
            outputs = [s.out_tokens for s in self.steps[:i + 1]]
        spec = self.program.next_step_fn(self._ctx(i, outputs))
        if spec is None:
            self._terminated = True
            return None
        if self._materialize(spec, i + 1):
            return self.steps[-1]
        return None

    def next_node_hint(self, step_idx: int) -> Optional[int]:
        """AEG node id of materialized step ``step_idx`` for graph
        programs (the taken edge, threaded into the coordinator), None
        for scripted/dynamic (legacy linear advancement)."""
        if self.program.kind != "graph" or step_idx >= len(self.path):
            return None
        return self.path[step_idx]

    # -- Task-shaped simulator surface -----------------------------------
    @property
    def n_steps(self) -> int:
        return len(self.steps)

    def _ensure_cum(self) -> List[float]:
        cum = self._cum
        while len(cum) < len(self.steps) + 1:
            s = self.steps[len(cum) - 1]
            cum.append(cum[-1] + (s.new_prompt_tokens + s.out_tokens +
                                  s.obs_tokens))
        return cum

    def context_after(self, step_idx: int) -> float:
        return self._ensure_cum()[step_idx + 1]

    def context_before(self, step_idx: int) -> float:
        return self._ensure_cum()[step_idx] + \
            self.steps[step_idx].new_prompt_tokens

    def tools(self) -> List[str]:
        return [s.tool for s in self.nominal_steps()]

    # -- planning estimates ----------------------------------------------
    def nominal_steps(self) -> List[Step]:
        """Expected path for admission-time estimates (deadline, Eq. 9
        work, ideal time).  Scripted: the actual steps.  Graph: the
        max-probability path (capped at ``max_steps``), median-latency
        where unspecified.  Dynamic: the ``planned_tools`` hint with
        default economics, or a single default step.  Never consumes
        instance RNG state — estimates must not perturb the path."""
        if self.program.kind == "scripted":
            return self.steps
        if self._nominal is not None:
            return self._nominal
        out: List[Step] = []
        if self.program.kind == "graph":
            for node in self._nominal_path():
                out.append(self._nominal_step(self.program.nodes[node]))
        else:
            tools = self.program.planned_tools or ["unknown"]
            for t in tools:
                lat = _median_latency(t) if t in TOOL_LATENCY_TABLE \
                    else 1.0
                out.append(Step(300.0, 150.0, t, 600.0, lat))
        self._nominal = out
        return out

    def _nominal_path(self) -> List[int]:
        """Max-probability node walk, discounted by edge mass: stop once
        the probability of still being in the workflow drops below 0.5
        (so low-probability cycles — retry loops, self-loops — don't
        inflate the estimate to ``max_steps``)."""
        nodes, mass = [self.program.entry], 1.0
        while len(nodes) < self.program.max_steps:
            succs = self._succs.get(nodes[-1], ())
            if not succs:
                break
            mass *= sum(p for _, p in succs)
            if mass < 0.5:
                break
            nodes.append(max(succs, key=lambda vp: vp[1])[0])
        return nodes

    def _nominal_step(self, spec: StepSpec) -> Step:
        lat = spec.tool_latency_s
        if lat is None:
            lat = _median_latency(spec.tool)
            if self._max_gap_s is not None:
                lat = min(lat, self._max_gap_s)
        return Step(spec.sim_prompt_tokens(), spec.sim_out_tokens(),
                    spec.tool, spec.obs_tokens, lat)

    def nominal_rt_counts(self) -> List[Tuple[int, int, str]]:
        """(n_prompt, n_out, tool) per nominal step — the runtime's
        admission-time work estimate.  For scripted programs these are
        the exact realized counts."""
        if self.program.kind == "scripted" and self.rt_steps:
            return [(len(p), n, t) for p, n, t, _ in self.rt_steps]
        out = []
        if self.program.kind == "graph":
            return [(self.program.nodes[n].rt_n_prompt(),
                     self.program.nodes[n].rt_n_out(),
                     self.program.nodes[n].tool)
                    for n in self._nominal_path()]
        return [(max(1, int(round(s.new_prompt_tokens))),
                 max(1, int(round(s.out_tokens))), s.tool)
                for s in self.nominal_steps()]

    def declared_aeg(self) -> Optional[AEG]:
        """The client-declared AEG (tier-a observability) — graph
        programs only."""
        return self._aeg

    # -- runtime surface -------------------------------------------------
    def rt_step(self, i: int) -> Tuple[List[int], int, str, float]:
        return self.rt_steps[i]


def as_instance(obj, *, vocab: Optional[int] = None,
                max_ctx_tokens: Optional[int] = None,
                max_gap_s: Optional[float] = None) -> WorkflowInstance:
    """Normalize any submission format to a fresh WorkflowInstance:
    AgentProgram -> instantiate; Task / AgentRequest -> scripted adapter
    (byte-identical execution); an existing instance passes through."""
    if isinstance(obj, WorkflowInstance):
        return obj
    if isinstance(obj, AgentProgram):
        return obj.instantiate(vocab=vocab, max_ctx_tokens=max_ctx_tokens,
                               max_gap_s=max_gap_s)
    if hasattr(obj, "task_id"):               # cluster.workload.Task
        return AgentProgram.from_task(obj).instantiate(
            vocab=vocab, max_ctx_tokens=max_ctx_tokens,
            max_gap_s=max_gap_s)
    if hasattr(obj, "session_id"):            # serving AgentRequest
        return AgentProgram.from_request(obj).instantiate(
            vocab=vocab, max_ctx_tokens=max_ctx_tokens,
            max_gap_s=max_gap_s)
    raise TypeError(f"cannot submit {type(obj).__name__} as a workflow")
