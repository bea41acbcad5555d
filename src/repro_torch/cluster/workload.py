"""Agent workload generators (paper §9.1).

Three sources:
  * SWE-bench: 500 verified tasks, mean 37 steps (max 150); each step
    2-4K prompt tokens, 100-500 output tokens; code/file/db/web tools.
  * WebArena: 812 tasks, mean 18 steps; 4-8K prompt (page content),
    50-200 output tokens; web-heavy tools.
  * BurstGPT-derived multi-tenant: 10 tenants — 3 heavy (100-step,
    16 tasks/min), 4 medium (30-step, 8/min), 3 light (10-step, 4/min),
    Poisson arrivals (§9.1 "Workloads").

Tool latencies are log-normal fits of Table 1 (P50/P95/P99).
"""
from __future__ import annotations

import math
import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

# Table 1: (P50 s, P95 s, P99 s)
TOOL_LATENCY_TABLE = {
    "code_execution": (0.180, 2.400, 28.000),
    "file_operations": (0.045, 0.320, 1.200),
    "web_api": (0.850, 4.500, 45.000),
    "database_query": (0.120, 0.890, 3.500),
}
Z95, Z99 = 1.6448536, 2.3263479


def lognormal_params(tool: str) -> tuple:
    """(mu, sigma) matching the table's median; sigma averages the
    P95- and P99-implied spreads (the empirical tail is heavy)."""
    p50, p95, p99 = TOOL_LATENCY_TABLE[tool]
    mu = math.log(p50)
    s95 = math.log(p95 / p50) / Z95
    s99 = math.log(p99 / p50) / Z99
    return mu, 0.5 * (s95 + s99)


def sample_tool_latency(tool: str, rng: random.Random,
                        cv_scale: float = 1.0) -> float:
    mu, sigma = lognormal_params(tool)
    return math.exp(mu + sigma * cv_scale * rng.gauss(0, 1))


@dataclass
class Step:
    new_prompt_tokens: float     # tokens appended before this LLM call
    out_tokens: float
    tool: str                    # tool invoked after this step
    obs_tokens: float            # observation appended by the tool
    tool_latency_s: float


@dataclass
class Task:
    task_id: str
    tenant: str
    workload: str                # swebench | webarena | burstgpt
    arrival_s: float
    steps: List[Step]
    prefix_tokens: float = 1200.0   # shared system prompt + tool defs
    # lazily-built cumulative token sums: context queries are O(1), not
    # an O(n) prefix walk per call (which made the simulator's per-step
    # context lookups O(n^2) over a 150-step SWE-bench task).  Rebuilt
    # if the step list's length changes; steps are treated as immutable
    # once queried (every generator here constructs them up front).
    _cum: Optional[List[float]] = field(default=None, init=False,
                                        repr=False, compare=False)

    @property
    def n_steps(self) -> int:
        return len(self.steps)

    def _cumsum(self) -> List[float]:
        cum = self._cum
        if cum is None or len(cum) != len(self.steps) + 1:
            c = self.prefix_tokens
            cum = [c]
            # same accumulation order as the original per-call loop, so
            # every query is bit-identical to the O(n) path it replaces
            for s in self.steps:
                c = c + (s.new_prompt_tokens + s.out_tokens +
                         s.obs_tokens)
                cum.append(c)
            self._cum = cum
        return cum

    def context_after(self, step_idx: int) -> float:
        """Context tokens right after step step_idx's tool returns."""
        return self._cumsum()[step_idx + 1]

    def context_before(self, step_idx: int) -> float:
        return self._cumsum()[step_idx] + \
            self.steps[step_idx].new_prompt_tokens

    def tools(self) -> List[str]:
        return [s.tool for s in self.steps]


# ---------------------------------------------------------------------------
_SWE_TOOLS = (["code_execution"] * 45 + ["file_operations"] * 35 +
              ["database_query"] * 10 + ["web_api"] * 10)
_WEB_TOOLS = (["web_api"] * 80 + ["file_operations"] * 10 +
              ["database_query"] * 10)


def _n_steps(rng: random.Random, mean: int, max_steps: int) -> int:
    # log-normal step counts: long tail to max_steps (paper: mean 37/150)
    mu = math.log(mean) - 0.18
    n = int(round(math.exp(mu + 0.6 * rng.gauss(0, 1))))
    return max(2, min(max_steps, n))


def make_task(task_id: str, tenant: str, workload: str, arrival: float,
              rng: random.Random, n_steps: Optional[int] = None,
              cv_scale: float = 1.0) -> Task:
    if workload == "webarena":
        n = n_steps or _n_steps(rng, 18, 60)
        tools = _WEB_TOOLS
        prompt_rng = (600, 1200)       # page deltas appended per step
        first_prompt = (4000, 8000)
        out_rng = (50, 200)
        obs_rng = (400, 1600)
    elif workload == "burstgpt":
        # API-style agent traffic: shorter per-step deltas, long chains
        n = n_steps or _n_steps(rng, 30, 120)
        tools = _SWE_TOOLS
        prompt_rng = (80, 300)
        first_prompt = (1500, 3000)
        out_rng = (80, 300)
        obs_rng = (100, 700)
    else:                               # swebench-like
        n = n_steps or _n_steps(rng, 37, 150)
        tools = _SWE_TOOLS
        prompt_rng = (150, 500)
        first_prompt = (2000, 4000)
        out_rng = (100, 500)
        # SWE-bench observations are big (test logs, diffs, file dumps):
        # contexts grow 2-4K -> 16-128K over a task (paper §2.1)
        obs_rng = (300, 3000)
    steps = []
    for i in range(n):
        tool = rng.choice(tools)
        steps.append(Step(
            new_prompt_tokens=rng.uniform(*(first_prompt if i == 0
                                            else prompt_rng)),
            out_tokens=rng.uniform(*out_rng),
            tool=tool,
            obs_tokens=rng.uniform(*obs_rng),
            tool_latency_s=sample_tool_latency(tool, rng, cv_scale),
        ))
    return Task(task_id, tenant, workload, arrival, steps)


def poisson_arrivals(rate_per_min: float, horizon_s: float,
                     rng: random.Random) -> List[float]:
    if rate_per_min <= 0.0 or horizon_s <= 0.0:
        # zero offered load is a valid workload knob (e.g. disabling a
        # tenant class in a sweep); it used to ZeroDivisionError inside
        # expovariate
        return []
    out, t = [], 0.0
    lam = rate_per_min / 60.0
    while True:
        t += rng.expovariate(lam)
        if t > horizon_s:
            return out
        out.append(t)


def swebench_workload(n_tasks: int = 500, rate_per_min: float = 8.0,
                      seed: int = 0, cv_scale: float = 1.0) -> List[Task]:
    """§9.2: single-tenant replay under a Poisson schedule (~8 tasks/min)."""
    rng = random.Random(seed)
    horizon = n_tasks / (rate_per_min / 60.0) * 1.2
    arr = poisson_arrivals(rate_per_min, horizon, rng)[:n_tasks]
    return [make_task(f"swe-{i}", "tenant0", "swebench", t, rng,
                      cv_scale=cv_scale)
            for i, t in enumerate(arr)]


def webarena_workload(n_tasks: int = 812, rate_per_min: float = 8.0,
                      seed: int = 0, cv_scale: float = 1.0) -> List[Task]:
    rng = random.Random(seed + 1)
    horizon = n_tasks / (rate_per_min / 60.0) * 1.2
    arr = poisson_arrivals(rate_per_min, horizon, rng)[:n_tasks]
    return [make_task(f"web-{i}", "tenant0", "webarena", t, rng,
                      cv_scale=cv_scale)
            for i, t in enumerate(arr)]


def scale_workload(n_workers: int, tasks_per_worker: float = 2.0,
                   seed: int = 0, horizon_s: float = 600.0,
                   n_steps: int = 8, burst_frac: float = 0.0,
                   burst_window_s: float = 30.0) -> List[Task]:
    """Cluster-scale driver for the schedulers' hot paths (the 256-worker
    ``benchmarks/scale_sweep.py``): short fixed-length swebench-style
    tasks at an aggregate arrival rate proportional to cluster size, so
    per-worker pressure — and therefore queue depth, the thing the heap
    queues are meant to handle — stays constant as workers grow.

    ``burst_frac`` > 0 front-loads that fraction of the tasks uniformly
    into the first ``burst_window_s`` seconds (adversarial arrival
    spike: queues build cluster-wide, the regime straggler/preemption
    chaos is meant to stress)."""
    rng = random.Random(seed + 3)
    n_tasks = int(n_workers * tasks_per_worker)
    n_burst = int(n_tasks * burst_frac)
    burst = sorted(rng.uniform(0.0, burst_window_s)
                   for _ in range(n_burst))
    rate = max(n_tasks - n_burst, 1) / (horizon_s / 60.0)
    arr = burst + poisson_arrivals(rate, horizon_s * 1.5,
                                   rng)[:n_tasks - n_burst]
    arr.sort()
    return [make_task(f"scale-{i}", f"tenant{i % 8}", "burstgpt", t, rng,
                      n_steps=n_steps)
            for i, t in enumerate(arr)]


def runtime_requests(n_sessions: int = 16, vocab: int = 512,
                     seed: int = 0,
                     mix: Sequence[str] = ("swebench", "webarena",
                                           "burstgpt"),
                     n_steps: int = 4, max_ctx: int = 224,
                     arrival_window_s: float = 2.0,
                     token_scale: float = 1.0 / 64.0,
                     max_gap_s: float = 20.0) -> List:
    """Trace-driven agent mixes emitted as SERVING-RUNTIME requests.

    Draws SWE-bench / WebArena / BurstGPT-style task structures from
    ``make_task`` (step counts, tool sequences, Table-1 tool latencies)
    and scales the token economics down by ``token_scale`` so the steps
    run as REAL forward passes on the micro model: each step's prompt
    (previous tool observation + new turn) becomes actual token ids,
    contexts are capped at ``max_ctx`` so every session fits a slot.
    Deterministic for a given seed across processes (one seeded
    ``random.Random``, no builtin ``hash``)."""
    # lazy: repro_torch.serving pulls jax, which simulator-only users of this
    # module never need
    from repro_torch.serving.runtime import AgentRequest

    if max_ctx < 16:
        raise ValueError(f"max_ctx={max_ctx} too small for 2-step tasks")
    rng = random.Random(seed + 11)
    reqs: List = []
    for i in range(n_sessions):
        kind = mix[i % len(mix)]
        task = make_task(f"rt-{kind[:3]}-{i}", f"tenant{i % 4}", kind,
                         rng.uniform(0.0, arrival_window_s), rng,
                         n_steps=n_steps)
        steps: List = []
        ctx = 0
        prev_obs = 0.0
        for s in task.steps:
            n_prompt = max(2, int((s.new_prompt_tokens + prev_obs)
                                  * token_scale))
            n_out = max(1, min(8, int(s.out_tokens * token_scale)))
            if ctx + n_prompt + n_out > max_ctx:
                break
            prompt = [rng.randrange(1, vocab) for _ in range(n_prompt)]
            steps.append((prompt, n_out, s.tool,
                          min(s.tool_latency_s, max_gap_s)))
            ctx += n_prompt + n_out
            prev_obs = s.obs_tokens
        if len(steps) < 2:         # degenerate draw (huge first prompt):
            # replace with a minimal 2-step task that respects max_ctx
            steps = [([rng.randrange(1, vocab) for _ in range(4)],
                      2, "file_operations", 0.1) for _ in range(2)]
        reqs.append(AgentRequest(task.task_id, task.tenant, steps,
                                 arrival_s=task.arrival_s))
    return reqs


# --- branching AgentProgram generators (repro_torch.workflow) --------------------
def swebench_retry_programs(n_programs: int = 16, rate_per_min: float = 4.0,
                            seed: int = 0, retry_p: float = 0.25,
                            n_nodes: int = 10, p_term: float = 0.02,
                            max_steps: int = 48) -> List:
    """SWE-bench-style mix as GRAPH AgentPrograms with executable retry
    loops: a chain of edit/test nodes where every ``code_execution``
    node carries a backward retry edge (test failed -> re-edit) taken
    with probability ``retry_p``.  The declared AEG reaches the
    coordinator at admission (tier-a), so reuse probability, prefetch
    targeting and Eq. 9 work estimates see the true loop structure —
    and the loops actually execute via each program's seeded resolver."""
    # lazy: repro_torch.workflow imports this module at top level
    from repro_torch.workflow.program import AgentProgram, StepSpec

    rng = random.Random(seed + 7)
    horizon = n_programs / max(rate_per_min / 60.0, 1e-9) * 1.2
    arr = poisson_arrivals(rate_per_min, horizon, rng)[:n_programs]
    while len(arr) < n_programs:          # tail draws past the horizon
        arr.append((arr[-1] if arr else 0.0) + rng.uniform(1.0, 10.0))
    progs = []
    for i, t in enumerate(arr):
        nodes = {}
        edges = []
        for v in range(n_nodes):
            tool = rng.choice(_SWE_TOOLS)
            nodes[v] = StepSpec(
                tool,
                new_prompt_tokens=rng.uniform(150, 500),
                out_tokens=rng.uniform(100, 500),
                obs_tokens=rng.uniform(300, 3000),
                tool_latency_s=None)          # fresh draw per execution
            if v + 1 < n_nodes:
                retry = retry_p if tool == "code_execution" and v > 0 \
                    else 0.0
                edges.append((v, v + 1, (1.0 - p_term) * (1.0 - retry)))
                if retry > 0.0:
                    edges.append((v, v - 1, (1.0 - p_term) * retry))
        progs.append(AgentProgram.graph(
            f"swe-retry-{i}", f"tenant{i % 4}", nodes, edges,
            arrival_s=t, seed=seed * 1000 + i, max_steps=max_steps,
            prefix_tokens=1200.0, workload="swebench"))
    return progs


def webarena_branch_programs(n_programs: int = 16,
                             rate_per_min: float = 4.0, seed: int = 0,
                             nav_p: float = 0.55,
                             max_steps: int = 32) -> List:
    """WebArena-style conditional workflows: after the landing page the
    agent either NAVIGATES (browse-heavy subchain: big page deltas,
    web_api tools) or FILLS A FORM (form subchain: file/db lookups,
    small deltas), converging on a final submit node.  The branch is a
    real conditional edge pair resolved per program at run time, and
    both subchains are visible to the scheduler in the declared AEG."""
    from repro_torch.workflow.program import AgentProgram, StepSpec

    rng = random.Random(seed + 13)
    horizon = n_programs / max(rate_per_min / 60.0, 1e-9) * 1.2
    arr = poisson_arrivals(rate_per_min, horizon, rng)[:n_programs]
    while len(arr) < n_programs:
        arr.append((arr[-1] if arr else 0.0) + rng.uniform(1.0, 10.0))
    progs = []
    for i, t in enumerate(arr):
        def page(lo, hi, tool="web_api", obs=(400, 1600)):
            return StepSpec(tool, new_prompt_tokens=rng.uniform(lo, hi),
                            out_tokens=rng.uniform(50, 200),
                            obs_tokens=rng.uniform(*obs),
                            tool_latency_s=None)
        # 0: landing  1-3: nav subchain  4-5: form subchain  6: submit
        nodes = {0: page(4000, 8000),
                 1: page(600, 1200), 2: page(600, 1200),
                 3: page(600, 1200),
                 4: page(200, 500, "file_operations", (100, 400)),
                 5: page(150, 400, "database_query", (100, 400)),
                 6: page(300, 700)}
        edges = [(0, 1, nav_p), (0, 4, 0.97 - nav_p),        # the branch
                 (1, 2, 0.95), (2, 3, 0.95), (3, 6, 0.9),
                 (4, 5, 0.95), (5, 6, 0.9)]
        progs.append(AgentProgram.graph(
            f"web-branch-{i}", f"tenant{i % 4}", nodes, edges,
            arrival_s=t, seed=seed * 1000 + i, max_steps=max_steps,
            prefix_tokens=1200.0, workload="webarena"))
    return progs


def runtime_programs(n_sessions: int = 8, seed: int = 0,
                     retry_p: float = 0.35, n_nodes: int = 4,
                     max_steps: int = 10) -> List:
    """Branching graph programs sized for the serving runtime's micro
    models: small token counts, short tool gaps, a retry edge on the
    test node.  Prompt token ids are left unspecified — the runtime
    realizes them deterministically from each program's seed against
    the model's vocab."""
    from repro_torch.workflow.program import AgentProgram, StepSpec

    rng = random.Random(seed + 17)
    progs = []
    for i in range(n_sessions):
        nodes = {}
        edges = []
        for v in range(n_nodes):
            tool = rng.choice(_SWE_TOOLS)
            nodes[v] = StepSpec(tool,
                                new_prompt_tokens=float(rng.randint(6, 14)),
                                n_out=rng.randint(2, 4),
                                obs_tokens=float(rng.randint(4, 12)),
                                tool_latency_s=round(
                                    rng.uniform(0.05, 0.4), 3))
            if v + 1 < n_nodes:
                retry = retry_p if v == n_nodes - 2 else 0.0
                edges.append((v, v + 1, 0.98 * (1.0 - retry)))
                if retry > 0.0:
                    edges.append((v, max(v - 1, 0), 0.98 * retry))
        progs.append(AgentProgram.graph(
            f"rt-wf-{i}", f"tenant{i % 4}", nodes, edges,
            arrival_s=rng.uniform(0.0, 1.0), seed=seed * 100 + i,
            max_steps=max_steps, workload="runtime"))
    return progs


def burstgpt_workload(horizon_s: float = 1800.0, seed: int = 0,
                      load_factor: float = 0.5,
                      cv_scale: float = 1.0) -> List[Task]:
    """10 tenants: 3 heavy (100-step), 4 medium (30-step), 3 light
    (10-step).  ``load_factor`` scales the paper's nominal 16/8/4
    tasks/min/tenant so aggregate offered load sits at ~80% of the
    simulated cluster's peak throughput (the paper's stated operating
    point; the nominal rates are 'approximate' per §9.1)."""
    rng = random.Random(seed + 2)
    tasks: List[Task] = []
    tenant_specs = ([("heavy", 100, 16.0 * load_factor)] * 3 +
                    [("medium", 30, 8.0 * load_factor)] * 4 +
                    [("light", 10, 4.0 * load_factor)] * 3)
    for ti, (kind, steps, rate) in enumerate(tenant_specs):
        tenant = f"{kind}-{ti}"
        for j, t in enumerate(poisson_arrivals(rate, horizon_s, rng)):
            tasks.append(make_task(f"{tenant}-task{j}", tenant, "burstgpt",
                                   t, rng, n_steps=max(
                                       2, int(rng.gauss(steps, steps * 0.15))),
                                   cv_scale=cv_scale))
    tasks.sort(key=lambda t: t.arrival_s)
    return tasks
