"""The one traffic generator: closed populations of agent sessions.

A traffic mix (``spec.traffic_mix``) gives a closed population of agents
and the economics of their tasks; this module turns them into the tasks
each agent runs.  The economics of ``agent_sessions`` are a frozen
copy of ``repro_torch/cluster/workload.py`` at commit 3d2082b
(``make_task``'s per-step draws, ``_n_steps``, ``TOOL_LATENCY_TABLE`` with
``lognormal_params`` / ``sample_tool_latency``, and ``runtime_requests``'
turning of a task into runtime steps, here at ``token_scale`` 1 and with
no cap on the outputs), so a later change to that module cannot move the
yardstick.

The schedule does not depend on ``--seed``: the task pool is drawn from
the traffic file's ``pool_seed``, in rounds of one task per agent, and
agent ``a`` runs task ``a`` of each round.  The seed draws every token id
(and the harness the weights).  The runtime's scheduling reads no token
id, so every seed serves the same sizes in the same order on the virtual
clock, and runs of different seeds differ by their ids and weights and by
the wall clock alone.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
import random
from typing import Dict, List, Sequence, Tuple

import numpy as np

Z95, Z99 = 1.6448536, 2.3263479


@dataclasses.dataclass
class TaskPlan:
    """One task's sizes: per runtime step (prompt tokens, output tokens,
    tool, tool gap s).  ``join`` > 0 marks a task that enters the system
    mid-way: its first prompt is the history of the ``join`` steps before
    it plus that step's own prompt."""
    steps: List[Tuple[int, int, str, float]]
    join: int = 0


def _lognormal_params(quantiles: Sequence[float]) -> Tuple[float, float]:
    p50, p95, p99 = quantiles
    mu = math.log(p50)
    s95 = math.log(p95 / p50) / Z95
    s99 = math.log(p99 / p50) / Z99
    return mu, 0.5 * (s95 + s99)


def _n_steps(rng: random.Random, mean: int, max_steps: int) -> int:
    mu = math.log(mean) - 0.18
    n = int(round(math.exp(mu + 0.6 * rng.gauss(0, 1))))
    return max(2, min(max_steps, n))


def _task(t: Dict, rng: random.Random) -> TaskPlan:
    """``make_task`` (swebench economics when ``t`` holds them) then
    ``runtime_requests``' step construction: each step's prompt is its new
    tokens plus the previous tool's observation; the task ends where the
    next step would pass ``max_len``."""
    tools = [name for name, w in t["tools"].items() for _ in range(int(w))]
    n = _n_steps(rng, t["steps_mean"], t["steps_max"])
    raw = []
    for i in range(n):
        tool = rng.choice(tools)
        new = rng.uniform(*(t["first_prompt"] if i == 0 else t["prompt"]))
        out = rng.uniform(*t["out"])
        obs = rng.uniform(*t["obs"])
        mu, sigma = _lognormal_params(t["tool_latency_s"][tool])
        lat = math.exp(mu + sigma * rng.gauss(0, 1))
        raw.append((new, out, tool, obs, lat))
    steps, ctx, prev_obs = [], 0, 0.0
    for new, out, tool, obs, lat in raw:
        n_prompt = max(2, int(new + prev_obs))
        n_out = max(1, int(out))
        if ctx + n_prompt + n_out > t["max_len"]:
            break
        steps.append((n_prompt, n_out, tool, min(lat, t["max_gap_s"])))
        ctx += n_prompt + n_out
        prev_obs = obs
    return TaskPlan(steps)


def task_pool(t: Dict, n_agents: int) -> List[List[TaskPlan]]:
    """``tasks_per_agent`` rounds of ``n_agents`` tasks, from the traffic's
    ``pool_seed`` alone.  A task of the first round joins at a step drawn
    uniformly from its steps, so the first contexts are spread as in a
    steady state and not all at step 0."""
    if t.get("generator") != "agent_sessions":
        raise ValueError(f"unknown traffic generator {t.get('generator')!r}")
    rng = random.Random(int(t["pool_seed"]))
    rounds = []
    for r in range(int(t["tasks_per_agent"])):
        tasks = []
        for _ in range(n_agents):
            plan = _task(t, rng)
            while len(plan.steps) < 2:
                plan = _task(t, rng)
            if r == 0:
                plan.join = rng.randrange(len(plan.steps))
            tasks.append(plan)
        rounds.append(tasks)
    return rounds


def seed_int(*parts) -> int:
    """A 64-bit seed from any parts, the same in every process."""
    h = hashlib.sha256("/".join(str(p) for p in parts).encode()).digest()
    return int.from_bytes(h[:8], "little")


@dataclasses.dataclass
class AgentTask:
    """A task as submitted: its session id, its per-step prompt ids (the
    first one holding the joined history) and step tuples."""
    session_id: str
    prompts: List[np.ndarray]
    steps: List[Tuple[List[int], int, str, float]]


class Agents:
    """The closed population of one run: agent ``a`` runs task ``a`` of
    each round, one after another; ``task(a, r)`` builds that task's
    token ids (uniform over [1, vocab), drawn from ``seed``, the agent and
    the round, so in any order)."""

    def __init__(self, t: Dict, seed: int, vocab: int):
        self.n = int(t["n_agents"])
        self.rounds = task_pool(t, self.n)
        self.seed = seed
        self.vocab = vocab

    def task(self, a: int, r: int) -> AgentTask:
        plan = self.rounds[r][a]
        ids = np.random.default_rng(seed_int("ids", self.seed, a, r))
        prompts, steps = [], []
        j = plan.join
        hist = sum(p + o for p, o, _, _ in plan.steps[:j])
        for k, (n_prompt, n_out, tool, gap) in enumerate(plan.steps[j:]):
            n = n_prompt + (hist if k == 0 else 0)
            p = ids.integers(1, self.vocab, size=n, dtype=np.int64)
            prompts.append(p)
            steps.append((p.tolist(), n_out, tool, gap))
        return AgentTask(f"a{a:03d}.t{r}", prompts, steps)
