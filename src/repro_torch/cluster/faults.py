"""Fault-tolerance & elasticity scenarios, shared across BOTH execution
substrates: plans are plain ``(t_seconds, kind, worker)`` triples
consumed by ``ClusterSim(fault_plan=...)`` (discrete-event simulator)
and ``ServingRuntime(fault_plan=...)`` (real-inference runtime, where a
"worker" is an ``Engine`` and a fail cancels in-flight attempts through
the attempt-stamped registry, reclaims slot KV, and releases real pool
blocks):

  ("fail", w)     worker w dies: queue requeued, KV lost, affinity dropped
  ("recover", w)  worker returns empty-cached
  ("scale_up", 0) elastic scale-out: a fresh worker joins
  ("slow", w)     worker w becomes a straggler (rates / slowdown factor)
  ("heal", w)     straggler returns to full speed

Also provides straggler injection (a slow worker = reduced rates), which
exercises the paper's own mitigation (work stealing, §5.2), and
preemption storms (spot-reclamation-style simultaneous mass kills).
Both substrates keep their conservation invariants (admitted ==
finished, zero slot/KV leak) and byte-identical identical-seed replay
under every plan here.
"""
from __future__ import annotations

import random
from typing import List, Tuple

Plan = List[Tuple[float, str, int]]


def crash_recover_plan(n_workers: int, horizon_s: float, n_faults: int = 2,
                       downtime_s: float = 120.0, seed: int = 0) -> Plan:
    rng = random.Random(seed)
    plan: Plan = []
    for _ in range(n_faults):
        w = rng.randrange(n_workers)
        t = rng.uniform(0.2, 0.6) * horizon_s
        plan.append((t, "fail", w))
        plan.append((t + downtime_s, "recover", w))
    return sorted(plan)


def elastic_plan(horizon_s: float, n_new_workers: int = 2) -> Plan:
    return [(horizon_s * (0.3 + 0.2 * i), "scale_up", 0)
            for i in range(n_new_workers)]


def chaos_plan(n_workers: int, horizon_s: float, n_events: int = 20,
               seed: int = 0, p_fail: float = 0.5,
               p_recover: float = 0.35, min_alive: int = 1) -> Plan:
    """Randomized fail/recover/scale-up schedule for chaos testing.

    Tracks cluster membership so the plan is always executable: only
    live workers fail, only dead workers recover, at least ``min_alive``
    workers stay up at every instant (a fully-dead cluster can make no
    progress, and the conservation tests require forward progress).
    Deterministic for a given seed — every choice draws from one
    ``random.Random`` and iterates sorted sets.
    """
    rng = random.Random(seed)
    alive = set(range(n_workers))
    dead: set = set()
    next_id = n_workers
    plan: Plan = []
    t = 0.0
    for _ in range(n_events):
        t += rng.uniform(0.02, 0.08) * horizon_s
        if t >= horizon_s:
            break
        r = rng.random()
        if r < p_fail and len(alive) > min_alive:
            w = rng.choice(sorted(alive))
            alive.discard(w)
            dead.add(w)
            plan.append((t, "fail", w))
        elif r < p_fail + p_recover and dead:
            w = rng.choice(sorted(dead))
            dead.discard(w)
            alive.add(w)
            plan.append((t, "recover", w))
        else:
            plan.append((t, "scale_up", 0))
            alive.add(next_id)
            next_id += 1
    return plan


def straggler_plan(n_workers: int, horizon_s: float, n_stragglers: int = 2,
                   slow_for_s: float = 120.0, seed: int = 0) -> Plan:
    """Transient stragglers: each picked worker serves at reduced rates
    (``ClusterSim.straggler_slowdown``) for ``slow_for_s``, then heals.
    Work stealing (§5.2) should drain the slow worker's queue onto
    healthy peers, bounding p99 TCT."""
    rng = random.Random(seed)
    plan: Plan = []
    # distinct workers: overlapping slow windows on one worker would be
    # cancelled early by the first heal (the sim keeps one factor per
    # worker), silently weakening the injected pressure
    for w in rng.sample(range(n_workers), min(n_stragglers, n_workers)):
        t = rng.uniform(0.15, 0.6) * horizon_s
        plan.append((t, "slow", w))
        plan.append((t + slow_for_s, "heal", w))
    return sorted(plan)


def preemption_storm_plan(n_workers: int, horizon_s: float,
                          n_storms: int = 2, kill_frac: float = 0.5,
                          downtime_s: float = 60.0, seed: int = 0,
                          min_alive: int = 1) -> Plan:
    """Spot-reclamation storms: at each storm instant a random
    ``kill_frac`` of the live workers fail *simultaneously* (mass
    in-flight cancellation + requeue onto the survivors), then recover
    together after ``downtime_s``.  At least ``min_alive`` workers stay
    up so the cluster can absorb the displaced work.  Storms are spaced
    so a storm never fires while the previous one's victims are still
    down (plans stay executable: only live workers fail)."""
    rng = random.Random(seed)
    plan: Plan = []
    gap = max((horizon_s * 0.6) / max(n_storms, 1), downtime_s * 1.5)
    t = 0.2 * horizon_s
    for _ in range(n_storms):
        if t >= horizon_s:
            break
        workers = list(range(n_workers))
        rng.shuffle(workers)
        n_kill = min(int(n_workers * kill_frac), n_workers - min_alive)
        for w in workers[:n_kill]:
            plan.append((t, "fail", w))
            plan.append((t + downtime_s, "recover", w))
        t += gap
    return sorted(plan)


class StragglerInjector:
    """Marks workers as stragglers by scaling their service rates.

    The simulator consults ``factor(w)`` when computing step durations;
    work stealing should drain the straggler's queue onto healthy
    workers, bounding p99 TCT.
    """

    def __init__(self, slow_workers: dict):
        # {worker_id: slowdown_factor>1}
        self.slow = dict(slow_workers)

    def factor(self, w: int) -> float:
        return self.slow.get(w, 1.0)
