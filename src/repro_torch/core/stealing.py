"""Randomized work stealing with thrashing safeguards (paper §5.2).

Triggers: (1) a worker's queue empty for T_idle = 100 ms, or (2) the
max/min load ratio exceeds R_max = 2.0.

Steal protocol: idle worker w_i picks a victim w_j uniformly at random
among overloaded workers, takes the OLDEST pending session, migrates its
KV cache (Llumnix-style; mean 230 ms / P95 890 ms per Table 7), then
re-homes affinity to w_i.

Safeguards (§5.2): (a) both trigger conditions must hold simultaneously;
(b) a migrated session re-establishes affinity at the thief so a second
migration of the same session is structurally prevented (cooldown);
(c) migration is asynchronous at the source, and a stale steal request
arriving after the victim refilled is rejected at acceptance time.
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple


@dataclass
class StealDecision:
    thief: int
    victim: int
    session_id: str


class WorkStealer:
    def __init__(self, t_idle_s: float = 0.100, r_max: float = 2.0,
                 migration_cooldown_s: float = 5.0, seed: int = 0):
        self.t_idle = t_idle_s
        self.r_max = r_max
        self.cooldown = migration_cooldown_s
        self.rng = random.Random(seed)
        self.idle_since: Dict[int, float] = {}
        self.last_migrated: Dict[str, float] = {}
        # instrumentation
        self.steals = 0
        self.rejected_stale = 0

    def note_queue_state(self, worker: int, empty: bool, now: float) -> None:
        """Transition hook: ``idle_since`` *is* the indexed idle-worker
        set — a dict keyed by worker id holding the time its queue went
        empty.  O(1) membership add/remove; callers invoke it on
        queue-depth transitions (and the legacy per-epoch scan path
        refreshes it wholesale, which is idempotent)."""
        if empty:
            self.idle_since.setdefault(worker, now)
        else:
            self.idle_since.pop(worker, None)

    def _idle_ok(self, worker: int, now: float) -> bool:
        t0 = self.idle_since.get(worker)
        return t0 is not None and (now - t0) >= self.t_idle

    def maybe_steal(self, now: float, loads: Sequence[float],
                    queues: Sequence[Sequence[Tuple[float, str]]],
                    alive: Optional[Sequence[bool]] = None,
                    candidates: Optional[Sequence[int]] = None
                    ) -> Optional[StealDecision]:
        """queues[w] = [(enqueue_time, session_id), ...] oldest-first.

        Returns a decision or None.  Safeguard (a): requires an idle
        thief AND a victim above the load-ratio threshold at the same
        instant.  ``alive`` masks dead workers out of both roles: a
        dead worker has an empty queue and so accrues idle time, but
        stealing onto it would strand the session forever.

        Thieves come from the indexed idle set (``idle_since``), not a
        cluster-wide scan; ``candidates`` optionally restricts the
        victim scan to workers known to have pending work (the
        simulator passes its nonempty-queue index), making the whole
        call O(idle + nonempty) instead of O(n_workers).
        """
        n = len(loads)
        if candidates is not None and not candidates:
            return None        # no queue anywhere: nothing to steal

        def _ok(w: int) -> bool:
            return alive is None or (w < len(alive) and alive[w])

        idle = sorted(w for w, t0 in self.idle_since.items()
                      if w < n and _ok(w) and (now - t0) >= self.t_idle)
        if not idle:
            return None
        lo_load = loads.min() if hasattr(loads, "min") else min(loads)
        lo = max(float(lo_load), 1e-6)
        cand = sorted(candidates) if candidates is not None else range(n)
        overloaded = [w for w in cand
                      if _ok(w) and loads[w] / lo >= self.r_max
                      and queues[w]]
        if not overloaded:
            return None
        thief = min(idle, key=lambda w: loads[w])
        victim = self.rng.choice(overloaded)     # uniform random (Blumofe)
        # oldest pending session not under migration cooldown (safeguard b)
        for t_enq, sid in queues[victim]:
            if now - self.last_migrated.get(sid, -1e18) >= self.cooldown:
                self.steals += 1
                self.last_migrated[sid] = now
                # restart (don't evict) the thief's idle clock: its
                # queue is still empty, so under transition-driven
                # updates nothing would ever re-add it
                self.idle_since[thief] = now
                return StealDecision(thief, victim, sid)
        return None

    def accept(self, decision: StealDecision, victim_queue_len: int,
               now: float, thief_alive: bool = True) -> bool:
        """Safeguard (c): reject stale steals after the victim refilled
        below the imbalance threshold, or whose thief died, for callers
        where decision and acceptance are asynchronous (a real serving
        engine).  The simulator calls this in the same epoch tick as
        maybe_steal, so there the checks cannot fire — its genuinely
        asynchronous window is the KV transfer, handled by the
        dead-destination re-route in ``_on_migr_done``."""
        if victim_queue_len == 0 or not thief_alive:
            self.rejected_stale += 1
            return False
        return True
