"""Agent Fair Share scheduling (paper §6, Eq. 8-9, Theorem 2).

Definition 2:  AFS_i = sum_{t in T_i} work_remain(t) / (deadline(t) - now)

work_remain(t) (Eq. 9) sums estimated prefill+decode GPU-seconds over the
pending AEG nodes.  The epoch allocator (100 ms) assigns worker capacity
proportionally to AFS and triggers preemption when a low-AFS task blocks
a high-AFS task for > 500 ms — the preempted task's cache is migrated,
not discarded (§6.2), so WA-LRU predictions survive preemption (§3.1).

Theorem 2 (Lyapunov drift): urgency-proportional allocation is a
restoring force on the deviation e_i = S_i - mu_i * t; `lyapunov_v`
exposes V(t) = sum e_i^2 so tests/benches can verify the negative-drift
property empirically.

Incremental accumulation (delta-update invariants)
--------------------------------------------------
``recompute(now)`` runs every epoch over every pending task, so the
per-task (deadline, work, tenant-index) columns are *persistent*
capacity-doubled arrays maintained by O(1) delta updates instead of
being rebuilt on structural change:

  * ``add_task``      appends one row (amortized O(1); arrays double).
  * ``finish_task``   tombstones the row by zeroing its work column — a
    zero contribution is exact (``x + 0.0 == x`` bitwise), so finished
    rows never perturb the running bincount sums.
  * ``note_progress`` marks the row dirty; ``recompute`` flushes dirty
    rows (O(|dirty|)) before the vectorized slack math, coalescing any
    number of progress updates between epochs into one column write.
  * tombstones are compacted away once they outnumber live rows
    (amortized O(1) per op, order-preserving so sums stay bit-exact).

The slack/contribution reduction itself must touch every live row —
Eq. 8's ``deadline - now`` term changes for every task every tick — but
it stays a single vectorized ``bincount`` (C speed), and the Python-
loop column rebuild the old cached-column path performed on every
admission/finish is gone entirely.

Invariant: ``recompute(now) == recompute_full(now)`` bit-for-bit at any
interleaving of add/finish/progress events — ``recompute_full`` rebuilds
fresh columns from the live task dict and runs the identical math, and
``tests/test_faults.py::test_incremental_vs_full_afs_equivalence``
property-checks the equality.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Set

try:
    import numpy as np
except ImportError:          # pragma: no cover - numpy ships with repo
    np = None

_MIN_ROWS = 64               # initial column capacity / compaction floor


@dataclass
class TaskProgress:
    task_id: str
    tenant: str
    deadline: float
    work_remain_s: float          # Eq. 9 estimate (GPU-seconds)
    blocked_since: Optional[float] = None


@dataclass
class TenantState:
    tenant: str
    afs: float = 0.0
    service_s: float = 0.0        # cumulative GPU-seconds received (S_i)
    share: float = 0.0            # current epoch allocation fraction


class AFSScheduler:
    def __init__(self, epoch_s: float = 0.100,
                 preempt_block_s: float = 0.500):
        self.epoch_s = epoch_s
        self.preempt_block_s = preempt_block_s
        self.tenants: Dict[str, TenantState] = {}
        self.tasks: Dict[str, TaskProgress] = {}
        self.preemptions = 0
        # persistent vectorized columns (see module docstring)
        self._n = 0                       # used rows incl. tombstones
        self._live = 0                    # rows backing a pending task
        self._row_of: Dict[str, int] = {}
        self._dirty: Set[str] = set()     # task ids with unflushed work
        self._names: List[str] = []       # tenant order (first-seen)
        self._tpos: Dict[str, int] = {}
        if np is not None:
            self._deadlines = np.zeros(_MIN_ROWS)
            self._works = np.zeros(_MIN_ROWS)
            self._tidx = np.zeros(_MIN_ROWS, dtype=np.intp)

    # -- column maintenance ------------------------------------------------
    def _tenant_index(self, tenant: str) -> int:
        pos = self._tpos.get(tenant)
        if pos is None:
            pos = len(self._names)
            self._tpos[tenant] = pos
            self._names.append(tenant)
        return pos

    def _grow(self) -> None:
        cap = max(_MIN_ROWS, 2 * len(self._deadlines))
        for name in ("_deadlines", "_works", "_tidx"):
            old = getattr(self, name)
            new = np.zeros(cap, dtype=old.dtype)
            new[:self._n] = old[:self._n]
            setattr(self, name, new)

    def _compact(self) -> None:
        """Drop tombstoned rows once they outnumber live ones.  Keeps
        relative row order, so per-tenant bincount accumulation order —
        and therefore every bit of the shares — is unchanged."""
        keep = sorted(self._row_of.items(), key=lambda kv: kv[1])
        n = len(keep)
        for new_row, (tid, old_row) in enumerate(keep):
            self._deadlines[new_row] = self._deadlines[old_row]
            self._works[new_row] = self._works[old_row]
            self._tidx[new_row] = self._tidx[old_row]
            self._row_of[tid] = new_row
        self._n = n
        self._live = n

    def _flush_dirty(self) -> None:
        """Apply pending work-column deltas — O(|dirty|), the only rows
        ``recompute`` writes."""
        # sagalint: ok(det-set-order) each tid writes only its own row, so visit order cannot change the flushed column
        for tid in self._dirty:
            row = self._row_of.get(tid)
            if row is not None:
                t = self.tasks.get(tid)
                self._works[row] = t.work_remain_s if t is not None else 0.0
        self._dirty.clear()

    # -- registration ----------------------------------------------------
    def add_task(self, tp: TaskProgress) -> None:
        self.tasks[tp.task_id] = tp
        self.tenants.setdefault(tp.tenant, TenantState(tp.tenant))
        if np is None:
            return
        pos = self._tenant_index(tp.tenant)
        if self._n >= len(self._deadlines):
            self._grow()
        row = self._n
        self._n += 1
        self._live += 1
        self._deadlines[row] = tp.deadline
        self._works[row] = tp.work_remain_s
        self._tidx[row] = pos
        self._row_of[tp.task_id] = row

    def finish_task(self, task_id: str) -> None:
        if self.tasks.pop(task_id, None) is None:
            return
        self._dirty.discard(task_id)
        if np is None:
            return
        row = self._row_of.pop(task_id, None)
        if row is not None:
            # tombstone: a zero contribution is exact (x + 0.0 == x)
            self._works[row] = 0.0
            self._live -= 1
            if self._n > _MIN_ROWS and self._n > 2 * self._live:
                self._compact()

    def note_service(self, tenant: str, gpu_seconds: float) -> None:
        if tenant not in self.tenants:
            self.tenants[tenant] = TenantState(tenant)
            if np is not None:
                self._tenant_index(tenant)
        self.tenants[tenant].service_s += gpu_seconds

    def note_progress(self, task_id: str, work_done_s: float) -> None:
        t = self.tasks.get(task_id)
        if t:
            t.work_remain_s = max(0.0, t.work_remain_s - work_done_s)
            if np is not None:     # scalar fallback has no columns to sync
                self._dirty.add(task_id)

    def set_work(self, task_id: str, work_s: float) -> None:
        """Replace a task's Eq. 9 work-remaining estimate outright (the
        coordinator re-derives it from the declared AEG's branch
        structure each step).  Same dirty-row protocol as
        ``note_progress`` — flushed O(|dirty|) on the next epoch."""
        t = self.tasks.get(task_id)
        if t:
            t.work_remain_s = max(0.0, work_s)
            if np is not None:
                self._dirty.add(task_id)

    def refund_work(self, task_id: str, work_s: float) -> None:
        """Return previously-charged progress to a task's Eq. 9
        work-remaining estimate: a fault cancelled the step mid-attempt,
        so the partial progress noted when the preemption parked it is
        un-done — the retried step re-runs in full and its priority must
        reflect that.  Same dirty-row protocol as ``note_progress``."""
        t = self.tasks.get(task_id)
        if t and work_s > 0.0:
            t.work_remain_s += work_s
            if np is not None:
                self._dirty.add(task_id)

    # -- Eq. 8 -------------------------------------------------------------
    def _accumulate(self, now: float) -> Dict[str, float]:
        """Per-tenant AFS numerators in tenant first-seen order."""
        if np is not None and self.tasks:
            self._flush_dirty()
            n = self._n
            slack = np.maximum(self._deadlines[:n] - now, self.epoch_s)
            acc_v = np.bincount(self._tidx[:n],
                                weights=self._works[:n] / slack,
                                minlength=len(self._names))
            return dict(zip(self._names, acc_v.tolist()))
        acc = dict.fromkeys(self.tenants, 0.0)
        eps = self.epoch_s
        for t in self.tasks.values():
            slack = t.deadline - now
            if slack < eps:
                slack = eps
            acc[t.tenant] += t.work_remain_s / slack
        return acc

    def _shares_from(self, acc: Dict[str, float],
                     write: bool = True) -> Dict[str, float]:
        total = 0.0
        for v in acc.values():
            if v > 0.0:
                total += v
        uniform = 1.0 / max(len(self.tenants), 1)
        shares: Dict[str, float] = {}
        for ten in self.tenants.values():
            afs = acc.get(ten.tenant, 0.0)
            share = (afs / total) if total > 0 else uniform
            if write:
                ten.afs = afs
                ten.share = share
            shares[ten.tenant] = share
        return shares

    def recompute(self, now: float) -> Dict[str, float]:
        """Epoch hot path: flush O(|dirty|) column writes, then one
        vectorized slack/bincount reduction (C speed) over the
        persistent columns.  No Python-loop rebuilds, ever."""
        return self._shares_from(self._accumulate(now), write=True)

    def recompute_full(self, now: float) -> Dict[str, float]:
        """Reference path: rebuild fresh columns from the live task dict
        and run the identical math.  Pure (does not touch tenant or
        column state) — the incremental path is regression-gated to
        match this bit-for-bit."""
        if np is not None and self.tasks:
            names = list(self.tenants)
            tpos = {k: i for i, k in enumerate(names)}
            deadlines = np.array([t.deadline for t in self.tasks.values()])
            works = np.array([t.work_remain_s
                              for t in self.tasks.values()])
            tidx = np.array([tpos[t.tenant] for t in self.tasks.values()],
                            dtype=np.intp)
            slack = np.maximum(deadlines - now, self.epoch_s)
            acc_v = np.bincount(tidx, weights=works / slack,
                                minlength=len(names))
            acc = dict(zip(names, acc_v.tolist()))
        else:
            acc = dict.fromkeys(self.tenants, 0.0)
            eps = self.epoch_s
            for t in self.tasks.values():
                slack = t.deadline - now
                if slack < eps:
                    slack = eps
                acc[t.tenant] += t.work_remain_s / slack
        return self._shares_from(acc, write=False)

    def priority(self, tenant: str) -> float:
        t = self.tenants.get(tenant)
        return t.afs if t else 0.0

    # -- preemption (§6.2 step 4) ------------------------------------------
    def deficit(self, blocked_tenant: str, running_tenant: str) -> float:
        """Fair-share deficit of a blocked tenant against a running one:
        the AFS-priority gap Eq. 8 says the allocator owes the blocked
        side.  The serving runtime preempts a running decode only when
        this exceeds its configured threshold (plus the blocked-time
        hysteresis in ``should_preempt``), so marginal inversions never
        thrash the decode batch."""
        return self.priority(blocked_tenant) - self.priority(running_tenant)

    def note_blocked(self, task_id: str, now: float) -> None:
        t = self.tasks.get(task_id)
        if t and t.blocked_since is None:
            t.blocked_since = now

    def note_unblocked(self, task_id: str) -> None:
        t = self.tasks.get(task_id)
        if t:
            t.blocked_since = None

    def should_preempt(self, blocked_task: str, blocking_task: str,
                       now: float) -> bool:
        b = self.tasks.get(blocked_task)
        lo = self.tasks.get(blocking_task)
        if b is None or lo is None or b.blocked_since is None:
            return False
        if now - b.blocked_since < self.preempt_block_s:
            return False
        if self.priority(b.tenant) <= self.priority(lo.tenant):
            return False
        self.preemptions += 1
        return True

    # -- Theorem 2 instrumentation ------------------------------------------
    def lyapunov_v(self, now: float, t0: float, capacity: float,
                   workloads: Dict[str, float]) -> float:
        """V(t) = sum_i (S_i(t) - mu_i * (t - t0))^2 with
        mu_i = W_i / sum_j W_j * C (proportional fair share)."""
        tot_w = sum(workloads.values()) or 1.0
        v = 0.0
        for ten, w in workloads.items():
            mu = w / tot_w * capacity
            s = self.tenants.get(ten, TenantState(ten)).service_s
            v += (s - mu * (now - t0)) ** 2
        return v
