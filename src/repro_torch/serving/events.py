"""Deterministic virtual-time event plumbing for the serving runtime.

The runtime (``repro_torch.serving.runtime``) interleaves many concurrent
agent sessions over real JAX engines.  Real compute (prefill, batched
decode, KV block copies) executes eagerly when an event is processed;
*time* is virtual — a seeded, reproducible clock advanced by the event
heap — so tool-call gaps cost nothing on the wall clock and two
identical-seed runs replay byte-identically even across processes with
different ``PYTHONHASHSEED``.

Two pieces live here:

  * ``EventLoop`` — a (time, seq, kind, args) min-heap.  ``seq`` is a
    global monotone counter, so same-timestamp events fire in schedule
    order: determinism never rests on float tie-breaking or object
    identity.  Handlers resolve by name (``_on_<kind>`` on the
    runtime); the vocabulary includes the disaggregated prefill-pool
    lifecycle (``pf_done`` — staging prefill finished, ``handoff_done``
    — cross-pool KV transfer landed), both attempt-stamped so faults
    make in-flight events stale rather than racy.
  * ``SessionQueue`` — a per-engine pending-session priority queue
    (AFS-ordered admission, §6), the serving twin of the simulator's
    ``StepQueue``: a lazy-deletion heap with tombstoned removal so the
    work stealer can extract an arbitrary victim session in O(n) scan /
    O(log n) amortized pop without rebuilding the heap.
"""
from __future__ import annotations

import heapq
import itertools
from typing import Iterator, List, Optional, Tuple


class EventLoop:
    """Virtual-time event heap.  ``pop`` advances ``now`` monotonically;
    scheduling in the past is clamped to ``now`` (a zero-latency event,
    still ordered after everything already scheduled at ``now``)."""

    __slots__ = ("now", "_heap", "_seq")

    def __init__(self, start: float = 0.0) -> None:
        self.now = start
        self._heap: List[Tuple[float, int, str, tuple]] = []
        self._seq = itertools.count()

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)

    def schedule(self, t: float, kind: str, args: tuple = ()) -> None:
        heapq.heappush(self._heap, (max(t, self.now), next(self._seq),
                                    kind, args))

    def peek_time(self) -> Optional[float]:
        return self._heap[0][0] if self._heap else None

    def pop(self) -> Tuple[float, str, tuple]:
        t, _, kind, args = heapq.heappop(self._heap)
        self.now = t
        return t, kind, args


class SessionQueue:
    """AFS-priority pending-session queue for one engine.

    Keyed ``(priority, enqueued_at, seq)`` — priority is the negated
    tenant AFS share at enqueue time (higher AFS drains first), FIFO
    within a tenant.  ``remove`` tombstones (work stealing extracts the
    oldest un-cooled session, which is rarely the heap head)."""

    __slots__ = ("_heap", "_live", "_seq")

    def __init__(self, seq: Optional[Iterator[int]] = None) -> None:
        self._heap: List[Tuple[float, float, int, "object"]] = []
        self._live = 0
        self._seq = seq if seq is not None else itertools.count()

    def __len__(self) -> int:
        return self._live

    def __bool__(self) -> bool:
        return self._live > 0

    def push(self, prio: float, enqueued_at: float, item) -> None:
        heapq.heappush(self._heap, (prio, enqueued_at, next(self._seq),
                                    item))
        self._live += 1

    def pop(self):
        h = self._heap
        while h and getattr(h[0][3], "cancelled", False):
            heapq.heappop(h)
        if not h:
            return None
        self._live -= 1
        return heapq.heappop(h)[3]

    def peek(self):
        """Highest-priority live item without removing it (the AFS
        preemption trigger inspects the blocked head).  Compacts dead
        heap heads as a side effect, like ``pop``."""
        h = self._heap
        while h and getattr(h[0][3], "cancelled", False):
            heapq.heappop(h)
        return h[0][3] if h else None

    def drain(self) -> List["object"]:
        """Remove and return every live item in heap (priority) order —
        the engine-failure requeue path."""
        items = []
        while True:
            item = self.pop()
            if item is None:
                return items
            items.append(item)

    def remove(self, session_id: str):
        """Tombstone and return the queued item for ``session_id`` (the
        steal path), or None."""
        for _, _, _, item in self._heap:
            if not item.cancelled and item.session_id == session_id:
                item.cancelled = True
                self._live -= 1
                return item
        return None

    def snapshot(self) -> List[Tuple[float, str]]:
        """(enqueued_at, session_id) oldest-first — the work stealer's
        victim-queue view."""
        return sorted((enq, item.session_id)
                      for _, enq, _, item in self._heap
                      if not item.cancelled)


class _RuntimeQueueView:
    """Persistent stealer-facing view of one engine's SessionQueue (the
    serving twin of the simulator's ``_QueueView``): O(1) emptiness, the
    sorted dump built only if the stealer actually picked this engine as
    the victim.  Holds a getter, not the queue, so queue swaps stay
    visible."""

    __slots__ = ("_get",)

    def __init__(self, get_queue) -> None:
        self._get = get_queue

    def __len__(self) -> int:
        return len(self._get())

    def __bool__(self) -> bool:
        return bool(self._get())

    def __iter__(self):
        return iter(self._get().snapshot())
