"""Virtual-time span tracer (the observability tentpole's core).

A ``Span`` is one interval on the deterministic virtual clock, living
on a named *track* (``session/<sid>``, ``engine/<w>``, ``run``) with an
optional parent — ``begin``/``end`` build the per-session tree, and
``instant`` marks zero-duration events (preemption decisions, parks,
prefetch landings, fault-plan events, attempt cancellations).

Determinism contract: span ids come from one monotone counter in event
order, every container is a list or an insertion-ordered dict keyed by
ints/strings (never ``id()``), and no wall clock is ever read — so two
identical-seed runs emit byte-identical ``canonical_bytes()`` even
across processes with different ``PYTHONHASHSEED``.  The tracer only
*records*; it never feeds a value back into scheduling, which is what
keeps a traced run's ``summarize()`` byte-identical to the untraced
run (asserted by the traced CI smoke leg).

Conservation: a well-hooked substrate closes every span it opens —
``check_closed()`` raises listing any still-open span, and the
trace-conservation test suite reconciles span counts against event
counts under chaos plans (a cancelled attempt must close its spans
with ``status="cancelled"``, not leak them).
"""
from __future__ import annotations

import dataclasses
import itertools
import json
from typing import Dict, List, Optional

ROOT = -1                       # parent_id of top-level spans


@dataclasses.dataclass
class Span:
    """One virtual-time interval (or instant) on a track.

    ``status`` is ``"open"`` until ``end`` stamps the outcome: ``"ok"``
    for the normal path, or an explicit abnormal exit — ``"cancelled"``
    (fault killed the attempt), ``"preempted"`` (AFS parked the decode
    mid-step), ``"stolen"`` (left the queue for migration),
    ``"requeued"`` (engine failure drained the queue).  Instants are
    born closed."""
    span_id: int
    parent_id: int
    track: str
    name: str
    t0: float
    t1: float = -1.0
    status: str = "open"
    kind: str = "span"          # "span" | "instant"
    meta: Dict[str, object] = dataclasses.field(default_factory=dict)

    @property
    def dur(self) -> float:
        return max(0.0, self.t1 - self.t0)

    @property
    def closed(self) -> bool:
        return self.status != "open"

    def to_json(self) -> dict:
        return {
            "span_id": self.span_id, "parent_id": self.parent_id,
            "track": self.track, "name": self.name,
            "t0": self.t0, "t1": self.t1, "status": self.status,
            "kind": self.kind, "meta": dict(self.meta),
        }


class Tracer:
    """Append-only span recorder on the virtual clock."""

    def __init__(self) -> None:
        self.spans: List[Span] = []
        self._by_id: Dict[int, Span] = {}
        # insertion-ordered open-span registry (a dict, not a set: the
        # iteration order of check_closed's error message is part of
        # the determinism contract)
        self._open: Dict[int, None] = {}
        self._next = itertools.count()

    def __len__(self) -> int:
        return len(self.spans)

    # -- recording ------------------------------------------------------
    def begin(self, track: str, name: str, t: float,
              parent: int = ROOT, **meta) -> int:
        sp = Span(next(self._next), parent, track, name, float(t),
                  meta=dict(meta))
        self.spans.append(sp)
        self._by_id[sp.span_id] = sp
        self._open[sp.span_id] = None
        return sp.span_id

    def end(self, span_id: int, t: float, status: str = "ok",
            **meta) -> Span:
        sp = self._by_id[span_id]
        if sp.closed:
            raise ValueError(
                f"span {span_id} ({sp.track}/{sp.name}) ended twice: "
                f"already {sp.status!r}")
        # a cancellation can land before a future-dated phase would
        # have started (serialized prefill pipeline): clamp, never a
        # negative duration
        sp.t1 = max(float(t), sp.t0)
        sp.status = status
        sp.meta.update(meta)
        del self._open[span_id]
        return sp

    def instant(self, track: str, name: str, t: float,
                parent: int = ROOT, **meta) -> int:
        sp = Span(next(self._next), parent, track, name, float(t),
                  t1=float(t), status="ok", kind="instant",
                  meta=dict(meta))
        self.spans.append(sp)
        self._by_id[sp.span_id] = sp
        return sp.span_id

    def complete(self, track: str, name: str, t0: float, t1: float,
                 parent: int = ROOT, **meta) -> int:
        """Record an already-finished interval in one call (decode-round
        spans, whose bounds are both known at the round event)."""
        sid = self.begin(track, name, t0, parent=parent, **meta)
        self.end(sid, t1)
        return sid

    def note(self, span_id: int, **meta) -> None:
        """Attach late metadata to a live or closed span (e.g. the
        first-token time learned one decode round after the span
        began)."""
        self._by_id[span_id].meta.update(meta)

    # -- inspection -----------------------------------------------------
    def get(self, span_id: int) -> Span:
        return self._by_id[span_id]

    def open_spans(self) -> List[Span]:
        return [self._by_id[i] for i in self._open]

    def children(self) -> Dict[int, List[Span]]:
        """parent_id -> child spans, in span-id (= event) order."""
        out: Dict[int, List[Span]] = {}
        for sp in self.spans:
            out.setdefault(sp.parent_id, []).append(sp)
        return out

    def counts(self) -> Dict[str, int]:
        """Span count per name (instants included), name-sorted."""
        out: Dict[str, int] = {}
        for sp in self.spans:
            out[sp.name] = out.get(sp.name, 0) + 1
        return dict(sorted(out.items()))

    def counts_by_status(self, name: str) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for sp in self.spans:
            if sp.name == name:
                out[sp.status] = out.get(sp.status, 0) + 1
        return dict(sorted(out.items()))

    def check_closed(self) -> None:
        """Raise if any span is still open — the trace twin of
        ``check_conservation``: an open span at end-of-run is a leaked
        lifecycle, exactly like a leaked slot or KV block."""
        if self._open:
            leaked = [f"{sp.track}/{sp.name}#{sp.span_id}"
                      for sp in self.open_spans()]
            raise RuntimeError(
                f"{len(leaked)} span(s) never closed: {leaked[:8]}")

    # -- serialization --------------------------------------------------
    def to_json(self) -> dict:
        return {"spans": [sp.to_json() for sp in self.spans]}

    def canonical_bytes(self) -> bytes:
        """Byte-stable serialization (sorted keys, fixed separators):
        the cross-process / cross-PYTHONHASHSEED identity contract for
        trace content."""
        return json.dumps(self.to_json(), sort_keys=True,
                          separators=(",", ":")).encode("utf-8")


def as_tracer(trace) -> Optional[Tracer]:
    """Normalize the ``trace=`` constructor knob: ``True`` builds a
    fresh tracer, a ``Tracer`` instance is used as-is (shared across an
    A/B pair if the caller wants one timeline), falsy disables."""
    if isinstance(trace, Tracer):
        return trace
    return Tracer() if trace else None
