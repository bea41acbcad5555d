"""Per-request lifecycle tracking for the HTTP front end.

``TrackedRequest`` mirrors one submitted workflow through the proxy's
phase vocabulary — queued → prefill → decode → parked → done — with
cumulative WALL seconds per phase (the runtime's own spans are virtual
time; operators of a live deployment care about real latency).  The
tracker is a pure observer: it diff-scans session states after each
dispatched event (driver listener) and never touches the runtime.

Runtime states map onto proxy phases as:
  new/queued/migrating → queued, prefill → prefill, decode → decode,
  tool → parked, done → done.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

PHASES = ("queued", "prefill", "decode", "parked", "done")

_STATE_TO_PHASE = {
    "new": "queued", "queued": "queued", "migrating": "queued",
    "prefill": "prefill", "decode": "decode", "tool": "parked",
    "done": "done",
}


@dataclass
class TrackedRequest:
    """One proxied request's lifecycle record (wall-clock seconds)."""
    request_id: str
    session_id: str          # runtime session (unique per request)
    client_session: str      # X-Session-Id (spans many requests)
    task_id: str             # X-Task-Id
    program_id: str          # X-Program-Id
    tenant: str
    created_wall: float
    phase: str = "queued"
    phase_since: float = 0.0
    phase_wall_s: Dict[str, float] = field(default_factory=dict)
    first_token_wall: Optional[float] = None
    finished_wall: Optional[float] = None
    engine: int = -1
    n_tokens: int = 0

    def to_dict(self) -> dict:
        return {
            "request_id": self.request_id,
            "session_id": self.session_id,
            "client_session": self.client_session,
            "task_id": self.task_id,
            "program_id": self.program_id,
            "tenant": self.tenant,
            "phase": self.phase,
            "engine": self.engine,
            "n_tokens": self.n_tokens,
            "created_wall": self.created_wall,
            "first_token_wall": self.first_token_wall,
            "finished_wall": self.finished_wall,
            "phase_wall_s": {p: round(v, 6)
                             for p, v in sorted(self.phase_wall_s.items())},
        }


class RequestTracker:
    """Tracks live requests against a runtime; read-only observer."""

    def __init__(self, wall_now: Callable[[], float]) -> None:
        self._wall = wall_now
        self.live: Dict[str, TrackedRequest] = {}      # keyed by session_id
        self.finished: List[TrackedRequest] = []
        self.max_finished = 4096                       # ring for soak runs

    def track(self, *, request_id: str, session_id: str,
              client_session: str, task_id: str, program_id: str,
              tenant: str) -> TrackedRequest:
        now = self._wall()
        tr = TrackedRequest(request_id, session_id, client_session,
                            task_id, program_id, tenant,
                            created_wall=now, phase_since=now)
        self.live[session_id] = tr
        return tr

    def observe(self, runtime) -> None:
        """Diff-scan tracked sessions; called after every dispatched
        event.  Finished entries migrate to the ``finished`` ring."""
        now = self._wall()
        done: List[str] = []
        for sid, tr in self.live.items():
            ses = runtime.sessions.get(sid)
            if ses is None:
                continue
            phase = _STATE_TO_PHASE.get(ses.state, "queued")
            if ses.engine >= 0:
                tr.engine = ses.engine
            n_tok = sum(len(o) for o in ses.step_outputs)
            if n_tok and not tr.n_tokens and tr.first_token_wall is None:
                tr.first_token_wall = now
            tr.n_tokens = n_tok
            if phase != tr.phase:
                tr.phase_wall_s[tr.phase] = \
                    tr.phase_wall_s.get(tr.phase, 0.0) + (now - tr.phase_since)
                tr.phase = phase
                tr.phase_since = now
                if phase == "done":
                    tr.finished_wall = now
                    done.append(sid)
        for sid in done:
            self.finished.append(self.live.pop(sid))
        if len(self.finished) > self.max_finished:
            del self.finished[:len(self.finished) - self.max_finished]

    def get(self, session_id: str) -> Optional[TrackedRequest]:
        tr = self.live.get(session_id)
        if tr is not None:
            return tr
        for t in reversed(self.finished):
            if t.session_id == session_id:
                return t
        return None

    def phase_counts(self) -> Dict[str, int]:
        out = {p: 0 for p in PHASES}
        for tr in self.live.values():
            out[tr.phase] += 1
        out["done"] = len(self.finished)
        return out
