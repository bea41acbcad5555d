"""Speculative KV prefetching (paper §4.3).

When node v finishes inference and its tool call starts, prefetch the
prefix cache of the most likely successor u = argmax P(v -> u) so the
cache load overlaps the tool-call gap.  On TPU the copy is an async
device-to-device transfer (CUDA streams in the paper); the simulator
models it as a bandwidth-limited background copy using spare HBM.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

from repro_torch.core.aeg import AEG


@dataclass
class PrefetchJob:
    session_id: str
    node_id: int              # successor being prefetched
    bytes_: float
    issued_at: float
    ready_at: float           # completion time under bandwidth model
    correct: Optional[bool] = None   # filled when the real next step lands
    worker: Optional[int] = None     # copy source (engine fault cleanup)


class SpeculativePrefetcher:
    def __init__(self, bandwidth_Bps: float = 25e9,
                 spare_capacity_fraction: float = 0.1):
        self.bw = bandwidth_Bps
        self.spare = spare_capacity_fraction
        self.inflight: Dict[str, PrefetchJob] = {}
        self.issued = 0
        self.correct = 0
        self.wasted_bytes = 0.0

    def maybe_issue(self, session_id: str, aeg: Optional[AEG],
                    node_id: int, entry_bytes: float, now: float,
                    pool_used_frac: float,
                    target: Optional[int] = None,
                    worker: Optional[int] = None) -> Optional[PrefetchJob]:
        """Issue a prefetch for the argmax successor if spare memory
        exists.  ``target`` overrides the successor prediction with an
        already-resolved node (declared graphs: the taken edge is known
        at the park boundary, so the prefetch is exact, not
        speculative).  ``worker`` records the copy's source engine so a
        fault there can cancel the job.  Returns the job (simulator
        schedules ready_at)."""
        if aeg is None or pool_used_frac > 1.0 - self.spare:
            return None
        succ = target if target is not None \
            else aeg.most_likely_successor(node_id)
        if succ is None:
            return None
        # an in-flight job for the same session is superseded, never
        # resolved: its bytes were copied for nothing and must count as
        # waste (previously they silently vanished from the accounting)
        prev = self.inflight.get(session_id)
        if prev is not None:
            self.wasted_bytes += prev.bytes_
        job = PrefetchJob(session_id=session_id, node_id=succ,
                          bytes_=entry_bytes, issued_at=now,
                          ready_at=now + entry_bytes / self.bw,
                          worker=worker)
        self.inflight[session_id] = job
        self.issued += 1
        return job

    def cancel(self, session_id: str) -> None:
        """Drop an in-flight job whose session ended before its next
        step arrived (task finished mid-gap).  The copy was pure waste."""
        job = self.inflight.pop(session_id, None)
        if job is not None:
            self.wasted_bytes += job.bytes_

    def cancel_worker(self, worker: int) -> int:
        """An engine died: every in-flight replication sourced from it
        can never land (its parked blocks are gone), so the jobs are
        cancelled and their bytes counted as waste — previously only
        supersession cancelled them, and a dead-source job would linger
        until ``resolve`` mis-scored it against the wrong copy.  Returns
        the number of jobs cancelled."""
        victims = [sid for sid, job in self.inflight.items()
                   if job.worker == worker]
        for sid in victims:
            self.wasted_bytes += self.inflight.pop(sid).bytes_
        return len(victims)

    def resolve(self, session_id: str, actual_node: int,
                now: float) -> bool:
        """The session's real next step arrived: was the prefetch warm
        and correct?  Returns True when the step's prefill is absorbed."""
        job = self.inflight.pop(session_id, None)
        if job is None:
            return False
        ok = job.node_id == actual_node and job.ready_at <= now
        job.correct = ok
        if ok:
            self.correct += 1
        else:
            self.wasted_bytes += job.bytes_
        return ok
