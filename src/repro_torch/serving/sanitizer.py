"""Runtime KV/slot sanitizer: conservation checked at every event.

``check_conservation`` proves the end state clean; when it fails, the
leak happened thousands of events earlier with no pointer to the
culprit.  With ``ServingRuntime(sanitize=True)`` (or ``SAGA_SANITIZE=1``
in the environment) the runtime calls :meth:`RuntimeSanitizer.after_event`
after *every* dispatched event, shadow-auditing:

  * **block conservation** per engine pool — every block in exactly one
    of {free list, one session's table} (``PagedKVPool.audit_blocks``);
    a double-release or an orphaned block fails here, at the first
    event that produced it, naming the owning session;
  * **slot ownership** — each occupied slot maps to a live session
    whose ``(engine, slot, state)`` agree, and the slot-owner set
    equals the continuous-batching set ``_active[w]`` (a session
    leaked out of the batch still holds a slot forever);
  * **incremental indices** — ``_resident`` / ``_loadnum`` /
    ``_nonempty`` against ground truth recomputed from scratch;
  * **registry consistency** — ``inflight`` keys are exactly the
    prefill/decode sessions and their (engine, attempt) stamps match
    the session records; queued tickets reference queued sessions;
  * **policy/real mirror** — parked blocks are a subset of the
    coordinator's pool metadata (the invariant behind
    ``verify_pool_mirrors``);
  * **cross-pool in-transit state** (disaggregated mode) — every staged
    handoff job's blocks really exist on its prefill engine with the
    staged token count, unstaged jobs hold only a reservation, and no
    reservation ever goes negative.

Violations raise :class:`SanitizerError` naming the event (kind, args,
virtual time) plus the owning session and attempt.  The sanitizer only
*reads* runtime state, so a sanitized run's ``summarize()`` repr is
byte-identical to an unsanitized one — CI runs one smoke leg with
``SAGA_SANITIZE=1`` to keep that true.
"""
from __future__ import annotations

from typing import List, Optional, TYPE_CHECKING

if TYPE_CHECKING:                       # pragma: no cover
    from repro_torch.serving.runtime import ServingRuntime


class SanitizerError(AssertionError):
    """Conservation violated at an event boundary (not at end-of-run)."""


class RuntimeSanitizer:
    """Read-only shadow auditor for one :class:`ServingRuntime`."""

    def __init__(self, rt: "ServingRuntime") -> None:
        self.rt = rt
        self.events_checked = 0

    # -- helpers --------------------------------------------------------
    def _attempt(self, sid: Optional[str]) -> str:
        if sid is None:
            return ""
        ses = self.rt.sessions.get(sid)
        if ses is None:
            return f" (session {sid!r} unknown)"
        return f" (session {sid!r} attempt={ses.attempt})"

    # -- the per-event audit --------------------------------------------
    def after_event(self, t: float, kind: str, args: tuple) -> None:
        rt = self.rt
        self.events_checked += 1
        errs: List[str] = []
        for w, eng in enumerate(rt.engines):
            for msg, sid in eng.pool.audit_blocks():
                errs.append(f"engine {w}: {msg}{self._attempt(sid)}")
            owners = {}
            for i, slot in enumerate(eng.slots):
                sid = slot.session_id
                if sid is None:
                    continue
                if sid in owners:
                    errs.append(f"engine {w}: slots {owners[sid]} and "
                                f"{i} both held by"
                                f"{self._attempt(sid)}")
                    continue
                owners[sid] = i
                ses = rt.sessions.get(sid)
                if ses is None:
                    errs.append(f"engine {w} slot {i} held by unknown "
                                f"session {sid!r}")
                elif (ses.engine, ses.slot, ses.state) != (w, i,
                                                           "decode"):
                    errs.append(
                        f"engine {w} slot {i}: session record "
                        f"(engine={ses.engine}, slot={ses.slot}, "
                        f"state={ses.state!r}) disagrees with the slot "
                        f"table{self._attempt(sid)}")
            if set(owners) != rt._active[w]:
                drift = sorted(set(owners) ^ rt._active[w])
                who = ", ".join(f"{s!r}{self._attempt(s)}"
                                for s in drift)
                errs.append(f"engine {w}: decode batch != slot owners "
                            f"— leaked/phantom: {who}")
            n_prefill = sum(1 for s in rt.sessions.values()
                            if s.engine == w and s.state == "prefill")
            if rt._resident[w] != len(owners) + n_prefill:
                errs.append(f"engine {w}: resident={rt._resident[w]} "
                            f"but slots={len(owners)} + "
                            f"prefills={n_prefill}")
            if int(rt._loadnum[w]) != rt._resident[w] + \
                    len(rt.queues[w]):
                errs.append(f"engine {w}: load index "
                            f"{int(rt._loadnum[w])} != resident "
                            f"{rt._resident[w]} + queued "
                            f"{len(rt.queues[w])}")
            if (w in rt._nonempty) != bool(rt.queues[w]):
                errs.append(f"engine {w}: nonempty-index membership "
                            f"{w in rt._nonempty} but queue length "
                            f"{len(rt.queues[w])}")
            # policy/real mirror: parked blocks ⊆ coordinator metadata.
            # Resident sessions are exempt — block ownership spans
            # admit→finish in paged mode, and a cache-miss admit has no
            # coordinator entry until its first park.  So are in-transit
            # handoff blocks staged on a prefill engine: the cross-pool
            # transfer deliberately carries no coordinator metadata
            # until it lands on the decode side.
            extra = sorted(set(eng.pool.tables)
                           - set(rt.co.pools[w].entries)
                           - eng.pool.resident
                           - rt._handoff_staged(w))
            if extra:
                who = ", ".join(f"{s!r}{self._attempt(s)}"
                                for s in extra[:5])
                errs.append(f"engine {w}: parked blocks with no pool "
                            f"metadata entry: {who}")
            if eng.paged:
                # resident set == slot owners: a resident session with
                # no slot leaks headroom blocks forever; a slot owner
                # not marked resident would count against (and can
                # exhaust) the parked-policy budget
                if eng.pool.resident != set(owners):
                    drift = sorted(eng.pool.resident ^ set(owners))
                    who = ", ".join(f"{s!r}{self._attempt(s)}"
                                    for s in drift[:5])
                    errs.append(f"engine {w}: resident sessions != "
                                f"slot owners — drift: {who}")
                for sid, i in sorted(owners.items()):
                    if eng.pool.lens.get(sid) != eng.slots[i].length:
                        errs.append(
                            f"engine {w} slot {i}: block-table length "
                            f"{eng.pool.lens.get(sid)} != slot length "
                            f"{eng.slots[i].length}{self._attempt(sid)}")
                if eng.pool.used_blocks() > eng.pool.num_blocks:
                    errs.append(
                        f"engine {w}: parked blocks "
                        f"{eng.pool.used_blocks()} exceed nominal "
                        f"capacity {eng.pool.num_blocks}")
            for _, sid in rt.queues[w].snapshot():
                ses = rt.sessions.get(sid)
                if ses is None or ses.state != "queued":
                    st = None if ses is None else ses.state
                    errs.append(f"engine {w}: queued ticket for "
                                f"session in state {st!r}"
                                f"{self._attempt(sid)}")
        live = {sid for sid, s in rt.sessions.items()
                if s.state in ("prefill", "decode")}
        if set(rt.inflight) != live:
            drift = sorted(set(rt.inflight) ^ live)
            who = ", ".join(f"{s!r}{self._attempt(s)}" for s in drift)
            errs.append(f"inflight registry != prefill/decode "
                        f"sessions — drift: {who}")
        for sid, (ew, att) in sorted(rt.inflight.items()):
            ses = rt.sessions.get(sid)
            if ses is not None and (ses.engine != ew
                                    or ses.attempt != att):
                errs.append(f"inflight stamp ({ew}, {att}) stale vs "
                            f"session (engine={ses.engine}, "
                            f"attempt={ses.attempt}) for {sid!r}")
        if rt.disagg:
            # cross-pool in-transit state: a staged job's blocks really
            # exist on its prefill engine with exactly the staged token
            # count; placed-but-unstaged jobs hold a reservation on a
            # prefill engine; pending jobs hold nothing anywhere
            for sid, job in sorted(rt._pf.jobs.items()):
                p = job.p_engine
                if job.state == "staged":
                    pool = rt.engines[p].pool
                    if pool.lens.get(sid) != job.n_stage:
                        errs.append(
                            f"handoff job {sid!r}: staged on engine {p} "
                            f"but pool holds "
                            f"{pool.lens.get(sid)} tokens, job staged "
                            f"{job.n_stage}")
                elif job.state == "prefill":
                    if p not in rt._pf.reserved or p < 0:
                        errs.append(f"handoff job {sid!r}: placed on "
                                    f"non-prefill engine {p}")
                elif job.state == "pending":
                    if p != -1 or sid not in rt._pf.pending:
                        errs.append(f"handoff job {sid!r}: pending but "
                                    f"p_engine={p}, in FIFO: "
                                    f"{sid in rt._pf.pending}")
            for p, r in sorted(rt._pf.reserved.items()):
                if r < 0:
                    errs.append(f"engine {p}: negative staging "
                                f"reservation {r}")
        if errs:
            raise SanitizerError(
                f"sanitizer: conservation violated after event "
                f"{kind!r} args={args!r} at t={t:.6f} "
                f"(event #{self.events_checked}):\n  "
                + "\n  ".join(errs))
