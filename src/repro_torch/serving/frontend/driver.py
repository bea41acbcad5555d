"""Asyncio wall-clock driver for ``ServingRuntime``.

One runtime codebase, two substrates: the virtual-time ``run()`` loop
pops the event heap as fast as Python allows, while this driver pops
THE SAME HEAP in the same order but paces each pop against a wall
clock — virtual deadlines map to awaits, tool gaps become real sleeps,
and decode rounds optionally execute on a single worker thread so the
asyncio loop stays responsive to HTTP traffic while JAX computes.

Byte-identity contract: because the driver dispatches the identical
event sequence (``getattr(rt, "_on_" + kind)(*args)``, sanitizer hook
included) and replicates ``run()``'s exact termination condition, a
``FakeClock`` run produces a ``summarize()`` repr byte-identical to the
virtual-time run.  ``benchmarks/serve_bench.py`` fingerprints this and
CI diffs it against the committed pin.

Wall mapping: ``wall = t0_wall + (virt - t0_virt) * time_scale``.  A
``time_scale`` of 1.0 serves virtual seconds in real seconds; soak runs
compress it.  When compute outruns the budget the driver simply never
sleeps (lag is recorded in ``wall_stats``), so pacing can throttle but
never reorder.
"""
from __future__ import annotations

import asyncio
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional

from repro_torch.serving.frontend.clock import FakeClock, WallClock

INF = float("inf")


class AsyncWorkflowHandle:
    """Awaitable twin of the runtime's ``WorkflowHandle``: same
    read-only views, but completion is awaited on the asyncio loop
    (``WorkflowHandle.result()`` drives the clock itself, which only
    the driver may do here)."""

    __slots__ = ("_driver", "_ses")

    def __init__(self, driver: "AsyncServingDriver", ses) -> None:
        self._driver = driver
        self._ses = ses

    @property
    def session_id(self) -> str:
        return self._ses.session_id

    @property
    def done(self) -> bool:
        return self._ses.finished_at >= 0

    @property
    def status(self) -> str:
        return self._ses.state

    @property
    def step_outputs(self) -> List[List[int]]:
        return [list(o) for o in self._ses.step_outputs]

    @property
    def path(self) -> List[int]:
        return list(self._ses.inst.path)

    @property
    def tct(self) -> float:
        return self._ses.tct

    async def wait(self, timeout: Optional[float] = None) -> "SessionState":
        """Await session completion; returns the ``SessionState``."""
        if self.done:
            return self._ses
        fut = asyncio.get_running_loop().create_future()
        self._driver._watch(self._ses.session_id, fut)
        await asyncio.wait_for(fut, timeout)
        return self._ses


class AsyncServingDriver:
    """Drives a ``ServingRuntime`` under asyncio.

    Parameters
      runtime     — a ``ServingRuntime`` (any config; the driver never
                    schedules events itself).
      clock       — ``WallClock()`` (default) or ``FakeClock()`` for
                    deterministic replay.
      time_scale  — wall seconds per virtual second (pacing only).
      executor    — run handlers on a single worker thread so prefill /
                    decode compute doesn't block the asyncio loop.
                    Handler EXECUTION stays strictly serial either way.
    """

    def __init__(self, runtime, *, clock=None, time_scale: float = 1.0,
                 executor: bool = False) -> None:
        if time_scale <= 0:
            raise ValueError(f"time_scale={time_scale!r} must be > 0")
        self.rt = runtime
        self.clock = clock if clock is not None else WallClock()
        self.time_scale = float(time_scale)
        self._pool = (ThreadPoolExecutor(max_workers=1,
                                         thread_name_prefix="saga-engine")
                      if executor else None)
        # guards the runtime: handlers may run on the executor thread
        # while submit()/state reads happen on the asyncio loop
        self._lock = threading.Lock()
        self._wake: Optional[asyncio.Event] = None
        self._watchers: Dict[str, List[asyncio.Future]] = {}
        self._listeners: List[Callable[[float, str, tuple], None]] = []
        self._stopping = False
        self._running = False
        self._t0_wall: Optional[float] = None
        self._t0_virt = 0.0
        self._last_done = 0
        self.wall_stats = {"events": 0, "max_lag_s": 0.0,
                           "wall_elapsed_s": 0.0, "submitted": 0}

    # -- client surface --------------------------------------------------
    def wall_now(self) -> float:
        return self.clock.time()

    def virt_now(self) -> float:
        """Current virtual time as seen from the wall clock (falls back
        to the runtime clock before the driver starts or under a fake
        clock)."""
        if self._t0_wall is None or self.clock.virtual:
            return self.rt.ev.now
        return self._t0_virt + \
            (self.clock.time() - self._t0_wall) / self.time_scale

    def submit(self, req, *, route_hint: Optional[int] = None,
               slo_s: Optional[float] = None,
               arrival: Optional[float] = None) -> AsyncWorkflowHandle:
        """Submit a program/request; safe to call from asyncio handlers
        while the driver is mid-run.  A live wall-clock run stamps the
        arrival at the wall-mapped virtual now, so inter-arrival gaps in
        real traffic survive into the virtual schedule."""
        if arrival is None and self._running and not self.clock.virtual:
            arrival = self.virt_now()
        with self._lock:
            h = self.rt.submit(req, arrival, route_hint=route_hint,
                               slo_s=slo_s)
        self.wall_stats["submitted"] += 1
        if self._wake is not None:
            self._wake.set()
        return AsyncWorkflowHandle(self, h._ses)

    def add_listener(self, fn: Callable[[float, str, tuple], None]) -> None:
        """Register a read-only observer called after every dispatched
        event with ``(t, kind, args)`` (trackers, metrics samplers).
        Listeners must never mutate the runtime."""
        self._listeners.append(fn)

    def stop(self) -> None:
        self._stopping = True
        if self._wake is not None:
            self._wake.set()

    # -- event pump ------------------------------------------------------
    async def run(self, horizon_s: float = INF) -> Dict[str, object]:
        """Drain the heap until every submitted session finishes —
        the asyncio twin of ``ServingRuntime.run`` with identical
        termination semantics (this equivalence is what the fake-clock
        fingerprint pins)."""
        self._begin()
        rt = self.rt
        try:
            while not self._stopping:
                nxt = rt.ev.peek_time()
                if nxt is None or nxt > horizon_s:
                    break
                if await self._pace(nxt):
                    continue                 # woken early: re-peek
                kind = await self._dispatch_next()
                if kind is not None and kind != "epoch" \
                        and rt.n_done == len(rt.sessions):
                    break
        finally:
            self._end()
        return rt.sessions

    async def serve_forever(self) -> None:
        """Pump events indefinitely, idling on the wake event whenever
        the heap drains (the HTTP proxy's mode: submissions re-arm the
        heap).  Returns after ``stop()``."""
        self._begin()
        rt = self.rt
        try:
            while not self._stopping:
                nxt = rt.ev.peek_time()
                if nxt is None:
                    self._wake.clear()
                    await self.clock.wait(self._wake, 0.05)
                    continue
                if await self._pace(nxt):
                    continue
                await self._dispatch_next()
        finally:
            self._end()

    # -- internals -------------------------------------------------------
    def _begin(self) -> None:
        if self._running:
            raise RuntimeError("driver is already running")
        self._running = True
        self._stopping = False
        self._wake = asyncio.Event()
        if self._t0_wall is None:
            self._t0_wall = self.clock.time()
            self._t0_virt = self.rt.ev.now

    def _end(self) -> None:
        self._running = False
        self.wall_stats["wall_elapsed_s"] = \
            self.clock.time() - (self._t0_wall or 0.0)

    def _wall_for(self, virt: float) -> float:
        return self._t0_wall + (virt - self._t0_virt) * self.time_scale

    async def _pace(self, nxt: float) -> bool:
        """Sleep until the wall deadline of virtual time ``nxt``.
        True → woken early (new submission / stop): caller re-peeks.
        False → deadline reached (or already behind): caller pops."""
        delay = self._wall_for(nxt) - self.clock.time()
        if delay > 0:
            self._wake.clear()
            return await self.clock.wait(self._wake, delay)
        lag = -delay
        if lag > self.wall_stats["max_lag_s"]:
            self.wall_stats["max_lag_s"] = lag
        # compute-bound stretch: still yield so proxy coroutines run
        if not self.clock.virtual:
            await asyncio.sleep(0)
        return False

    async def _dispatch_next(self) -> Optional[str]:
        """Pop and dispatch exactly one event, mirroring the body of
        ``ServingRuntime.run`` (handler, then sanitizer hook)."""
        rt = self.rt

        def step():
            with self._lock:
                t, kind, args = rt.ev.pop()
                getattr(rt, "_on_" + kind)(*args)
                if rt._san is not None:
                    rt._san.after_event(t, kind, args)
                return t, kind, args

        if self._pool is not None:
            t, kind, args = await asyncio.get_running_loop() \
                .run_in_executor(self._pool, step)
        else:
            t, kind, args = step()
        self.wall_stats["events"] += 1
        for fn in self._listeners:
            fn(t, kind, args)
        if rt.n_done != self._last_done:
            self._last_done = rt.n_done
            self._resolve_watchers()
        return kind

    def _watch(self, sid: str, fut: asyncio.Future) -> None:
        ses = self.rt.sessions.get(sid)
        if ses is not None and ses.finished_at >= 0:
            fut.set_result(ses)
            return
        self._watchers.setdefault(sid, []).append(fut)

    def _resolve_watchers(self) -> None:
        if not self._watchers:
            return
        done = [sid for sid in self._watchers
                if self.rt.sessions[sid].finished_at >= 0]
        for sid in done:
            for fut in self._watchers.pop(sid):
                if not fut.done():
                    fut.set_result(self.rt.sessions[sid])
