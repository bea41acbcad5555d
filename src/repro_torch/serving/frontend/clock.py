"""Clock abstraction for the asyncio serving driver.

``AsyncServingDriver`` never reads time sources directly — it asks its
clock, so the same pacing code runs against the real asyncio clock
(``WallClock``) or a deterministic counter (``FakeClock``).  The fake
clock is how CI proves the driver reproduces the virtual-time
``summarize()`` byte-identically: sleeps advance it instantly, so the
run is pure event-order replay with zero wall-time influence.
"""
from __future__ import annotations

import asyncio


class WallClock:
    """Real time via the running asyncio event loop.  ``wait`` blocks
    until ``event`` fires (True) or ``timeout`` elapses (False) — the
    driver's interruptible pacing sleep, so a submission arriving
    earlier than the next scheduled virtual event wakes it."""

    virtual = False

    def time(self) -> float:
        loop = asyncio.get_running_loop()
        return loop.time()

    async def wait(self, event: asyncio.Event, timeout: float) -> bool:
        try:
            await asyncio.wait_for(event.wait(), max(timeout, 0.0))
            return True
        except asyncio.TimeoutError:
            return False


class FakeClock:
    """Deterministic clock: ``wait`` advances time by the full timeout
    and reports no interruption, regardless of pending submissions.
    Pacing therefore costs nothing and perturbs nothing — the driver
    degenerates to exact heap-order replay of the virtual run."""

    virtual = True

    def __init__(self, start: float = 0.0) -> None:
        self._now = float(start)

    def time(self) -> float:
        return self._now

    async def wait(self, event: asyncio.Event, timeout: float) -> bool:
        self._now += max(timeout, 0.0)
        return False
