"""Wall-clock serving front end (ROADMAP item 3).

The virtual-time ``EventLoop`` in ``repro_torch.serving.events`` was built so
the SAME ``_on_*`` handler set could one day run under a real clock —
this package is that day:

  * ``clock``     — ``WallClock`` (asyncio wall time) and ``FakeClock``
                    (deterministic, sleeps advance it instantly) behind
                    one awaitable interface.
  * ``driver``    — ``AsyncServingDriver``: pops the runtime's event
                    heap in exact virtual order, paces pops against the
                    wall clock (virtual deadlines → awaits, tool gaps →
                    real sleeps, decode rounds → executor-threaded
                    engine steps).  Under ``FakeClock`` it reproduces
                    the virtual-time ``summarize()`` byte-identically —
                    CI diffs that fingerprint.
  * ``strategies``— pluggable load balancers (saga-affinity /
                    round-robin / least-loaded) feeding the runtime's
                    one-shot ``route_hint``.
  * ``tracker``   — ``TrackedRequest`` lifecycle (queued → prefill →
                    decode → parked → done) with per-phase wall-clock
                    accounting.
  * ``proxy``     — stdlib-asyncio HTTP server speaking
                    OpenAI-compatible ``/v1/chat/completions`` (plus
                    SSE streaming) with ``X-Session-Id`` /
                    ``X-Task-Id`` / ``X-Program-Id`` headers, and
                    ``/metrics`` Prometheus text from the ``repro_torch.obs``
                    registry.

This package is the ONE place sagalint's det-clock rule permits wall
clocks (scoped configuration in ``repro_torch.analysis.sagalint``, not
pragmas): everything here drives or observes the runtime, never
schedules inside it, so virtual-time determinism is untouched.

See docs/SERVING_API.md for the full contract.
"""
from repro_torch.serving.frontend.clock import FakeClock, WallClock
from repro_torch.serving.frontend.driver import (AsyncServingDriver,
                                           AsyncWorkflowHandle)
from repro_torch.serving.frontend.proxy import SagaHTTPProxy
from repro_torch.serving.frontend.strategies import (LeastLoaded, RoundRobin,
                                               SagaAffinity, Strategy,
                                               get_strategy,
                                               register_strategy)
from repro_torch.serving.frontend.tracker import RequestTracker, TrackedRequest

__all__ = [
    "AsyncServingDriver", "AsyncWorkflowHandle", "FakeClock",
    "LeastLoaded", "RequestTracker", "RoundRobin", "SagaAffinity",
    "SagaHTTPProxy", "Strategy", "TrackedRequest", "WallClock",
    "get_strategy", "register_strategy",
]
