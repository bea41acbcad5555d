"""SagaClient — the one submission surface for every substrate.

Before this facade there were three client-facing submission paths:
``ServingRuntime.submit`` (event-driven serving), ``MultiWorkerServer.
run_task`` (blocking serial wrapper) and raw ``ClusterSim`` task lists
(simulator).  Tests, benchmarks, examples and the HTTP proxy each
picked one and coupled to its quirks.  ``SagaClient`` collapses them:

    client = SagaClient.for_runtime(rt)          # virtual-time serving
    client = SagaClient.for_server(server)       # serial wrapper
    client = SagaClient.for_simulation(policy)   # discrete-event sim
    client = SagaClient.for_driver(driver)       # asyncio wall clock

    h = client.submit(program_or_request, tenant="teamA", slo=30.0)
    client.run()
    h.done, h.status, h.step_outputs (serving) / h.metrics (sim)

``submit`` accepts anything ``as_instance`` does — ``AgentProgram``
(scripted/graph/dynamic), legacy ``AgentRequest``, simulator ``Task`` —
and every backend returns a handle with the same core surface
(``session_id`` / ``done`` / ``status``).  ``tenant=`` overrides the
submission's tenant without mutating the caller's object; ``slo=``
registers an explicit deadline with the coordinator on the serving
substrates (the simulator derives deadlines from Eq. 9 work estimates
— its scheduler is deadline-free by construction, so ``slo`` only
annotates the handle there).

The old entry points remain as thin deprecated shims so golden
byte-pins stay untouched.
"""
from __future__ import annotations

import copy
from typing import Dict, List, Optional

INF = float("inf")


def _retenant(obj, tenant: Optional[str]):
    """Shallow-copy ``obj`` with its tenant replaced (copy.copy keeps
    adapter side-channels like ``_raw_steps`` that dataclasses.replace
    would drop).  No-op when tenant is None or already equal."""
    if tenant is None or getattr(obj, "tenant", None) == tenant:
        return obj
    c = copy.copy(obj)
    c.tenant = tenant
    return c


class SimWorkflowHandle:
    """Deferred-simulation handle: resolves after ``client.run()``."""

    def __init__(self, client: "SagaClient", task_id: str,
                 slo: Optional[float]) -> None:
        self._client = client
        self.session_id = task_id
        self.slo = slo

    @property
    def _metrics(self):
        sim = self._client._sim
        return None if sim is None else sim.metrics.get(self.session_id)

    @property
    def done(self) -> bool:
        m = self._metrics
        return m is not None and m.finish >= 0

    @property
    def status(self) -> str:
        if self._client._sim is None:
            return "pending"
        return "done" if self.done else "queued"

    @property
    def metrics(self):
        """Simulator ``TaskMetrics`` (tct / regen_tokens / steps)."""
        if not self.done:
            raise RuntimeError(f"task {self.session_id} not finished "
                               "(call client.run() first)")
        return self._metrics

    @property
    def tct(self) -> float:
        return self.metrics.tct

    @property
    def slo_met(self) -> Optional[bool]:
        return None if self.slo is None else self.tct <= self.slo


class SagaClient:
    """Facade over one scheduling substrate; construct via the
    ``for_*`` classmethods."""

    def __init__(self, *, _runtime=None, _server=None, _driver=None,
                 _sim_factory=None) -> None:
        given = [x for x in (_runtime, _server, _driver, _sim_factory)
                 if x is not None]
        if len(given) != 1:
            raise ValueError("construct SagaClient via for_runtime / "
                             "for_server / for_simulation / for_driver")
        self._rt = _runtime
        self._server = _server
        self._driver = _driver
        self._sim_factory = _sim_factory
        self._sim = None
        self._pending: List[object] = []        # sim submissions
        self.handles: Dict[str, object] = {}

    # -- constructors ----------------------------------------------------
    @classmethod
    def for_runtime(cls, runtime) -> "SagaClient":
        """Virtual-time event-driven serving (``ServingRuntime``)."""
        return cls(_runtime=runtime)

    @classmethod
    def for_server(cls, server) -> "SagaClient":
        """The serial ``MultiWorkerServer`` wrapper (its runtime clock
        carries across submissions; ``run()`` drains after each)."""
        return cls(_server=server)

    @classmethod
    def for_driver(cls, driver) -> "SagaClient":
        """Asyncio wall-clock driver; ``submit`` returns awaitable
        ``AsyncWorkflowHandle``s and ``run()`` is a no-op (the driver's
        ``run()``/``serve_forever()`` coroutine pumps events)."""
        return cls(_driver=driver)

    @classmethod
    def for_simulation(cls, policy=None, *, n_workers: int = 16,
                       perf=None, seed: int = 0, fault_plan=None,
                       straggler=None, straggler_slowdown: float = 4.0,
                       trace=None) -> "SagaClient":
        """Deferred ``ClusterSim``: submissions accumulate, ``run()``
        builds and runs the simulator (it takes its task list at
        construction).  ``policy`` is a ``SimPolicy`` or ``SAGAConfig``
        (wrapped), default SAGA."""
        from repro_torch.cluster.simulator import ClusterSim, SimPolicy
        from repro_torch.core.coordinator import SAGAConfig

        if policy is None:
            policy = SimPolicy()
        elif isinstance(policy, SAGAConfig):
            policy = SimPolicy(saga=policy)

        def factory(tasks):
            return ClusterSim(tasks, policy, n_workers=n_workers,
                              perf=perf, seed=seed, fault_plan=fault_plan,
                              straggler=straggler,
                              straggler_slowdown=straggler_slowdown,
                              trace=trace)
        return cls(_sim_factory=factory)

    # -- core API --------------------------------------------------------
    def submit(self, program_or_request, *, tenant: Optional[str] = None,
               slo: Optional[float] = None,
               arrival: Optional[float] = None,
               route_hint: Optional[int] = None):
        """Submit one workflow; returns a handle (backend-specific type,
        shared ``session_id``/``done``/``status`` surface)."""
        obj = _retenant(program_or_request, tenant)
        if self._rt is not None:
            h = self._rt.submit(obj, arrival, route_hint=route_hint,
                                slo_s=slo)
        elif self._server is not None:
            rt = self._server.runtime
            h = rt.submit(obj, rt.ev.now if arrival is None else arrival,
                          route_hint=route_hint, slo_s=slo)
        elif self._driver is not None:
            h = self._driver.submit(obj, route_hint=route_hint,
                                    slo_s=slo, arrival=arrival)
        else:
            if self._sim is not None:
                raise RuntimeError("simulation already ran; build a "
                                   "fresh SagaClient.for_simulation")
            tid = getattr(obj, "task_id", None) \
                or getattr(obj, "program_id", None) \
                or getattr(obj, "session_id", None)
            if tid is None:
                raise TypeError(f"cannot infer task id from "
                                f"{type(obj).__name__}")
            self._pending.append(obj)
            h = SimWorkflowHandle(self, str(tid), slo)
        self.handles[h.session_id] = h
        return h

    def run(self, horizon_s: float = INF):
        """Advance the substrate until submitted work completes (sim:
        build-and-run; driver: no-op — await its coroutine instead)."""
        if self._rt is not None:
            return self._rt.run(horizon_s)
        if self._server is not None:
            return self._server.runtime.run(horizon_s)
        if self._driver is not None:
            return None
        if self._sim is None:
            self._sim, self._pending = \
                self._sim_factory(self._pending), []
        return self._sim.run(horizon_s)

    # -- read-only surface ----------------------------------------------
    @property
    def runtime(self):
        """The underlying ``ServingRuntime`` when one exists (runtime /
        server / driver backends), else None."""
        if self._rt is not None:
            return self._rt
        if self._server is not None:
            return self._server.runtime
        if self._driver is not None:
            return self._driver.rt
        return None

    def stats(self) -> dict:
        rt = self.runtime
        return rt.stats() if rt is not None else {}

    def summarize(self) -> dict:
        rt = self.runtime
        if rt is not None:
            return rt.summarize()
        if self._sim is None:
            raise RuntimeError("nothing ran yet")
        from repro_torch.cluster.simulator import summarize
        return summarize(self._sim)

    def check_conservation(self) -> None:
        rt = self.runtime
        if rt is not None:
            rt.check_conservation()
        elif self._sim is not None:
            self._sim.check_conservation()
