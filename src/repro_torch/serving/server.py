"""Multi-worker in-process serving cluster under the SAGA coordinator.

Runs REAL inference (tiny zoo models on CPU; same code drives TPU pods)
for multi-step agent sessions: route (Eq. 7) -> resume-or-prefill ->
decode -> park with tool-TTL -> tool gap (virtual time) -> repeat.
Demonstrates and MEASURES the paper's central quantity: prefilled tokens
with and without workflow-atomic scheduling.

This is now a thin SERIAL wrapper over the event-driven
``repro_torch.serving.runtime.ServingRuntime`` — one task submitted and run to
completion at a time, preserving the original blocking ``run_task`` API
(and its tests) while the runtime underneath is the same engine that
interleaves many concurrent sessions.  Load reporting is the runtime's
real queue-depth + slot-occupancy vector, not the old binary
free-slot hack.

DEPRECATED as a client surface: new code should submit through
``repro_torch.serving.client.SagaClient`` (``SagaClient.for_server(server)``
wraps this object; ``run_task`` stays byte-identical for the golden
pins).  See docs/SERVING_API.md.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.core.coordinator import SAGAConfig
from repro_torch.serving.runtime import AgentRequest, RuntimePerf, ServingRuntime

__all__ = ["AgentRequest", "MultiWorkerServer"]


class MultiWorkerServer:
    def __init__(self, cfg: ModelConfig, params, *, n_workers: int = 2,
                 saga: Optional[SAGAConfig] = None, n_slots: int = 4,
                 max_len: int = 512, pool_blocks: int = 48,
                 perf: Optional[RuntimePerf] = None, seed: int = 0):
        self.cfg = cfg
        self.runtime = ServingRuntime(cfg, params, n_workers=n_workers,
                                      saga=saga, n_slots=n_slots,
                                      max_len=max_len,
                                      pool_blocks=pool_blocks,
                                      perf=perf, seed=seed)
        self.engines = self.runtime.engines
        self.co = self.runtime.co
        self.kv_bytes_per_token = self.runtime.kv_bytes_per_token

    @property
    def clock(self) -> float:
        return self.runtime.ev.now

    def _loads(self) -> List[float]:
        """Real queue-depth + slot-occupancy loads, shared with the
        runtime's router and epoch tick."""
        return [float(x) for x in self.runtime.loads()]

    def run_task(self, req: AgentRequest) -> Dict[str, float]:
        """Execute a whole agent task through the cluster; returns stats.
        Serial: blocks until this task completes (the runtime's clock
        keeps advancing across calls, so TTLs and AFS state carry over)."""
        handle = self.runtime.submit(req, arrival=self.runtime.ev.now)
        self.runtime.run()
        if not handle.done:
            raise RuntimeError(
                f"task {handle.session_id} did not finish")
        ses = self.runtime.sessions[handle.session_id]
        return {"regen_tokens": float(ses.regen_tokens),
                "ctx_tokens": float(len(ses.ctx))}

    def stats(self) -> dict:
        return self.runtime.stats()
