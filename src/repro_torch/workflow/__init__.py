"""Unified AgentProgram submission API (paper §3.1-§3.3).

The *workflow* — not the request — is the schedulable unit.  An
``AgentProgram`` is one submission format consumed by BOTH execution
substrates (the discrete-event ``ClusterSim`` and the real-inference
``ServingRuntime``) in three flavors:

  * **scripted** — a pre-resolved linear step list.  The legacy
    ``cluster.workload.Task`` and ``serving.runtime.AgentRequest``
    formats compile to this flavor through thin adapters
    (``AgentProgram.from_task`` / ``AgentProgram.from_request``), so
    every existing entry point keeps working byte-identically.
  * **graph** — an explicit Agent Execution Graph (tier-a
    observability, §3.3): per-node step parameters plus probabilistic
    edges.  Branches *execute* — a seeded per-program RNG resolves the
    taken edge at each park boundary — and the declared AEG is handed
    to the ``GlobalCoordinator`` at admission, so reuse probability
    (Eq. 4), prefetch targeting (§4.3), tool TTLs (§4.2) and AFS
    work-remaining (Eq. 9) all operate on the true branch structure.
  * **dynamic** — a client callback decides the next step from prior
    step outputs and the tool observation, resolved deterministically
    at park/resume boundaries in virtual time (the tier-b/c path where
    ``PatternInferencer`` drives predictions).

``WorkflowInstance`` is the per-run execution cursor: it materializes
the taken path lazily, keeps O(1) cumulative context sums, and exposes
the Task-shaped surface the simulator schedules plus the token-id
realization the serving runtime prefills.
"""
from repro_torch.workflow.program import (AgentProgram, DynamicContext,
                                    StepSpec, WorkflowInstance,
                                    as_instance)

__all__ = ["AgentProgram", "DynamicContext", "StepSpec",
           "WorkflowInstance", "as_instance"]
