"""Baseline scheduler matrix (paper §9.1 "Baselines").

Each baseline = a SimPolicy capturing what that system can and cannot
see.  The differences mirror §9.1.1's comparison points: session vs
prefix affinity, tool-call TTL, task-level fairness.
"""
from __future__ import annotations

from repro_torch.cluster.simulator import SimPolicy
from repro_torch.core.coordinator import SAGAConfig


def vllm() -> SimPolicy:
    """vLLM v0.6.0: FCFS, request-level, LRU KV pool, no affinity."""
    return SimPolicy(
        name="vllm",
        saga=SAGAConfig(cache_policy="none", enable_affinity=False,
                        enable_stealing=False, enable_ttl=False,
                        enable_prefetch=False, enable_afs=False,
                        observability="none"),
        routing="least", queue_discipline="fcfs")


def vllm_apc() -> SimPolicy:
    """vLLM v0.15.1 + Automatic Prefix Caching + PrefixCacheAffinityRouter:
    prefix-level (not session-level) affinity; LRU over session suffixes;
    no tool TTL."""
    return SimPolicy(
        name="vllm_apc",
        saga=SAGAConfig(cache_policy="prefix", prefix_fraction=0.35,
                        enable_affinity=False, enable_stealing=False,
                        enable_ttl=False, enable_prefetch=False,
                        enable_afs=False, observability="none"),
        routing="group", queue_discipline="fcfs")


def sglang() -> SimPolicy:
    """SGLang v0.5.8: RadixAttention + cache-aware load balancing —
    session-level affinity emerges from the radix router, but no
    workflow TTL / stealing / task fairness."""
    return SimPolicy(
        name="sglang",
        saga=SAGAConfig(cache_policy="prefix", prefix_fraction=0.45,
                        enable_affinity=True, enable_stealing=False,
                        enable_ttl=False, enable_prefetch=False,
                        enable_afs=False, observability="none"),
        routing="session", queue_discipline="fcfs")


def llumnix() -> SimPolicy:
    """Llumnix v1.2: vLLM + reactive live migration for load balance;
    no workflow awareness."""
    return SimPolicy(
        name="llumnix",
        saga=SAGAConfig(cache_policy="none", enable_affinity=False,
                        enable_stealing=True, enable_ttl=False,
                        enable_prefetch=False, enable_afs=False,
                        observability="none"),
        routing="least", queue_discipline="fcfs")


def trt_scaffolding() -> SimPolicy:
    """TRT-LLM v1.1 + Scaffolding: multi-step aware on a single node
    (KV Cache Connector) — sticky sessions + prefix reuse, but no
    cluster-wide scheduling."""
    return SimPolicy(
        name="trt_scaffolding",
        saga=SAGAConfig(cache_policy="prefix", prefix_fraction=0.45,
                        enable_affinity=True, enable_stealing=False,
                        enable_ttl=False, enable_prefetch=False,
                        enable_afs=False, observability="none"),
        routing="sticky", queue_discipline="fcfs")


def kvflow() -> SimPolicy:
    """KVFlow (our reimplementation): workflow-aware eviction + tool TTL
    via agent step graphs, but no distributed scheduling / fairness."""
    return SimPolicy(
        name="kvflow",
        saga=SAGAConfig(cache_policy="walru", enable_affinity=True,
                        enable_stealing=False, enable_ttl=True,
                        enable_prefetch=False, enable_afs=False,
                        observability="hints"),
        routing="sticky", queue_discipline="fcfs")


def saga(observability: str = "hints") -> SimPolicy:
    """Full SAGA."""
    return SimPolicy(
        name=f"saga[{observability}]",
        saga=SAGAConfig(cache_policy="walru", observability=observability),
        routing="session", queue_discipline="afs")


def saga_ablation(drop: str) -> SimPolicy:
    """Table 4: full SAGA minus one component."""
    cfg = SAGAConfig(cache_policy="walru", observability="hints")
    pol = SimPolicy(name=f"saga-w/o-{drop}", saga=cfg, routing="session",
                    queue_discipline="afs")
    if drop == "walru":
        cfg.cache_policy = "lru"
    elif drop == "ttl":
        cfg.enable_ttl = False
    elif drop == "prefetch":
        cfg.enable_prefetch = False
    elif drop == "affinity":
        cfg.enable_affinity = False
        pol.routing = "least"
    elif drop == "stealing":
        cfg.enable_stealing = False
    elif drop == "afs":
        cfg.enable_afs = False
        pol.queue_discipline = "fcfs"
    else:
        raise ValueError(drop)
    return pol


def strategy(name: str) -> SimPolicy:
    """Table 8: Pure BFS / Pure DFS / Hybrid execution strategies."""
    base = saga()
    if name == "bfs":
        base.name = "pure_bfs"
        base.admission_max_tasks = None       # admit everything
        base.saga.enable_ttl = False          # throughput-first: no holds
        base.saga.cache_policy = "lru"
    elif name == "dfs":
        base.name = "pure_dfs"
        base.admission_max_tasks = 24         # few tasks run to completion
    elif name == "hybrid":
        base.name = "hybrid"
        base.admission_max_tasks = 160        # SAGA's operating point
    else:
        raise ValueError(name)
    return base


ALL_BASELINES = {
    "vllm": vllm, "vllm_apc": vllm_apc, "sglang": sglang,
    "llumnix": llumnix, "trt_scaffolding": trt_scaffolding,
    "kvflow": kvflow, "saga": saga,
}
