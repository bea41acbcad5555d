"""SAGA's contribution: workflow-atomic scheduling primitives.

Everything in this package is pure, deterministic Python (no jax): the
same objects drive both the discrete-event cluster simulator
(``repro_torch.cluster``) and the real JAX serving engine (``repro_torch.serving``).
"""
from repro_torch.core.aeg import AEG, AEGNode, PatternInferencer, ToolStats
from repro_torch.core.walru import CacheEntry, WALRUCache, EvictionWeights
from repro_torch.core.ttl import ToolTTLPolicy, memory_pressure
from repro_torch.core.belady import BeladyOracle, replay_policy, competitive_ratio
from repro_torch.core.affinity import SessionRouter
from repro_torch.core.stealing import WorkStealer
from repro_torch.core.afs import AFSScheduler, TenantState
from repro_torch.core.prefetch import SpeculativePrefetcher
from repro_torch.core.coordinator import GlobalCoordinator, SAGAConfig

__all__ = [
    "AEG", "AEGNode", "PatternInferencer", "ToolStats",
    "CacheEntry", "WALRUCache", "EvictionWeights",
    "ToolTTLPolicy", "memory_pressure",
    "BeladyOracle", "replay_policy", "competitive_ratio",
    "SessionRouter", "WorkStealer",
    "AFSScheduler", "TenantState",
    "SpeculativePrefetcher",
    "GlobalCoordinator", "SAGAConfig",
]
