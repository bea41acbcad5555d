"""Distributed cluster runtime: discrete-event simulator, workload
generators (SWE-bench / WebArena / BurstGPT-like), baseline schedulers,
fault injection, metrics."""
