"""Quickstart: SAGA's core mechanism in 60 lines.

Builds an Agent Execution Graph for a coding agent, replays a bursty
multi-session trace through WA-LRU vs LRU vs the Bélády oracle, and
prints the empirical competitive ratios (the paper's Table 2 pipeline).

    PYTHONPATH=src python examples/quickstart.py
"""
import random

from repro_torch.core.aeg import AEG, ToolStats
from repro_torch.core.belady import Access, BeladyOracle, competitive_ratio, \
    replay_policy
from repro_torch.core.ttl import ToolTTLPolicy
from repro_torch.core.walru import EvictionWeights, LRUCache, WALRUCache


def make_trace(n_tasks=40, steps=10, seed=0):
    rng = random.Random(seed)
    events = []
    for i in range(n_tasks):
        t = rng.uniform(0, 120.0)
        for s in range(steps):
            t += 0.5 + rng.choice([0.2, 0.2, 0.4, 3.0, 12.0])  # tool gap
            events.append(Access(
                t=t, session=f"task{i}", tokens=2000.0 + 900.0 * s,
                bytes_=10.0 * (1 + s), node_id=s,
                tool=rng.choice(["code_execution", "web_api"]),
                last=(s == steps - 1)))
    events.sort(key=lambda a: a.t)
    return events


def main():
    trace = make_trace()
    # capacity: live working set + 20% headroom (the contended regime)
    live, peak = {}, 0.0
    for a in trace:
        live.pop(a.session, None) if a.last else live.update(
            {a.session: a.bytes_})
        peak = max(peak, sum(live.values()))
    cap = 1.2 * peak

    # --- workflow knowledge: one AEG per task (here: a ReAct chain) ----
    aeg = AEG.linear_chain(["code_execution"] * 11, p_term=0.03)
    stats = ToolStats()
    stats.observe("code_execution", 700, 0.3)
    stats.observe("web_api", 700, 2.0)

    def p_reuse(entry):
        if entry.completed:
            return 0.0
        return aeg.p_reuse(min(entry.node_id, 9), entry.tokens, stats)

    ttl = ToolTTLPolicy()
    for tool, lat in [("code_execution", 0.3), ("web_api", 2.0)] * 20:
        ttl.observe(tool, lat * random.Random(0).uniform(0.3, 4.0))

    opt = BeladyOracle(cap).replay(trace)
    walru = replay_policy(
        trace, WALRUCache(cap, EvictionWeights(), p_reuse_fn=p_reuse),
        ttl_policy=ttl)
    lru = replay_policy(trace, LRUCache(cap))

    print(f"regeneration cost (tokens): OPT={opt:,.0f} "
          f"WA-LRU={walru:,.0f} LRU={lru:,.0f}")
    print(f"competitive ratio: WA-LRU={competitive_ratio(walru, opt):.2f} "
          f"LRU={competitive_ratio(lru, opt):.2f}  (paper: 1.31 vs 2.84)")


if __name__ == "__main__":
    main()
