"""The traffic generator: the same work for every seed, in another order;
token ids drawn from the seed; the frozen economics' ranges."""
from __future__ import annotations

import numpy as np

from port_bench import spec, traffic

SWE = spec.traffic_mix("swe-agents-16")


def _agents(n, seed, vocab):
    return traffic.Agents(dict(SWE, n_agents=n), seed, vocab)


def _sizes(agents, a, r):
    t = agents.task(a, r)
    return [(len(p), n, tool, gap) for p, n, tool, gap in t.steps]


def test_same_seed_same_tasks():
    a, b = (_agents(6, 4_000_000_123, 131072) for _ in range(2))
    for ag in range(6):
        ta, tb = a.task(ag, 0), b.task(ag, 0)
        assert ta.session_id == tb.session_id
        assert all(np.array_equal(x, y)
                   for x, y in zip(ta.prompts, tb.prompts))
        assert ta.steps == tb.steps


def test_seeds_share_one_schedule():
    a = _agents(8, 1, 32768)
    b = _agents(8, 2, 32768)
    for r in range(len(a.rounds)):
        assert [_sizes(a, ag, r) for ag in range(8)] == \
            [_sizes(b, ag, r) for ag in range(8)]
    assert not np.array_equal(a.task(0, 0).prompts[0][:50],
                              b.task(0, 0).prompts[0][:50])


def test_lengths_within_the_economics():
    vocab = 32768
    ag = _agents(24, 7, vocab)
    joined = 0
    for a in range(24):
        for r in range(len(ag.rounds)):
            plan = ag.rounds[r][a]
            t = ag.task(a, r)
            ctx = 0
            for k, (ids, n_out, tool, gap) in enumerate(t.steps):
                assert 1 <= min(ids) and max(ids) < vocab
                assert 100 <= n_out < 500
                assert 0 < gap <= SWE["max_gap_s"]
                assert tool in SWE["tools"]
                if k == 0 and plan.join == 0:
                    assert 2000 <= len(ids) < 4000
                elif k > 0:
                    assert 150 + 300 <= len(ids) < 500 + 3000
                ctx += len(ids) + n_out
            assert ctx <= SWE["max_len"]
            joined += plan.join > 0
    assert joined > 0            # first tasks join mid-way


def test_first_task_carries_its_history():
    ag = _agents(16, 11, 1000)
    for a in range(16):
        plan = ag.rounds[0][a]
        t = ag.task(a, 0)
        hist = sum(p + o for p, o, _, _ in plan.steps[:plan.join])
        assert len(t.prompts[0]) == hist + plan.steps[plan.join][0]
        assert len(t.steps) == len(plan.steps) - plan.join
