"""The engine's wall-clock spans (``Engine.wall``) on the CPU: micro served
through ``ServingRuntime`` as the benchmark's cells drive it (one engine,
``SAGAConfig()`` as shipped, a pool small enough that the policy evicts, so
every kind of admission occurs), in paged and in gather mode.

The spans are closed and nested, a round's phases tile it, turning them on
changes nothing the engine serves or counts (and with them off the engine
reads no clock), their meta sums to the engine's counters, each
admission's kind is the one an outside observer reading ``pool.has``
before the call gives, and the clock they are stamped with is the one
``torch.profiler`` stamps its events with."""
import collections

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)           # tiny shapes: threads only add overhead

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.coordinator import SAGAConfig  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.obs.tracer import ROOT, Tracer  # noqa: E402
from repro_torch.serving import engine as engine_mod  # noqa: E402
from repro_torch.serving.engine import (ROUND_PHASES, Engine,  # noqa: E402
                                        wall_clock)
from repro_torch.serving.runtime import (AgentRequest,  # noqa: E402
                                         RuntimePerf, ServingRuntime)

CFG = get_config("micro")
ADMIT_PHASES = ("admit.prefill", "admit.land", "admit.wait")


def _requests(n=6, n_steps=4, seed=0):
    """Agents whose first prompt is 20-40 tokens, later steps 5-10 new
    tokens and 4-8 out, tool gaps of 0.2-0.5 virtual s."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        steps = []
        for s in range(n_steps):
            k = rng.randint(20, 41) if s == 0 else rng.randint(5, 11)
            steps.append((list(map(int, rng.randint(1, CFG.vocab, size=k))),
                          int(rng.randint(4, 9)), "code_execution",
                          float(rng.uniform(0.2, 0.5))))
        out.append(AgentRequest(f"s{i}", "t0", steps))
    return out


@pytest.fixture(scope="module")
def params():
    return lm.init_params(CFG, seed=0, device="cpu")


def _serve(params, paged, wall):
    """Serve ``_requests`` on one engine of 2 slots and a pool of 16
    blocks (one max context): returns the runtime, its engine and each
    admission's kind as the harness tells it (``pool.has`` read before
    the call, a session seen before)."""
    rt = ServingRuntime(CFG, params, n_workers=1, saga=SAGAConfig(),
                        n_slots=2, max_len=256, pool_blocks=16,
                        perf=RuntimePerf(prefill_tokens_per_s=20000.0,
                                         decode_round_s=0.01),
                        seed=0, sanitize=False, trace=False, paged=paged)
    eng = rt.engines[0]
    if wall:
        eng.wall = Tracer()
    outside, seen = [], set()
    served = eng.start_session

    def start_session(sid, tokens, cached_hit):
        hit = bool(cached_hit) and eng.pool.has(sid)
        outside.append((sid, "hit" if hit else
                        "regen" if sid in seen else "first"))
        seen.add(sid)
        return served(sid, tokens, cached_hit)

    eng.start_session = start_session
    for r in _requests():
        rt.submit(r)
    rt.run()
    rt.check_conservation()
    return rt, eng, outside


@pytest.fixture(scope="module", params=[True, False], ids=["paged",
                                                          "gather"])
def served(request, params):
    return _serve(params, request.param, wall=True)


def _top(tracer, name):
    return [sp for sp in tracer.spans if sp.name == name]


def test_spans_closed_and_nested(served):
    _, eng, _ = served
    tr = eng.wall
    tr.check_closed()
    kids = tr.children()
    top = kids[ROOT]
    assert {sp.name for sp in top} == {"admit", "round"}
    assert all(sp.track == "engine" for sp in tr.spans)
    # the engine's calls do not overlap
    for a, b in zip(top, top[1:]):
        assert a.t1 <= b.t0
    for sp in top:
        names = [c.name for c in kids.get(sp.span_id, [])]
        if sp.name == "admit":
            assert names == list(ADMIT_PHASES)
        else:
            assert names == list(ROUND_PHASES) * sp.meta["n_steps"]
        for c in kids[sp.span_id]:
            assert sp.t0 <= c.t0 <= c.t1 <= sp.t1
            assert c.span_id not in kids           # two levels only
    assert len(top) + sum(len(kids[sp.span_id]) for sp in top) \
        == len(tr.spans)


def test_round_phases_tile_the_round(served):
    _, eng, _ = served
    kids = eng.wall.children()
    rounds = _top(eng.wall, "round")
    assert rounds
    for r in rounds:
        phases = kids[r.span_id]
        assert sum(c.dur for c in phases) == pytest.approx(r.dur, rel=0.02)
        assert phases[0].t0 == r.t0 and phases[-1].t1 == r.t1


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "gather"])
def test_each_phase_holds_the_call_it_names(params, paged):
    """Every call of the engine's phase methods lies inside a span of the
    phase named for it: admissions (first, hit with a delta) and rounds
    of one and two steps."""
    eng = Engine(CFG, params, n_slots=2, max_len=128, pool_blocks=16,
                 paged=paged)
    phases = {"_prefill_kv": "admit.prefill", "_land": "admit.land",
              "_round_inputs": "round.prep", "_round_model": "round.model",
              "_round_ids": "round.wait", "_round_commit": "round.commit"}
    calls = collections.defaultdict(list)
    for meth, phase in phases.items():
        def timed(*a, _real=getattr(eng, meth), _phase=phase, **k):
            t0 = wall_clock()
            out = _real(*a, **k)
            calls[_phase].append((t0, wall_clock()))
            return out
        setattr(eng, meth, timed)
    eng.wall = Tracer()
    prompt = np.arange(1, 41, dtype=np.int32)
    cur = {eng.start_session("a", prompt, False): 5,
           eng.start_session("b", prompt[:30], False): 6}
    for n_steps in (1, 2):
        out = eng.decode(cur, n_steps=n_steps)
        cur = {s: o[-1] for s, o in out.items()}
    assert eng.park_session("a")
    eng.start_session("a", np.arange(1, 51, dtype=np.int32), True)
    spans = collections.defaultdict(list)
    for sp in eng.wall.spans:
        spans[sp.name].append(sp)
    assert [sp.meta["kind"] for sp in spans["admit"]] == \
        ["first", "first", "hit"]
    assert {len(calls[p]) for p in ADMIT_PHASES[:2]} == {3}
    assert {len(calls[p]) for p in ROUND_PHASES} == {3}
    for phase, cs in calls.items():
        for a, b in cs:
            assert any(sp.t0 <= a and b <= sp.t1 for sp in spans[phase]), \
                (phase, a, b)


def test_span_meta_sums_to_counters(served):
    rt, eng, outside = served
    tr = eng.wall
    admits = _top(tr, "admit")
    rounds = _top(tr, "round")
    kinds = collections.Counter(sp.meta["kind"] for sp in admits)
    assert kinds["first"] == 6 and kinds["hit"] and kinds["regen"], kinds
    # each admission's kind is the one seen from outside
    assert [(sp.meta["sid"], sp.meta["kind"]) for sp in admits] == outside
    assert sum(sp.meta["prefill"] for sp in admits) == eng.prefill_tokens
    assert sum(sp.meta["ctx"] for sp in admits
               if sp.meta["kind"] != "hit") == eng.regen_tokens
    assert {sp.meta["sid"] for sp in admits
            if sp.meta["kind"] == "first"} == {f"s{i}" for i in range(6)}
    resumed = sum(sp.meta["prefill"] for sp in admits
                  if sp.meta["kind"] != "first")
    regen = sum(sp.meta["prefill"] for sp in admits
                if sp.meta["kind"] == "regen")
    assert 0 < regen < resumed
    assert sum(sp.meta["n_steps"] for sp in rounds) == eng.decode_steps
    decoded = sum(len(o) for ses in rt.sessions.values()
                  for o in ses.step_outputs)
    assert sum(sp.meta["rows"] * sp.meta["n_steps"] for sp in rounds) \
        == decoded
    for sp in admits:
        m = sp.meta
        assert m["prefill"] <= m["ctx"] and 0 <= m["slot"] < eng.n_slots
        assert m["padded"] == (eng._pad_len(m["prefill"]) if m["prefill"]
                               else 0)
        if m["kind"] != "hit":
            assert m["prefill"] == m["ctx"]


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "gather"])
def test_wall_off_changes_nothing_and_reads_no_clock(params, paged,
                                                     monkeypatch):
    rt_on, eng_on, kinds_on = _serve(params, paged, wall=True)

    def no_clock():
        raise AssertionError("the engine read the clock with wall off")

    monkeypatch.setattr(engine_mod, "wall_clock", no_clock)
    rt_off, eng_off, kinds_off = _serve(params, paged, wall=False)
    assert eng_off.wall is None and eng_off._wall_seen is None
    assert repr(rt_on.summarize()) == repr(rt_off.summarize())
    assert rt_on.stats() == rt_off.stats()
    assert kinds_on == kinds_off
    for sid, ses in rt_on.sessions.items():
        assert ses.step_outputs == rt_off.sessions[sid].step_outputs
        assert ses.ctx == rt_off.sessions[sid].ctx
    a, b = eng_on.pool, eng_off.pool
    assert (a.tables, a.lens, list(a.free), sorted(a.resident)) == \
        (b.tables, b.lens, list(b.free), sorted(b.resident))
    assert [(s.session_id, s.length) for s in eng_on.slots] == \
        [(s.session_id, s.length) for s in eng_off.slots]
    for x, y in ((a.k_pool, b.k_pool), (a.v_pool, b.v_pool)):
        assert torch.equal(x, y)


def test_counts_live_and_die_with_the_recorder(params):
    """The ids seen while ``wall`` is set outlive a tracer swapped for
    another (a regeneration is still told from a first admission); set to
    None, they are dropped."""
    eng = Engine(CFG, params, n_slots=2, max_len=128, pool_blocks=16)
    prompt = np.arange(1, 41, dtype=np.int32)
    assert eng.wall is None and eng._wall_seen is None

    def admit(tokens, cached_hit):
        eng.wall = Tracer() if eng.wall is not None else None
        eng.start_session("a", tokens, cached_hit)
        (sp,) = _top(eng.wall, "admit")
        return sp.meta["kind"], sp.meta["prefill"]

    eng.wall = Tracer()
    assert admit(prompt, False) == ("first", 40)
    assert eng.park_session("a")
    assert admit(np.concatenate([prompt, prompt[:7]]), True) == ("hit", 7)
    eng.release_session("a")
    assert admit(prompt, False) == ("regen", 40)
    assert eng._wall_seen == {"a"}
    eng.release_session("a")
    eng.wall = None
    assert eng._wall_seen is None
    eng.wall = Tracer()
    assert admit(prompt, False) == ("first", 40)


def test_wall_clock_is_the_profilers_clock():
    """A span stamped by ``wall_clock`` inside ``record_function`` lies
    within that kineto event's [start_ns, end_ns]."""
    tr = Tracer()
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        for i in range(5):
            with torch.profiler.record_function(f"probe{i}"):
                t0 = wall_clock()
                torch.ones(64).sum()
                tr.complete("engine", f"probe{i}", t0, wall_clock())
    events = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("probe")}
    assert len(events) == 5
    for sp in tr.spans:
        e = events[sp.name]
        assert e.start_ns() <= round(sp.t0 * 1e9) <= round(sp.t1 * 1e9) \
            <= e.start_ns() + e.duration_ns(), (sp, e.start_ns(),
                                                e.duration_ns())
