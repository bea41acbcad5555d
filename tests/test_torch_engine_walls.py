"""``tools/wall_readers.py`` on the CPU: the readers of the engine's wall
spans, on hand-made spans of a window of three rounds and three
admissions, one of each profiled.  (The readers on a traced run of the
benchmark's tiny cells are ``port_bench/tests/test_engine_walls.py``.)"""
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from repro_torch.obs.tracer import Tracer  # noqa: E402
from tools import wall_readers as W  # noqa: E402

T = 1_700_000_000.0        # the spans' clock: seconds since the epoch
MS = 1e-3                  # a float's step there is 2.4e-4 ms


def _round(tr, t0, marks, rows=2, visible=12):
    """A round from ``t0`` whose prep, model, wait and commit end at the
    offsets ``marks``."""
    rid = tr.complete("engine", "round", t0, t0 + marks[-1], rows=rows,
                      n_steps=1, visible=visible)
    a = t0
    for name, m in zip(("round.prep", "round.model", "round.wait",
                        "round.commit"), marks):
        tr.complete("engine", name, a, t0 + m, parent=rid)
        a = t0 + m


def _admit(tr, t0, dur, kind, prefill):
    aid = tr.complete("engine", "admit", t0, t0 + dur, sid="x", kind=kind,
                      ctx=100, prefill=prefill, padded=prefill, slot=0)
    for name in ("admit.prefill", "admit.land", "admit.wait"):
        tr.complete("engine", name, t0, t0 + dur / 3, parent=aid)
        t0 += dur / 3


def _seen(t_call, t_end, profiled):
    return SimpleNamespace(t_call=t_call, t_end=t_end, profiled=profiled)


@pytest.fixture
def walls():
    """Admissions of 0.2, 0.1 and 0.09 s (first, hit, regen), each before
    a round of 50, 60 and 40 ms; the second round and the third
    admission profiled.  The device is busy from 10 ms into the profiled
    round's model phase to 5 ms into its commit."""
    tr = Tracer()
    _admit(tr, T + 0.0, 0.2, "first", 40)
    _round(tr, T + 0.3, [0.02, 0.03, 0.045, 0.05])
    _admit(tr, T + 0.4, 0.1, "hit", 10)
    _round(tr, T + 0.6, [0.01, 0.03, 0.05, 0.06])
    _admit(tr, T + 0.7, 0.09, "regen", 30)
    _round(tr, T + 0.8, [0.005, 0.02, 0.035, 0.04])
    rounds = [_seen(100.3, 100.35, False), _seen(100.6, 100.66, True),
              _seen(100.8, 100.84, False)]
    admissions = [_seen(100.0, 100.2, False), _seen(100.4, 100.5, False),
                  _seen(100.7, 100.79, True)]
    ns = round(T * 1e9)
    busy = [(ns + 610_000_000, ns + 630_000_000),
            (ns + 630_000_000, ns + 655_000_000)]
    return W.Walls(tr.spans, rounds, admissions, busy)


def test_nothing_to_read_reads_none(walls):
    empty = W.Walls([], walls.rounds, walls.admissions, walls.busy)
    line = W.wall_line(empty)
    assert line["metrics"] == dict.fromkeys(W.METRICS)
    assert [line[k] for k in ("profiled_rounds", "idle_by_phase_s",
                              "round_wall_gaps_ms", "host_gaps",
                              "n_round_spans")] == [None] * 4 + [0]
    assert W.profiled_rounds(W.Walls(walls.spans, walls.rounds,
                                     walls.admissions)) is None


def test_round_host_and_wait_over_unprofiled_rounds(walls):
    # rounds 1 and 3: walls 50 and 40 ms, waits 15 and 15 ms
    assert W.round_host_ms_mean(walls) == pytest.approx(30.0, abs=MS)
    assert W.round_wait_ms_mean(walls) == pytest.approx(15.0, abs=MS)


def test_profiled_rounds_and_idle_by_phase(walls):
    # the profiled round: prep [0, 10] idle 10, model [10, 30] busy from
    # 10, commit [50, 60] busy to 55: idle 10 + 0 + 5 ms of its 60
    p = W.profiled_rounds(walls)
    assert p["n"] == 1
    assert p["wall_ms_mean"] == pytest.approx(60.0, abs=MS)
    assert p["unprofiled_wall_ms_mean"] == pytest.approx(45.0, abs=MS)
    assert p["host_idle_ms_mean"] == pytest.approx(15.0, abs=MS)
    assert p["host_idle_share"] == pytest.approx(25.0, abs=1e-2)
    # the admissions lie outside the busy range
    assert W.idle_by_phase(walls) == pytest.approx(
        {"round.commit": 0.005, "round.model": 0.0, "round.prep": 0.01,
         "round.wait": 0.0}, abs=MS * 1e-3)


def test_runtime_host_share_leaves_the_profiler_out(walls):
    # outside the profiled round and admission: spans 0.2 + 0.05 + 0.1 +
    # 0.04 s, gaps between two of them 0.1 + 0.05 s
    assert W.runtime_host_share(walls) == pytest.approx(
        100 * 0.15 / 0.54, abs=1e-4)


def test_resume_regen_share_from_admit_meta(walls):
    assert W.resume_regen_share(walls) == pytest.approx(100 * 30 / 40)
    firsts = [sp for sp in walls.spans
              if sp.name != "admit" or sp.meta["kind"] == "first"]
    assert W.resume_regen_share(W.Walls(firsts, walls.rounds, [])) is None


def test_round_wall_gaps_and_host_gaps(walls):
    gaps = W.round_wall_gaps_ms(walls)
    assert gaps["unprofiled_max"] == pytest.approx(0.0, abs=MS)
    assert gaps["profiled_over_0.5"] == 0
    walls.rounds[2].t_end += 0.0007
    assert W.round_wall_gaps_ms(walls)["unprofiled_over_0.5"] == 1
    # the two longest, 0.1 s each: A1 -> R1, and A2 -> the profiled R2
    longest = W.host_gaps(walls, 2)
    assert [g[1] for g in longest] == pytest.approx([0.1, 0.1], abs=1e-6)
    assert sorted(g[2] for g in longest) == [False, True]


def test_mismatched_counts_raise(walls):
    with pytest.raises(ValueError, match="3 admit spans for 2"):
        W.runtime_host_share(W.Walls(walls.spans, walls.rounds,
                                     walls.admissions[1:]))
    with pytest.raises(ValueError, match="3 round spans for 4"):
        W.round_host_ms_mean(W.Walls(
            walls.spans, walls.rounds + [_seen(101.0, 101.1, False)], []))


def test_readers_on_a_hand_made_record(walls):
    line = W.wall_line(walls)
    assert set(line["metrics"]) == {
        "round_host_ms_mean", "round_wait_ms_mean", "runtime_host_share",
        "resume_regen_share"}
    assert all(v is not None for v in line["metrics"].values())
    assert line["n_round_spans"] == line["n_window_rounds"] == 3
    assert len(line["host_gaps"]) == 5
