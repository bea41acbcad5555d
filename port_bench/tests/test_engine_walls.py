"""The engine's wall spans (``Engine.wall``) through the harness, with
``tools/engine_walls.py`` switching them on from outside it (CPU, tiny
cells): the harness's own readers are unmoved by the fields the tool adds
(``Record.spans``, ``TraceSummary.busy``), a traced run holds one
``round`` span per window ``Round``, and the engine's admission kinds are
the harness's, so ``resume_regen_share`` reads ``regen_share``.  Once the
harness takes the switch itself, these move onto its ``Recorder``."""
from __future__ import annotations

import collections
import json
import time

import pytest

from port_bench import correct, harness, spec
from port_bench.harness import Record, Round, StepLog
from port_bench.trace import TraceSummary
from repro_torch.obs.tracer import Tracer
from tools import engine_walls as EW

from conftest import ROOT, TINY_CELLS

M = {"name": "m", "n_layers": 2, "d_model": 8, "n_heads": 4, "n_kv_heads": 2,
     "head_dim": 4, "d_ff": 16, "vocab": 32, "n_experts": 0, "top_k": 0,
     "window": 0}
PEAKS = {"bf16_flops": 1e9, "hbm_bytes_per_s": 1e8}


def _step(kind, t_call, times, prefill=10, window=True, profiled=False):
    s = StepLog(kind, t_call, 100, prefill, len(times), window, profiled)
    s.times, s.tokens, s.t_ret = list(times), [1] * len(times), t_call + .1
    return s


def _rec():
    r = Record(M, {}, PEAKS, 10.0, setup_s=3.5, t_window=(100.0, 110.0),
               n_slots=4, max_nb=8)
    r.rounds = [Round(99.0, 99.5, [("a", 5)], False, False),
                Round(100.3, 100.35, [("a", 7), ("b", 3)], True, False),
                Round(100.6, 100.66, [("a", 8), ("b", 4)], True, True),
                Round(100.8, 100.84, [("a", 9), ("c", 9)], True, False)]
    r.steps = {"a": [_step("first", 98.0, [99.5, 100.35, 100.66, 100.84],
                           window=False)],
               "d": [_step("first", 100.0, [100.35], prefill=40)],
               "b": [_step("first", 90.0, [95.0], window=False),
                     _step("hit", 100.2, [100.35, 100.66], prefill=10)],
               "c": [_step("first", 90.0, [91.0], window=False),
                     _step("regen", 100.7, [100.84], prefill=30,
                           profiled=True)]}
    r.prefills = [(10, 32, False), (30, 32, True)]
    r.trace = TraceSummary(2.0, 0.5, 40,
                           {"void paged_decode_kernel<128>": 0.01,
                            "paged_append_kernel": 0.002,
                            "flash_prefill_kernel<Cfg>": 0.02}, {}, [], [])
    return r


def test_existing_readers_unmoved_by_the_new_fields():
    rec = _rec()
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    before = {n: spec.reader(n)(rec) for n in names}
    assert sum(v is not None for v in before.values()) == len(names)
    tr = Tracer()
    rid = tr.complete("engine", "round", 0.0, 0.05, rows=2, n_steps=1,
                      visible=12)
    tr.complete("engine", "round.prep", 0.0, 0.05, parent=rid)
    rec.spans = tr.spans
    rec.trace.busy = [(0, 10), (20, 30)]
    assert {n: spec.reader(n)(rec) for n in names} == before


@pytest.mark.parametrize("i", [0, 1], ids=["dense", "moe"])
def test_traced_tiny_cell_with_wall_spans(tiny_root, i, monkeypatch):
    cell, seed = TINY_CELLS[i], 2_200_000_021 + i
    monkeypatch.setattr(harness, "TRACE_AT", 0.0)
    with EW.wall_on() as recs:
        rec, host = harness.run(cell, seed, 4.0, True, time.perf_counter(),
                                PEAKS, device="cpu", root=tiny_root)
    assert recs == [rec] and harness.Recorder is not EW.WallRecorder
    line = EW.W.wall_line(EW.walls(rec))
    assert line["n_round_spans"] == line["n_window_rounds"] > 0
    assert len(line["host_gaps"]) == 5
    # the engine's kinds are the harness's, admission by admission
    admits = [sp.meta for sp in rec.spans if sp.name == "admit"]
    engine_side = collections.Counter(
        (m["sid"], m["kind"], m["prefill"]) for m in admits)
    harness_side = collections.Counter(
        (sid, s.kind, s.prefill) for sid, steps in rec.steps.items()
        for s in steps if s.window)
    assert engine_side == harness_side
    assert {"hit", "regen"} <= {m["kind"] for m in admits}
    regen = spec.reader("regen_share", tiny_root)(rec)
    assert regen is not None
    assert line["metrics"]["resume_regen_share"] == pytest.approx(regen)
    assert line["metrics"]["round_host_ms_mean"] > 0
    assert 0 <= line["metrics"]["runtime_host_share"] < 100
    # the served path is still the reference's
    c = spec.cell(cell, tiny_root)
    sample = harness.sample_steps(rec, seed, c["sizing"]["sample_steps"])
    numbers = correct.compare(rec, host, sample)
    assert sample and correct.verdict(numbers, c["sizing"]["limits"]), \
        numbers
