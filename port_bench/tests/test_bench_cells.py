"""A cell added from new files alone runs through the harness and comes
out correct (CPU, tiny configurations); with the timed path broken
underneath it comes out not correct, once for each fault a served cell
can have.  (The exchange between chips has no fault to plant: every cell
runs on one card.)"""
from __future__ import annotations

import time

import pytest
import torch

from port_bench import correct, harness, spec

from conftest import TINY_CELLS

PEAKS = {"bf16_flops": 989e12, "hbm_bytes_per_s": 3.35e12}


def _run(root, cell, seed, seconds=2.0, traced=False):
    rec, host = harness.run(cell, seed, seconds, traced,
                            time.perf_counter(), PEAKS, device="cpu",
                            root=root)
    c = spec.cell(cell, root)
    sample = harness.sample_steps(rec, seed, c["sizing"]["sample_steps"])
    numbers = correct.compare(rec, host, sample)
    ok = bool(sample) and correct.verdict(numbers, c["sizing"]["limits"])
    return rec, numbers, ok, c


@pytest.mark.parametrize("cell", TINY_CELLS)
def test_new_cell_from_files_alone(tiny_root, cell):
    rec, numbers, ok, c = _run(tiny_root, cell, 2_200_000_017)
    assert ok, numbers
    sample = harness.sample_steps(rec, 2_200_000_017,
                                  c["sizing"]["sample_steps"])
    assert {"hit", "regen"} <= {rec.steps[s][j].kind for s, j in sample}
    assert {rec.steps[s][j].slot for s, j in sample} == {0, 1}
    assert numbers["tokens_compared"] > 0
    for m in c["end_to_end"]:
        assert spec.reader(m["name"], tiny_root)(rec) > 0, m["name"]
    kinds = {s.kind for s in rec.window_steps()}
    assert {"hit", "regen"} <= kinds       # the tiny pool evicts


def _alter_tokens(monkeypatch):
    from repro_torch.serving.engine import Engine
    real = Engine.decode
    calls = [0]

    def decode(self, slot_tokens, n_steps=1):
        out = real(self, slot_tokens, n_steps)
        calls[0] += 1
        if calls[0] % 3 == 0:
            for s in out:
                out[s][0] = (out[s][0] + 1) % self.cfg.vocab
        return out

    monkeypatch.setattr(Engine, "decode", decode)


def _state_unchanged(monkeypatch):
    from repro_torch.models import layers
    monkeypatch.setattr(layers, "paged_kv_update",
                        lambda kp, vp, *a: (kp, vp))


def _half_batch(monkeypatch):
    from repro_torch.serving import engine
    real = engine.lm.decode_step_paged

    def step(*a, **k):
        logits, kp, vp = real(*a, **k)
        half = logits.shape[0] // 2
        logits = logits.clone()
        logits[half:] = logits[:logits.shape[0] - half]
        return logits, kp, vp

    monkeypatch.setattr(engine.lm, "decode_step_paged", step)


@pytest.mark.parametrize("fault", [_alter_tokens, _state_unchanged,
                                   _half_batch],
                         ids=["token_altered", "state_unchanged",
                              "half_batch"])
def test_faults_come_out_not_correct(tiny_root, fault, monkeypatch):
    fault(monkeypatch)
    _, numbers, ok, _ = _run(tiny_root, TINY_CELLS[0], 2_200_000_019,
                             seconds=4.0)
    assert not ok, numbers


def test_traced_run_on_the_cpu(tiny_root, monkeypatch):
    """The traced path runs (on the CPU the profiler sees no device, so
    the trace's metrics read nothing).  The profiler starts with the
    window here: a slow CPU's slices may outlast the usual lead."""
    monkeypatch.setattr(harness, "TRACE_AT", 0.0)
    rec, numbers, ok, c = _run(tiny_root, TINY_CELLS[1], 2_200_000_021,
                               seconds=4.0, traced=True)
    assert ok, numbers
    assert any(r.profiled for r in rec.rounds)
    assert any(profiled for _, _, profiled in rec.prefills)
    assert spec.reader("batch_rows_mean", tiny_root)(rec) > 0
    if not torch.cuda.is_available():
        assert rec.trace is None
