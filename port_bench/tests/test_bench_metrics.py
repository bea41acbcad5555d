"""The metric readers' arithmetic on a hand-made record: a rate over the
whole window, a tail over every gap, a mean over every resume, and shares
that ignore what they must."""
from __future__ import annotations

import math

import pytest

from port_bench import spec, work
from port_bench.harness import Record, Round, StepLog, sample_steps
from port_bench.trace import TraceSummary, _kind, reduce_events

M = {"name": "m", "n_layers": 2, "d_model": 8, "n_heads": 4, "n_kv_heads": 2,
     "head_dim": 4, "d_ff": 16, "vocab": 32, "n_experts": 0, "top_k": 0,
     "window": 0}
PEAKS = {"bf16_flops": 1e9, "hbm_bytes_per_s": 1e8}


def _read(name, rec):
    return spec.reader(name)(rec)


def _step(kind, t_call, times, prefill=10, window=True, n_out=None):
    s = StepLog(kind, t_call, 100, prefill, n_out or len(times), window,
                False)
    s.times = list(times)
    s.tokens = [1] * len(times)
    return s


@pytest.fixture
def rec():
    r = Record(M, {}, PEAKS, 10.0, setup_s=3.5, t_window=(100.0, 110.0),
               n_slots=4, max_nb=8)
    # two rounds before the window, three in it (2 + 3 + 1 rows)
    r.rounds = [Round(99.0, 99.5, [("a", 5)], False, False),
                Round(99.5, 100.0, [("a", 6)], False, False),
                Round(100.0, 101.0, [("a", 7), ("b", 3)], True, False),
                Round(101.0, 102.5, [("a", 8), ("b", 4), ("c", 9)], True,
                      False),
                Round(102.5, 103.0, [("c", 10)], True, False)]
    r.steps = {
        "a": [_step("first", 98.0, [99.5, 100.0, 101.0, 102.5],
                    window=False)],
        "b": [_step("first", 90.0, [95.0], window=False),
              _step("hit", 100.2, [101.0, 102.5], prefill=30)],
        "c": [_step("first", 90.0, [91.0], window=False),
              _step("regen", 101.5, [102.5, 103.0], prefill=90)],
    }
    return r


def test_rate_over_the_whole_window(rec):
    assert _read("out_tokens_per_s", rec) == pytest.approx(6 / 10.0)


def test_tail_over_every_gap_in_the_window(rec):
    # gaps whose both ends lie in (100, 110]: a 1.0, 1.5; b 1.5; c 0.5
    gaps = sorted([1.0, 1.5, 1.5, 0.5])
    want = 1e3 * (gaps[2] + 0.97 * (gaps[3] - gaps[2]))
    assert _read("itl_ms_p99", rec) == pytest.approx(want)
    assert _read("itl_ms_p99.host", rec) == pytest.approx(want)


def test_mean_over_every_resume(rec):
    # b: 101.0 - 100.2, c: 102.5 - 101.5; first admissions never count
    assert _read("resume_ttft_ms_mean", rec) == pytest.approx(
        1e3 * (0.8 + 1.0) / 2)


def test_regen_share_ignores_first_admissions(rec):
    rec.steps["d"] = [_step("first", 100.5, [101.0], prefill=5000)]
    assert _read("regen_share", rec) == pytest.approx(100 * 90 / 120)


def test_sample_takes_resumes_partial_steps_and_over_half_the_slots():
    r = Record(M, {}, PEAKS, 10.0, t_window=(100.0, 110.0), n_slots=4)

    def step(kind, slot, times, n_out=None, ctx=100):
        s = _step(kind, 90.0, times, n_out=n_out)
        s.slot, s.ctx_len = slot, ctx
        return s

    r.steps = {
        "a": [step("first", 0, [101.0, 102.0], ctx=9000)],   # the longest
        "b": [step("first", 1, [95.0]),
              step("hit", 1, [108.0, 109.0], n_out=10)],     # still decoding
        "c": [step("first", 1, [96.0]),
              step("regen", 1, [109.5], n_out=10)],          # still decoding
        "d": [step("first", 2, [103.0])],
        "e": [step("first", 3, [104.0])],
        "f": [step("first", 0, [97.0])],                     # before it
    }
    for seed in range(20):
        got = sample_steps(r, seed, 2)
        # the longest, the hit and the regeneration however small n is,
        # then a step of a fresh slot: 3 of the 4 slots covered
        assert {("a", 0), ("b", 1), ("c", 1)} < set(got), got
        assert len(got) == 4 and ("f", 0) not in got, got
    assert len(sample_steps(r, 0, 6)) == 5


def test_batch_rows_and_setup(rec):
    assert _read("batch_rows_mean", rec) == pytest.approx(2.0)
    assert _read("setup_s", rec) == 3.5


def test_trace_metrics(rec):
    assert _read("serve_mfu", rec) is None
    for r in rec.rounds[2:4]:
        r.profiled = True
    rec.prefills = [(30, 32, True), (90, 96, False)]
    rec.trace = TraceSummary(2.0, 0.5, 40,
                             {"void paged_decode_kernel<128>": 0.01,
                              "paged_append_kernel": 0.002,
                              "flash_prefill_kernel<Cfg>": 0.02}, {}, [], [])
    assert _read("device_idle_share", rec) == pytest.approx(75.0)
    assert _read("launches_per_round", rec) == pytest.approx(20.0)
    flops = sum(work.token_flops(M, p + 1, True)
                for r in rec.rounds[2:4] for _, p in r.rows) \
        + work.prefill_flops(M, 30)
    assert _read("serve_mfu", rec) == pytest.approx(100 * flops / 2e9)
    least = 0.0
    for r in rec.rounds[2:4]:
        vis = sum(p + 1 for _, p in r.rows) + 4 - len(r.rows)
        fl, by = work.paged_decode_work(4, 4, 2, 4, 8, vis)
        least += 2 * max(fl / 1e9, by / 1e8)
        least += 2 * work.paged_append_work(4, 2, 4, len(r.rows))[1] / 1e8
    assert _read("paged_decode_roofline", rec) == pytest.approx(
        100 * least / 0.012)
    fl, by = work.flash_prefill_work(1, 32, 32, 4, 2, 4, 4)
    assert _read("flash_prefill_roofline", rec) == pytest.approx(
        100 * 2 * max(fl / 1e9, by / 1e8) / 0.02)


def test_round_hbm_share_leaves_profiled_rounds_out(rec):
    rounds = rec.window_rounds()
    nbytes = sum(work.round_bytes(M, len(r.rows),
                                  sum(p + 1 for _, p in r.rows))
                 for r in rounds)
    assert _read("round_hbm_share", rec) == pytest.approx(
        100 * nbytes / (3.0 * 1e8))
    rounds[0].profiled = True
    nbytes -= work.round_bytes(M, 2, 8 + 4)
    assert _read("round_hbm_share", rec) == pytest.approx(
        100 * nbytes / (2.0 * 1e8))


def test_counts_against_hand_counts():
    # one token at 3 visible positions, logits: per layer 2 * (4*4*8*2 +
    # 2*8*2*4 + 3*8*16) + 4 * 4 * 4 * 3, plus 2 * 8 * 32
    per_layer = 2 * (2 * 8 * 16 + 2 * 8 * 8 + 3 * 8 * 16) + 4 * 16 * 3
    assert work.token_flops(M, 3, True) == 2 * per_layer + 2 * 8 * 32
    moe = dict(M, n_experts=8, top_k=2)
    assert work.layer_matmul_params(moe) == \
        2 * 8 * 16 + 2 * 8 * 8 + 8 * 8 + 2 * 3 * 8 * 16
    # at many rows every expert is touched
    full = work.round_bytes(moe, 1000, 0)
    assert full == pytest.approx(
        2 * (2 * (work.layer_matmul_params(moe, False) + 16) + 8 + 256
             + 8000) + 2 * 2 * 2 * 4 * 2 * 1000 + 4 * 1000 * 32)
    assert work.visible_pairs(5, 5, True, 0) == 15


def test_reduce_events_busy_and_gaps():
    ev = [("kernel", "k1", 0, 100, True), ("kernel", "k2", 50, 150, True),
          ("gpu_memcpy", "Memcpy DtoH", 300, 400, True),
          ("user_annotation", "bench.decode", 0, 500, False),
          ("cpu_op", "aten::item", 140, 320, False)]
    s = reduce_events(ev, 1e-6)
    assert s.busy_s == pytest.approx(250e-9)
    assert s.launches == 2
    assert s.idle_gaps == [("bench.decode > aten::item",
                            pytest.approx(150e-9))]
    assert reduce_events(ev[3:], 1.0) is None
    assert not math.isnan(s.window_s)


class _OldEvent:
    """A kineto event of a build without ``activity_type``."""

    def __init__(self, name, annotation):
        self._name, self._ann = name, annotation

    def name(self):
        return self._name

    def is_user_annotation(self):
        return self._ann


def test_event_kinds_without_activity_type():
    assert _kind(_OldEvent("bench.decode", True), False) == "user_annotation"
    assert _kind(_OldEvent("bench.decode", True), True) == \
        "gpu_user_annotation"
    assert _kind(_OldEvent("aten::mm", False), False) == "cpu_op"
    assert _kind(_OldEvent("Memcpy DtoH (Device -> Pinned)", False),
                 True) == "gpu_memcpy"
    assert _kind(_OldEvent("Memset (Device)", False), True) == "gpu_memset"
    assert _kind(_OldEvent("void paged_decode_kernel<128>", False),
                 True) == "kernel"
