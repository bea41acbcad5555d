"""The control on the card: the reference computed in fp8 (the step below
the configurations' bf16), put in the program's place, must come out not
correct under the cell's own limits where the program comes out
correct.  At a size a test run holds:
mistral-nemo-12b's widths and vocabulary at 2 of its 40 layers, 4 slots
of 2K tokens, a short window.  The cells' own readings, at their own
sizes, are in PERF.md (``calibrate.py``)."""
from __future__ import annotations

import json
import time

import pytest

from port_bench import correct, harness, spec

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def small_root(tmp_path_factory):
    import shutil
    from conftest import ROOT
    root = tmp_path_factory.mktemp("card")
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(ROOT / "port_bench", root / "port_bench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    bench = root / "port_bench"
    c = json.loads((bench / "configs" / "mistral-nemo-12b.json").read_text())
    c.update(name="nemo-2l", num_hidden_layers=2)
    (bench / "configs" / "nemo-2l.json").write_text(json.dumps(c))
    (bench / "traffic" / "small.json").write_text(json.dumps({
        "generator": "agent_sessions", "economics": "swe-bench",
        "n_agents": 6, "first_prompt": [300, 600], "prompt": [30, 80],
        "obs": [50, 300], "out": [30, 80], "max_len": 2048}))
    # the limit lies between the program's widest gap, 0.054 to 0.102, and
    # the control's, 1.15 to 1.80, on the three seeds below (H100)
    (bench / "cells" / "nemo-2l-small.json").write_text(json.dumps({
        "n_slots": 4, "pool_blocks": 128,
        "perf": {"prefill_tokens_per_s": 50000.0, "decode_round_s": 0.01},
        "sample_steps": 3,
        "limits": {"logit_gap_max": 0.5, "ctx_mismatch": 0,
                   "out_mismatch": 0, "kv_len_mismatch": 0}}))
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "nemo-2l", "source": "test", "reduced": [],
                         "file": "port_bench/configs/nemo-2l.json",
                         "why": "test"})
    b["workloads"].append({"name": "nemo-2l-small", "config": "nemo-2l",
                           "traffic": "small", "chips": 1, "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    return root


@pytest.mark.parametrize("seed", [4_100_000_001, 4_100_000_003,
                                  4_100_000_007])
def test_control_fails_where_the_program_passes(card, small_root, seed):
    peaks = spec.load_json(spec.BENCH / "peaks.json")
    peaks = next(iter(peaks.values()))
    rec, host = harness.run("nemo-2l-small", seed, 6.0, False,
                            time.perf_counter(), peaks, root=small_root)
    sizing = spec.cell("nemo-2l-small", small_root)["sizing"]
    sample = harness.sample_steps(rec, seed, sizing["sample_steps"])
    got = correct.compare(rec, host, sample, control=True)
    assert got["tokens_compared"] > 0
    assert correct.verdict(got, sizing["limits"]), got
    assert not correct.verdict(correct.as_control(got), sizing["limits"]), \
        got
