"""Fixtures of the benchmark's tests: a checkout of tiny cells made from
new files alone, and the card where a test needs one.

Run from the root of the repository:

    python -m pytest -q port_bench/tests          # CPU
    python -m pytest -q -m cuda port_bench/tests  # on the card
"""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY = {"hidden_size": 64, "head_dim": 16, "intermediate_size": 128,
        "num_attention_heads": 4, "num_hidden_layers": 2,
        "num_key_value_heads": 2, "rms_norm_eps": 1e-5,
        "rope_theta": 10000.0, "sliding_window": None,
        "tie_word_embeddings": False, "torch_dtype": "bfloat16",
        "vocab_size": 256, "initializer_range": 0.05, "reduced": []}
# a matrix std of 0.05 at width 64 makes attention sharp enough that a
# decode round's lost K/V moves a greedy pick, and keeps bf16 serving
# within the reference's greedy pick on every seed tried
TINY_TRAFFIC = {"generator": "agent_sessions", "economics": "swe-bench",
                "n_agents": 5, "first_prompt": [20, 40], "prompt": [5, 10],
                "obs": [5, 20], "out": [4, 8], "max_len": 256,
                "max_gap_s": 0.5, "tasks_per_agent": 400}
TINY_CELL = {"n_slots": 2, "pool_blocks": 24,
             "perf": {"prefill_tokens_per_s": 20000.0,
                      "decode_round_s": 0.01},
             "sample_steps": 3,
             "limits": {"ctx_mismatch": 0, "out_mismatch": 0,
                        "kv_len_mismatch": 0}}
TINY_CELLS = ("tiny-dense-cell", "tiny-moe-cell")


def add_tiny_cells(root: Path) -> None:
    """Add two tiny cells to the checkout at ``root`` by new files and new
    entries alone: two configurations, a traffic mix, two cell files."""
    bench = root / "port_bench"
    configs = {"tiny-dense": dict(TINY, name="tiny-dense"),
               "tiny-moe": dict(TINY, name="tiny-moe", num_local_experts=4,
                                num_experts_per_tok=2)}
    for name, c in configs.items():
        (bench / "configs" / f"{name}.json").write_text(json.dumps(c))
    (bench / "traffic" / "tiny-agents.json").write_text(
        json.dumps(TINY_TRAFFIC))
    # dense: sound runs read a widest gap of 0 to 1.9e-3 on five seeds, the
    # planted faults 0.21 to 1.81; sparse: a routing near-tie can part a
    # pick by 0.37, so, as in mixtral's cell, the share of tokens over 1
    # logit, 0 % on five seeds
    limits = {TINY_CELLS[0]: {"logit_gap_max": 0.02},
              TINY_CELLS[1]: {"logit_gap_over_1": 10.0}}
    for cell in TINY_CELLS:
        c = dict(TINY_CELL, limits=dict(TINY_CELL["limits"], **limits[cell]))
        (bench / "cells" / f"{cell}.json").write_text(json.dumps(c))
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["configs"] += [{"name": n, "source": "tiny", "reduced": [],
                      "file": f"port_bench/configs/{n}.json", "why": "test"}
                     for n in configs]
    b["workloads"] += [{"name": cell, "config": cfg, "traffic": "tiny-agents",
                        "chips": 1, "why": "test"}
                       for cell, cfg in zip(TINY_CELLS, configs)]
    (root / "BENCHMARK.json").write_text(json.dumps(b))


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    """A copy of the benchmark's files with the tiny cells added."""
    root = tmp_path_factory.mktemp("checkout")
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(ROOT / "port_bench", root / "port_bench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    add_tiny_cells(root)
    return root


@pytest.fixture
def card():
    """The card, or a skip where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the port's CUDA kernels)")
    return torch.device("cuda")
