"""What the benchmark may load: no top-level ``jax``, ``jaxlib``, ``flax``
or ``repro`` module (compared whole: ``repro_torch`` is the port), no
file of ``benchmarks/``, and a reference that imports nothing of the
program."""
from __future__ import annotations

import os
import re
import subprocess
import sys

from port_bench import spec

from conftest import ROOT


def test_names_compared_whole():
    ok = ["repro_torch", "repro_torch.serving.runtime", "jax_like",
          "reproduce", "port_bench.spec"]
    bad = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "repro",
           "repro.serving.runtime"]
    assert spec.forbidden_modules(ok) == []
    assert spec.forbidden_modules(ok + bad) == sorted(bad)


def _loaded(code: str) -> list:
    env = dict(os.environ, PYTHONPATH=f"{ROOT}:{ROOT / 'src'}")
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(sorted(sys.modules))"],
                         capture_output=True, text=True, env=env, cwd=ROOT,
                         check=True).stdout
    return eval(out.strip().splitlines()[-1])


def test_a_run_loads_no_jax(tiny_root):
    mods = _loaded(
        "import time\n"
        "from pathlib import Path\n"
        "from port_bench import harness, correct, run\n"
        "rec, host = harness.run('tiny-moe-cell', 5, 1.0, False,\n"
        "    time.perf_counter(), {'bf16_flops': 1e15,\n"
        "    'hbm_bytes_per_s': 3e12}, device='cpu',\n"
        f"    root=Path({str(tiny_root)!r}))\n"
        "correct.compare(rec, host, harness.sample_steps(rec, 5, 3))\n")
    assert "repro_torch.serving.runtime" in mods
    assert spec.forbidden_modules(mods) == []


def test_reference_imports_nothing_of_the_program():
    mods = _loaded("import port_bench.reference.model\n"
                   "import port_bench.correct\n")
    assert not [m for m in mods if m.split(".")[0] == "repro_torch"]


def test_nothing_reads_benchmarks():
    pat = re.compile(r"^\s*(from|import)\s+benchmarks\b|benchmarks/",
                     re.M)
    for path in (ROOT / "port_bench").rglob("*.py"):
        if "tests" in path.parts:
            continue
        assert not pat.search(path.read_text()), path
