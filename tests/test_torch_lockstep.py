"""The port's copies of the reference's framework-free modules stay
verbatim: each is the reference file with ``repro`` renamed to
``repro_torch``, and nothing else."""
from pathlib import Path

import pytest

pytest.importorskip("torch")

SRC = Path(__file__).resolve().parents[1] / "src"
COPIES = (
    [f"configs/{p.name}" for p in sorted((SRC / "repro" / "configs")
                                         .glob("*.py"))]
    + [f"core/{p.name}" for p in sorted((SRC / "repro" / "core")
                                        .glob("*.py"))]
    + ["obs/__init__.py", "obs/metrics.py", "obs/tracer.py",
       "cluster/__init__.py", "cluster/workload.py",
       "workflow/__init__.py", "workflow/program.py",
       "serving/events.py", "serving/disagg.py", "serving/sanitizer.py",
       "serving/runtime.py", "serving/server.py", "serving/__init__.py",
       "cluster/perf.py", "cluster/faults.py", "cluster/simulator.py",
       "cluster/baselines.py", "obs/export.py",
       "serving/client.py", "serving/schema.py"]
    + [f"serving/frontend/{m}.py" for m in
       ("__init__", "clock", "driver", "proxy", "strategies", "tracker")]
    + [f"analysis/{m}.py" for m in
       ("__init__", "cfg", "determinism", "lifecycle", "sagalint")])


def test_copy_list_covers_the_runtime_import_closure():
    assert len(COPIES) == 54


@pytest.mark.parametrize("rel", COPIES)
def test_copy_is_verbatim(rel):
    ref = (SRC / "repro" / rel).read_text()
    copy = (SRC / "repro_torch" / rel).read_text()
    assert "repro_torch" not in ref
    assert copy.replace("repro_torch", "repro") == ref, \
        f"src/repro_torch/{rel} drifted from src/repro/{rel}"
