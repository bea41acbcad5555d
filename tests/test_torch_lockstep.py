"""The port's copies of the reference's framework-free modules, and of the
two examples that import nothing else, stay verbatim: each is the
reference file with ``repro`` renamed to ``repro_torch``, and nothing
else."""
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
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
       ("__init__", "cfg", "determinism", "lifecycle", "sagalint")]
    + ["train/__init__.py", "train/data.py"])


def test_copy_list_covers_the_runtime_import_closure():
    assert len(COPIES) == 56


@pytest.mark.parametrize("rel", COPIES)
def test_copy_is_verbatim(rel):
    ref = (SRC / "repro" / rel).read_text()
    copy = (SRC / "repro_torch" / rel).read_text()
    assert "repro_torch" not in ref
    assert copy.replace("repro_torch", "repro") == ref, \
        f"src/repro_torch/{rel} drifted from src/repro/{rel}"


# examples/<name>_torch.py: copies of examples/<name>.py
EXAMPLE_COPIES = ("cluster_sim", "quickstart")


def test_example_copy_list_covers_the_framework_free_examples():
    assert len(EXAMPLE_COPIES) == 2


@pytest.mark.parametrize("name", EXAMPLE_COPIES)
def test_example_copy_is_verbatim(name):
    ref = (ROOT / "examples" / f"{name}.py").read_text()
    copy = (ROOT / "examples" / f"{name}_torch.py").read_text()
    assert "repro_torch" not in ref
    assert copy.replace("repro_torch", "repro") == ref, \
        f"examples/{name}_torch.py drifted from examples/{name}.py"
