"""The modules that the port's own packages advertise import without jax
and without the reference package: ``python -m repro_torch.obs.export``
(``obs/__init__.py``), ``client.SagaClient``, ``schema`` and ``frontend``
(``serving/__init__.py``), and the ``sagalint`` analyzer."""
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
BLOCK = ("import sys\n"
         "for name in ('jax', 'jaxlib', 'repro'):\n"
         "    sys.modules[name] = None\n")


def _run(code: str):
    return subprocess.run([sys.executable, "-c", BLOCK + code],
                          capture_output=True, text=True, cwd=ROOT,
                          timeout=120,
                          env={"PYTHONPATH": str(ROOT / "src"),
                               "PATH": "/usr/bin:/bin"})


@pytest.mark.parametrize("module, name", [
    ("repro_torch.obs.export", "main"),
    ("repro_torch.serving.client", "SagaClient"),
    ("repro_torch.serving.schema", "validate_stats"),
    ("repro_torch.serving.frontend", "AsyncServingDriver"),
    ("repro_torch.analysis.sagalint", "main"),
])
def test_advertised_entry_point_imports_with_jax_and_reference_blocked(
        module, name):
    res = _run(f"import importlib\n"
               f"mod = importlib.import_module({module!r})\n"
               f"assert callable(getattr(mod, {name!r}))\n"
               f"print(mod.__file__)\n")
    assert res.returncode == 0, res.stderr[-2000:]
    assert "src/repro_torch/" in res.stdout


def test_export_main_without_a_path_prints_its_usage():
    res = _run("from repro_torch.obs.export import main\n"
               "print('rc', main([]))\n")
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip() == "rc 2"
    assert res.stderr.startswith(
        "usage: python -m repro_torch.obs.export <trace.json>")
