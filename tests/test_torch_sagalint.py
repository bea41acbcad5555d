"""Twin of tests/test_sagalint.py on the port: the reference's tests, run on
the ``repro_torch`` copies (see
tests/torch_twin.py)."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)           # tiny shapes: threads only add overhead

from torch_twin import twin_source  # noqa: E402

exec(compile(twin_source("test_sagalint.py"), __file__, "exec"))


def test_sagalint_cli_reports_no_finding_on_the_port():
    """``python -m repro_torch.analysis.sagalint src/repro_torch``, as a
    user runs it, exits 0 with no finding."""
    import subprocess
    import sys
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.sagalint",
         "src/repro_torch"], capture_output=True, text=True, cwd=REPO,
        timeout=120, env={"PYTHONPATH": str(REPO / "src"),
                          "PATH": "/usr/bin:/bin"})
    assert res.returncode == 0, res.stdout + res.stderr
    assert "sagalint: 0 finding(s)" in res.stderr, res.stderr
