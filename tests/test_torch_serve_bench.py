"""The port's serve_bench twin (``benchmarks/serve_bench_torch.py``) on the
CPU: its three determinism fingerprints equal the committed
``benchmarks/expected/serve_bench{,_disagg,_asyncio}_fingerprint.txt``
byte for byte, in-process, also under ``SAGA_SANITIZE=1``; its
paged-vs-gather leg passes; and ``--smoke --device cpu`` (every leg, the
two ``PYTHONHASHSEED`` child processes) exits 0."""
import functools
import operator
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)           # tiny shapes: threads only add overhead

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmarks import serve_bench_torch as sb  # noqa: E402
from benchmarks.torch_common import check_fingerprint  # noqa: E402

FINGERPRINTS = {"serve_bench": sb._fingerprint,
                "serve_bench_disagg": sb._disagg_fingerprint,
                "serve_bench_asyncio": sb._asyncio_fingerprint}


@pytest.mark.parametrize("name", sorted(FINGERPRINTS))
def test_fingerprint_equals_the_committed_file(name):
    check_fingerprint(name, FINGERPRINTS[name]("cpu"))


def test_clean_fingerprint_under_the_sanitizer(monkeypatch):
    monkeypatch.setenv("SAGA_SANITIZE", "1")
    check_fingerprint("serve_bench", sb._fingerprint("cpu"))


def test_pinned_summary_changes_only_the_sum():
    """``pinned_summary`` differs from ``summarize()`` in ``tct_mean``
    alone, and there only by the summation: the left-to-right sum of the
    same times."""
    from benchmarks.torch_common import pinned_summary
    from repro_torch.configs import get_config, load_all
    from repro_torch.models import lm
    load_all()
    cfg = get_config("micro")
    params = lm.init_params(cfg, seed=0, device="cpu")
    rt, _ = sb.run_policy(cfg, params, sb.SAGAConfig(), sb._sessions(True))
    raw, pinned = rt.summarize(), pinned_summary(rt)
    tcts = sorted(s.tct for s in rt.sessions.values() if s.finished_at >= 0)
    assert {k: v for k, v in pinned.items() if k != "tct_mean"} == \
        {k: v for k, v in raw.items() if k != "tct_mean"}
    assert pinned["tct_mean"] == functools.reduce(operator.add, tcts) \
        / len(tcts)
    assert abs(pinned["tct_mean"] - raw["tct_mean"]) <= 4e-16 * raw[
        "tct_mean"]


def test_paged_vs_gather_leg():
    from repro_torch.configs import get_config, load_all
    from repro_torch.models import lm
    load_all()
    cfg = get_config("micro")
    out = sb.run_paged_gather_ab(cfg, lm.init_params(cfg, seed=0,
                                                     device="cpu"))
    assert out["paged_park_copy_bytes"] == 0
    assert out["gather_park_copy_bytes"] > 0
    assert out["gather_resume_copy_bytes"] > 0


def test_smoke_cli_exits_clean():
    res = subprocess.run(
        [sys.executable, "benchmarks/serve_bench_torch.py", "--smoke",
         "--device", "cpu"], capture_output=True, text=True, cwd=ROOT,
        timeout=600, env={"PYTHONPATH": f"{ROOT / 'src'}:{ROOT}",
                          "PATH": "/usr/bin:/bin"})
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    assert "smoke ok" in res.stdout
