"""The port's soak twin (``benchmarks/soak_bench_torch.py``) on the CPU at
a size that fits the test clock: 24 sessions through ``SagaClient`` ->
``AsyncServingDriver`` -> ``ServingRuntime`` on the port's engines while a
live ``SagaHTTPProxy`` on localhost answers completions (one streamed)
and ``/metrics``; conservation, the block audit, the pool mirrors and
span closure all clean (``_soak`` raises on any of them)."""
import asyncio
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)           # tiny shapes: threads only add overhead

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmarks import soak_bench_torch as soak  # noqa: E402


def test_soak_runs_clean():
    out = asyncio.run(soak._soak(24, 0.5, 0.02, "least-loaded", "cpu"))
    assert out["n_sessions"] >= 24 + 1          # + the HTTP session
    assert out["http_completions"] == 5
    assert out["decoded_tokens"] > 0
