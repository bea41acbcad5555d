"""Benchmark helpers of the PyTorch port's benches (``*_torch.py``):
``emit``, ``save_json``, ``save_fingerprint`` and ``percentile`` as
``benchmarks/common.py`` has them, without its imports of the JAX
package, and the committed fingerprints the port is held to
(``pinned_summary``, ``check_fingerprint``).

Results go to ``benchmarks/results/`` under the names the callers give
(``serve_bench_torch_*``, ``soak_bench_torch*``), beside the reference's
files and never over them.
"""
from __future__ import annotations

import functools
import json
import operator
import os
from pathlib import Path

# the repo-wide percentile convention, from the port's copy of
# repro.obs.export (so the benches and report() agree digit for digit)
from repro_torch.obs.export import percentile  # noqa: F401

RESULTS = Path(__file__).resolve().parent / "results"
EXPECTED = Path(__file__).resolve().parent / "expected"


def emit(name: str, wall_s: float, derived: str) -> None:
    print(f"{name},{wall_s * 1e6:.0f},{derived}", flush=True)


def save_json(name: str, payload) -> None:
    RESULTS.mkdir(parents=True, exist_ok=True)
    (RESULTS / f"{name}.json").write_text(json.dumps(payload, indent=1,
                                                     default=str))


def save_fingerprint(name: str, text: str) -> Path:
    """Write a smoke run's summary bytes to
    ``benchmarks/results/<name>_fingerprint.txt``, atomically (temp file
    + ``os.replace``), so an interrupted run leaves no half file."""
    RESULTS.mkdir(parents=True, exist_ok=True)
    p = RESULTS / f"{name}_fingerprint.txt"
    tmp = p.with_suffix(".txt.tmp")
    tmp.write_text(text if text.endswith("\n") else text + "\n")
    os.replace(tmp, p)
    return p


def pinned_summary(rt) -> dict:
    """``rt.summarize()`` in the form the committed fingerprints hold.

    The files in ``benchmarks/expected/`` were written by a Python whose
    ``sum()`` adds floats left to right.  From Python 3.12 ``sum()``
    compensates its rounding (Neumaier), which moves the last digit of a
    mean: the disagg line's ``tct_mean`` reads 1.7193575476440566 there,
    the reference's own run included, against the file's
    1.7193575476440568.  So ``tct_mean`` is taken here as the
    left-to-right sum of the same sorted task completion times, over
    their count; every other key is ``summarize()``'s own."""
    out = rt.summarize()
    tcts = sorted(s.tct for s in rt.sessions.values() if s.finished_at >= 0)
    if tcts:
        out["tct_mean"] = float(functools.reduce(operator.add, tcts)
                                / len(tcts))
    return out


def check_fingerprint(name: str, text: str) -> None:
    """Raise unless ``text`` is, byte for byte, the committed
    ``benchmarks/expected/<name>_fingerprint.txt`` (which ends in a
    newline, as ``save_fingerprint`` writes it)."""
    want = (EXPECTED / f"{name}_fingerprint.txt").read_text()
    got = text if text.endswith("\n") else text + "\n"
    if got != want:
        raise AssertionError(
            f"fingerprint differs from benchmarks/expected/{name}_"
            f"fingerprint.txt:\n  expected {want!r}\n  got      {got!r}")
