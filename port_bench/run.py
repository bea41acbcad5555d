"""The port's benchmark: one run of one cell.

    python3 port_bench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  The cell (``BENCHMARK.json``'s workload of
that name) names its configuration, traffic and sizing files; the run
makes its weights and traffic from ``--seed``, warms up (set-up), measures
``--seconds`` of wall time, then holds what the timed path served to the
plain reference.  The last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device``, with
``--trace 1`` also ``breakdown``, and last ``checks``: each compared
number beside its limit, which also end standard error.

Exits 1 with no result where CUDA is missing or a module of JAX or of
the JAX package was loaded.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

from port_bench import correct, harness, spec  # noqa: E402


def _fail(msg: str) -> None:
    print(msg, file=sys.stderr)
    sys.exit(1)


def _finite(x):
    return None if isinstance(x, float) and x != x else x


def peaks_for(kind: str) -> dict:
    table = spec.load_json(spec.BENCH / "peaks.json")
    for name, p in table.items():
        if name == kind:
            return p
    _fail(f"no published peaks for {kind!r} in port_bench/peaks.json")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    c = spec.cell(args.workload)
    want = c["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < want:
        _fail(f"{args.workload} needs {want} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    kind = torch.cuda.get_device_name(0)
    peaks = peaks_for(kind)
    traced = bool(args.trace)
    rec, host = harness.run(args.workload, args.seed, args.seconds, traced,
                            T_PROCESS, peaks)
    found = spec.forbidden_modules()
    if found:
        _fail("modules of JAX or the JAX package were loaded: "
              + ", ".join(found))

    metrics = {}
    for m in (c["per_layer"] if traced else c["end_to_end"]):
        value = spec.reader(m["name"])(rec)
        if value is None:
            if not traced:
                _fail(f"end-to-end metric {m['name']} read nothing")
            continue
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    sz = c["sizing"]
    kinds = {}
    for s in rec.window_steps():
        kinds[s.kind] = kinds.get(s.kind, 0) + 1
    print(f"run: setup {rec.setup_s:.2f} s, window "
          f"{rec.t_window[1] - rec.t_window[0]:.2f} s, "
          f"{len(rec.window_rounds())} rounds, admissions {kinds}, "
          f"memory peak {rec.memory_peak}", file=sys.stderr)
    if traced:
        calm = [r for r in rec.window_rounds() if not r.profiled]
        pf = [s for s in rec.window_steps() if not s.profiled]
        print(f"run: untraced part of the traced window: round wall mean "
              f"{sum(r.t_end - r.t_call for r in calm) / max(1, len(calm))}"
              f" s; prefill {sum(s.prefill for s in pf)} tokens in "
              f"{sum(s.t_ret - s.t_call for s in pf)} s", file=sys.stderr)
    t_ref = time.perf_counter()
    sample = harness.sample_steps(rec, args.seed, sz["sample_steps"])
    numbers = correct.compare(rec, host, sample)
    print(f"run: reference {time.perf_counter() - t_ref:.2f} s over "
          f"{[(s, j, rec.steps[s][j].kind) for s, j in sample]}",
          file=sys.stderr)
    limits = sz["limits"]
    ok = bool(sample) and correct.verdict(numbers, limits)
    checks = {k: {"value": _finite(numbers[k]), "limit": lim}
              for k, lim in limits.items()}
    for k in sorted(set(numbers) - set(limits)):
        checks[k] = {"value": _finite(numbers[k]), "limit": None}

    device = {"platform": "gpu", "kind": kind, "count": want,
              "memory_peak_bytes": rec.memory_peak}
    out = {"correct": ok,
           "attempted": len(rec.window_steps()),
           "failed": 0,
           "metrics": metrics,
           "device": device}
    if traced:
        if rec.trace is None:
            _fail("the traced window ran nothing on the device")
        device["busy_s"] = rec.trace.busy_s
        device["window_s"] = rec.trace.window_s
        out["breakdown"] = {"device_ops": rec.trace.device_ops,
                            "idle_gaps": rec.trace.idle_gaps}
    out["checks"] = checks
    for k, v in checks.items():
        print(f"check {k}: {v['value']} (limit {v['limit']})",
              file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
