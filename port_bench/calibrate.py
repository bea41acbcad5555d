"""Readings that set a cell's limits: the program's compared numbers over
many seeds and, on those of them named in ``--control-seeds``, the
control's (the reference in fp8 in the program's place,
``reference.model``), all in one process so the import and the kernels'
build are paid once.

    python3 port_bench/calibrate.py --workload <name> --seeds 1,2,3 \\
        --seconds 20 [--control-seeds 1,2]

Each seed makes its own weights and traffic, warms up, serves a window of
``--seconds`` at the cell's own load, and compares the same sample a run
of the benchmark does.  One JSON line a seed, with the program's verdict
under the cell's limits (``correct``) and, on a control seed, the
control's (``control_correct``: its gaps judged by the same limits, in
the program's place).  Exits 1 where a control comes out correct.  The
benchmark's runs never run this.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

from port_bench import correct, harness, spec  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate needs the card", file=sys.stderr)
        return 1
    c = spec.cell(args.workload)
    limits = c["sizing"]["limits"]
    peaks = spec.load_json(spec.BENCH / "peaks.json")[
        torch.cuda.get_device_name(0)]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    t = T_PROCESS
    control_passed = False
    for seed in (int(s) for s in args.seeds.split(",")):
        rec, host = harness.run(args.workload, seed, args.seconds, False, t,
                                peaks)
        t0 = time.perf_counter()
        sample = harness.sample_steps(rec, seed,
                                      c["sizing"]["sample_steps"])
        control = seed in controls
        numbers = correct.compare(rec, host, sample, control=control)
        line = {"workload": args.workload, "seed": seed,
                "correct": bool(sample) and correct.verdict(numbers, limits)}
        if control:
            line["control_correct"] = bool(sample) and correct.verdict(
                correct.as_control(numbers), limits)
            control_passed |= line["control_correct"]
        line.update(numbers)
        line.update({
            "sample": sample,
            "kinds": [rec.steps[s][j].kind for s, j in sample],
            "slots": [rec.steps[s][j].slot for s, j in sample],
            "partial": [len(rec.steps[s][j].tokens) < rec.steps[s][j].n_out
                        for s, j in sample],
            "setup_s": rec.setup_s, "compare_s": time.perf_counter() - t0})
        print(json.dumps(line), flush=True)
        del rec, host
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
    if control_passed:
        print("a control came out correct: the limits do not separate it",
              file=sys.stderr)
    return 1 if control_passed else 0


if __name__ == "__main__":
    sys.exit(main())
