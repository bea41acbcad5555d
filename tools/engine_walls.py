#!/usr/bin/env python3
"""A benchmark cell's ``--trace 1`` run with the engine's wall spans on
(``Engine.wall``), read into four per-layer metrics; and the cost of the
spans on a decode round.

    python3 tools/engine_walls.py --workload <cell> --seed <n> --seconds 51
    python3 tools/engine_walls.py --cost [--rounds 200]

The first runs ``port_bench/run.py --trace 1`` as it is, with two
additions made from outside the harness: ``WallRecorder`` sets
``eng.wall`` before the warm-up (so the engine's admission kinds see every
admission since the start, as the harness's ``StepLog.kind`` does), a
fresh ``Tracer`` when the window opens, and moves the window's spans to
``Record.spans`` when it closes; ``summary_with_busy`` keeps the device's
busy intervals (kineto ns) on ``TraceSummary.busy``.  run.py's result line
is followed by a ``WALL`` line (``tools/wall_readers.py``): the four
``METRICS``, the profiled rounds beside the others, device idle by engine
phase over the profiled rounds, how far the ``round`` spans' walls lie
from the harness's ``Round`` walls, and the longest host gaps between
engine calls.  The harness taking the switch itself (a ``Record.spans``,
a ``TraceSummary.busy``) would retire ``WallRecorder``,
``summary_with_busy`` and ``wall_on``.

``--cost`` serves nemo-swe-evict's shape (mistral-nemo-12b, 8 slots of
16K, its pool) with 8 sessions of 9K tokens and times ``Engine.decode``
(each round ends with its ids on the host) in blocks of 25 rounds, wall
off and on in turns; then the recording alone, on the host.  In a
checkout whose engine has no wall spans, ``on`` sets a plain attribute
and both sides time the same code.  Both modes need a card.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import sys
import time
from pathlib import Path
from typing import Dict, List, Tuple

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from port_bench import harness, trace  # noqa: E402
from repro_torch.obs.tracer import Tracer  # noqa: E402
from tools import wall_readers as W  # noqa: E402


class WallRecorder(harness.Recorder):
    """``harness.Recorder`` with the engine's wall spans on."""

    def __init__(self, engine, rec, traced):
        self._window = False
        self._rec = rec
        super().__init__(engine, rec, traced)
        engine.wall = Tracer()

    @property
    def in_window(self) -> bool:
        return self._window

    @in_window.setter
    def in_window(self, on: bool) -> None:
        if on and not self._window:
            self.engine.wall = Tracer()
        elif self._window and not on:
            self._rec.spans = self.engine.wall.spans
            self.engine.wall = None
        self._window = on


def summary_with_busy(reduce):
    """``trace.reduce_events`` that also keeps the union of the device
    intervals, in kineto ns, as ``busy``."""
    def reduce_events(events, window_s, top=10):
        s = reduce(events, window_s, top)
        if s is not None:
            s.busy = trace._union([(a, b) for k, _, a, b, on_dev in events
                                   if on_dev and k in trace.DEVICE_KINDS
                                   and b > a])
        return s
    return reduce_events


def walls(rec) -> W.Walls:
    """The window of a record ``WallRecorder`` filled, for the readers."""
    return W.Walls(getattr(rec, "spans", None) or [], rec.window_rounds(),
                   sorted(rec.window_steps(), key=lambda s: s.t_call),
                   getattr(rec.trace, "busy", None) if rec.trace else None)


@contextlib.contextmanager
def wall_on():
    """``harness.run`` with ``WallRecorder`` and ``summary_with_busy`` in
    place; yields the list the runs' records are appended to."""
    captured = []
    real_run, real_reduce, real_recorder = \
        harness.run, trace.reduce_events, harness.Recorder

    def run_and_keep(*a, **k):
        rec, host = real_run(*a, **k)
        captured.append(rec)
        return rec, host

    harness.run, harness.Recorder = run_and_keep, WallRecorder
    trace.reduce_events = summary_with_busy(real_reduce)
    try:
        yield captured
    finally:
        harness.run, harness.Recorder = real_run, real_recorder
        trace.reduce_events = real_reduce


def traced_run(argv: List[str]) -> Tuple[int, object]:
    """``port_bench/run.py``'s ``main(argv)`` with the wall spans on;
    returns its exit code and the run's record."""
    from port_bench import run
    with wall_on() as captured:
        code = run.main(argv)
    return code, captured[0]


# -- the cost of the spans --------------------------------------------------
def _record_us(E, eng, cur, n: int = 20000) -> float:
    """Microseconds a round's clock reads and spans take on the host."""
    tr = Tracer()
    t = time.perf_counter()
    for _ in range(n):
        visible = sum(eng.slots[s].length + 1 for s in cur)
        ts = [E.wall_clock() for _ in range(5)]
        rid = tr.complete("engine", "round", ts[0], ts[-1], rows=len(cur),
                          n_steps=1, visible=visible)
        for i in range(4):
            tr.complete("engine", E.ROUND_PHASES[i], ts[i], ts[i + 1],
                        parent=rid)
    return 1e6 * (time.perf_counter() - t) / n


def cost(n_rounds: int, block: int = 25, ctx: int = 9216) -> Dict:
    import numpy as np
    import torch

    from port_bench import spec
    from port_bench.weights import make_params
    from repro_torch.kernels import build
    from repro_torch.serving import engine as E

    c = spec.cell("nemo-swe-evict")
    m = spec.model_sizes(c["config"])
    sz = c["sizing"]
    build.build_all(["flash_attention", "paged_attention"])
    params = make_params(m, 7, "cuda")
    eng = E.Engine(spec.model_config(m), params, n_slots=sz["n_slots"],
                   max_len=c["traffic"]["max_len"],
                   pool_blocks=sz["pool_blocks"])
    rng = np.random.RandomState(7)
    cur = {}
    for s in range(eng.n_slots):
        toks = rng.randint(1, m["vocab"], ctx).astype(np.int32)
        cur[eng.start_session(f"s{s}", toks, False)] = int(toks[-1])
    for _ in range(5):                                   # warm
        out = eng.decode(cur)
        cur = {s: o[-1] for s, o in out.items()}
    walls = {"off": [], "on": []}
    for b in range(2 * n_rounds // block):
        side = "off" if b % 4 in (0, 3) else "on"        # off on on off
        eng.wall = Tracer() if side == "on" else None
        for _ in range(block):
            t = time.perf_counter()
            out = eng.decode(cur)
            walls[side].append(time.perf_counter() - t)
            cur = {s: o[-1] for s, o in out.items()}
    eng.wall = None
    # the recording alone: a round's clock reads and spans, on the host
    # (an engine without wall spans has nothing to record)
    record_us = _record_us(E, eng, cur) if hasattr(E, "wall_clock") \
        else None
    q = {k: statistics.quantiles(v, n=4) for k, v in walls.items()}
    return {"device": torch.cuda.get_device_name(0), "rounds": n_rounds,
            "ctx": ctx, "rows": len(cur),
            "round_us_median": {k: 1e6 * q[k][1] for k in q},
            "round_us_quartiles": {k: [1e6 * q[k][0], 1e6 * q[k][2]]
                                   for k in q},
            "round_us_mean": {k: 1e6 * statistics.fmean(v)
                              for k, v in walls.items()},
            "on_minus_off_us_median": 1e6 * (q["on"][1] - q["off"][1]),
            "record_us_per_round": record_us}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--cost", action="store_true")
    ap.add_argument("--rounds", type=int, default=200)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 1
    if args.cost:
        print("COST " + json.dumps(cost(args.rounds)))
        return 0
    code, rec = traced_run(["--workload", args.workload, "--seed",
                            str(args.seed), "--seconds", str(args.seconds),
                            "--trace", "1"])
    print("WALL " + json.dumps(W.wall_line(walls(rec))))
    return code


if __name__ == "__main__":
    sys.exit(main())
