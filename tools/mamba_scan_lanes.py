#!/usr/bin/env python3
"""The lane sweep behind ``kLanes`` in ``src/repro_torch/csrc/mamba_scan.cu``,
on one NVIDIA card (built for an H100):

    python3 tools/mamba_scan_lanes.py

The kernel spreads each channel's d_state states over kLanes lanes, one
compile-time number.  This script builds the source once for each pair of
lane counts (at d_state 8, at d_state 16) below, each into its own library
under ``build/lanes/`` (all nvcc processes at once), with the kernel's
``Cfg::G`` rewritten to the pair; the port itself builds and runs only
kLanes.  Each build is held to the plain version with ``chip_smoke.py``'s
limits (``rounding_errs`` in the rounding mode, ``TOL_SCAN`` otherwise) at
jamba's prefill (B=2 T=1024 di=8192, zero state, h.C rounded to bf16) and
decode (T=1, a state in) shapes, at both d_states, and timed there: CUDA
events and the profiler's device time, beside the ring entry's registers,
shared memory, CTAs an SM and local memory.  Prints one line a case, then
one JSON object with every case.  Exits 1 without a card.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# (lanes at d_state 8, lanes at d_state 16); the first is the source's own
PAIRS = ((4, 4), (2, 8), (8, 16))
OUT = ROOT / "build" / "lanes"
G_LINE = "static constexpr int G = kLanes;"


def build(pairs):
    """One library a pair, every nvcc at once; {pair: ctypes.CDLL}."""
    from repro_torch.kernels import build as Bd
    src = (Bd.CSRC / "mamba_scan.cu").read_text()
    if src.count(G_LINE) != 1:
        raise RuntimeError(f"mamba_scan.cu no longer has {G_LINE!r} once")
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for g8, g16 in pairs:
        cu = OUT / f"mamba_scan_{g8}_{g16}.cu"
        cu.write_text(src.replace(
            G_LINE, f"static constexpr int G = DS == 8 ? {g8} : {g16};"))
        so = cu.with_suffix(".so")
        procs[g8, g16] = (so, subprocess.Popen(
            [Bd._nvcc(), *Bd.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for pair, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for lanes {pair}:\n{log}")
        libs[pair] = ctypes.CDLL(str(so))
    return libs


def config(lib, ds):
    """(lanes, registers, shared memory bytes, CTAs an SM, local bytes)."""
    out = (ctypes.c_int * 5)()
    fn = lib.mamba_scan_config
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_void_p], ctypes.c_int
    err = fn(ds, ctypes.addressof(out))
    if err:
        raise RuntimeError(f"mamba_scan_config: CUDA error {err}")
    return tuple(out)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: the sweep runs on a card", file=sys.stderr)
        return 1
    import chip_smoke as S
    from repro_torch.kernels.mamba_scan import ops as M

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    S.log(card)
    libs = build(PAIRS)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    def inputs(B, T, di, ds, dtr, state):
        mk = lambda *s: torch.randn(s, generator=gen, device="cuda")  # noqa
        x = mk(B, T, di).to(torch.bfloat16)
        dt = torch.nn.functional.softplus(mk(B, T, di) - 3).to(torch.bfloat16)
        dbc = mk(B, T, dtr + 2 * ds).to(torch.bfloat16)
        A = -torch.arange(1, ds + 1, dtype=torch.float32, device="cuda"
                          ).expand(di, ds).contiguous()
        return (x, dt, dbc[..., dtr:dtr + ds], dbc[..., dtr + ds:], A,
                torch.ones(di, device="cuda"),
                mk(B, di, ds) * 0.5 if state else None)

    rows = []
    for ds in M.STATE_SIZES:
        for T in (1024, 1):
            rnd, args = T > 1, inputs(2, T, 8192, ds, 256, T == 1)
            ref, ref_T = M.mamba_scan_plain(*args, round_y=rnd)
            for pair, lib in libs.items():
                fn = lib.mamba_scan
                fn.argtypes, fn.restype = M._ARGTYPES, ctypes.c_int
                run = (lambda fn=fn: M._launch(fn, *args, rnd))
                y, h_T = run()
                torch.cuda.synchronize()
                lanes = pair[ds == 16]
                name = f"lanes={lanes} B=2 T={T} di=8192 ds={ds}"
                if rnd:
                    steps, share = M.rounding_errs(y, ref, *args)
                    S.check(name + " (y: bf16 steps past the f32 slack)",
                            steps, tol=M.ROUND_STEPS)
                    S.check(name + " (y: share off the plain version)",
                            share, tol=M.ROUND_SHARE)
                else:
                    S.check(name + " (y)", S.rel_err(y, ref),
                            tol=S.TOL_SCAN)
                S.check(name + " (h_T)", S.rel_err(h_T, ref_T),
                        tol=S.TOL_SCAN)
                row = {"lanes": lanes, "ds": ds, "T": T,
                       "ms": S.timed(torch, run),
                       "device_ms": S.device_ms(torch, run,
                                                "mamba_scan_kernel")}
                cfg = config(lib, ds)
                if cfg[0] != lanes:
                    raise AssertionError(f"{name}: the build reports "
                                         f"{cfg[0]} lanes")
                row.update(zip(("registers", "smem_bytes", "ctas_per_sm",
                                "local_bytes"), cfg[1:]))
                S.log(f"  {name}: {row}")
                rows.append(row)
    S.log(json.dumps({"card": card, "mamba_scan_lanes": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
