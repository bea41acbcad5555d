#!/usr/bin/env python3
"""Shows that ``chip_smoke.py``'s limits at the long windowed shapes see a
fault at the window's edge, on one NVIDIA card (built for an H100):

    python3 tools/window_faults.py [--work DIR]

Over a window of 4096 keys an attention output of std-1 inputs has std
about 0.026, so the absolute limit ``TOL_BF16`` (2e-2) is as large as a
typical value there.  This script builds copies of the two attention
sources, each with one fault planted at the window's edge, into ``DIR``
(default ``build/window_faults/``, all nvcc processes at once):

- flash_prefill: the first key tile (128 keys) skipped in every CTA whose
  rows the window bites; and the window 64 keys short;
- paged_decode: the first 256 keys of the window lost (one split's span
  at this shape); and the first 16 (one pool block).

The sound build (the repo's own library) and each faulty one run through
the port's wrappers at mixtral-8x22b's shapes from ``chip_smoke.py``
phase 2: flash at B=1 S=4608 H=48 K=8 D=128, causal, window 4096, and
paged decode at B=4 H=48 K=8 dh=128, block 16, nb 512, one live row of
4640 tokens and three idle rows, window 4096.  Each is held to the plain
version with both of phase 2's limits there: ``TOL_BF16`` and
``TOL_ROW_STEPS`` (``chip_smoke.row_steps``).  Prints one line a case and
one JSON object; exits 0 only when the sound build passes both limits and
``TOL_ROW_STEPS`` catches every fault.  Exits 1 without a card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

FLASH_LINE = "  const int k_begin = window ? max(0, q0 - window + 1) : 0;"
PAGED_LINE = "  const int lo = window ? max(0, len - window) : 0;"
# name: (source, line, the line with the fault)
FAULTS = {
    "flash: first key tile skipped where the window bites": (
        "flash_attention", FLASH_LINE,
        "  const int k_begin = window ? max(0, q0 - window + 1)"
        " + (q0 >= window ? BK : 0) : 0;"),
    "flash: window 64 keys short": (
        "flash_attention", FLASH_LINE,
        "  if (window) window -= 64;\n" + FLASH_LINE),
    "paged: first 256 keys of the window lost": (
        "paged_attention", PAGED_LINE,
        "  const int lo = window ? max(0, len - window + 256) : 0;"),
    "paged: first 16 keys of the window lost": (
        "paged_attention", PAGED_LINE,
        "  const int lo = window ? max(0, len - window + 16) : 0;"),
}


def build(work: Path):
    """One library a fault, every nvcc at once; {fault: ctypes.CDLL}."""
    from repro_torch.kernels import build as Bd
    work.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (fault, (src, line, bad)) in enumerate(FAULTS.items()):
        text = (Bd.CSRC / f"{src}.cu").read_text()
        if text.count(line) != 1:
            raise RuntimeError(f"{src}.cu no longer has {line!r} once")
        cu = work / f"{src}_fault{i}.cu"
        cu.write_text(text.replace(line, bad))
        so = cu.with_suffix(".so")
        procs[fault] = (so, subprocess.Popen(
            [Bd._nvcc(), *Bd.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for fault, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {fault!r}:\n{log}")
        libs[fault] = ctypes.CDLL(str(so))
    return libs


def use(src: str, lib):
    """Route the port's wrappers of ``src`` to ``lib`` (None: the repo's
    own library)."""
    from repro_torch.kernels import build as Bd
    Bd._LIBS.pop(src, None)
    for key in [k for k in Bd._FUNCS if k[0] == src]:
        del Bd._FUNCS[key]
    if lib is not None:
        Bd._LIBS[src] = lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--work", type=Path,
                    default=ROOT / "build" / "window_faults",
                    help="where the faulty sources and libraries go")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: this check runs on a card", file=sys.stderr)
        return 1
    import chip_smoke as S
    from repro_torch.kernels import build as Bd
    from repro_torch.kernels.flash_attention import ops as F
    from repro_torch.kernels.paged_attention import ops as P

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    S.log(card)
    Bd.build_all(["flash_attention", "paged_attention"])
    libs = build(args.work)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    mk = lambda *s: torch.randn(s, generator=gen, device="cuda",  # noqa
                                dtype=torch.float32).to(torch.bfloat16)
    W = 4096
    q, k, v = mk(1, 4608, 48, 128), mk(1, 4608, 8, 128), mk(1, 4608, 8, 128)
    flash_ref = F.flash_prefill_plain(q, k, v, causal=True, window=W)
    B, nb = 4, 512
    pq, kp, vp = mk(B, 48, 128), mk(B * nb + 1, 16, 8, 128), \
        mk(B * nb + 1, 16, 8, 128)
    tables = torch.zeros(B, nb, dtype=torch.int32, device="cuda")
    tables[0] = torch.arange(1, nb + 1, dtype=torch.int32, device="cuda")
    lens = torch.tensor([4640, 1, 1, 1], dtype=torch.int32, device="cuda")
    paged_ref = P.paged_decode_plain(pq, kp, vp, tables, lens, window=W)
    runs = {"flash_attention": (
                lambda: F.flash_prefill(q, k, v, causal=True, window=W),
                flash_ref),
            "paged_attention": (
                lambda: P.paged_decode(pq, kp, vp, tables, lens, window=W),
                paged_ref)}

    rows, ok = [], True
    cases = [(f"{src}: sound", src, None) for src in runs] + [
        (fault, FAULTS[fault][0], lib) for fault, lib in libs.items()]
    for name, src, lib in cases:
        use(src, lib)
        run, ref = runs[src]
        out = run()
        torch.cuda.synchronize()
        err, steps = S.max_err(out, ref), S.row_steps(out, ref)
        row = {"case": name, "max_abs_err": err, "row_err_bf16_steps": steps,
               "over_tol_bf16": err >= S.TOL_BF16,
               "over_tol_row_steps": steps >= S.TOL_ROW_STEPS}
        S.log(f"  {name}: max_abs_err {err:.4e} (TOL_BF16 {S.TOL_BF16:g}), "
              f"largest row error {steps:.3f} bf16 steps (TOL_ROW_STEPS "
              f"{S.TOL_ROW_STEPS:g})")
        sound = lib is None
        if sound and (row["over_tol_bf16"] or row["over_tol_row_steps"]):
            ok = False
        if not sound and not row["over_tol_row_steps"]:
            ok = False
        rows.append(row)
        use(src, None)
    S.log(json.dumps({"card": card, "window_faults": rows, "ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
