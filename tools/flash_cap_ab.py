#!/usr/bin/env python3
"""Flash prefill without a cap against the kernel from before the cap, on
one NVIDIA card (built for an H100):

    mkdir -p build/cap_ab
    git show <commit>:src/repro_torch/csrc/flash_attention.cu \\
        > build/cap_ab/before.cu
    python3 tools/flash_cap_ab.py build/cap_ab/before.cu

``src/repro_torch/csrc/flash_attention.cu`` takes the soft cap as a
template flag, so cap 0 launches an instance compiled from the body the
kernel had before the cap.  This script builds the given older source (its
C entry ``flash_prefill`` takes no cap) and the checkout's into
``build/cap_ab/`` (both nvcc at once), and at ``chip_smoke.py`` phase 2's
flash shapes checks that the checkout's kernel at cap 0 gives the older
build's output bit for bit, then reads both with the profiler's device
time (``chip_smoke.device_ms``, 10 calls) in the order older, checkout,
checkout, older, the checkout's capped instance (cap ``CAP_KERNEL``)
beside them.  Prints the card, one line a shape, then one JSON object with
every shape.  Exits 1 without a card or on a mismatch.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

OUT = ROOT / "build" / "cap_ab"
# label, B, Sq, Sk, H, K, D, Dv, causal, window: phase 2's flash shapes
SHAPES = [
    ("llama3.2-3b", 1, 1024, 1024, 24, 8, 128, 128, True, 0),
    ("llama3.2-3b window 32", 1, 1024, 1024, 24, 8, 128, 128, True, 32),
    ("jamba", 2, 1024, 1024, 32, 8, 128, 128, True, 0),
    ("mixtral-8x22b window 4096", 1, 4608, 4608, 48, 8, 128, 128, True,
     4096),
    ("llava-next-34b", 1, 2560, 2560, 56, 8, 128, 128, True, 0),
    ("deepseek-v2 MLA", 2, 1024, 1024, 128, 128, 192, 128, True, 0),
    ("seamless encoder", 4, 1024, 1024, 16, 16, 64, 64, False, 0),
    ("seamless cross-attention", 4, 256, 1024, 16, 16, 64, 64, False, 0),
    ("micro", 1, 256, 256, 4, 2, 16, 16, True, 0),
    ("micro ragged window 32", 2, 200, 200, 4, 2, 16, 16, True, 32)]
ARGS_BEFORE = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
               + [ctypes.c_float, ctypes.c_void_p])


def build(before: Path) -> dict:
    """{"before": CDLL, "checkout": CDLL}, both nvcc at once."""
    from repro_torch.kernels import build as Bd
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in (("before", before),
                      ("checkout", Bd.CSRC / "flash_attention.cu")):
        so = OUT / f"flash_{name}.so"
        procs[name] = (so, subprocess.Popen(
            [Bd._nvcc(), *Bd.NVCC_FLAGS, "-o", str(so), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(so))
    return libs


def main() -> int:
    import torch
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("no CUDA device: this comparison runs on a card",
              file=sys.stderr)
        return 1
    import chip_smoke as S
    from repro_torch.kernels import build as Bd
    from repro_torch.kernels.flash_attention import ops as F

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    S.log(card)
    libs = build(Path(sys.argv[1]))
    fns = {}
    for name, lib in libs.items():
        fn = lib.flash_prefill
        fn.argtypes = ARGS_BEFORE if name == "before" else F._ARGTYPES
        fn.restype = ctypes.c_int
        fns[name] = fn
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    mk = lambda *s: torch.randn(s, generator=gen, device="cuda",  # noqa
                                dtype=torch.float32).to(torch.bfloat16)
    rows, fails = [], []
    for label, B, Sq, Sk, H, K, D, Dv, causal, window in SHAPES:
        q, k, v = mk(B, Sq, H, D), mk(B, Sk, K, D), mk(B, Sk, K, Dv)
        out = q.new_empty(B, Sq, H, Dv)
        scale = 1.0 / D ** 0.5

        def run(name, cap=0.0):
            extra = () if name == "before" else (cap,)
            err = Bd.launch(q.device, fns[name], q.data_ptr(), k.data_ptr(),
                            v.data_ptr(), out.data_ptr(), B, Sq, Sk, H, K, D,
                            Dv, int(causal), window, scale, *extra)
            if err:
                raise RuntimeError(f"{label} {name}: error {err}")
            return out

        got = {}
        for name in ("before", "checkout"):
            got[name] = run(name).clone()
        torch.cuda.synchronize()
        equal = torch.equal(got["before"], got["checkout"])
        if not equal:
            fails.append(label)
        times = {n: [] for n in ("before", "checkout")}
        for name in ("before", "checkout", "checkout", "before"):
            times[name].append(S.device_ms(
                torch, lambda: run(name), "flash_prefill_kernel"))
        capped = S.device_ms(torch, lambda: run("checkout", S.CAP_KERNEL),
                             "flash_prefill_kernel")
        row = {"shape": f"{label}: B={B} Sq={Sq} Sk={Sk} H={H} K={K} D={D} "
                        f"Dv={Dv} causal={causal} window={window}",
               "bit_equal_at_cap_0": equal,
               "before_device_ms": times["before"],
               "checkout_device_ms": times["checkout"],
               "checkout_capped_device_ms": capped}
        S.log(f"  {row['shape']}: bit-equal {equal}; device ms before "
              f"{times['before']}, checkout {times['checkout']}, checkout "
              f"capped {capped:.4f}")
        rows.append(row)
        del q, k, v, out, got
    S.log(json.dumps({"card": card, "flash_cap_ab": rows}))
    if fails:
        S.log(f"cap 0 differs from the older build at {fails}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
