#!/usr/bin/env python3
"""The training loss of llama3.2-3b at full width and depth on one NVIDIA
card, at a few learning rates:

    python3 tools/train_lr_probe.py [--lr 1e-4 3e-5 3e-4] [--steps 8 8 14]

``train_loop`` on the card (B=2 x 1024 ``SyntheticLM`` tokens, seed 0,
random bf16 weights from seed 0), one run a learning rate with its step
count; prints each run's losses.  It shows whether the loss falls within a
run's steps at a given rate (``chip_smoke.py`` phase 11 requires its last
loss below its first).  Exits 1 without a card.
"""
from __future__ import annotations

import argparse
import gc
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--lr", type=float, nargs="+", default=[1e-4, 3e-5, 3e-4])
    ap.add_argument("--steps", type=int, nargs="+", default=[8, 8, 14])
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("train_lr_probe: needs a CUDA card")
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    from repro_torch.launch import train

    for lr, steps in zip(args.lr, args.steps):
        t0 = time.perf_counter()
        _, _, losses = train.train_loop("llama3.2-3b", steps=steps, batch=2,
                                        seq=1024, lr=lr, seed=0,
                                        log_every=steps, device="cuda")
        print(f"lr {lr:g}, {steps} steps [{torch.cuda.get_device_name(0)}]: "
              f"losses {[round(x, 4) for x in losses]} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
