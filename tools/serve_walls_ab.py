#!/usr/bin/env python3
"""``chip_smoke.py`` phases 4-4b (llama3.2-3b served paged, then gather)
from one checkout of the repo, alone or after phase 2, on one NVIDIA card
(built for an H100): the host-bound walls of two commits side by side.

    mkdir -p build/parent && git archive <commit> | tar -x -C build/parent
    python3 tools/serve_walls_ab.py build/parent phase2
    python3 tools/serve_walls_ab.py .

The first argument is the checkout whose ``chip_smoke.py`` and
``src/repro_torch`` run (its kernels build under its own ``build/``);
``phase2`` runs that checkout's phase 2 (the kernels against their plain
versions) first, as the whole smoke does.  Run each in a process of its
own, in the order parent, change, change, parent.  Prints phase 4's and
4b's lines (the main path's wall, gather vs paged a decode round) and
``PROBE`` lines with the walls of phase 2 and of phases 4-4b.  Exits 1
without a card.
"""
from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path


def phase2(torch, S):
    """The checkout's phase 2, in ``main``'s order."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    gen_more = torch.Generator(device="cuda")
    gen_more.manual_seed(1)
    kernels = [S.flash_phase(torch, gen, gen_more),
               *S.paged_phase(torch, gen, gen_more),
               S.wkv6_phase(torch, gen), S.mamba_phase(torch, gen)]
    S.flash_long_shapes(torch, gen_more, kernels[0])
    S.flash_width_shapes(torch, gen_more, kernels[0])
    S.paged_g1_shapes(torch, gen_more, kernels[1:3])
    S.flash_long_shapes(torch, gen_more, kernels[0], S.FLASH_RANK)
    S.paged_g1_shapes(torch, gen_more, kernels[1:3], S.PAGED_RANK)
    S.scan_rank_shapes(torch, gen_more, kernels[3], kernels[4])
    S.flash_width_shapes(torch, gen_more, kernels[0], S.FLASH_REST)
    S.paged_g1_shapes(torch, gen_more, kernels[1:3], S.PAGED_REST)
    if hasattr(S, "flash_capped_shapes"):
        gen_cap = torch.Generator(device="cuda")
        gen_cap.manual_seed(2)
        S.flash_capped_shapes(torch, gen_cap, kernels[0])


def main() -> int:
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    root = Path(sys.argv[1]).resolve()
    sys.path[:0] = [str(root / "src"), str(root)]
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: this comparison runs on a card",
              file=sys.stderr)
        return 1
    import chip_smoke as S
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    S.log(f"{card}; checkout {root}")
    build.build_all()
    if "phase2" in sys.argv[2:]:
        t0 = time.perf_counter()
        phase2(torch, S)
        S.log(f"PROBE phase 2 wall {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    S.main_path(torch, np, card)
    S.log(f"PROBE phases 4-4b wall {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
