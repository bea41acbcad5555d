#!/usr/bin/env python3
"""The port's training steps against the reference's at llama3.2-3b's full
width, on the CPU:

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/train_wide_parity.py [--layers 2] [--steps 8] [--lr 3e-4] [--seq 64]

llama3.2-3b (d_model 3072, 24 heads over 8, vocab 128,256, tied
embeddings) with its depth cut to ``--layers``, the reference's PRNGKey(0)
params carried into the port bit-exactly, and the same ``SyntheticLM``
batches (2 x ``--seq`` tokens, seed 0): ``--steps`` of the port's
``make_train_step`` and of the reference's jitted ``make_train_step`` at
``--lr``.  Prints both loss sequences and the largest relative gap.  At
two layers it holds ~11 GB and takes ~5 minutes on 8 cores: a width
check the tiny-config tests cannot make (phase 11 of ``chip_smoke.py``
trains the full depth on the card without the reference).
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seq", type=int, default=64)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from repro.configs import get_config as ref_config
    from repro.launch import train as ref_train
    from repro.models import lm as ref_lm
    from repro.models.sharding import ShardingEnv
    from repro.train import optimizer as ref_opt
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.models import lm
    from repro_torch.train import optimizer
    from repro_torch.train.data import SyntheticLM

    cut = dict(n_layers=args.layers)
    cfg_ref = dataclasses.replace(ref_config("llama3.2-3b"), **cut)
    cfg = dataclasses.replace(get_config("llama3.2-3b"), **cut)
    params_ref = ref_lm.init_params(cfg_ref, jax.random.PRNGKey(0))
    data = SyntheticLM(cfg, 2, args.seq, seed=0)
    batches = [data.next() for _ in range(args.steps)]

    params = lm.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                       params_ref), "cpu")
    for p in optimizer.tree_leaves(params):
        p.requires_grad_(True)
    step = train.make_train_step(cfg, args.lr)
    opt = optimizer.init_opt_state(params)
    port = [float(step(params, opt, {k: torch.from_numpy(v)
                                     for k, v in b.items()})[0])
            for b in batches]
    print("port     ", [round(x, 4) for x in port], flush=True)
    del params, opt

    env = ShardingEnv(None, {"remat": False, "sp": False,
                             "moe_impl": "dense"})
    step_ref = jax.jit(ref_train.make_train_step(cfg_ref, env, args.lr),
                       donate_argnums=(0, 1))
    opt_ref = ref_opt.init_opt_state(params_ref)
    ref = []
    for b in batches:
        loss, _, params_ref, opt_ref = step_ref(
            params_ref, opt_ref, {k: jnp.asarray(v) for k, v in b.items()})
        ref.append(float(loss))
    print("reference", [round(x, 4) for x in ref])
    gap = max(abs(a - b) / abs(b) for a, b in zip(port, ref))
    print(f"largest relative gap {gap:.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
