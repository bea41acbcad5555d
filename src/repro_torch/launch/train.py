"""Training launcher: the train loop with checkpoint/restart, the twin of
``repro.launch.train`` on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch micro --device cpu --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b --batch 2 --seq 1024

Weights are random, made from ``seed`` on ``--device`` (default ``cuda``:
the run raises when there is no card); batches come from ``SyntheticLM``.
A step is ``lm.forward_train``, its backward and ``adamw_update``, all in
place; no kernel is launched (none has a backward).  Every ``ckpt_every``
steps the params, the moments and the data cursor are saved in the
reference's format; ``--resume`` restarts at the batch after the last
checkpoint.  A mesh (sharded training) comes with Sharding II (ROADMAP
Queue 1 item 3).
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from repro_torch.configs import get_config, load_all
from repro_torch.models import lm
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.data import SyntheticLM
from repro_torch.train.optimizer import (abstract_opt_state, adamw_update,
                                         init_opt_state, tree_leaves,
                                         tree_map)


def make_train_step(cfg, lr: float, *, opts=None):
    """``train_step(params, opt, batch) -> (loss, gnorm)``: the forward
    loss, its backward into the params' ``.grad``, one AdamW step on the
    params and the state in place, then the grads set to None.  The
    params' leaves must require grad."""
    def train_step(params, opt, batch):
        loss = lm.forward_train(params, batch, cfg, opts=opts)
        loss.backward()
        grads = tree_map(lambda p: p.grad, params)
        _, _, gnorm = adamw_update(params, grads, opt, lr=lr)
        for p in tree_leaves(params):
            p.grad = None
        return loss.detach(), gnorm
    return train_step


def train_loop(arch: str = "small-100m", *, steps: int = 50, batch: int = 8,
               seq: int = 128, lr: float = 3e-4,
               ckpt_dir: Optional[str] = None, ckpt_every: int = 25, mesh=None, log_every: int = 5,
               resume: bool = False, seed: int = 0, device="cuda"):
    """Returns (params, opt, losses of the steps run)."""
    if mesh is not None:
        raise NotImplementedError(
            "train_loop(mesh=...): sharded training comes with Sharding II "
            "(ROADMAP Queue 1 item 3); the port trains on one device")
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train_loop: CUDA is not available; pass "
                           "device='cpu' to run on the CPU")
    load_all()
    cfg = get_config(arch)
    data = SyntheticLM(cfg, batch, seq, seed=seed)

    start = 0
    if resume and ckpt_dir and ckpt.latest_step(ckpt_dir) is not None:
        ap = lm.abstract_params(cfg)
        start, params, opt, meta = ckpt.restore_checkpoint(
            ckpt_dir, ap, abstract_opt_state(ap), device=device)
        data.restore(meta["data_state"])
        print(f"[train] resumed from step {start}")
    else:
        params = lm.init_params(cfg, seed, device)
        opt = init_opt_state(params)
    for p in tree_leaves(params):
        p.requires_grad_(True)

    step_fn = make_train_step(cfg, lr)
    losses = []
    t0 = time.time()
    for step in range(start, steps):
        b = data.next()
        batch_dev = {k: torch.from_numpy(v).to(device) for k, v in b.items()}
        loss, gnorm = step_fn(params, opt, batch_dev)
        losses.append(float(loss))
        if step % log_every == 0 or step == steps - 1:
            print(f"[train] step {step:4d} loss {float(loss):.4f} "
                  f"gnorm {float(gnorm):.3f} "
                  f"({(time.time() - t0):.1f}s)", flush=True)
        if ckpt_dir and (step + 1) % ckpt_every == 0:
            ckpt.save_checkpoint(ckpt_dir, step + 1, params, opt,
                                 data_state=data.snapshot())
    return params, opt, losses


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="small-100m")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    train_loop(args.arch, steps=args.steps, batch=args.batch, seq=args.seq,
               lr=args.lr, ckpt_dir=args.ckpt_dir, resume=args.resume,
               device=args.device)


if __name__ == "__main__":
    main()
