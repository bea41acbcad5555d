"""Training launcher: the train loop with checkpoint/restart, the twin of
``repro.launch.train``, on one device or on a mesh.

    PYTHONPATH=src python -m repro_torch.launch.train --arch micro --device cpu --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b --batch 2 --seq 1024

Weights are random, made from ``seed`` on ``--device`` (default ``cuda``:
the run raises when there is no card); batches come from ``SyntheticLM``.
A step is ``lm.forward_train``, its backward and ``adamw_update``, all in
place; no kernel is launched (none has a backward).  Every ``ckpt_every``
steps the params, the moments and the data cursor are saved in the
reference's format; ``--resume`` restarts at the batch after the last
checkpoint.

``train_loop(mesh=...)`` trains on a ("data", "model") ``DeviceMesh`` and
is called in every rank (a thread of a ``launch.mesh.threaded_world``, or
one process per card): the env takes the reference's mesh options (sp,
``moe_impl="ep"``, no remat), the params are laid out by
``lm.param_shardings`` and the moments by ``optimizer.opt_pspecs``, each
step's batch (the same global batch as on one device) is cut to the
rank's rows by ``launch.specs._batch_pspecs``, and rank 0 alone logs.
Checkpoints hold whole leaves, so a run moves between meshes and one
device.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from repro_torch.configs import get_config, load_all
from repro_torch.launch.specs import _batch_pspecs
from repro_torch.models import lm
from repro_torch.models.sharding import ShardingEnv, distribute
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.data import SyntheticLM
from repro_torch.train.optimizer import (abstract_opt_state, adamw_update,
                                         init_opt_state, opt_pspecs,
                                         tree_leaves, tree_map)

MESH_AXES = ("data", "model")


def make_train_step(cfg, lr: float, *, opts=None, env=None):
    """``train_step(params, opt, batch) -> (loss, gnorm)``: the forward
    loss, its backward into the params' ``.grad``, one AdamW step on the
    params and the state in place, then the grads set to None.  The
    params' leaves must require grad.  With ``env`` on a mesh the params,
    grads and moments are DTensors and the options come from
    ``env.opts``."""
    def train_step(params, opt, batch):
        if env is None:
            loss = lm.forward_train(params, batch, cfg, opts=opts)
        else:
            loss = lm.forward_train(params, batch, cfg, env, opts=opts)
        loss.backward()
        grads = tree_map(lambda p: p.grad, params)
        _, _, gnorm = adamw_update(params, grads, opt, lr=lr)
        for p in tree_leaves(params):
            p.grad = None
        return loss.detach(), gnorm
    return train_step


def mesh_env(mesh) -> ShardingEnv:
    """The env ``train_loop`` trains under on ``mesh``: the reference's
    options (``repro/launch/train.py``: no remat, sp, ``moe_impl="ep"``).
    Raises unless ``mesh`` is a ``DeviceMesh`` with the axes ("data",
    "model")."""
    from torch.distributed.device_mesh import DeviceMesh
    if not isinstance(mesh, DeviceMesh) \
            or tuple(mesh.mesh_dim_names or ()) != MESH_AXES:
        raise ValueError(f"train_loop: mesh must be a DeviceMesh with the "
                         f"axes {MESH_AXES}, not {mesh!r}")
    return ShardingEnv(mesh, {"remat": False, "sp": True, "moe_impl": "ep"})


def _rank0(env) -> bool:
    import torch.distributed as dist
    return env is None or dist.get_rank() == 0


def train_loop(arch: str = "small-100m", *, steps: int = 50, batch: int = 8,
               seq: int = 128, lr: float = 3e-4,
               ckpt_dir: Optional[str] = None, ckpt_every: int = 25, mesh=None, log_every: int = 5,
               resume: bool = False, seed: int = 0, device="cuda"):
    """Returns (params, opt, losses of the steps run); on a mesh (called
    in every rank, on the mesh's device type) the params and moments are
    DTensors and every rank returns the same losses."""
    env = None if mesh is None else mesh_env(mesh)
    if env is not None:
        device = mesh.device_type
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train_loop: CUDA is not available; pass "
                           "device='cpu' to run on the CPU")
    load_all()
    cfg = get_config(arch)
    data = SyntheticLM(cfg, batch, seq, seed=seed)
    shardings = None if env is None else lm.param_shardings(cfg, env)

    start = 0
    if resume and ckpt_dir and ckpt.latest_step(ckpt_dir) is not None:
        ap = lm.abstract_params(cfg)
        start, params, opt, meta = ckpt.restore_checkpoint(
            ckpt_dir, ap, abstract_opt_state(ap), device=device,
            shardings=None if env is None
            else (shardings, opt_pspecs(shardings)))
        data.restore(meta["data_state"])
        if _rank0(env):
            print(f"[train] resumed from step {start}")
    else:
        params = lm.init_params(cfg, seed, device)
        if env is not None:
            params = distribute(params, shardings)
        opt = init_opt_state(params)
    for p in tree_leaves(params):
        p.requires_grad_(True)

    step_fn = make_train_step(cfg, lr, env=env)
    losses = []
    t0 = time.time()
    for step in range(start, steps):
        b = data.next()
        batch_dev = {k: torch.from_numpy(v).to(device) for k, v in b.items()}
        if env is not None:          # the rank's rows of the global batch
            batch_dev = distribute(batch_dev,
                                   _batch_pspecs(cfg, batch_dev, env))
        loss, gnorm = step_fn(params, opt, batch_dev)
        losses.append(float(loss))
        if _rank0(env) and (step % log_every == 0 or step == steps - 1):
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
