"""Train a ~100M-parameter dense LM for a few hundred steps on the PyTorch
port with checkpoint/restart — the training-substrate end-to-end driver
(the twin of ``examples/train_small.py``).  Runs on ``--device`` (default
``cuda``; ``--device cpu`` asks for the CPU).  Its checkpoints default to
``/tmp/repro_torch_ckpt``: with ``resume=True`` a directory of the
reference's checkpoints is not the port's to restore.

    PYTHONPATH=src python examples/train_small_torch.py [--steps 200]
"""
import argparse

from repro_torch.launch.train import train_loop


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--arch", default="small-100m")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default="/tmp/repro_torch_ckpt")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    _, _, losses = train_loop(
        args.arch, steps=args.steps, batch=args.batch, seq=args.seq,
        lr=1e-3, ckpt_dir=args.ckpt_dir, ckpt_every=50, log_every=10,
        resume=True, device=args.device)
    print(f"\nloss: {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"({len(losses)} steps); checkpoints in {args.ckpt_dir}")
    return losses


if __name__ == "__main__":
    main()
