"""Multi-pod dry-run demo on the PyTorch port: place one (arch x shape)
cell on the 2x16x16 = 512-rank production mesh and print its memory and
cost analysis (the twin of ``examples/multipod_dryrun.py``).

    PYTHONPATH=src python examples/multipod_dryrun_torch.py \
        [--arch command-r-35b] [--shape decode_32k]

(This script re-execs ``python -m repro_torch.launch.dryrun``, rank 0 of a
fake world of 512 on meta tensors, so it needs no card; its JSON goes to
``build/dryrun/``.  The full sweep lives in repro_torch/launch/dryrun.py.)
"""
import argparse
import os
import subprocess
import sys


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="command-r-35b")
    ap.add_argument("--shape", default="decode_32k")
    ap.add_argument("--mesh", default="multi", choices=["single", "multi"])
    args = ap.parse_args()
    env = dict(os.environ)
    env["PYTHONPATH"] = env.get("PYTHONPATH", "src")
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
           "--arch", args.arch, "--shape", args.shape,
           "--mesh", args.mesh, "--tag", "demo", "--force"]
    if args.mesh == "multi":
        cmd.append("--no-slopes")
    print("running:", " ".join(cmd))
    sys.exit(subprocess.call(cmd, env=env))


if __name__ == "__main__":
    main()
