"""Serving launcher: bring up the multi-worker SAGA cluster on PyTorch
engines and run a synthetic agent workload against it (real forward
passes through the port's kernels).

    PYTHONPATH=src python -m repro_torch.launch.serve --tasks 6
    PYTHONPATH=src python -m repro_torch.launch.serve --arch micro --device cpu

Weights are random, made from ``--seed`` on ``--device`` (default
``cuda``: the run raises when there is no card).  Workers are in-process
engines sharing one set of weights.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import get_config, load_all
from repro_torch.core.coordinator import SAGAConfig
from repro_torch.models import lm
from repro_torch.serving.server import AgentRequest, MultiWorkerServer

TOOLS = ["code_execution", "file_operations", "web_api", "database_query"]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tasks", type=int, default=6)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--decode-tokens", type=int, default=8)
    ap.add_argument("--observability", default="hints",
                    choices=["hints", "pattern", "none"])
    ap.add_argument("--baseline", action="store_true",
                    help="request-level scheduling instead of SAGA")
    args = ap.parse_args()

    load_all()
    cfg = get_config(args.arch)
    params = lm.init_params(cfg, args.seed, device=args.device)
    if args.baseline:
        saga = SAGAConfig(cache_policy="none", enable_affinity=False,
                          enable_ttl=False, enable_prefetch=False,
                          enable_afs=False, observability="none")
    else:
        saga = SAGAConfig(observability=args.observability)
    srv = MultiWorkerServer(cfg, params, n_workers=args.workers, saga=saga,
                            n_slots=3, max_len=512, pool_blocks=96)
    rng = np.random.RandomState(args.seed)
    t0 = time.time()
    for i in range(args.tasks):
        steps = [(list(rng.randint(1, cfg.vocab, size=12)),
                  args.decode_tokens, TOOLS[s % len(TOOLS)],
                  float(rng.uniform(0.1, 1.5)))
                 for s in range(args.steps)]
        out = srv.run_task(AgentRequest(f"task-{i}", f"t{i % 2}", steps))
        print(f"task-{i}: ctx={out['ctx_tokens']} "
              f"regenerated={out['regen_tokens']} tokens")
    s = srv.stats()
    print(f"\n{'baseline' if args.baseline else 'SAGA'}: "
          f"prefilled={s['prefill_tokens']} regen={s['regen_tokens']} "
          f"decode_steps={s['decode_steps']} hits={s['coordinator_hits']} "
          f"({time.time() - t0:.1f}s)")


if __name__ == "__main__":
    main()
