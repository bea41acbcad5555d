"""End-to-end driver on the PyTorch port: serve a small model with batched
multi-step agent requests through the full SAGA stack (REAL forward
passes; the twin of ``examples/serve_agents.py``).

Two runs over the same agent workload:
  1. SAGA (workflow-atomic: session affinity + WA-LRU + TTL park/resume)
  2. request-level (vLLM-v0.6.0-style: KV discarded between steps)

The printed numbers are actual prefilled-token counts from the engine —
the paper's central quantity, measured, not simulated.  They count tokens,
so they equal the reference's whatever the weights.  Params are the
port's seeded init on ``--device`` (default ``cuda``: on the card every
prefill runs ``flash_prefill`` and every batched decode round
``paged_append`` + ``paged_decode``; there is no CPU fallback, ask for
``--device cpu``).

    PYTHONPATH=src python examples/serve_agents_torch.py [--device cpu]
"""
import argparse
import time

import numpy as np

from repro_torch.configs import get_config, load_all
from repro_torch.core.coordinator import SAGAConfig
from repro_torch.models import lm
from repro_torch.serving.client import SagaClient
from repro_torch.serving.server import AgentRequest, MultiWorkerServer


def make_request(i, vocab, n_steps, rng):
    steps = []
    tools = ["code_execution", "file_operations", "web_api"]
    for s in range(n_steps):
        prompt = list(rng.randint(1, vocab, size=16))
        steps.append((prompt, 8, tools[s % 3], float(rng.uniform(0.1, 2.0))))
    return AgentRequest(f"agent-{i}", f"tenant{i % 2}", steps)


def main(argv=None, params=None):
    """``params``: a params tree to serve instead of the seeded init (the
    tests pass the reference's, carried by ``lm.params_from_jax``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    load_all()
    cfg = get_config("micro")          # swap for "small-100m" if patient
    if params is None:
        params = lm.init_params(cfg, seed=0, device=args.device)
    rng = np.random.RandomState(0)
    requests = [make_request(i, cfg.vocab, n_steps=5, rng=rng)
                for i in range(6)]

    configs = {
        "SAGA (workflow-atomic)": SAGAConfig(),
        "request-level baseline": SAGAConfig(
            cache_policy="none", enable_affinity=False, enable_ttl=False,
            enable_prefetch=False, enable_afs=False, observability="none"),
    }
    results = {}
    for name, saga in configs.items():
        srv = MultiWorkerServer(cfg, params, n_workers=2, saga=saga,
                                n_slots=3, max_len=512, pool_blocks=96)
        # SagaClient is the submission surface; run_task is a shim now
        client = SagaClient.for_server(srv)
        t0 = time.time()
        for req in requests:
            client.submit(req)
            client.run()
        stats = client.stats()
        stats["wall_s"] = time.time() - t0
        results[name] = stats
        print(f"{name}: prefilled={stats['prefill_tokens']} tokens "
              f"(regenerated={stats['regen_tokens']}), "
              f"decoded={stats['decode_steps']} steps, "
              f"cache hits={stats['coordinator_hits']}, "
              f"{stats['wall_s']:.1f}s wall")

    saga_t = results["SAGA (workflow-atomic)"]["prefill_tokens"]
    base_t = results["request-level baseline"]["prefill_tokens"]
    print(f"\nprefill-work reduction: {base_t / max(saga_t, 1):.2f}x "
          "(this is the mechanism behind the paper's 1.64x TCT gain)")


if __name__ == "__main__":
    main()
