"""Concurrent serving demo on the PyTorch port: many agent sessions
interleaved on real engines through the event-driven runtime (the twin of
``examples/serve_runtime.py``).

Submits a trace-driven SWE-bench/WebArena/BurstGPT-style agent mix to
``ServingRuntime`` — every decode step is a REAL batched forward pass on
the micro model — and contrasts workflow-atomic SAGA with the
request-level baseline: regenerated prefill tokens, virtual
task-completion time, and how continuous batching compresses forward
passes (decode rounds << decoded tokens).  Params are the port's seeded
init on ``--device`` (default ``cuda``: every prefill runs
``flash_prefill`` and every batched round ``paged_append`` +
``paged_decode``; ask for ``--device cpu`` to run on the CPU).

    PYTHONPATH=src python examples/serve_runtime_torch.py [--device cpu]
"""
import argparse
import time

from repro_torch.cluster.workload import runtime_requests
from repro_torch.configs import get_config, load_all
from repro_torch.core.coordinator import SAGAConfig
from repro_torch.models import lm
from repro_torch.serving.client import SagaClient
from repro_torch.serving.runtime import RuntimePerf, ServingRuntime


def main(argv=None, params=None):
    """``params``: a params tree to serve instead of the seeded init (the
    tests pass the reference's, carried by ``lm.params_from_jax``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    load_all()
    cfg = get_config("micro")
    if params is None:
        params = lm.init_params(cfg, seed=0, device=args.device)
    reqs = runtime_requests(n_sessions=12, vocab=cfg.vocab, seed=0,
                            n_steps=4, max_ctx=200)
    # token counts are scaled 64x down from the paper's traces; the
    # virtual prefill rate scales with them (see benchmarks/serve_bench)
    perf = RuntimePerf(prefill_tokens_per_s=8000.0 / 64.0)

    configs = {
        "SAGA (workflow-atomic)": SAGAConfig(),
        "request-level baseline": SAGAConfig(
            cache_policy="none", enable_affinity=False, enable_ttl=False,
            enable_prefetch=False, enable_afs=False,
            enable_stealing=False, observability="none"),
    }
    for name, saga in configs.items():
        rt = ServingRuntime(cfg, params, n_workers=2, saga=saga,
                            n_slots=4, max_len=256, pool_blocks=128,
                            perf=perf, seed=0)
        client = SagaClient.for_runtime(rt)
        t0 = time.time()
        for r in reqs:
            client.submit(r)
        client.run()
        client.check_conservation()
        s = client.summarize()
        print(f"{name}: {s['n_done']} sessions, "
              f"tct_mean={s['tct_mean']:.2f}s (virtual), "
              f"regen={s['regen_tokens']} tokens, "
              f"{s['decode_rounds']} batched rounds for "
              f"{s['decoded_tokens']} decoded tokens, "
              f"hits={s['cache_hits']}, steals={s['steals']}, "
              f"prefetch copies={s['prefetch_copies']}, "
              f"{time.time() - t0:.1f}s wall")


if __name__ == "__main__":
    main()
