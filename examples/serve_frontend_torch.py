"""Wall-clock serving demo on the PyTorch port: the asyncio front end +
OpenAI-compatible HTTP proxy over real engines (the twin of
``examples/serve_frontend.py``).

Starts ``AsyncServingDriver`` (real wall clock, compressed 20x) with
``SagaHTTPProxy`` on an ephemeral port, plays an OpenAI client against
it — a sticky multi-turn session (``X-Session-Id`` keeps park/resume on
the session's KV home engine), a streamed completion, a ``/metrics``
scrape — while a background agent fleet submitted through ``SagaClient``
keeps the engines busy.  See docs/SERVING_API.md.  The engines' steps run
in AsyncServingDriver's worker thread (``executor=True``), on the params'
device.  Params are the port's seeded init on ``--device`` (default
``cuda``; ask for ``--device cpu`` to run on the CPU).

    PYTHONPATH=src python examples/serve_frontend_torch.py [--device cpu]
"""
import argparse
import asyncio
import json

from repro_torch.cluster.workload import runtime_requests
from repro_torch.configs import get_config, load_all
from repro_torch.core.coordinator import SAGAConfig
from repro_torch.models import lm
from repro_torch.serving.client import SagaClient
from repro_torch.serving.frontend import AsyncServingDriver, SagaHTTPProxy
from repro_torch.serving.runtime import RuntimePerf, ServingRuntime


async def http(port, method, path, body=None, headers=None):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    payload = json.dumps(body).encode() if body is not None else b""
    head = f"{method} {path} HTTP/1.1\r\nHost: demo\r\nConnection: close\r\n"
    for k, v in (headers or {}).items():
        head += f"{k}: {v}\r\n"
    writer.write((head + f"Content-Length: {len(payload)}\r\n\r\n")
                 .encode() + payload)
    await writer.drain()
    data = await reader.read()
    writer.close()
    return data.split(b"\r\n\r\n", 1)[1]


async def serve(cfg, params):
    rt = ServingRuntime(cfg, params, n_workers=2, n_slots=6, max_len=256,
                        pool_blocks=144, saga=SAGAConfig(), seed=0,
                        perf=RuntimePerf(prefill_tokens_per_s=8000.0 / 64))
    driver = AsyncServingDriver(rt, time_scale=0.05, executor=True)
    proxy = await SagaHTTPProxy(driver).start()
    pump = asyncio.create_task(driver.serve_forever())
    print(f"proxy listening on {proxy.base_url}")

    # background fleet through the unified client API
    fleet = SagaClient.for_driver(driver)
    handles = [fleet.submit(r) for r in runtime_requests(
        n_sessions=6, vocab=cfg.vocab, seed=0, n_steps=2, max_ctx=200)]

    # a sticky two-turn chat session: the second request is hinted to
    # the engine whose pool holds the first request's KV
    chat = {"model": "saga-micro", "max_tokens": 8,
            "messages": [{"role": "user", "content": "plan the fix"},
                         {"role": "assistant", "content": "running tests"},
                         {"role": "user", "content": "apply the patch"}],
            "saga": {"tool_gap_s": 0.2, "step_tokens": 4}}
    for i in range(2):
        raw = await http(proxy.port, "POST", "/v1/chat/completions",
                         chat, {"X-Session-Id": "demo-session"})
        resp = json.loads(raw)
        print(f"completion {i}: engine={resp['saga']['engine']} "
              f"steps={resp['saga']['steps']} "
              f"content={resp['choices'][0]['message']['content']!r}")

    raw = await http(proxy.port, "POST", "/v1/chat/completions",
                     dict(chat, stream=True),
                     {"X-Session-Id": "demo-session"})
    n_chunks = raw.count(b"chat.completion.chunk")
    print(f"streamed completion: {n_chunks} SSE chunks")

    await asyncio.gather(*(h.wait() for h in handles))
    metrics = (await http(proxy.port, "GET", "/metrics")).decode()
    depth = [l for l in metrics.splitlines()
             if l.startswith(("saga_queue_depth", "saga_kv_pool_blocks_used",
                              "saga_afs_deviation_max"))]
    print("metrics sample:\n  " + "\n  ".join(depth))

    driver.stop()
    await pump
    await proxy.stop()
    rt.check_conservation()
    print(f"done: {rt.n_done} sessions, "
          f"{driver.wall_stats['events']} events, "
          f"{driver.wall_stats['wall_elapsed_s']:.1f}s wall "
          f"({rt.ev.now:.1f}s virtual), conservation clean")


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
    asyncio.run(serve(cfg, params))


if __name__ == "__main__":
    main()
