"""Wall-clock soak harness for the asyncio serving front end, on the
PyTorch port: the twin of ``benchmarks/soak_bench.py``, on ``repro_torch``
with the port's own seeded micro params on ``--device`` (default
``cuda``; ``--device cpu`` runs the kernels' plain versions).

Hundreds of concurrent agent sessions pushed through the REAL stack —
``SagaClient`` → ``AsyncServingDriver`` (wall clock, executor-threaded
engine steps) → ``ServingRuntime`` on jitted engines — while a live
``SagaHTTPProxy`` serves OpenAI-compatible completions (one streamed)
and a ``/metrics`` scrape on the side.  Arrivals are staggered in real
time, so the virtual schedule is built from wall-clock traffic, not a
pre-declared plan.

The harness exits 0 only when, after the last session completes:

  * ``check_conservation()``   — every session finished, zero slot leak,
                                 indices consistent;
  * ``audit_blocks()``         — every KV block on every engine is on
                                 the free list or in exactly one table
                                 (no leak, no double-release);
  * ``verify_pool_mirrors()``  — coordinator metadata matches the real
                                 block tables;
  * ``check_closed()``         — every tracer span closed.

    PYTHONPATH=src:. python benchmarks/soak_bench_torch.py --smoke --device cpu
        # >= 200 sessions; python3 benchmarks/soak_bench_torch.py --smoke
        # on the card
    PYTHONPATH=src:. python benchmarks/soak_bench_torch.py \
        --sessions 1000 --spread-s 30                          # longer

Results go to ``benchmarks/results/soak_bench_torch*.json``.

CSV row: ``soak,us_per_session,derived`` (house format).
"""
from __future__ import annotations

import argparse
import asyncio
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np
import torch

from repro_torch.configs import get_config, load_all
from repro_torch.core.coordinator import SAGAConfig
from repro_torch.models import lm
from repro_torch.serving.client import SagaClient
from repro_torch.serving.frontend import AsyncServingDriver, SagaHTTPProxy
from repro_torch.serving.runtime import AgentRequest, RuntimePerf, ServingRuntime

from benchmarks.torch_common import emit, save_json

N_WORKERS = 3
N_SLOTS = 8
MAX_LEN = 128
POOL_BLOCKS = 768
SEED = 0
TOOLS = ("code_execution", "web_api", "file_operations", "browser")
SMOKE_SESSIONS, SMOKE_SPREAD_S = 200, 4.0      # the --smoke size
TIME_SCALE = 0.02           # wall seconds per virtual second (default)


def _requests(n: int, vocab: int, seed: int = SEED):
    """Small multi-step sessions across 8 tenants: big enough to park
    on tool gaps, small enough that N hundred of them finish in CI."""
    rng = np.random.RandomState(seed)
    reqs = []
    for i in range(n):
        n_steps = int(rng.randint(2, 4))
        steps = [(list(map(int, rng.randint(1, vocab, size=8))),
                  int(rng.randint(3, 7)), TOOLS[int(rng.randint(4))],
                  float(rng.uniform(0.05, 0.4)))
                 for _ in range(n_steps)]
        reqs.append(AgentRequest(f"soak{i}", f"tenant{i % 8}", steps))
    return reqs


async def _http(port: int, method: str, path: str, body=None,
                headers=None) -> tuple:
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    payload = json.dumps(body).encode() if body is not None else b""
    head = f"{method} {path} HTTP/1.1\r\nHost: soak\r\nConnection: close\r\n"
    for k, v in (headers or {}).items():
        head += f"{k}: {v}\r\n"
    head += f"Content-Length: {len(payload)}\r\n\r\n"
    writer.write(head.encode() + payload)
    await writer.drain()
    data = await reader.read()
    writer.close()
    status = int(data.split(b" ", 2)[1])
    return status, data


async def _soak(n_sessions: int, spread_s: float, time_scale: float,
                strategy: str, device: str) -> dict:
    load_all()
    cfg = get_config("micro")
    params = lm.init_params(cfg, seed=0, device=device)
    rt = ServingRuntime(cfg, params, seed=SEED, n_workers=N_WORKERS,
                        n_slots=N_SLOTS, max_len=MAX_LEN,
                        pool_blocks=POOL_BLOCKS, saga=SAGAConfig(),
                        perf=RuntimePerf(prefill_tokens_per_s=8000.0 / 64),
                        trace=True)
    driver = AsyncServingDriver(rt, time_scale=time_scale, executor=True)
    client = SagaClient.for_driver(driver)
    proxy = await SagaHTTPProxy(driver, strategy=strategy).start()
    pump = asyncio.create_task(driver.serve_forever())
    t0 = time.time()

    # stagger submissions over ~spread_s of real wall clock
    reqs = _requests(n_sessions, cfg.vocab)
    handles = []
    batch = max(1, n_sessions // max(1, int(spread_s / 0.05)))
    for i, r in enumerate(reqs):
        handles.append(client.submit(r, slo=120.0))
        if (i + 1) % batch == 0:
            await asyncio.sleep(0.05)

    # live HTTP traffic while the fleet decodes: 4 plain completions
    # on one sticky session + 1 streamed, end-to-end through the proxy
    chat = {"model": "soak", "max_tokens": 5,
            "messages": [{"role": "user", "content": "soak probe alpha"},
                         {"role": "assistant", "content": "ack"},
                         {"role": "user", "content": "soak probe beta"}],
            "saga": {"tool_gap_s": 0.1, "step_tokens": 3}}
    http_ok = 0
    for i in range(4):
        status, raw = await _http(proxy.port, "POST",
                                  "/v1/chat/completions", chat,
                                  {"X-Session-Id": "soak-http",
                                   "X-Program-Id": "soak-prog"})
        assert status == 200, raw[:200]
        resp = json.loads(raw.split(b"\r\n\r\n", 1)[1])
        assert resp["choices"][0]["message"]["content"], resp
        http_ok += 1
    status, raw = await _http(proxy.port, "POST", "/v1/chat/completions",
                              dict(chat, stream=True),
                              {"X-Session-Id": "soak-http"})
    assert status == 200 and b"[DONE]" in raw, raw[:200]
    http_ok += 1
    status, metrics = await _http(proxy.port, "GET", "/metrics")
    assert status == 200
    for family in (b"saga_queue_depth", b"saga_kv_pool_blocks_used",
                   b"saga_afs_deviation_max", b"saga_kv_handoff_bytes"):
        assert family in metrics, f"/metrics missing {family}"

    await asyncio.gather(*(h.wait(timeout=300.0) for h in handles))
    # idle one pump cycle so trailing epoch ticks drain, then stop
    while rt.ev:
        await asyncio.sleep(0.02)
    driver.stop()
    await pump
    await proxy.stop()
    wall = time.time() - t0

    # -- the four leak gates --------------------------------------------
    rt.check_conservation()
    rt.verify_pool_mirrors()
    for w, eng in enumerate(rt.engines):
        problems = eng.pool.audit_blocks()
        assert not problems, f"engine {w} block audit: {problems[:3]}"
    rt.tracer.check_closed()

    summary = rt.summarize()
    assert summary["n_done"] == len(rt.sessions) >= n_sessions
    done_http = [t for t in proxy.tracker.finished
                 if t.client_session == "soak-http"]
    assert len(done_http) == http_ok
    return {
        "n_sessions": int(summary["n_done"]),
        "http_completions": http_ok,
        "wall_s": wall,
        "events": driver.wall_stats["events"],
        "max_lag_s": driver.wall_stats["max_lag_s"],
        "virtual_makespan_s": summary["makespan"],
        "decoded_tokens": summary["decoded_tokens"],
        "steals": summary["steals"],
        "preempt_phase_counts": proxy.tracker.phase_counts(),
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="gate: 200+ sessions, zero leak")
    ap.add_argument("--sessions", type=int, default=400)
    ap.add_argument("--spread-s", type=float, default=10.0,
                    help="wall seconds to spread arrivals over")
    ap.add_argument("--time-scale", type=float, default=TIME_SCALE,
                    help="wall seconds per virtual second")
    ap.add_argument("--strategy", default="least-loaded",
                    choices=("saga-affinity", "round-robin",
                             "least-loaded"))
    ap.add_argument("--device", default="cuda",
                    help="where the engines run (cuda or cpu)")
    args = ap.parse_args()
    if args.device == "cpu":
        torch.set_num_threads(1)    # micro shapes: threads only add overhead
    if args.smoke:
        args.sessions, args.spread_s = SMOKE_SESSIONS, SMOKE_SPREAD_S
    out = asyncio.run(_soak(args.sessions, args.spread_s,
                            args.time_scale, args.strategy, args.device))
    save_json("soak_bench_torch_smoke" if args.smoke else "soak_bench_torch",
              out)
    emit("soak", out["wall_s"] / max(out["n_sessions"], 1),
         f"sessions={out['n_sessions']} http={out['http_completions']} "
         f"wall={out['wall_s']:.1f}s events={out['events']} "
         f"lag={out['max_lag_s']:.3f}s")
    print(f"soak ok: {out['n_sessions']} sessions "
          f"(+{out['http_completions']} HTTP completions through the "
          f"proxy) in {out['wall_s']:.1f}s wall / "
          f"{out['virtual_makespan_s']:.1f}s virtual, "
          f"{out['events']} events, max pacing lag "
          f"{out['max_lag_s']:.3f}s; conservation + block audit + pool "
          f"mirrors + span closure all green")


if __name__ == "__main__":
    main()
