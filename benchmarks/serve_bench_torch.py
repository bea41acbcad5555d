"""Serving-runtime benchmark on the PyTorch port: the twin of
``benchmarks/serve_bench.py``, on ``repro_torch``.

The same constants, micro config, request mixes, chaos plans and legs as
the reference: SAGA against request-level (regenerated prefill tokens from
the engines' own counters), chaos conservation, the preemption A/B, the
paged-vs-gather A/B, the disaggregation A/B, the traced run, and the three
determinism fingerprints.  Params are the port's own seeded init
(``repro_torch.models.lm.init_params(cfg, seed=0)``) on ``--device``
(default ``cuda``; ``--device cpu`` runs the kernels' plain versions).

    PYTHONPATH=src:. python benchmarks/serve_bench_torch.py --smoke --device cpu
    python3 benchmarks/serve_bench_torch.py --smoke          # on the card

``--smoke`` is the gate: every leg's assertions as in the reference, the
three fingerprints identical across two in-process runs and two child
processes under ``PYTHONHASHSEED`` 0 and 424242, and equal, byte for
byte, to the committed
``benchmarks/expected/serve_bench{,_disagg,_asyncio}_fingerprint.txt``
(``summarize()`` counts tokens and models virtual time, so the port's
parameters and kernels do not move it; each line is
``torch_common.pinned_summary``, which takes ``tct_mean`` as the
committed files do, as a left-to-right sum).  The paged-vs-gather leg compares
summaries and copy bytes, not ids: a gather round writes its idle rows'
K/V at position 0, into occupied slots too, as the reference's does
(``repro_torch/serving/engine.py``, ``Engine.decode``).  Results go to
``benchmarks/results/serve_bench_torch*``.

CSV rows follow the house format: ``name,us_per_call,derived``.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np
import torch

from repro_torch.cluster.faults import chaos_plan
from repro_torch.cluster.workload import runtime_requests
from repro_torch.configs import get_config, load_all
from repro_torch.core.coordinator import SAGAConfig
from repro_torch.models import lm
from repro_torch.serving.disagg import ROLE_DECODE, ROLE_PREFILL
from repro_torch.serving.runtime import (AgentRequest, RuntimePerf,
                                   ServingRuntime)

from repro_torch.obs.export import chrome_trace, report

from benchmarks.torch_common import (check_fingerprint, emit,
                                     percentile, pinned_summary,
                                     save_fingerprint, save_json)

N_WORKERS = 2
N_SLOTS = 6
MAX_LEN = 256
POOL_BLOCKS = 144
SEED = 0
DISAGG_WORKERS = 8
# runtime_requests scales token counts down 64x to fit the micro model;
# the virtual prefill rate scales with them (8000 tok/s at 70B / 64) so
# regeneration costs the same *fraction* of virtual time as at scale.
# Decode needs no rescale: one round is one token per session either way.
PERF = RuntimePerf(prefill_tokens_per_s=8000.0 / 64.0)

ENGINE_KEYS = ("prefill_tokens", "regen_tokens", "decode_steps")


def request_level() -> SAGAConfig:
    return SAGAConfig(cache_policy="none", enable_affinity=False,
                      enable_ttl=False, enable_prefetch=False,
                      enable_afs=False, enable_stealing=False,
                      observability="none")


def _sessions(smoke: bool):
    cfg = get_config("micro")
    n_steps = 3 if smoke else 5
    return runtime_requests(n_sessions=16, vocab=cfg.vocab, seed=SEED,
                            n_steps=n_steps, max_ctx=MAX_LEN - 32)


def run_policy(cfg, params, saga, reqs, engines=None, paged=True):
    """One runtime pass; returns (runtime, engine-counter deltas)."""
    rt = ServingRuntime(cfg, params, n_workers=N_WORKERS, saga=saga,
                        n_slots=N_SLOTS, max_len=MAX_LEN,
                        pool_blocks=POOL_BLOCKS, seed=SEED, perf=PERF,
                        engines=engines, paged=paged)
    before = {k: rt.stats()[k] for k in ENGINE_KEYS}
    for r in reqs:
        rt.submit(r)
    rt.run()
    rt.check_conservation()
    after = rt.stats()
    delta = {k: after[k] - before[k] for k in ENGINE_KEYS}
    return rt, delta


def run_ab(smoke: bool, device: str) -> dict:
    load_all()
    cfg = get_config("micro")
    params = lm.init_params(cfg, seed=0, device=device)
    reqs = _sessions(smoke)

    t0 = time.time()
    saga_rt, saga_eng = run_policy(cfg, params, SAGAConfig(), reqs)
    saga_wall = time.time() - t0
    saga = saga_rt.summarize()

    t0 = time.time()
    base_rt, base_eng = run_policy(cfg, params, request_level(), reqs,
                                   engines=saga_rt.engines)
    base_wall = time.time() - t0
    base_done = [s for s in base_rt.sessions.values()
                 if s.finished_at >= 0]
    base_tcts = sorted(s.tct for s in base_done)

    if not saga["regen_tokens"] < base_eng["regen_tokens"]:
        raise AssertionError(
            f"SAGA regen {saga['regen_tokens']} not strictly below "
            f"request-level {base_eng['regen_tokens']}")
    if base_rt.co.cache_hits != 0:
        raise AssertionError("request-level baseline hit cache")

    out = {
        "n_sessions": len(reqs),
        "n_engines": N_WORKERS,
        "saga": saga,
        "saga_wall_s": saga_wall,
        "reqlevel": {
            "regen_tokens": base_eng["regen_tokens"],
            "prefill_tokens": base_eng["prefill_tokens"],
            "decode_rounds": base_eng["decode_steps"],
            "tct_mean": sum(base_tcts) / len(base_tcts),
            "tct_p99": percentile(base_tcts, 0.99),
            "makespan": max(s.finished_at for s in base_done),
        },
        "reqlevel_wall_s": base_wall,
        "regen_reduction_x":
            base_eng["regen_tokens"] / max(saga["regen_tokens"], 1),
        "tct_speedup_x":
            (sum(base_tcts) / len(base_tcts)) / max(saga["tct_mean"],
                                                    1e-9),
    }
    emit("serve_saga", saga_wall,
         f"regen={saga['regen_tokens']} tct_mean={saga['tct_mean']:.3f} "
         f"hits={saga['cache_hits']} steals={saga['steals']}")
    emit("serve_reqlevel", base_wall,
         f"regen={base_eng['regen_tokens']} "
         f"tct_mean={out['reqlevel']['tct_mean']:.3f}")
    emit("serve_ab", saga_wall + base_wall,
         f"regen_reduction={out['regen_reduction_x']:.2f}x "
         f"tct_speedup={out['tct_speedup_x']:.2f}x")
    return out


def run_chaos(cfg, params) -> dict:
    """Chaos mode: the full SAGA stack under an engine fail / recover /
    scale-up plan on real engines.  Conservation (admitted == finished,
    zero slot/KV-block leak) is asserted inside ``run_policy`` via
    ``check_conservation``, exactly like the simulator's gate."""
    reqs = _sessions(smoke=True)
    rt = ServingRuntime(cfg, params, n_workers=N_WORKERS, saga=SAGAConfig(),
                        n_slots=N_SLOTS, max_len=MAX_LEN,
                        pool_blocks=POOL_BLOCKS, seed=SEED, perf=PERF,
                        fault_plan=chaos_plan(N_WORKERS, 30.0,
                                              n_events=12, seed=1))
    for r in reqs:
        rt.submit(r)
    rt.run()
    rt.check_conservation()      # raises on ANY unfinished session or
    rt.verify_pool_mirrors()     # slot/KV-block leak
    s = rt.summarize()
    if s["faults_injected"] < 1:
        raise AssertionError("chaos plan injected no engine failures")
    return s


def _starvation_runtimes(cfg, params, preempt: bool) -> ServingRuntime:
    """Two hog decodes hold the only engine's two slots; a
    higher-aggregate-demand burst of short sessions then arrives."""
    saga = SAGAConfig(enable_preemption=preempt)
    rt = ServingRuntime(cfg, params, n_workers=1, saga=saga, n_slots=2,
                        max_len=MAX_LEN, pool_blocks=POOL_BLOCKS,
                        seed=SEED, perf=RuntimePerf())
    rng = np.random.RandomState(3)
    for i in range(2):
        rt.submit(AgentRequest(
            f"hog{i}", "hogT",
            [(list(map(int, rng.randint(1, cfg.vocab, 8))), 150,
              "code_execution", 0.05)]))
    for i in range(8):
        rt.submit(AgentRequest(
            f"st{i}", "stT",
            [(list(map(int, rng.randint(1, cfg.vocab, 6))), 40,
              "web_api", 0.05)], arrival_s=0.2))
    rt.run()
    rt.check_conservation()
    return rt


def run_preemption_ab(cfg, params) -> dict:
    """AFS preemption gate: with preemption ON, running decodes are
    parked for the starved tenant and the max fair-share deviation
    (Thm. 2) must be strictly below admission-only ordering."""
    base = _starvation_runtimes(cfg, params, preempt=False)
    pre = _starvation_runtimes(cfg, params, preempt=True)
    if base.preempted != 0:
        raise AssertionError("admission-only run preempted")
    if pre.preempted < 1:
        raise AssertionError("preemption never fired in starvation mix")
    if not pre.afs_dev_max < base.afs_dev_max:
        raise AssertionError(
            f"preemption did not tighten AFS deviation: "
            f"{pre.afs_dev_max} vs admission-only {base.afs_dev_max}")
    return {
        "afs_dev_admission": base.afs_dev_max,
        "afs_dev_preempt": pre.afs_dev_max,
        "dev_reduction_x": base.afs_dev_max / pre.afs_dev_max,
        "preemptions": pre.preempted,
        "preempt_summary": pre.summarize(),
        "admission_summary": base.summarize(),
    }


def run_paged_gather_ab(cfg, params) -> dict:
    """Paged-vs-gather leg: the true-paged decode path (attend over
    block tables, metadata-only park/resume) against the gather oracle
    (contiguous slot caches, park/resume as real device copies).  Both
    must make the same scheduling decisions — the whole summary repr
    matches — while paged moves zero park/resume device bytes and
    regenerates exactly the same tokens.  Token ids are not compared: a
    gather round writes its idle rows' K/V at position 0, into occupied
    slots too, as the reference's gather engine does."""
    reqs = _sessions(smoke=True)
    t0 = time.time()
    paged_rt, paged_eng = run_policy(cfg, params, SAGAConfig(), reqs)
    paged_wall = time.time() - t0
    t0 = time.time()
    gather_rt, gather_eng = run_policy(cfg, params, SAGAConfig(), reqs,
                                       paged=False)
    gather_wall = time.time() - t0
    if repr(paged_rt.summarize()) != repr(gather_rt.summarize()):
        raise AssertionError(
            "paged and gather summaries diverged — the paged path "
            "changed scheduling decisions")
    if paged_eng["regen_tokens"] != gather_eng["regen_tokens"]:
        raise AssertionError(
            f"regen bytes changed: paged {paged_eng['regen_tokens']} vs "
            f"gather {gather_eng['regen_tokens']}")
    ps, gs = paged_rt.stats(), gather_rt.stats()
    if ps["park_copy_bytes"] != 0 or ps["resume_copy_bytes"] != 0:
        raise AssertionError(
            f"paged park/resume moved device bytes: "
            f"park={ps['park_copy_bytes']} resume={ps['resume_copy_bytes']}")
    if gs["park_copy_bytes"] <= 0 or gs["resume_copy_bytes"] <= 0:
        raise AssertionError("gather oracle moved no park/resume bytes "
                             "— the A/B is not exercising park/resume")
    rounds = max(paged_eng["decode_steps"], 1)
    # per-round wall (whole runtime pass over decode rounds, prefill and
    # park/resume copies included) is informational
    out = {
        "paged_wall_s": paged_wall,
        "gather_wall_s": gather_wall,
        "decode_rounds": paged_eng["decode_steps"],
        "paged_us_per_round": 1e6 * paged_wall / rounds,
        "gather_us_per_round": 1e6 * gather_wall / rounds,
        "round_latency_delta_us":
            1e6 * (paged_wall - gather_wall) / rounds,
        "paged_park_copy_bytes": ps["park_copy_bytes"],
        "paged_resume_copy_bytes": ps["resume_copy_bytes"],
        "gather_park_copy_bytes": gs["park_copy_bytes"],
        "gather_resume_copy_bytes": gs["resume_copy_bytes"],
    }
    emit("serve_paged_round", paged_wall / rounds,
         f"gather={out['gather_us_per_round']:.0f}us "
         f"delta={out['round_latency_delta_us']:+.0f}us "
         f"park_bytes=0 resume_bytes=0 vs "
         f"{gs['park_copy_bytes']}/{gs['resume_copy_bytes']}")
    return out


def _disagg_arm(cfg, params, reqs, disagg: bool):
    """One traced arm of the disaggregation A/B.  Both arms run the
    same BurstGPT-style burst mix over the same engine count with the
    same chunked-prefill interference coefficients (both directions:
    prefills stretch co-resident decode rounds AND are themselves
    chunked into the round schedule) — the only difference is whether
    prefill work shares decode engines (unified) or lives in its own
    pool with block-granular handoff (disagg).  The mix is
    prefill-heavy (long agent contexts, short tool-step decodes), so
    the pool is provisioned to the prefill share of compute: 5 prefill
    / 3 decode engines — role sizing is a deployment choice, and an
    underprovisioned pool simply queues (``prefill_deferred``)."""
    perf = RuntimePerf(prefill_tokens_per_s=8000.0 / 64.0,
                       prefill_round_interference=0.35,
                       prefill_decode_interference=0.35)
    roles = [ROLE_PREFILL] * 5 + [ROLE_DECODE] * 3 if disagg else None
    rt = ServingRuntime(cfg, params, n_workers=DISAGG_WORKERS,
                        saga=SAGAConfig(disaggregate=disagg),
                        n_slots=6, max_len=MAX_LEN,
                        pool_blocks=POOL_BLOCKS, seed=SEED, perf=perf,
                        roles=roles, trace=True)
    for r in reqs:
        rt.submit(r)
    rt.run()
    rt.check_conservation()
    rt.verify_pool_mirrors()
    rt.tracer.check_closed()
    return rt, report(rt.tracer)


def _disagg_reqs(cfg):
    return runtime_requests(n_sessions=16, vocab=cfg.vocab, seed=SEED,
                            mix=("burstgpt",), n_steps=3,
                            max_ctx=MAX_LEN - 32)


def run_disagg_ab(cfg, params) -> dict:
    """Disaggregation gate: under a bursty mix where chunked prefill
    interferes with co-resident decode rounds
    (``prefill_round_interference`` > 0 in BOTH arms), splitting the
    engines into prefill/decode pools must improve TTFT-on-resume p99
    — resumes whose speculative prefill and handoff overlapped the tool
    gap join a decode slot with zero prefill on the critical path — and
    must not degrade p99 decode-round latency (prefill leaves the
    decode engines)."""
    uni_rt, uni = _disagg_arm(cfg, params, _disagg_reqs(cfg), False)
    dis_rt, dis = _disagg_arm(cfg, params, _disagg_reqs(cfg), True)
    ds = dis_rt.summarize()
    if ds["handoffs"] < 1 or ds["speculative_prefills"] < 1:
        raise AssertionError(
            f"disagg arm never exercised the handoff path: {ds}")
    uni_ttft = uni["ttft_on_resume"]["p99"]
    dis_ttft = dis["ttft_on_resume"]["p99"]
    if not dis_ttft < uni_ttft:
        raise AssertionError(
            f"disaggregation did not improve TTFT-on-resume p99: "
            f"{dis_ttft:.4f}s vs unified {uni_ttft:.4f}s")
    uni_round = uni["round_latency"]["p99"]
    dis_round = dis["round_latency"]["p99"]
    if not dis_round <= uni_round:
        raise AssertionError(
            f"disaggregation degraded p99 round latency: "
            f"{dis_round:.4f}s vs unified {uni_round:.4f}s")
    out = {
        "n_engines": DISAGG_WORKERS,
        "roles": list(dis_rt.roles),
        "unified_ttft_resume_p99": uni_ttft,
        "disagg_ttft_resume_p99": dis_ttft,
        "ttft_improvement_x": uni_ttft / max(dis_ttft, 1e-9),
        "unified_round_p99": uni_round,
        "disagg_round_p99": dis_round,
        "handoffs": ds["handoffs"],
        "handoff_bytes": ds["handoff_bytes"],
        "speculative_prefills": ds["speculative_prefills"],
        "prefill_deferred": ds["prefill_deferred"],
        "unified_summary": uni_rt.summarize(),
        "disagg_summary": ds,
    }
    emit("serve_disagg_ab", dis_ttft,
         f"ttft_resume_p99={dis_ttft:.4f}s vs {uni_ttft:.4f}s "
         f"({out['ttft_improvement_x']:.2f}x) round_p99="
         f"{dis_round:.4f}s vs {uni_round:.4f}s "
         f"handoffs={ds['handoffs']}")
    return out


def run_traced(cfg, params, expect_summary) -> dict:
    """Observability leg: the clean SAGA pass re-run with the span
    tracer on.  Tracing is read-only by contract, so the traced
    summary must be byte-identical to the untraced one from
    ``run_ab``; every span must close; and the Perfetto trace +
    per-phase TCT decomposition are saved for CI's artifact upload."""
    reqs = _sessions(smoke=True)
    rt = ServingRuntime(cfg, params, n_workers=N_WORKERS,
                        saga=SAGAConfig(), n_slots=N_SLOTS,
                        max_len=MAX_LEN, pool_blocks=POOL_BLOCKS,
                        seed=SEED, perf=PERF, trace=True)
    t0 = time.time()
    for r in reqs:
        rt.submit(r)
    rt.run()
    wall = time.time() - t0
    rt.check_conservation()
    if repr(rt.summarize()) != repr(expect_summary):
        raise AssertionError(
            "traced summary diverged from untraced — tracing perturbed "
            "the schedule, violating the zero-perturbation contract")
    rt.tracer.check_closed()
    save_json("serve_bench_torch_trace", chrome_trace(rt.tracer,
                                                      rt.obs_metrics))
    rep = report(rt.tracer)
    frac = rep["phase_frac"]
    emit("serve_traced", wall,
         f"spans={len(rt.tracer.spans)} "
         f"prefill={frac.get('prefill', 0.0):.3f} "
         f"decode={frac.get('decode', 0.0):.3f} "
         f"round_p99={rep['round_latency']['p99']:.4f}")
    return rep


def _fingerprint(device: str) -> str:
    """Deterministic SAGA-run summaries (fresh engines, fixed seed): the
    byte-identity contract compared across runs and processes, covering
    the clean, chaos, and preemption paths (each line ``pinned_summary``,
    the form the committed files hold).  Reduced sizes so the smoke
    gate can afford to run it three times — the contract is about
    replay, not scale."""
    load_all()
    cfg = get_config("micro")
    params = lm.init_params(cfg, seed=0, device=device)
    reqs = runtime_requests(n_sessions=8, vocab=cfg.vocab, seed=SEED,
                            n_steps=2, max_ctx=MAX_LEN - 32)
    rt, _ = run_policy(cfg, params, SAGAConfig(), reqs)
    lines = ["clean " + repr(pinned_summary(rt))]
    chaos_reqs = runtime_requests(n_sessions=6, vocab=cfg.vocab,
                                  seed=SEED, n_steps=2,
                                  max_ctx=MAX_LEN - 32)
    crt = ServingRuntime(cfg, params, n_workers=N_WORKERS,
                         saga=SAGAConfig(enable_preemption=True),
                         n_slots=2, max_len=MAX_LEN,
                         pool_blocks=POOL_BLOCKS, seed=SEED, perf=PERF,
                         fault_plan=chaos_plan(N_WORKERS, 10.0,
                                               n_events=8, seed=1))
    for r in chaos_reqs:
        crt.submit(r)
    crt.run()
    crt.check_conservation()
    lines.append("chaos+preempt " + repr(pinned_summary(crt)))
    return "\n".join(lines)


def _disagg_fingerprint(device: str) -> str:
    """Disaggregated-mode determinism contract: a clean disagg run and
    a disagg run with the prefill engine dying mid-stream, both
    summarized — handoff placement, transfer windows and fault
    cancellation are RNG- and hash-order-free, so these lines are
    byte-identical across processes and ``PYTHONHASHSEED``."""
    load_all()
    cfg = get_config("micro")
    params = lm.init_params(cfg, seed=0, device=device)

    def _one(fault_plan=None):
        rt = ServingRuntime(cfg, params, n_workers=4,
                            saga=SAGAConfig(disaggregate=True),
                            n_slots=N_SLOTS, max_len=MAX_LEN,
                            pool_blocks=POOL_BLOCKS, seed=SEED,
                            perf=PERF, fault_plan=fault_plan)
        for r in runtime_requests(n_sessions=8, vocab=cfg.vocab,
                                  seed=SEED, mix=("burstgpt",),
                                  n_steps=2, max_ctx=MAX_LEN - 32):
            rt.submit(r)
        rt.run()
        rt.check_conservation()
        return repr(pinned_summary(rt))

    return "disagg " + _one() + "\ndisagg-chaos " \
        + _one(fault_plan=[(0.5, "fail", 0), (2.0, "recover", 0)])


def _asyncio_fingerprint(device: str) -> str:
    """Fake-clock asyncio identity contract (serving/frontend): the
    wall-clock driver run under ``FakeClock`` pops the same event heap
    through the same handlers, so its ``summarize()`` must be
    byte-identical to the virtual-time clean run — pacing can throttle,
    never reorder.  Submissions go through the ``SagaClient`` facade to
    pin that path too."""
    import asyncio

    from repro_torch.serving.client import SagaClient
    from repro_torch.serving.frontend import AsyncServingDriver, FakeClock

    load_all()
    cfg = get_config("micro")
    params = lm.init_params(cfg, seed=0, device=device)

    def _reqs():
        return runtime_requests(n_sessions=8, vocab=cfg.vocab,
                                seed=SEED, n_steps=2,
                                max_ctx=MAX_LEN - 32)

    rt, _ = run_policy(cfg, params, SAGAConfig(), _reqs())
    virt = repr(rt.summarize())

    art = ServingRuntime(cfg, params, n_workers=N_WORKERS,
                         saga=SAGAConfig(), n_slots=N_SLOTS,
                         max_len=MAX_LEN, pool_blocks=POOL_BLOCKS,
                         seed=SEED, perf=PERF)
    drv = AsyncServingDriver(art, clock=FakeClock())
    client = SagaClient.for_driver(drv)
    for r in _reqs():
        client.submit(r)
    asyncio.run(drv.run())
    art.check_conservation()
    wall = repr(art.summarize())
    if wall != virt:
        raise AssertionError(
            "asyncio fake-clock summary diverged from virtual time:\n"
            f"  virtual {virt}\n  asyncio {wall}")
    return "asyncio " + repr(pinned_summary(art))


def smoke(device: str) -> None:
    """CI gate: 16 concurrent sessions over 2 engines on real forward
    passes — SAGA strictly below request-level regeneration; chaos-mode
    conservation + zero slot/KV leak under engine faults; preemption
    strictly tightening max AFS deviation vs admission-only; and
    byte-identical identical-seed summaries (clean + chaos + preempt)
    in-process and across PYTHONHASHSEED, each equal to its committed
    file in ``benchmarks/expected/`` and saved beside it in
    ``benchmarks/results/``."""
    load_all()
    cfg = get_config("micro")
    params = lm.init_params(cfg, seed=0, device=device)
    out = run_ab(smoke=True, device=device)
    chaos = run_chaos(cfg, params)
    pre = run_preemption_ab(cfg, params)
    pg = run_paged_gather_ab(cfg, params)
    dz = run_disagg_ab(cfg, params)
    rep = run_traced(cfg, params, out["saga"])
    out["chaos"] = chaos
    out["preemption"] = pre
    out["paged_vs_gather"] = pg
    out["disagg_ab"] = dz
    out["trace_report"] = rep
    save_json("serve_bench_torch_smoke", out)
    a = _fingerprint(device)
    assert a == _fingerprint(device), "same-process summaries diverged"
    d = _disagg_fingerprint(device)
    assert d == _disagg_fingerprint(device), \
        "same-process disagg summaries diverged"
    z = _asyncio_fingerprint(device)    # asserts asyncio == virtual inside
    outs = []
    for hashseed in ("0", "424242"):
        env = dict(os.environ)
        env["PYTHONHASHSEED"] = hashseed
        r = subprocess.run([sys.executable, __file__, "--smoke-emit",
                            "--device", device],
                           env=env, capture_output=True, text=True,
                           timeout=240)
        assert r.returncode == 0, r.stderr
        outs.append(r.stdout)
    assert outs[0] == outs[1], "cross-process summaries diverged"
    assert a + "\n" + d + "\n" + z + "\n" == outs[0], \
        "parent/child summaries diverged"
    for name, text in (("serve_bench", a), ("serve_bench_disagg", d),
                       ("serve_bench_asyncio", z)):
        save_fingerprint(name.replace("serve_bench", "serve_bench_torch"),
                         text)
        check_fingerprint(name, text)
    print(f"smoke ok: {out['n_sessions']} sessions / {out['n_engines']} "
          f"engines, regen {out['saga']['regen_tokens']} vs "
          f"{out['reqlevel']['regen_tokens']} "
          f"({out['regen_reduction_x']:.2f}x); chaos "
          f"faults={chaos['faults_injected']} "
          f"cancelled={chaos['cancelled_attempts']} conservation green; "
          f"preemption dev {pre['afs_dev_preempt']:.3f} vs "
          f"{pre['afs_dev_admission']:.3f} "
          f"({pre['dev_reduction_x']:.2f}x, {pre['preemptions']} parks); "
          f"paged==gather byte-identical, park/resume copies 0 vs "
          f"{pg['gather_park_copy_bytes']}/"
          f"{pg['gather_resume_copy_bytes']} bytes "
          f"(round delta {pg['round_latency_delta_us']:+.0f}us); "
          f"disagg ttft-on-resume p99 {dz['disagg_ttft_resume_p99']:.4f}s "
          f"vs unified {dz['unified_ttft_resume_p99']:.4f}s "
          f"({dz['ttft_improvement_x']:.2f}x, {dz['handoffs']} handoffs); "
          f"traced run byte-identical ({rep['span_counts']['session']} "
          f"session span trees closed); asyncio fake-clock replay "
          f"byte-identical; determinism green; fingerprints equal "
          f"benchmarks/expected/ [{device}]")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="fast CI gate: A/B + conservation + determinism")
    ap.add_argument("--smoke-emit", action="store_true",
                    help="internal: print the determinism fingerprint")
    ap.add_argument("--device", default="cuda",
                    help="where the engines run (cuda or cpu)")
    args = ap.parse_args()
    if args.device == "cpu":
        torch.set_num_threads(1)    # micro shapes: threads only add overhead
    if args.smoke_emit:
        print(_fingerprint(args.device))
        print(_disagg_fingerprint(args.device))
        print(_asyncio_fingerprint(args.device))
        return
    if args.smoke:
        smoke(args.device)
        return
    out = run_ab(smoke=False, device=args.device)
    save_json("serve_bench_torch", out)
    print(f"SAGA:          regen={out['saga']['regen_tokens']:6d} tokens  "
          f"tct_mean={out['saga']['tct_mean']:.3f}s  "
          f"makespan={out['saga']['makespan']:.3f}s")
    print(f"request-level: regen={out['reqlevel']['regen_tokens']:6d} "
          f"tokens  tct_mean={out['reqlevel']['tct_mean']:.3f}s  "
          f"makespan={out['reqlevel']['makespan']:.3f}s")
    print(f"regen reduction {out['regen_reduction_x']:.2f}x, "
          f"TCT speedup {out['tct_speedup_x']:.2f}x on real forward "
          f"passes")


if __name__ == "__main__":
    main()
