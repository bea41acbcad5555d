#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
card, built for an H100:

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit code:

1. The card: ``nvidia-smi`` name and power limit.  Build the kernels from
   ``src/repro_torch/csrc/*.cu`` with nvcc (one process per source, all
   at once) into ``build/kernels/``.
2. Every kernel against its plain PyTorch version on the card, in bf16,
   within 2e-2: flash prefill at llama3.2-3b width (S=1024, H=24, K=8,
   D=128; causal, and causal + window 32) and at micro width (D=16, and a
   ragged S); paged append + decode at B=4, H=24, K=8, dh=128, block 16,
   lens up to 2048 with a drop-sentinel row (window 0 and 32), and at
   dh=16.  Each kernel is timed with CUDA events beside its plain
   version, its bound and, for flash, ``scaled_dot_product_attention``
   (a yardstick the port never calls).
3. A reference check on a small input: micro's prefill and paged-decode
   logits through the kernels on the card against the plain versions on
   the CPU.
4. The main path: llama3.2-3b at full width and depth with random bf16
   weights made on the card from a seed, served by ``MultiWorkerServer``
   (2 workers, 4 slots, max_len 2048, block 16, 1024 pool blocks) for 4
   agent tasks of 3 steps.  The kernels' launch counts are zeroed just
   before and read just after; each must be > 0, and conservation and the
   block audit must be clean.

The second-to-last line is the kernels' JSON record; the last is
``{"ok": true, "device": {...}}``.  Nothing falls back to the CPU: without
CUDA the script exits non-zero before any result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

TOL_BF16 = 2e-2             # tests/test_kernels.py TOL[bfloat16]
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
BF16_FLOPS = 989e12         # dense bf16 tensor-core peak


def log(*a):
    print(*a, flush=True)


def bound(nbytes: float, flops: float):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the bf16 peak."""
    tb, tf = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return (max(tb, tf) * 1e3, "bytes" if tb >= tf else "operations")


def timed(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def device_ms(torch, fn, kernel: str, iters: int = 10):
    """Per-call device time of the kernels whose name contains ``kernel``,
    from the profiler's CUDA trace; None when the trace shows no device
    time (the event timing above then stands alone)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(_dev_us(e) for e in prof.key_averages() if kernel in e.key)
    return us / iters / 1e3 if us else None


def _dev_us(evt) -> float:
    """Self device time of a kernel's entry; 0 for host-side ops, whose
    device time the kernel entries already count."""
    if not str(evt.device_type).endswith("CUDA"):
        return 0.0
    return float(getattr(evt, "self_device_time_total", None)
                 or getattr(evt, "self_cuda_time_total", 0.0))


def max_err(x, y) -> float:
    return float((x.float() - y.float()).abs().max())


def check(name: str, err: float, tol: float = TOL_BF16) -> float:
    log(f"  {name}: max_abs_err {err:.3e} (tol {tol:g})")
    if not err < tol:
        raise AssertionError(f"{name}: max abs error {err} >= {tol}")
    return err


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------
def flash_phase(torch, gen):
    from repro_torch.kernels.flash_attention import ops as F

    def inputs(B, S, H, K, D):
        mk = lambda *s: torch.randn(s, generator=gen, device="cuda",  # noqa
                                    dtype=torch.float32).to(torch.bfloat16)
        return mk(B, S, H, D), mk(B, S, K, D), mk(B, S, K, D)

    errs, rec = [], None
    for (B, S, H, K, D), window in [((1, 1024, 24, 8, 128), 0),
                                    ((1, 1024, 24, 8, 128), 32),
                                    ((1, 256, 4, 2, 16), 0),
                                    ((2, 200, 4, 2, 16), 32)]:
        q, k, v = inputs(B, S, H, K, D)
        out = F.flash_prefill(q, k, v, causal=True, window=window)
        torch.cuda.synchronize()
        ref = F.flash_prefill_plain(q, k, v, causal=True, window=window)
        errs.append(check(f"flash B={B} S={S} H={H} K={K} D={D} "
                          f"window={window}", max_err(out, ref)))
        if rec is None:        # the main path's shape: llama3.2-3b, causal
            ms = timed(torch, lambda: F.flash_prefill(q, k, v, causal=True))
            plain_ms = timed(torch, lambda: F.flash_prefill_plain(
                q, k, v, causal=True), iters=5)
            lib_ms = timed(torch, lambda: torch.nn.functional
                           .scaled_dot_product_attention(
                               q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), is_causal=True,
                               enable_gqa=True))
            dev = device_ms(torch, lambda: F.flash_prefill(
                q, k, v, causal=True), "flash_prefill_kernel")
            pairs = B * H * S * (S + 1) // 2
            nbytes = 2 * (2 * B * S * H * D + 2 * B * S * K * D)
            bms, by = bound(nbytes, 4 * D * pairs)
            rec = {"name": "flash_prefill", "route": "cuda",
                   "source": "src/repro_torch/csrc/flash_attention.cu",
                   "replaces": "src/repro/kernels/flash_attention/"
                               "kernel.py:73",
                   "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                   "bound_by": by, "library_ms": lib_ms, "device_ms": dev,
                   "shape": f"B={B} S={S} H={H} K={K} D={D} causal"}
            log(f"  flash time {ms:.4f} ms (device {dev} ms)  plain "
                f"{plain_ms:.4f} ms  sdpa {lib_ms:.4f} ms  bound {bms:.4f} "
                f"ms ({by})")
    rec["max_abs_err"] = max(errs)
    return rec


def paged_phase(torch, gen):
    from repro_torch.kernels.paged_attention import ops as P

    recs = {}
    errs = {"paged_decode": [], "paged_append": []}
    for (B, H, K, dh), window in [((4, 24, 8, 128), 0),
                                  ((4, 24, 8, 128), 32),
                                  ((4, 4, 2, 16), 0)]:
        block, nb = 16, 2048 // 16
        nblocks = B * nb + 8
        mk = lambda *s: torch.randn(s, generator=gen, device="cuda",  # noqa
                                    dtype=torch.float32).to(torch.bfloat16)
        q = mk(B, H, dh)
        k_new, v_new = mk(B, K, dh), mk(B, K, dh)
        kp, vp = mk(nblocks, block, K, dh), mk(nblocks, block, K, dh)
        perm = torch.randperm(nblocks, generator=gen, device="cuda")
        tables = perm[:B * nb].reshape(B, nb).to(torch.int32).contiguous()
        # lens include the appended token; row 2 is idle: drop sentinel
        lens = torch.tensor([2048, 1531, 1, 77], dtype=torch.int32,
                            device="cuda")
        pos = (lens - 1).long()
        ablk = tables[torch.arange(B, device="cuda"), pos // block]
        ablk[2] = nblocks
        aoff = (pos % block).to(torch.int32)
        ablk = ablk.to(torch.int32).contiguous()

        kp2, vp2 = kp.clone(), vp.clone()
        P.paged_append(kp, vp, k_new, v_new, ablk, aoff)
        out = P.paged_decode(q, kp, vp, tables, lens, window=window)
        torch.cuda.synchronize()
        P.paged_append_plain(kp2, vp2, k_new, v_new, ablk, aoff)
        ref = P.paged_decode_plain(q, kp2, vp2, tables, lens, window=window)
        # the append moves bits: it must match the plain version exactly
        errs["paged_append"].append(check(
            f"append B={B} K={K} dh={dh} (sentinel row dropped)",
            max(max_err(kp, kp2), max_err(vp, vp2)), tol=1e-30))
        errs["paged_decode"].append(check(
            f"paged decode B={B} H={H} K={K} dh={dh} window={window}",
            max_err(out, ref)))
        if "paged_decode" in recs:
            continue
        # the main path's shape: llama3.2-3b, 4 rows, window 0
        n_tok = int(lens.sum())               # every visible K/V row
        ms = timed(torch, lambda: P.paged_decode(q, kp, vp, tables, lens))
        plain_ms = timed(torch, lambda: P.paged_decode_plain(
            q, kp, vp, tables, lens), iters=5)
        dev = device_ms(torch, lambda: P.paged_decode(q, kp, vp, tables,
                                                      lens),
                        "paged_decode_kernel")
        nbytes = (2 * B * H * dh * 2 + B * nb * 4 + B * 4
                  + n_tok * K * dh * 2 * 2)
        bms, by = bound(nbytes, 4 * H * dh * n_tok)
        recs["paged_decode"] = {
            "name": "paged_decode", "route": "cuda",
            "source": "src/repro_torch/csrc/paged_attention.cu",
            "replaces": "src/repro/kernels/paged_attention/kernel.py:77",
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
            "bound_by": by, "library_ms": None, "device_ms": dev,
            "library_note": "no single PyTorch call reads through a "
                            "block table",
            "shape": f"B={B} H={H} K={K} dh={dh} block={block} "
                     f"lens={lens.tolist()}"}
        log(f"  paged decode time {ms:.4f} ms (device {dev} ms)  plain "
            f"{plain_ms:.4f} ms  bound {bms:.4f} ms ({by})")
        ams = timed(torch, lambda: P.paged_append(kp, vp, k_new, v_new,
                                                  ablk, aoff))
        aplain = timed(torch, lambda: P.paged_append_plain(
            kp2, vp2, k_new, v_new, ablk, aoff))
        adev = device_ms(torch, lambda: P.paged_append(
            kp, vp, k_new, v_new, ablk, aoff), "paged_append_kernel")
        n_rows = int(((ablk >= 0) & (ablk < nblocks)).sum())
        abms, aby = bound(2 * 2 * n_rows * K * dh * 2 + 2 * B * 4, 0.0)
        recs["paged_append"] = {
            "name": "paged_append", "route": "cuda",
            "source": "src/repro_torch/csrc/paged_attention.cu",
            "replaces": "src/repro/kernels/paged_attention/ops.py:52",
            "ms": ams, "plain_ms": aplain, "bound_ms": abms,
            "bound_by": aby, "library_ms": None, "device_ms": adev,
            "library_note": "index_put_ cannot skip the drop sentinel",
            "shape": f"B={B} K={K} dh={dh} one sentinel row"}
        log(f"  paged append time {ams:.4f} ms (device {adev} ms)  plain "
            f"{aplain:.4f} ms  "
            f"bound {abms:.6f} ms ({aby})")
    for name, rec in recs.items():
        rec["max_abs_err"] = max(errs[name])
    return [recs["paged_decode"], recs["paged_append"]]


# ---------------------------------------------------------------------------
# phase 3: the model through the kernels on the card vs plain on the CPU
# ---------------------------------------------------------------------------
def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def reference_phase(torch, np):
    from repro_torch.configs import get_config
    from repro_torch.models import lm

    cfg = get_config("micro")
    cpu_params = lm.init_params(cfg, seed=1, device="cpu")
    prompt = np.random.RandomState(1).randint(1, cfg.vocab, size=(2, 40))
    blk, nb, n = 16, 3, prompt.shape[1]
    outs = {}
    for dev in ("cpu", "cuda"):
        params = _to(cpu_params, dev)
        last, cache = lm.prefill(
            params, {"tokens": torch.as_tensor(prompt, device=dev)}, cfg)
        # row b's KV in pool blocks 3b .. 3b+2
        shape = (cfg.n_layers, 2 * nb, blk, cfg.n_kv_heads, cfg.head_dim)
        kp = torch.zeros(shape, dtype=torch.bfloat16, device=dev)
        vp = torch.zeros_like(kp)
        t = torch.arange(n, device=dev)
        for b in range(2):
            kp[:, b * nb + t // blk, t % blk] = cache["k"][:, b]
            vp[:, b * nb + t // blk, t % blk] = cache["v"][:, b]
        tables = torch.arange(2 * nb, dtype=torch.int32,
                              device=dev).reshape(2, nb)
        logits = [last[:, 0]]
        tok = torch.as_tensor(prompt[:, -1:], device=dev)
        for p in range(n, n + 4):
            pos = torch.full((2,), p, dtype=torch.int32, device=dev)
            ablk = tables[:, p // blk].contiguous()
            aoff = torch.full((2,), p % blk, dtype=torch.int32, device=dev)
            lg, kp, vp = lm.decode_step_paged(params, tok, kp, vp, tables,
                                              pos, ablk, aoff, cfg)
            logits.append(lg[:, 0])
            tok = torch.as_tensor(prompt[:, :1], device=dev)
        outs[dev] = torch.stack(logits).float().cpu()
    return check("micro prefill + 4 paged decode steps, logits "
                 "(card kernels vs CPU plain versions)",
                 max_err(outs["cuda"], outs["cpu"]))


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------
def main_path(torch, np, card: str):
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as F
    from repro_torch.kernels.paged_attention import ops as P
    from repro_torch.models import lm
    from repro_torch.serving.server import AgentRequest, MultiWorkerServer

    wrappers = {"flash_prefill": F.flash_prefill,
                "paged_decode": P.paged_decode,
                "paged_append": P.paged_append}
    cfg = get_config("llama3.2-3b")
    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed=0, device="cuda")
    srv = MultiWorkerServer(cfg, params, n_workers=2, n_slots=4,
                            max_len=2048, pool_blocks=1024)
    torch.cuda.synchronize()
    log(f"  llama3.2-3b params + 2 engines ready in "
        f"{time.perf_counter() - t0:.1f} s")

    # SWE-bench-shaped agent tasks, scaled down: a 512-1024 token first
    # prompt, then 64-256 tokens of tool observation; 32 decoded per step
    rng = np.random.RandomState(0)
    tools = ["code_execution", "web_api", "file_operations"]
    reqs, n_decode = [], 32
    for i in range(4):
        steps = []
        for s in range(3):
            n = rng.randint(512, 1025) if s == 0 else rng.randint(64, 257)
            steps.append((list(map(int, rng.randint(1, cfg.vocab, size=n))),
                          n_decode, tools[s % 3],
                          float(rng.uniform(0.1, 1.5))))
        reqs.append(AgentRequest(f"task-{i}", f"t{i % 2}", steps))

    for w in wrappers.values():
        w.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    outs = [srv.run_task(r) for r in reqs]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: w.launches for name, w in wrappers.items()}

    st = srv.stats()
    log(f"  stats: prefill_tokens={st['prefill_tokens']} "
        f"regen_tokens={st['regen_tokens']} "
        f"decode_steps={st['decode_steps']} "
        f"coordinator_hits={st['coordinator_hits']} "
        f"park_copy_bytes={st['park_copy_bytes']} "
        f"(== 0: {st['park_copy_bytes'] == 0})")
    log(f"  launches: {launches}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"main path never launched {name}")
    if st["park_copy_bytes"] != 0:
        raise AssertionError("paged park copied device bytes")
    srv.runtime.check_conservation()
    for w, eng in enumerate(srv.engines):
        errs = eng.pool.audit_blocks()
        if errs:
            raise AssertionError(f"engine {w} block audit: {errs}")
    decoded = 0
    for req, out in zip(reqs, outs):
        ctx = np.asarray(srv.runtime.sessions[req.session_id].ctx)
        want = sum(len(s[0]) + s[1] for s in req.steps)
        if len(ctx) != want or out["ctx_tokens"] != want:
            raise AssertionError(f"{req.session_id}: context {len(ctx)} "
                                 f"tokens, expected {want}")
        if ctx.min() < 0 or ctx.max() >= cfg.vocab:
            raise AssertionError(f"{req.session_id}: token id out of range")
        decoded += sum(s[1] for s in req.steps)
    log("  conservation and block audit clean; every context has the "
        "expected length with in-range token ids")
    peak = torch.cuda.max_memory_allocated()
    log(f"  main path [{card}]: wall {wall:.3f} s for 4 tasks x 3 steps, "
        f"{decoded} decoded tokens = {decoded / wall:.2f} decoded tokens "
        f"per wall second (prefill included); max_memory_allocated "
        f"{peak / 2**30:.2f} GiB")
    profile_window(torch, np, srv, cfg, card)
    return launches


def profile_window(torch, np, srv, cfg, card: str):
    """Where the time goes: one more task (a 512-token prompt, 16 decoded
    tokens) under the profiler; device busy share and the top ops."""
    from repro_torch.serving.server import AgentRequest
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.RandomState(1)
    req = AgentRequest("profiled", "t0", [(
        list(map(int, rng.randint(1, cfg.vocab, size=512))), 16,
        "code_execution", 0.5)])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        srv.run_task(req)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    evts = prof.key_averages()
    busy = sum(_dev_us(e) for e in evts) / 1e6
    log(f"  profiled task [{card}]: wall {wall:.3f} s, device busy "
        f"{busy:.3f} s = {100 * busy / wall:.1f}% (idle "
        f"{100 * (1 - busy / wall):.1f}%)")
    for e in sorted(evts, key=_dev_us, reverse=True)[:12]:
        log(f"    device {_dev_us(e) / 1e3:9.3f} ms  calls {e.count:6d}  "
            f"{e.key[:90]}")
    host = [e for e in evts if not _dev_us(e)]
    for e in sorted(host, key=lambda e: e.self_cpu_time_total,
                    reverse=True)[:8]:
        log(f"    host {e.self_cpu_time_total / 1e3:9.3f} ms  calls "
            f"{e.count:6d}  {e.key[:90]}")
    srv.runtime.check_conservation()


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: torch.cuda.is_available() is false; this smoke "
            "runs only on a CUDA card")
        return 1
    from repro_torch.kernels import build

    # float32 products in full float32 (PyTorch's default, stated here)
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(card)
    log(f"phase 1: card {card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda} python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    logs = build.build_all()
    log(f"  built {sorted(logs) or 'nothing (up to date)'} in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, text in sorted(logs.items()):
        for line in text.splitlines():
            if "Used" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    log(f"phase 2: kernels vs plain versions on the card [{card}]")
    kernels = [flash_phase(torch, gen), *paged_phase(torch, gen)]
    log("phase 3: reference check on a small input")
    reference_phase(torch, np)
    log("phase 4: main path")
    launches = main_path(torch, np, card)
    for rec in kernels:
        rec["launches"] = launches[rec["name"]]
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
