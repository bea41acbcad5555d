#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
card, built for an H100:

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit code:

1. The card: ``nvidia-smi`` name and power limit.  Build the kernels from
   ``src/repro_torch/csrc/*.cu`` with nvcc (one process per source, all
   at once) into ``build/kernels/``; print ptxas's registers and spills,
   and the kernels' shared memory and CTAs an SM (``mamba_scan`` must use
   no local memory: no spill).
2. Every kernel against its plain PyTorch version on the card: flash
   prefill at llama3.2-3b width (S=1024, H=24, K=8, D=128; causal, and
   causal + window 32), at jamba's attention slot (B=2, H=32) and at
   micro width (D=16, and a ragged S); paged append + decode at B=4,
   H=24, K=8, dh=128, block 16, lens up to 2048 with a drop-sentinel row
   (window 0 and 32), and at dh=16; paged decode also at the served
   path's real shape (one live row of 1056 tokens, three idle rows), at
   jamba's contiguous cache (one block of 1058 tokens a row) and at the
   gather engine's llama3.2-3b cache (one block of 2048 tokens a row)
   (bf16, 2e-2);
   wkv6 at rwkv6-7b's prefill (B=4, T=1024, H=64, dh=64) and decode (T=1,
   a state in) shapes and at head size 16; mamba_scan at jamba's prefill
   (B=2, T=1024, di=8192, ds=16, h.C rounded to bf16) and decode (T=1, a
   state in) shapes and at di=128, ds=8 in both modes (outputs and final
   states, 1e-3 relative; the rounding mode's outputs equal past an f32
   slack at the scale of the sum h.C but on at most 1 % of elements, each
   at most one bf16 step of h.C off: ``mamba_scan.ops.rounding_errs``).
   Each kernel is timed with CUDA events beside its plain version, its
   bound and, for flash, ``scaled_dot_product_attention`` (a yardstick
   the port never calls); flash and paged decode also at the further
   shapes, wkv6 and mamba_scan also at their decode shapes (T=1, a state
   in), whose times go into the JSON line's ``more_shapes``;
   ``mamba_scan``'s record also gives its lanes a channel (``lanes``) and
   the special-function units' floor (``sfu_floor_ms``).  The profiler's
   device time counts every kernel a wrapper launches, and fails if
   another kernel runs in the window.
3. Reference checks on small inputs: micro's prefill and paged-decode
   logits, and rwkv6-tiny's and jamba-tiny's prefill + 4 ``decode_step``s,
   through the kernels on the card against the plain versions on the CPU.
4. The serving path: llama3.2-3b at full width and depth with random
   bf16 weights made on the card from a seed, served by
   ``MultiWorkerServer`` (2 workers, 4 slots, max_len 2048, block 16,
   1024 pool blocks) for 4 agent tasks of 3 steps.  The kernels' launch
   counts are zeroed just before and read just after; each of its
   kernels must be > 0, and conservation and the block audit must be
   clean.  Then one more task under the profiler.
4b. Gather at full width: the same 4 tasks on the same params through
   ``ServingRuntime(..., paged=False)`` (phase 4's sizes), driven as
   ``run_task`` drives them: ``summarize()``, and ``stats()`` but for the
   copy-byte counters, equal phase 4's; gather's park and resume bytes
   are > 0 where paged's are 0; paged_decode and paged_append launch;
   conservation and the block audit are clean.  Then one session alone
   through a paged and a gather engine (a 1024-token prompt, a park, a
   resume with a 128-token delta, 16 decoded tokens): the ids must be
   identical, or part only at a near-tie (the gather run's top-2 logit
   gap below the two paths' logit difference at that step).
4c. ``benchmarks/serve_bench_torch.py``'s three fingerprints on the card
   (plain, under ``SAGA_SANITIZE=1`` and under ``SAGA_TRACE=1``), each
   equal to its committed ``benchmarks/expected/`` file, and its
   paged-vs-gather leg.
4d. ``benchmarks/soak_bench_torch.py``'s soak at its smoke size (200
   sessions through the client, the asyncio driver and a live HTTP proxy
   on localhost) with its four end checks.
   Each of 4b-4d counts its kernels' launches apart (each > 0) and prints
   its wall time.
5. Path A: rwkv6-7b at full width and depth (B=4 prompts of 1024 tokens)
   through ``lm.prefill`` then 32 greedy ``lm.decode_step``s carrying the
   state cache: exactly 32 x 33 wkv6 launches and no other.
6. Path B: jamba-v0.1-52b at full width, depth cut to one superblock (8
   layers), B=2: exactly 7 x 33 mamba_scan, 1 flash_prefill and 32 each
   of paged_append and paged_decode launches.
   Each path then runs ``lm.forward_logits`` on the prompt and on the
   1056-token sequences and ``lm.prefill`` on the sequences (launches
   counted apart).  It holds the prefill's logits to the forward within
   2e-2 of the largest logit, the last decode step's within a fixed limit
   per path (TOL_DECODE), and the carried states (the first layer of
   each cache entry) to the sequence's prefill within TOL_STATE.  The
   same step with a fault planted in its inputs (a lost state write, a
   dropped token-shift or conv state, a position off by one, a zero
   cache) must fail one of the two.  Both paths run before a failed
   check ends the script.

The second-to-last line is the kernels' JSON record; the last is
``{"ok": true, "device": {...}}``.  Nothing falls back to the CPU: without
CUDA the script exits non-zero before any result.
"""
from __future__ import annotations

import ctypes
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
sys.path.insert(0, str(Path(__file__).resolve().parent))    # benchmarks/

TOL_BF16 = 2e-2             # tests/test_kernels.py TOL[bfloat16]
TOL_SCAN = 1e-3             # tests/test_kernels.py's wkv6 tolerance
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
BF16_FLOPS = 989e12         # dense bf16 tensor-core peak
F32_FLOPS = 67e12           # f32 outside the tensor cores (the scans' type)


def log(*a):
    print(*a, flush=True)


def bound(nbytes: float, flops: float, peak: float = BF16_FLOPS):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak of their type (bf16 tensor cores unless
    given)."""
    tb, tf = nbytes / HBM_BYTES_PER_S, flops / peak
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
    time (the event timing above then stands alone).  Any other kernel in
    the window fails the run: a filter that missed a kernel the wrapper
    launches would flatter the time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    evts = [e for e in prof.key_averages() if _dev_us(e)]
    other = sorted({e.key for e in evts if kernel not in e.key})
    if other:
        raise AssertionError(f"{kernel}: the timed window also ran {other}")
    us = sum(_dev_us(e) for e in evts if kernel in e.key)
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


def rel_err(x, ref) -> float:
    """Max abs error over the reference's largest magnitude (at least 1):
    the recurrences' states and outputs grow past 1 with the sequence."""
    return max_err(x, ref) / max(1.0, float(ref.float().abs().max()))


def check(name: str, err: float, tol: float = TOL_BF16) -> float:
    log(f"  {name}: max_abs_err {err:.3e} (tol {tol:g})")
    if not err < tol:
        raise AssertionError(f"{name}: max abs error {err} >= {tol}")
    return err


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------
def flash_phase(torch, gen, gen_more):
    """Flash prefill against its plain version at llama3.2-3b's prefill
    (causal, and causal + window 32), jamba's attention slot and micro's
    head size (D=16, and a ragged S); timed at llama3.2-3b's and jamba's
    shapes beside ``scaled_dot_product_attention``.  Jamba's inputs come
    from ``gen_more``, so the later-added shapes leave the draws of the
    earlier checks as they were."""
    from repro_torch.kernels.flash_attention import ops as F

    def inputs(g, B, S, H, K, D):
        mk = lambda *s: torch.randn(s, generator=g, device="cuda",  # noqa
                                    dtype=torch.float32).to(torch.bfloat16)
        return mk(B, S, H, D), mk(B, S, K, D), mk(B, S, K, D)

    errs, times = [], []
    for (B, S, H, K, D), window, g in [
            ((1, 1024, 24, 8, 128), 0, gen),       # llama3.2-3b: main path
            ((1, 1024, 24, 8, 128), 32, gen),
            ((2, 1024, 32, 8, 128), 0, gen_more),  # jamba's attention slot
            ((1, 256, 4, 2, 16), 0, gen),
            ((2, 200, 4, 2, 16), 32, gen)]:
        timed_here = window == 0 and D == 128
        q, k, v = inputs(g, B, S, H, K, D)
        out = F.flash_prefill(q, k, v, causal=True, window=window)
        torch.cuda.synchronize()
        ref = F.flash_prefill_plain(q, k, v, causal=True, window=window)
        errs.append(check(f"flash B={B} S={S} H={H} K={K} D={D} "
                          f"window={window}", max_err(out, ref)))
        if not timed_here:
            continue
        ms = timed(torch, lambda: F.flash_prefill(q, k, v, causal=True))
        plain_ms = timed(torch, lambda: F.flash_prefill_plain(
            q, k, v, causal=True), iters=5)
        lib_ms = timed(torch, lambda: torch.nn.functional
                       .scaled_dot_product_attention(
                           q.transpose(1, 2), k.transpose(1, 2),
                           v.transpose(1, 2), is_causal=True,
                           enable_gqa=True))
        dev = device_ms(torch, lambda: F.flash_prefill(q, k, v, causal=True),
                        "flash_prefill_kernel")
        pairs = B * H * S * (S + 1) // 2
        nbytes = 2 * (2 * B * S * H * D + 2 * B * S * K * D)
        bms, by = bound(nbytes, 4 * D * pairs)
        times.append({"shape": f"B={B} S={S} H={H} K={K} D={D} causal",
                      "ms": ms, "device_ms": dev, "plain_ms": plain_ms,
                      "library_ms": lib_ms, "bound_ms": bms, "bound_by": by})
        log(f"  flash time {ms:.4f} ms (device {dev} ms)  plain "
            f"{plain_ms:.4f} ms  sdpa {lib_ms:.4f} ms  bound {bms:.4f} "
            f"ms ({by})")
    main, *more = times
    return {"name": "flash_prefill", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:73",
            **main, "more_shapes": more, "max_abs_err": max(errs)}


def paged_phase(torch, gen, gen_more):
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
    recs["paged_decode"]["more_shapes"] = paged_more_shapes(
        torch, gen_more, errs["paged_decode"])
    for name, rec in recs.items():
        rec["max_abs_err"] = max(errs[name])
    return [recs["paged_decode"], recs["paged_append"]]


def paged_more_shapes(torch, gen, errs):
    """paged_decode at the served path's real shape (B=4: one live row of
    1056 tokens, three idle rows of len 1 on table rows of zeros, nb=128),
    at jamba's contiguous cache (B=2, one block of 1058 tokens a row,
    nb=1, lens 1056 and 1025) and at the gather engine's llama3.2-3b cache
    (B=4, one block of 2048 tokens a row, a full row, an idle one):
    checked, timed, each beside its bound."""
    from repro_torch.kernels.paged_attention import ops as P

    mk = lambda *s: torch.randn(s, generator=gen, device="cuda",  # noqa
                                dtype=torch.float32).to(torch.bfloat16)
    out_recs = []
    for label, B, H, K, dh, block, nb, lens in [
            ("served", 4, 24, 8, 128, 16, 128, [1056, 1, 1, 1]),
            ("jamba contiguous", 2, 32, 8, 128, 1058, 1, [1056, 1025]),
            ("gather llama3.2-3b contiguous", 4, 24, 8, 128, 2048, 1,
             [2048, 1056, 1, 300])]:
        nblocks = B * nb + 1
        q, kp, vp = mk(B, H, dh), mk(nblocks, block, K, dh), \
            mk(nblocks, block, K, dh)
        tables = torch.zeros(B, nb, dtype=torch.int32, device="cuda")
        tables[0] = torch.arange(1, nb + 1, dtype=torch.int32,
                                 device="cuda")
        if nb == 1:                    # the contiguous cache: block b
            tables[:, 0] = torch.arange(B, dtype=torch.int32, device="cuda")
        lens_t = torch.tensor(lens, dtype=torch.int32, device="cuda")
        out = P.paged_decode(q, kp, vp, tables, lens_t)
        torch.cuda.synchronize()
        ref = P.paged_decode_plain(q, kp, vp, tables, lens_t)
        errs.append(check(f"paged decode {label} B={B} H={H} K={K} "
                          f"block={block} nb={nb} lens={lens}",
                          max_err(out, ref)))
        ms = timed(torch, lambda: P.paged_decode(q, kp, vp, tables, lens_t))
        dev = device_ms(torch, lambda: P.paged_decode(q, kp, vp, tables,
                                                      lens_t),
                        "paged_decode_kernel")
        plain_ms = timed(torch, lambda: P.paged_decode_plain(
            q, kp, vp, tables, lens_t), iters=5, warmup=1)
        n_tok = sum(lens)
        bms, by = bound(2 * B * H * dh * 2 + B * nb * 4 + B * 4
                        + n_tok * K * dh * 2 * 2, 4 * H * dh * n_tok)
        span, splits = P.split_schedule(
            nb, block, B * K,
            torch.cuda.get_device_properties(0).multi_processor_count)
        out_recs.append({
            "shape": f"{label}: B={B} H={H} K={K} dh={dh} block={block} "
                     f"nb={nb} lens={lens}",
            "ms": ms, "device_ms": dev, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "span": span,
            "splits": splits})
        log(f"  paged decode {label} time {ms:.4f} ms (device {dev} ms)  "
            f"plain {plain_ms:.4f} ms  bound {bms:.5f} ms ({by}); span "
            f"{span}, {splits} splits")
    return out_recs


def wkv6_phase(torch, gen):
    """wkv6 at rwkv6-7b's prefill (B=4, T=1024, H=64, dh=64, zero state)
    and decode (T=1, a state in) shapes, and at rwkv6-tiny's head size 16;
    outputs and final states within TOL_SCAN of the plain scan, relative
    to their largest magnitude (both are f32; the sums run in another
    order)."""
    from repro_torch.kernels.rwkv6 import ops as R

    def inputs(B, T, H, dh, state):
        mk = lambda *s: torch.randn(s, generator=gen, device="cuda")  # noqa
        r, k, v = ((mk(B, T, H, dh) * 0.5).to(torch.bfloat16)
                   for _ in range(3))
        # the model's decay exp(-exp(dec)), dec over its init range -5..3
        dec = -5 + 8 * torch.rand(B, T, H, dh, generator=gen, device="cuda")
        w = torch.exp(-torch.exp(dec))
        u = mk(H, dh) * 0.3
        return r, k, v, w, u, (mk(B, H, dh, dh) if state else None)

    def nbytes(B, T, H, dh, state):
        """r, k, v, w and o once, u, and the state out (and in)."""
        return (B * T * H * dh * (3 * 2 + 4 + 4) + H * dh * 4
                + (1 + state) * B * H * dh * dh * 4)

    errs, rec, decode = [], None, None
    for B, T, H, dh, state in [(4, 1024, 64, 64, False), (4, 1, 64, 64, True),
                               (2, 37, 4, 16, True), (2, 1, 4, 16, True)]:
        args = inputs(B, T, H, dh, state)
        if (B, T, H, dh) == (4, 1, 64, 64):
            decode = (B, T, H, dh, state), args
        out, s_T = R.wkv6(*args)
        torch.cuda.synchronize()
        ref, ref_T = R.wkv6_plain(*args)
        errs.append(check(f"wkv6 B={B} T={T} H={H} dh={dh} "
                          f"state_in={state} (out, S_T)",
                          max(rel_err(out, ref), rel_err(s_T, ref_T)),
                          tol=TOL_SCAN))
        if rec is None:        # rwkv6-7b's prefill shape
            ms = timed(torch, lambda: R.wkv6(*args))
            plain_ms = timed(torch, lambda: R.wkv6_plain(*args), iters=2,
                             warmup=1)
            dev = device_ms(torch, lambda: R.wkv6(*args), "wkv6_kernel")
            n = B * T * H * dh
            # per (b, t, h): w*S + k v^T (a multiply and an FMA) and r.S
            # (an FMA) on dh^2 state elements, 5 flops each; the u term
            # v_j * sum_i r_i u_i k_i and its add, 5 per head lane
            bms, by = bound(nbytes(B, T, H, dh, state), n * (5 * dh + 5),
                            F32_FLOPS)
            rec = {"name": "wkv6", "route": "cuda",
                   "source": "src/repro_torch/csrc/wkv6.cu",
                   "replaces": "src/repro/kernels/rwkv6/kernel.py:47",
                   "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                   "bound_by": by, "library_ms": None, "device_ms": dev,
                   "library_note": "no PyTorch call computes the WKV6 "
                                   "recurrence",
                   "shape": f"B={B} T={T} H={H} dh={dh} zero state"}
            log(f"  wkv6 time {ms:.4f} ms (device {dev} ms)  plain "
                f"{plain_ms:.4f} ms  bound {bms:.4f} ms ({by})")
    (B, T, H, dh, state), args = decode       # rwkv6-7b's decode step
    rec["more_shapes"] = [decode_time(
        torch, lambda: R.wkv6(*args), lambda: R.wkv6_plain(*args),
        "wkv6_kernel",
        f"B={B} T={T} H={H} dh={dh} state in",
        nbytes(B, T, H, dh, state), B * T * H * dh * (5 * dh + 5))]
    rec["max_abs_err"] = max(errs)
    return rec


def decode_time(torch, fn, plain, kernel, shape, nbytes, flops):
    """A scan at its decode shape (inputs already drawn): CUDA events,
    the profiler's device time, the plain version's time and the bound."""
    ms = timed(torch, fn)
    dev = device_ms(torch, fn, kernel)
    plain_ms = timed(torch, plain, iters=5, warmup=1)
    bms, by = bound(nbytes, flops, F32_FLOPS)
    log(f"  {kernel} at {shape}: time {ms:.4f} ms (device {dev} ms)  plain "
        f"{plain_ms:.4f} ms  bound {bms:.5f} ms ({by})")
    return {"shape": shape, "ms": ms, "device_ms": dev,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by}


def sfu_floor_ms(torch, n_exp: float) -> float:
    """The least time the card's special-function units take for n_exp
    exponentials: 16 a clock an SM at the card's largest SM clock."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return n_exp / (16 * sms * mhz * 1e6) * 1e3


def mamba_phase(torch, gen):
    """mamba_scan at jamba's prefill (B=2, T=1024, di=8192, ds=16, zero
    state, h.C rounded to bf16) and decode (T=1, a state in, unrounded)
    shapes, and at jamba-tiny's (di=128, ds=8) in both modes, with B and C
    strided slices of one projection as mamba_layer passes them.  Outputs
    and final states within TOL_SCAN of their largest magnitude; the
    rounding mode's outputs by ``M.rounding_errs``; the decode shape is
    timed too."""
    from repro_torch.kernels.mamba_scan import ops as M

    def inputs(B, T, di, ds, dtr, state):
        mk = lambda *s: torch.randn(s, generator=gen, device="cuda")  # noqa
        x = mk(B, T, di).to(torch.bfloat16)
        dt = torch.nn.functional.softplus(mk(B, T, di) - 3).to(torch.bfloat16)
        dbc = mk(B, T, dtr + 2 * ds).to(torch.bfloat16)
        A = -torch.arange(1, ds + 1, dtype=torch.float32, device="cuda"
                          ).expand(di, ds).contiguous()
        D = torch.ones(di, device="cuda")
        return (x, dt, dbc[..., dtr:dtr + ds], dbc[..., dtr + ds:], A, D,
                mk(B, di, ds) * 0.5 if state else None)

    def nbytes(B, T, di, ds, state):
        """x, dt, B, C and y once, A and D, the state out (and in)."""
        return (B * T * di * (2 + 2 + 4) + 2 * B * T * ds * 2 + di * ds * 4
                + di * 4 + (1 + state) * B * di * ds * 4)

    errs, rec, decode = [], None, None
    for B, T, di, ds, dtr, state, rnd in [
            (2, 1024, 8192, 16, 256, False, True),
            (2, 1, 8192, 16, 256, True, False),
            (2, 45, 128, 8, 4, False, True), (2, 45, 128, 8, 4, True, False),
            (2, 1, 128, 8, 4, True, False)]:
        args = inputs(B, T, di, ds, dtr, state)
        if (B, T, di) == (2, 1, 8192):
            decode = (B, T, di, ds, state), args
        y, h_T = M.mamba_scan(*args, round_y=rnd)
        torch.cuda.synchronize()
        ref, ref_T = M.mamba_scan_plain(*args, round_y=rnd)
        name = (f"mamba_scan B={B} T={T} di={di} ds={ds} state_in={state} "
                f"round_y={rnd}")
        if rnd:
            steps, share = M.rounding_errs(y, ref, *args)
            check(name + " (y: largest difference past the f32 slack, in "
                  "bf16 steps of h.C)", steps, tol=M.ROUND_STEPS)
            check(name + " (y: share of elements off the plain version)",
                  share, tol=M.ROUND_SHARE)
            errs.append(rel_err(y, ref))
        else:
            errs.append(check(name + " (y)", rel_err(y, ref), tol=TOL_SCAN))
        errs.append(check(name + " (h_T)", rel_err(h_T, ref_T),
                          tol=TOL_SCAN))
        if rec is None:        # jamba's prefill shape
            ms = timed(torch, lambda: M.mamba_scan(*args, round_y=True))
            plain_ms = timed(torch, lambda: M.mamba_scan_plain(
                *args, round_y=True), iters=2, warmup=1)
            dev = device_ms(torch, lambda: M.mamba_scan(*args, round_y=True),
                            "mamba_scan_kernel")
            bms, by = bound(nbytes(B, T, di, ds, state),
                            B * T * di * (7 * ds + 3), F32_FLOPS)
            rec = {"name": "mamba_scan", "route": "cuda",
                   "source": "src/repro_torch/csrc/mamba_scan.cu",
                   "replaces": "src/repro/kernels/mamba_scan/kernel.py:45",
                   "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                   "bound_by": by, "library_ms": None, "device_ms": dev,
                   "sfu_floor_ms": sfu_floor_ms(torch, B * T * di * ds),
                   "lanes": M.kernel_config(ds)[0],
                   "library_note": "no PyTorch call computes the selective "
                                   "scan",
                   "shape": f"B={B} T={T} di={di} ds={ds} zero state, "
                            f"round_y"}
            log(f"  mamba_scan time {ms:.4f} ms (device {dev} ms)  plain "
                f"{plain_ms:.4f} ms  bound {bms:.4f} ms ({by})")
    (B, T, di, ds, state), args = decode      # jamba's decode step
    rec["more_shapes"] = [decode_time(
        torch, lambda: M.mamba_scan(*args), lambda: M.mamba_scan_plain(*args),
        "mamba_scan_kernel",
        f"B={B} T={T} di={di} ds={ds} state in",
        nbytes(B, T, di, ds, state), B * T * di * (7 * ds + 3))]
    rec["more_shapes"][0]["sfu_floor_ms"] = sfu_floor_ms(torch, B * di * ds)
    rec["max_abs_err"] = max(errs)
    return rec


class SameRouting:
    """Holds one run of jamba's MoE to the expert picks another run made.

    Two runs of the same tokens (the card and the CPU, or prefill + decode
    and the full forward) round the residual stream differently, and on a
    near-tie of the top-2 pick one other expert moves that row's logits
    far past any rounding tolerance.  ``record`` stores each router call's
    probabilities and picks; ``replay`` makes the router return recorded
    picks in call order, weighted by its own probabilities.  Each token
    where it would have picked otherwise is counted and must be a near-tie
    of the recording (its k-th vs (k+1)-th gap below 4x the two runs'
    probability difference)."""

    def __init__(self, torch, layers):
        self.torch, self.L = torch, layers
        self.router = layers.moe_router
        self.calls, self.flips, self.gaps = [], 0, []

    def record(self):
        def rec(x2d, w, k):
            p, e = self.router(x2d, w, k)
            self.calls.append((self.torch.softmax((x2d @ w).float(), -1), e))
            return p, e
        self.L.moe_router = rec

    def replay(self, calls):
        queue = list(calls)

        def rep(x2d, w, k):
            probs_r, ids_r = (t.to(x2d.device) for t in queue.pop(0))
            _, own = self.router(x2d, w, k)
            probs = self.torch.softmax((x2d @ w).float(), -1)
            flip = (own.sort(-1).values != ids_r.sort(-1).values).any(-1)
            if bool(flip.any()):
                srt = probs_r[flip].sort(-1, descending=True).values
                gap = srt[:, k - 1] - srt[:, k]
                diff = (probs[flip] - probs_r[flip]).abs().amax(-1)
                if not bool((gap < 4 * diff).all()):
                    raise AssertionError(f"router pick differs away from a "
                                         f"near-tie: gap {gap.tolist()} vs "
                                         f"difference {diff.tolist()}")
                self.flips += int(flip.sum())
                self.gaps += gap.tolist()
            top_p = probs.gather(1, ids_r)
            return top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9), ids_r
        self.L.moe_router = rep

    def by_position(self, B, S, n_dec):
        """The picks recorded over a prefill of S tokens then n_dec decode
        steps, per MoE layer as (probs (B, S + n_dec, E), ids (B, S +
        n_dec, k)) in position order."""
        n = len(self.calls) // (1 + n_dec)
        out = []
        for layer in range(n):
            steps = [self.calls[layer]] + [self.calls[n * (1 + j) + layer]
                                           for j in range(n_dec)]
            out.append(tuple(
                self.torch.cat([c[i].reshape(B, -1, c[i].shape[-1])
                                for c in steps], 1) for i in (0, 1)))
        return out

    def restore(self):
        self.L.moe_router = self.router


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


def ssm_reference_phase(torch, np):
    """rwkv6-tiny and jamba-tiny: prefill (S=40) + 4 decode_steps through
    the kernels on the card against the plain versions on the CPU, from
    the same seed weights; jamba's card run is held to the CPU run's MoE
    picks (SameRouting)."""
    from repro_torch.configs import jamba_v0_1_52b, rwkv6_7b
    from repro_torch.models import layers as L
    from repro_torch.models import lm

    for cfg in (rwkv6_7b.tiny(), jamba_v0_1_52b.tiny()):
        cpu_params = lm.init_params(cfg, seed=1, device="cpu")
        prompt = np.random.RandomState(1).randint(1, cfg.vocab, size=(2, 40))
        routing = SameRouting(torch, L) if cfg.attn_period else None
        outs = {}
        for dev in ("cpu", "cuda"):
            if routing:
                (routing.record() if dev == "cpu"
                 else routing.replay(routing.calls))
            params = _to(cpu_params, dev)
            last, cache = lm.prefill(
                params, {"tokens": torch.as_tensor(prompt, device=dev)}, cfg,
                max_len=48)
            logits = [last[:, 0]]
            tok = torch.as_tensor(prompt[:, -1:], device=dev)
            for p in range(40, 44):
                lg, cache = lm.decode_step(params, tok, cache, p, cfg)
                logits.append(lg[:, 0])
                tok = torch.as_tensor(prompt[:, :1], device=dev)
            outs[dev] = torch.stack(logits).float().cpu()
        if routing:
            routing.restore()
            log(f"  {cfg.name}: {routing.flips} router near-tie flips "
                f"held to the CPU picks")
        check(f"{cfg.name} prefill + 4 decode steps, logits (card kernels "
              f"vs CPU plain versions)", max_err(outs["cuda"], outs["cpu"]))


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------
def served_tasks(np, cfg, AgentRequest):
    """SWE-bench-shaped agent tasks, scaled down: a 512-1024 token first
    prompt, then 64-256 tokens of tool observation; 32 decoded per step."""
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
    return reqs


def main_path(torch, np, card: str):
    """Phase 4, then phase 4b on the same params and tasks.  Returns the
    launches of each, by path."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.serving.server import AgentRequest

    cfg = get_config("llama3.2-3b")
    params = lm.init_params(cfg, seed=0, device="cuda")
    reqs = served_tasks(np, cfg, AgentRequest)
    launches, paged = serve_paged(torch, np, card, cfg, params, reqs)
    gc.collect()                  # the runtime and its engines hold cycles
    torch.cuda.empty_cache()
    log("phase 4b: gather at full width (llama3.2-3b, Engine(paged=False))")
    gather = gather_phase(torch, np, card, cfg, params, reqs, paged)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return {"serve llama3.2-3b": launches,
            "serve llama3.2-3b gather": gather}


def audit(engines, label: str):
    for w, eng in enumerate(engines):
        errs = eng.pool.audit_blocks()
        if errs:
            raise AssertionError(f"{label} engine {w} block audit: {errs}")


def serve_paged(torch, np, card, cfg, params, reqs):
    """Phase 4: ``reqs`` one at a time through ``MultiWorkerServer``;
    then one more task under the profiler.  Returns the counted run's
    launches and its readings (summary, stats, wall, peak memory)."""
    from repro_torch.serving.server import MultiWorkerServer

    wrappers = all_wrappers()
    t0 = time.perf_counter()
    srv = MultiWorkerServer(cfg, params, n_workers=2, n_slots=4,
                            max_len=2048, pool_blocks=1024)
    torch.cuda.synchronize()
    log(f"  llama3.2-3b: 2 paged engines ready in "
        f"{time.perf_counter() - t0:.1f} s")

    reset(wrappers)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    outs = [srv.run_task(r) for r in reqs]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts(wrappers)

    st = srv.stats()
    log(f"  stats: prefill_tokens={st['prefill_tokens']} "
        f"regen_tokens={st['regen_tokens']} "
        f"decode_steps={st['decode_steps']} "
        f"coordinator_hits={st['coordinator_hits']} "
        f"park_copy_bytes={st['park_copy_bytes']} "
        f"(== 0: {st['park_copy_bytes'] == 0})")
    log(f"  launches: {launches}")
    for name in ("flash_prefill", "paged_decode", "paged_append"):
        if launches[name] <= 0:
            raise AssertionError(f"main path never launched {name}")
    if st["park_copy_bytes"] != 0:
        raise AssertionError("paged park copied device bytes")
    srv.runtime.check_conservation()
    audit(srv.engines, "paged")
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
    paged = {"summary": srv.runtime.summarize(), "stats": st, "wall": wall,
             "peak": peak}
    profile_window(torch, np, srv, cfg, card)
    return launches, paged


COPY_BYTES = ("park_copy_bytes", "resume_copy_bytes", "migration_copy_bytes")


def gather_phase(torch, np, card, cfg, params, reqs, paged):
    """Phase 4b: ``reqs`` through ``ServingRuntime(..., paged=False)`` at
    phase 4's sizes, each submitted and run to its end as
    ``MultiWorkerServer.run_task`` does, held to phase 4's ``paged``
    readings; then ``gather_identity``.  Returns the run's launches."""
    from repro_torch.serving.runtime import ServingRuntime

    wrappers = all_wrappers()
    t_phase = time.perf_counter()
    rt = ServingRuntime(cfg, params, n_workers=2, n_slots=4, max_len=2048,
                        pool_blocks=1024, paged=False)
    reset(wrappers)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for req in reqs:
        handle = rt.submit(req, arrival=rt.ev.now)
        rt.run()
        if not handle.done:
            raise AssertionError(f"gather: task {req.session_id} did not "
                                 f"finish")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts(wrappers)
    peak = torch.cuda.max_memory_allocated()
    st = rt.stats()
    log(f"  launches: {launches}")
    if repr(rt.summarize()) != repr(paged["summary"]):
        raise AssertionError(f"gather summary {rt.summarize()} differs from "
                             f"paged {paged['summary']}")

    def strip(d):
        return {k: v for k, v in d.items() if k not in COPY_BYTES}
    if strip(st) != strip(paged["stats"]):
        raise AssertionError(f"gather stats {st} differ from paged "
                             f"{paged['stats']} (copy bytes apart)")
    if st["park_copy_bytes"] <= 0 or st["resume_copy_bytes"] <= 0 \
            or paged["stats"]["park_copy_bytes"] \
            or paged["stats"]["resume_copy_bytes"]:
        raise AssertionError("park/resume copy bytes: gather must move "
                             "some, paged none")
    for name in ("flash_prefill", "paged_decode", "paged_append"):
        if launches[name] <= 0:
            raise AssertionError(f"gather path never launched {name}")
    rt.check_conservation()
    audit(rt.engines, "gather")
    rounds = st["decode_steps"]
    log(f"  summarize() and stats() (copy bytes apart) equal phase 4's; "
        f"park/resume copy bytes gather {st['park_copy_bytes']}/"
        f"{st['resume_copy_bytes']}, paged 0/0; conservation and block "
        f"audit clean")
    log(f"  gather vs paged [{card}]: wall over {rounds} decode rounds "
        f"(prefill and copies included) {wall / rounds * 1e3:.2f} ms vs "
        f"{paged['wall'] / rounds * 1e3:.2f} ms a round; "
        f"max_memory_allocated {peak / 2**30:.2f} GiB vs "
        f"{paged['peak'] / 2**30:.2f} GiB")
    del rt
    gc.collect()
    torch.cuda.empty_cache()
    gather_identity(torch, np, card, cfg, params)
    log(f"  phase 4b wall {time.perf_counter() - t_phase:.1f} s")
    return launches


def gather_identity(torch, np, card, cfg, params):
    """One session alone through a paged and a gather engine at phase 4's
    sizes, the twin of tests/test_paged_decode.py::_identity_roundtrip at
    full width: a 1024-token prompt, 8 decoded tokens, a park, a resume
    with a 128-token delta, 8 more.  The ids must be identical.  Where
    they part, the step's logits, recorded from each engine's own
    ``lm.decode_step`` / ``lm.decode_step_paged`` calls, must show a
    near-tie (ROADMAP.md): the gather run's top-2 logit gap below the two
    paths' logit difference."""
    from repro_torch.models import lm
    from repro_torch.serving.engine import Engine

    rng = np.random.RandomState(4)
    prompt = rng.randint(1, cfg.vocab, size=1024).astype(np.int32)
    tool = rng.randint(1, cfg.vocab, size=128).astype(np.int32)
    real = (lm.decode_step, lm.decode_step_paged)

    def recorded(fn, sink):
        def call(*args, **kw):
            out = fn(*args, **kw)
            sink.append(out[0][:, 0].float().cpu())
            return out
        return call

    runs = {}
    for mode in ("paged", "gather"):
        logits = []
        lm.decode_step, lm.decode_step_paged = (recorded(f, logits)
                                                for f in real)
        try:
            eng = Engine(cfg, params, n_slots=4, max_len=2048,
                         pool_blocks=1024, paged=mode == "paged")
            t0 = time.perf_counter()
            s = eng.start_session("x", prompt, cached_hit=False)
            first = eng.decode({s: int(prompt[-1])}, n_steps=8)[s]
            rows = [s] * 8
            if not eng.park_session("x"):
                raise AssertionError(f"{mode} engine: park failed")
            ctx = np.concatenate([prompt, np.asarray(first, np.int32), tool])
            s = eng.start_session("x", ctx, cached_hit=True)
            rest = eng.decode({s: int(ctx[-1])}, n_steps=8)[s]
            rows += [s] * 8
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            lm.decode_step, lm.decode_step_paged = real
        runs[mode] = {"ids": first + rest, "wall": wall,
                      "logits": [lg[r] for lg, r in zip(logits, rows)],
                      "copies": (eng.park_copy_bytes, eng.resume_copy_bytes)}
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    p, g = runs["paged"], runs["gather"]
    diffs = [max_err(a, b) for a, b in zip(p["logits"], g["logits"])]
    part = next((j for j, (a, b) in enumerate(zip(p["ids"], g["ids"]))
                 if a != b), None)
    upto = len(diffs) if part is None else part + 1
    log(f"  one session alone, paged vs gather engine [{card}]: 16 decoded "
        f"ids {'identical' if part is None else f'part at step {part}'}; "
        f"largest logit difference up to there {max(diffs[:upto]):.3e}; "
        f"park/resume copy bytes gather {g['copies']}, paged {p['copies']}; "
        f"wall gather {g['wall']:.3f} s, paged {p['wall']:.3f} s")
    if part is not None:
        top2 = g["logits"][part].topk(2).values
        gap = float(top2[0] - top2[1])
        log(f"  step {part}: the gather run's top-2 logit gap {gap:.3e}, "
            f"the paths' logit difference {diffs[part]:.3e}")
        if not gap < diffs[part]:
            raise AssertionError(f"paged and gather ids part at step {part} "
                                 f"away from a near-tie")
    if min(g["copies"]) <= 0 or max(p["copies"]) != 0:
        raise AssertionError(f"copy bytes: gather {g['copies']}, paged "
                             f"{p['copies']}")


def bench_phase(torch, card):
    """Phase 4c: ``benchmarks/serve_bench_torch.py``'s three fingerprints
    on the card, plain, under SAGA_SANITIZE=1 and under SAGA_TRACE=1,
    each equal to its committed ``benchmarks/expected/`` file, then its
    paged-vs-gather leg.  Returns the phase's launches."""
    import os

    from benchmarks import serve_bench_torch as sb
    from benchmarks.torch_common import check_fingerprint
    from repro_torch.configs import get_config
    from repro_torch.models import lm

    wrappers = all_wrappers()
    reset(wrappers)
    t_phase = time.perf_counter()
    for flag in (None, "SAGA_SANITIZE", "SAGA_TRACE"):
        old = os.environ.get(flag) if flag else None
        if flag:
            os.environ[flag] = "1"
        try:
            t0 = time.perf_counter()
            for name, fn in (("serve_bench", sb._fingerprint),
                             ("serve_bench_disagg", sb._disagg_fingerprint),
                             ("serve_bench_asyncio", sb._asyncio_fingerprint)):
                check_fingerprint(name, fn("cuda"))
        finally:
            if flag and old is None:
                del os.environ[flag]
            elif flag:
                os.environ[flag] = old
        log(f"  fingerprints {flag or 'plain'} [{card}]: all three equal "
            f"benchmarks/expected/ ({time.perf_counter() - t0:.1f} s)")
    cfg = get_config("micro")
    pg = sb.run_paged_gather_ab(cfg, lm.init_params(cfg, seed=0,
                                                    device="cuda"))
    torch.cuda.synchronize()
    launches = counts(wrappers)
    log(f"  paged-vs-gather leg [{card}]: summaries equal over "
        f"{pg['decode_rounds']} decode rounds; wall a round (prefill and "
        f"copies included) paged {pg['paged_us_per_round']:.0f} us, gather "
        f"{pg['gather_us_per_round']:.0f} us; park/resume copy bytes gather "
        f"{pg['gather_park_copy_bytes']}/{pg['gather_resume_copy_bytes']}, "
        f"paged 0/0")
    log(f"  launches: {launches}")
    for name in ("flash_prefill", "paged_decode", "paged_append"):
        if launches[name] <= 0:
            raise AssertionError(f"serve_bench_torch never launched {name}")
    log(f"  phase 4c wall {time.perf_counter() - t_phase:.1f} s")
    return launches


def soak_phase(torch, card):
    """Phase 4d: ``benchmarks/soak_bench_torch.py``'s soak at its smoke
    size on the card (it raises on any of its four end checks).  Returns
    the phase's launches."""
    import asyncio

    from benchmarks import soak_bench_torch as soak

    wrappers = all_wrappers()
    reset(wrappers)
    t0 = time.perf_counter()
    out = asyncio.run(soak._soak(soak.SMOKE_SESSIONS, soak.SMOKE_SPREAD_S,
                                 soak.TIME_SCALE, "least-loaded", "cuda"))
    torch.cuda.synchronize()
    launches = counts(wrappers)
    log(f"  soak [{card}]: {out['n_sessions']} sessions and "
        f"{out['http_completions']} HTTP completions in {out['wall_s']:.2f} s "
        f"wall = {out['n_sessions'] / out['wall_s']:.2f} sessions per wall "
        f"second; {out['virtual_makespan_s']:.1f} s virtual, "
        f"{out['events']} events, max pacing lag {out['max_lag_s']:.3f} s, "
        f"{out['decoded_tokens']} decoded tokens; conservation, block audit, "
        f"pool mirrors and span closure clean")
    log(f"  launches: {launches}")
    for name in ("flash_prefill", "paged_decode", "paged_append"):
        if launches[name] <= 0:
            raise AssertionError(f"soak never launched {name}")
    log(f"  phase 4d wall {time.perf_counter() - t0:.1f} s")
    return launches


def decode_profile(torch, params, tok, cache, pos, cfg, card):
    """Where a decode step's time goes: two more steps (after the counted
    run, on a copy of the cache) under the profiler; device busy share and
    the top kernels."""
    from repro_torch.models import lm
    from torch.profiler import ProfilerActivity, profile

    cache = {k: v.clone() for k, v in cache.items()}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for step in range(2):
            lm.decode_step(params, tok, cache, pos + step, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    evts = prof.key_averages()
    busy = sum(_dev_us(e) for e in evts) / 1e6
    log(f"  profiled 2 decode steps [{card}]: wall {wall * 1e3:.1f} ms, "
        f"device busy {busy * 1e3:.1f} ms = {100 * busy / wall:.1f}% (idle "
        f"{100 * (1 - busy / wall):.1f}%), "
        f"{sum(e.count for e in evts if _dev_us(e))} kernel launches")
    for e in sorted(evts, key=_dev_us, reverse=True)[:6]:
        log(f"    device {_dev_us(e) / 1e3:9.3f} ms  calls {e.count:6d}  "
            f"{e.key[:90]}")


def all_wrappers():
    from repro_torch.kernels.flash_attention import ops as F
    from repro_torch.kernels.mamba_scan import ops as M
    from repro_torch.kernels.paged_attention import ops as P
    from repro_torch.kernels.rwkv6 import ops as R
    return {"flash_prefill": F.flash_prefill,
            "paged_decode": P.paged_decode, "paged_append": P.paged_append,
            "wkv6": R.wkv6, "mamba_scan": M.mamba_scan}


def ssm_paths(torch, np, card):
    """Path A (rwkv6-7b, full width and depth, B=4) and path B
    (jamba-v0.1-52b at full width, depth cut to one superblock of 8
    layers, B=2: the whole model needs ~102 GB)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L

    wrappers = all_wrappers()
    none = dict.fromkeys(wrappers, 0)
    log("phase 5: path A, rwkv6-7b through lm.prefill / lm.decode_step")
    cfg = get_config("rwkv6-7b")
    n = cfg.n_layers
    a, fails = serve_path(torch, np, card, wrappers, cfg, 4,
                          {**none, "wkv6": n * 33}, {**none, "wkv6": n})
    log("phase 6: path B, jamba-v0.1-52b (depth 8) through lm.prefill / "
        "lm.decode_step")
    cfg = dataclasses.replace(get_config("jamba-v0.1-52b"), n_layers=8)
    b, fails_b = serve_path(torch, np, card, wrappers, cfg, 2,
                            {**none, "mamba_scan": 7 * 33,
                             "flash_prefill": 1, "paged_append": 32,
                             "paged_decode": 32},
                            {**none, "mamba_scan": 7, "flash_prefill": 1},
                            routing=SameRouting(torch, L))
    if fails + fails_b:
        raise AssertionError("; ".join(fails + fails_b))
    return {"path A rwkv6-7b": a, "path B jamba-v0.1-52b depth 8": b}


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
    for name in ("paged_decode_kernel", "flash_prefill_kernel"):
        mine = [e for e in evts if name in e.key and _dev_us(e)]
        t = sum(_dev_us(e) for e in mine) / 1e6
        log(f"  {name}: {t * 1e3:.3f} ms in {sum(e.count for e in mine)} "
            f"calls = {100 * t / busy:.1f}% of the device's busy time")
    host = [e for e in evts if not _dev_us(e)]
    for e in sorted(host, key=lambda e: e.self_cpu_time_total,
                    reverse=True)[:8]:
        log(f"    host {e.self_cpu_time_total / 1e3:9.3f} ms  calls "
            f"{e.count:6d}  {e.key[:90]}")
    srv.runtime.check_conservation()


# ---------------------------------------------------------------------------
# phases 5-6: paths A (rwkv6-7b) and B (jamba) through lm.prefill /
# lm.decode_step
# ---------------------------------------------------------------------------
# prefill + decode against the full forward: tests/test_models_smoke.py
# holds the reference to 1e-2 / 2e-2 at tiny width, where logits stay
# below 1; at full width they reach ~6, so the limits are taken relative
# to the largest logit.  The prefill's last logits run the forward's own
# arithmetic on the same prompt: TOL_FORWARD.  A decode step does not:
# its GEMMs take B rows where the forward's take B*1056, so cuBLAS picks
# other kernels, whose f32 sums round some bf16 activations the other
# way; jamba's decode scan leaves h.C unrounded where the prefill scan
# rounds it (the reference's own difference), and its attention runs
# paged_decode, not flash.  Random-weight layers amplify such one-ulp
# differences with depth.  Readings on an NVIDIA H100 80GB HBM3 at 700 W:
# the forward on 1024 and on 1056 tokens differs at position 1023 by
# 6.8e-2 of the largest logit through rwkv6-7b's 32 layers (1.6e-6
# through jamba's 8), and is bit-exact when both take 1056 tokens (the
# last 32 changed): the GEMM shape is the cause.  The carried states
# differ from the sequence's prefill by 4.2e-3 (rwkv6-7b) and 1.2e-2
# (jamba, its attention slot's k and v) at the first layer of each cache
# entry, growing to 7e-2 and 2.6e-2 at the last.  The last decode step
# read 6.2e-2 (rwkv6-7b) and 2.4e-2 (jamba) against the forward.
# Faults planted in that step's inputs read, on the logits and on the
# states: a lost state write 1.10 / 0.96 and 1.38 / 1.42, a zero cache
# 1.20 / 1.12 and 1.46 / 1.00, a dropped shift_tm 0.48 / 0.12, a dropped
# conv state 1.56 / 1.00, a position off by one 3.2e-2 / 1.14.  Each
# limit below sits between the sound reading and the faults'; every
# fault must be caught by one of the two checks, and the lost write and
# the zero cache by the logits.
TOL_FORWARD = 2e-2
TOL_DECODE = {"ssm": 1.5e-1, "hybrid": 5e-2}
TOL_STATE = {"ssm": 2e-2, "hybrid": 1e-1}
MUST_MOVE_LOGITS = ("zero cache", "one lost state write")


def reset(wrappers):
    for w in wrappers.values():
        w.launches = 0


def counts(wrappers):
    return {name: w.launches for name, w in wrappers.items()}


def _clone(cache):
    return {key: t.clone() for key, t in cache.items()}


def state_errs(cache, ref, n):
    """Per layer, each cache entry's largest difference from ``ref``'s
    over ``ref``'s largest magnitude there: rwkv's states per layer,
    jamba's k and v (first n positions) per superblock and its conv and
    ssm states per mamba layer."""
    out = {}
    for key, a in cache.items():
        b = ref[key]
        if key in ("k", "v"):
            a, b = a[:, :, :n], b[:, :, :n]
        elif key in ("conv", "ssm"):
            a, b = a.flatten(0, 1), b.flatten(0, 1)
        d = (a.float() - b.float()).abs().flatten(1).amax(1)
        m = b.float().abs().flatten(1).amax(1).clamp_min(1e-30)
        out[key] = (d / m).tolist()
    return out


def first_layer(errs) -> float:
    """The largest error at the first layer of each cache entry (jamba's
    k and v: its attention slot, after four mamba layers)."""
    return max(e[0] for e in errs.values())


def serve_path(torch, np, card, wrappers, cfg, B, expect, expect_fwd,
               routing=None):
    """``cfg`` at full width from seed-0 random bf16 weights made on the
    card: B prompts of 1024 tokens through ``lm.prefill``, then 32 greedy
    ``lm.decode_step``s carrying the state cache (counted: ``expect``
    launches).  Then ``lm.forward_logits`` on the prompt and on the
    1056-token sequences and ``lm.prefill`` on the sequences (each counted
    apart: ``expect_fwd``), held to the prefill's logits, the last decode
    step's logits and the carried states; then the planted faults.
    Returns (the path's launch counts, the failed checks)."""
    from repro_torch.models import lm

    S, n_dec = 1024, 32
    fails = []

    def hold(name, err, tol, miss=False):
        ok = err > tol if miss else err < tol
        log(f"  {name}: {err:.4e} ({'must exceed' if miss else 'tol'} "
            f"{tol:g}){'' if ok else '  FAILED'}")
        if not ok:
            fails.append(f"{cfg.name} {name}: {err} vs {tol}")

    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"  {cfg.name} ({cfg.n_layers} layers) params ready in "
        f"{time.perf_counter() - t0:.1f} s; memory_allocated "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    prompt = torch.as_tensor(np.random.RandomState(2).randint(
        1, cfg.vocab, size=(B, S)), device="cuda")

    if routing:
        routing.record()
    reset(wrappers)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    # 2 more positions: the profiled steps after the counted run
    max_len = S + n_dec + 2
    last, cache = lm.prefill(params, {"tokens": prompt}, cfg,
                             max_len=max_len)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    toks, tok, kept = [prompt], last.argmax(-1), []
    for step in range(n_dec):
        if step >= n_dec - 2:        # the planted faults start from these
            kept.append(_clone(cache))
        toks.append(tok)
        logits, cache = lm.decode_step(params, tok, cache, S + step, cfg)
        tok = logits.argmax(-1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts(wrappers)
    peak = torch.cuda.max_memory_allocated()
    if routing:
        routing.restore()
    log(f"  launches (prefill + {n_dec} decode steps): {launches}")
    if launches != expect:
        raise AssertionError(f"{cfg.name}: launches {launches}, expected "
                             f"{expect}")
    log(f"  {cfg.name} [{card}]: B={B} x {S} prompt tokens; prefill "
        f"{t_prefill:.3f} s, then {n_dec} decode steps "
        f"{(wall - t_prefill) / n_dec * 1e3:.2f} ms each; wall "
        f"{wall:.3f} s = {B * n_dec / wall:.2f} decoded tokens per wall "
        f"second (prefill included); max_memory_allocated "
        f"{peak / 2**30:.2f} GiB")

    decode_profile(torch, params, tok, cache, S + n_dec, cfg, card)

    seq = torch.cat(toks, dim=1)                       # (B, S + n_dec)
    picks = routing.by_position(B, S, n_dec) if routing else None
    fwd = {}
    for label, n, run in (
            ("forward_logits on the prompt", S, lm.forward_logits),
            ("forward_logits on the sequence", S + n_dec, lm.forward_logits),
            ("prefill on the sequence", S + n_dec,
             lambda p, b, c: lm.prefill(p, b, c, max_len=max_len))):
        if routing:
            routing.replay([(p[:, :n].flatten(0, 1), i[:, :n].flatten(0, 1))
                            for p, i in picks])
        reset(wrappers)
        out = run(params, {"tokens": seq[:, :n]}, cfg)
        torch.cuda.synchronize()
        if routing:
            routing.restore()
        log(f"  {label} ({n} tokens), launches (apart): {counts(wrappers)}")
        if counts(wrappers) != expect_fwd:
            raise AssertionError(f"{cfg.name}: {label} launches "
                                 f"{counts(wrappers)}, expected {expect_fwd}")
        fwd[label] = out
    ref_cache = fwd.pop("prefill on the sequence")[1]
    ref = fwd["forward_logits on the sequence"]
    if not bool(ref.isfinite().all()) or ref.shape != (B, S + n_dec,
                                                       cfg.vocab):
        raise AssertionError(f"{cfg.name}: forward logits {ref.shape}, "
                             f"finite {bool(ref.isfinite().all())}")
    if routing:
        log(f"  forwards and prefill held to the served MoE picks: "
            f"{routing.flips} near-tie flips over the three (recorded gaps "
            f"{routing.gaps[:8]})")

    # where the decode step's difference comes from (reported)
    floor = rel_err(fwd["forward_logits on the prompt"][:, -1],
                    ref[:, S - 1])
    log(f"  forward on {S} vs {S + n_dec} tokens at position {S - 1}: "
        f"{floor:.4e} of the largest logit")
    if not routing:              # one shape: the same kernels on each row
        other = seq.clone()
        other[:, S:] = (other[:, S:] + 1) % cfg.vocab
        same = rel_err(lm.forward_logits(params, {"tokens": other}, cfg)
                       [:, S - 1], ref[:, S - 1])
        log(f"  forward on {S + n_dec} tokens, its last {n_dec} changed, "
            f"at position {S - 1}: {same:.4e} of the largest logit")
    errs = state_errs(cache, ref_cache, S + n_dec)
    for key, e in errs.items():
        idx = sorted({i for i in (0, 1, 3, len(e) // 2, len(e) - 1)
                      if i < len(e)})
        log(f"  carried {key} vs prefill on the sequence, by layer "
            + ", ".join(f"{i}: {e[i]:.2e}" for i in idx))

    # the checks
    ref_last = ref[:, -1]
    for label, ours, theirs, tol in (
            ("prefill last logits vs forward", last[:, 0],
             fwd["forward_logits on the prompt"][:, -1], TOL_FORWARD),
            ("last decode step logits vs forward", logits[:, 0], ref_last,
             TOL_DECODE[cfg.family])):
        agree = int((ours.argmax(-1) == theirs.argmax(-1)).sum())
        log(f"  {label}: max_abs_err {max_err(ours, theirs):.4e}, largest "
            f"logit {float(theirs.abs().max()):.3f}, argmax agrees on "
            f"{agree}/{B} rows")
        hold(f"{label} (relative)", rel_err(ours, theirs), tol)
    hold("carried states vs prefill on the sequence, first layer of each "
         "entry", first_layer(errs), TOL_STATE[cfg.family])

    # planted faults in the last decode step's inputs: each must miss
    pos = S + n_dec - 1
    stale, before = kept
    faults = {"zero cache": (lm.init_cache(cfg, B, max_len, device="cuda"),
                             pos),
              "one lost state write": (stale, pos)}
    if cfg.family == "ssm":
        faults["shift_tm dropped"] = (dict(_clone(before), shift_tm=(
            torch.zeros_like(before["shift_tm"]))), pos)
    else:
        faults["conv state dropped"] = (dict(_clone(before), conv=(
            torch.zeros_like(before["conv"]))), pos)
        faults["position off by one"] = (_clone(before), pos - 1)
    for name, (bad, p) in faults.items():
        lg, bad = lm.decode_step(params, seq[:, -1:], bad, p, cfg)
        got = {"logits": (rel_err(lg[:, 0], ref_last),
                          TOL_DECODE[cfg.family]),
               "states": (first_layer(state_errs(bad, ref_cache, S + n_dec)),
                          TOL_STATE[cfg.family])}
        seen = [what for what, (e, tol) in got.items() if e > tol]
        log(f"  fault '{name}': " + ", ".join(
            f"{what} {e:.4e} (limit {tol:g})" for what, (e, tol)
            in got.items()) + f"; caught by {' and '.join(seen) or 'NEITHER'}")
        if not seen or (name in MUST_MOVE_LOGITS and "logits" not in seen):
            fails.append(f"{cfg.name} fault '{name}' caught by {seen}")
    del fwd, ref, ref_cache, faults, kept, stale, before, bad, lg
    del params, cache, logits, last
    gc.collect()
    torch.cuda.empty_cache()
    return launches, fails


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: torch.cuda.is_available() is false; this smoke "
            "runs only on a CUDA card")
        return 1
    from repro_torch.kernels import build

    # float32 products in full float32 (PyTorch's default, stated here),
    # and bf16 products reduced in f32 (the parity phases compare against
    # f32-accumulating references; ROADMAP.md asks it for the MoE router)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
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
            elif "entry function" in line:
                log(f"  ptxas {name}: {line.split(chr(39))[1]}")
    smem = build.function("flash_attention", "flash_prefill_smem_bytes",
                          [ctypes.c_int])
    log("  flash_prefill_kernel dynamic shared memory per CTA: "
        + ", ".join(f"D={d} {smem(d)} bytes" for d in (16, 64, 128)))
    wsmem, wctas = (build.function("wkv6", f"wkv6_{f}", [ctypes.c_int])
                    for f in ("smem_bytes", "ctas_per_sm"))
    log("  wkv6_kernel dynamic shared memory per CTA and CTAs per SM: "
        + ", ".join(f"dh={d} {wsmem(d)} bytes, {wctas(d)}"
                    for d in (16, 64)))
    from repro_torch.kernels.mamba_scan import ops as M
    configs = {d: M.kernel_config(d) for d in M.STATE_SIZES}
    log("  mamba_scan_kernel (the ring entry) lanes a channel, registers a "
        "thread, dynamic shared memory per CTA and CTAs per SM; local "
        "memory a thread (either entry): "
        + ", ".join("ds={} {} lanes, {} registers, {} bytes, {}; {} "
                    "bytes".format(d, *c) for d, c in configs.items()))
    spills = {d: c[4] for d, c in configs.items() if c[4]}
    if spills:
        raise AssertionError(f"mamba_scan uses local memory (spills), "
                             f"bytes a thread by d_state: {spills}")

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    gen_more = torch.Generator(device="cuda")   # the later-added shapes
    gen_more.manual_seed(1)
    log(f"phase 2: kernels vs plain versions on the card [{card}]")
    kernels = [flash_phase(torch, gen, gen_more),
               *paged_phase(torch, gen, gen_more),
               wkv6_phase(torch, gen), mamba_phase(torch, gen)]
    log("phase 3: reference check on small inputs")
    reference_phase(torch, np)
    ssm_reference_phase(torch, np)
    log("phase 4: main path (llama3.2-3b served)")
    by_path = main_path(torch, np, card)
    log("phase 4c: serve_bench_torch's fingerprints on the card (micro)")
    by_path["serve_bench_torch micro"] = bench_phase(torch, card)
    log("phase 4d: soak_bench_torch's soak on the card (micro)")
    by_path["soak_bench_torch micro"] = soak_phase(torch, card)
    by_path.update(ssm_paths(torch, np, card))
    for rec in kernels:
        rec["launches_by_path"] = {p: n[rec["name"]] for p, n in
                                   by_path.items() if n[rec["name"]]}
        rec["launches"] = sum(rec["launches_by_path"].values())
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
