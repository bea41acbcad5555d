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
   gather engine's llama3.2-3b cache (one block of 2048 tokens a row);
   both at phases 7-8's shapes (flash at mixtral-8x22b's S=4608, H=48
   over K=8, window 4096, and llava-next-34b's S=2560, H=56 over K=8;
   paged append + decode at mixtral's served round, B=4, nb=512, window
   4096 over a 4640-token row; paged decode over llava's contiguous
   cache, one block of 2576 tokens; inputs from ``gen_more``, drawn
   after the paged shapes') (bf16, 2e-2; these four long shapes also
   within 2 bf16 steps of each output row's largest value, which
   ``tools/window_faults.py`` shows catching faults at the window's edge);
   wkv6 at rwkv6-7b's prefill (B=4, T=1024, H=64, dh=64) and decode (T=1,
   a state in) shapes and at head size 16; mamba_scan at jamba's prefill
   (B=2, T=1024, di=8192, ds=16, h.C rounded to bf16) and decode (T=1, a
   state in) shapes and at di=128, ds=8 in both modes (outputs and final
   states, 1e-3 relative; the rounding mode's outputs equal past an f32
   slack at the scale of the sum h.C but on at most 1 % of elements, each
   at most one bf16 step of h.C off: ``mamba_scan.ops.rounding_errs``).
   Then phases 9-10's shapes, from ``gen_more`` after the long ones: flash
   at deepseek-v2's MLA prefill (B=2, S=1024, H=K=128, query-key width
   192 over value width 128, causal), seamless's encoder (B=4, S=1024,
   H=K=16, D=64, non-causal) and cross-attention (256 queries over 1024
   frames, non-causal); paged append + decode at G = 1, dh = 64 over
   seamless's self cache (one block of 288 a row, lens 257) and decode
   over its cross cache (lens 1024); all also within ``TOL_ROW_STEPS``.
   Each kernel is timed with CUDA events beside its plain version, its
   bound and, for flash, ``scaled_dot_product_attention`` (a yardstick
   the port never calls); flash and paged decode also at the further
   shapes, wkv6 and mamba_scan also at their decode shapes (T=1, a state
   in), whose times go into the JSON line's ``more_shapes``;
   ``mamba_scan``'s record also gives its lanes a channel (``lanes``) and
   the special-function units' floor (``sfu_floor_ms``).  The profiler's
   device time counts every kernel a wrapper launches, and fails if
   another kernel runs in the window.  An empty kernel launched as
   ``paged_append`` is (4 CTAs of 128 threads, through ctypes) is timed as
   the least a separate launch takes (``launch_floor_ms``, device
   ``launch_floor_device_ms``, in ``paged_append``'s record).
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
7. The moe family: mixtral-8x22b at full width, depth cut from 56 to 8
   layers (random bf16 from seed 0, ~38 GiB), served by
   ``MultiWorkerServer`` (2 workers, 4 slots, max_len 8192, block 16,
   1024 pool blocks) for 3 agent tasks, task 0's first prompt 4608 tokens
   so its prefill and every later decode pass the 4096-token window;
   phase 4's checks, then a profiled task.  Then one session alone: a
   4608-token prompt through ``lm.prefill``, scattered into pool blocks,
   16 ``lm.decode_step_paged`` steps (exactly 8 flash_prefill, 128 each
   of paged_append and paged_decode), held to ``lm.forward_logits`` on
   the 4624 tokens (TOL_DECODE, the forward held to the run's MoE picks)
   and the first layer's K/V to ``lm.prefill`` on them (TOL_STATE); a
   zero cache, a lost append, a position off by one and the step run
   without the window must each fail one of the two (the window also at
   layer 0's attention against the plain version with and without it).
8. The vlm family: llava-next-34b at full width, depth cut from 60 to 16
   layers (~18 GiB): 2048 patch embeddings then 512 tokens through
   ``lm.prefill``, 16 ``lm.decode_step``s over the contiguous cache at
   positions counted with the patches (exactly 16 flash_prefill, 256
   each of paged_append and paged_decode), held as in phase 7; a zero
   cache, a lost state write and positions counted without the patches
   must fail.  Then one text-only session (the empty patch stream)
   through ``Engine(paged=True)``: a park and a resume with a 64-token
   delta, exact launches, ids in range, the audit clean.
   Both phases run before a failed check ends the script; each counts
   its launches under its own path.
9. MLA: deepseek-v2-236b at full width (d_model 5120, 128 heads, q_lora
   1536, kv_lora 512, qk 128 + 64, v 128, 160 experts top-6 and 2 shared,
   vocab 102400), depth cut from 60 to 4 layers (~31.6 GiB): B=2 prompts
   of 1024 tokens through ``lm.prefill``, 16 greedy ``lm.decode_step``s
   over the latent cache (exactly 4 flash_prefill launches and no other:
   the decode attends over the latent with absorbed-matrix products, and
   the latent is written by an indexed copy), held to
   ``lm.forward_logits`` on the 1040 tokens (``TOL_DECODE["mla"]``, the
   forward replaying the run's MoE picks) and the first layer's ckv and
   krope to ``lm.prefill`` on them (``TOL_STATE["mla"]``); a zero latent
   cache, a lost latent write and a position off by one must each fail
   one of the two, the first two the logits.
10. Enc-dec: seamless-m4t-large-v2 at full width and depth (24 + 24
   layers, d_model 1024, 16 heads of 64, vocab 256206): B=4, 1024 seeded
   frame embeddings (x 0.02, the reference's front-end stub) and a
   256-token target prefix through ``lm.prefill``, 32 greedy
   ``lm.decode_step``s (exactly 72 flash_prefill, 768 paged_append and
   1,536 paged_decode launches), held to the forward on the 288 target
   tokens and the first decoder layer's self and cross K/V to the
   prefill on them (``TOL_DECODE`` / ``TOL_STATE["encdec"]``); a position
   off by one must fail one of the two, and a zero self cache, a zeroed
   cross cache, a cross cache made by a causal encoder and the cross
   query alone roped at the position before must each fail the logits
   (the state check compares the very caches the first three replace,
   and no cache shows the fourth).
11. Training: llama3.2-3b at full width and depth (random bf16 from seed
   0 on the card), B=2 x 1024 ``SyntheticLM`` tokens.  Step 0's
   ``lm.forward_train`` loss (plain blocked attention, under autograd)
   against the cross-entropy of ``lm.forward_logits`` on the same batch
   (28 flash_prefill launches, the path's only ones) within 2e-2
   relative; every gradient leaf finite and nonzero, and not with the
   attention output detached before ``wo`` (planted); ``train_loop`` for
   12 AdamW steps at lr 3e-4 launches no kernel, and its last loss is
   below its first (step time, tokens a second, peak memory, one profiled
   step); 6 steps with a checkpoint at step 6 in a temporary directory,
   then a fresh ``train_loop(resume=True)``: the state restored bit-equal
   to the saving run's, batch 6's tokens first, steps 6-11's losses equal
   to the uninterrupted run's (or within 1e-3 relative).  12 steps, not
   8: at full width AdamW's first steps raise the loss on this stream,
   the reference's as the port's (``tools/train_wide_parity.py``), and
   it falls below step 0's from step 8.  Then the ten tiny
   families' ``forward_train`` + backward on the card against the CPU
   (loss and every gradient leaf within 2e-2).
12. Production layouts, in a child process (``chip_smoke.py --layouts
   CARD``) so that its fake process group never meets phases 1-11's
   state: the sharding specs on DTensor meshes on "cuda" over
   ``launch.mesh.fake_world(512)`` (this process rank 0, the card its
   device): the reference's (16, 16) and (2, 16, 16) meshes and
   ``make_worker_mesh(64, tp=8)``, an (8, 8) mesh of 64 GPUs, 8 a node.
   (a) Every supported (arch x shape) cell's ``specs.input_specs`` on
   each: every leaf's local shape under DTensor's placements as its spec
   implies, and a table of bytes a device (params, AdamW moments, cache,
   inputs; not activations) against the card's memory; the same local
   shape check for ``serve_fullshard``'s decode cells (KV sequence over
   ("model", "data"), a ``_StridedShard``).  (b) Rank 0's shards of
   deepseek-v2-236b at full depth (60 layers) on the (8, 8) mesh, params
   and both moments (35.96 GiB), allocated on the card, filled from a
   seeded generator and wrapped with ``DTensor.from_local``: global and
   local shapes as the specs give them, and the rise in
   ``memory_allocated`` the table's bytes within 512 bytes a leaf; then
   freed.  No kernel is launched.
   Phases 5-6 and 9-10 run through one ``serve_path``, with phases 5-6's
   forward on the prompt and prefill-vs-forward check.  Both phases run
   before a failed check ends the script; each counts its launches under
   its own path.

The second-to-last line is the kernels' JSON record; the last is
``{"ok": true, "device": {...}}``.  Nothing falls back to the CPU: without
CUDA the script exits non-zero before any result.
"""
from __future__ import annotations

import contextlib
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
TOL_ROW_STEPS = 2.0         # the long shapes: bf16 steps at a row's top
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


def row_steps(x, ref) -> float:
    """The largest error of any row (the last axis), in bf16 steps at that
    row's largest |ref|.  Over n keys an attention output of std-1 inputs
    has std sqrt(e / n), about 0.026 at n = 4096, so at the long shapes
    TOL_BF16 is as large as a typical value; this limit scales with each
    row instead.  Both versions round to bf16 last, so a sound kernel
    parts from the plain one by at most about a step."""
    ref = ref.float()
    err = (x.float() - ref).abs().amax(-1)
    top = ref.abs().amax(-1).clamp_min(2.0 ** -126)
    step = (top.log2().floor() - 7).exp2()   # bf16: 8 significant bits
    return float((err / step).max())


def check_long(name: str, x, ref) -> dict:
    """``check`` with TOL_BF16 and with TOL_ROW_STEPS; both readings."""
    steps = row_steps(x, ref)
    err = check(name, max_err(x, ref))
    log(f"  {name}: largest row error {steps:.3f} bf16 steps at the row's "
        f"largest |ref| (tol {TOL_ROW_STEPS:g})")
    if not steps < TOL_ROW_STEPS:
        raise AssertionError(f"{name}: {steps} bf16 steps >= "
                             f"{TOL_ROW_STEPS}")
    return {"max_abs_err": err, "row_err_bf16_steps": steps}


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


def flash_long_shapes(torch, gen, rec):
    """Flash prefill at this slice's served shapes, drawn from ``gen``
    after the paged shapes' draws: mixtral-8x22b's 4608-token prompt (H=48
    over K=8, G=6) with its window of 4096 biting, and llava-next-34b's
    2048 patches + 512 tokens (H=56 over K=8, G=7), causal.  Checked
    (``check_long``: TOL_BF16 and a limit scaled to each row), timed
    beside SDPA (the band as a boolean ``attn_mask`` where there is
    a window) and the bound; added to ``rec``'s ``more_shapes`` and
    ``max_abs_err``."""
    from repro_torch.kernels.flash_attention import ops as F

    sdpa = torch.nn.functional.scaled_dot_product_attention
    mk = lambda *s: torch.randn(s, generator=gen, device="cuda",  # noqa
                                dtype=torch.float32).to(torch.bfloat16)
    for (B, S, H, K, D), window in [((1, 4608, 48, 8, 128), 4096),
                                    ((1, 2560, 56, 8, 128), 0)]:
        q, k, v = mk(B, S, H, D), mk(B, S, K, D), mk(B, S, K, D)
        out = F.flash_prefill(q, k, v, causal=True, window=window)
        torch.cuda.synchronize()
        ref = F.flash_prefill_plain(q, k, v, causal=True, window=window)
        errs = check_long(f"flash B={B} S={S} H={H} K={K} D={D} "
                          f"window={window}", out, ref)
        rec["max_abs_err"] = max(rec["max_abs_err"], errs["max_abs_err"])
        del ref
        run = lambda: F.flash_prefill(q, k, v, causal=True,  # noqa
                                      window=window)
        ms = timed(torch, run)
        dev = device_ms(torch, run, "flash_prefill_kernel")
        plain_ms = timed(torch, lambda: F.flash_prefill_plain(
            q, k, v, causal=True, window=window), iters=2, warmup=1)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        if window:
            i = torch.arange(S, device="cuda")
            band = (i[None, :] <= i[:, None]) & (i[:, None] - i[None, :]
                                                  < window)
            lib = lambda: sdpa(qt, kt, vt, attn_mask=band,  # noqa
                               enable_gqa=True)
        else:
            lib = lambda: sdpa(qt, kt, vt, is_causal=True,  # noqa
                               enable_gqa=True)
        lib_ms = timed(torch, lib, iters=5)
        # (query, key) pairs each query head scores: the band's
        pairs = B * H * sum(min(t + 1, window or S) for t in range(S))
        nbytes = 2 * (2 * B * S * H * D + 2 * B * S * K * D)
        bms, by = bound(nbytes, 4 * D * pairs)
        shape = (f"B={B} S={S} H={H} K={K} D={D} causal"
                 + (f" window={window}" if window else ""))
        rec["more_shapes"].append({
            "shape": shape, "ms": ms, "device_ms": dev,
            "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bms,
            "bound_by": by, **errs})
        log(f"  flash {shape} time {ms:.4f} ms (device {dev} ms)  plain "
            f"{plain_ms:.4f} ms  sdpa {lib_ms:.4f} ms  bound {bms:.4f} ms "
            f"({by})")


def flash_width_shapes(torch, gen, rec):
    """Flash prefill at phases 9-10's shapes, drawn from ``gen`` after the
    long shapes' draws: deepseek-v2's MLA prefill (B=2, S=1024, H=K=128,
    query-key width 192 over value width 128, causal), seamless's encoder
    (B=4, S=1024, H=K=16, D=64, non-causal) and its cross-attention (256
    target queries over 1024 frames, non-causal).  Checked (``check_long``:
    TOL_BF16 and a limit scaled to each row), timed beside SDPA (which
    takes a value width apart; "none" where no backend takes the shape)
    and the bound; added to ``rec``'s ``more_shapes`` and ``max_abs_err``."""
    from repro_torch.kernels.flash_attention import ops as F

    sdpa = torch.nn.functional.scaled_dot_product_attention
    mk = lambda *s: torch.randn(s, generator=gen, device="cuda",  # noqa
                                dtype=torch.float32).to(torch.bfloat16)
    for label, B, Sq, Sk, H, K, D, Dv, causal in [
            ("deepseek-v2 MLA prefill", 2, 1024, 1024, 128, 128, 192, 128,
             True),
            ("seamless encoder", 4, 1024, 1024, 16, 16, 64, 64, False),
            ("seamless cross-attention", 4, 256, 1024, 16, 16, 64, 64,
             False)]:
        q, k, v = mk(B, Sq, H, D), mk(B, Sk, K, D), mk(B, Sk, K, Dv)
        run = lambda: F.flash_prefill(q, k, v, causal=causal)  # noqa
        out = run()
        torch.cuda.synchronize()
        ref = F.flash_prefill_plain(q, k, v, causal=causal)
        errs = check_long(f"flash {label} B={B} Sq={Sq} Sk={Sk} H={H} K={K} "
                          f"D={D} Dv={Dv} causal={causal}", out, ref)
        rec["max_abs_err"] = max(rec["max_abs_err"], errs["max_abs_err"])
        del ref, out
        ms = timed(torch, run)
        dev = device_ms(torch, run, "flash_prefill_kernel")
        plain_ms = timed(torch, lambda: F.flash_prefill_plain(
            q, k, v, causal=causal), iters=2, warmup=1)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        try:
            lib_ms = timed(torch, lambda: sdpa(qt, kt, vt, is_causal=causal),
                           iters=5)
        except RuntimeError as e:          # no backend takes the shape
            log(f"  sdpa at {label}: {str(e).splitlines()[0][:120]}")
            lib_ms = None
        pairs = B * H * (Sq * (Sq + 1) // 2 if causal else Sq * Sk)
        nbytes = 2 * (B * Sq * H * (D + Dv) + B * Sk * K * (D + Dv))
        bms, by = bound(nbytes, 2 * (D + Dv) * pairs)
        shape = (f"{label}: B={B} Sq={Sq} Sk={Sk} H={H} K={K} D={D} Dv={Dv} "
                 + ("causal" if causal else "non-causal"))
        rec["more_shapes"].append({
            "shape": shape, "ms": ms, "device_ms": dev,
            "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bms,
            "bound_by": by, **errs})
        sdpa_ms = "none" if lib_ms is None else f"{lib_ms:.4f} ms"
        log(f"  flash {shape} time {ms:.4f} ms (device {dev} ms)  plain "
            f"{plain_ms:.4f} ms  sdpa {sdpa_ms}  bound {bms:.4f} ms ({by})")


def paged_g1_shapes(torch, gen, recs):
    """paged_append + paged_decode at phase 10's shapes (G = 1, dh = 64:
    ``PAGED_SEAMLESS``), drawn from ``gen`` after the flash width shapes';
    added to the two kernels' records ``recs``."""
    errs = {"paged_decode": [], "paged_append": []}
    more = paged_more_shapes(torch, gen, errs, PAGED_SEAMLESS)
    for rec in recs:
        rec["more_shapes"] += more[rec["name"]]
        rec["max_abs_err"] = max([rec["max_abs_err"], *errs[rec["name"]]])


def paged_phase(torch, gen, gen_more):
    from repro_torch.kernels import build
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
        # the floor under any separate launch: an empty kernel launched as
        # paged_append is (B CTAs of 128 threads, through ctypes)
        floor = build.function("paged_attention", "launch_floor",
                               [ctypes.c_int, ctypes.c_void_p])
        run_floor = lambda: build.launch(kp.device, floor, B)  # noqa: E731
        fms = timed(torch, run_floor)
        fdev = device_ms(torch, run_floor, "launch_floor_kernel")
        recs["paged_append"].update(launch_floor_ms=fms,
                                    launch_floor_device_ms=fdev)
        log(f"  launch floor (an empty kernel, {B} CTAs of 128 threads) "
            f"{fms:.4f} ms (device {fdev} ms): the least a separate "
            f"paged_append launch takes")
    more = paged_more_shapes(torch, gen_more, errs)
    recs["paged_decode"]["more_shapes"] = more["paged_decode"]
    recs["paged_append"]["more_shapes"] = more["paged_append"]
    for name, rec in recs.items():
        rec["max_abs_err"] = max(errs[name])
    return [recs["paged_decode"], recs["paged_append"]]


PAGED_MORE = [   # label, B, H, K, dh, block, nb, lens, window, appends, long
    ("served", 4, 24, 8, 128, 16, 128, [1056, 1, 1, 1], 0, False, False),
    ("jamba contiguous", 2, 32, 8, 128, 1058, 1, [1056, 1025], 0, False,
     False),
    ("gather llama3.2-3b contiguous", 4, 24, 8, 128, 2048, 1,
     [2048, 1056, 1, 300], 0, False, False),
    ("served mixtral-8x22b", 4, 48, 8, 128, 16, 512, [4640, 1, 1, 1], 4096,
     True, True),
    ("llava-next-34b contiguous", 1, 56, 8, 128, 2576, 1, [2576], 0, False,
     True)]
# phase 10's shapes: seamless's self cache (one block of 288 a row, the
# first decode step's append at 256) and its cross cache, G = 1
PAGED_SEAMLESS = [
    ("seamless self cache", 4, 16, 16, 64, 288, 1, [257] * 4, 0, True,
     True),
    ("seamless cross cache", 4, 16, 16, 64, 1024, 1, [1024] * 4, 0, False,
     True)]


def paged_more_shapes(torch, gen, errs, cases=PAGED_MORE):
    """paged_decode at the served path's real shape (B=4: one live row of
    1056 tokens, three idle rows of len 1 on table rows of zeros, nb=128),
    at jamba's contiguous cache (B=2, one block of 1058 tokens a row,
    nb=1, lens 1056 and 1025), at the gather engine's llama3.2-3b cache
    (B=4, one block of 2048 tokens a row, a full row, an idle one), at
    mixtral-8x22b's served shape (B=4, H=48 over K=8, G=6, max_len 8192
    so nb=512, window 4096 biting on one live row of 4640 tokens, three
    idle rows; paged_append first, the idle rows on the drop sentinel)
    and at llava-next-34b's contiguous cache (B=1, G=7, one block of 2576
    tokens): checked, timed, each beside its bound and, over a contiguous
    cache, one ``scaled_dot_product_attention`` call
    (``contiguous_sdpa``); the two later shapes
    (``long``) also against ``TOL_ROW_STEPS``, as ``check_long`` does.
    ``cases`` (``PAGED_MORE`` unless given) lists them.  Returns the
    records of both kernels."""
    from repro_torch.kernels.paged_attention import ops as P

    mk = lambda *s: torch.randn(s, generator=gen, device="cuda",  # noqa
                                dtype=torch.float32).to(torch.bfloat16)
    out_recs = {"paged_decode": [], "paged_append": []}
    for label, B, H, K, dh, block, nb, lens, window, appends, long in cases:
        nblocks = B * nb + 1
        q, kp, vp = mk(B, H, dh), mk(nblocks, block, K, dh), \
            mk(nblocks, block, K, dh)
        tables = torch.zeros(B, nb, dtype=torch.int32, device="cuda")
        tables[0] = torch.arange(1, nb + 1, dtype=torch.int32,
                                 device="cuda")
        if nb == 1:                    # the contiguous cache: block b
            tables[:, 0] = torch.arange(B, dtype=torch.int32, device="cuda")
        lens_t = torch.tensor(lens, dtype=torch.int32, device="cuda")
        if appends:                    # a served round: the append first
            append_shape(torch, P, mk, errs, out_recs, label, tables,
                         lens_t, kp, vp, nblocks)
        out = P.paged_decode(q, kp, vp, tables, lens_t, window=window)
        torch.cuda.synchronize()
        ref = P.paged_decode_plain(q, kp, vp, tables, lens_t, window=window)
        name = (f"paged decode {label} B={B} H={H} K={K} block={block} "
                f"nb={nb} lens={lens} window={window}")
        got = (check_long(name, out, ref) if long
               else {"max_abs_err": check(name, max_err(out, ref))})
        errs["paged_decode"].append(got["max_abs_err"])
        run = lambda: P.paged_decode(q, kp, vp, tables, lens_t,  # noqa
                                     window=window)
        ms = timed(torch, run)
        dev = device_ms(torch, run, "paged_decode_kernel")
        plain_ms = timed(torch, lambda: P.paged_decode_plain(
            q, kp, vp, tables, lens_t, window=window), iters=5, warmup=1)
        lib = contiguous_sdpa(torch, q, kp, vp, lens, window) \
            if nb == 1 else None
        lib_ms = None
        if lib:
            check(f"sdpa yardstick at {label}", max_err(lib(), ref))
            lib_ms = timed(torch, lib)
        # the keys each row reads: the window clips a long row
        n_tok = sum(min(n, window) if window else n for n in lens)
        bms, by = bound(2 * B * H * dh * 2 + B * nb * 4 + B * 4
                        + n_tok * K * dh * 2 * 2, 4 * H * dh * n_tok)
        span, splits = P.split_schedule(
            nb, block, B * K,
            torch.cuda.get_device_properties(0).multi_processor_count)
        out_recs["paged_decode"].append({
            "shape": f"{label}: B={B} H={H} K={K} dh={dh} block={block} "
                     f"nb={nb} lens={lens}"
                     + (f" window={window}" if window else ""),
            "ms": ms, "device_ms": dev, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound_ms": bms, "bound_by": by,
            "span": span, "splits": splits, **(got if long else {})})
        sdpa_ms = "none" if lib_ms is None else f"{lib_ms:.4f} ms"
        log(f"  paged decode {label} time {ms:.4f} ms (device {dev} ms)  "
            f"plain {plain_ms:.4f} ms  sdpa {sdpa_ms}  bound {bms:.5f} ms "
            f"({by}); span {span}, {splits} splits")
    return out_recs


def contiguous_sdpa(torch, q, kp, vp, lens, window):
    """One ``scaled_dot_product_attention`` call computing what
    ``paged_decode`` computes over a contiguous cache (one block a row,
    table ``arange(B)``): row b's query over block b's first ``lens[b]``
    keys, sliced where every row has the same length, else masked.  A
    yardstick the port never calls; None with a window."""
    if window:
        return None
    sdpa = torch.nn.functional.scaled_dot_product_attention
    B, H, K = q.shape[0], q.shape[1], kp.shape[2]
    qt = q[:, :, None]                                  # (B, H, 1, dh)
    if len(set(lens)) == 1:
        kt, vt = (x[:B, :lens[0]].transpose(1, 2) for x in (kp, vp))
        mask = None
    else:
        kt, vt = (x[:B].transpose(1, 2) for x in (kp, vp))
        mask = (torch.arange(kp.shape[1], device=q.device)
                < torch.tensor(lens, device=q.device)[:, None])[:, None,
                                                                 None]
    return lambda: sdpa(qt, kt, vt, attn_mask=mask,
                        enable_gqa=H != K)[:, :, 0]


def append_shape(torch, P, mk, errs, out_recs, label, tables, lens, kp, vp,
                 nblocks):
    """paged_append at a served shape: each live row's token at position
    len - 1 of its table, the idle rows (len 1) on the drop sentinel;
    exact against the plain version, timed beside its bound."""
    B, K, dh = tables.shape[0], kp.shape[2], kp.shape[3]
    k_new, v_new = mk(B, K, dh), mk(B, K, dh)
    pos = (lens - 1).long()
    rows = torch.arange(B, device="cuda")
    ablk = tables[rows, pos // kp.shape[1]].contiguous()
    ablk[lens <= 1] = nblocks
    aoff = (pos % kp.shape[1]).to(torch.int32)
    kp2, vp2 = kp.clone(), vp.clone()
    P.paged_append(kp, vp, k_new, v_new, ablk, aoff)
    torch.cuda.synchronize()
    P.paged_append_plain(kp2, vp2, k_new, v_new, ablk, aoff)
    errs["paged_append"].append(check(
        f"append {label} B={B} K={K} dh={dh} (idle rows dropped)",
        max(max_err(kp, kp2), max_err(vp, vp2)), tol=1e-30))
    run = lambda: P.paged_append(kp, vp, k_new, v_new, ablk, aoff)  # noqa
    ms = timed(torch, run)
    dev = device_ms(torch, run, "paged_append_kernel")
    plain_ms = timed(torch, lambda: P.paged_append_plain(
        kp2, vp2, k_new, v_new, ablk, aoff))
    n_rows = int((ablk < nblocks).sum())
    bms, by = bound(2 * 2 * n_rows * K * dh * 2 + 2 * B * 4, 0.0)
    out_recs["paged_append"].append({
        "shape": f"{label}: B={B} K={K} dh={dh}, {B - n_rows} sentinel "
                 f"rows", "ms": ms, "device_ms": dev, "plain_ms": plain_ms,
        "bound_ms": bms, "bound_by": by})
    log(f"  paged append {label} time {ms:.4f} ms (device {dev} ms)  plain "
        f"{plain_ms:.4f} ms  bound {bms:.6f} ms ({by})")


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
    from repro_torch.models.routing_replay import SameRouting
    from repro_torch.models import lm

    for cfg in (rwkv6_7b.tiny(), jamba_v0_1_52b.tiny()):
        cpu_params = lm.init_params(cfg, seed=1, device="cpu")
        prompt = np.random.RandomState(1).randint(1, cfg.vocab, size=(2, 40))
        routing = SameRouting() if cfg.attn_period else None
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
def served_tasks(np, cfg, AgentRequest, n_tasks=4, first=None):
    """SWE-bench-shaped agent tasks, scaled down: a 512-1024 token first
    prompt (task 0's ``first`` tokens where given), then 64-256 tokens of
    tool observation; 32 decoded per step."""
    rng = np.random.RandomState(0)
    tools = ["code_execution", "web_api", "file_operations"]
    reqs, n_decode = [], 32
    for i in range(n_tasks):
        steps = []
        for s in range(3):
            n = rng.randint(512, 1025) if s == 0 else rng.randint(64, 257)
            if first and i == s == 0:
                n = first
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


def serve_paged(torch, np, card, cfg, params, reqs, max_len=2048):
    """Phase 4 (and phase 7's served run): ``reqs`` one at a time through
    ``MultiWorkerServer`` (2 workers, 4 slots, ``max_len``, block 16,
    1024 pool blocks); then one more task under the profiler.  Returns
    the counted run's launches and its readings (summary, stats, wall,
    peak memory)."""
    from repro_torch.serving.server import MultiWorkerServer

    wrappers = all_wrappers()
    t0 = time.perf_counter()
    srv = MultiWorkerServer(cfg, params, n_workers=2, n_slots=4,
                            max_len=max_len, pool_blocks=1024)
    torch.cuda.synchronize()
    log(f"  {cfg.name}: 2 paged engines ready in "
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
    log(f"  main path [{card}]: wall {wall:.3f} s for {len(reqs)} tasks x "
        f"3 steps, {decoded} decoded tokens = {decoded / wall:.2f} decoded "
        f"tokens per wall second (prefill included); max_memory_allocated "
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


def decode_profile(torch, step, card):
    """Where a decode step's time goes: ``step(0)`` and ``step(1)``, two
    more steps after the counted run (on a copy of its cache), under the
    profiler; device busy share and the top kernels."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for j in range(2):
            step(j)
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
    from repro_torch.models import lm
    from repro_torch.models.routing_replay import SameRouting

    wrappers = all_wrappers()
    none = dict.fromkeys(wrappers, 0)
    log("phase 5: path A, rwkv6-7b through lm.prefill / lm.decode_step")
    cfg = get_config("rwkv6-7b")
    n = cfg.n_layers
    params = ready(torch, lm, cfg)
    a, fails = serve_path(torch, np, card, wrappers, cfg, params, 4,
                          {**none, "wkv6": n * 33}, {**none, "wkv6": n})
    del params
    gc.collect()
    torch.cuda.empty_cache()
    log("phase 6: path B, jamba-v0.1-52b (depth 8) through lm.prefill / "
        "lm.decode_step")
    cfg = dataclasses.replace(get_config("jamba-v0.1-52b"), n_layers=8)
    params = ready(torch, lm, cfg)
    b, fails_b = serve_path(torch, np, card, wrappers, cfg, params, 2,
                            {**none, "mamba_scan": 7 * 33,
                             "flash_prefill": 1, "paged_append": 32,
                             "paged_decode": 32},
                            {**none, "mamba_scan": 7, "flash_prefill": 1},
                            routing=SameRouting())
    del params
    gc.collect()
    torch.cuda.empty_cache()
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
#
# Phases 7 (mixtral-8x22b, moe, depth 8) and 8 (llava-next-34b, vlm,
# depth 16) are held the same way, to limits set before their first run
# on the card: the decode step to jamba's 5e-2 at mixtral's depth of 8
# and to 1e-1 at llava's 16 (between jamba's 8 and rwkv6-7b's 32 layers);
# the first layer's appended K/V, which the decode computes from the
# token's embedding alone, to 2e-2 (one bf16 step of its largest
# magnitude is 3.9e-3).  The limits of the earlier paths are unchanged.
#
# Phases 9 (deepseek-v2, MLA, depth 4) and 10 (seamless-m4t, enc-dec, 24 +
# 24 layers) have limits of their own, keyed by path and set before their
# first run on the card: MLA's decode attends in f32 over the latent where
# its prefill and the forward attend in bf16 through flash, as the
# reference's do, and its depth is 4: mixtral's 5e-2.  The first layer's
# cache entries, which a decode step computes from the token's embedding
# alone, as the other paths: 2e-2 (seamless's cross K/V come from the
# same encoder run on the same frames).  Seamless's decode step was first
# held to rwkv6-7b's 0.15 (72 sublayers against its 64) and read 1.91e-2.
# That left a fault confined to the cross-attention decode, which no
# compared cache can show, free to move the logits by up to 8x the sound
# reading.  Planted (the cross query roped at pos - 1), such a fault read
# 3.31e-2 against the sound 1.91e-2 (NVIDIA H100 80GB HBM3, 700 W): the
# limit sits between the two.
TOL_FORWARD = 2e-2
TOL_DECODE = {"ssm": 1.5e-1, "hybrid": 5e-2, "moe": 5e-2, "vlm": 1e-1,
              "mla": 5e-2, "encdec": 2.5e-2}
TOL_STATE = {"ssm": 2e-2, "hybrid": 1e-1, "moe": 2e-2, "vlm": 2e-2,
             "mla": 2e-2, "encdec": 2e-2}
MUST_MOVE_LOGITS = ("zero cache", "one lost state write", "zero self cache",
                    "zeroed cross cache", "cross cache from a causal encoder",
                    "cross query roped at pos - 1")


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
        if key in ("k", "v", "ckv", "krope"):
            a, b = a[:, :, :n], b[:, :, :n]
        elif key in ("conv", "ssm"):
            a, b = a.flatten(0, 1), b.flatten(0, 1)
        d = (a.float() - b.float()).abs().flatten(1).amax(1)
        m = b.float().abs().flatten(1).amax(1).clamp_min(1e-30)
        out[key] = (d / m).tolist()
    return out


def holder(cfg, fails):
    """``hold(name, err, tol)``: log a reading against its limit and, past
    it, add it to ``fails`` (the path runs on; ``main`` fails at the end)."""
    def hold(name, err, tol):
        ok = err < tol
        log(f"  {name}: {err:.4e} (tol {tol:g}){'' if ok else '  FAILED'}")
        if not ok:
            fails.append(f"{cfg.name} {name}: {err} vs {tol}")
    return hold


def first_layer(errs) -> float:
    """The largest error at the first layer of each cache entry (jamba's
    k and v: its attention slot, after four mamba layers)."""
    return max(e[0] for e in errs.values())


def path_of(cfg) -> str:
    """The key of ``cfg``'s limits in ``TOL_DECODE`` / ``TOL_STATE``."""
    return "mla" if cfg.use_mla else "encdec" if cfg.enc_dec else cfg.family


def serve_path(torch, np, card, wrappers, cfg, params, B, expect, expect_fwd,
               S=1024, n_dec=32, seed=2, frames=None, routing=None):
    """``cfg`` at full width from ``params`` on the card: B prompts of S
    tokens (seeded by ``seed``; enc-dec: target tokens after ``frames``)
    through ``lm.prefill``, then n_dec greedy ``lm.decode_step``s carrying
    the cache (counted: ``expect`` launches), then two profiled steps.
    Then ``lm.forward_logits`` on the prompt and on the whole sequence and
    ``lm.prefill`` on the sequence (each counted apart: ``expect_fwd``;
    held to the run's MoE picks where ``routing``), held to the prefill's
    logits, the last decode step's logits (``TOL_DECODE[path_of(cfg)]``)
    and the first layer of each carried cache entry (``TOL_STATE``); then
    the ``planted_faults``, each of which must fail one of the two.
    Returns (the path's launch counts, the failed checks)."""
    from repro_torch.models import lm

    fails = []
    hold = holder(cfg, fails)
    path = path_of(cfg)
    key = "tgt_tokens" if cfg.enc_dec else "tokens"
    prompt = torch.as_tensor(np.random.RandomState(seed).randint(
        1, cfg.vocab, size=(B, S)), device="cuda")

    def batch_of(tokens):
        return {key: tokens, **({} if frames is None else
                                {"frames": frames})}

    if routing:
        routing.record()
    reset(wrappers)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    # 2 more positions: the profiled steps after the counted run
    max_len = S + n_dec + 2
    last, cache = lm.prefill(params, batch_of(prompt), cfg, max_len=max_len)
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
    src = "" if frames is None else f"{frames.shape[1]} frames + "
    log(f"  {cfg.name} [{card}]: B={B} x ({src}{S} prompt tokens); prefill "
        f"{t_prefill:.3f} s, then {n_dec} decode steps "
        f"{(wall - t_prefill) / n_dec * 1e3:.2f} ms each; wall "
        f"{wall:.3f} s = {B * n_dec / wall:.2f} decoded tokens per wall "
        f"second (prefill included); max_memory_allocated "
        f"{peak / 2**30:.2f} GiB")

    spare = _clone(cache)
    decode_profile(torch, lambda j: lm.decode_step(
        params, tok, spare, S + n_dec + j, cfg), card)
    del spare

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
        out = run(params, batch_of(seq[:, :n]), cfg)
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
        log(f"  forwards and prefill held to the run's MoE picks: "
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
        same = rel_err(lm.forward_logits(params, batch_of(other), cfg)
                       [:, S - 1], ref[:, S - 1])
        log(f"  forward on {S + n_dec} tokens, its last {n_dec} changed, "
            f"at position {S - 1}: {same:.4e} of the largest logit")
    errs = state_errs(cache, ref_cache, S + n_dec)
    for name, e in errs.items():
        idx = sorted({i for i in (0, 1, 3, len(e) // 2, len(e) - 1)
                      if i < len(e)})
        log(f"  carried {name} vs prefill on the sequence, by layer "
            + ", ".join(f"{i}: {e[i]:.2e}" for i in idx))

    # the checks
    ref_last = ref[:, -1]
    for label, ours, theirs, tol in (
            ("prefill last logits vs forward", last[:, 0],
             fwd["forward_logits on the prompt"][:, -1], TOL_FORWARD),
            ("last decode step logits vs forward", logits[:, 0], ref_last,
             TOL_DECODE[path])):
        agree = int((ours.argmax(-1) == theirs.argmax(-1)).sum())
        log(f"  {label}: max_abs_err {max_err(ours, theirs):.4e}, largest "
            f"logit {float(theirs.abs().max()):.3f}, argmax agrees on "
            f"{agree}/{B} rows")
        hold(f"{label} (relative)", rel_err(ours, theirs), tol)
    hold("carried states vs prefill on the sequence, first layer of each "
         "entry", first_layer(errs), TOL_STATE[path])

    # planted faults in the last decode step's inputs: each must miss
    faults = planted_faults(torch, cfg, params, B, max_len, kept,
                            S + n_dec - 1, frames)
    for name, (bad, p, swap) in faults.items():
        with swap:
            lg, bad = lm.decode_step(params, seq[:, -1:], bad, p, cfg)
        got = {"logits": (rel_err(lg[:, 0], ref_last), TOL_DECODE[path]),
               "states": (first_layer(state_errs(bad, ref_cache, S + n_dec)),
                          TOL_STATE[path])}
        seen = [what for what, (e, tol) in got.items() if e > tol]
        log(f"  fault '{name}': " + ", ".join(
            f"{what} {e:.4e} (limit {tol:g})" for what, (e, tol)
            in got.items()) + f"; caught by {' and '.join(seen) or 'NEITHER'}")
        if not seen or (name in MUST_MOVE_LOGITS and "logits" not in seen):
            fails.append(f"{cfg.name} fault '{name}' caught by {seen}")
    del fwd, ref, ref_cache, faults, kept, bad, lg
    del cache, logits, last
    gc.collect()
    torch.cuda.empty_cache()
    return launches, fails


@contextlib.contextmanager
def swapped(mod, name, wrap):
    """``mod.name`` replaced by ``wrap(mod.name)`` inside the block."""
    old = getattr(mod, name)
    setattr(mod, name, wrap(old))
    try:
        yield
    finally:
        setattr(mod, name, old)


def planted_faults(torch, cfg, params, B, max_len, kept, pos, frames):
    """Faults planted in the last decode step's inputs, as {name: (cache,
    position, a context the step runs in)}: from ``kept``, the caches
    before the last two steps (the older one has lost the last write)."""
    from repro_torch.models import layers as L
    from repro_torch.models import lm

    stale, before = kept
    none = contextlib.nullcontext()
    if cfg.enc_dec:
        return {
            "zero self cache": (dict(_clone(before), k=torch.zeros_like(
                before["k"]), v=torch.zeros_like(before["v"])), pos, none),
            "zeroed cross cache": (dict(_clone(before), cross_k=(
                torch.zeros_like(before["cross_k"])), cross_v=(
                torch.zeros_like(before["cross_v"]))), pos, none),
            "position off by one": (_clone(before), pos - 1, none),
            "cross cache from a causal encoder": (dict(
                _clone(before), **causal_cross(torch, cfg, params, frames)),
                pos, none),
            # the self-attention sound, the cross query alone off: only
            # the logits can see it
            "cross query roped at pos - 1": (_clone(before), pos, swapped(
                L, "cross_attention_decode",
                lambda f: lambda x, p, c, kc, vc, at: f(x, p, c, kc, vc,
                                                        at - 1)))}
    faults = {"zero cache": (lm.init_cache(cfg, B, max_len, device="cuda"),
                             pos, none),
              "one lost state write": (stale, pos, none)}
    if cfg.family == "ssm":
        faults["shift_tm dropped"] = (dict(_clone(before), shift_tm=(
            torch.zeros_like(before["shift_tm"]))), pos, none)
    elif not cfg.use_mla:
        faults["conv state dropped"] = (dict(_clone(before), conv=(
            torch.zeros_like(before["conv"]))), pos, none)
    if cfg.family != "ssm":
        faults["position off by one"] = (_clone(before), pos - 1, none)
    return faults


# ---------------------------------------------------------------------------
# phases 7-8: the moe (mixtral-8x22b) and vlm (llava-next-34b) families
# ---------------------------------------------------------------------------
def moe_vlm_paths(torch, np, card):
    """Phase 7: mixtral-8x22b at full width, depth cut from 56 to 8,
    served through ``MultiWorkerServer`` past its 4096-token window, then
    held one session alone (``held_path``, paged).  Phase 8: llava-next-34b
    at full width, depth cut from 60 to 16, with its 2048-patch stream
    (``held_path``, contiguous cache), then one text-only session through
    ``Engine(paged=True)``.  Returns the launches by path."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models.routing_replay import SameRouting
    from repro_torch.models import lm
    from repro_torch.serving.server import AgentRequest

    wrappers = all_wrappers()
    none = dict.fromkeys(wrappers, 0)
    by_path, fails = {}, []
    log("phase 7: mixtral-8x22b (depth 8) served past its window")
    cfg = dataclasses.replace(get_config("mixtral-8x22b"), n_layers=8)
    params = ready(torch, lm, cfg)
    reqs = served_tasks(np, cfg, AgentRequest, n_tasks=3, first=4608)
    by_path["serve mixtral-8x22b depth 8"], _ = serve_paged(
        torch, np, card, cfg, params, reqs, max_len=8192)
    gc.collect()                  # the runtime and its engines hold cycles
    torch.cuda.empty_cache()
    n = cfg.n_layers
    by_path["mixtral-8x22b depth 8 alone"], f = held_path(
        torch, np, card, wrappers, cfg, params, 4608,
        {**none, "flash_prefill": n, "paged_append": 16 * n,
         "paged_decode": 16 * n},
        {**none, "flash_prefill": n}, paged=True,
        routing=SameRouting())
    fails += f
    del params
    gc.collect()
    torch.cuda.empty_cache()

    log("phase 8: llava-next-34b (depth 16) with its patch stream")
    cfg = dataclasses.replace(get_config("llava-next-34b"), n_layers=16)
    params = ready(torch, lm, cfg)
    n = cfg.n_layers
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    patches = (torch.randn(1, cfg.n_frontend_tokens, cfg.d_model,
                           generator=gen, device="cuda") * 0.02
               ).to(torch.bfloat16)
    by_path["llava-next-34b depth 16 patches"], f = held_path(
        torch, np, card, wrappers, cfg, params, 512,
        {**none, "flash_prefill": n, "paged_append": 16 * n,
         "paged_decode": 16 * n},
        {**none, "flash_prefill": n}, paged=False, patches=patches)
    fails += f
    by_path["llava-next-34b text-only engine"] = text_engine(
        torch, np, card, wrappers, cfg, params)
    del params, patches
    gc.collect()
    torch.cuda.empty_cache()
    if fails:
        raise AssertionError("; ".join(fails))
    return by_path


def ready(torch, lm, cfg):
    """``cfg``'s seed-0 random bf16 params made on the card."""
    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"  {cfg.name} ({cfg.n_layers} layers) params ready in "
        f"{time.perf_counter() - t0:.1f} s; memory_allocated "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    return params


def held_path(torch, np, card, wrappers, cfg, params, S, expect,
              expect_fwd, paged, patches=None, routing=None):
    """One session alone at full width: an S-token prompt (after the
    patch stream, where given) through ``lm.prefill``, then 16 greedy
    decode steps (counted: ``expect`` launches) at positions counted with
    the patches.  With ``paged`` the prefill's K/V is scattered into pool
    blocks through a shuffled block table, as the engine's pool holds it,
    and the steps run ``lm.decode_step_paged``; without it
    ``lm.decode_step`` over the contiguous cache.  Then two
    profiled steps, ``lm.forward_logits`` on the whole sequence (held to
    the recorded MoE picks, ``expect_fwd`` launches) and ``lm.prefill`` on
    it; the last step's logits are held to the forward's (TOL_DECODE),
    the first layer's K/V to that prefill's (TOL_STATE), and faults
    planted in the last step's inputs must fail one of the two.  Returns
    (the launches, the failed checks)."""
    import dataclasses

    from repro_torch.models import lm

    n_dec, blk = 16, 16
    P = 0 if patches is None else patches.shape[1]
    n = P + S + n_dec                      # positions after the last step
    max_len = n + 2                        # and the two profiled steps
    fails = []
    hold = holder(cfg, fails)
    prompt = torch.as_tensor(np.random.RandomState(3).randint(
        1, cfg.vocab, size=(1, S)), device="cuda")
    batch = {"tokens": prompt}
    if patches is not None:
        batch["patches"] = patches
    i32 = lambda *v: torch.tensor(v, dtype=torch.int32,  # noqa: E731
                                  device="cuda")
    nb = -(-max_len // blk)
    nblocks = nb + 7                       # a few blocks no row uses
    table = torch.as_tensor(np.random.RandomState(5).permutation(nblocks)
                            [:nb], dtype=torch.int32, device="cuda")
    tables = table[None]

    def dest(p):
        """The append destination of position p: (block, offset)."""
        return table[p // blk:p // blk + 1].clone(), i32(p % blk)

    def step(tok, state, p, c=cfg, where=None):
        if not paged:
            return lm.decode_step(params, tok, state, p, c)[0]
        ablk, aoff = where or dest(p)
        return lm.decode_step_paged(params, tok, state["k"], state["v"],
                                    tables, i32(p), ablk, aoff, c)[0]

    def first_kv(state):
        """Layer 0's K and V at positions 0 .. n-1."""
        if not paged:
            return state["k"][0, 0, :n], state["v"][0, 0, :n]
        t = torch.arange(n, device="cuda")
        return tuple(state[key][0][table[t // blk].long(), t % blk]
                     for key in ("k", "v"))

    if routing:
        routing.record()
    reset(wrappers)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    last, cache = lm.prefill(params, batch, cfg,
                             max_len=None if paged else max_len)
    if paged:                              # into blocks, as the engine does
        shape = (cfg.n_layers, nblocks, blk, cfg.n_kv_heads, cfg.head_dim)
        state = {key: torch.zeros(shape, dtype=torch.bfloat16,
                                  device="cuda") for key in ("k", "v")}
        t = torch.arange(P + S, device="cuda")
        for key in ("k", "v"):
            state[key][:, table[t // blk].long(), t % blk] = cache[key][:, 0]
        del cache
    else:
        state = cache
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    toks, tok, kept = [prompt], last.argmax(-1), []
    for j in range(n_dec):
        if j >= n_dec - 2:          # the planted faults start from these
            kept.append(_clone(state))
        toks.append(tok)
        logits = step(tok, state, P + S + j)
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
    log(f"  {cfg.name} [{card}]: {P} patches + {S} prompt tokens; prefill "
        f"{t_prefill:.3f} s, then {n_dec} {'paged ' if paged else ''}decode "
        f"steps {(wall - t_prefill) / n_dec * 1e3:.2f} ms each; "
        f"max_memory_allocated {peak / 2**30:.2f} GiB")
    spare = _clone(state)
    decode_profile(torch, lambda j: step(tok, spare, n + j), card)
    del spare

    seq = torch.cat(toks, dim=1)                    # (1, S + n_dec)
    full = dict(batch, tokens=seq)
    if routing:
        picks = routing.by_position(1, P + S, n_dec)
        routing.replay([(p.flatten(0, 1), i.flatten(0, 1))
                        for p, i in picks])
        last_gap = min(float((srt[0, -1, 1] - srt[0, -1, 2]))
                       for srt in (p.sort(-1, descending=True).values
                                   for p, _ in picks))
    reset(wrappers)
    ref = lm.forward_logits(params, full, cfg)
    torch.cuda.synchronize()
    if routing:
        routing.restore()
    log(f"  forward_logits on the sequence ({n} positions), launches "
        f"(apart): {counts(wrappers)}")
    if counts(wrappers) != expect_fwd:
        raise AssertionError(f"{cfg.name}: forward launches "
                             f"{counts(wrappers)}, expected {expect_fwd}")
    if not bool(ref.isfinite().all()) or ref.shape != (1, n, cfg.vocab):
        raise AssertionError(f"{cfg.name}: forward logits {ref.shape}, "
                             f"finite {bool(ref.isfinite().all())}")
    if routing:
        log(f"  forward held to the served MoE picks: {routing.flips} "
            f"near-tie flips; the last step's smallest gap between the 2nd "
            f"and 3rd router probability, over the layers: {last_gap:.3e}")
    log(f"  prefill's last logits vs the forward at position {P + S - 1} "
        f"(reported; GEMM shapes differ): "
        f"{rel_err(last[:, 0], ref[:, P + S - 1]):.4e} of the largest logit")
    ref_last = ref[:, -1]
    del ref
    cache = lm.prefill(params, full, cfg)[1]
    ref_kv = (cache["k"][0, 0].clone(), cache["v"][0, 0].clone())
    del cache

    def state_err(state):
        return max(rel_err(a, b) for a, b in zip(first_kv(state), ref_kv))

    agree = bool(logits[:, 0].argmax(-1) == ref_last.argmax(-1))
    log(f"  last decode step vs forward: max_abs_err "
        f"{max_err(logits[:, 0], ref_last):.4e}, largest logit "
        f"{float(ref_last.abs().max()):.3f}, argmax agrees: {agree}")
    hold("last decode step logits vs forward (relative)",
         rel_err(logits[:, 0], ref_last), TOL_DECODE[cfg.family])
    hold("first layer's K/V vs prefill on the sequence (relative)",
         state_err(state), TOL_STATE[cfg.family])

    # planted faults in the last step's inputs: each must miss
    pos = n - 1
    stale, before = kept
    faults = {"zero cache": ({k: torch.zeros_like(v) for k, v in
                              before.items()}, pos, {})}
    if paged:
        faults["lost append (the row on the sentinel)"] = (
            _clone(before), pos, {"where": (i32(nblocks), i32(0))})
        faults["position off by one"] = (_clone(before), pos - 1, {})
        faults["sliding window off"] = (_clone(before), pos, {
            "c": dataclasses.replace(cfg, sliding_window=0)})
    else:
        faults["one lost state write"] = (stale, pos, {})
    if P:
        faults["positions without the patch offset"] = (_clone(before),
                                                        pos - P, {})
    for name, (bad, p, kw) in faults.items():
        lg = step(seq[:, -1:], bad, p, **kw)
        got = {"logits": (rel_err(lg[:, 0], ref_last),
                          TOL_DECODE[cfg.family]),
               "states": (state_err(bad), TOL_STATE[cfg.family])}
        seen = [what for what, (e, tol) in got.items() if e > tol]
        log(f"  fault '{name}': " + ", ".join(
            f"{what} {e:.4e} (limit {tol:g})" for what, (e, tol)
            in got.items()) + f"; caught by {' and '.join(seen) or 'NEITHER'}")
        if name == "sliding window off":
            proof = window_proof(torch, cfg, params, seq[:, -1:], before,
                                 tables, pos, dest(pos), fails)
            seen = seen or proof
        # unlike paths A and B (MUST_MOVE_LOGITS), one lost write need
        # only show in the K/V: on llava it moves the logits less than
        # TOL_DECODE["vlm"] allows the sound run (PERF.md)
        if not seen or (name == "zero cache" and "logits" not in seen):
            fails.append(f"{cfg.name} fault '{name}' caught by {seen}")
    del faults, kept, stale, before, bad, lg, state, ref_kv
    gc.collect()
    torch.cuda.empty_cache()
    return launches, fails


# ---------------------------------------------------------------------------
# phases 9-10: MLA (deepseek-v2) and the encoder-decoder (seamless-m4t)
# through lm.prefill / lm.decode_step
# ---------------------------------------------------------------------------
def mla_encdec_paths(torch, np, card):
    """Phase 9: deepseek-v2-236b at full width, depth cut from 60 to 4, B=2
    prompts of 1024 tokens, 16 decode steps over the latent cache.  Phase
    10: seamless-m4t-large-v2 at full width and depth, B=4, 1024 frames and
    a 256-token target prefix, 32 decode steps.  Both run before a failed
    check ends the script.  Returns the launches by path."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models.routing_replay import SameRouting
    from repro_torch.models import lm

    wrappers = all_wrappers()
    none = dict.fromkeys(wrappers, 0)
    by_path, fails = {}, []
    log("phase 9: deepseek-v2-236b (depth 4, MLA) through lm.prefill / "
        "lm.decode_step")
    cfg = dataclasses.replace(get_config("deepseek-v2-236b"), n_layers=4)
    params = ready(torch, lm, cfg)
    n = cfg.n_layers
    by_path["deepseek-v2-236b depth 4 MLA"], f = serve_path(
        torch, np, card, wrappers, cfg, params, 2,
        {**none, "flash_prefill": n}, {**none, "flash_prefill": n},
        n_dec=16, seed=9, routing=SameRouting())
    fails += f
    del params
    gc.collect()
    torch.cuda.empty_cache()

    log("phase 10: seamless-m4t-large-v2 (24 + 24 layers) through "
        "lm.prefill / lm.decode_step")
    cfg = get_config("seamless-m4t-large-v2")
    params = ready(torch, lm, cfg)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(10)
    frames = (torch.randn(4, 1024, cfg.d_model, generator=gen,
                          device="cuda") * 0.02).to(torch.bfloat16)
    n_enc, n_dec_layers, steps = cfg.n_enc_layers, cfg.n_dec_layers, 32
    by_path["seamless-m4t-large-v2 enc-dec"], f = serve_path(
        torch, np, card, wrappers, cfg, params, 4,
        {**none, "flash_prefill": n_enc + 2 * n_dec_layers,
         "paged_append": steps * n_dec_layers,
         "paged_decode": 2 * steps * n_dec_layers},
        {**none, "flash_prefill": n_enc + 2 * n_dec_layers},
        S=256, n_dec=steps, seed=9, frames=frames)
    fails += f
    del params, frames
    gc.collect()
    torch.cuda.empty_cache()
    if fails:
        raise AssertionError("; ".join(fails))
    return by_path


def causal_cross(torch, cfg, params, frames):
    """A planted fault: the cross caches (cross_k, cross_v) that a causal
    encoder would give, the encoder's attention run with causal=True."""
    from repro_torch.models import encdec
    from repro_torch.models import layers as L

    with swapped(L, "gqa_attention_full", lambda full: lambda *a, causal,
                 **kw: full(*a, causal=True, **kw)):
        enc = encdec._run_encoder(params, frames, cfg)
    kv = [encdec._cross_kv(encdec.lm._layer(params["dec_layers"]["cross"],
                                            i), enc)
          for i in range(cfg.n_dec_layers)]
    return {"cross_k": torch.stack([k for k, _ in kv]),
            "cross_v": torch.stack([v for _, v in kv])}


def window_proof(torch, cfg, params, tok, pools, tables, pos, where, fails):
    """The window at the model's first layer, shown whatever the logits
    show: the last step's layer-0 attention through the kernels (the
    append, then ``paged_decode`` with the window) must agree with
    ``paged_decode_plain`` with the window (else a failed check) and part
    from it without.  Returns ["first layer"] when it parts."""
    from repro_torch.kernels.paged_attention import ops as P
    from repro_torch.models import layers as L
    from repro_torch.models import lm

    lp = lm._layer(params["layers"], 0)
    h = L.rms_norm(lm.embed_tokens(params, tok, cfg), lp["ln1"],
                   cfg.norm_eps)
    p = torch.tensor([pos], dtype=torch.int32, device="cuda")
    q, k, v = L.gqa_qkv(h, lp["attn"], cfg, p[:, None])
    kp, vp = pools["k"][0].clone(), pools["v"][0].clone()
    P.paged_append(kp, vp, k[:, 0].contiguous(), v[:, 0].contiguous(),
                   *where)
    q = q[:, 0].contiguous()
    out = P.paged_decode(q, kp, vp, tables, p + 1, window=cfg.sliding_window)
    agree = max_err(out, P.paged_decode_plain(q, kp, vp, tables, p + 1,
                                              window=cfg.sliding_window))
    part = max_err(out, P.paged_decode_plain(q, kp, vp, tables, p + 1))
    log(f"  the window at layer 0 of the last step: the kernel vs the plain "
        f"version with window {cfg.sliding_window} {agree:.4e} (tol "
        f"{TOL_BF16:g}), without it {part:.4e} (must exceed {TOL_BF16:g})")
    if not agree < TOL_BF16:
        fails.append(f"{cfg.name}: layer 0's windowed attention {agree}")
    return ["first layer"] if part > TOL_BF16 else []


def text_engine(torch, np, card, wrappers, cfg, params):
    """Phase 8's text-only session through ``Engine(paged=True)`` (2
    slots, max_len 1024, 128 pool blocks), its prefills on the vlm's empty
    patch stream: a 512-token prompt, 16 decoded, a park, a resume with a
    64-token delta, 8 decoded, a release.  Exact launches; ids in range;
    no copy bytes; the block audit clean.  Returns the launches."""
    from repro_torch.serving.engine import Engine

    rng = np.random.RandomState(6)
    prompt = rng.randint(1, cfg.vocab, size=512).astype(np.int32)
    tool = rng.randint(1, cfg.vocab, size=64).astype(np.int32)
    eng = Engine(cfg, params, n_slots=2, max_len=1024, pool_blocks=128)
    reset(wrappers)
    t0 = time.perf_counter()
    s = eng.start_session("x", prompt, cached_hit=False)
    ids = eng.decode({s: int(prompt[-1])}, n_steps=16)[s]
    if not eng.park_session("x"):
        raise AssertionError("text-only engine: park failed")
    ctx = np.concatenate([prompt, np.asarray(ids, np.int32), tool])
    s = eng.start_session("x", ctx, cached_hit=True)
    ids += eng.decode({s: int(ctx[-1])}, n_steps=8)[s]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts(wrappers)
    n = cfg.n_layers
    want = {**dict.fromkeys(wrappers, 0), "flash_prefill": 2 * n,
            "paged_append": 24 * n, "paged_decode": 24 * n}
    log(f"  text-only session through Engine(paged=True) [{card}]: "
        f"prefill_tokens {eng.prefill_tokens} (512 + a 64-token delta), "
        f"24 decoded ids, wall {wall:.3f} s; launches {launches}")
    if launches != want:
        raise AssertionError(f"text-only engine: launches {launches}, "
                             f"expected {want}")
    if len(ids) != 24 or min(ids) < 0 or max(ids) >= cfg.vocab:
        raise AssertionError(f"text-only engine: ids {ids}")
    if eng.prefill_tokens != 576 or eng.park_copy_bytes \
            or eng.resume_copy_bytes:
        raise AssertionError(f"text-only engine: prefill_tokens "
                             f"{eng.prefill_tokens}, copy bytes "
                             f"{eng.park_copy_bytes}/{eng.resume_copy_bytes}")
    if not eng.release_session("x"):
        raise AssertionError("text-only engine: release failed")
    audit([eng], "text-only")
    return launches


# ---------------------------------------------------------------------------
# phase 11: training
# ---------------------------------------------------------------------------
# Step 0's loss through the training path (plain blocked attention in f32
# sums) against the cross-entropy of ``lm.forward_logits`` (flash_prefill)
# on the same batch: the bf16 TOL_BF16, relative.  A resumed run's losses
# against the uninterrupted run's: equal, or within TOL_RESTART relative
# where the embedding's backward (``index_put_`` with accumulate, CUDA
# atomics) sums in another order.  The ten tiny families, card against
# CPU: the loss within TOL_BF16 relative, every gradient leaf within
# TOL_BF16 of its largest magnitude (rwkv6's and jamba's read 1.2e-2 and
# 1.3e-2 in bf16 on an NVIDIA H100 80GB HBM3 at 700 W; against the JAX
# package on the CPU the port's part by up to 4.4e-2, which
# tests/test_torch_forward_train.py holds in f32 instead).
TOL_RESTART = 1e-3
TRAIN_ARCHS = ["jamba_v0_1_52b", "deepseek_v2_236b", "mixtral_8x22b",
               "command_r_35b", "mistral_nemo_12b", "qwen3_32b",
               "llama3_2_3b", "llava_next_34b", "rwkv6_7b",
               "seamless_m4t_large_v2"]


def named_leaves(tree, prefix=""):
    """(key path, tensor) of a nested dict, keys sorted."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in named_leaves(tree[k], f"{prefix}{k}/")]
    return [(prefix[:-1], tree)]


def clear_grads(params):
    for _, p in named_leaves(params):
        p.grad = None


def unreal_grads(torch, params):
    """The leaves whose gradient is missing, not finite or all zero."""
    bad = []
    for name, p in named_leaves(params):
        g = p.grad
        if g is None or not bool(torch.isfinite(g).all()) \
                or not bool(g.any()):
            bad.append(name)
    return bad


def mean_xent(torch, logits, labels):
    lse = torch.logsumexp(logits.float(), dim=-1)
    lab = logits.float().gather(-1, labels.long()[..., None])[..., 0]
    return float((lse - lab).mean())


def train_paths(torch, np, card):
    """Phase 11: ``train_llama`` then ``train_families``.  Both run before
    a failed check ends the script.  Returns the launches by path."""
    fails = []
    launches = train_llama(torch, np, card, fails)
    gc.collect()
    torch.cuda.empty_cache()
    train_families(torch, np, card, fails)
    if fails:
        raise AssertionError("; ".join(fails))
    return {"train llama3.2-3b": launches}


def train_llama(torch, np, card, fails):
    """llama3.2-3b at full width and depth, B=2 x 1024 ``SyntheticLM``
    tokens: step 0's loss against ``forward_logits`` (28 flash launches,
    the path's only ones); every gradient leaf real, and not under a
    planted detach of the attention output; ``train_loop`` for 12 AdamW
    steps at lr 3e-4 (no kernel launched, the loss falling; step time,
    tokens a second, peak memory, one profiled step); 6 steps with a
    checkpoint at 6, and a fresh ``train_loop(resume=True)`` from it
    (state bit-equal, batch 6's tokens, steps 6-11's losses).  Returns the
    launches of the loss check."""
    import tempfile
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.launch import train as T
    from repro_torch.models import layers as L
    from repro_torch.models import lm
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.data import SyntheticLM

    wrappers = all_wrappers()
    none = dict.fromkeys(wrappers, 0)
    cfg = get_config("llama3.2-3b")
    B, S, steps, lr = 2, 1024, 12, 3e-4
    half = steps // 2
    kw = dict(steps=steps, batch=B, seq=S, lr=lr, seed=0, log_every=1,
              device="cuda")
    params = ready(torch, lm, cfg)       # train_loop's seed-0 init
    batch0 = {k: torch.from_numpy(v).cuda()
              for k, v in SyntheticLM(cfg, B, S, seed=0).next().items()}
    reset(wrappers)
    with torch.no_grad():
        logits = lm.forward_logits(params, batch0, cfg)
        ref = mean_xent(torch, logits, batch0["labels"])
        del logits
    loss_launches = counts(wrappers)
    want = {**none, "flash_prefill": cfg.n_layers}
    if loss_launches != want:
        fails.append(f"train: forward_logits launches {loss_launches}, "
                     f"expected {want}")

    [p.requires_grad_(True) for _, p in named_leaves(params)]
    reset(wrappers)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = lm.forward_train(params, batch0, cfg)
    loss.backward()
    torch.cuda.synchronize()
    fb = time.perf_counter() - t0
    step0 = float(loss.detach())
    rel = abs(step0 - ref) / abs(ref)
    bad = unreal_grads(torch, params)
    n_leaves = len(named_leaves(params))
    log(f"  step 0 [{card}]: forward_train {step0:.6f} against "
        f"forward_logits' cross-entropy {ref:.6f} (flash_prefill, "
        f"{loss_launches['flash_prefill']} launches): {rel:.3e} relative "
        f"(tol {TOL_BF16:g}); forward + backward {fb:.3f} s, launches "
        f"{counts(wrappers)}; {n_leaves - len(bad)} of {n_leaves} gradient "
        f"leaves finite and nonzero")
    if not rel < TOL_BF16:
        fails.append(f"train: step 0's loss {step0} against {ref}")
    if counts(wrappers) != none:
        fails.append(f"train: step 0 launched {counts(wrappers)}")
    if bad:
        fails.append(f"train: gradients not real at step 0: {bad}")
    clear_grads(params)
    detach = lambda f: lambda *a, **k: f(*a, **k).detach()  # noqa: E731
    with swapped(L, "chunked_attention_train", detach):
        lm.forward_train(params, batch0, cfg).backward()
    planted = unreal_grads(torch, params)
    log(f"  planted fault, the attention output detached before wo: "
        f"gradients not real {planted} (must not be empty)")
    if not planted:
        fails.append("train: the detached attention output went unseen")
    del params, loss, batch0
    gc.collect()
    torch.cuda.empty_cache()

    rec = {"tokens": [], "step_s": [], "launches": [], "profile": None}

    class Recorded(SyntheticLM):
        def next(self):
            b = super().next()
            rec["tokens"].append(b["tokens"].copy())
            return b

    def timed_steps(make):
        def make_timed(*a, **k):
            step = make(*a, **k)

            def run(params, opt, batch):
                torch.cuda.synchronize()
                reset(wrappers)
                prof = None
                if len(rec["step_s"]) == 6:
                    prof = profile(activities=[ProfilerActivity.CPU,
                                               ProfilerActivity.CUDA])
                    prof.__enter__()
                t0 = time.perf_counter()
                out = step(params, opt, batch)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                if prof is not None:
                    prof.__exit__(None, None, None)
                    rec["profile"] = (wall, prof.key_averages())
                rec["step_s"].append(wall)
                rec["launches"].append(counts(wrappers))
                return out
            return run
        return make_timed

    recorded = lambda cls: Recorded  # noqa: E731
    torch.cuda.reset_peak_memory_stats()
    with swapped(T, "SyntheticLM", recorded), \
            swapped(T, "make_train_step", timed_steps):
        losses = T.train_loop("llama3.2-3b", **kw)[2]
    peak = torch.cuda.max_memory_allocated() / 2**30
    gc.collect()
    torch.cuda.empty_cache()
    times = rec["step_s"]
    rest = times[1:6] + times[7:]          # no warm-up, no profiler
    steady = sorted(rest)[len(rest) // 2]
    wall, evts = rec["profile"]
    busy = sum(_dev_us(e) for e in evts) / 1e6
    log(f"  train_loop llama3.2-3b, {steps} steps of {B} x {S} tokens "
        f"[{card}]: losses {[round(x, 4) for x in losses]}; step times "
        f"{[round(t, 3) for t in times]} s; steady step {steady:.3f} s = "
        f"{B * S / steady:.0f} tokens/s; peak max_memory_allocated "
        f"{peak:.2f} GiB")
    log(f"  profiled step 6 [{card}]: wall {wall:.3f} s, device busy "
        f"{busy:.3f} s = {100 * busy / wall:.1f}% (idle "
        f"{100 * (1 - busy / wall):.1f}%), "
        f"{sum(e.count for e in evts if _dev_us(e))} kernel launches")
    for e in sorted(evts, key=_dev_us, reverse=True)[:8]:
        log(f"    device {_dev_us(e) / 1e3:9.3f} ms  calls {e.count:6d}  "
            f"{e.key[:90]}")
    if any(n != none for n in rec["launches"]):
        fails.append(f"train: a training step launched a kernel: "
                     f"{rec['launches']}")
    if not losses[-1] < losses[0]:
        fails.append(f"train: the loss did not fall: {losses}")
    whole_tokens = rec["tokens"]

    with tempfile.TemporaryDirectory() as d:
        rec["tokens"] = []
        t0 = time.perf_counter()
        with swapped(T, "SyntheticLM", recorded):
            p4, o4, first = T.train_loop("llama3.2-3b", **{
                **kw, "steps": half}, ckpt_dir=d, ckpt_every=half)
        part = time.perf_counter() - t0
        size = sum(f.stat().st_size for f in Path(d).iterdir()) / 2**30
        # the saving run's state stays on the card (29.5 GiB) until the
        # restored one (as much again) is compared with it
        saved = [state_items(p4, o4)]
        del p4, o4
        diff = []

        def restore_checked(restore):
            def call(*a, **k):
                torch.cuda.synchronize()
                t = time.perf_counter()
                step, params, opt, meta = restore(*a, **k)
                torch.cuda.synchronize()
                rec["restore_s"] = time.perf_counter() - t
                got, want = state_items(params, opt), saved.pop()
                diff.extend(n for n in want if n not in got
                            or got[n].dtype != want[n].dtype
                            or not torch.equal(got[n], want[n]))
                del want
                gc.collect()
                torch.cuda.empty_cache()
                return step, params, opt, meta
            return call

        rec["tokens"] = []
        with swapped(T, "SyntheticLM", recorded), \
                swapped(ckpt, "restore_checkpoint", restore_checked):
            resumed = T.train_loop("llama3.2-3b", **kw, ckpt_dir=d,
                                   resume=True)[2]
    gc.collect()
    torch.cuda.empty_cache()
    same_batch = bool(rec["tokens"]) and np.array_equal(
        rec["tokens"][0], whole_tokens[half])
    gap = max(abs(a - b) / abs(b) for a, b in zip(resumed, losses[half:]))
    how = ("equal" if resumed == losses[half:] else
           f"within {gap:.3e} relative" if gap < TOL_RESTART else
           f"{gap:.3e} apart")
    log(f"  restart [{card}]: {half} steps and a checkpoint ({size:.2f} GiB "
        f"on disk) in {part:.1f} s, losses {[round(x, 4) for x in first]}; "
        f"restored in {rec['restore_s']:.1f} s, {len(diff)} leaves "
        f"differing from the saved state; first batch equal to batch "
        f"{half}: {same_batch}; steps {half}-{steps - 1} {resumed} against "
        f"{losses[half:]}: {how}")
    if diff:
        fails.append(f"train: restored state differs at {diff[:4]}")
    if not same_batch:
        fails.append(f"train: the resumed run did not start at batch "
                     f"{half}")
    if not (len(resumed) == steps - half and gap < TOL_RESTART):
        fails.append(f"train: resumed losses {resumed} against "
                     f"{losses[half:]}")
    return loss_launches


def state_items(params, opt):
    """The checkpoint's keys to the tensors of a params tree and an
    ``OptState``."""
    out = {f"params/{n}": v.detach() for n, v in named_leaves(params)}
    out.update({f"opt/.mu/{n}": v for n, v in named_leaves(opt.mu)})
    out.update({f"opt/.nu/{n}": v for n, v in named_leaves(opt.nu)})
    out["opt/.step"] = opt.step
    return out


def tiny_train_batch(torch, np, cfg, B=2, S=32):
    rng = np.random.RandomState(11)
    ints = lambda: torch.from_numpy(rng.randint(0, cfg.vocab,  # noqa
                                                size=(B, S)))
    emb = lambda n: torch.from_numpy((rng.randn(B, n, cfg.d_model)  # noqa
                                      * 0.02).astype(np.float32)).bfloat16()
    if cfg.enc_dec:
        return {"frames": emb(24), "tgt_tokens": ints(), "tgt_labels": ints()}
    batch = {"tokens": ints(), "labels": ints()}
    if cfg.family == "vlm":
        batch["patches"] = emb(8)
    return batch


def train_families(torch, np, card, fails):
    """The ten tiny configs: one ``forward_train`` + backward on the card
    and on the CPU from the same seeded params and batch (2 x 32 tokens in
    attention and loss blocks of 16), no kernel launched on the card; the
    MoE archs' card run held to the CPU run's router picks."""
    import importlib
    from repro_torch.models import lm
    from repro_torch.models.routing_replay import SameRouting

    wrappers = all_wrappers()
    opts = {"attn_block": 16, "loss_chunk": 16}
    for mod in TRAIN_ARCHS:
        cfg = importlib.import_module(f"repro_torch.configs.{mod}").tiny()
        init = lm.init_params(cfg, seed=11, device="cpu")
        batch = tiny_train_batch(torch, np, cfg)
        picks = SameRouting() if cfg.n_experts else None
        out = {}
        for dev in ("cpu", "cuda"):
            if picks is not None:
                (picks.record if dev == "cpu" else picks.replay)()
            leaves = [(n, t.detach().to(dev).clone().requires_grad_(True))
                      for n, t in named_leaves(init)]
            reset(wrappers)
            loss = lm.forward_train(_tree(leaves), _to(batch, dev), cfg,
                                    opts=opts)
            loss.backward()
            if dev == "cuda" and any(counts(wrappers).values()):
                fails.append(f"{cfg.name}: training launched "
                             f"{counts(wrappers)}")
            out[dev] = (float(loss.detach()),
                        {n: c.grad.float().cpu() for n, c in leaves})
        if picks is not None:
            picks.restore()
        (lc, g_cpu), (lg, g_card) = out["cpu"], out["cuda"]
        worst = max((float((g_card[n] - g).abs().max())
                     / max(float(g.abs().max()), 1e-30), n)
                    for n, g in g_cpu.items())
        log(f"  {cfg.name} card vs CPU [{card}]: loss {lg:.6f} / {lc:.6f} "
            f"({abs(lg - lc) / abs(lc):.2e}), worst gradient leaf "
            f"{worst[1]} {worst[0]:.2e} of its max (tol {TOL_BF16:g})")
        if not abs(lg - lc) < TOL_BF16 * abs(lc):
            fails.append(f"{cfg.name}: card loss {lg} against {lc}")
        if not worst[0] < TOL_BF16:
            fails.append(f"{cfg.name}: gradient {worst[1]} "
                         f"{worst[0]:.3e} of its max")


def _tree(items):
    """A nested dict from (key path, value) pairs."""
    out = {}
    for name, v in items:
        *path, last = name.split("/")
        d = out
        for k in path:
            d = d.setdefault(k, {})
        d[last] = v
    return out


# ---------------------------------------------------------------------------
# phase 12: production layouts
# ---------------------------------------------------------------------------
# In a child process (``--layouts``), so the fake process group never meets
# phases 1-11's state.  The meshes are DTensor ``DeviceMesh``es on "cuda"
# over ``launch.mesh.fake_world(512)``: this process is rank 0, so the card
# is rank 0's device, and only rank 0's shards exist.  Per-device bytes
# count params, AdamW moments, caches and inputs, not activations (that is
# the dry run's, ROADMAP Queue 1 item 3).
LAYOUT_MESHES = ("16x16", "2x16x16", "8x8")
PLACE_ARCH, PLACE_MESH = "deepseek-v2-236b", "8x8"
# memory_allocated counts the caching allocator's blocks: a request is
# rounded up to 512 bytes, and one of more than 1 MiB may take up to 1 MiB
# more of its segment unsplit (8,273,920 bytes over 57 leaves on the H100);
# the requested bytes (``memory_stats``' "requested_bytes") carry none of it
PLACE_SLACK = 1 << 20       # bytes a leaf memory_allocated may add
GIB = 2 ** 30


def layouts_phase(card: str) -> None:
    """Phase 12: ``layouts_main`` in a child process; fails unless the
    child exits 0."""
    sys.stdout.flush()
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                          "--layouts", card], timeout=600)
    log(f"  phase 12 wall with the child's start "
        f"{time.perf_counter() - t0:.1f} s")
    if res.returncode:
        raise AssertionError(f"phase 12 (production layouts) failed: exit "
                             f"{res.returncode}")


def spec_leaves(tree, path=()):
    """[(key path, leaf)] of nested dicts, NamedTuples and tuples; a
    None is a leaf."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    elif type(tree) in (tuple, list):
        items = enumerate(tree)
    else:
        return [("/".join(map(str, path)), tree)]
    return [item for k, v in items for item in spec_leaves(v, path + (k,))]


def sharded_bytes(pairs, mesh, fails, where):
    """Bytes a device holds of (leaf, sharding) pairs.  Each leaf's local
    shape from DTensor's placements must equal the one its spec
    implies."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    total = 0
    for path, leaf, sh in pairs:
        shape = tuple(leaf.shape)
        if sh is None:
            local = shape
        else:
            local = sh.shard_shape(shape)
            got, _ = compute_local_shape_and_global_offset(
                shape, mesh, sh.placements)
            if tuple(got) != local:
                fails.append(f"{where} {path}: local shape {tuple(got)} "
                             f"where its spec {sh.spec} gives {local}")
        n = 1
        for d in local:
            n *= d
        total += n * leaf.element_size()
    return total


def cell_bytes(lm, cfg, cell, info, mesh, fails, where):
    """{params, moments, cache, inputs}: bytes a device of ``cell``
    (``specs.input_specs``)."""
    args, ins = cell["args"], cell["in_shardings"]

    def pairs(tree, shs):
        a, b = spec_leaves(tree), dict(spec_leaves(shs))
        return [(k, leaf, b[k]) for k, leaf in a]

    out = {"params": sharded_bytes(pairs(args[0], ins[0]), mesh,
                                   fails, where)}
    kind, B, S = info["kind"], info["batch"], info["seq"]
    if kind == "train":
        out["moments"] = sum(sharded_bytes(pairs(t, s), mesh, fails, where)
                             for t, s in ((args[1].mu, ins[1].mu),
                                          (args[1].nu, ins[1].nu)))
        out["inputs"] = sharded_bytes(pairs(args[2], ins[2]), mesh,
                                      fails, where)
    elif kind == "prefill":
        cache = lm.abstract_cache(cfg, B, S)
        out["cache"] = sharded_bytes(pairs(cache, cell["out_shardings"][1]),
                                     mesh, fails, where)
        out["inputs"] = sharded_bytes(pairs(args[1], ins[1]), mesh,
                                      fails, where)
    else:
        out["cache"] = sharded_bytes(pairs(args[2], ins[2]), mesh,
                                     fails, where)
        out["inputs"] = sharded_bytes(
            pairs((args[1], args[3]), (ins[1], ins[3])), mesh, fails, where)
    return out


def layout_table(torch, lm, S, ShardingEnv, get_config, archs, meshes,
                 card, fails):
    """Phase 12 (a): every supported (arch x shape) cell on each mesh, its
    bytes a device against the card's memory.  Returns {(mesh, arch,
    shape): bytes}."""
    cap = torch.cuda.get_device_properties(0).total_memory
    log(f"  bytes a device (GiB) of params (their dtypes: bf16, mamba's "
        f"A_log f32), AdamW mu + nu (f32; train cells), cache (decode "
        f"cells; a prefill's output cache) and inputs; activations not "
        f"counted; against the card's {cap / GIB:.2f} GiB [{card}]")
    log(f"  {'mesh':8} {'arch':22} {'shape':12} {'params':>8} "
        f"{'moments':>8} {'cache':>8} {'inputs':>8} {'total':>8}")
    table = {}
    for mname in LAYOUT_MESHES:
        mesh = meshes[mname]
        env = ShardingEnv(mesh)
        for arch in archs:
            cfg = get_config(arch)
            for shape in S.SHAPES:
                if not S.cell_supported(cfg, shape)[0]:
                    continue
                where = f"{mname} {arch} {shape}"
                cell = S.input_specs(cfg, shape, env)
                b = cell_bytes(lm, cfg, cell, S.SHAPES[shape], mesh, fails,
                               where)
                table[(mname, arch, shape)] = b
                tot = sum(b.values())
                log(f"  {mname:8} {arch:22} {shape:12} "
                    + " ".join(f"{b.get(k, 0) / GIB:8.3f}" for k in
                               ("params", "moments", "cache", "inputs"))
                    + f" {tot / GIB:8.3f} "
                    + ("fits" if tot < cap else "OVER the card"))
    return table


def strided_check(S, ShardingEnv, get_config, archs, meshes, card, fails):
    """``serve_fullshard``'s decode cells, whose KV sequence dim runs over
    ("model", "data") against the mesh's order (``_StridedShard``): every
    leaf's local shape as its spec implies."""
    n_cells = n_strided = 0
    for mname in LAYOUT_MESHES:
        env = ShardingEnv(meshes[mname], {"serve_fullshard": True})
        for arch in archs:
            cfg = get_config(arch)
            for shape, info in S.SHAPES.items():
                if info["kind"] != "decode" or \
                        not S.cell_supported(cfg, shape)[0]:
                    continue
                cell = S.input_specs(cfg, shape, env)
                shs = dict(spec_leaves(cell["in_shardings"]))
                pairs = [(k, leaf, shs[k])
                         for k, leaf in spec_leaves(cell["args"])]
                sharded_bytes(pairs, meshes[mname], fails,
                              f"{mname} {arch} {shape} serve_fullshard")
                n_cells += 1
                n_strided += sum(
                    1 for _, _, sh in pairs if sh is not None and
                    ("model", "data") in tuple(sh.spec))
    log(f"  serve_fullshard decode: {n_cells} cells, {n_strided} cache "
        f"leaves with the sequence over (\"model\", \"data\"), local shapes "
        f"checked [{card}]")
    if not n_strided:
        fails.append("serve_fullshard: no leaf over (\"model\", \"data\")")


def place_rank0(torch, lm, ShardingEnv, get_config, mesh, table, card,
                fails):
    """Phase 12 (b): rank 0's shards of PLACE_ARCH at full depth on the
    PLACE_MESH mesh, params and AdamW moments, allocated on the card and
    filled from a seeded CUDA generator, each wrapped as a DTensor of the
    global shape.  The rise in the allocator's requested bytes must equal
    the table's bytes, and that in ``memory_allocated`` them within
    PLACE_SLACK a leaf."""
    from repro_torch.train.optimizer import abstract_opt_state, opt_pspecs
    cfg = get_config(PLACE_ARCH)
    env = ShardingEnv(mesh)
    ap = lm.abstract_params(cfg)
    psh = lm.param_shardings(cfg, env)
    osh, aopt = opt_pspecs(psh), abstract_opt_state(ap)
    b = table[(PLACE_MESH, PLACE_ARCH, "train_4k")]
    want = b["params"] + b["moments"]

    def requested():
        return torch.cuda.memory_stats()["requested_bytes.all.current"]

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base, base_req = torch.cuda.memory_allocated(), requested()
    t0 = time.perf_counter()
    placed = placed_shards(torch, mesh, ((ap, psh, "normal_"),
                                         (aopt.mu, osh.mu, "normal_"),
                                         (aopt.nu, osh.nu, "uniform_")),
                           fails)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    rise, rise_req = torch.cuda.memory_allocated() - base, requested() - \
        base_req
    n = len(placed)
    log(f"  placed rank 0's shards of {PLACE_ARCH} ({cfg.n_layers} layers) "
        f"on the {PLACE_MESH} mesh: {n} DTensors (params, mu, nu) in "
        f"{secs:.3f} s; requested bytes rose {rise_req} and memory_allocated "
        f"{rise} ({rise / GIB:.3f} GiB) against the table's {want} "
        f"({want / GIB:.3f} GiB: params {b['params']} + moments "
        f"{b['moments']}) [{card}]")
    if rise_req != want:
        fails.append(f"requested bytes rose {rise_req} for {want} in the "
                     f"table")
    if not 0 <= rise - want <= PLACE_SLACK * n:
        fails.append(f"memory_allocated rose {rise} bytes for {want} in "
                     f"the table (limit {PLACE_SLACK} a leaf, {n} leaves)")
    placed.clear()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    left = torch.cuda.memory_allocated() - base
    log(f"  freed: memory_allocated {left} bytes above where it started")
    if left:
        fails.append(f"{left} bytes still allocated after the placement")


def placed_shards(torch, mesh, trees, fails):
    """For each (abstract tree, its shardings, fill) the local shards as
    DTensors of the global shapes; global and local shapes checked
    against the abstract leaf, its spec and DTensor's placements."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    placed = []
    for tree, shs, fill in trees:
        shd = dict(spec_leaves(shs))
        for path, leaf in spec_leaves(tree):
            sh = shd[path]
            spec_local = sh.shard_shape(leaf.shape)
            local = torch.empty(spec_local, dtype=leaf.dtype, device="cuda")
            getattr(local, fill)(generator=gen)
            dt = DTensor.from_local(local, mesh, sh.placements,
                                    shape=leaf.shape, stride=leaf.stride())
            placed.append(dt)
            got, _ = compute_local_shape_and_global_offset(
                leaf.shape, mesh, sh.placements)
            if tuple(dt.shape) != tuple(leaf.shape) or \
                    tuple(dt.to_local().shape) != spec_local or \
                    tuple(got) != spec_local:
                fails.append(f"placed {path}: global {tuple(dt.shape)} "
                             f"(want {tuple(leaf.shape)}), local "
                             f"{tuple(dt.to_local().shape)} (spec "
                             f"{spec_local}, DTensor {tuple(got)})")
    return placed


def layouts_main(card: str) -> int:
    """Phase 12 in the child: the meshes, the table, the strided check and
    the placement.  Exit 0 only when every check held."""
    import torch
    if not torch.cuda.is_available():
        log("chip_smoke --layouts: torch.cuda.is_available() is false")
        return 1
    from repro_torch.configs import ARCH_IDS, get_config, load_all
    from repro_torch.launch import mesh as M
    from repro_torch.launch import specs as S
    from repro_torch.models import lm
    from repro_torch.models.sharding import ShardingEnv
    load_all()
    fails = []
    t0 = time.perf_counter()
    with M.fake_world(512):
        meshes = {"16x16": M.make_production_mesh(),
                  "2x16x16": M.make_production_mesh(multi_pod=True),
                  "8x8": M.make_worker_mesh(64, tp=8)}
        log("  meshes: " + "; ".join(f"{k} {m}" for k, m in meshes.items())
            + f"; rank 0 on cuda:{torch.cuda.current_device()}")
        table = layout_table(torch, lm, S, ShardingEnv, get_config,
                             ARCH_IDS, meshes, card, fails)
        strided_check(S, ShardingEnv, get_config, ARCH_IDS, meshes, card,
                      fails)
        place_rank0(torch, lm, ShardingEnv, get_config, meshes[PLACE_MESH],
                    table, card, fails)
    log(f"  phase 12 wall {time.perf_counter() - t0:.1f} s")
    for f in fails:
        log(f"  FAILED: {f}")
    return 1 if fails else 0


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
    from repro_torch.kernels.flash_attention import ops as F
    smem = build.function("flash_attention", "flash_prefill_smem_bytes",
                          [ctypes.c_int, ctypes.c_int])
    log("  flash_prefill_kernel dynamic shared memory per CTA: "
        + ", ".join(f"D={d} Dv={dv} {smem(d, dv)} bytes"
                    for d, dv in F.WIDTHS))
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
    flash_long_shapes(torch, gen_more, kernels[0])
    flash_width_shapes(torch, gen_more, kernels[0])
    paged_g1_shapes(torch, gen_more, kernels[1:3])
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
    by_path.update(moe_vlm_paths(torch, np, card))
    by_path.update(mla_encdec_paths(torch, np, card))
    log("phase 11: training (llama3.2-3b at full width and depth; the ten "
        "tiny families on the card against the CPU)")
    by_path.update(train_paths(torch, np, card))
    log("phase 12: production layouts (the sharding specs on DTensor "
        "meshes; a child process)")
    layouts_phase(card)
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
    if sys.argv[1:2] == ["--layouts"]:
        sys.exit(layouts_main(sys.argv[2]))
    sys.exit(main())
