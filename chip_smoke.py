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
   Then phase 13's rank-local shapes (one row, half the heads a rank):
   flash at B=1 S=1024 H=12 K=4 and H=24 K=4 (window 4096), paged
   append + decode over one gathered block of 1040 positions.  Then
   flash with a soft cap on the scores (``CAP_KERNEL``, from a generator
   of its own: ``flash_capped_shapes``) at llama3.2-3b's prefill (causal,
   and window 32), seamless's encoder and its cross-attention, against
   ``flash_prefill_plain(cap=...)`` (TOL_BF16 and TOL_ROW_STEPS); the
   kernel launched without the cap must fail them (planted); timed
   beside the special-function units' floor (one tanh a visible pair)
   and ``flex_attention`` with a tanh ``score_mod`` and a block mask (a
   yardstick the port never calls; a child, ``--flex``, started in phase
   1, compiles it meanwhile and times it after phase 18, when nothing
   else runs on the card).
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
   step); then at depth 4 (for time: the full depth's checkpoint is 35.9
   GiB), 12 steps, and 6 steps with a checkpoint at step 6 in a temporary
   directory and a fresh ``train_loop(resume=True)``: the state restored
   bit-equal to the saving run's, batch 6's tokens first, steps 6-11's
   losses equal to the 12 steps' (or within 1e-3 relative).  12 steps, not
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
13. Sharded serving, in a child process (``chip_smoke.py --sharded
   CARD``) so that its threaded world never meets the other phases'
   state: 4 thread-ranks (``launch.mesh.threaded_world``) on a
   ("data", "model") mesh of (2, 2) on "cuda" with the dry run's default
   options, every rank computing on its shards on the one card.
   llama3.2-3b at full width, depth cut from 28 to 8 (seed 0): the
   one-device ``lm.prefill`` (B=2 x 1024, max_len 1040) and 16 greedy
   ``lm.decode_step``s, then the params distributed by
   ``param_shardings``, the sharded prefill and 16 sharded steps
   teacher-forced with the one-device tokens (exactly 32 flash_prefill,
   512 each of paged_append and paged_decode: 4 ranks x 8 layers);
   every step's logits within ``TOL_SHARDED`` of the largest logit of the
   one-device step's, the greedy picks equal or parted at a near-tie; a
   planted fault (rank 1 reading the other model shard's kv heads) must
   break the limit.  mixtral-8x22b at full width, depth cut from 56 to 2:
   the one-device prefill's cache distributed by ``cache_pspecs`` and 16
   sharded steps through ``moe_ep``'s EP branch against 16 one-device
   ones, and the sharded prefill under ``moe_impl="dense"`` against the
   one-device prefill, both held to the one-device run's MoE picks.  The
   walls (4 thread-ranks sharing one card: not a multi-GPU deployment's)
   beside the one-device ones, and ``max_memory_allocated``.  Phase 2
   checks and times the kernels at the ranks' shapes
   (``FLASH_RANK``, ``PAGED_RANK``).
15. Sharded training, in a child process (``chip_smoke.py
   --sharded-train CARD [arch ...]``, the cells named or all), on phase
   13's mesh under ``train_loop``'s mesh options (sp, fsdp, EP):
   llama3.2-3b (depth 4, B=2 x 1024): step 0's loss and every gradient
   leaf against the one-device run's, two planted transposes (ln1's
   gradient left as each rank's share, the FSDP gather of wq cut), then
   ``train_loop`` for 4 AdamW steps each way (losses and gnorms), a
   checkpoint at step 2 saved from the mesh and restored on the mesh and
   on one device (bit-equal); mixtral-8x22b (depth 2, EP, no pair
   dropped), rwkv6-7b (B=2 x 256; depth 1 in bf16; depth 2 in f32 with
   ln_x's output unrounded, beside the one-device gradients' own spread
   when the params move by one f32 ulp), jamba (one superblock, B=2 x
   128; planted: its conv taken on the sequence shard) and seamless-m4t
   (4 + 4): the loss and every gradient leaf of one step.  No kernel is launched (all five
   counted under their paths).  ``--sharded-train CARD --spread`` runs
   the spread study instead (PERF.md §6): rwkv6-7b in f32 with ln_x
   rounded (depths 2 and 4) and unrounded (depth 2), jamba on two
   seeds.  Limits: ``TOL_SHARDED_LOSS``, ``TOL_SHARDED_GRAD``,
   ``TOL_SHARDED_STEPS`` (PERF.md).
16. The dry run held to the card, in a child process (``chip_smoke.py
   --dryrun CARD``) on one thread-rank (a (1, 1) mesh on "cuda"):
   llama3.2-3b at full width, depth cut from 28 to 8, trained (B=2 x
   1024, one step of ``launch.train.make_train_step``: forward,
   backward, AdamW) under ``remat_policy`` "full" and "dots", at full
   depth decoded (B=4, one step over an 8192-token cache) and jamba
   (depth 8) prefilled (B=2 x 1024).  Each
   step measured on meta by the dry run's functions, then run on the card
   on seed-0 params laid out the same way: the predicted peak within
   ``TOL_DRYRUN_PEAK`` of ``max_memory_allocated``, the aten FLOPs equal,
   each kernel's tallied calls equal to its launches and the bytes its
   meta route allocated equal to those the allocator hands out in its
   calls; ``paged_decode``'s route planted without its scratch must part
   from the card; "dots" gives "full"'s loss and gradients (``TOL_BF16``)
   with fewer backward FLOPs; the first cell's prediction, the child's
   first step, is made twice and the two equal (peak, FLOPs, bytes:
   DTensor's propagation ops on fake tensors counted by neither).  Phase
   2's bounds take each kernel's work from the functions the dry run
   tallies (``flash_prefill_work``,
   ``paged_decode_work``, ``paged_append_work``, ``wkv6_work``,
   ``mamba_scan_work``).
17. The examples on the card, in a child process (``chip_smoke.py
   --examples CARD``): the eight ``examples/*_torch.py`` twins at the
   reference's defaults.  serve_agents, serve_runtime, workflow_api and
   serve_frontend serve micro on "cuda" in the child; their lines (but
   the wall figure) held to those the reference's examples print
   (``EXAMPLE_LINES``: token counts and virtual time, whatever the
   weights; workflow_api's graph programs only, its dynamic agent
   branches on token values), their launches exact where the run is in
   virtual time (``EXAMPLE_LAUNCHES``; the dynamic agent's from its
   printed step count), above 0 for serve_frontend, whose launches must
   all come from AsyncServingDriver's worker thread on cuda:0.
   train_small at its defaults but 100 steps (small-100m, B=4 x 128;
   the default 200 cut on the command line, for time) with checkpoints
   in a temporary directory: 100 finite losses, checkpoints at 50 and
   100, then a resume from step 100 for 10 more steps; and on micro at
   the same steps, where its loss falls (at the defaults it does not in
   200 steps, the reference's example's neither).  quickstart,
   cluster_sim and the multi-pod dry run (command-r-35b x decode_32k on
   2x16x16: status ok, ``MULTIPOD_ARGUMENT_BYTES``) run as child
   processes meanwhile.  Launches under "examples ..." paths.
   Phases 5-6 and 9-10 run through one ``serve_path``, with phases 5-6's
   forward on the prompt and prefill-vs-forward check.  Both phases run
   before a failed check ends the script; each counts its launches under
   its own path.
18. Soft-capped attention (``attn_logit_softcap``; ``chip_smoke.py
   --capped CARD`` runs it alone): llama3.2-3b at full width, depth cut
   from 28 to 4 (B=1, a 1024-token prompt, cap 1.0) and
   seamless-m4t-large-v2 at full width, 4 + 4 of its 24 + 24 layers (B=4,
   1024 frames and 256 target tokens, cap 0.25), cut because the
   kernels' one-bf16-step differences from the plain versions grow past
   ``TOL_FORWARD`` at full depth, capped or not (``CAPPED_DEPTH``),
   through ``lm.prefill`` and 4 greedy ``lm.decode_step``s (exactly 4
   flash_prefill, 16 each of paged_append and paged_decode; 12, 16 and
   32), held to the same run with the three attention wrappers swapped
   for their plain versions (teacher-forced): prefill logits within
   ``TOL_FORWARD``, the first layer of each cache entry ``TOL_STATE``,
   each step's logits ``TOL_DECODE`` of the family; the capped prefill's
   logits must part from the uncapped one's past ``TOL_FORWARD``.  The
   decode is uncapped, as the reference's is, so it is not held to the
   capped forward.
``chip_smoke.py --sharded-train CARD --f32-checks`` (not in the default
run) runs ROADMAP.md Queue 3's two checks in f32 (``f32_checks``).

The second-to-last line is the kernels' JSON record; the last is
``{"ok": true, "device": {...}}``.  Nothing falls back to the CPU: without
CUDA the script exits non-zero before any result.
"""
from __future__ import annotations

import atexit
import contextlib
import ctypes
import gc
import json
import math
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
        flops, nbytes = F.flash_prefill_work(B, S, S, H, K, D, D)
        bms, by = bound(nbytes, flops)
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


FLASH_LONG = [((1, 4608, 48, 8, 128), 4096), ((1, 2560, 56, 8, 128), 0)]
# phase 13's rank-local shapes on its (2, 2) mesh: one row of 1024 tokens
# a rank, llama3.2-3b's 24 q heads over 8 KV heads split to 12 over 4,
# mixtral-8x22b's 48 over 8 to 24 over 4 (G 6; its window of 4096 does not
# bite at 1024 tokens)
FLASH_RANK = [((1, 1024, 12, 4, 128), 0), ((1, 1024, 24, 4, 128), 4096)]


def flash_long_shapes(torch, gen, rec, cases=FLASH_LONG):
    """Flash prefill at further served shapes, drawn from ``gen`` after
    the earlier shapes' draws: by default (``FLASH_LONG``) mixtral-8x22b's
    4608-token prompt (H=48 over K=8, G=6) with its window of 4096 biting,
    and llava-next-34b's 2048 patches + 512 tokens (H=56 over K=8, G=7),
    causal.  Checked (``check_long``: TOL_BF16 and a limit scaled to each
    row), timed beside SDPA (the band as a boolean ``attn_mask`` where the
    window bites) and the bound; added to ``rec``'s ``more_shapes`` and
    ``max_abs_err``."""
    from repro_torch.kernels.flash_attention import ops as F

    sdpa = torch.nn.functional.scaled_dot_product_attention
    mk = lambda *s: torch.randn(s, generator=gen, device="cuda",  # noqa
                                dtype=torch.float32).to(torch.bfloat16)
    for (B, S, H, K, D), window in cases:
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
        if window and window < S:
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
        flops, nbytes = F.flash_prefill_work(B, S, S, H, K, D, D,
                                             window=window)
        bms, by = bound(nbytes, flops)
        shape = (f"B={B} S={S} H={H} K={K} D={D} causal"
                 + (f" window={window}" if window else ""))
        rec["more_shapes"].append({
            "shape": shape, "ms": ms, "device_ms": dev,
            "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bms,
            "bound_by": by, **errs})
        log(f"  flash {shape} time {ms:.4f} ms (device {dev} ms)  plain "
            f"{plain_ms:.4f} ms  sdpa {lib_ms:.4f} ms  bound {bms:.4f} ms "
            f"({by})")


FLASH_WIDTH = [
    ("deepseek-v2 MLA prefill", 2, 1024, 1024, 128, 128, 192, 128, True),
    ("seamless encoder", 4, 1024, 1024, 16, 16, 64, 64, False),
    ("seamless cross-attention", 4, 256, 1024, 16, 16, 64, 64, False)]
# phase 14's rank-local seamless encoder on its (2, 2) mesh: one row of
# 1024 frames and 8 of the 16 heads a rank
FLASH_REST = [("rank-local seamless encoder (2, 2)", 1, 1024, 1024, 8, 8,
               64, 64, False)]


def flash_width_shapes(torch, gen, rec, cases=FLASH_WIDTH):
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
    for label, B, Sq, Sk, H, K, D, Dv, causal in cases:
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
        flops, nbytes = F.flash_prefill_work(B, Sq, Sk, H, K, D, Dv,
                                             causal=causal)
        bms, by = bound(nbytes, flops)
        shape = (f"{label}: B={B} Sq={Sq} Sk={Sk} H={H} K={K} D={D} Dv={Dv} "
                 + ("causal" if causal else "non-causal"))
        rec["more_shapes"].append({
            "shape": shape, "ms": ms, "device_ms": dev,
            "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bms,
            "bound_by": by, **errs})
        sdpa_ms = "none" if lib_ms is None else f"{lib_ms:.4f} ms"
        log(f"  flash {shape} time {ms:.4f} ms (device {dev} ms)  plain "
            f"{plain_ms:.4f} ms  sdpa {sdpa_ms}  bound {bms:.4f} ms ({by})")


# soft-capped attention (``cfg.attn_logit_softcap``): phase 2's cap on
# std-1 inputs, whose scores have a standard deviation of about 1, so a
# cap of 1 holds most of them on tanh's bend (the capped output moves by
# 0.4 to 1.5 from the uncapped one at these shapes, far past TOL_BF16)
CAP_KERNEL = 1.0
FLASH_CAPPED = [   # label, B, Sq, Sk, H, K, D, causal, window; the first timed
    ("llama3.2-3b", 1, 1024, 1024, 24, 8, 128, True, 0),
    ("llama3.2-3b", 1, 1024, 1024, 24, 8, 128, True, 32),
    ("seamless encoder", 4, 1024, 1024, 16, 16, 64, False, 0),
    ("seamless cross-attention", 4, 256, 1024, 16, 16, 64, False, 0)]


FLEX_WAIT = 240        # s: the wait for the flex child's timing
FLEX_RESULT = "FLEX_CAPPED "


def capped_inputs(torch, gen, cases=FLASH_CAPPED):
    """q, k, v (bf16, std 1) for each of ``cases`` in turn, drawn from
    ``gen``: the flash check and the flex child draw the same tensors."""
    mk = lambda *s: torch.randn(s, generator=gen, device="cuda",  # noqa
                                dtype=torch.float32).to(torch.bfloat16)
    for label, B, Sq, Sk, H, K, D, causal, window in cases:
        yield mk(B, Sq, H, D), mk(B, Sk, K, D), mk(B, Sk, K, D)


def flex_main(card: str) -> int:
    """``--flex``: the capped shapes' yardstick in a child that phase 1
    starts, so that Inductor's import and compiles overlap phases 1-4.
    ``torch.nn.attention.flex_attention``, compiled, with the cap as a
    tanh ``score_mod`` and the mask as a block mask; causal and window
    read from a captured tensor, so one compiled callable serves both
    masks at a head width (it recompiles for a new width or length).  It
    draws phase 2's capped inputs (``capped_inputs``, seed 2), compiles
    and checks flex at each shape against ``flash_prefill_plain(cap=)``
    (TOL_BF16), then waits for a line on stdin (sent after phase 18, when
    nothing else runs on the card) before it times them: CUDA events, 20 calls after 3 warm-ups.  Prints
    ``FLEX_CAPPED`` and a JSON list, one entry a shape with ``ms`` (None
    and ``why`` where flex failed), as its last line."""
    import torch
    if not torch.cuda.is_available():
        log("chip_smoke --flex: torch.cuda.is_available() is false")
        return 1
    import torch._inductor.config as inductor
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)
    from repro_torch.kernels.flash_attention import ops as F

    torch.backends.cuda.matmul.allow_tf32 = False
    inductor.compile_threads = 1       # no pool of compile workers
    cap = CAP_KERNEL
    flags = torch.zeros(2, dtype=torch.int32, device="cuda")  # causal, window

    def visible(b, h, qi, ki):
        return (((flags[0] == 0) | (ki <= qi))
                & ((flags[1] == 0) | (qi - ki < flags[1])))

    def softcap(score, b, h, qi, ki):
        return cap * torch.tanh(score / cap)

    flex = torch.compile(flex_attention)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    runs, out = [], []
    for case, (q, k, v) in zip(FLASH_CAPPED, capped_inputs(torch, gen)):
        label, B, Sq, Sk, H, K, D, causal, window = case
        entry = {"label": label, "window": window, "ms": None}
        out.append(entry)
        t0 = time.perf_counter()
        try:
            flags.copy_(torch.tensor([int(causal), window]))
            mask = create_block_mask(visible, None, None, Sq, Sk,
                                     device="cuda")
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            run = (lambda qt=qt, kt=kt, vt=vt, mask=mask: flex(
                qt, kt, vt, score_mod=softcap, block_mask=mask,
                enable_gqa=True))
            got = run().transpose(1, 2)
            torch.cuda.synchronize()
            entry["compile_s"] = time.perf_counter() - t0
            entry["max_abs_err"] = max_err(got, F.flash_prefill_plain(
                q, k, v, causal=causal, window=window, cap=cap))
            if not entry["max_abs_err"] < TOL_BF16:
                raise AssertionError(f"flex parts from the plain version "
                                     f"by {entry['max_abs_err']}")
            runs.append((entry, run, flags.clone()))
        except Exception as exc:        # the yardstick only
            entry["why"] = (f"{type(exc).__name__}: "
                            f"{str(exc).splitlines()[0][:160]}")
    sys.stdin.readline()
    for entry, run, fl in runs:
        flags.copy_(fl)
        entry["ms"] = timed(torch, run)
    log(FLEX_RESULT + json.dumps(out))
    return 0


def start_flex(card: str):
    """The ``--flex`` child (phase 1 starts it; ``flash_capped_shapes``
    reads it)."""
    return subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--flex", card],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def flex_times(proc) -> list:
    """Tell the flex child to time, wait for it, echo its lines; its
    entries by shape, or None each (and why) where it failed."""
    t0 = time.perf_counter()
    try:
        text = proc.communicate("go\n", timeout=FLEX_WAIT)[0]
    except subprocess.TimeoutExpired:
        proc.kill()
        text = proc.communicate()[0] + f"\n(no result in {FLEX_WAIT} s)"
    res = None
    for line in text.splitlines():
        if line.startswith(FLEX_RESULT):
            res = json.loads(line[len(FLEX_RESULT):])
        elif line.strip():
            log(f"  flex child: {line[:200]}")
    log(f"  flex child: waited {time.perf_counter() - t0:.1f} s for it "
        f"(exit {proc.returncode})")
    return res or [{"ms": None, "why": f"the child gave no result (exit "
                    f"{proc.returncode})"}] * len(FLASH_CAPPED)


def flash_capped_shapes(torch, gen, rec, cases=FLASH_CAPPED):
    """Flash prefill with the cap ``CAP_KERNEL`` against
    ``flash_prefill_plain(cap=...)``, drawn from ``gen`` (its own, so the
    earlier shapes' draws stay as they were): llama3.2-3b's prefill
    (causal, and causal + window 32), seamless's encoder (non-causal) and
    its cross-attention (256 queries over 1024 frames).  Checked with
    ``check_long`` (TOL_BF16 and TOL_ROW_STEPS); the kernel launched
    without the cap must part from the capped plain version (a planted
    fault); each timed beside the plain version, the bound
    (``flash_prefill_work`` with the cap: the larger of its operations and
    bytes) with the special-function units' floor beside it (one tanh a
    visible pair); ``library_ms``, ``flex_attention``, comes later
    (``flex_rows``).  Added to ``rec``'s ``more_shapes`` and
    ``max_abs_err``; returns those rows."""
    from repro_torch.kernels.flash_attention import ops as F

    cap = CAP_KERNEL
    rows = []
    for case, (q, k, v) in zip(cases, capped_inputs(torch, gen, cases)):
        label, B, Sq, Sk, H, K, D, causal, window = case
        run = lambda: F.flash_prefill(q, k, v, causal=causal,  # noqa
                                      window=window, cap=cap)
        out = run()
        torch.cuda.synchronize()
        ref = F.flash_prefill_plain(q, k, v, causal=causal, window=window,
                                    cap=cap)
        shape = (f"{label}: B={B} Sq={Sq} Sk={Sk} H={H} K={K} D={D} "
                 + ("causal" if causal else "non-causal")
                 + (f" window={window}" if window else "") + f" cap={cap:g}")
        errs = check_long(f"flash {shape}", out, ref)
        rec["max_abs_err"] = max(rec["max_abs_err"], errs["max_abs_err"])
        moved = max_err(F.flash_prefill_plain(q, k, v, causal=causal,
                                              window=window), ref)
        uncapped = F.flash_prefill(q, k, v, causal=causal, window=window)
        planted = {"max_abs_err": max_err(uncapped, ref),
                   "row_err_bf16_steps": row_steps(uncapped, ref)}
        log(f"  {shape}: the cap moves the plain output {moved:.3e}; "
            f"planted, the kernel launched with cap 0 against the capped "
            f"plain version: max_abs_err {planted['max_abs_err']:.3e}, "
            f"{planted['row_err_bf16_steps']:.1f} bf16 steps")
        if planted["max_abs_err"] < TOL_BF16 \
                and planted["row_err_bf16_steps"] < TOL_ROW_STEPS:
            raise AssertionError(f"flash {shape}: the kernel without its "
                                 f"cap passes both limits")
        del out, ref, uncapped
        ms = timed(torch, run)
        dev = device_ms(torch, run, "flash_prefill_kernel")
        plain_ms = timed(torch, lambda: F.flash_prefill_plain(
            q, k, v, causal=causal, window=window, cap=cap), iters=2,
            warmup=1)
        flops, nbytes = F.flash_prefill_work(B, Sq, Sk, H, K, D, D,
                                             causal=causal, window=window,
                                             cap=cap)
        bms, by = bound(nbytes, flops)
        sfu = sfu_floor_ms(torch, B * H * F.visible_pairs(Sq, Sk, causal,
                                                          window))
        row = {"shape": shape, "ms": ms, "device_ms": dev,
               "plain_ms": plain_ms, "library_ms": None, "bound_ms": bms,
               "bound_by": by, "sfu_floor_ms": sfu, "cap_moves": moved,
               "planted_cap_0": planted, **errs}
        rows.append(row)
        rec["more_shapes"].append(row)
        log(f"  flash {shape} time {ms:.4f} ms (device {dev} ms)  plain "
            f"{plain_ms:.4f} ms  bound {bms:.4f} ms ({by}); SFU floor "
            f"{sfu:.5f} ms")
        del q, k, v
    return rows


def flex_rows(rows, flex):
    """``library_ms`` of ``flash_capped_shapes``' rows from the ``flex``
    child, which by now has compiled and waits (main calls this after
    phase 18, so the compiles cost the run no wall time)."""
    for row, lib in zip(rows, flex_times(flex)):
        row["library_ms"] = lib["ms"]
        if lib["ms"] is None:
            log(f"  flex_attention at {row['shape']}: none, {lib.get('why')}")
        else:
            log(f"  flex_attention (tanh score_mod, block mask) at "
                f"{row['shape']}: {lib['ms']:.4f} ms (compiled in "
                f"{lib['compile_s']:.1f} s; against the plain version "
                f"{lib['max_abs_err']:.3e})")


def paged_g1_shapes(torch, gen, recs, cases=None):
    """paged_append + paged_decode at further shapes, by default phase
    10's (G = 1, dh = 64: ``PAGED_SEAMLESS``), drawn from ``gen`` after
    the earlier shapes'; added to the two kernels' records ``recs``."""
    errs = {"paged_decode": [], "paged_append": []}
    more = paged_more_shapes(torch, gen, errs, cases or PAGED_SEAMLESS)
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
        flops, nbytes = P.paged_decode_work(B, H, K, dh, nb, n_tok)
        bms, by = bound(nbytes, flops)
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
        abms, aby = bound(*reversed(P.paged_append_work(B, K, dh, n_rows)))
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


# phase 13's rank-local decode: one row a rank over the layer's gathered
# cache of 1040 positions (one block), its last step (lens 1040), the
# append first; q heads as FLASH_RANK's
PAGED_RANK = [
    ("rank-local llama3.2-3b (2, 2)", 1, 12, 4, 128, 1040, 1, [1040], 0,
     True, False),
    ("rank-local mixtral-8x22b (2, 2)", 1, 24, 4, 128, 1040, 1, [1040],
     4096, True, False)]


# phase 14's rank-local engine round: llama3.2-3b's engine on the (2, 2)
# mesh, 2 of its 4 slots a rank (one live row of 1152 tokens, one idle on
# a zero table), 12 q heads over the pool's 4 kv heads a rank, max_len
# 2048 in blocks of 16 (nb 128); the append first
PAGED_REST = [
    ("rank-local engine llama3.2-3b (2, 2)", 2, 12, 4, 128, 16, 128,
     [1152, 1], 0, True, False)]


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
        flops, nbytes = P.paged_decode_work(B, H, K, dh, nb, n_tok)
        bms, by = bound(nbytes, flops)
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
    yardstick the port never calls; None where a window bites."""
    if window and max(lens) > window:
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
    bms, by = bound(*reversed(P.paged_append_work(B, K, dh, n_rows)))
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
            flops, nbytes = R.wkv6_work(B, T, H, dh, state)
            bms, by = bound(nbytes, flops, F32_FLOPS)
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
    flops, nbytes = R.wkv6_work(B, T, H, dh, state)
    rec["more_shapes"] = [decode_time(
        torch, lambda: R.wkv6(*args), lambda: R.wkv6_plain(*args),
        "wkv6_kernel", f"B={B} T={T} H={H} dh={dh} state in", nbytes,
        flops)]
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
            flops, nbytes = M.mamba_scan_work(B, T, di, ds, state)
            bms, by = bound(nbytes, flops, F32_FLOPS)
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
        "mamba_scan_kernel", f"B={B} T={T} di={di} ds={ds} state in",
        *reversed(M.mamba_scan_work(B, T, di, ds, state)))]
    rec["more_shapes"][0]["sfu_floor_ms"] = sfu_floor_ms(torch, B * di * ds)
    rec["max_abs_err"] = max(errs)
    return rec


def scan_rank_shapes(torch, gen, wkv_rec, mamba_rec):
    """wkv6 and mamba_scan at phase 14's rank-local shapes on its (2, 2)
    mesh, drawn from ``gen``: rwkv6-7b's 32 of 64 heads for one row
    (B=1, H=32, dh=64) and jamba's 4096 of 8192 channels (B=1, di=4096,
    ds=16), each at the prefill's T=1024 (zero state; mamba's h.C
    rounded) and a decode step's T=1 (a state in).  Checked as
    ``wkv6_phase`` / ``mamba_phase`` check theirs, timed beside the plain
    version and the bound (``decode_time``), added to the records'
    ``more_shapes`` and ``max_abs_err``."""
    from repro_torch.kernels.mamba_scan import ops as M
    from repro_torch.kernels.rwkv6 import ops as R

    mk = lambda *s: torch.randn(s, generator=gen, device="cuda")  # noqa
    B, H, dh = 1, 32, 64
    for T, state in ((1024, False), (1, True)):
        r, k, v = ((mk(B, T, H, dh) * 0.5).to(torch.bfloat16)
                   for _ in range(3))
        w = torch.exp(-torch.exp(-5 + 8 * torch.rand(
            B, T, H, dh, generator=gen, device="cuda")))
        args = (r, k, v, w, mk(H, dh) * 0.3,
                mk(B, H, dh, dh) if state else None)
        out, s_T = R.wkv6(*args)
        torch.cuda.synchronize()
        ref, ref_T = R.wkv6_plain(*args)
        shape = (f"rank-local rwkv6-7b (2, 2): B={B} T={T} H={H} dh={dh} "
                 + ("state in" if state else "zero state"))
        err = check(f"wkv6 {shape} (out, S_T)",
                    max(rel_err(out, ref), rel_err(s_T, ref_T)), tol=TOL_SCAN)
        wkv_rec["max_abs_err"] = max(wkv_rec["max_abs_err"], err)
        flops, nbytes = R.wkv6_work(B, T, H, dh, state)
        wkv_rec["more_shapes"].append(decode_time(
            torch, lambda: R.wkv6(*args), lambda: R.wkv6_plain(*args),
            "wkv6_kernel", shape, nbytes, flops))
    di, ds, dtr = 4096, 16, 256
    for T, state in ((1024, False), (1, True)):
        x = mk(B, T, di).to(torch.bfloat16)
        dt = torch.nn.functional.softplus(mk(B, T, di) - 3).to(torch.bfloat16)
        dbc = mk(B, T, dtr + 2 * ds).to(torch.bfloat16)
        A = -torch.arange(1, ds + 1, dtype=torch.float32, device="cuda"
                          ).expand(di, ds).contiguous()
        args = (x, dt, dbc[..., dtr:dtr + ds], dbc[..., dtr + ds:], A,
                torch.ones(di, device="cuda"),
                mk(B, di, ds) * 0.5 if state else None)
        rnd = not state
        y, h_T = M.mamba_scan(*args, round_y=rnd)
        torch.cuda.synchronize()
        ref, ref_T = M.mamba_scan_plain(*args, round_y=rnd)
        shape = (f"rank-local jamba (2, 2): B={B} T={T} di={di} ds={ds} "
                 + ("state in" if state else "zero state, round_y"))
        if rnd:
            steps, share = M.rounding_errs(y, ref, *args)
            check(f"mamba_scan {shape} (y: bf16 steps of h.C past the f32 "
                  f"slack)", steps, tol=M.ROUND_STEPS)
            check(f"mamba_scan {shape} (y: share off the plain version)",
                  share, tol=M.ROUND_SHARE)
            errs = [rel_err(y, ref)]
        else:
            errs = [check(f"mamba_scan {shape} (y)", rel_err(y, ref),
                          tol=TOL_SCAN)]
        errs.append(check(f"mamba_scan {shape} (h_T)", rel_err(h_T, ref_T),
                          tol=TOL_SCAN))
        mamba_rec["max_abs_err"] = max([mamba_rec["max_abs_err"], *errs])
        flops, nbytes = M.mamba_scan_work(B, T, di, ds, state)
        rec = decode_time(
            torch, lambda: M.mamba_scan(*args, round_y=rnd),
            lambda: M.mamba_scan_plain(*args, round_y=rnd),
            "mamba_scan_kernel", shape, nbytes, flops)
        rec["sfu_floor_ms"] = sfu_floor_ms(torch, B * T * di * ds)
        mamba_rec["more_shapes"].append(rec)


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
    they part, the step's logits, recorded from each engine's own steps
    (``Engine._round_model``: the paged engine's round graph or eager
    step, the gather engine's ``lm.decode_step``), must show a near-tie
    (ROADMAP.md): the gather run's top-2 logit gap below the two paths'
    logit difference."""
    from repro_torch.serving.engine import Engine

    rng = np.random.RandomState(4)
    prompt = rng.randint(1, cfg.vocab, size=1024).astype(np.int32)
    tool = rng.randint(1, cfg.vocab, size=128).astype(np.int32)

    def recorded(fn, sink):
        def call(*args, **kw):
            out = fn(*args, **kw)
            sink.append(out[:, 0].float().cpu())
            return out
        return call

    runs = {}
    for mode in ("paged", "gather"):
        logits = []
        eng = Engine(cfg, params, n_slots=4, max_len=2048, pool_blocks=1024,
                     paged=mode == "paged")
        eng._round_model = recorded(eng._round_model, logits)
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
              "mla": 5e-2, "encdec": 2.5e-2, "dense": 5e-2}
TOL_STATE = {"ssm": 2e-2, "hybrid": 1e-1, "moe": 2e-2, "vlm": 2e-2,
             "mla": 2e-2, "encdec": 2e-2, "dense": 2e-2}
# ("dense": llama3.2-3b's in phase 18, the uniform GQA decoder's limits,
# mixtral's without its experts)
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
# The restart runs at a cut depth: at 28 layers its checkpoint (params and
# both moments in f32) is 35.9 GiB, ~90 s of disk a save and a restore
RESTART_DEPTH = 4
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
    tokens a second, peak memory, one profiled step); then at depth
    RESTART_DEPTH, 12 steps, and 6 steps with a checkpoint at 6 and a
    fresh ``train_loop(resume=True)`` from it (state bit-equal, batch 6's
    tokens, steps 6-11's losses those of the 12).  Returns the launches of
    the loss check."""
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

    arch = train_cfg("llama3.2-3b", RESTART_DEPTH).name
    rec["tokens"] = []
    with swapped(T, "SyntheticLM", recorded):
        losses = T.train_loop(arch, **kw)[2]
    whole_tokens = rec["tokens"]
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as d:
        rec["tokens"] = []
        t0 = time.perf_counter()
        with swapped(T, "SyntheticLM", recorded):
            p4, o4, first = T.train_loop(arch, **{
                **kw, "steps": half}, ckpt_dir=d, ckpt_every=half)
        part = time.perf_counter() - t0
        size = sum(f.stat().st_size for f in Path(d).iterdir()) / 2**30
        # the saving run's state stays on the card until the restored one
        # is compared with it
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
            resumed = T.train_loop(arch, **kw, ckpt_dir=d,
                                   resume=True)[2]
    gc.collect()
    torch.cuda.empty_cache()
    same_batch = bool(rec["tokens"]) and np.array_equal(
        rec["tokens"][0], whole_tokens[half])
    gap = max(abs(a - b) / abs(b) for a, b in zip(resumed, losses[half:]))
    how = ("equal" if resumed == losses[half:] else
           f"within {gap:.3e} relative" if gap < TOL_RESTART else
           f"{gap:.3e} apart")
    log(f"  restart at depth {RESTART_DEPTH} [{card}]: {steps} steps, losses "
        f"{[round(x, 4) for x in losses]}; {half} steps and a checkpoint "
        f"({size:.2f} GiB on disk) in {part:.1f} s, losses "
        f"{[round(x, 4) for x in first]}; "
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
# count params, AdamW moments, caches and inputs, not activations (the dry
# run's peak counts those: ``launch/dryrun.py``, phase 16).
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


# ---------------------------------------------------------------------------
# phase 13: sharded serving, 4 thread-ranks sharing the card
# ---------------------------------------------------------------------------
# In a child process (``--sharded``), so the threaded world never meets the
# other phases' state.  The ranks are threads of the child on torch's
# threaded process group (``launch.mesh.threaded_world``), a
# ("data", "model") mesh of (2, 2) on "cuda" with the dry run's default
# options (sp, fsdp, moe_impl "ep"): every rank computes on its own shards
# of one card, so the walls are those of 4 thread-ranks sharing one card,
# not of a multi-GPU deployment.
SHARDED_MESH = (2, 2)
SHARDED_B, SHARDED_S, SHARDED_STEPS = 2, 1024, 16
SHARDED_DEPTH = 2                 # mixtral-8x22b: 56 layers cut to 2
SHARDED_LLAMA_DEPTH = 8           # llama3.2-3b: 28 cut to 8 (for time)
# The sharded run's logits against the one-device run's on the same
# params and tokens, as the largest |difference| over the largest |logit|
# (at least 1): the ranks round each partial product of the out-projection
# and the FFN to bf16 and sum them over 'model', where one device rounds
# the whole contraction once, so the readings are of the size of the
# decode-vs-forward gaps of the paths above (PERF.md, phase 13's cell)
TOL_SHARDED = 5e-2
SHARDED_COUNTS = "SHARDED_LAUNCHES "


def sharded_phase(card: str) -> dict:
    """Phase 13: ``sharded_main`` in a child process; its output is
    echoed, and its launch counts by path (a line of their own) returned.
    Fails unless the child exits 0."""
    sys.stdout.flush()
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                          "--sharded", card], timeout=600,
                         stdout=subprocess.PIPE, text=True)
    counts = None
    for line in res.stdout.splitlines():
        if line.startswith(SHARDED_COUNTS):
            counts = json.loads(line[len(SHARDED_COUNTS):])
        else:
            log(line)
    log(f"  phase 13 wall with the child's start "
        f"{time.perf_counter() - t0:.1f} s")
    if res.returncode or counts is None:
        raise AssertionError(f"phase 13 (sharded serving) failed: exit "
                             f"{res.returncode}")
    return counts


def one_device(torch, lm, cfg, params, batch, max_len, routing=None):
    """The one-device run: ``lm.prefill`` then SHARDED_STEPS greedy
    ``lm.decode_step``s, after an unmeasured prefill and step (the
    kernels' and the GEMM libraries' first calls).  Returns (last logits,
    the prefill's cache (a copy), each step's logits, the tokens fed,
    prefill wall s, step wall ms)."""
    last, cache = lm.prefill(params, batch, cfg, max_len=max_len)
    lm.decode_step(params, last.argmax(-1).to(torch.int32), cache,
                   SHARDED_S, cfg)
    del last, cache
    if routing:
        routing.record()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    last, cache = lm.prefill(params, batch, cfg, max_len=max_len)
    torch.cuda.synchronize()
    t_pre = time.perf_counter() - t0
    first = _clone(cache)
    tok = last.argmax(-1).to(torch.int32)
    steps, ids = [], []
    t0 = time.perf_counter()
    for t in range(SHARDED_STEPS):
        ids.append(tok)
        lg, cache = lm.decode_step(params, tok, cache, SHARDED_S + t, cfg)
        steps.append(lg)
        tok = lg.argmax(-1).to(torch.int32)
    torch.cuda.synchronize()
    t_step = (time.perf_counter() - t0) / SHARDED_STEPS * 1e3
    del cache
    return last, first, steps, ids, t_pre, t_step


def sharded_run(torch, cfg, params, batch, max_len, ids, *, prefill=True,
                cache=None, moe_impl=None, steps=SHARDED_STEPS):
    """The sharded run on each of the 4 thread-ranks: params (and a given
    one-device cache) distributed by their specs, ``lm.prefill`` (under
    ``moe_impl`` where given; skipped without ``prefill``) and ``steps``
    ``lm.decode_step``s teacher-forced with ``ids``, from the given cache
    or else the prefill's.  Returns rank 0's {"last", "cache", "steps":
    the logits and caches whole on the card, "t_pre": prefill wall s,
    "t_step": step wall ms}."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_worker_mesh, threaded_world
    from repro_torch.models import lm
    from repro_torch.models.sharding import ShardingEnv, distribute

    dp, tp = SHARDED_MESH

    def rank(r):
        env = ShardingEnv(make_worker_mesh(dp * tp, tp=tp))
        env_pre = (ShardingEnv(env.mesh, {"moe_impl": moe_impl})
                   if moe_impl else env)
        ps = distribute(params, lm.param_shardings(cfg, env))
        specs = lm.cache_pspecs(cfg, env, SHARDED_B, max_len)
        out = {}

        def sync():
            torch.cuda.synchronize()
            dist.barrier()
            return time.perf_counter()

        with torch.no_grad():
            if prefill:
                t0 = sync()
                last, got = lm.prefill(ps, batch, cfg, env_pre,
                                       max_len=max_len)
                out["t_pre"] = sync() - t0
                out["last"] = last.full_tensor()
                out["cache"] = {k: v.full_tensor().clone()
                                for k, v in got.items()}
            c = got if cache is None else distribute(_clone(cache), specs)
            lgs = []
            t0 = sync()
            for t in range(steps):
                lg, c = lm.decode_step(ps, ids[t], c, SHARDED_S + t, cfg,
                                       env)
                lgs.append(lg)
            out["t_step"] = (sync() - t0) / steps * 1e3
            out["steps"] = [lg.full_tensor() for lg in lgs]
        return out

    with threaded_world(dp * tp, timeout=300) as run:
        return run(rank)[0]


def held_sharded(name, ref, got, fails):
    """Each step's logits within TOL_SHARDED of the one-device run's, and
    the greedy picks equal or parted at a near-tie (the one-device top-2
    gap below the row's difference).  Returns the largest reading."""
    worst = 0.0
    for t, (a, b) in enumerate(zip(got, ref)):
        err = rel_err(a, b)
        worst = max(worst, err)
        diff = (a.float() - b.float()).abs().amax(-1).flatten()
        top2 = b.float().flatten(0, -2).topk(2, -1).values
        part = (a.argmax(-1) != b.argmax(-1)).flatten()
        if err >= TOL_SHARDED:
            fails.append(f"{name} step {t}: {err:.3e} >= {TOL_SHARDED}")
        far = part & ((top2[:, 0] - top2[:, 1]) >= diff)
        if bool(far.any()):
            fails.append(f"{name} step {t}: a greedy pick differs away "
                         f"from a near-tie")
    log(f"  {name}: {len(got)} steps, largest logit error {worst:.3e} of "
        f"the largest logit (limit {TOL_SHARDED:g})")
    return worst


def sharded_llama(torch, card, wrappers, fails):
    """llama3.2-3b at full width, depth SHARDED_LLAMA_DEPTH: one-device
    prefill + 16 greedy steps, then the sharded prefill + 16 steps
    teacher-forced with the one-device tokens (exact launches), then the
    last step again with rank 1 reading the wrong kv heads (planted: must
    break the limit)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    from repro_torch.models import lm

    cfg = dataclasses.replace(get_config("llama3.2-3b"),
                              n_layers=SHARDED_LLAMA_DEPTH)
    params = ready(torch, lm, cfg)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    batch = {"tokens": torch.randint(1, cfg.vocab, (SHARDED_B, SHARDED_S),
                                     generator=gen, device="cuda")}
    max_len = SHARDED_S + SHARDED_STEPS
    last, first, steps, ids, t_pre, t_step = one_device(
        torch, lm, cfg, params, batch, max_len)
    reset(wrappers)
    got = sharded_run(torch, cfg, params, batch, max_len, ids)
    n = counts(wrappers)
    dp, tp = SHARDED_MESH
    ranks, L_ = dp * tp, cfg.n_layers
    expect = {**dict.fromkeys(wrappers, 0), "flash_prefill": ranks * L_,
              "paged_append": SHARDED_STEPS * L_ * ranks,
              "paged_decode": SHARDED_STEPS * L_ * ranks}
    log(f"  sharded llama3.2-3b launches {n} (expected {expect})")
    if n != expect:
        fails.append(f"sharded llama3.2-3b launches {n} != {expect}")
    err = rel_err(got["last"], last)
    log(f"  prefill's last logits {err:.3e}, cache "
        + ", ".join(f"{k} {rel_err(got['cache'][k], v):.3e}"
                    for k, v in first.items()))
    if not err < TOL_SHARDED:
        fails.append(f"sharded llama3.2-3b prefill {err:.3e}")
    held_sharded("sharded llama3.2-3b decode", steps, got["steps"], fails)
    log(f"  walls: sharded prefill {got['t_pre']:.3f} s, decode step "
        f"{got['t_step']:.2f} ms (4 thread-ranks sharing one card); "
        f"one-device prefill {t_pre:.3f} s, step {t_step:.2f} ms [{card}]")
    # planted: in the first decode step from the one-device prefill's
    # cache, rank 1 (data 0, model 1) reads the kv heads of the other
    # model shard's q heads
    kv_for_heads = L._kv_for_heads

    def wrong_heads(k, v, h0, Hl, H):
        import torch.distributed as dist
        if dist.get_rank() == 1:
            h0 = (h0 + Hl) % H
        return kv_for_heads(k, v, h0, Hl, H)

    L._kv_for_heads = wrong_heads
    try:
        bad = sharded_run(torch, cfg, params, batch, max_len, ids,
                          prefill=False, cache=first, steps=1)
    finally:
        L._kv_for_heads = kv_for_heads
    err = rel_err(bad["steps"][0], steps[0])
    log(f"  planted (rank 1 reads the other shard's kv heads): step 0 "
        f"{err:.3e} (must be >= {TOL_SHARDED})")
    if err < TOL_SHARDED:
        fails.append(f"planted wrong kv heads not caught: {err:.3e}")
    del params
    return n


def sharded_mixtral(torch, card, wrappers, fails):
    """mixtral-8x22b at full width, depth 2: the one-device prefill's
    cache distributed by ``cache_pspecs`` and 16 sharded decode steps
    through ``moe_ep``'s EP branch (4 experts a rank, their d_model
    gathered over 'data' in the body) against 16 one-device steps; the
    sharded prefill under ``moe_impl="dense"`` against the one-device
    prefill.  Both held to the one-device run's MoE picks."""
    import dataclasses
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.models.routing_replay import SameRouting

    cfg = dataclasses.replace(get_config("mixtral-8x22b"),
                              n_layers=SHARDED_DEPTH)
    params = ready(torch, lm, cfg)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(14)
    batch = {"tokens": torch.randint(1, cfg.vocab, (SHARDED_B, SHARDED_S),
                                     generator=gen, device="cuda")}
    max_len = SHARDED_S + SHARDED_STEPS
    routing = SameRouting()
    last, first, steps, ids, t_pre, t_step = one_device(
        torch, lm, cfg, params, batch, max_len, routing)
    dp, tp = SHARDED_MESH

    def rows(n_rows, m):           # a rank routes its data shard's tokens
        return 0 if n_rows == m else (dist.get_rank() // tp) * m

    routing.replay(rows=rows)
    reset(wrappers)
    try:
        got = sharded_run(torch, cfg, params, batch, max_len, ids,
                          cache=first, moe_impl="dense")
    finally:
        routing.restore()
    n = counts(wrappers)
    ranks, L_ = dp * tp, cfg.n_layers
    expect = {**dict.fromkeys(wrappers, 0), "flash_prefill": ranks * L_,
              "paged_append": SHARDED_STEPS * L_ * ranks,
              "paged_decode": SHARDED_STEPS * L_ * ranks}
    log(f"  sharded mixtral-8x22b launches {n} (expected {expect}); "
        f"router picks parted at near-ties: {routing.flips}")
    if n != expect:
        fails.append(f"sharded mixtral-8x22b launches {n} != {expect}")
    err = rel_err(got["last"], last)
    log(f"  prefill (moe_impl dense) last logits {err:.3e}, cache "
        + ", ".join(f"{k} {rel_err(got['cache'][k], v):.3e}"
                    for k, v in first.items()))
    if not err < TOL_SHARDED:
        fails.append(f"sharded mixtral-8x22b prefill {err:.3e}")
    held_sharded("sharded mixtral-8x22b decode (EP)", steps, got["steps"],
                 fails)
    log(f"  walls: sharded prefill {got['t_pre']:.3f} s, decode step "
        f"{got['t_step']:.2f} ms (4 thread-ranks sharing one card); "
        f"one-device prefill {t_pre:.3f} s, step {t_step:.2f} ms [{card}]")
    del params
    return n


def sharded_main(card: str) -> int:
    """Phase 13 in the child: llama3.2-3b (depth 8) and mixtral-8x22b
    (depth 2) served on a (2, 2) mesh of thread-ranks against their
    one-device runs.  Prints the launch counts by path on a line of their
    own; exit 0 only when every check held."""
    import torch
    if not torch.cuda.is_available():
        log("chip_smoke --sharded: torch.cuda.is_available() is false")
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    from repro_torch.configs import load_all
    load_all()
    wrappers, fails, by_path = all_wrappers(), [], {}
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        log(f"phase 13: llama3.2-3b (depth {SHARDED_LLAMA_DEPTH}) on a (2, 2) "
            f"mesh of thread-ranks")
        by_path["sharded llama3.2-3b"] = sharded_llama(torch, card,
                                                       wrappers, fails)
        gc.collect()
        torch.cuda.empty_cache()
        log(f"phase 13: mixtral-8x22b (depth {SHARDED_DEPTH}) on the same "
            f"mesh, decode through moe_ep")
        by_path["sharded mixtral-8x22b"] = sharded_mixtral(
            torch, card, wrappers, fails)
    log(f"  phase 13 max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / GIB:.2f} GiB [{card}]; wall "
        f"{time.perf_counter() - t0:.1f} s")
    print(SHARDED_COUNTS + json.dumps(by_path), flush=True)
    for f in fails:
        log(f"  FAILED: {f}")
    return 1 if fails else 0


# ---------------------------------------------------------------------------
# phase 14: sharded serving II -- rwkv6-7b, jamba and seamless-m4t on the
# mesh, and the engine (Engine(env=mesh)) over its sharded pool
# ---------------------------------------------------------------------------
# The mesh, the ranks and the options are phase 13's (a child process, 4
# thread-ranks sharing one card).  The limit on every step's logits is
# TOL_SHARDED for these families too (PERF.md, phase 14's prediction); the
# first layer's carried states (rwkv6's wkv and shifts, jamba's conv, ssm,
# k and v, seamless's self cache), which a step computes from its token's
# embedding through one layer, are held to TOL_STATE, as paths A and B and
# phase 10 hold theirs against the forward.  Seamless's cross caches are
# projections of the whole encoder's output (REST_ENCDEC[0] layers deep,
# sharded as the stack that makes the logits), so they are held to
# TOL_SHARDED: on the first run, at 24 + 24 (NVIDIA H100 80GB HBM3,
# 700.00 W), they read 2.64e-2 of their largest magnitude beside the
# prefill's logits at 2.12e-2.
DEEP_STATES = ("cross_k", "cross_v")
REST_B, REST_S, REST_STEPS = 2, 1024, 16
REST_DEPTH = 4                    # rwkv6-7b 32, llama3.2-3b 28 (for time)
REST_JAMBA_DEPTH = 8              # jamba: one superblock of its 32
REST_FRAMES, REST_TGT, REST_ENCDEC_STEPS = 1024, 256, 8
REST_ENCDEC = (8, 8)              # seamless: of 24 + 24 (for time)
REST_COUNTS = "SHARDED_REST_LAUNCHES "


def rest_phase(card: str) -> dict:
    """Phase 14: ``rest_main`` in a child process; its output is echoed,
    and its launch counts by path (a line of their own) returned.  Fails
    unless the child exits 0."""
    sys.stdout.flush()
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                          "--sharded-rest", card], timeout=600,
                         stdout=subprocess.PIPE, text=True)
    counts_ = None
    for line in res.stdout.splitlines():
        if line.startswith(REST_COUNTS):
            counts_ = json.loads(line[len(REST_COUNTS):])
        else:
            log(line)
    log(f"  phase 14 wall with the child's start "
        f"{time.perf_counter() - t0:.1f} s")
    if res.returncode or counts_ is None:
        raise AssertionError(f"phase 14 (sharded serving II) failed: exit "
                             f"{res.returncode}")
    return counts_


def rest_one_device(torch, lm, cfg, params, batch, S, max_len, steps,
                    routing=None):
    """The one-device run: ``lm.prefill`` then ``steps`` greedy
    ``lm.decode_step``s, after an unmeasured prefill and step.  Returns
    {"last", "first" (the prefill's cache, a copy), "steps" (each step's
    logits), "ids", "step0" (the cache after the first step, a copy),
    "after" (the cache after the steps), "t_pre" s, "t_step" ms}."""
    last, cache = lm.prefill(params, batch, cfg, max_len=max_len)
    lm.decode_step(params, last.argmax(-1).to(torch.int32), cache, S, cfg)
    del last, cache
    if routing:
        routing.record()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    last, cache = lm.prefill(params, batch, cfg, max_len=max_len)
    torch.cuda.synchronize()
    out = {"t_pre": time.perf_counter() - t0, "last": last,
           "first": _clone(cache), "steps": [], "ids": []}
    tok = last.argmax(-1).to(torch.int32)
    t0 = time.perf_counter()
    for t in range(steps):
        out["ids"].append(tok)
        lg, cache = lm.decode_step(params, tok, cache, S + t, cfg)
        out["steps"].append(lg)
        tok = lg.argmax(-1).to(torch.int32)
        if t == 0:
            out["step0"] = _clone(cache)
    torch.cuda.synchronize()
    out["t_step"] = (time.perf_counter() - t0) / steps * 1e3
    out["after"] = cache
    return out


def other_shard(t, whole, dim):
    """Rank 1's planted fault: its shard of the cache DTensor ``t``
    overwritten with the block of ``whole`` (the same cache, whole) that
    the other 'model' coordinate holds along ``dim``."""
    import torch.distributed as dist
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    if dist.get_rank() != 1:
        return
    shape, off = compute_local_shape_and_global_offset(
        t.shape, t.device_mesh, t.placements)
    off = list(off)
    off[dim] = (off[dim] + shape[dim]) % t.shape[dim]
    t.to_local().copy_(whole[tuple(slice(o, o + n)
                                   for o, n in zip(off, shape))])


def rest_sharded(torch, cfg, held, batch, S, max_len, one, wrappers, *,
                 steps, moe_impl=None, plant=None, src_len=None,
                 routing=None, swap=None):
    """One world of 4 thread-ranks: the params (``held["params"]``, the
    one reference to them) distributed by their specs (the whole tree then
    dropped), the sharded ``lm.prefill`` (under
    ``moe_impl`` where given) and ``steps`` ``lm.decode_step``s
    teacher-forced with the one-device ids, its launches counted from 0;
    then, as a planted fault, one step from the one-device prefill's cache
    distributed by ``cache_pspecs`` after ``plant(cache, whole)`` edits
    rank 1's shards, or with ``swap`` = (module, name, function) put in
    place for that step.  Returns rank 0's {"last", "cache", "steps", "after",
    "launches", "bad" and "bad_cache" (the planted step's logits and
    cache), "t_pre", "t_step"}, whole on the card."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_worker_mesh, threaded_world
    from repro_torch.models import lm
    from repro_torch.models.sharding import ShardingEnv, distribute

    dp, tp = SHARDED_MESH

    def rank(r):
        env = ShardingEnv(make_worker_mesh(dp * tp, tp=tp))
        env_pre = (ShardingEnv(env.mesh, {"moe_impl": moe_impl})
                   if moe_impl else env)
        ps = distribute(held["params"], lm.param_shardings(cfg, env))
        specs = lm.cache_pspecs(cfg, env, REST_B, max_len, src_len=src_len)
        out = {}

        def sync():
            torch.cuda.synchronize()
            dist.barrier()
            return time.perf_counter()

        sync()
        if r == 0:
            held.clear()                 # the whole params: shards only
            reset(wrappers)
        with torch.no_grad():
            t0 = sync()
            last, c = lm.prefill(ps, batch, cfg, env_pre, max_len=max_len)
            out["t_pre"] = sync() - t0
            out["last"] = last.full_tensor()
            out["cache"] = {k: v.full_tensor() for k, v in c.items()}
            lgs = []
            t0 = sync()
            for t in range(steps):
                lg, c = lm.decode_step(ps, one["ids"][t], c, S + t, cfg, env)
                lgs.append(lg)
            out["t_step"] = (sync() - t0) / steps * 1e3
            if r == 0:
                out["launches"] = counts(wrappers)
                if routing:
                    routing.restore()
            out["steps"] = [lg.full_tensor() for lg in lgs]
            out["after"] = {k: v.full_tensor() for k, v in c.items()}
            del c, lgs
            bad = distribute(_clone(one["first"]), specs)
            if plant:
                plant(bad, one["first"])
            if swap and r == 0:
                kept = getattr(swap[0], swap[1])
                setattr(swap[0], swap[1], swap[2])
            sync()
            lg, bad = lm.decode_step(ps, one["ids"][0], bad, S, cfg, env)
            out["bad"] = lg.full_tensor()
            out["bad_cache"] = {k: v.full_tensor() for k, v in bad.items()}
            sync()
            if swap and r == 0:
                setattr(swap[0], swap[1], kept)
        return out

    with threaded_world(dp * tp, timeout=600) as run:
        return run(rank)[0]


def held_rest(name, cfg, one, got, S, steps, fails, must_move=True):
    """The sharded run against the one-device one: the prefill's last
    logits and each step's within TOL_SHARDED (picks parted only at a
    near-tie, ``held_sharded``), the first layer of each cache entry
    after the prefill and after the steps within TOL_STATE.  The planted
    step's logits at or past TOL_SHARDED (with ``must_move``), else those
    or its cache's first layer past TOL_STATE against the one-device
    step's, as paths A and B hold their faults."""
    hold = holder(cfg, fails)
    hold(f"{name} prefill's last logits", rel_err(got["last"], one["last"]),
         TOL_SHARDED)
    held_sharded(f"{name} decode", one["steps"], got["steps"], fails)
    for when, a, b, n in (("prefill", got["cache"], one["first"], S),
                          ("after the steps", got["after"], one["after"],
                           S + steps)):
        errs = state_errs(a, b, n)
        log(f"  {name} states {when}: " + ", ".join(
            f"{k} first layer {e[0]:.3e}, largest {max(e):.3e}"
            for k, e in errs.items()))
        hold(f"{name} first layer's states {when}", first_layer(
            {k: e for k, e in errs.items() if k not in DEEP_STATES}),
            TOL_STATE[path_of(cfg)])
        deep = {k: e for k, e in errs.items() if k in DEEP_STATES}
        if deep:
            hold(f"{name} first layer's cross caches {when}",
                 first_layer(deep), TOL_SHARDED)
    err = rel_err(got["bad"], one["steps"][0])
    st = first_layer({k: e for k, e in state_errs(
        got["bad_cache"], one["step0"], S + 1).items()
        if k not in DEEP_STATES})
    tol = TOL_STATE[path_of(cfg)]
    log(f"  {name} planted fault: step 0 logits {err:.3e} (limit "
        f"{TOL_SHARDED:g}), first layer's states {st:.3e} (limit {tol:g}); "
        + ("the logits must" if must_move else "one of the two must")
        + " break its limit")
    if err < TOL_SHARDED and (must_move or st < tol):
        fails.append(f"{name}: planted fault not caught ({err:.3e}, "
                     f"{st:.3e})")


def rest_walls(name, one, got, card):
    log(f"  {name} walls: sharded prefill {got['t_pre']:.3f} s, decode step "
        f"{got['t_step']:.2f} ms (4 thread-ranks sharing one card); "
        f"one-device prefill {one['t_pre']:.3f} s, step "
        f"{one['t_step']:.2f} ms [{card}]")


def rest_launches(name, got, expect, wrappers, fails):
    n = got["launches"]
    expect = {**dict.fromkeys(wrappers, 0), **expect}
    log(f"  {name} launches {n} (expected {expect})")
    if n != expect:
        fails.append(f"{name} launches {n} != {expect}")
    return n


def rest_rwkv(torch, card, wrappers, fails):
    """rwkv6-7b at full width, depth REST_DEPTH: 32 of its 64 heads a rank.
    Planted: rank 1 starts its decode from the other model shard's wkv
    heads."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import lm

    cfg = dataclasses.replace(get_config("rwkv6-7b"), n_layers=REST_DEPTH)
    params = ready(torch, lm, cfg)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(15)
    batch = {"tokens": torch.randint(1, cfg.vocab, (REST_B, REST_S),
                                     generator=gen, device="cuda")}
    one = rest_one_device(torch, lm, cfg, params, batch, REST_S, REST_S,
                          REST_STEPS)
    held = {"params": params}
    del params
    got = rest_sharded(torch, cfg, held, batch, REST_S, REST_S, one,
                       wrappers, steps=REST_STEPS,
                       plant=lambda c, w: other_shard(c["wkv"], w["wkv"], 2))
    ranks, L_ = 4, cfg.n_layers
    n = rest_launches("sharded rwkv6-7b", got,
                      {"wkv6": ranks * L_ * (1 + REST_STEPS)}, wrappers,
                      fails)
    held_rest("sharded rwkv6-7b", cfg, one, got, REST_S, REST_STEPS, fails)
    rest_walls("sharded rwkv6-7b", one, got, card)
    return n


def rest_jamba(torch, card, wrappers, fails):
    """jamba-v0.1-52b at full width, depth 8 (one superblock): its 8192
    mamba channels 4096 a rank; the prefill under ``moe_impl="dense"``,
    the decode through ``moe_ep``'s EP branch (8 of 16 experts a rank),
    both held to the one-device run's MoE picks.  Planted: rank 1 starts
    its decode from the other model shard's conv and ssm channels."""
    import dataclasses
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.models.routing_replay import SameRouting

    cfg = dataclasses.replace(get_config("jamba-v0.1-52b"),
                              n_layers=REST_JAMBA_DEPTH)
    params = ready(torch, lm, cfg)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(16)
    batch = {"tokens": torch.randint(1, cfg.vocab, (REST_B, REST_S),
                                     generator=gen, device="cuda")}
    max_len = REST_S + REST_STEPS
    routing = SameRouting()
    one = rest_one_device(torch, lm, cfg, params, batch, REST_S, max_len,
                          REST_STEPS, routing)
    dp, tp = SHARDED_MESH

    def rows(n_rows, m):           # a rank routes its data shard's tokens
        return 0 if n_rows == m else (dist.get_rank() // tp) * m

    routing.replay(rows=rows)
    held = {"params": params}
    del params
    try:
        got = rest_sharded(
            torch, cfg, held, batch, REST_S, max_len, one, wrappers,
            steps=REST_STEPS, moe_impl="dense", routing=routing,
            plant=lambda c, w: (other_shard(c["conv"], w["conv"], 4),
                                other_shard(c["ssm"], w["ssm"], 3)))
    finally:
        routing.restore()
    ranks, nm = 4, cfg.attn_period - 1
    n = rest_launches(
        "sharded jamba", got,
        {"mamba_scan": ranks * nm * (1 + REST_STEPS),
         "flash_prefill": ranks, "paged_append": ranks * REST_STEPS,
         "paged_decode": ranks * REST_STEPS}, wrappers, fails)
    log(f"  sharded jamba: router picks parted at near-ties: "
        f"{routing.flips}")
    held_rest("sharded jamba", cfg, one, got, REST_S, REST_STEPS, fails,
              must_move=False)
    rest_walls("sharded jamba", one, got, card)
    return n


def rest_seamless(torch, card, wrappers, fails):
    """seamless-m4t-large-v2 at full width, depth REST_ENCDEC (of 24 +
    24): 1024 seeded frames (x 0.02), B=2, a 256-token target prompt, 8
    steps; the
    vocabulary (256,206) over 'model' at tp 2.  Planted: in the step,
    rank 1 reads the kv heads of the other model shard's q heads (self and
    cross), as phase 13's fault."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    from repro_torch.models import lm

    ne, nd = REST_ENCDEC
    cfg = dataclasses.replace(get_config("seamless-m4t-large-v2"),
                              n_layers=ne + nd, n_enc_layers=ne,
                              n_dec_layers=nd)
    params = ready(torch, lm, cfg)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(17)
    batch = {"frames": torch.randn(REST_B, REST_FRAMES, cfg.d_model,
                                   generator=gen, device="cuda") * 0.02,
             "tgt_tokens": torch.randint(1, cfg.vocab, (REST_B, REST_TGT),
                                         generator=gen, device="cuda")}
    max_len = REST_TGT + REST_ENCDEC_STEPS
    one = rest_one_device(torch, lm, cfg, params, batch, REST_TGT, max_len,
                          REST_ENCDEC_STEPS)

    kv_for_heads = L._kv_for_heads

    def wrong_heads(k, v, h0, Hl, H):
        import torch.distributed as dist
        if dist.get_rank() == 1:
            h0 = (h0 + Hl) % H
        return kv_for_heads(k, v, h0, Hl, H)

    held = {"params": params}
    del params
    got = rest_sharded(torch, cfg, held, batch, REST_TGT, max_len, one,
                       wrappers, steps=REST_ENCDEC_STEPS, src_len=REST_FRAMES,
                       swap=(L, "_kv_for_heads", wrong_heads))
    ranks, L_ = 4, cfg.n_dec_layers
    n = rest_launches(
        "sharded seamless", got,
        {"flash_prefill": ranks * (cfg.n_enc_layers + 2 * L_),
         "paged_append": ranks * L_ * REST_ENCDEC_STEPS,
         "paged_decode": 2 * ranks * L_ * REST_ENCDEC_STEPS}, wrappers, fails)
    held_rest("sharded seamless", cfg, one, got, REST_TGT, REST_ENCDEC_STEPS,
              fails)
    rest_walls("sharded seamless", one, got, card)
    return n


ENGINE_KW = dict(n_slots=4, max_len=2048, pool_blocks=256, block_size=16)


def engine_state(eng):
    """The engine's host state: tables, lens, free list, resident set,
    slots, counters, copy bytes."""
    p = eng.pool
    return (dict(p.tables), dict(p.lens), list(p.free), sorted(p.resident),
            [(s.session_id, s.length) for s in eng.slots],
            eng.prefill_tokens, eng.regen_tokens, eng.decode_steps,
            eng.park_copy_bytes, eng.resume_copy_bytes)


def engine_script(np, eng, vocab, short=False):
    """Two SWE-bench-shaped sessions (prompts of 1136 and 752 tokens)
    admitted and decoded together (8 rounds); a parks for a tool call,
    a short third session takes its slot (4 rounds with b); a resumes with
    its tool output (208 tokens, a delta prefill) into another slot, the
    first of the other data rank on a (2, 2) mesh (8 rounds of three); b
    releases and a parks.  ``short``: the admits and 2 rounds alone.
    Returns (ids, host states)."""
    rng = np.random.RandomState(18)
    a, b, c, tool = (rng.randint(1, vocab, size=n).astype(np.int32)
                     for n in (1136, 752, 304, 208))
    ids, states = [], []
    sa = eng.start_session("a", a, cached_hit=False)
    sb = eng.start_session("b", b, cached_hit=False)
    out = eng.decode({sa: int(a[-1]), sb: int(b[-1])},
                     n_steps=2 if short else 8)
    ids += [out[sa], out[sb]]
    states.append(engine_state(eng))
    if short:
        return ids, states
    assert eng.park_session("a")
    sc = eng.start_session("c", c, cached_hit=False)
    out = eng.decode({sb: ids[1][-1], sc: int(c[-1])}, n_steps=4)
    ids += [out[sb], out[sc]]
    ctx = np.concatenate([a, np.asarray(ids[0], np.int32), tool])
    sa2 = eng.start_session("a", ctx, cached_hit=True)
    assert sa2 == 2, sa2
    states.append(engine_state(eng))
    out = eng.decode({sa2: int(ctx[-1]), sb: ids[2][-1], sc: ids[3][-1]},
                     n_steps=8)
    ids += [out[sa2], out[sb], out[sc]]
    assert eng.release_session("b") and eng.park_session("a")
    states.append(engine_state(eng))
    return ids, states


class EngineHold:
    """Holds the sharded engines' decode steps to the one-device engine's:
    ``record`` keeps each one-device step's logits; under ``hold`` each
    rank thread compares its step's gathered logits with them in order:
    within TOL_SHARDED of the largest logit, and a row whose greedy pick
    differs must be a near-tie (the one-device top-2 gap below the row's
    difference), its logits then the one-device ones, so the scripts stay
    in step."""

    def __init__(self, torch):
        import threading
        self.torch, self.logits, self.worst, self.flips = torch, [], 0.0, 0
        self.far, self.lock, self.mine = [], threading.Lock(), \
            threading.local()

    def record(self, fn):
        """``fn``: the one-device engine's ``_round_model`` (a step's
        logits, from its round graph on the card)."""
        def call(*args, **kw):
            out = fn(*args, **kw)
            self.logits.append(out[:, 0].float().clone())
            return out
        return call

    def hold(self, fn):
        torch = self.torch

        def call(*args, **kw):
            from torch.distributed.tensor import DTensor, Replicate
            out = fn(*args, **kw)
            if not hasattr(self.mine, "queue"):
                self.mine.queue = list(self.logits)
            ref = self.mine.queue.pop(0)
            whole = out[0].full_tensor()
            got = whole[:, 0].float()
            diff = (got - ref).abs().amax(-1)
            top2 = ref.topk(2, -1).values
            part = got.argmax(-1) != ref.argmax(-1)
            with self.lock:
                self.worst = max(self.worst, rel_err(got, ref))
                self.flips += int(part.sum())
                if bool((part & (top2[:, 0] - top2[:, 1] >= diff)).any()):
                    self.far.append("a greedy pick differs away from a "
                                    "near-tie")
            if not bool(part.any()):
                return out
            whole = whole.clone()
            whole[part, 0] = ref[part].to(whole.dtype)
            mesh = out[0].device_mesh
            return (DTensor.from_local(whole, mesh,
                                       [Replicate()] * mesh.ndim,
                                       run_check=False), *out[1:])
        return call


def rest_engine(torch, np, card, wrappers, fails):
    """llama3.2-3b at full width, depth REST_DEPTH, in
    ``Engine(env=mesh)`` (4 slots over 'data', the pool's 8 kv heads 4 a
    rank, max_len 2048 in blocks of 16) against the one-device engine on
    ``engine_script``: ids equal (parted only at a near-tie,
    ``EngineHold``), host state exact, every rank's pool replica
    byte-equal to its data peer's.
    Planted: one data rank appends its own rows only (the gather of the
    new K/V over 'data' skipped), which must leave its replica unlike its
    peer's."""
    import dataclasses
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_worker_mesh, threaded_world
    from repro_torch.models import layers as L
    from repro_torch.models import lm
    from repro_torch.models.sharding import ShardingEnv, distribute
    from repro_torch.serving.engine import Engine

    cfg = dataclasses.replace(get_config("llama3.2-3b"), n_layers=REST_DEPTH)
    params = ready(torch, lm, cfg)
    hold = EngineHold(torch)
    step = lm.decode_step_paged
    with torch.no_grad():
        Engine(cfg, params, **ENGINE_KW).start_session(
            "warm", np.arange(1, 65, dtype=np.int32), False)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng = Engine(cfg, params, **ENGINE_KW)
        eng._round_model = hold.record(eng._round_model)
        ids_1, states_1 = engine_script(np, eng, cfg.vocab)
        torch.cuda.synchronize()
        t_one = time.perf_counter() - t0
        del eng
    dp, tp = SHARDED_MESH
    held = {"params": params}
    del params
    append = L.append_rows

    def skip_gather(kp, vp, k, v, block_ids, offsets, env, rows, heads):
        append(kp.clone() if env.mesh.get_local_rank("data") == 1 else kp,
               vp.clone() if env.mesh.get_local_rank("data") == 1 else vp,
               k, v, block_ids, offsets, env, rows, heads)
        if env.mesh.get_local_rank("data") == 1:     # its own rows alone
            k0, nk = heads
            L.paged_kv_update(kp, vp, k[:, :, k0:k0 + nk],
                              v[:, :, k0:k0 + nk],
                              L.shard_of(block_ids, env, [rows]),
                              L.shard_of(offsets, env, [rows]))

    def replicas(eng):
        return [t.to_local().clone() for t in (eng.pool.k_pool,
                                               eng.pool.v_pool)]

    def rank(r):
        env = ShardingEnv(make_worker_mesh(dp * tp, tp=tp))
        ps = distribute(held["params"], lm.param_shardings(cfg, env))
        out = {}

        def sync():
            torch.cuda.synchronize()
            dist.barrier()
            return time.perf_counter()

        sync()
        if r == 0:
            held.clear()
            reset(wrappers)
            lm.decode_step_paged = hold.hold(step)
        with torch.no_grad():
            t0 = sync()
            eng = Engine(cfg, ps, env=env, **ENGINE_KW)
            out["ids"], out["states"] = engine_script(np, eng, cfg.vocab)
            out["t"] = sync() - t0
            if r == 0:
                out["launches"] = counts(wrappers)
                lm.decode_step_paged = step
                L.append_rows = skip_gather
            out["pool"], out["audit"] = replicas(eng), eng.pool.audit_blocks()
            del eng
            sync()
            bad = Engine(cfg, ps, env=env, **ENGINE_KW)
            engine_script(np, bad, cfg.vocab, short=True)
            out["bad"] = replicas(bad)
            sync()
            if r == 0:
                L.append_rows = append
        return out

    try:
        with threaded_world(dp * tp, timeout=600) as run:
            res = run(rank)
    finally:
        lm.decode_step_paged, L.append_rows = step, append
    n = res[0]["launches"]
    rounds, prefills = 8 + 4 + 8, 4
    ranks, L_ = dp * tp, cfg.n_layers
    expect = {**dict.fromkeys(wrappers, 0),
              "flash_prefill": ranks * L_ * prefills,
              "paged_append": ranks * L_ * rounds,
              "paged_decode": ranks * L_ * rounds}
    log(f"  sharded engine llama3.2-3b launches {n} (expected {expect})")
    if n != expect:
        fails.append(f"sharded engine launches {n} != {expect}")
    log(f"  sharded engine: every step's logits within {hold.worst:.3e} of "
        f"the one-device engine's (limit {TOL_SHARDED:g}); picks parted at "
        f"near-ties {hold.flips} (all ranks)")
    if hold.worst >= TOL_SHARDED or hold.far:
        fails.append(f"sharded engine logits {hold.worst:.3e}; {hold.far}")
    same = lambda a, b: all(torch.equal(x.view(torch.int16),  # noqa
                                        y.view(torch.int16))
                            for x, y in zip(a, b))
    for r, o in enumerate(res):
        if o["ids"] != ids_1 or o["states"] != states_1 or o["audit"]:
            fails.append(f"sharded engine rank {r}: ids, host state or "
                         f"audit differ from the one-device engine's")
    ok = all(same(o["pool"], res[r % tp]["pool"]) for r, o in enumerate(res))
    bad_ok = all(same(o["bad"], res[r % tp]["bad"])
                 for r, o in enumerate(res))
    log(f"  sharded engine: ids and host state equal to the one-device "
        f"engine's on every rank: {not any('engine rank' in f for f in fails)}"
        f"; pool replicas byte-equal: {ok}; planted skipped gather leaves "
        f"them equal: {bad_ok} (must be False)")
    if not ok or bad_ok:
        fails.append(f"sharded engine replicas equal {ok}, under the "
                     f"planted fault {bad_ok}")
    log(f"  sharded engine walls: the script {res[0]['t']:.2f} s (4 thread-"
        f"ranks sharing one card; 20 rounds, 4 prefills); one device "
        f"{t_one:.2f} s [{card}]")
    return n


def rest_main(card: str) -> int:
    """Phase 14 in the child: rwkv6-7b (depth 4), jamba (depth 8),
    seamless-m4t (8 + 8) and llama3.2-3b's engine (depth 4) served
    on a (2, 2) mesh of thread-ranks against their one-device runs.
    Prints the launch counts by path on a line of their own; exit 0 only
    when every check held."""
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        log("chip_smoke --sharded-rest: torch.cuda.is_available() is false")
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    from repro_torch.configs import load_all
    load_all()
    wrappers, fails, by_path = all_wrappers(), [], {}
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    for key, label, fn in (
            ("sharded rwkv6-7b", f"rwkv6-7b (depth {REST_DEPTH})", rest_rwkv),
            ("sharded jamba", f"jamba-v0.1-52b (depth {REST_JAMBA_DEPTH})",
             rest_jamba),
            ("sharded seamless", "seamless-m4t-large-v2 ({} + {} layers)"
             .format(*REST_ENCDEC), rest_seamless)):
        log(f"phase 14: {label} on a (2, 2) mesh of thread-ranks")
        t_cell = time.perf_counter()
        with torch.no_grad():
            by_path[key] = fn(torch, card, wrappers, fails)
        gc.collect()
        torch.cuda.empty_cache()
        log(f"  {key}'s wall {time.perf_counter() - t_cell:.1f} s [{card}]")
    log(f"phase 14: Engine(env=mesh), llama3.2-3b (depth {REST_DEPTH})")
    by_path["sharded engine llama3.2-3b"] = rest_engine(torch, np, card,
                                                        wrappers, fails)
    log(f"  phase 14 max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / GIB:.2f} GiB [{card}]; wall "
        f"{time.perf_counter() - t0:.1f} s")
    print(REST_COUNTS + json.dumps(by_path), flush=True)
    for f in fails:
        log(f"  FAILED: {f}")
    return 1 if fails else 0


# ---------------------------------------------------------------------------
# phase 15: sharded training -- forward_train(env), its backward, sharded
# AdamW, train_loop(mesh=...) and checkpoints across meshes on 4
# thread-ranks sharing the card
# ---------------------------------------------------------------------------
# A child process (``--sharded-train``), as phases 13 and 14: a ("data",
# "model") mesh of (2, 2) of thread-ranks on "cuda" under train_loop's
# mesh options (sp, fsdp, moe_impl "ep", no remat), against the one-device
# run on the card on the same seed-0 params and batch.  The limits and
# their reasons are PERF.md's (phase 15's cells, written before the first
# run on the card): the loss relative to the one-device loss; each
# gradient leaf's largest |difference| over the leaf's largest one-device
# magnitude (every element of every leaf: each rank its blocks against the
# one-device gradient's); the AdamW steps' losses and global norms
# relative.  The MoE cells give each expert room for all of a rank's
# tokens (capacity factor E / top_k), as the CPU tests do: the one-device
# run is the dense impl, which drops nothing; no pair may drop.
TRAIN_MESH = (2, 2)
TRAIN_OPTS = {"remat": False, "sp": True, "moe_impl": "ep"}
TOL_SHARDED_LOSS = 2e-3
TOL_SHARDED_GRAD = 5e-2
TOL_SHARDED_STEPS = 2e-3
TRAIN_COUNTS = "SHARDED_TRAIN_LAUNCHES "
TRAIN_B, TRAIN_S = 2, 512                 # llama3.2-3b: phase 11's 2 x 1024
TRAIN_DEPTH = {"llama3.2-3b": 4,          # of 28
               "mixtral-8x22b": 2,        # of 56
               "rwkv6-7b": 1,             # of 32 in bf16 (PERF.md)
               "jamba-v0.1-52b": 8}       # of 32: one superblock
TRAIN_F32_DEPTH = 2                       # rwkv6-7b's f32 cell, of 32
TRAIN_ENCDEC = (4, 4)                     # seamless: of 24 + 24
TRAIN_FRAMES, TRAIN_TGT = 512, 128
TRAIN_STEPS, TRAIN_SAVE = 4, 2
# the recurrences' rows cut for time (their scans under autograd are loops
# over the sequence, each of 4 ranks' steps under one GIL): jamba's cell
# 240 s at 512 on an NVIDIA H100 80GB HBM3 at 700 W
TRAIN_SEQ = {"rwkv6-7b": 256, "jamba-v0.1-52b": 128}
CHUNK = 1 << 24


def sharded_train_phase(card: str) -> dict:
    """Phase 15: ``sharded_train_main`` in a child process; its output
    echoed, its launch counts by path returned.  Fails unless the child
    exits 0."""
    sys.stdout.flush()
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                          "--sharded-train", card], timeout=600,
                         stdout=subprocess.PIPE, text=True)
    counts_ = None
    for line in res.stdout.splitlines():
        if line.startswith(TRAIN_COUNTS):
            counts_ = json.loads(line[len(TRAIN_COUNTS):])
        else:
            log(line)
    log(f"  phase 15 wall with the child's start "
        f"{time.perf_counter() - t0:.1f} s")
    if res.returncode or counts_ is None:
        raise AssertionError(f"phase 15 (sharded training) failed: exit "
                             f"{res.returncode}")
    return counts_


def train_cfg(name, depth=None):
    """``name``'s config at full width with phase 15's depth (``depth``
    where given), registered under a name of its own (``train_loop``
    takes a name)."""
    import dataclasses
    from repro_torch.configs import get_config, register
    cfg = get_config(name)
    if cfg.enc_dec:
        ne, nd = TRAIN_ENCDEC
        cfg = dataclasses.replace(cfg, name=f"{name}-{ne}+{nd}",
                                  n_enc_layers=ne, n_dec_layers=nd)
    else:
        depth = depth or TRAIN_DEPTH[name]
        cfg = dataclasses.replace(cfg, name=f"{name}-d{depth}",
                                  n_layers=depth)
    return register(cfg)


def n_layers(cfg) -> int:
    return cfg.n_enc_layers + cfg.n_dec_layers if cfg.enc_dec \
        else cfg.n_layers


class Collectives:
    """Counts the collectives each rank thread makes on the threaded
    process group (``ProcessLocalGroup``'s all-reduce, all-gather and
    reduce-scatter, the tiled forms included)."""

    def __init__(self):
        import threading
        from torch.testing._internal.distributed import multi_threaded_pg
        self.cls = multi_threaded_pg.ProcessLocalGroup
        self.mine = threading.local()
        self.kept = {n: getattr(self.cls, n) for n in
                     ("allreduce", "allgather", "reduce_scatter")}
        for name, fn in self.kept.items():
            setattr(self.cls, name, self._counted(fn))

    def _counted(self, fn):
        def call(*a, **kw):
            self.mine.n = getattr(self.mine, "n", 0) + 1
            return fn(*a, **kw)
        return call

    def take(self) -> int:
        n, self.mine.n = getattr(self.mine, "n", 0), 0
        return n

    def close(self):
        for name, fn in self.kept.items():
            setattr(self.cls, name, fn)


def train_seq(name) -> int:
    """The tokens a row of ``name``'s phase 15 cell."""
    return TRAIN_SEQ.get(name, TRAIN_S)


def train_batch(torch, cfg, seed, S=TRAIN_S):
    """A seeded B x S training batch on the card (seamless: frames x 0.02,
    target tokens and labels)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)

    def ints(s):
        return torch.randint(0, cfg.vocab, (TRAIN_B, s), generator=gen,
                             device="cuda")
    if cfg.enc_dec:
        return {"frames": torch.randn(TRAIN_B, TRAIN_FRAMES, cfg.d_model,
                                      generator=gen, device="cuda") * 0.02,
                "tgt_tokens": ints(TRAIN_TGT), "tgt_labels": ints(TRAIN_TGT)}
    return {"tokens": ints(S), "labels": ints(S)}


def train_one(torch, lm, cfg, params, batch, routing=None, warm=False):
    """The one-device loss and gradients on the card (after an unmeasured
    forward and backward where ``warm``); forward and backward timed apart
    (``routing`` records the measured forward's MoE picks); the gradients
    moved to host memory with each leaf's largest magnitude.  Returns
    {"loss", "grads", "tops", "t_fwd", "t_bwd"}; the params' grads
    cleared."""
    for _, p in named_leaves(params):
        p.requires_grad_(True)
    if warm:
        lm.forward_train(params, batch, cfg).backward()
        clear_grads(params)
    if routing:
        routing.record()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = lm.forward_train(params, batch, cfg)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    if routing:
        routing.restore()
    loss.backward()
    torch.cuda.synchronize()
    out = {"loss": float(loss.detach()), "t_fwd": t1 - t0,
           "t_bwd": time.perf_counter() - t1, "grads": {}, "tops": {}}
    for name, p in named_leaves(params):
        out["tops"][name] = float(p.grad.abs().max())
        out["grads"][name] = p.grad.to("cpu")
        p.grad = None
    return out


def local_block(t):
    """(offset, shape) of this rank's block of the DTensor t."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    shape, off = compute_local_shape_and_global_offset(
        t.shape, t.device_mesh, t.placements)
    return tuple(slice(o, o + n) for o, n in zip(off, shape))


def grad_errs(torch, ps, one):
    """Each leaf's largest |sharded - one-device| over this rank's blocks
    (the one-device gradient's block copied to the card a slab at a
    time), and whether every gradient is laid out as its param."""
    errs, laid = {}, True
    for name, p in named_leaves(ps):
        g = p.grad
        laid = laid and g is not None and g.placements == p.placements
        local = g.to_local().reshape(-1)
        block = one["grads"][name][local_block(p)].contiguous().reshape(-1)
        errs[name] = max(
            float((local[i:i + CHUNK].float()
                   - block[i:i + CHUNK].to("cuda").float()).abs().max())
            for i in range(0, local.numel(), CHUNK))
    return errs, laid


def train_world(torch, cfg, held, batch, one, wrappers, plants=(),
                after=None, warm=False):
    """4 thread-ranks: the params (``held["params"]``, the one reference
    to them) distributed by ``param_shardings`` (the whole tree then
    dropped); ``lm.forward_train`` and its backward timed apart with their
    collectives counted (after an unmeasured pair where ``warm``), the
    launches counted from 0; each leaf's gradient against ``one``'s
    (``grad_errs``); each planted fault (name, put, take: rank 0 calls
    ``put()`` before and ``take()`` after the fault's forward and
    backward) and its gradients' errors; then ``after(env, rank)`` (its
    result under "after").  Returns every rank's dict."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_worker_mesh, threaded_world
    from repro_torch.models import lm
    from repro_torch.models.sharding import ShardingEnv, distribute

    dp, tp = TRAIN_MESH
    coll = Collectives()

    def rank(r):
        env = ShardingEnv(make_worker_mesh(dp * tp, tp=tp), TRAIN_OPTS)
        ps = distribute(held["params"], lm.param_shardings(cfg, env))
        for _, p in named_leaves(ps):
            p.requires_grad_(True)
        out = {"plants": {}}

        def sync():
            torch.cuda.synchronize()
            dist.barrier()
            return time.perf_counter()

        sync()
        if r == 0:
            held.clear()                 # the whole params: shards only
            reset(wrappers)
        if warm:
            lm.forward_train(ps, batch, cfg, env).backward()
            clear_grads(ps)
        t0 = sync()
        coll.take()
        loss = lm.forward_train(ps, batch, cfg, env)
        n_fwd = coll.take()
        t1 = sync()
        loss.backward()
        n_bwd = coll.take()
        t2 = sync()
        out.update(loss=float(loss.detach()), t_fwd=t1 - t0, t_bwd=t2 - t1,
                   n_fwd=n_fwd, n_bwd=n_bwd)
        del loss
        if r == 0:
            out["launches"] = counts(wrappers)
        out["errs"], out["laid"] = grad_errs(torch, ps, one)
        for name, put, take in plants:
            clear_grads(ps)
            sync()
            if r == 0:
                put()
            sync()
            lm.forward_train(ps, batch, cfg, env).backward()
            sync()
            if r == 0:
                take()
            out["plants"][name] = grad_errs(torch, ps, one)[0]
        clear_grads(ps)
        del ps
        if after is not None:
            out["after"] = after(env, r)
        return out

    try:
        with threaded_world(dp * tp, timeout=600) as run:
            return run(rank)
    finally:
        coll.close()


def held_train(label, cfg, one, outs, fails, card, plant_leaves=None):
    """The sharded loss (equal on every rank) and every gradient leaf
    against the one-device run's; each planted fault past the limit on
    its leaves (all where None).  Logs the walls and the collectives."""
    losses = [o["loss"] for o in outs]
    rel = abs(losses[0] - one["loss"]) / abs(one["loss"])
    errs = {n: max(o["errs"][n] for o in outs) / max(one["tops"][n], 1e-30)
            for n in one["tops"]}
    worst = max(errs, key=errs.get)
    laid = all(o["laid"] for o in outs)
    log(f"  {label}: loss {losses[0]:.6f} on every rank: "
        f"{len(set(losses)) == 1}; one device {one['loss']:.6f}, "
        f"{rel:.3e} relative (limit {TOL_SHARDED_LOSS:g}); gradients laid "
        f"out as the params: {laid}; largest leaf error {errs[worst]:.3e} "
        f"({worst}) of {len(errs)} leaves (limit {TOL_SHARDED_GRAD:g})")
    if len(set(losses)) != 1 or not rel < TOL_SHARDED_LOSS:
        fails.append(f"{label}: losses {losses} against {one['loss']}")
    if not laid:
        fails.append(f"{label}: a gradient not laid out as its param")
    bad = {n: e for n, e in errs.items() if not e < TOL_SHARDED_GRAD}
    if bad:
        fails.append(f"{label}: gradient leaves past the limit {bad}")
    log(f"  {label}: the next leaves' errors "
        + ", ".join(f"{n} {errs[n]:.3e}" for n in sorted(
            errs, key=errs.get, reverse=True)[1:5]))
    per = n_layers(cfg)
    log(f"  {label} walls (4 thread-ranks sharing one card): forward "
        f"{outs[0]['t_fwd']:.3f} s, backward {outs[0]['t_bwd']:.3f} s; one "
        f"device forward {one['t_fwd']:.3f} s, backward {one['t_bwd']:.3f} "
        f"s [{card}]; collectives a layer and rank: forward "
        f"{outs[0]['n_fwd'] / per:.1f}, backward "
        f"{outs[0]['n_bwd'] / per:.1f}")
    for name, leaves in (plant_leaves or {}).items():
        got = {n: max(o["plants"][name][n] for o in outs)
               / max(one["tops"][n], 1e-30) for n in one["tops"]}
        names = leaves or [max(got, key=got.get)]
        seen = max(got[n] for n in names)
        log(f"  planted fault, {name}: {seen:.3e} on {names} (must reach "
            f"{TOL_SHARDED_GRAD:g})")
        if not seen >= TOL_SHARDED_GRAD:
            fails.append(f"{label}: planted {name} unseen ({seen:.3e})")


def zero_launches(label, outs, fails):
    n = outs[0]["launches"]
    log(f"  {label} launches {n} (none expected: no kernel has a "
        f"backward)")
    if any(n.values()):
        fails.append(f"{label} launched {n}")
    return n


def swap_in(mod, name, fn):
    """(put, take) of a planted fault: ``mod.name`` replaced by
    ``fn(mod.name)``, then put back."""
    kept = getattr(mod, name)
    return (lambda: setattr(mod, name, fn(kept)),
            lambda: setattr(mod, name, kept))


def fsdp_cut(gather):
    """``sharding._gather_mesh`` whose gathers over 'data' (the FSDP
    gathers) transpose to a cut: a weight's gradient misses the other
    data rank's rows (planted)."""
    import torch

    class CutBack(torch.autograd.Function):
        @staticmethod
        def forward(ctx, t, out, n, dim, r):
            ctx.n, ctx.dim, ctx.r = n, dim, r
            return out

        @staticmethod
        def backward(ctx, g):
            k = g.shape[ctx.dim] // ctx.n
            return (g.narrow(ctx.dim, ctx.r * k, k), None, None, None,
                    None)

    def planted(t, mesh, axis, dim):
        if axis != "data":
            return gather(t, mesh, axis, dim)
        with torch.no_grad():
            out = gather(t, mesh, axis, dim)
        return CutBack.apply(t, out, mesh.size(0), dim,
                             mesh.get_local_rank("data"))
    return planted


def conv_on_shards(conv):
    """jamba's causal conv taken on each of the 'model' sequence shards
    alone (planted): each shard after the first misses the d_conv - 1
    tokens before it."""
    import torch

    def planted(x, w, b):
        return torch.cat([conv(p, w, b) for p in
                          x.chunk(TRAIN_MESH[1], dim=1)], dim=1)
    return planted


def room_for_all(L, cfg):
    """(put, take): ``moe_ep`` with room in each expert for all of a
    rank's tokens."""
    import functools
    kept = L.moe_ep
    put = functools.partial(kept, capacity_factor=cfg.n_experts / cfg.top_k)
    return (lambda: setattr(L, "moe_ep", put),
            lambda: setattr(L, "moe_ep", kept))


def dropped_pairs(L):
    """``layers._dispatch`` counting the pairs a rank's capacity drops;
    returns (the counts, take)."""
    kept, drops = L._dispatch, []

    def counted(top_p, top_e, e_start, e_local, capacity):
        out = kept(top_p, top_e, e_start, e_local, capacity)
        mine = (top_e >= e_start) & (top_e < e_start + e_local)
        drops.append(int(mine.sum()) - int(out[0].sum()))
        return out
    L._dispatch = counted
    return drops, lambda: setattr(L, "_dispatch", kept)


def ln_x_f32(x, scale, n_heads, eps=1e-5):
    """rwkv6's ``group_norm_heads`` (ln_x) with its output left in f32:
    the port rounds it to bf16, as the reference does, which an f32 run
    would otherwise keep."""
    import torch
    orig = x.shape
    x = x.reshape(*orig[:-1], n_heads, orig[-1] // n_heads).float()
    x = (x - x.mean(dim=-1, keepdim=True)) * torch.rsqrt(
        x.var(dim=-1, unbiased=False, keepdim=True) + eps)
    return x.reshape(orig) * scale.float()


def one_ulp(torch, params, seed):
    """``params`` each moved by about one f32 ulp: times 1 + 2^-24 n, n
    standard normal from a seeded generator."""
    from repro_torch.train.optimizer import tree_map
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    return tree_map(lambda t: (t * (1 + 2.0 ** -24 * torch.randn(
        t.shape, generator=gen, device="cuda"))).detach(), params)


def host_spread(torch, a, b):
    """(the largest leaf error of ``b``'s host gradients against ``a``'s,
    over ``a``'s largest magnitude in the leaf; that leaf), compared on
    the card a slab at a time."""
    errs = {}
    for name, g in a["grads"].items():
        x, y = g.reshape(-1), b["grads"][name].reshape(-1)
        errs[name] = max(
            float((x[i:i + CHUNK].to("cuda").float()
                   - y[i:i + CHUNK].to("cuda").float()).abs().max())
            for i in range(0, x.numel(), CHUNK)) / max(a["tops"][name],
                                                        1e-30)
    worst = max(errs, key=errs.get)
    return errs[worst], worst


def train_cell(torch, card, wrappers, fails, name, seed, plants=(),
               plant_leaves=None, f32=None, depth=None, cfg=None):
    """One step's loss and gradients of ``name`` (phase 15's depth, or
    ``depth``; ``train_seq(name)`` tokens a row) on the mesh against one
    device: the MoE archs held to the one-device run's picks and asserted
    to drop no pair.  With ``f32`` ("unrounded": rwkv6's ln_x
    output left in f32 in both runs, ``ln_x_f32``; "rounded": as the port
    rounds it) every param is f32 in both runs, and the one-device
    gradients' own spread (the params moved by one f32 ulp, ``one_ulp``)
    is logged beside the mesh's error.  ``cfg``: a config of ``name``'s
    family to run instead of phase 15's (``name`` still sets the rows)."""
    import torch.distributed as dist
    from repro_torch.models import layers as L
    from repro_torch.models import lm
    from repro_torch.models import rwkv as R
    from repro_torch.models.routing_replay import SameRouting
    from repro_torch.train.optimizer import tree_map

    cfg = cfg or train_cfg(name, depth)
    label = f"sharded train {name.split('-')[0]}"
    if f32:
        ln_x = f", ln_x {f32}" if cfg.family == "ssm" else ""
        label += f" (f32{ln_x}, depth {cfg.n_layers})"
    batch = train_batch(torch, cfg, seed, train_seq(name))
    params = ready(torch, lm, cfg)
    takes = []
    if f32:
        params = tree_map(lambda t: t.float(), params)
        if f32 == "unrounded":
            put, take = swap_in(R, "group_norm_heads", lambda _: ln_x_f32)
            put()
            takes.append(take)
    routing = SameRouting() if cfg.n_experts else None
    one = train_one(torch, lm, cfg, params, batch, routing)
    if f32:
        moved = one_ulp(torch, params, seed)
        spread = host_spread(torch, one, train_one(torch, lm, cfg, moved,
                                                   batch))
        del moved
        log(f"  {label}: one device against itself with the params moved "
            f"by one f32 ulp: largest leaf error {spread[0]:.3e} "
            f"({spread[1]}) [{card}]")
    gc.collect()
    torch.cuda.empty_cache()
    held = {"params": params}
    del params
    tp = TRAIN_MESH[1]

    def rows(n_rows, m):           # a rank routes its data shard's tokens
        return 0 if n_rows == m else (dist.get_rank() // tp) * m

    drops = []
    if routing:
        routing.replay(rows=rows)
        put, take = room_for_all(L, cfg)
        put()
        drops, undo = dropped_pairs(L)
        takes += [take, undo, routing.restore]
        plants = tuple((n, lambda p=p: (p(), routing.replay(rows=rows)), t)
                       for n, p, t in plants)
    try:
        outs = train_world(torch, cfg, held, batch, one, wrappers, plants)
    finally:
        for take in takes:
            take()
    n = zero_launches(label, outs, fails)
    held_train(label, cfg, one, outs, fails, card, plant_leaves)
    if routing:
        log(f"  {label}: router picks parted at near-ties {routing.flips}; "
            f"pairs dropped {sum(drops)} (must be 0)")
        if sum(drops):
            fails.append(f"{label}: moe_ep dropped {sum(drops)} pairs")
    del one, outs
    gc.collect()
    torch.cuda.empty_cache()
    return n


def conditioning(torch, card, name, depth, seed):
    """``name`` at ``depth``, one device: its bf16 gradients against the
    same params' in f32 (the smallest leaf cosine, the largest leaf error
    of the f32 leaf's largest magnitude): how far bf16 rounding alone
    moves the gradients, which bounds what a sharded run can be held
    to."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.train.optimizer import tree_map
    cfg = dataclasses.replace(get_config(name), n_layers=depth)
    batch = train_batch(torch, cfg, seed, train_seq(name))
    params = lm.init_params(cfg, 0, "cuda")
    grads = []
    for tree in (params, tree_map(lambda t: t.float(), params)):
        for _, p in named_leaves(tree):
            p.requires_grad_(True)
        lm.forward_train(tree, batch, cfg).backward()
        grads.append({n: p.grad.float() for n, p in named_leaves(tree)})
        clear_grads(tree)
    b16, f32 = grads
    cos = min(float((b16[n] * f32[n]).sum()
                    / (b16[n].norm() * f32[n].norm() + 1e-30)) for n in f32)
    err = max(float((b16[n] - f32[n]).abs().max() / f32[n].abs().max())
              for n in f32)
    log(f"  {name} at depth {depth}, one device: bf16 gradients against "
        f"f32 ones, smallest leaf cosine {cos:.4f}, largest leaf error "
        f"{err:.3e} [{card}]")
    del params, grads, b16, f32
    gc.collect()
    torch.cuda.empty_cache()


def sharded_train_llama(torch, card, wrappers, fails):
    """llama3.2-3b at full width, depth 4, B=2 x 1024 ``SyntheticLM``
    tokens (phase 11's batch): step 0 on one device against the mesh (the
    loss, every gradient leaf; planted: ln1's gradient left as each
    rank's share, the FSDP gather of wq transposed as a cut); then
    ``train_loop`` for 4 AdamW steps each way (losses and gnorms), the
    mesh's saving a checkpoint at step 2 and resuming from it; that
    checkpoint restored on the mesh and on one device, every rank's
    blocks bit-equal to the saving run's state."""
    import shutil
    import tempfile
    from repro_torch.launch import train as T
    from repro_torch.models import lm
    from repro_torch.models import sharding as SH
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.data import SyntheticLM
    from repro_torch.train.optimizer import abstract_opt_state, opt_pspecs

    cfg = train_cfg("llama3.2-3b")
    label = "sharded train llama3.2-3b"
    B, S, lr = 2, 1024, 3e-4
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in SyntheticLM(cfg, B, S, seed=0).next().items()}
    one = train_one(torch, lm, cfg, ready(torch, lm, cfg), batch, warm=True)
    gc.collect()
    torch.cuda.empty_cache()
    gnorms = {"one": [], "mesh": []}
    make = T.make_train_step

    def recording(key):
        def build(*a, **kw):
            step = make(*a, **kw)

            def run(*args):
                import torch.distributed as dist
                loss, gnorm = step(*args)
                if key == "one" or dist.get_rank() == 0:
                    gnorms[key].append(float(gnorm))
                return loss, gnorm
            return run
        return build

    kw = dict(batch=B, seq=S, lr=lr, seed=0, log_every=1)
    T.make_train_step = recording("one")
    try:
        t0 = time.perf_counter()
        _, _, losses_one = T.train_loop(cfg.name, steps=TRAIN_STEPS,
                                        device="cuda", **kw)
        t_one = time.perf_counter() - t0
    finally:
        T.make_train_step = make
    gc.collect()
    torch.cuda.empty_cache()
    d = tempfile.mkdtemp()

    def loop(env, r):
        """train_loop on the mesh: 2 steps and a checkpoint, then resumed
        to step 4; the checkpoint restored on the mesh."""
        t0 = time.perf_counter()
        p2, o2, first = T.train_loop(cfg.name, steps=TRAIN_SAVE,
                                     mesh=env.mesh, ckpt_dir=d,
                                     ckpt_every=TRAIN_SAVE, **kw)
        t_save = time.perf_counter() - t0
        leaves = (named_values(p2) + named_values(o2.mu)
                  + named_values(o2.nu))
        saved = [(t.to_local().clone(), local_block(t)) for t in leaves]
        del p2, o2, leaves
        t0 = time.perf_counter()
        _, _, rest = T.train_loop(cfg.name, steps=TRAIN_STEPS,
                                  mesh=env.mesh, ckpt_dir=d, resume=True,
                                  **kw)
        t_resume = time.perf_counter() - t0
        sh = lm.param_shardings(cfg, env)
        ap = lm.abstract_params(cfg)
        _, p3, o3, _ = ckpt.restore_checkpoint(
            d, ap, abstract_opt_state(ap), step=TRAIN_SAVE, device="cuda",
            shardings=(sh, opt_pspecs(sh)))
        back = named_values(p3) + named_values(o3.mu) + named_values(o3.nu)
        equal = all(torch.equal(a, b.to_local())
                    for (a, _), b in zip(saved, back))
        return {"losses": first + rest, "equal": equal, "saved": saved,
                "t_save": t_save, "t_resume": t_resume}

    T.make_train_step = recording("mesh")
    try:
        outs = train_world(
            torch, cfg, {"params": ready(torch, lm, cfg)}, batch, one,
            wrappers, warm=True, after=loop,
            plants=(("ln1's gradient left as each rank's share",
                     *swap_in(SH, "copies", lambda f: lambda tree: tree)),
                    ("the FSDP gather of wq transposed as a cut",
                     *swap_in(SH, "_gather_mesh", fsdp_cut))))
    finally:
        T.make_train_step = make
    n = zero_launches(label, outs, fails)
    held_train(label, cfg, one, outs, fails, card,
               {"ln1's gradient left as each rank's share": ["layers/ln1"],
                "the FSDP gather of wq transposed as a cut":
                    ["layers/attn/wq"]})
    got = outs[0]["after"]
    rel = [abs(a - b) / abs(b) for a, b in
           zip(got["losses"] + gnorms["mesh"], losses_one + gnorms["one"])]
    log(f"  train_loop, {TRAIN_STEPS} AdamW steps at lr {lr} [{card}]: one "
        f"device losses {[round(x, 5) for x in losses_one]} gnorms "
        f"{[round(x, 4) for x in gnorms['one']]} ({t_one:.1f} s); mesh "
        f"losses {[round(x, 5) for x in got['losses']]} gnorms "
        f"{[round(x, 4) for x in gnorms['mesh']]} (2 steps and the "
        f"checkpoint {got['t_save']:.1f} s, resumed to step {TRAIN_STEPS} "
        f"{got['t_resume']:.1f} s); largest relative difference "
        f"{max(rel):.3e} (limit {TOL_SHARDED_STEPS:g})")
    if len(rel) != 2 * TRAIN_STEPS or not max(rel) < TOL_SHARDED_STEPS:
        fails.append(f"{label}: AdamW steps' losses or gnorms past the "
                     f"limit ({rel})")
    mesh_equal = all(o["after"]["equal"] for o in outs)
    ap = lm.abstract_params(cfg)
    _, p1, o1, _ = ckpt.restore_checkpoint(d, ap, abstract_opt_state(ap),
                                           step=TRAIN_SAVE, device="cuda")
    whole = named_values(p1) + named_values(o1.mu) + named_values(o1.nu)
    one_equal = all(torch.equal(a, whole[i][index])
                    for o in outs
                    for i, (a, index) in enumerate(o["after"]["saved"]))
    log(f"  the step-{TRAIN_SAVE} checkpoint (saved from the mesh) "
        f"restored: on the mesh, every rank's state bit-equal "
        f"{mesh_equal}; on one device, every rank's blocks bit-equal "
        f"{one_equal}")
    if not (mesh_equal and one_equal):
        fails.append(f"{label}: a restored state differs from the saved")
    del p1, o1, whole, outs
    shutil.rmtree(d, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return n


def named_values(tree):
    return [t for _, t in named_leaves(tree)]


def spread_study(torch, card, wrappers):
    """``--spread``: how far the mesh's gradients part from one device's
    where the gradients are ill-conditioned.  rwkv6-7b in f32 at depths 2
    and 4 with its ln_x output rounded to bf16 (as the port does), and
    at depth 2 unrounded (phase 15's f32 cell), each beside one
    device's own spread under a one-ulp move of the params; jamba (phase
    15's cell without its planted fault) on its seed twice and on a
    second seed.  Logs every reading against the
    limit; fails nothing."""
    readings = []
    for f32, depth in (("rounded", 2), ("rounded", 4), ("unrounded", 2)):
        log(f"spread: rwkv6-7b in f32, ln_x {f32}, depth {depth}")
        train_cell(torch, card, wrappers, readings, "rwkv6-7b", 22,
                   f32=f32, depth=depth)
    for seed in (23, 23, 25):
        log(f"spread: jamba-v0.1-52b, seed {seed}")
        train_cell(torch, card, wrappers, readings, "jamba-v0.1-52b", seed)
    for r in readings:
        log(f"  past a limit (a reading, not a failure here): {r}")


def f32_checks(torch, np, card, wrappers):
    """``--f32-checks``: ROADMAP.md Queue 3's two open checks, in f32 on
    the card; logs each reading against its limit and fails nothing.

    (a) Path A (phase 5) with every param of rwkv6-7b in f32 and ln_x's
    output unrounded (``ln_x_f32``) in the decode and the forward alike:
    its last decode step against its own forward, beside the bf16 path's
    5.39e-2 of the largest logit.  The ``wkv6`` kernel takes bf16 r, k, v,
    so this run takes its plain version (the same f32 recurrence) on the
    card, in both.  (b) jamba's sharded gradients in f32 (phase 15's cell,
    seed 23, its rows, no planted fault) beside one device's own spread
    under a one-ulp move of the params.  Its superblock is cut to
    ``attn_period`` 2 slots of full width, one mamba layer with its FFN
    and the attention layer with its MoE (slot ``per // 2`` and
    ``layer_is_moe``'s odd slot): a depth cut keeps whole superblocks of 8,
    and one of them in f32 (~52 GiB of params) does not fit its gradients
    beside it on 80 GB."""
    import dataclasses
    from repro_torch.configs import get_config, register
    from repro_torch.kernels.rwkv6 import ops as RK
    from repro_torch.models import lm
    from repro_torch.models import rwkv as R
    from repro_torch.train.optimizer import tree_map

    readings = []
    log(f"f32 check (a): rwkv6-7b path A in f32, ln_x unrounded, wkv6's "
        f"plain version in the decode and the forward [{card}]")
    cfg = get_config("rwkv6-7b")
    params = tree_map(lambda t: t.float(), ready(torch, lm, cfg))
    gc.collect()
    torch.cuda.empty_cache()
    none = dict.fromkeys(wrappers, 0)
    with swapped(R, "wkv6", lambda _: RK.wkv6_plain), \
            swapped(R, "group_norm_heads", lambda _: ln_x_f32):
        _, fails = serve_path(torch, np, card, wrappers, cfg, params, 4,
                              none, none)
    readings += fails
    del params
    gc.collect()
    torch.cuda.empty_cache()
    log(f"f32 check (b): jamba's sharded gradients in f32, superblock of 2 "
        f"slots (mamba + FFN, attention + MoE) [{card}]")
    base = get_config("jamba-v0.1-52b")
    small = register(dataclasses.replace(
        base, name=f"{base.name}-p2", attn_period=2, n_layers=2))
    train_cell(torch, card, wrappers, readings, base.name, 23,
               f32="rounded", cfg=small)
    for r in readings:
        log(f"  past a limit (a reading, not a failure here): {r}")


def sharded_train_main(card: str) -> int:
    """Phase 15 in the child: llama3.2-3b (depth 4: step 0, AdamW,
    checkpoints across meshes), mixtral-8x22b (depth 2), rwkv6-7b (depth
    1 in bf16, depth 2 in f32), jamba (depth 8) and seamless-m4t (4 + 4)
    trained on a (2, 2) mesh of thread-ranks against their one-device
    runs (``--spread``: ``spread_study`` instead).  Prints the launch
    counts by path on a line of their own; exit 0 only when every check
    held."""
    import os
    # 4 ranks' shards, gradients and gathered expert weights share the
    # card: segments that grow keep the allocator's blocks from splitting
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    import torch
    if not torch.cuda.is_available():
        log("chip_smoke --sharded-train: torch.cuda.is_available() is "
            "false")
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    from repro_torch.configs import load_all
    from repro_torch.models import mamba as M
    load_all()
    wrappers, fails, by_path = all_wrappers(), [], {}
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    only = set(sys.argv[3:])         # cells by arch name; all where none
    if only == {"--spread"}:
        spread_study(torch, card, wrappers)
        return 0
    if only == {"--f32-checks"}:
        import numpy as np
        f32_checks(torch, np, card, wrappers)
        return 0
    if not only or "llama3.2-3b" in only:
        log(f"phase 15: llama3.2-3b (depth {TRAIN_DEPTH['llama3.2-3b']}) "
            f"trained on a (2, 2) mesh of thread-ranks")
        t_cell = time.perf_counter()
        by_path["sharded train llama3.2-3b"] = sharded_train_llama(
            torch, card, wrappers, fails)
        log(f"  llama3.2-3b's cell wall {time.perf_counter() - t_cell:.1f} s "
            f"[{card}]")
    for key, name, seed, plants, leaves in (
            ("sharded train mixtral", "mixtral-8x22b", 21, (), None),
            ("sharded train rwkv6-7b", "rwkv6-7b", 22, (), None),
            ("sharded train jamba", "jamba-v0.1-52b", 23,
             (("jamba's conv taken on the sequence shard",
               *swap_in(M, "_causal_depthwise_conv", conv_on_shards)),),
             {"jamba's conv taken on the sequence shard": None}),
            ("sharded train seamless", "seamless-m4t-large-v2", 24, (),
             None)):
        if only and name not in only:
            continue
        log(f"phase 15: {name} trained on the same mesh")
        t_cell = time.perf_counter()
        by_path[key] = train_cell(torch, card, wrappers, fails, name, seed,
                                  plants, leaves)
        if name == "rwkv6-7b":             # why its cell is one layer deep
            conditioning(torch, card, name, 2, seed)
            log(f"phase 15: {name} in f32 (depth {TRAIN_F32_DEPTH}) on the "
                f"same mesh")
            by_path[key + " f32"] = train_cell(
                torch, card, wrappers, fails, name, seed, f32="unrounded",
                depth=TRAIN_F32_DEPTH)
        log(f"  {name}'s cell wall {time.perf_counter() - t_cell:.1f} s "
            f"[{card}]")
    log(f"  phase 15 max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / GIB:.2f} GiB [{card}]; wall "
        f"{time.perf_counter() - t0:.1f} s")
    print(TRAIN_COUNTS + json.dumps(by_path), flush=True)
    for f in fails:
        log(f"  FAILED: {f}")
    return 1 if fails else 0


# ---------------------------------------------------------------------------
# phase 16: the dry run held to the card
# ---------------------------------------------------------------------------
# In a child process (``--dryrun``), one thread-rank (``threaded_world(1)``,
# a (1, 1) mesh on "cuda") under the dry run's default options.  Each cell's
# step (``launch.dryrun.make_step_fn``) is first measured on meta DTensors by
# the dry run's own functions (``prepare``, ``place``, ``measure``), then run
# for real on the card on seeded params laid out the same way
# (``materialize``).  The predicted peak (MemTracker on meta, the arguments
# included) against ``max_memory_allocated`` reset after the arguments are
# placed: within TOL_DRYRUN_PEAK of the measured peak.  The aten FLOPs of
# the two runs equal; each kernel's tallied calls equal its launches, and
# the bytes its route allocated on meta equal the bytes the allocator hands
# out inside its calls on the card (``requested_bytes``, exact): a route
# that leaves out a scratch buffer (planted: ``paged_decode``'s split
# buffer) fails there, where a peak of many GiB cannot show ~45 MiB.  The
# first cell's prediction is the thread's first step (DTensor's sharding
# propagation runs ops on fake tensors where its cache misses); it is made
# again at once, and the two must give the same peak, FLOPs and bytes.
TOL_DRYRUN_PEAK = 0.10
DRYRUN_COUNTS = "DRYRUN_LAUNCHES "
# (label, arch, depth or None, kind, batch, seq, remat policy); the train
# cells' depth cut from 28 to 8 for time
DRYRUN_CELLS = (
    ("llama3.2-3b train full", "llama3.2-3b", 8, "train", 2, 1024,
     "full"),
    ("llama3.2-3b train dots", "llama3.2-3b", 8, "train", 2, 1024,
     "dots"),
    ("llama3.2-3b decode", "llama3.2-3b", None, "decode", 4, 8192, None),
    ("jamba prefill", "jamba-v0.1-52b", 8, "prefill", 2, 1024, None),
)


def dryrun_phase(card: str) -> dict:
    """Phase 16: ``dryrun_main`` in a child process; its output echoed, its
    launch counts by path returned.  Fails unless the child exits 0."""
    sys.stdout.flush()
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                          "--dryrun", card], timeout=400,
                         stdout=subprocess.PIPE, text=True)
    counts_ = None
    for line in res.stdout.splitlines():
        if line.startswith(DRYRUN_COUNTS):
            counts_ = json.loads(line[len(DRYRUN_COUNTS):])
        else:
            log(line)
    log(f"  phase 16 wall with the child's start "
        f"{time.perf_counter() - t0:.1f} s")
    if res.returncode or counts_ is None:
        raise AssertionError(f"phase 16 (the dry run on the card) failed: "
                             f"exit {res.returncode}")
    return counts_


class AllocMeter:
    """The kernel wrappers the model modules call, each wrapped so the
    bytes the CUDA allocator hands out inside its calls
    (``requested_bytes.all.allocated``, summed by kernel) are counted;
    ``close`` puts the wrappers back."""

    def __init__(self, torch):
        from repro_torch.models import layers, mamba, rwkv
        self.torch, self.bytes, self.kept = torch, {}, []
        for mod in (layers, mamba, rwkv):
            for name in ("flash_prefill", "paged_decode", "paged_append",
                         "wkv6", "mamba_scan"):
                if hasattr(mod, name):
                    fn = getattr(mod, name)
                    self.kept.append((mod, name, fn))
                    setattr(mod, name, self._metered(name, fn))

    def _requested(self):
        return self.torch.cuda.memory_stats()[
            "requested_bytes.all.allocated"]

    def _metered(self, name, fn):
        def call(*a, **kw):
            before = self._requested()
            out = fn(*a, **kw)
            self.bytes[name] = self.bytes.get(name, 0) \
                + self._requested() - before
            return out
        return call

    def close(self):
        for mod, name, fn in self.kept:
            setattr(mod, name, fn)


class NoScratch:
    """``torch`` for ``kernels/paged_attention/ops.py`` with its f32 meta
    allocations (the decode's split buffer on the dry run's route) made
    empty: the planted fault of a route that leaves out its scratch."""

    def __init__(self, torch):
        self._torch = torch

    def __getattr__(self, name):
        return getattr(self._torch, name)

    def empty(self, *shape, dtype=None, device=None, **kw):
        if dtype == self._torch.float32 and \
                self._torch.device(device).type == "meta":
            shape = (0,)
        return self._torch.empty(*shape, dtype=dtype, device=device, **kw)


def dryrun_cfg(name, depth):
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(name)
    return cfg if depth is None else dataclasses.replace(cfg, n_layers=depth)


def predicted(D, cfg, kind, info, mesh, opts):
    """The dry run's record of a cell's step on meta DTensors."""
    env, spec, step = D.prepare(cfg, kind, mesh, opts, info)
    args = D.place(spec, mesh)
    t0 = time.perf_counter()
    out, c = D.measure(step, args)
    rec = D.summarize(cfg, info, spec, mesh, args, out, c)
    rec["wall_s"] = time.perf_counter() - t0
    return rec


def remat_grads(torch, lm, cfg, args, mesh, D, fails, card):
    """Phase 16's train cell: ``forward_train`` + backward on the card
    under whole-layer remat and under ``remat_policy="dots"`` from the
    same params: the loss within TOL_BF16 relative and every gradient leaf
    within TOL_BF16 of its largest magnitude (phase 11's limits)."""
    from repro_torch.models.sharding import ShardingEnv
    params, batch = args[0], args[2]
    got = {}
    for pol in ("full", "dots"):
        env = ShardingEnv(mesh, dict(D.DEFAULT_OPTS, remat=True,
                                     remat_policy=pol))
        loss = lm.forward_train(params, batch, cfg, env)
        loss.backward()
        got[pol] = float(loss.detach())
        if pol == "full":
            kept = {k: p.grad.to_local().clone()
                    for k, p in named_leaves(params)}
        else:
            worst = max(
                float((p.grad.to_local().float() - kept[k].float()).abs()
                      .max()) / max(float(kept[k].float().abs().max()),
                                    1e-30)
                for k, p in named_leaves(params))
            del kept
        clear_grads(params)
    rel = abs(got["dots"] - got["full"]) / abs(got["full"])
    log(f"  remat dots vs full on the card: loss {got['dots']:.6f} vs "
        f"{got['full']:.6f} ({rel:.2e} relative), largest gradient leaf "
        f"{worst:.2e} of its largest magnitude [{card}]")
    if not rel <= TOL_BF16 or not worst <= TOL_BF16:
        fails.append(f"remat dots vs full: loss {rel:.2e}, gradients "
                     f"{worst:.2e} (limit {TOL_BF16})")


def dryrun_cell(torch, card, wrappers, fails, D, lm, mesh, cell,
                twice=False):
    """One phase-16 cell: the prediction on meta (with ``twice``, made
    again and held equal to the first), then the same step on the card
    (the arguments from seed 0), the two held to each other.  Returns
    (prediction, measured launches, bytes the kernels' calls allocated on
    the card)."""
    label, name, depth, kind, B, S, pol = cell
    cfg = dryrun_cfg(name, depth)
    info = dict(seq=S, batch=B, kind=kind)
    opts = dict(D.DEFAULT_OPTS, remat_policy=pol or "full")
    pred = predicted(D, cfg, kind, info, mesh, opts)
    if twice:
        keys = ("aten_flops_per_device", "bytes_per_device")
        first = (pred["memory"]["peak_bytes"], *(pred[k] for k in keys))
        again = predicted(D, cfg, kind, info, mesh, opts)
        second = (again["memory"]["peak_bytes"], *(again[k] for k in keys))
        log(f"  {label}: the thread's first meta step (peak, aten FLOPs, "
            f"bytes) {first}, the next {second} [{card}]")
        if first != second:
            fails.append(f"{label}: the first meta step {first} differs "
                         f"from the next {second}")
    env, spec, step = D.prepare(cfg, kind, mesh, opts, info)
    values = D.materialize(cfg, spec, "cuda", seed=0)
    args = D.place(spec, mesh, values)
    del values
    if kind == "train" and pol == "dots":
        remat_grads(torch, lm, cfg, args, mesh, D, fails, card)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset(wrappers)
    meter = AllocMeter(torch)
    t0 = time.perf_counter()
    try:
        out, c = D.measure(step, args)
        torch.cuda.synchronize()
    finally:
        meter.close()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launched = counts(wrappers)
    aten = c.aten_flops()
    del out, c, args
    gc.collect()
    torch.cuda.empty_cache()
    gap = (pred["memory"]["peak_bytes"] - peak) / peak
    log(f"  {label}: predicted peak {pred['memory']['peak_bytes']} bytes "
        f"({pred['memory']['peak_bytes'] / GIB:.3f} GiB, arguments "
        f"{pred['memory']['argument_bytes'] / GIB:.3f}) against "
        f"max_memory_allocated {peak} ({peak / GIB:.3f} GiB): {gap:+.2%} "
        f"(limit {TOL_DRYRUN_PEAK:.0%}) [{card}]")
    log(f"  {label}: aten FLOPs predicted {pred['aten_flops_per_device']} "
        f"measured {aten}"
        + (f"; backward {pred['aten_backward_flops_per_device']}"
           if kind == "train" else "")
        + f"; meta step {pred['wall_s']:.1f} s, card step {wall:.2f} s")
    if abs(gap) > TOL_DRYRUN_PEAK:
        fails.append(f"{label}: predicted peak {gap:+.2%} off "
                     f"max_memory_allocated (limit {TOL_DRYRUN_PEAK:.0%})")
    if pred["aten_flops_per_device"] != aten:
        fails.append(f"{label}: aten FLOPs {pred['aten_flops_per_device']} "
                     f"predicted, {aten} on the card")
    tally = pred["kernels"]
    for k in wrappers:
        calls = tally.get(k, {}).get("calls", 0)
        alloc = tally.get(k, {}).get("alloc_bytes", 0)
        if calls or launched[k]:
            log(f"  {label}: {k} calls {calls} predicted, {launched[k]} "
                f"launched; bytes allocated {alloc} predicted, "
                f"{meter.bytes.get(k, 0)} on the card")
        if calls != launched[k]:
            fails.append(f"{label}: {k} {calls} calls predicted, "
                         f"{launched[k]} launched")
        if alloc != meter.bytes.get(k, 0):
            fails.append(f"{label}: {k} allocated {alloc} bytes on meta, "
                         f"{meter.bytes.get(k, 0)} on the card")
    return pred, launched, meter.bytes


def planted_scratch(D, mesh, cell, measured, fails, card):
    """The planted fault: ``paged_decode``'s route without its split
    buffer (``NoScratch``) on the decode cell; its predicted bytes must
    part from the card's."""
    from repro_torch.kernels.paged_attention import ops as P
    import torch
    label, name, depth, kind, B, S, pol = cell
    kept = P.torch
    P.torch = NoScratch(torch)
    try:
        pred = predicted(D, dryrun_cfg(name, depth), kind,
                         dict(seq=S, batch=B, kind=kind), mesh,
                         dict(D.DEFAULT_OPTS))
    finally:
        P.torch = kept
    alloc = pred["kernels"]["paged_decode"]["alloc_bytes"]
    log(f"  planted (paged_decode's route without its scratch): "
        f"{alloc} bytes predicted against {measured} on the card; the "
        f"peak {pred['memory']['peak_bytes']} bytes [{card}]")
    if alloc == measured:
        fails.append("the planted route without its scratch was not "
                     "caught")


def dryrun_cells(torch, card, wrappers, fails):
    """Phase 16's cells on one thread-rank; returns the launches by
    path."""
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_worker_mesh
    from repro_torch.models import lm
    mesh = make_worker_mesh(1, tp=1)
    by_path, back = {}, {}
    for cell in DRYRUN_CELLS:
        pred, launched, alloc = dryrun_cell(torch, card, wrappers, fails, D,
                                            lm, mesh, cell,
                                            twice=cell is DRYRUN_CELLS[0])
        by_path[f"dryrun {cell[0]}"] = launched
        if cell[3] == "train":
            back[cell[6]] = pred["aten_backward_flops_per_device"]
        if cell[3] == "decode":
            planted_scratch(D, mesh, cell, alloc.get("paged_decode", 0),
                            fails, card)
    log(f"  backward aten FLOPs: full remat {back['full']}, dots "
        f"{back['dots']} ({back['dots'] / back['full']:.3f} of full)")
    if not back["dots"] < back["full"]:
        fails.append("remat dots counted no fewer backward FLOPs than full")
    return by_path


def dryrun_main(card: str) -> int:
    """Phase 16 in the child: the cells on one thread-rank of a threaded
    world; prints the launch counts by path on a line of their own; exit 0
    only when every check held."""
    import torch
    if not torch.cuda.is_available():
        log("chip_smoke --dryrun: torch.cuda.is_available() is false")
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    from repro_torch.configs import load_all
    from repro_torch.launch.mesh import threaded_world
    load_all()
    wrappers, fails = all_wrappers(), []
    t0 = time.perf_counter()
    cap = torch.cuda.get_device_properties(0).total_memory
    log(f"  card total_memory {cap} bytes ({cap / GIB:.2f} GiB) [{card}]")
    with threaded_world(1, timeout=600) as run:
        by_path, = run(lambda r: dryrun_cells(torch, card, wrappers, fails))
    log(f"  phase 16 wall {time.perf_counter() - t0:.1f} s")
    print(DRYRUN_COUNTS + json.dumps(by_path), flush=True)
    for f in fails:
        log(f"  FAILED: {f}")
    return 1 if fails else 0


# ---------------------------------------------------------------------------
# phase 17: the examples on the card
# ---------------------------------------------------------------------------
# In a child process (``--examples``): the eight ``examples/*_torch.py``
# twins at the reference's own defaults on "cuda".  The serving twins run
# in this process, their printed lines kept with the launch counts as each
# line ended (``Printed``); quickstart, cluster_sim and the multi-pod dry
# run (CPU and meta by nature) run in child processes of their own at the
# same time.  The lines below count tokens and virtual time, so the weights
# (the port's seeded init here) do not move them: they are the lines the
# reference's examples print on the CPU, but the wall figure
# (tests/test_torch_examples_serve.py and ..._workflow.py hold them there,
# with the reference's params carried over), and so are the launches (on
# the CPU the tests count the wrappers' calls, one launch a call here).
EXAMPLES_COUNTS = "EXAMPLES_LAUNCHES "
EXAMPLE_WALL = r"\d+\.\d+s wall"
EXAMPLE_LINES = {
    "serve_agents": [
        "SAGA (workflow-atomic): prefilled=480 tokens (regenerated=96), "
        "decoded=240 steps, cache hits=24, <wall>",
        "request-level baseline: prefilled=1920 tokens (regenerated=1920), "
        "decoded=240 steps, cache hits=0, <wall>",
        "",
        "prefill-work reduction: 4.00x (this is the mechanism behind the "
        "paper's 1.64x TCT gain)"],
    "serve_runtime": [
        "SAGA (workflow-atomic): 12 sessions, tct_mean=4.07s (virtual), "
        "regen=657 tokens, 112 batched rounds for 131 decoded tokens, "
        "hits=35, steals=0, prefetch copies=0, <wall>",
        "request-level baseline: 12 sessions, tct_mean=5.93s (virtual), "
        "regen=4237 tokens, 124 batched rounds for 131 decoded tokens, "
        "hits=0, steals=0, prefetch copies=0, <wall>"],
    # the graph programs: the lines before the dynamic agent's header
    "workflow_api": [
        "== explicit-graph programs (retry loop declared + executed)",
        "  fix-0: path=[0, 1, 2, 1, 2, 3]  <- retry taken",
        "  fix-1: path=[0]",
        "  fix-2: path=[0, 1, 2, 3]",
        "  fix-3: path=[0, 1, 2, 3]",
        "  fix-4: path=[0, 1, 2, 3]",
        "  fix-5: path=[0, 1, 2, 3]",
        "  cache hits 15 (delta-only resumes), regen 138 of 256 prefilled "
        "tokens"],
}
EXAMPLE_DYNAMIC = "== dynamic-callback program (branches on decoded tokens)"
# micro has 2 layers: a prefill is 2 flash launches, a batched decode round
# 2 appends and 2 decodes (serve_agents: 240 + 240 steps, one session at a
# time; serve_runtime: 112 + 124 rounds)
EXAMPLE_LAUNCHES = {
    "serve_agents": {"flash_prefill": 120, "paged_decode": 960,
                     "paged_append": 960},
    "serve_runtime": {"flash_prefill": 188, "paged_decode": 472,
                      "paged_append": 472},
    "workflow_api graph": {"flash_prefill": 46, "paged_decode": 86,
                           "paged_append": 86},
}
MICRO_LAYERS = 2
SERVE_KERNELS = ("flash_prefill", "paged_decode", "paged_append")
# command-r-35b x decode_32k on the 2x16x16 mesh: rank 0's arguments, the
# reference's own figure (tests/test_torch_examples_rest.py)
MULTIPOD_ARGUMENT_BYTES = 2_166_636_564
MULTIPOD_JSON = "build/dryrun/demo.command-r-35b.decode_32k.multi.json"
# train_small's defaults but the checkpoints' directory (a temporary one)
# and the steps (its default 200 cut to 100 on the command line, for the
# smoke's time); then resumed for TRAIN_SMALL_MORE steps past its last
# checkpoint
TRAIN_SMALL_STEPS = 100
TRAIN_SMALL_MORE = 10


def examples_phase(card: str) -> dict:
    """Phase 17: ``examples_main`` in a child process; its output echoed,
    its launch counts by path returned.  Fails unless the child exits 0."""
    sys.stdout.flush()
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                          "--examples", card], timeout=400,
                         stdout=subprocess.PIPE, text=True)
    counts_ = None
    for line in res.stdout.splitlines():
        if line.startswith(EXAMPLES_COUNTS):
            counts_ = json.loads(line[len(EXAMPLES_COUNTS):])
        else:
            log(line)
    log(f"  phase 17 wall with the child's start "
        f"{time.perf_counter() - t0:.1f} s [{card}]")
    if res.returncode or counts_ is None:
        raise AssertionError(f"phase 17 (the examples on the card) failed: "
                             f"exit {res.returncode}")
    return counts_


class Printed:
    """stdout for an example: each line echoed, indented, and kept with the
    launch counts as it ended (``at[i]``: the launches before line i was
    printed)."""

    def __init__(self, counts_):
        self.counts, self.lines, self.at, self._part = counts_, [], [], ""
        self.out = sys.stdout

    def write(self, s):
        self._part += s
        *done, self._part = self._part.split("\n")
        for line in done:
            self.lines.append(line)
            self.at.append(self.counts())
            self.out.write(f"    | {line}\n")
        return len(s)

    def flush(self):
        self.out.flush()


def example(name):
    """The module ``examples/<name>_torch.py``."""
    import importlib.util
    path = Path(__file__).resolve().parent / "examples" / f"{name}_torch.py"
    spec = importlib.util.spec_from_file_location(f"{name}_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_example(torch, wrappers, name, argv, card):
    """``main(argv)`` of a twin in this process: (printed lines, launches
    as each ended, launches, what main returned)."""
    reset(wrappers)
    out = Printed(lambda: counts(wrappers))
    log(f"  examples/{name}_torch.py {' '.join(argv)}")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        ret = example(name).main(argv)
    torch.cuda.synchronize()
    launches = counts(wrappers)
    log(f"  {name}: wall {time.perf_counter() - t0:.1f} s [{card}]; "
        f"launches {launches}")
    return out.lines, out.at, launches, ret


def no_wall(lines):
    import re
    return [re.sub(EXAMPLE_WALL, "<wall>", line) for line in lines]


def held_lines(name, got, want, fails):
    if got != want:
        fails.append(f"{name} printed {got}, not the reference's {want}")


def held_launches(name, got, want, fails):
    """The serving kernels' launches exactly ``want``; the scans' none."""
    got = {k: n for k, n in got.items() if k in want or n}
    if got != want:
        fails.append(f"{name} launched {got}, not {want}")


def example_children(tmp):
    """quickstart, cluster_sim and the multi-pod dry run, each in a child
    process (a session of its own, so that its children end with it) in a
    directory of its own under ``tmp``, started at once."""
    import os
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    procs = {}
    for name in ("quickstart", "cluster_sim", "multipod_dryrun"):
        cwd = Path(tmp) / name
        cwd.mkdir()
        procs[name] = (cwd, subprocess.Popen(
            [sys.executable, str(root / "examples" / f"{name}_torch.py")],
            cwd=cwd, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, start_new_session=True))
    return procs


def example_children_done(procs, card, fails, t0):
    for name, (cwd, p) in procs.items():
        out, _ = p.communicate(timeout=300)
        log(f"  examples/{name}_torch.py (a child process): exit "
            f"{p.returncode}, done {time.perf_counter() - t0:.1f} s after "
            f"the phase began [{card}]")
        for line in out.splitlines()[-8:]:
            log(f"    | {line}")
        if p.returncode:
            fails.append(f"{name}_torch exited {p.returncode}")
    path = procs["multipod_dryrun"][0] / MULTIPOD_JSON
    if not path.exists():
        fails.append(f"multipod_dryrun_torch wrote no {MULTIPOD_JSON}")
        return
    rec = json.loads(path.read_text())
    got = (rec["status"], rec.get("mesh"),
           rec.get("memory", {}).get("argument_bytes"))
    log(f"  multipod cell: status {got[0]}, mesh {got[1]}, argument bytes "
        f"{got[2]}, predicted peak {rec.get('memory', {}).get('peak_bytes')}"
        f" bytes a card (meta), wall {rec.get('wall_s')} s [{card}]")
    if got != ("ok", [2, 16, 16], MULTIPOD_ARGUMENT_BYTES):
        fails.append(f"multipod_dryrun_torch's cell {got}, not ('ok', "
                     f"[2, 16, 16], {MULTIPOD_ARGUMENT_BYTES})")


def on_threads(torch, seen):
    """The model's kernel wrappers, each wrapped to note the thread that
    calls it, its first tensor's device and the thread's current CUDA
    device; returns a function that puts them back."""
    import threading

    from repro_torch.models import layers
    kept = []
    for name in SERVE_KERNELS:
        fn = getattr(layers, name)

        def call(*a, _fn=fn, _name=name, **kw):
            seen.add((_name, threading.current_thread().name,
                      str(a[0].device), torch.cuda.current_device()))
            return _fn(*a, **kw)
        kept.append((name, fn))
        setattr(layers, name, call)
    return lambda: [setattr(layers, n, f) for n, f in kept]


def examples_serving(torch, card, wrappers, fails, argv):
    """The four serving twins on micro; launches by path."""
    by_path = {}
    for name in ("serve_agents", "serve_runtime"):
        lines, _, got, _ = run_example(torch, wrappers, name, argv, card)
        by_path[f"examples {name}"] = got
        held_lines(name, no_wall(lines), EXAMPLE_LINES[name], fails)
        held_launches(name, got, EXAMPLE_LAUNCHES[name], fails)

    lines, at, got, _ = run_example(torch, wrappers, "workflow_api", argv,
                                    card)
    by_path["examples workflow_api"] = got
    i = lines.index(EXAMPLE_DYNAMIC) if EXAMPLE_DYNAMIC in lines else None
    if i is None:
        fails.append("workflow_api printed no dynamic agent")
    else:
        held_lines("workflow_api", lines[:i], EXAMPLE_LINES["workflow_api"],
                   fails)
        held_launches("workflow_api's graph programs", at[i],
                      EXAMPLE_LAUNCHES["workflow_api graph"], fails)
        # the dynamic agent: a prefill a step, 3 tokens in the first step
        # and 2 in each later one, one batched round a token
        steps = int(lines[i + 1].split(": ")[1].split()[0])
        rounds = 3 + 2 * (steps - 1)
        held_launches("workflow_api's dynamic agent",
                      {k: got[k] - at[i][k] for k in got},
                      {"flash_prefill": MICRO_LAYERS * steps,
                       "paged_decode": MICRO_LAYERS * rounds,
                       "paged_append": MICRO_LAYERS * rounds}, fails)
    if not lines or not lines[-1].endswith("across substrates: True"):
        fails.append("workflow_api's graph took other paths on the "
                     "simulator")

    seen = set()
    undo = on_threads(torch, seen)
    try:
        lines, _, got, _ = run_example(torch, wrappers, "serve_frontend",
                                       argv, card)
    finally:
        undo()
    by_path["examples serve_frontend"] = got
    if any(got[k] <= 0 for k in SERVE_KERNELS) \
            or any(n for k, n in got.items() if k not in SERVE_KERNELS):
        fails.append(f"serve_frontend launched {got}: each serving kernel "
                     f"> 0, the scans none")
    threads = sorted({(t, d, c) for _, t, d, c in seen})
    log(f"  serve_frontend's launches by (thread, tensor device, current "
        f"device): {threads}")
    if not threads or any(not t.startswith("saga-engine") or d != "cuda:0"
                          or c != 0 for t, d, c in threads):
        fails.append(f"serve_frontend's kernels ran outside the engine's "
                     f"worker thread or off cuda:0: {threads}")
    if not lines or not lines[-1].endswith("conservation clean"):
        fails.append("serve_frontend did not end conservation clean")
    return by_path


def examples_train(torch, card, wrappers, fails, argv, tmp):
    """train_small at its defaults but TRAIN_SMALL_STEPS (small-100m, B=4
    x 128, lr 1e-3, a checkpoint every 50), then resumed from its last
    checkpoint
    for TRAIN_SMALL_MORE steps; and on micro at the same steps and batch,
    where the loss falls.  At the defaults it does not fall in 200 steps,
    in the reference's example as in the port (PERF.md): 32,768 tokens
    seen about three times each are not learned."""
    from repro_torch.train import checkpoint as ckpt
    by_path = {}
    steps = ["--steps", str(TRAIN_SMALL_STEPS)]
    ckdir = tmp / "train_small_ckpt"
    torch.cuda.reset_peak_memory_stats()
    _, _, got, losses = run_example(
        torch, wrappers, "train_small",
        [*argv, *steps, "--ckpt-dir", str(ckdir)], card)
    by_path["examples train_small"] = got
    saved = sorted(int(f.stem[5:]) for f in ckdir.glob("step_*.npz"))
    log(f"  train_small: loss {losses[0]:.4f} -> {losses[-1]:.4f} over "
        f"{len(losses)} steps, peak "
        f"{torch.cuda.max_memory_allocated() / GIB:.2f} GiB [{card}]; "
        f"checkpoints at steps {saved}")
    if len(losses) != TRAIN_SMALL_STEPS or not all(
            math.isfinite(x) for x in losses):
        fails.append(f"train_small ran {len(losses)} steps or lost a "
                     f"finite loss")
    if saved != list(range(50, TRAIN_SMALL_STEPS + 1, 50)) \
            or ckpt.latest_step(str(ckdir)) != TRAIN_SMALL_STEPS:
        fails.append(f"train_small's checkpoints {saved}, latest "
                     f"{ckpt.latest_step(str(ckdir))}")
    more = TRAIN_SMALL_STEPS + TRAIN_SMALL_MORE
    lines, _, got, again = run_example(
        torch, wrappers, "train_small",
        [*argv, "--steps", str(more), "--ckpt-dir", str(ckdir)], card)
    by_path["examples train_small resumed"] = got
    if f"[train] resumed from step {TRAIN_SMALL_STEPS}" not in lines \
            or len(again) != TRAIN_SMALL_MORE \
            or not all(math.isfinite(x) for x in again):
        fails.append(f"train_small did not resume from step "
                     f"{TRAIN_SMALL_STEPS} for {TRAIN_SMALL_MORE} steps")
    _, _, got, micro = run_example(
        torch, wrappers, "train_small",
        [*argv, *steps, "--arch", "micro", "--ckpt-dir",
         str(tmp / "train_micro_ckpt")], card)
    by_path["examples train_small micro"] = got
    first, last = (sum(micro[:10]) / 10, sum(micro[-10:]) / 10)
    log(f"  train_small on micro: mean loss of the first ten steps "
        f"{first:.4f}, of the last ten {last:.4f} [{card}]")
    if not last < first:
        fails.append(f"train_small's loss on micro did not fall: "
                     f"{first} -> {last}")
    return by_path


def examples_main(card: str) -> int:
    """Phase 17 in the child: the eight twins; prints the launch counts by
    path on a line of their own; exit 0 only when every check held."""
    import os
    import signal
    import tempfile

    import torch
    if not torch.cuda.is_available():
        log("chip_smoke --examples: torch.cuda.is_available() is false")
        return 1
    wrappers, fails = all_wrappers(), []
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        procs = example_children(tmp)
        try:
            argv = ["--device", "cuda"]
            by_path = examples_serving(torch, card, wrappers, fails, argv)
            by_path.update(examples_train(torch, card, wrappers, fails,
                                          argv, Path(tmp)))
            example_children_done(procs, card, fails, t0)
        finally:
            for _, p in procs.values():
                if p.poll() is None:
                    os.killpg(p.pid, signal.SIGKILL)
                    p.wait()
    log(f"  phase 17 wall {time.perf_counter() - t0:.1f} s [{card}]")
    print(EXAMPLES_COUNTS + json.dumps(by_path), flush=True)
    for f in fails:
        log(f"  FAILED: {f}")
    return 1 if fails else 0


# ---------------------------------------------------------------------------
# phase 18: soft-capped attention at full width
# ---------------------------------------------------------------------------
# llama3.2-3b (depth CAPPED_DEPTH, B=1, a 1024-token prompt) and
# seamless-m4t-large-v2 (CAPPED_DEPTH encoder + decoder layers, B=4, 1024
# frames and a 256-token target prefix), each with a cap on its attention
# scores, through lm.prefill and CAPPED_STEPS greedy
# lm.decode_steps (exact launches), held to the same run with flash_prefill,
# paged_decode and paged_append swapped for their plain versions (teacher-
# forced with the kernels' tokens): the prefill's logits within TOL_FORWARD,
# the first layer of each cache entry within TOL_STATE and each step's
# logits within TOL_DECODE of the family.  Not decode-vs-forward: the
# reference decodes uncapped (repro/models/layers.py:310), so a capped
# model's decode parts from its own forward there too, and the port keeps
# token parity by doing the same.  The capped prefill's logits must move
# from the uncapped one's past TOL_FORWARD (as MUST_MOVE_LOGITS' faults).
# The caps: at random init the scores' standard deviation is set by the
# widths (llama3.2-3b about 1.2, seamless about 0.4, from the 0.02 init),
# and a cap near it puts them on tanh's bend.
# The depth: the kernels part from their plain versions by at most one bf16
# step of an attention output (phase 2), and a random-init stack grows that
# with depth alike with and without a cap.  Kernels vs plain versions, the
# prefill's logits, capped (uncapped): llama3.2-3b 1.34e-2 (1.34e-2) at 4
# layers, 1.98e-2 (2.03e-2) at 8, 3.60e-2 (4.16e-2) at 28; seamless
# 1.03e-2 (1.16e-2) at 4 + 4, 2.33e-2 (2.46e-2) at 24 + 24, its first
# decoder layer's cross K/V 1.26e-2 and 3.46e-2 (NVIDIA H100 80GB HBM3,
# 700 W).  Full depth passes TOL_FORWARD and TOL_STATE without a cap too,
# so the phase runs where the limits hold the kernels, not the depth.
CAPPED = {"llama3.2-3b": 1.0, "seamless-m4t-large-v2": 0.25}
CAPPED_DEPTH = 4                  # of 28; seamless's of 24 + 24
CAPPED_STEPS = 4
CAPPED_S, CAPPED_TGT = 1024, 256


def plain_kernels():
    """The three attention wrappers of ``models.layers`` swapped for their
    plain versions (on CUDA tensors: no kernel, no count)."""
    from repro_torch.kernels.flash_attention import ops as F
    from repro_torch.kernels.paged_attention import ops as P
    from repro_torch.models import layers as L
    stack = contextlib.ExitStack()
    for name, plain in (("flash_prefill", F.flash_prefill_plain),
                        ("paged_decode", P.paged_decode_plain),
                        ("paged_append", P.paged_append_plain)):
        stack.enter_context(swapped(L, name, lambda _, f=plain: f))
    return stack


def capped_run(torch, lm, cfg, params, batch, max_len, tokens=None):
    """``lm.prefill`` then CAPPED_STEPS greedy ``lm.decode_step``s (fed
    ``tokens`` where given): (the prefill's logits, its cache, each step's
    logits, the tokens fed)."""
    pos = batch["tgt_tokens" if cfg.enc_dec else "tokens"].shape[1]
    with torch.no_grad():
        last, cache = lm.prefill(params, batch, cfg, max_len=max_len)
        first = _clone(cache)
        tok, fed, steps = last.argmax(-1), [], []
        for t in range(CAPPED_STEPS):
            tok = tok if tokens is None else tokens[t]
            fed.append(tok)
            logits, cache = lm.decode_step(params, tok, cache, pos + t, cfg)
            steps.append(logits)
            tok = logits.argmax(-1)
    torch.cuda.synchronize()
    return last, first, steps, fed


def capped_cfg(name):
    """``name`` at full width, cut to ``CAPPED_DEPTH`` (enc-dec: that many
    encoder and decoder layers), uncapped."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(name)
    if cfg.enc_dec:
        return dataclasses.replace(cfg, n_layers=2 * CAPPED_DEPTH,
                                   n_enc_layers=CAPPED_DEPTH,
                                   n_dec_layers=CAPPED_DEPTH)
    return dataclasses.replace(cfg, n_layers=CAPPED_DEPTH)


def capped_path(torch, np, card, wrappers, name, expect):
    """One model of phase 18 (see above); returns (launches, fails)."""
    import dataclasses
    from repro_torch.models import lm

    fails = []
    t0 = time.perf_counter()
    plain_cfg = capped_cfg(name)
    cfg = dataclasses.replace(plain_cfg, attn_logit_softcap=CAPPED[name])
    hold, path = holder(cfg, fails), path_of(cfg)
    params = ready(torch, lm, cfg)
    if cfg.enc_dec:
        B, S = 4, CAPPED_TGT
        gen = torch.Generator(device="cuda")
        gen.manual_seed(18)
        frames = (torch.randn(B, CAPPED_S, cfg.d_model, generator=gen,
                              device="cuda") * 0.02).to(torch.bfloat16)
        batch = {"frames": frames, "tgt_tokens": torch.as_tensor(
            np.random.RandomState(18).randint(1, cfg.vocab, size=(B, S)),
            device="cuda")}
    else:
        B, S = 1, CAPPED_S
        batch = {"tokens": torch.as_tensor(np.random.RandomState(18).randint(
            1, cfg.vocab, size=(B, S)), device="cuda")}
    max_len = S + CAPPED_STEPS
    reset(wrappers)
    last, first, steps, fed = capped_run(torch, lm, cfg, params, batch,
                                         max_len)
    launches = counts(wrappers)
    log(f"  {name} capped at {CAPPED[name]:g}: launches (prefill + "
        f"{CAPPED_STEPS} decode steps) {launches}")
    if launches != expect:
        fails.append(f"{name} capped: launches {launches}, expected "
                     f"{expect}")
    reset(wrappers)
    with plain_kernels():
        p_last, p_first, p_steps, _ = capped_run(torch, lm, cfg, params,
                                                 batch, max_len, fed)
    if any(counts(wrappers).values()):
        fails.append(f"{name}: the plain run launched {counts(wrappers)}")
    hold("capped prefill logits, kernels vs plain versions (relative)",
         rel_err(last, p_last), TOL_FORWARD)
    hold("capped prefill cache, first layer of each entry, kernels vs plain "
         "versions", first_layer(state_errs(first, p_first, S)),
         TOL_STATE[path])
    for t, (a, b) in enumerate(zip(steps, p_steps)):
        hold(f"decode step {t} logits, kernels vs plain versions "
             f"(relative)", rel_err(a, b), TOL_DECODE[path])
    with torch.no_grad():
        u_last, _ = lm.prefill(params, batch, plain_cfg, max_len=max_len)
    moved = rel_err(u_last, last)
    log(f"  {name}: the uncapped prefill's logits part from the capped "
        f"ones by {moved:.4e} of the largest logit (must pass "
        f"{TOL_FORWARD:g}); greedy picks agree on "
        f"{int((u_last.argmax(-1) == last.argmax(-1)).sum())}/{B} rows")
    if not moved > TOL_FORWARD:
        fails.append(f"{name}: the cap moved the logits only {moved}")
    ok = all(bool(x.isfinite().all()) for x in (last, *steps))
    if not ok or last.shape != (B, 1, cfg.vocab):
        fails.append(f"{name}: logits {tuple(last.shape)}, finite {ok}")
    log(f"  {name} capped [{card}]: wall {time.perf_counter() - t0:.1f} s")
    del params, batch, last, first, steps, p_last, p_first, p_steps, u_last
    gc.collect()
    torch.cuda.empty_cache()
    return launches, fails


def capped_paths(torch, np, card):
    """Phase 18: llama3.2-3b and seamless-m4t-large-v2 soft-capped, both
    before a failed check ends the script.  Returns the launches by
    path."""
    wrappers = all_wrappers()
    none = dict.fromkeys(wrappers, 0)
    n = capped_cfg("llama3.2-3b").n_layers
    sm = capped_cfg("seamless-m4t-large-v2")
    ne, nd, st = sm.n_enc_layers, sm.n_dec_layers, CAPPED_STEPS
    by_path, fails = {}, []
    for name, expect in (
            ("llama3.2-3b", {**none, "flash_prefill": n,
                             "paged_append": st * n,
                             "paged_decode": st * n}),
            ("seamless-m4t-large-v2", {**none, "flash_prefill": ne + 2 * nd,
                                       "paged_append": st * nd,
                                       "paged_decode": 2 * st * nd})):
        log(f"phase 18: {name} (full width, depth {CAPPED_DEPTH}) with "
            f"attn_logit_softcap {CAPPED[name]:g}")
        by_path[f"capped {name}"], f = capped_path(torch, np, card,
                                                   wrappers, name, expect)
        fails += f
    if fails:
        raise AssertionError("; ".join(fails))
    return by_path


def capped_main(card: str) -> int:
    """``--capped``: phase 18 alone."""
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        log("chip_smoke --capped: torch.cuda.is_available() is false")
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    t0 = time.perf_counter()
    by_path = capped_paths(torch, np, card)
    log(f"  phase 18 wall {time.perf_counter() - t0:.1f} s; launches "
        f"{json.dumps(by_path)}")
    return 0


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
    marks = []                   # (phase, its start): the walls by phase

    def mark(name):
        marks.append((name, time.perf_counter()))
    mark("1")
    log(f"phase 1: card {card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda} python {sys.version.split()[0]}")
    flex = start_flex(card)
    atexit.register(lambda: flex.poll() is None and flex.kill())
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
    mark("2")
    log(f"phase 2: kernels vs plain versions on the card [{card}]")
    kernels = [flash_phase(torch, gen, gen_more),
               *paged_phase(torch, gen, gen_more),
               wkv6_phase(torch, gen), mamba_phase(torch, gen)]
    flash_long_shapes(torch, gen_more, kernels[0])
    flash_width_shapes(torch, gen_more, kernels[0])
    paged_g1_shapes(torch, gen_more, kernels[1:3])
    log("  phase 13's rank-local shapes (a (2, 2) mesh: one row, half the "
        "heads a rank)")
    flash_long_shapes(torch, gen_more, kernels[0], FLASH_RANK)
    paged_g1_shapes(torch, gen_more, kernels[1:3], PAGED_RANK)
    log("  phase 14's rank-local shapes (the same mesh: half of rwkv6-7b's "
        "heads, of jamba's channels, of seamless's heads; the engine's "
        "round)")
    scan_rank_shapes(torch, gen_more, kernels[3], kernels[4])
    flash_width_shapes(torch, gen_more, kernels[0], FLASH_REST)
    paged_g1_shapes(torch, gen_more, kernels[1:3], PAGED_REST)
    log(f"  phase 18's soft-capped attention (cap {CAP_KERNEL:g})")
    gen_cap = torch.Generator(device="cuda")
    gen_cap.manual_seed(2)
    capped_rows = flash_capped_shapes(torch, gen_cap, kernels[0])
    mark("3")
    log("phase 3: reference check on small inputs")
    reference_phase(torch, np)
    ssm_reference_phase(torch, np)
    mark("4-4b")
    log("phase 4: main path (llama3.2-3b served)")
    by_path = main_path(torch, np, card)
    mark("4c")
    log("phase 4c: serve_bench_torch's fingerprints on the card (micro)")
    by_path["serve_bench_torch micro"] = bench_phase(torch, card)
    mark("4d")
    log("phase 4d: soak_bench_torch's soak on the card (micro)")
    by_path["soak_bench_torch micro"] = soak_phase(torch, card)
    mark("5-6")
    by_path.update(ssm_paths(torch, np, card))
    mark("7-8")
    by_path.update(moe_vlm_paths(torch, np, card))
    mark("9-10")
    by_path.update(mla_encdec_paths(torch, np, card))
    mark("11")
    log("phase 11: training (llama3.2-3b at full width and depth; the ten "
        "tiny families on the card against the CPU)")
    by_path.update(train_paths(torch, np, card))
    mark("12")
    log("phase 12: production layouts (the sharding specs on DTensor "
        "meshes; a child process)")
    layouts_phase(card)
    mark("13")
    log("phase 13: sharded serving (4 thread-ranks on the card; a child "
        "process)")
    by_path.update(sharded_phase(card))
    mark("14")
    log("phase 14: sharded serving II (rwkv6-7b, jamba, seamless-m4t and the "
        "engine on 4 thread-ranks; a child process)")
    by_path.update(rest_phase(card))
    mark("15")
    log("phase 15: sharded training (llama3.2-3b, mixtral-8x22b, rwkv6-7b, "
        "jamba and seamless-m4t on 4 thread-ranks; a child process)")
    by_path.update(sharded_train_phase(card))
    mark("16")
    log("phase 16: the dry run held to the card (llama3.2-3b trained under "
        "both remat policies and decoded, jamba's prefill; a child "
        "process)")
    by_path.update(dryrun_phase(card))
    mark("17")
    log("phase 17: the examples on the card (the eight examples/*_torch.py "
        "twins at the reference's defaults; a child process)")
    by_path.update(examples_phase(card))
    mark("18")
    log("phase 18: soft-capped attention at full width (llama3.2-3b and "
        "seamless-m4t-large-v2 with attn_logit_softcap, against the plain "
        "versions)")
    by_path.update(capped_paths(torch, np, card))
    log("  phase 2's yardstick: flex_attention at the capped shapes, timed "
        "by the child phase 1 started (compiled meanwhile)")
    flex_rows(capped_rows, flex)
    mark("")
    log(f"walls by phase [{card}]: " + ", ".join(
        f"{n} {b - a:.1f} s" for (n, a), (_, b) in zip(marks, marks[1:]))
        + f"; phases 1-18 {marks[-1][1] - marks[0][1]:.1f} s")
    for rec in kernels:
        # the sharded training paths are listed with their zero launches
        rec["launches_by_path"] = {
            p: n[rec["name"]] for p, n in by_path.items()
            if n[rec["name"]] or p.startswith(("sharded train", "dryrun",
                                               "examples"))}
        rec["launches"] = sum(rec["launches_by_path"].values())
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--layouts"]:
        sys.exit(layouts_main(sys.argv[2]))
    if sys.argv[1:2] == ["--sharded"]:
        sys.exit(sharded_main(sys.argv[2]))
    if sys.argv[1:2] == ["--sharded-rest"]:
        sys.exit(rest_main(sys.argv[2]))
    if sys.argv[1:2] == ["--sharded-train"]:
        sys.exit(sharded_train_main(sys.argv[2]))
    if sys.argv[1:2] == ["--dryrun"]:
        sys.exit(dryrun_main(sys.argv[2]))
    if sys.argv[1:2] == ["--examples"]:
        sys.exit(examples_main(sys.argv[2]))
    if sys.argv[1:2] == ["--capped"]:
        sys.exit(capped_main(sys.argv[2]))
    if sys.argv[1:2] == ["--flex"]:
        sys.exit(flex_main(sys.argv[2]))
    sys.exit(main())
