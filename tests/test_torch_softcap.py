"""Soft-capped attention (``cfg.attn_logit_softcap``) in the port against
the reference on the CPU (tests/torch_softcap.py says how the cap is made
to bite and which reference paths apply it):

- ``flash_prefill_plain(cap=c)`` against the reference's
  ``attention_dense(logit_cap=c)`` and ``chunked_attention(logit_cap=c)``,
  causal, windowed, non-causal and a cross-attention with Sq != Sk, in
  f32 and bf16 within ``tests/test_kernels.py:38``'s ``TOL``;
- ``lm.forward_logits``, ``lm.prefill`` (logits and caches) and two
  ``lm.decode_step``s, uncapped as the reference decodes, for the dense,
  moe, vlm, hybrid (f32, 1e-3) and audio families: the capped tiny
  configs on the same carried params, within 2e-2 (bf16) of the largest
  magnitude where that passes 1;
- ``lm.forward_train``'s loss and every gradient leaf against
  ``jax.value_and_grad``, under ``attn_mode`` "full" and "tri", with every
  param (and seamless's frames, ``f32_frames``) in f32 in both packages,
  within 1e-3 relative to the loss and to each leaf's largest magnitude
  (they read 4e-6 at most).  Not in bf16: at the scaled attention that
  lets the cap bite, seamless-tiny's bf16 gradients part from the
  reference's by 1.4-2.4e-2 of a leaf's largest magnitude with or without
  the cap (1.75e-2 uncapped on the reference's own init), so a bf16 limit
  of 2e-2 would hold rounding, not the cap;
- deepseek-v2-tiny's MLA ignores the cap, as the reference's does: its
  capped forward, prefill and decode held to the reference's capped run,
  and equal to its own uncapped ones; and a capped model decodes exactly
  as the uncapped one.

Every capped case also shows the cap bites: its output moves from the
same model's uncapped one by at least ``BITE`` (10) times its tolerance.
At ``CAP`` 1.0 the capped logits moved by 0.43 (llama3.2), 0.52
(mixtral), 0.71 (llava-next), 0.57 (jamba) and 0.64 (seamless) of the
largest magnitude where that passes 1, against errors of 3e-3 to 4e-3
(jamba 2.4e-7); the capped gradients by 1.8 to 14.5 of a leaf's largest
magnitude.
"""
import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)           # tiny shapes: threads only add overhead

from repro.models import layers as jL  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import ops as F  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from torch_routing import SameRouting  # noqa: E402
from torch_softcap import (B, BITE, CAP, S, STEPS, TOL_F32,  # noqa: E402
                           _np, configs, err, f32_frames, grad_errs, offset,
                           port_grads,
                           reference, tol, train_reference)

TOL_KERNEL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# (Sq, Sk, causal, window); heads 4 over 2 kv heads, D 16
ATTN_CASES = {"causal": (24, 24, True, 0), "window": (24, 24, True, 5),
              "non-causal": (24, 24, False, 0),
              "cross": (12, 20, False, 0)}
SERVED = ["llama3.2-tiny", "mixtral-tiny", "llava-next-tiny", "jamba-tiny",
          "seamless-tiny"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", ATTN_CASES)
def test_flash_prefill_plain_cap_matches_reference(case, dtype):
    """q, k, v standard normal times 2 (scores of std 4 against a cap of
    1: the cap moves the output by ~0.3 to 0.5 here)."""
    Sq, Sk, causal, window = ATTN_CASES[case]
    rng = np.random.RandomState(7)
    arrs = [rng.randn(2, s, h, 16).astype(np.float32) * 2
            for s, h in ((Sq, 4), (Sk, 2), (Sk, 2))]
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    qj, kj, vj = (jnp.asarray(a).astype(jdt) for a in arrs)
    q, k, v = (torch.from_numpy(_np(a)).to(dtype) for a in (qj, kj, vj))
    tol_ = TOL_KERNEL[dtype]
    got = F.flash_prefill_plain(q, k, v, causal=causal, window=window,
                                cap=CAP)
    dense = jL.attention_dense(qj, kj, vj, causal=causal, window=window,
                               logit_cap=CAP)
    chunked = jL.chunked_attention(
        qj, jL.expand_kv(kj, 4), jL.expand_kv(vj, 4), causal=causal,
        window=window, q_block=Sq // 2, kv_block=Sk // 4, logit_cap=CAP)
    assert got.dtype == dtype and got.shape == (2, Sq, 4, 16)
    assert err(got, dense) < tol_, err(got, dense)
    assert err(got, chunked) < tol_, err(got, chunked)
    moved = err(F.flash_prefill_plain(q, k, v, causal=causal,
                                      window=window), dense)
    assert moved > BITE * tol_, f"the cap moved the output by {moved}"


def test_flash_prefill_work_counts_the_cap_only_when_set():
    """Three operations (divide, tanh, multiply) a visible pair with a
    cap; at cap 0 the count is the uncapped one.  The dry run's meta route
    tallies the same."""
    B_, Sq, H, K, D = 2, 40, 4, 2, 16
    pairs = B_ * H * F.visible_pairs(Sq, Sq, True, 8)
    plain = F.flash_prefill_work(B_, Sq, Sq, H, K, D, D, window=8)
    assert F.flash_prefill_work(B_, Sq, Sq, H, K, D, D, window=8,
                                cap=0.0) == plain
    assert plain[0] == 2 * (D + D) * pairs
    capped = F.flash_prefill_work(B_, Sq, Sq, H, K, D, D, window=8, cap=50.0)
    assert capped == (plain[0] + 3 * pairs, plain[1])
    m = lambda *s: torch.empty(s, dtype=torch.bfloat16,  # noqa: E731
                               device="meta")
    with build.dry_run() as tally:
        F.flash_prefill(m(B_, Sq, H, D), m(B_, Sq, K, D), m(B_, Sq, K, D),
                        window=8, cap=50.0)
    assert tally["flash_prefill"]["flops"] == capped[0]


def _port_serve(name, cap, ref):
    """The port's forward, prefill and teacher-forced decode steps on the
    reference's params and batch with the cap ``cap``."""
    _, ct = configs(name, cap)
    P = offset(ct)
    with torch.no_grad():
        full = tlm.forward_logits(ref["params"], ref["batch"], ct)
        last, cache = tlm.prefill(ref["params"], ref["batch"], ct,
                                  max_len=ref["max_len"])
        first = {k: v.clone() for k, v in cache.items()}
        steps = []
        for t in range(STEPS):
            lg, cache = tlm.decode_step(
                ref["params"], torch.from_numpy(ref["toks"][t]).long(),
                cache, P + S + t, ct)
            steps.append(lg)
    return {"full": full, "last": last, "cache": first, "after": cache,
            "steps": steps}


def _hold(got, ref, tol_):
    """The port's forward, prefill logits and cache, decode steps and the
    cache after them (``_port_serve``) within ``tol_`` of the
    reference's."""
    for key in ("full", "last"):
        assert got[key].shape == ref[key].shape
        assert err(got[key], ref[key]) < tol_, (key, err(got[key],
                                                         ref[key]))
    for stage in ("cache", "after"):
        assert sorted(got[stage]) == sorted(ref[stage])
        for leaf, c in got[stage].items():
            assert err(c, ref[stage][leaf]) < tol_, (stage, leaf)
    for t, lg in enumerate(got["steps"]):
        assert err(lg, ref["steps"][t]) < tol_, (t, err(lg,
                                                       ref["steps"][t]))


@pytest.mark.parametrize("name", SERVED)
def test_capped_serving_matches_reference(name, monkeypatch):
    """forward_logits, prefill's logits and cache, and two decode steps
    (uncapped in both packages) carrying that cache; the MoE archs held to
    the reference's router picks."""
    ref = reference(name)
    tol_ = tol(name)
    uncapped = _port_serve(name, 0.0, ref)["full"]      # its own picks
    cj, _ = configs(name)
    if cj.n_experts:
        routing = SameRouting(monkeypatch)
        routing.calls = list(ref["calls"])
    got = _port_serve(name, CAP, ref)
    _hold(got, ref, tol_)
    moved = err(uncapped, got["full"])
    assert moved > BITE * tol_, f"{name}: the cap moved the logits {moved}"


@pytest.mark.parametrize("mode", ["full", "tri"])
@pytest.mark.parametrize("name", SERVED)
def test_capped_training_matches_reference(name, mode, monkeypatch):
    """The loss and every gradient leaf of one capped step, 2 x 16 tokens
    in attention blocks of 8 (``mode`` "tri" skips the block above the
    diagonal), the backward through the tanh."""
    ref = train_reference(name, mode)
    tol_ = TOL_F32
    if configs(name)[0].enc_dec:
        f32_frames(monkeypatch)
    _, uncapped = port_grads(name, ref["params"], ref["batch"], 0.0, mode)
    cj, _ = configs(name)
    if cj.n_experts:
        routing = SameRouting(monkeypatch, traced=True)
        routing.calls = list(ref["calls"])
    loss, grads = port_grads(name, ref["params"], ref["batch"], CAP, mode)
    assert math.isfinite(loss)
    assert abs(loss - ref["loss"]) < tol_ * abs(ref["loss"]), (loss,
                                                               ref["loss"])
    bad = {n: e for n, e in grad_errs(grads, ref["grads"]).items()
           if not e < tol_}
    assert not bad, bad
    moved = max(grad_errs(uncapped, ref["grads"]).values())
    assert moved > BITE * tol_, f"{name}: the cap moved a leaf by {moved}"


def test_mla_ignores_the_cap(monkeypatch):
    """deepseek-v2-tiny: the reference's ``mla_attention_full`` passes no
    cap (``repro/models/layers.py:540``).  The port's capped forward,
    prefill (logits and cache) and two decode steps are held to the
    reference's capped run within 2e-2, on its router picks (no bite is
    asserted: the cap changes nothing there), and give exactly the port's
    uncapped outputs; so does the training loss."""
    name = "deepseek-v2-tiny"
    ref = reference(name)
    ps, toks = ref["params"], ref["batch"]["tokens"]
    losses = [tlm.forward_train(ps, {"tokens": toks, "labels": toks},
                                configs(name, cap)[1]) for cap in (0.0, CAP)]
    assert torch.equal(*losses)
    routing = SameRouting(monkeypatch)
    outs = []
    for cap in (CAP, 0.0):
        routing.calls = list(ref["calls"])
        outs.append(_port_serve(name, cap, ref))
    got, plain = outs
    _hold(got, ref, tol(name))
    for key in ("full", "last", "cache", "after", "steps"):
        a, b = got[key], plain[key]
        pairs = zip(a.values(), b.values()) if isinstance(a, dict) \
            else zip(a, b) if isinstance(a, list) else [(a, b)]
        assert all(torch.equal(x, y) for x, y in pairs), key


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_capped_model_decodes_uncapped(paged):
    """A capped model's decode step equals the uncapped model's on the
    same cache, bit for bit, as the reference's ``decode_attention`` has
    no cap (``repro/models/layers.py:310``); the capped prefill that made
    the cache does differ."""
    ref = reference("llama3.2-tiny")
    ps, bt = ref["params"], ref["batch"]
    _, capped = configs("llama3.2-tiny")
    plain = dataclasses.replace(capped, attn_logit_softcap=0.0)
    tok = torch.from_numpy(ref["toks"][0]).long()
    with torch.no_grad():
        _, cache = tlm.prefill(ps, bt, capped, max_len=S + 1)
        if paged:                  # each row's cache as one pool block
            pools = (cache["k"], cache["v"])
            tables = torch.arange(B, dtype=torch.int32)[:, None]
            pos = torch.full((B,), S, dtype=torch.int32)
            run = lambda cfg: tlm.decode_step_paged(  # noqa: E731
                ps, tok, *(p.clone() for p in pools), tables, pos,
                torch.arange(B, dtype=torch.int32), pos, cfg)[0]
        else:
            run = lambda cfg: tlm.decode_step(  # noqa: E731
                ps, tok, {k: v.clone() for k, v in cache.items()}, S,
                cfg)[0]
        assert torch.equal(run(capped), run(plain))
        assert not torch.equal(tlm.prefill(ps, bt, plain, max_len=S)[0],
                               tlm.prefill(ps, bt, capped, max_len=S)[0])
