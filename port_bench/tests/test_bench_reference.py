"""The plain reference against the port on tiny configurations (CPU).

A session is served by the port's own paged ``Engine`` (a first admission,
decode, a park and a resume that prefills its delta alone, decode, an
eviction and a regeneration, decode), its logits taken where the program
makes them; the reference, given only the prompts and served tokens,
must reproduce them.  A reference that counted the delta's positions on
from the cache (not as the served path keeps them) must not."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from port_bench import spec, weights
from port_bench.correct import session_chunks
from port_bench.reference import model as refmodel

from conftest import TINY

# bf16 serving against the f32 reference at d_model 64 (matrix std 0.05):
# logits of scale ~1.2-1.5 agree within 7.9e-3 to 1.10e-2 (dense and moe,
# seeds 1234, 99, 7); the delta counted on from the cache moves them by
# 0.23 to 0.42
TOL = 2.5e-2


def _sizes(moe: bool):
    c = dict(TINY, name="t")
    if moe:
        c.update(num_local_experts=4, num_experts_per_tok=2)
    return spec.model_sizes(c)


def _serve(m, params, prompts, n_outs, monkeypatch):
    """Serve one session step by step; returns (kinds, served, logits of
    each step's rows)."""
    from repro_torch.serving import engine as engmod
    logits = []
    real = engmod.lm.decode_step_paged

    def spy(*a, **k):
        out = real(*a, **k)
        logits.append(out[0][:, 0].float().clone())
        return out

    monkeypatch.setattr(engmod.lm, "decode_step_paged", spy)
    eng = engmod.Engine(spec.model_config(m), params, n_slots=2, max_len=256,
                        pool_blocks=32)
    ctx, kinds, served, per_step = [], [], [], []
    plan = ["first", "hit", "regen"]
    for j, (p, n) in enumerate(zip(prompts, n_outs)):
        ctx += list(p)
        if plan[j] == "regen":
            eng.evict_session("s")
        slot = eng.start_session("s", np.asarray(ctx), cached_hit=j > 0)
        kinds.append(plan[j])
        out, tok, rows = [], ctx[-1], []
        for _ in range(n):
            logits.clear()
            tok = eng.decode({slot: tok})[slot][0]
            out.append(tok)
            rows.append(logits[0][slot])
        ctx += out
        served.append(out)
        per_step.append(torch.stack(rows))
        assert eng.park_session("s")
    return kinds, served, per_step


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_reference_matches_the_served_path(moe, monkeypatch):
    m = _sizes(moe)
    params = weights.make_params(m, 1234, "cpu")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, m["vocab"], n) for n in (37, 9, 12)]
    kinds, served, got = _serve(m, params, prompts, [6, 5, 4], monkeypatch)
    chunks = session_chunks(prompts, kinds, served, [True] * 3)
    assert [c.kind for c in chunks] == ["full", "decode", "delta", "decode",
                                        "full", "decode"]
    ref = refmodel.Reference(params, m).logits([chunks])[0]
    want = [x for x in ref if x is not None]
    for g, w in zip(got, want):
        assert (g - w).abs().max().item() < TOL
    # the served path's design: a resumed delta counts positions from 0
    wrong = [refmodel.Chunk("decode" if c.kind == "delta" else c.kind,
                            c.ids, c.want) for c in chunks]
    bad = [x for x in refmodel.Reference(params, m).logits([wrong])[0]
           if x is not None]
    assert (got[1] - bad[1]).abs().max().item() > 4 * TOL


def test_control_rounds_to_fp8():
    x = torch.tensor([1.0, 1.0625, 3.0, -448.0])
    y = refmodel._q8(x)
    assert y[1] == 1.0 and y[3] == -448.0
