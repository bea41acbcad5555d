"""The port's sharded serving of the recurrent and enc-dec families
(rwkv6-tiny, jamba-tiny, seamless-tiny: ``lm.forward_logits`` /
``prefill`` / ``decode_step`` with an ``env`` over a DTensor mesh of
thread-ranks) against the reference's one-device run, for
tests/test_torch_sharded_{recurrent,hybrid,encdec}.py.

The reference runs once a module per arch and dtype (``reference``), as
``torch_sharded.reference`` does for the uniform archs: its
``forward_logits``, ``prefill`` (max_len S + STEPS) and STEPS greedy
``decode_step``s, each jitted (eagerly, each of its scans would compile
at every call), its layers unrolled and jamba's MoE picks recorded
inside the jitted functions (``torch_routing.SameRouting(traced=True)``).  ``check_case`` runs the port on each
rank of a (dp, tp) mesh under one option set, teacher-forced with the
reference's greedy ids, and holds the logits and every cache leaf
(``wkv``, ``shift_*``; ``k``, ``v``, ``conv``, ``ssm``; ``k``, ``v``,
``cross_k``, ``cross_v``) to the reference's within ``TOL`` (2e-2 in
bf16, 2e-5 in f32, tests/test_kernels.py) of the largest magnitude where
that passes 1, the greedy picks equal or parted at a near-tie, and the
placements to ``named(...)`` of the reference's specs.  jamba's forward
and prefill run under ``moe_impl="dense"``, its decode under "ep" (no
token drops: t_local <= 4 <= capacity).

rwkv6-tiny's token-shift mixes (``maa_*``, ``cmix_maa_*``) are drawn in
[0, 1), as a trained model's are: at init they are zero, and the channel
mix would not read the shifted token at all, so no shift fault could
show.  seamless-tiny runs ``SS`` frames; ``seamless-tiny-v258`` has a
vocabulary of 258, which 2 divides and 4 does not, as seamless-m4t's
256,206 (``embed`` / ``unembed`` split over 'model' at tp 2, replicated
at tp 4)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import jamba_v0_1_52b, rwkv6_7b, seamless_m4t_large_v2
from repro.models import lm as jlm
from repro_torch.configs import jamba_v0_1_52b as t_jamba
from repro_torch.configs import rwkv6_7b as t_rwkv
from repro_torch.configs import seamless_m4t_large_v2 as t_seamless
from repro_torch.models import lm as tlm
from repro_torch.models.sharding import ShardingEnv, distribute
from torch_mesh import data_rows, on_mesh
from torch_routing import SameRouting, parted_argmax
from torch_sharded import ENV_J, OPTS, _np

TOL = {"bfloat16": 2e-2, "float32": 2e-5}
B, S, STEPS, SS = 4, 12, 4, 16
MESHES = ((1, 2), (2, 2), (1, 4))
ARCHS = {
    "rwkv6-tiny": (rwkv6_7b.tiny(), t_rwkv.tiny()),
    "jamba-tiny": (jamba_v0_1_52b.tiny(), t_jamba.tiny()),
    "seamless-tiny": (seamless_m4t_large_v2.tiny(), t_seamless.tiny()),
    "seamless-tiny-v258": (
        dataclasses.replace(seamless_m4t_large_v2.tiny(), vocab=258),
        dataclasses.replace(t_seamless.tiny(), vocab=258)),
}


def cases(name, meshes=MESHES):
    return [(name, m, o) for m in meshes for o in OPTS]


def err(a, b) -> float:
    """The largest |a - b| over the largest |b| where that passes 1."""
    a, b = _np(a), _np(b)
    return float(np.max(np.abs(a - b))) / max(1.0, float(np.max(np.abs(b))))


def _trained_mixes(pj, rng):
    layers = dict(pj["layers"])
    for part, names in (("tm", ("maa_x", "maa_w", "maa_k", "maa_v",
                                "maa_r", "maa_g")),
                        ("cm", ("cmix_maa_k", "cmix_maa_r"))):
        layers[part] = dict(layers[part])
        for n in names:
            a = layers[part][n]
            layers[part][n] = jnp.asarray(rng.uniform(0, 1, a.shape),
                                          a.dtype)
    return {**pj, "layers": layers}


def reference(name, dtype="bfloat16"):
    """The reference's one-device run of ``name`` with params in
    ``dtype``, and the port's batch and carried params (made once a
    module; the tests only read them)."""
    return _reference(name, dtype)


@functools.lru_cache(maxsize=None)
def _reference(name, dtype):
    cj, _ = ARCHS[name]
    rng = np.random.RandomState(1)
    pj = jlm.init_params(cj, jax.random.PRNGKey(0))
    if cj.family == "ssm":
        pj = _trained_mixes(pj, rng)
    if dtype == "float32":
        pj = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), pj)
    toks = rng.randint(1, cj.vocab, size=(B, S)).astype(np.int32)
    if cj.enc_dec:
        frames = (rng.randn(B, SS, cj.d_model) * 0.02).astype(np.float32)
        bj = {"frames": jnp.asarray(frames), "tgt_tokens": jnp.asarray(toks)}
        bt = {"frames": torch.from_numpy(frames),
              "tgt_tokens": torch.from_numpy(toks)}
    else:
        bj, bt = {"tokens": jnp.asarray(toks)}, {"tokens":
                                                 torch.from_numpy(toks)}
    max_len = S + STEPS
    with pytest.MonkeyPatch.context() as mp:
        routing = SameRouting(mp, traced=True) if cj.n_experts else None
        full = jax.jit(lambda p, b: jlm.forward_logits(p, b, cj, ENV_J))(
            pj, bj)
        last, cache = jax.jit(lambda p, b: jlm.prefill(
            p, b, cj, ENV_J, max_len=max_len))(pj, bj)
        prefill_cache = {k: _np(v) for k, v in cache.items()}
        step = jax.jit(lambda p, t, c, pos: jlm.decode_step(p, t, c, pos,
                                                            cj, ENV_J))
        ids, steps = [], []
        tok = np.asarray(jnp.argmax(last, -1), np.int32)
        for t in range(STEPS):
            ids.append(tok)
            lg, cache = step(pj, jnp.asarray(tok), cache,
                             jnp.asarray(S + t, jnp.int32))
            steps.append(_np(lg))
            tok = np.asarray(jnp.argmax(lg, -1), np.int32)
        jax.effects_barrier()
    pt = tlm.params_from_jax(jax.tree_util.tree_map(np.asarray, pj), "cpu")
    return {"params": pt, "batch": bt, "max_len": max_len,
            "full": _np(full), "last": _np(last), "cache": prefill_cache,
            "after": {k: _np(v) for k, v in cache.items()}, "ids": ids,
            "steps": steps, "calls": routing.calls if routing else None}


def run(name, mesh, opts, monkeypatch, dtype="bfloat16"):
    """The port on each rank of ``mesh`` under ``opts``; rank 0's whole
    outputs (and their placements), with the placements the reference's
    specs give."""
    ref = reference(name, dtype)
    cj, ct = ARCHS[name]
    if cj.n_experts:
        routing = SameRouting(monkeypatch, rows=data_rows(mesh[1]))
        routing.calls = list(ref["calls"])
    max_len = ref["max_len"]

    def rank(env):
        env_pre = (ShardingEnv(env.mesh, dict(opts, moe_impl="dense"))
                   if ct.n_experts else env)
        bt = env.batch_axes
        dec_bt = None if opts.get("serve_fullshard") else bt
        V = ct.vocab
        want = {"full": env.named((B, S, V), [bt, None, "model"]),
                "last": env.named((B, 1, V), [bt, None, "model"]),
                "step": env.named((B, 1, V), [dec_bt, None, "model"]),
                "cache": tlm.cache_pspecs(ct, env, B, max_len,
                                          src_len=SS if ct.enc_dec else None)}
        ps = distribute(ref["params"], tlm.param_shardings(ct, env))
        with torch.no_grad():
            full = tlm.forward_logits(ps, ref["batch"], ct, env_pre)
            last, cache = tlm.prefill(ps, ref["batch"], ct, env_pre,
                                      max_len=max_len)
            out = {"full": (full.full_tensor(), full.placements),
                   "last": (last.full_tensor(), last.placements),
                   "cache": {k: (v.full_tensor().clone(), v.placements)
                             for k, v in cache.items()}}
            steps = []
            for t in range(STEPS):
                lg, cache = tlm.decode_step(
                    ps, torch.from_numpy(np.array(ref["ids"][t])), cache,
                    S + t, ct, env)
                steps.append((lg.full_tensor(), lg.placements))
        out["steps"] = steps
        out["after"] = {k: (v.full_tensor(), v.placements)
                        for k, v in cache.items()}
        want = {k: ({n: s.placements for n, s in v.items()}
                    if isinstance(v, dict) else v.placements)
                for k, v in want.items()}
        return out, want

    return on_mesh(*mesh, rank, opts)[0]


def check_case(name, mesh, opt_name, monkeypatch, dtype="bfloat16"):
    ref = reference(name, dtype)
    tol = TOL[dtype]
    out, want = run(name, mesh, OPTS[opt_name], monkeypatch, dtype)
    for key in ("full", "last"):
        y, pls = out[key]
        assert pls == want[key], (key, pls, want[key])
        assert y.dtype == torch.float32 and y.shape == ref[key].shape
        assert err(y, ref[key]) < tol, (key, err(y, ref[key]))
        parted_argmax(_np(y), ref[key], tol)
    for stage, got in (("cache", out["cache"]), ("after", out["after"])):
        assert set(got) == set(ref[stage])
        for leaf, (c, pls) in got.items():
            assert pls == want["cache"][leaf], (stage, leaf, pls)
            assert c.shape == ref[stage][leaf].shape, (stage, leaf)
            assert err(c, ref[stage][leaf]) < tol, (
                stage, leaf, err(c, ref[stage][leaf]))
    for t, (lg, pls) in enumerate(out["steps"]):
        assert pls == want["step"], (t, pls)
        assert err(lg, ref["steps"][t]) < tol, (t, err(lg, ref["steps"][t]))
        parted_argmax(_np(lg), ref["steps"][t], tol)
    return out


def shift_on_shards(shift, tp):
    """``rwkv._token_shift`` taken on each of tp sequence shards alone, as
    a rank would take it on its shard of a stream whose sequence is split
    over 'model': each shard after the first starts from zeros instead of
    the previous shard's last token (a decode's one token passes)."""
    def planted(x, last):
        if x.shape[1] != S:
            return shift(x, last)
        parts = x.chunk(tp, dim=1)
        return torch.cat([shift(parts[0], last)]
                         + [shift(p, None) for p in parts[1:]], dim=1)
    return planted


def conv_on_shards(conv, tp):
    """``mamba._causal_depthwise_conv`` taken on each of tp sequence
    shards alone: each shard after the first misses the d_conv - 1 tokens
    before it (a decode's carried window passes)."""
    def planted(x, w, b):
        if x.shape[1] != S:
            return conv(x, w, b)
        return torch.cat([conv(p, w, b) for p in x.chunk(tp, dim=1)], dim=1)
    return planted
