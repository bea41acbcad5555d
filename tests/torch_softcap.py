"""Soft-capped attention (``cfg.attn_logit_softcap``) for
tests/test_torch_{softcap,sharded_softcap}.py: the capped tiny configs,
their params and batches, and the reference's runs, each made once a
module.

The reference applies ``s = cap * tanh(s / cap)`` after the 1/sqrt(D)
scale and before the mask in ``attention_dense``, ``chunked_attention``
and its training route (``repro/models/layers.py:101-102, 204-205,
271-272``), for every full-sequence GQA attention; its decode and MLA take
no cap (``layers.py:310, 540``).

A cap cannot bite at the reference's init: at d_model 64 and head_dim 16
the scores have a standard deviation of about 0.02 (largest 0.1),
attention is near uniform, and a capped model's logits move by 3e-3 from
its uncapped ones even at a cap of 0.05, far below the bf16 tolerance
2e-2.  So every ``wq`` (self- and cross-attention) is scaled by
``Q_SCALE`` and every ``wo`` by ``O_SCALE`` in the reference's params
before they are carried (both packages get the same params): the scores
then have a standard deviation of about 2.5 (largest 10), a cap of
``CAP`` (1.0; Gemma 2's published cap is 50.0 on trained scores) holds
them to +-1, and the capped logits move by 0.43 to 0.71 from the
uncapped ones, past 10x the tolerance.  The tests say how far each
output moved."""
import dataclasses
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import lm as jlm
from repro.models.sharding import ShardingEnv
from repro_torch.models import lm as tlm
from torch_routing import SameRouting

CAP = 1.0
Q_SCALE, O_SCALE = 128.0, 8.0
TOL, TOL_F32 = 2e-2, 1e-3      # bf16 (tests/test_kernels.py:38); jamba f32
BITE = 10                      # a capped output moves >= BITE x its tol
FAMILIES = {"llama3.2-tiny": "llama3_2_3b", "mixtral-tiny": "mixtral_8x22b",
            "llava-next-tiny": "llava_next_34b",
            "jamba-tiny": "jamba_v0_1_52b",
            "seamless-tiny": "seamless_m4t_large_v2",
            "deepseek-v2-tiny": "deepseek_v2_236b"}
F32 = ("jamba-tiny",)          # the hybrid family is held in f32
B, S, STEPS, PATCHES, FRAMES = 2, 16, 2, 4, 16
ENV = ShardingEnv(None, opts={"remat": False, "sp": False,
                              "moe_impl": "dense", "unroll_layers": True})
TRAIN = {"remat": False, "sp": False, "moe_impl": "dense", "attn_block": 8,
         "loss_chunk": 8}


def configs(name, cap=CAP):
    """The reference's and the port's tiny config of ``name`` with the
    cap set (``cap`` 0: as shipped)."""
    mod = FAMILIES[name]
    return tuple(dataclasses.replace(
        importlib.import_module(f"{pkg}.configs.{mod}").tiny(),
        attn_logit_softcap=cap) for pkg in ("repro", "repro_torch"))


def tol(name) -> float:
    return TOL_F32 if name in F32 else TOL


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def err(a, b) -> float:
    """The largest |a - b| over the largest |b| where that passes 1."""
    a, b = _np(a), _np(b)
    return float(np.max(np.abs(a - b))) / max(1.0, float(np.max(np.abs(b))))


def leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], prefix + (k,))
    else:
        yield "/".join(prefix), tree


def _scaled(tree, scales, path=()):
    if isinstance(tree, dict):
        return {k: _scaled(v, scales, path + (k,)) for k, v in tree.items()}
    scale = dict(zip(("wq", "wo"), scales)).get(path[-1])
    if scale is None or len(path) < 2 or path[-2] not in ("attn", "cross"):
        return tree
    return (tree.astype(jnp.float32) * scale).astype(tree.dtype)


def params(name, f32=False):
    """The reference's PRNGKey(0) params of ``name``, its attention
    scaled (the module docstring), in f32 for ``F32`` or where ``f32``."""
    cj, _ = configs(name)
    pj = _scaled(jlm.init_params(cj, jax.random.PRNGKey(0)),
                 (Q_SCALE, O_SCALE))
    if f32 or name in F32:
        pj = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), pj)
    return pj


def carried(pj):
    return tlm.params_from_jax(jax.tree_util.tree_map(np.asarray, pj), "cpu")


def batch(cfg, rng, labels=False, f32=False):
    """The reference's and the port's batch, drawn with numpy: B x S
    tokens (vlm: PATCHES patch embeddings first; enc-dec: FRAMES frames
    and S target tokens), and with ``labels`` their labels; the
    embeddings in bf16, or with ``f32`` in f32."""
    ints = lambda: rng.randint(1, cfg.vocab, size=(B, S))  # noqa: E731
    key = "tgt_tokens" if cfg.enc_dec else "tokens"
    arrs = {key: ints()}
    if labels:
        arrs["tgt_labels" if cfg.enc_dec else "labels"] = ints()
    if cfg.enc_dec:
        arrs["frames"] = rng.randn(B, FRAMES, cfg.d_model) * 0.02
    elif cfg.family == "vlm":
        arrs["patches"] = rng.randn(B, PATCHES, cfg.d_model) * 0.02
    ref, port = {}, {}
    for k, a in arrs.items():
        if a.dtype == np.float64:
            ref[k] = jnp.asarray(a, jnp.float32)
            port[k] = torch.from_numpy(a.astype(np.float32))
            if not f32:
                ref[k], port[k] = ref[k].astype(jnp.bfloat16), \
                    port[k].bfloat16()
        else:
            ref[k] = jnp.asarray(a.astype(np.int32))
            port[k] = torch.from_numpy(a)
    return ref, port


def offset(cfg) -> int:
    """Positions before the tokens (the vlm's patches)."""
    return PATCHES if cfg.family == "vlm" else 0


@functools.lru_cache(maxsize=None)
def reference(name):
    """The reference's capped run of ``name``, jitted: ``forward_logits``,
    ``prefill`` (max_len offset + S + STEPS) and STEPS ``decode_step``s on
    numpy-drawn tokens (its decode uncapped, as written), its MoE picks
    recorded; with the port's carried params and batch."""
    cj, _ = configs(name)
    pj = params(name)
    rng = np.random.RandomState(1)
    bj, bt = batch(cj, rng)
    P = offset(cj)
    max_len = P + S + STEPS
    toks = rng.randint(1, cj.vocab, size=(STEPS, B, 1)).astype(np.int32)
    with pytest.MonkeyPatch.context() as mp:
        routing = SameRouting(mp, traced=True) if cj.n_experts else None
        full = jax.jit(lambda p, b: jlm.forward_logits(p, b, cj, ENV))(
            pj, bj)
        last, cache = jax.jit(lambda p, b: jlm.prefill(
            p, b, cj, ENV, max_len=max_len))(pj, bj)
        first = {k: _np(v) for k, v in cache.items()}
        step = jax.jit(lambda p, t, c, pos: jlm.decode_step(p, t, c, pos,
                                                            cj, ENV))
        steps = []
        for t in range(STEPS):
            lg, cache = step(pj, jnp.asarray(toks[t]), cache,
                             jnp.asarray(P + S + t, jnp.int32))
            steps.append(_np(lg))
        jax.effects_barrier()
    return {"params": carried(pj), "batch": bt, "max_len": max_len,
            "toks": toks, "full": _np(full), "last": _np(last),
            "cache": first, "after": {k: _np(v) for k, v in cache.items()},
            "steps": steps, "calls": routing.calls if routing else None}


def f32_frames(mp):
    """The enc-dec encoder's input cast (``frames.astype(BF16)`` in both
    packages) made an f32 one, so that seamless runs in f32 where its
    params are f32 (the reference's encoder scan refuses a bf16 carry
    with f32 params)."""
    from repro.models import encdec as jencdec
    from repro_torch.models import encdec as tencdec
    mp.setattr(jencdec, "BF16", jnp.float32)
    mp.setattr(tencdec, "BF16", torch.float32)


@functools.lru_cache(maxsize=None)
def train_reference(name, mode):
    """``jax.value_and_grad`` of the reference's capped ``forward_train``
    under ``TRAIN`` with ``attn_mode`` ``mode`` (blocks of 8 over 16
    tokens), jitted, every param and embedding in f32 (``f32_frames``);
    (loss, {leaf: grad} numpy f32, the port's params and batch, the MoE
    picks)."""
    cj, _ = configs(name)
    pj = params(name, f32=True)
    bj, bt = batch(cj, np.random.RandomState(2), labels=True, f32=True)
    env = ShardingEnv(None, dict(TRAIN, attn_mode=mode))
    with pytest.MonkeyPatch.context() as mp:
        routing = SameRouting(mp, traced=True) if cj.n_experts else None
        if cj.enc_dec:
            f32_frames(mp)
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: jlm.forward_train(p, bj, cj, env)))(pj)
        jax.effects_barrier()
    return {"loss": float(loss), "params": carried(pj), "batch": bt,
            "grads": dict(leaves(jax.tree_util.tree_map(
                lambda a: np.asarray(a, np.float32), grads))),
            "calls": routing.calls if routing else None}


def port_grads(name, ps, bt, cap, mode="full", env=None):
    """The port's loss and gradients (numpy f32 by leaf path) of
    ``forward_train`` on ``ps`` with the cap ``cap``, the reference's
    training options (``env``: a mesh's; its params are DTensors)."""
    from repro_torch.models.sharding import whole
    _, ct = configs(name, cap)
    ps = jax.tree_util.tree_map(lambda t: t.detach().clone(), ps) \
        if env is None else ps
    for _, t in leaves(ps):
        t.requires_grad_(True)
    opts = {"attn_block": 8, "loss_chunk": 8, "attn_mode": mode}
    loss = tlm.forward_train(ps, bt, ct, env, opts=None if env else opts)
    loss.backward()
    with torch.no_grad():
        return float(loss.detach()), {
            n: _np(t.grad if env is None else whole(t.grad))
            for n, t in leaves(ps)}


def grad_errs(got, want) -> dict:
    """{leaf: the largest |got - want| over want's largest magnitude}."""
    return {n: float(np.abs(got[n] - g).max())
            / max(float(np.abs(g).max()), 1e-30) for n, g in want.items()}
