"""The port's sharded serving path (``lm.forward_logits`` / ``prefill`` /
``decode_step`` with an ``env`` over a DTensor mesh of thread-ranks)
against the reference's one-device run, for the tests of the seven
uniform archs' tiny configs.

The reference runs once a module per arch (``reference``): its
``forward_logits``, ``prefill`` (max_len P + S + STEPS) and STEPS greedy
``decode_step``s, its layers unrolled so its MoE picks are concrete and
recorded (``torch_routing.SameRouting``).  ``check_case`` runs the port on
each rank of a (dp, tp) mesh under one option set, teacher-forced with
the reference's greedy ids, and holds every output to the reference's
within the bf16 tolerance 2e-2 relative to its largest magnitude where
that passes 1 (tests/test_kernels.py), the greedy picks equal or parted
at a near-tie of the reference (``parted_argmax``: the ranks sum partial
products in another order than one device does), and each output's
and cache leaf's placements to ``named(...)`` of the reference's spec: the
logits (batch axes, None, "model") as the reference's dry run fixes them
(batch replicated in ``serve_fullshard`` decode), the cache
``cache_pspecs``.  The MoE archs' forward and prefill run under
``moe_impl="dense"`` (a prefill's capacity could drop tokens; the
reference allows it), their decode under "ep", where no token drops
(t_local <= 4 <= capacity)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import (command_r_35b, deepseek_v2_236b,  # noqa: F401
                           llama3_2_3b, llava_next_34b, mistral_nemo_12b,
                           mixtral_8x22b, qwen3_32b)
from repro.models import lm as jlm
from repro.models.sharding import ShardingEnv as JEnv
from repro_torch.configs import command_r_35b as t_command_r
from repro_torch.configs import deepseek_v2_236b as t_deepseek
from repro_torch.configs import llama3_2_3b as t_llama
from repro_torch.configs import llava_next_34b as t_llava
from repro_torch.configs import mistral_nemo_12b as t_mistral
from repro_torch.configs import mixtral_8x22b as t_mixtral
from repro_torch.configs import qwen3_32b as t_qwen
from repro_torch.models import lm as tlm
from repro_torch.models.sharding import ShardingEnv, distribute
from torch_mesh import data_rows, on_mesh
from torch_routing import SameRouting, parted_argmax

TOL = 2e-2
ARCHS = {
    "llama3.2-tiny": (llama3_2_3b.tiny(), t_llama.tiny()),
    "qwen3-tiny": (qwen3_32b.tiny(), t_qwen.tiny()),
    "mistral-nemo-tiny": (mistral_nemo_12b.tiny(), t_mistral.tiny()),
    "command-r-tiny": (command_r_35b.tiny(), t_command_r.tiny()),
    "mixtral-tiny": (mixtral_8x22b.tiny(), t_mixtral.tiny()),
    "deepseek-v2-tiny": (deepseek_v2_236b.tiny(), t_deepseek.tiny()),
    "llava-next-tiny": (llava_next_34b.tiny(), t_llava.tiny()),
}
# the dry run's defaults (sp, fsdp, moe_impl "ep"), then one change each
OPTS = {"defaults": {}, "rs_matmul": {"rs_matmul": True},
        "no_fsdp": {"fsdp": False},
        "serve_fullshard": {"serve_fullshard": True}}
B, S, STEPS = 4, 12, 4
ENV_J = JEnv(None, opts={"remat": False, "sp": False, "moe_impl": "dense",
                         "unroll_layers": True})


def cases(names, extra=()):
    """(arch, mesh, option set) for ``names`` on (1, 2) and (2, 2), and
    for ``extra`` on (1, 4) too."""
    out = [(n, m, o) for n in names for m in ((1, 2), (2, 2)) for o in OPTS]
    return out + [(n, (1, 4), o) for n in extra for o in OPTS]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.array(jnp.asarray(x).astype(jnp.float32))


def _close(a, b) -> bool:
    a, b = _np(a), _np(b)
    return float(np.max(np.abs(a - b))) < TOL * max(
        1.0, float(np.max(np.abs(b))))


def _bf16(a):
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.array(j).view(np.int16)).view(
        torch.bfloat16)


@functools.lru_cache(maxsize=None)
def reference(name):
    """The reference's one-device run of ``name`` and the port's batch and
    carried params (made once a module; the tests only read them)."""
    cj, _ = ARCHS[name]
    pj = jlm.init_params(cj, jax.random.PRNGKey(0))
    rng = np.random.RandomState(1)
    toks = rng.randint(1, cj.vocab, size=(B, S)).astype(np.int32)
    bj, bt = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    P = 0
    if cj.family == "vlm":
        P = 4
        bj["patches"], bt["patches"] = _bf16(
            rng.randn(B, P, cj.d_model).astype(np.float32) * 0.02)
    max_len = P + S + STEPS
    with pytest.MonkeyPatch.context() as mp:
        routing = SameRouting(mp) if cj.n_experts else None
        full = jlm.forward_logits(pj, bj, cj, ENV_J)
        last, cache = jlm.prefill(pj, bj, cj, ENV_J, max_len=max_len)
        prefill_cache = {k: _np(v) for k, v in cache.items()}
        ids, steps = [], []
        tok = np.asarray(jnp.argmax(last, -1), np.int32)
        for t in range(STEPS):
            ids.append(tok)
            lg, cache = jlm.decode_step(pj, jnp.asarray(tok), cache,
                                        P + S + t, cj, ENV_J)
            steps.append(_np(lg))
            tok = np.asarray(jnp.argmax(lg, -1), np.int32)
    pt = tlm.params_from_jax(jax.tree_util.tree_map(np.asarray, pj), "cpu")
    return {"params": pt, "batch": bt, "P": P, "max_len": max_len,
            "full": _np(full), "last": _np(last), "cache": prefill_cache,
            "ids": ids, "steps": steps,
            "calls": routing.calls if routing else None}


def _run(name, mesh, opts):
    """The port on each rank; rank 0's whole outputs and placements, and
    the placements the reference's specs give."""
    ref = reference(name)
    _, ct = ARCHS[name]
    P, max_len, bt_in = ref["P"], ref["max_len"], ref["batch"]

    def rank(env):
        env_pre = (ShardingEnv(env.mesh, dict(opts, moe_impl="dense"))
                   if ct.n_experts else env)
        bt = env.batch_axes
        dec_bt = None if opts.get("serve_fullshard") else bt
        V = ct.vocab
        want = {"full": env.named((B, P + S, V), [bt, None, "model"]),
                "last": env.named((B, 1, V), [bt, None, "model"]),
                "step": env.named((B, 1, V), [dec_bt, None, "model"]),
                "cache": tlm.cache_pspecs(ct, env, B, max_len)}
        ps = distribute(ref["params"], tlm.param_shardings(ct, env))
        with torch.no_grad():
            full = tlm.forward_logits(ps, bt_in, ct, env_pre)
            last, cache = tlm.prefill(ps, bt_in, ct, env_pre,
                                      max_len=max_len)
            out = {"full": (full.full_tensor(), full.placements),
                   "last": (last.full_tensor(), last.placements),
                   "cache": {k: (v.full_tensor().clone(), v.placements)
                             for k, v in cache.items()}}
            steps = []
            for t in range(STEPS):
                lg, cache = tlm.decode_step(
                    ps, torch.from_numpy(np.array(ref["ids"][t])), cache, P + S + t,
                    ct, env)
                steps.append((lg.full_tensor(), lg.placements))
        out["steps"] = steps
        out["cache_after"] = {k: v.placements for k, v in cache.items()}
        want = {k: ({n: s.placements for n, s in v.items()}
                    if isinstance(v, dict) else v.placements)
                for k, v in want.items()}
        return out, want

    return on_mesh(*mesh, rank, opts)[0]


def check_case(name, mesh, opt_name, monkeypatch):
    ref = reference(name)
    cj, _ = ARCHS[name]
    if cj.n_experts:
        routing = SameRouting(monkeypatch, rows=data_rows(mesh[1]))
        routing.calls = list(ref["calls"])
    out, want = _run(name, mesh, OPTS[opt_name])
    # greedy picks equal, or parted at a near-tie of the reference
    for key in ("full", "last"):
        y, pls = out[key]
        assert pls == want[key], (key, pls, want[key])
        assert y.dtype == torch.float32 and y.shape == ref[key].shape
        assert _close(y, ref[key]), key
        parted_argmax(_np(y), ref[key], TOL)
    for name_, (c, pls) in out["cache"].items():
        assert pls == want["cache"][name_], (name_, pls)
        assert c.shape == ref["cache"][name_].shape
        assert _close(c, ref["cache"][name_]), name_
    assert out["cache_after"] == want["cache"]
    for t, (lg, pls) in enumerate(out["steps"]):
        assert pls == want["step"], (t, pls)
        assert _close(lg, ref["steps"][t]), t
        parted_argmax(_np(lg), ref["steps"][t], TOL)
