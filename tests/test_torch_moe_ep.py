"""The port's expert-parallel MoE (``layers.moe_ep``) on DTensor meshes
of thread-ranks against the reference's MoE functions on the same
carried params and bf16 inputs, within the bf16 tolerance 2e-2
(tests/test_kernels.py):

- EP (experts over 'model', E % tp == 0) where no (token, expert) pair is
  dropped, against ``moe_dense_ref``: mixtral-tiny (E 4) on (1, 2) and
  (1, 4), deepseek-v2-tiny (E 8, a shared expert outside ``moe_ep``) on
  (2, 2);
- EP where a skewed router overflows an expert, against the sum over
  model shards of the reference's ``_moe_local`` on each data shard's
  tokens (its capacity, its drops);
- d_ff TP (E % tp != 0, tp dividing d_ff): the sum of ``_moe_local`` over
  the d_ff slices;
- ``serve_fullshard`` on (2, 2): every token routed on every rank;
- the raise where tp divides neither E nor d_ff (the reference's d_ff-TP
  branch would sum tp whole copies: ROADMAP Queue 3).

The reference's router runs first and the port replays its picks
(``torch_routing.SameRouting``, each rank thread its data shard's rows);
a pick the port would have made otherwise must be a near-tie.  The
output's placements are those of ``moe_ep``'s ``out_spec``."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.configs import deepseek_v2_236b, mixtral_8x22b  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models.sharding import ShardingEnv as JEnv  # noqa: E402
from repro_torch.configs import deepseek_v2_236b as tdeepseek  # noqa: E402
from repro_torch.configs import mixtral_8x22b as tmixtral  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models.sharding import distribute  # noqa: E402
from torch_mesh import data_rows, on_mesh, replicated  # noqa: E402
from torch_routing import SameRouting  # noqa: E402

TOL = 2e-2
ARCHS = {"mixtral-tiny": (mixtral_8x22b.tiny(), tmixtral.tiny()),
         "deepseek-v2-tiny": (deepseek_v2_236b.tiny(), tdeepseek.tiny())}


def _moe(name, **changes):
    """Layer 0's MoE params of the reference's init, in both packages
    (bit-exact carry), for the arch with ``changes`` to its config."""
    cj, ct = (dataclasses.replace(c, **changes) for c in ARCHS[name])
    pj = jax.tree_util.tree_map(
        lambda a: np.asarray(a[0]),
        jlm.init_params(cj, jax.random.PRNGKey(0))["layers"]["mlp"])
    return cj, ct, pj


def _carry(pj):
    return tlm.params_from_jax({k: np.array(v) for k, v in pj.items()},
                               "cpu")


def _x(B, S, d, seed, shift=None):
    """(B, S, d) bf16 normals (plus ``shift`` on every token) in both
    packages, the same bits."""
    x = np.random.RandomState(seed).randn(B, S, d).astype(np.float32)
    if shift is not None:
        x = x + shift
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(np.array(xj).view(np.int16)).view(torch.bfloat16)
    return xj, xt


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _capacity(t_local, cfg, factor=1.25):
    return max(4, int(math.ceil(t_local * cfg.top_k / cfg.n_experts
                                * factor)))


def _drops(ids, n_shards, e_lo, e_n, cap):
    """Pairs the reference's capacity drops: per data shard of the
    (T, k) picks, each of experts [e_lo, e_lo + e_n) keeps ``cap``."""
    out = 0
    for part in np.split(ids, n_shards):
        for e in range(e_lo, e_lo + e_n):
            out += max(0, int((part == e).sum()) - cap)
    return out


def _run_port(ct, pt, xt, mesh, opts=None, **kw):
    """The port's ``moe_ep`` on each rank: (the whole output, its
    placements, the spec's placements) of rank 0."""
    dp, tp = mesh

    def rank(env):
        rules = tlm.param_rules(ct, env)
        p = {k: distribute(v, env.named(v.shape, rules(
            f"layers/mlp/{k}", (1, *v.shape))[1:])) for k, v in pt.items()}
        bt = None if (opts or {}).get("serve_fullshard") else env.batch_axes
        y = tl.moe_ep(replicated(xt, env), p, ct, env, **kw)
        return (y.full_tensor(), y.placements,
                env.named(xt.shape, [bt, None, None]).placements)

    return on_mesh(dp, tp, rank, opts)[0]


def _reference_shards(cj, pj, xj, dp, tp, split):
    """Sum over model shards of the reference's ``_moe_local`` on each of
    the dp data shards' tokens; ``split`` = "experts" (EP) or "d_ff"."""
    B, S, d = xj.shape
    E = cj.n_experts
    cap = _capacity(B // dp * S, cj)
    x2 = xj.reshape(dp, -1, d)
    rows = []
    for i in range(dp):
        tot = 0.0
        for m in range(tp):
            if split == "experts":
                el, e0 = E // tp, m * (E // tp)
                w1, w3, w2 = (pj[n][e0:e0 + el] for n in ("w1", "w3", "w2"))
            else:
                el, e0, f = E, 0, cj.d_ff // tp
                w1, w3 = (pj[n][:, :, m * f:(m + 1) * f] for n in ("w1", "w3"))
                w2 = pj["w2"][:, m * f:(m + 1) * f]
            y = jl._moe_local(x2[i], pj["router"], w1, w3, w2, n_experts=E,
                              top_k=cj.top_k, e_start=e0, e_local=el,
                              capacity=cap)
            tot = tot + _np(y)
        rows.append(tot)
    return np.concatenate(rows).reshape(B, S, d)


def _record(monkeypatch, cj, pj, xj, tp):
    """The reference's picks for every token, replayed by the port."""
    routing = SameRouting(monkeypatch, rows=data_rows(tp))
    _, ids = jl.moe_router(xj.reshape(-1, cj.d_model), pj["router"],
                           cj.top_k)
    return routing, np.asarray(ids)


def _check(out, ref):
    y, pls, want = out
    assert pls == want
    assert y.dtype == torch.bfloat16 and y.shape == ref.shape
    err = float(np.abs(_np(y) - ref).max())
    assert err < TOL * max(1.0, float(np.abs(ref).max())), err


@pytest.mark.parametrize("name,mesh,B,S", [
    ("mixtral-tiny", (1, 2), 2, 2), ("mixtral-tiny", (1, 4), 2, 2),
    ("mixtral-tiny", (1, 2), 4, 8), ("deepseek-v2-tiny", (2, 2), 4, 2)])
def test_moe_ep_expert_parallel_matches_dense_ref(name, mesh, B, S,
                                                  monkeypatch):
    cj, ct, pj = _moe(name)
    dp, tp = mesh
    assert cj.n_experts % tp == 0                     # the EP branch
    xj, xt = _x(B, S, cj.d_model, seed=B * S)
    ref = _np(jl.moe_dense_ref(xj.reshape(-1, cj.d_model), pj, cj)
              ).reshape(B, S, -1)
    routing, ids = _record(monkeypatch, cj, pj, xj, tp)
    # the larger batch routes 32 tokens to 4 experts: give each expert
    # room for all of its data shard's tokens, so no pair is dropped
    factor = cj.n_experts / cj.top_k if B * S > 8 else 1.25
    cap = _capacity(B // dp * S, cj, factor)
    assert _drops(ids, dp, 0, cj.n_experts, cap) == 0
    _check(_run_port(ct, _carry(pj), xt, mesh, capacity_factor=factor), ref)


def test_moe_ep_expert_parallel_drops_as_the_reference(monkeypatch):
    """A router skewed toward expert 0 overflows its capacity: the port
    drops the pairs the reference's ``_moe_local`` drops."""
    cj, ct, pj = _moe("mixtral-tiny")
    dp, tp, B, S = 2, 2, 4, 4
    u = np.random.RandomState(7).randn(cj.d_model).astype(np.float32)
    u /= np.linalg.norm(u)
    router = np.asarray(pj["router"], np.float32)
    router[:, 0] += 0.3 * u
    pj = dict(pj, router=np.asarray(jnp.asarray(router, jnp.bfloat16)))
    xj, xt = _x(B, S, cj.d_model, seed=3, shift=2.0 * u)
    ref = _reference_shards(cj, pj, xj, dp, tp, "experts")
    routing, ids = _record(monkeypatch, cj, pj, xj, tp)
    assert _drops(ids, dp, 0, cj.n_experts,
                  _capacity(B // dp * S, cj)) > 0
    _check(_run_port(ct, _carry(pj), xt, (dp, tp)), ref)


@pytest.mark.parametrize("mesh,n_experts", [((1, 8), 4), ((1, 4), 6)])
def test_moe_ep_dff_tensor_parallel(mesh, n_experts, monkeypatch):
    """E % tp != 0: every shard computes all experts over its d_ff slice;
    the shards' sum is the reference's ``_moe_local`` summed over the
    slices."""
    cj, ct, pj = _moe("mixtral-tiny", n_experts=n_experts)
    dp, tp = mesh
    assert cj.n_experts % tp and cj.d_ff % tp == 0
    B, S = 2, 8
    xj, xt = _x(B, S, cj.d_model, seed=5)
    ref = _reference_shards(cj, pj, xj, dp, tp, "d_ff")
    _record(monkeypatch, cj, pj, xj, tp)
    _check(_run_port(ct, _carry(pj), xt, mesh), ref)


def test_moe_ep_serve_fullshard(monkeypatch):
    """Experts over 'model', d_model over 'data', tokens replicated: each
    rank dispatches its d_model slice of every token; the capacity is the
    whole batch's."""
    cj, ct, pj = _moe("mixtral-tiny")
    B, S = 2, 4
    xj, xt = _x(B, S, cj.d_model, seed=11)
    ref = _reference_shards(cj, pj, xj, 1, 2, "experts")
    _record(monkeypatch, cj, pj, xj, 2)
    _check(_run_port(ct, _carry(pj), xt, (2, 2),
                     opts={"serve_fullshard": True}), ref)


def test_moe_ep_refuses_tp_dividing_neither_experts_nor_dff():
    """tp 3 divides neither mixtral-tiny's 4 experts nor its d_ff 128.
    The reference's spec then leaves every expert whole on every 'model'
    shard (its w1 spec has no 'model' entry), so its psum over 'model'
    would return 3x the output; the port raises instead."""
    cj, ct, pj = _moe("mixtral-tiny")
    env = JEnv(None)
    env.axis_sizes = {"data": 1, "model": 3}
    assert not env.moe_ep(cj.n_experts)
    assert "model" not in tuple(env.spec(pj["w1"].shape,
                                         [None, env.fsdp_axis, "model"]))
    xj, xt = _x(2, 2, cj.d_model, seed=1)
    with pytest.raises(ValueError, match="divides neither"):
        _run_port(ct, _carry(pj), xt, (1, 3))
