"""The backward of the port's expert-parallel MoE (``layers.moe_ep``, the
index operations of its dispatch and combine, the psum over 'model' and
the FSDP gathers of the expert weights) on a (2, 2) mesh of
thread-ranks, against ``jax.grad`` of the reference's functions on the
same carried params (mixtral-tiny's layer 0) and bf16 tokens: the
gradient of sum(y * R), R a fixed f32 draw, with respect to the tokens
and every MoE weight, each within 2e-2 of its largest magnitude
(tests/test_kernels.py's bf16 tolerance).

- No pair dropped (each expert given room for all of a rank's tokens):
  against ``moe_dense_ref``.
- A router skewed toward expert 0 overflows its capacity: against the sum
  over data and model shards of the reference's ``_moe_local`` on each
  data shard's tokens (its capacity, its drops); a dropped pair gets no
  gradient, and the gradient reaches the router through the kept pairs'
  gates.

The port replays the reference's router picks
(``torch_routing.SameRouting``, each rank its data shard's rows)."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.configs import mixtral_8x22b  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.configs import mixtral_8x22b as tmixtral  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import sharding as tsh  # noqa: E402
from repro_torch.models.sharding import distribute  # noqa: E402
from torch_mesh import data_rows, on_mesh, replicated  # noqa: E402
from torch_routing import SameRouting  # noqa: E402

TOL = 2e-2
DP, TP, B, S = 2, 2, 4, 4
NAMES = ("x", "router", "w1", "w3", "w2")


def _setup(skew):
    cj, ct = mixtral_8x22b.tiny(), tmixtral.tiny()
    pj = jax.tree_util.tree_map(
        lambda a: np.asarray(a[0]),
        jlm.init_params(cj, jax.random.PRNGKey(0))["layers"]["mlp"])
    rng = np.random.RandomState(3)
    x = rng.randn(B, S, cj.d_model).astype(np.float32)
    if skew:
        u = np.random.RandomState(7).randn(cj.d_model).astype(np.float32)
        u /= np.linalg.norm(u)
        router = np.asarray(pj["router"], np.float32)
        router[:, 0] += 0.3 * u
        pj = dict(pj, router=np.asarray(jnp.asarray(router, jnp.bfloat16)))
        x = x + 2.0 * u
    xj = jnp.asarray(x, jnp.bfloat16)
    r = rng.randn(B, S, cj.d_model).astype(np.float32)
    return cj, ct, pj, xj, r


def _capacity(cfg, factor):
    return max(4, int(math.ceil(B // DP * S * cfg.top_k / cfg.n_experts
                                * factor)))


def _drops(ids, cap, E):
    return sum(max(0, int((part == e).sum()) - cap)
               for part in np.split(ids, DP) for e in range(E))


def _ref_grads(cj, pj, xj, r, factor, dense):
    """jax.grad of sum(y * r) over (x, router, w1, w3, w2)."""
    E, el = cj.n_experts, cj.n_experts // TP
    cap = _capacity(cj, factor)

    def y_of(x, p):
        if dense:
            return jl.moe_dense_ref(x.reshape(-1, cj.d_model), p, cj
                                    ).reshape(B, S, -1)
        rows = []
        for xs in jnp.split(x.reshape(-1, cj.d_model), DP):
            tot = 0.0
            for m in range(TP):
                w = {n: p[n][m * el:(m + 1) * el] for n in ("w1", "w3", "w2")}
                tot = tot + jl._moe_local(
                    xs, p["router"], w["w1"], w["w3"], w["w2"], n_experts=E,
                    top_k=cj.top_k, e_start=m * el, e_local=el,
                    capacity=cap).astype(jnp.float32)
            rows.append(tot)
        return jnp.concatenate(rows).reshape(B, S, -1)

    def f(x, p):
        return jnp.sum(y_of(x, p).astype(jnp.float32) * r)

    gx, gp = jax.grad(f, argnums=(0, 1))(xj, {k: jnp.asarray(v)
                                               for k, v in pj.items()})
    return {"x": np.asarray(gx, np.float32),
            **{k: np.asarray(gp[k], np.float32) for k in NAMES[1:]}}


def _port_grads(ct, pj, xj, r, factor):
    """The port's gradients of sum(y * r) on each rank of the (2, 2)
    mesh, gathered whole (rank 0's)."""
    pt = tlm.params_from_jax({k: np.array(v) for k, v in pj.items()}, "cpu")
    xt = torch.from_numpy(np.array(xj).view(np.int16)).view(torch.bfloat16)
    rt = torch.from_numpy(r)

    def rank(env):
        rules = tlm.param_rules(ct, env)
        p = {k: distribute(v, env.named(v.shape, rules(
            f"layers/mlp/{k}", (1, *v.shape))[1:])) for k, v in pt.items()}
        x = replicated(xt, env)
        for t in (x, *p.values()):
            t.requires_grad_(True)
        leaves = tsh.copies({"x": x, **p})
        y = tl.moe_ep(leaves["x"], {k: leaves[k] for k in p}, ct, env,
                      capacity_factor=factor)
        part = (y.to_local().float()
                * tl.shard_of(rt, env, tl.sharding_spec(y, env))).sum()
        loss = tsh.rank_share(tsh.psum(part, env, "data"), env)
        loss.backward()
        with torch.no_grad():
            return {n: tsh.whole(t.grad).float().numpy()
                    for n, t in (("x", x), *p.items())}

    return on_mesh(DP, TP, rank)[0]


def _check(got, ref):
    for n in NAMES:
        top = max(float(np.abs(ref[n]).max()), 1e-30)
        err = float(np.abs(got[n] - ref[n]).max()) / top
        assert err < TOL, (n, err)


@pytest.mark.parametrize("skew", [False, True], ids=["no_drops", "drops"])
def test_moe_ep_backward_matches_reference(skew, monkeypatch):
    cj, ct, pj, xj, r = _setup(skew)
    factor = cj.n_experts / cj.top_k if not skew else 1.25
    ref = _ref_grads(cj, pj, xj, r, factor, dense=not skew)
    SameRouting(monkeypatch, rows=data_rows(TP))
    _, ids = jl.moe_router(xj.reshape(-1, cj.d_model), pj["router"],
                           cj.top_k)           # recorded, then replayed
    drops = _drops(np.asarray(ids), _capacity(cj, factor), cj.n_experts)
    assert (drops > 0) == skew
    _check(_port_grads(ct, pj, xj, r, factor), ref)
