"""Sharded AdamW (``train.optimizer`` on DTensor params, gradients and
moments laid out by ``lm.param_shardings`` / ``opt_pspecs``) on a (2, 2)
mesh of thread-ranks against the reference's ``adamw_update`` on one
device, fed the same params, gradients and state (micro's carried
params; the gradients and a state three steps in drawn with numpy, the
gradients x 100 where the clip binds): tests/test_torch_train.py's
limits, moments within 2e-5, ``gnorm`` within 2e-5 relative and equal on
every rank, each new bf16 param equal or one bf16 step apart.  A global
norm that sums the local squares of a leaf replicated over 'data' over
that axis too counts it twice: planted, it must break the limit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.configs import get_config as ref_config  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro_torch.configs import get_config, load_all  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import sharding as tsh  # noqa: E402
from repro_torch.models.sharding import distribute  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from torch_mesh import on_mesh  # noqa: E402

load_all()
TOL_F32 = 2e-5


def _case(clipped):
    """The reference's step and the port's inputs, as numpy trees."""
    pj = jlm.init_params(ref_config("micro"), jax.random.PRNGKey(0))
    rng = np.random.RandomState(7)
    scale = 100.0 if clipped else 1e-3

    def draw(p, s, dtype):
        return (rng.randn(*p.shape) * s).astype(np.float32).astype(dtype)

    leaves, treedef = jax.tree_util.tree_flatten(pj)
    g = [draw(p, scale, jnp.bfloat16) for p in leaves]
    mu = [draw(p, 1e-2, np.float32) for p in leaves]
    nu = [np.abs(draw(p, 1e-3, np.float32)) for p in leaves]
    unflat = lambda xs: jax.tree_util.tree_unflatten(treedef, xs)  # noqa
    opt_j = jopt.OptState(unflat([jnp.asarray(a) for a in mu]),
                          unflat([jnp.asarray(a) for a in nu]),
                          jnp.asarray(3, jnp.int32))
    newp_j, newopt_j, gnorm_j = jopt.adamw_update(
        pj, unflat([jnp.asarray(a) for a in g]), opt_j, lr=1e-2)
    to_t = lambda tree: lm.params_from_jax(  # noqa: E731
        jax.tree_util.tree_map(np.asarray, tree), "cpu")
    port = {"params": to_t(pj), "grads": to_t(unflat(g)),
            "mu": to_t(unflat(mu)), "nu": to_t(unflat(nu))}
    ref = {"params": to_t(newp_j), "mu": to_t(newopt_j.mu),
           "nu": to_t(newopt_j.nu), "gnorm": float(gnorm_j)}
    return port, ref


def _sharded_step(port):
    """One ``adamw_update`` on each rank; (every rank's gnorm, rank 0's
    new params and moments gathered whole, whether the moments are laid
    out as ``opt_pspecs``)."""
    cfg = get_config("micro")

    def rank(env):
        sh = lm.param_shardings(cfg, env)
        osh = topt.opt_pspecs(sh)
        params, grads = (distribute(port[k], sh) for k in ("params",
                                                            "grads"))
        opt = topt.OptState(distribute(port["mu"], osh.mu),
                            distribute(port["nu"], osh.nu),
                            torch.tensor(3, dtype=torch.int32))
        zero = topt.init_opt_state(params)
        laid = all(a.placements == b.placements for a, b in zip(
            topt.tree_leaves(zero.mu), topt.tree_leaves(params)))
        _, opt, gnorm = topt.adamw_update(params, grads, opt, lr=1e-2)
        whole = lambda tree: topt.tree_map(  # noqa: E731
            lambda t: tsh.whole(t), tree)
        return (float(gnorm), int(opt.step), laid,
                {"params": whole(params), "mu": whole(opt.mu),
                 "nu": whole(opt.nu)})

    out = on_mesh(2, 2, rank)
    return [o[0] for o in out], out[0][1], all(o[2] for o in out), out[0][3]


def _check(ref, gnorms, step, laid, got):
    assert laid and step == 4
    assert len(set(gnorms)) == 1, gnorms
    assert abs(gnorms[0] - ref["gnorm"]) < TOL_F32 * ref["gnorm"]
    for key in ("mu", "nu"):
        for a, b in zip(topt.tree_leaves(got[key]),
                        topt.tree_leaves(ref[key])):
            top = max(float(b.abs().max()), 1e-30)
            assert float((a - b).abs().max()) < TOL_F32 * top, key
    for a, b in zip(topt.tree_leaves(got["params"]),
                    topt.tree_leaves(ref["params"])):
        steps = (a.view(torch.int16).int() - b.view(torch.int16).int())
        assert int(steps.abs().max()) <= 1


@pytest.mark.parametrize("clipped", [False, True])
def test_sharded_adamw_matches_reference(clipped):
    port, ref = _case(clipped)
    assert (ref["gnorm"] > 1.0) == clipped
    _check(ref, *_sharded_step(port))


def test_gnorm_summed_over_a_replicated_axis_is_caught(monkeypatch):
    """Every leaf's squares summed over both mesh axes: the leaves
    replicated over 'data' (the norms' scales) count twice."""
    port, ref = _case(False)
    monkeypatch.setattr(topt, "split_axes",
                        lambda t: tuple(t.device_mesh.mesh_dim_names))
    gnorms = _sharded_step(port)[0]
    assert abs(gnorms[0] - ref["gnorm"]) >= TOL_F32 * ref["gnorm"]
