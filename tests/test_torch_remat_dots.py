"""``remat_policy="dots"`` in the port's training path
(``lm._maybe_remat``: ``torch.utils.checkpoint`` with a selective context
that keeps the matmuls' outputs, the twin of the reference's
``jax.checkpoint_policies.checkpoint_dots``):

- one device, tiny: the loss and every gradient leaf against
  ``jax.value_and_grad`` of the reference's ``forward_train`` under
  ``{"remat": True, "remat_policy": "dots"}`` on the same carried params
  and batch, llama3.2 within 2e-2 (relative loss; each leaf's largest
  magnitude), rwkv6 with every param in f32 within 1e-3
  (tests/test_torch_forward_train.py's limits and reasons);
- on a (2, 2) mesh of thread-ranks: the loss and every gradient leaf
  under "dots" against whole-layer remat on the same mesh, and both
  against the reference (``torch_sharded_train``'s limits);
- ``attn_mode="tri"`` (the key blocks a query block cannot see skipped)
  against the reference's value and grad under "tri", one device, tiny,
  three families;
- None and "full" are whole-layer remat; the backward's aten FLOPs under
  "dots" are those of no remat (every matmul kept) and fewer than
  whole-layer remat's."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import lm as jlm  # noqa: E402
from repro.models.sharding import ShardingEnv as JEnv  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from torch_routing import SameRouting  # noqa: E402
from torch_sharded_train import BASE, errors, run  # noqa: E402

TOL, TOL_F32 = 2e-2, 1e-3
DOTS = {"remat": True, "remat_policy": "dots", "attn_block": 8,
        "loss_chunk": 8}


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield "/".join(prefix), tree


def _batch(cfg, B=2, S=16):
    rng = np.random.RandomState(0)
    toks = rng.randint(0, cfg.vocab, size=(B, S))
    labels = rng.randint(0, cfg.vocab, size=(B, S))
    return ({"tokens": toks.astype(np.int32),
             "labels": labels.astype(np.int32)},
            {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels)})


def port_loss_grads(params, batch, cfg, opts):
    """The port's loss and {leaf: gradient} (numpy f32) on one device."""
    leaves = [t.detach().clone().requires_grad_(True)
              for _, t in _leaves(params)]
    tree = {}
    for (name, _), t in zip(_leaves(params), leaves):
        node = tree
        *path, last = name.split("/")
        for k in path:
            node = node.setdefault(k, {})
        node[last] = t
    loss = tlm.forward_train(tree, batch, cfg, opts=opts)
    loss.backward()
    return float(loss.detach()), {
        n: t.grad.float().numpy() for (n, _), t in zip(_leaves(params),
                                                       leaves)}


def check_against_reference(mod, opts, monkeypatch, *, S=16, f32=False):
    """The port's loss and every gradient leaf on one device under
    ``opts`` against ``jax.value_and_grad`` of the reference's
    ``forward_train`` under the same options, from the same carried params
    and batch (the MoE archs held to the reference's picks): within 2e-2,
    or 1e-3 with every param in f32."""
    cj = importlib.import_module(f"repro.configs.{mod}").tiny()
    ct = importlib.import_module(f"repro_torch.configs.{mod}").tiny()
    pj = jlm.init_params(cj, jax.random.PRNGKey(0))
    if f32:
        pj = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), pj)
    bj, bt = _batch(cj, S=S)
    if cj.n_experts:
        SameRouting(monkeypatch, traced=True)
    env = JEnv(None, {"sp": False, "moe_impl": "dense", **opts})
    loss_j, grads_j = jax.jit(jax.value_and_grad(
        lambda p: jlm.forward_train(p, bj, cj, env)))(pj)
    jax.effects_barrier()
    grads_j = dict(_leaves(jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), grads_j)))
    params = tlm.params_from_jax(jax.tree_util.tree_map(np.asarray, pj),
                                 "cpu")
    loss_t, grads_t = port_loss_grads(params, bt, ct, opts)
    tol = TOL_F32 if f32 else TOL
    assert abs(loss_t - float(loss_j)) / abs(float(loss_j)) < tol
    assert sorted(grads_t) == sorted(grads_j)
    bad = {n: err for n, gj in grads_j.items()
           if not (err := float(np.abs(grads_t[n] - gj).max())
                   / max(float(np.abs(gj).max()), 1e-30)) < tol}
    assert not bad, bad


@pytest.mark.parametrize("mod,f32", [("llama3_2_3b", False),
                                     ("rwkv6_7b", True)])
def test_dots_matches_the_reference_value_and_grad(mod, f32, monkeypatch):
    check_against_reference(mod, DOTS, monkeypatch, f32=f32)


TRI = {"remat": True, "attn_mode": "tri", "attn_block": 8, "loss_chunk": 8}


@pytest.mark.parametrize("mod,S", [("llama3_2_3b", 32), ("mixtral_8x22b", 48),
                                   ("deepseek_v2_236b", 32)])
def test_tri_matches_the_reference_value_and_grad(mod, S, monkeypatch):
    """``attn_mode="tri"`` (``layers._attn_q_block`` skips the key blocks
    a query block cannot see) against the reference under the same
    option, in blocks of 8: llama3.2's causal triangle, mixtral's 32-wide
    window over 48 positions (the band), deepseek-v2's MLA.  Another mode
    is refused."""
    check_against_reference(mod, TRI, monkeypatch, S=S)
    with pytest.raises(ValueError, match="attn_mode"):
        tlm.train_opts({"attn_mode": "band"})


@pytest.mark.parametrize("name", ["llama3.2-tiny", "mixtral-tiny"])
def test_dots_on_a_mesh_matches_whole_layer_remat(name):
    """On a (2, 2) mesh (the collectives of the tensor-parallel layers,
    and mixtral's expert parallelism, recomputed under the selective
    context): "dots" gives whole-layer remat's loss and gradients, and
    both the reference's."""
    got = {}
    for pol in ("full", "dots"):
        with pytest.MonkeyPatch.context() as mp:
            got[pol] = run(name, (2, 2),
                           {"remat": True, "remat_policy": pol}, mp)
    losses = {pol: g[0] for pol, g in got.items()}
    assert len(set(losses["dots"])) == 1 and losses["dots"] == \
        pytest.approx(losses["full"], rel=TOL)
    for n, g in got["full"][1].items():
        top = max(float(np.abs(g).max()), 1e-30)
        assert float(np.abs(got["dots"][1][n] - g).max()) / top < TOL, n
    for pol, g in got.items():
        assert g[2] and g[3] == 0, pol
        loss_err, leaf = errors(name, g)
        assert loss_err < TOL and max(leaf.values()) < TOL, (pol, leaf)


def test_none_and_full_are_whole_layer_remat_and_others_raise():
    assert tlm.REMAT_POLICIES == (None, "full", "dots")
    for pol in (None, "full", "dots"):
        assert tlm.train_opts({"remat": True,
                               "remat_policy": pol})["remat_policy"] == pol
    with pytest.raises(ValueError, match="remat_policy"):
        tlm.train_opts({"remat": True, "remat_policy": "nothing"})
    assert BASE["remat"] is False


def test_dots_keeps_every_matmul_of_the_backward():
    """One device, tiny llama3.2: the backward's aten FLOPs (FlopCounter-
    Mode's formulas, ``launch.dryrun.Traffic``: the ops run inside an
    autograd node, all those after the forward) under "dots" equal those
    of no remat and fall below whole-layer remat's; None and "full" count
    alike; the losses and gradients are the same in all four."""
    ct = importlib.import_module("repro_torch.configs.llama3_2_3b").tiny()
    params = tlm.init_params(ct, 0, device="cpu")
    _, batch = _batch(ct)
    back, out = {}, {}
    for key, opts in (("none", {"remat": False}),
                      ("None", {"remat": True, "remat_policy": None}),
                      ("full", {"remat": True, "remat_policy": "full"}),
                      ("dots", {"remat": True, "remat_policy": "dots"})):
        opts = dict(opts, attn_block=8, loss_chunk=8)
        leaves = [t.requires_grad_(True) for _, t in _leaves(params)]
        with D.Traffic() as c:
            loss = tlm.forward_train(params, batch, ct, opts=opts)
            fwd = c.flops
            loss.backward()
        back[key] = c.backward_flops
        assert c.flops - fwd == c.backward_flops > 0
        out[key] = (float(loss.detach()),
                    [t.grad.clone() for t in leaves])
        for t in leaves:
            t.grad = None
    assert back["dots"] == back["none"] < back["full"] == back["None"]
    for key in ("None", "full", "dots"):
        assert out[key][0] == out["none"][0]
        for a, b in zip(out[key][1], out["none"][1]):
            assert torch.equal(a, b), key
