"""The port's training substrate (``repro_torch.train``,
``repro_torch.launch.train``): the twins of tests/test_train.py's four
tests, and the port held to the reference on the same inputs.

- ``adamw_update`` against the reference's on the same params, grads and
  state, clipped and not: moments within 2e-5 (f32), ``gnorm`` within
  2e-5 relative, each new bf16 param equal or one bf16 step apart (the
  update is f32, rounded once to bf16);
- five ``make_train_step`` steps on micro from the same carried init and
  the same ``SyntheticLM`` batches: losses within 2e-2 relative (bf16);
- checkpoints: the reference writes and the port restores, bit-exact,
  and the other way round."""
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)           # tiny shapes: threads only add overhead

from repro.configs import get_config as ref_config  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models.sharding import ShardingEnv  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro_torch.configs import get_config, load_all  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train.data import SyntheticLM  # noqa: E402

load_all()
TOL_F32 = 2e-5
TOL_LOSS = 2e-2


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _carried_micro():
    """micro's reference params (PRNGKey(0)) and the port's copy."""
    pj = jlm.init_params(ref_config("micro"), jax.random.PRNGKey(0))
    return pj, lm.params_from_jax(_np(pj), "cpu")


def _pairs(ref_tree, port_tree):
    """(key path, reference leaf as numpy, port leaf) over the reference's
    leaves; the port's tree is walked by the same keys."""
    for path, leaf in jax.tree_util.tree_flatten_with_path(ref_tree)[0]:
        t = port_tree
        for p in path:
            t = getattr(t, p.name) if hasattr(p, "name") else t[p.key]
        yield jax.tree_util.keystr(path), np.asarray(leaf), t


def _bits(t):
    """A tensor's bit pattern as numpy (bf16 as int16), for bit-exact
    comparison."""
    t = t.detach().cpu()
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 \
        else t.numpy()


# --- twins of tests/test_train.py -------------------------------------------
def test_adamw_moves_params_and_clips():
    cfg = get_config("micro")
    params = lm.init_params(cfg, 0, device="cpu")
    before = topt.tree_map(torch.clone, params)
    opt = topt.init_opt_state(params)
    grads = topt.tree_map(lambda p: torch.full(p.shape, 100.0), params)
    newp, newopt, gnorm = topt.adamw_update(params, grads, opt, lr=1e-2,
                                            grad_clip=1.0)
    assert float(gnorm) > 1.0                  # clipping engaged
    assert int(newopt.step) == 1
    moved = sum(float((a.float() - b.float()).abs().sum())
                for a, b in zip(topt.tree_leaves(newp),
                                topt.tree_leaves(before)))
    assert moved > 0


def test_loss_decreases_on_structured_data():
    _, _, losses = ttrain.train_loop("micro", steps=20, batch=4, seq=32,
                                     lr=2e-3, log_every=100, device="cpu")
    assert losses[-1] < losses[0]


def test_checkpoint_roundtrip_exact():
    cfg = get_config("micro")
    params = lm.init_params(cfg, 0, device="cpu")
    opt = topt.init_opt_state(params)
    with tempfile.TemporaryDirectory() as d:
        ckpt.save_checkpoint(d, 3, params, opt,
                             data_state={"step": 3, "seed": 0})
        ap = lm.abstract_params(cfg)
        step, p2, o2, meta = ckpt.restore_checkpoint(
            d, ap, topt.abstract_opt_state(ap), device="cpu")
        assert step == 3
        assert meta["data_state"]["step"] == 3
        for a, b in zip(topt.tree_leaves(params), topt.tree_leaves(p2)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(_bits(a), _bits(b))
        assert int(o2.step) == 0


def test_data_pipeline_deterministic_resume():
    cfg = get_config("micro")
    d1 = SyntheticLM(cfg, batch=2, seq=16, seed=5)
    [d1.next() for _ in range(4)]
    snap = d1.snapshot()
    nxt = d1.next()
    d2 = SyntheticLM(cfg, batch=2, seq=16, seed=5)
    d2.restore(snap)
    nxt2 = d2.next()
    np.testing.assert_array_equal(nxt["tokens"], nxt2["tokens"])


# --- the port held to the reference -----------------------------------------
def test_abstract_params_allocate_nothing_and_match_the_reference():
    cfg = get_config("jamba-v0.1-52b")
    ap = lm.abstract_params(cfg)
    ref = jlm.abstract_params(ref_config("jamba-v0.1-52b"))
    flat = jax.tree_util.tree_flatten_with_path(ref)[0]
    assert len(flat) == len(topt.tree_leaves(ap))
    for path, r in flat:
        t = ap
        for k in path:
            t = t[k.key]
        name = jax.tree_util.keystr(path)
        assert t.device.type == "meta", name
        assert tuple(t.shape) == tuple(r.shape), name
        assert str(t.dtype).split(".")[-1] == str(r.dtype), name


@pytest.mark.parametrize("clipped", [False, True])
def test_adamw_update_matches_jax(clipped):
    """micro's params, grads drawn with numpy (x 100 where clipped, so
    gnorm passes 1), and a state three steps in: both packages' step, the
    reference's run op by op as written (under ``jax.jit`` XLA fuses the
    update and rounds some new params two bf16 steps away)."""
    pj, pt = _carried_micro()
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

    to_t = lambda xs: lm.params_from_jax(_np(unflat(xs)), "cpu")  # noqa
    opt_t = topt.OptState(to_t(mu), to_t(nu),
                          torch.tensor(3, dtype=torch.int32))
    newp_t, newopt_t, gnorm_t = topt.adamw_update(
        pt, to_t([np.asarray(a) for a in g]), opt_t, lr=1e-2)

    assert (float(gnorm_j) > 1.0) == clipped
    assert abs(float(gnorm_t) - float(gnorm_j)) < TOL_F32 * float(gnorm_j)
    assert int(newopt_t.step) == int(newopt_j.step) == 4
    for name, a, t in [*_pairs(newopt_j.mu, newopt_t.mu),
                       *_pairs(newopt_j.nu, newopt_t.nu)]:
        top = max(float(np.abs(a).max()), 1e-30)
        assert float(np.abs(t.numpy() - a).max()) < TOL_F32 * top, name
    moved = 0
    for (name, a, t), (_, old, _) in zip(_pairs(newp_j, newp_t),
                                         _pairs(pj, newp_t)):
        ia = a.view(np.int16).astype(np.int32)
        it = t.view(torch.int16).numpy().astype(np.int32)
        assert np.abs(ia - it).max() <= 1, name      # one bf16 step
        moved += int((ia != old.view(np.int16)).sum())
    assert moved > 0


def test_five_train_steps_match_jax():
    """micro, batch 4 x 32, lr 2e-3, the same carried init and the same
    SyntheticLM batches: the reference's jitted step against
    ``make_train_step``."""
    cfg_j, cfg_t = ref_config("micro"), get_config("micro")
    pj, pt = _carried_micro()
    for p in topt.tree_leaves(pt):
        p.requires_grad_(True)
    env = ShardingEnv(None, {"remat": False, "sp": False,
                             "moe_impl": "dense"})
    step_j = jax.jit(jtrain.make_train_step(cfg_j, env, 2e-3))
    step_t = ttrain.make_train_step(cfg_t, 2e-3)
    opt_j, opt_t = jopt.init_opt_state(pj), topt.init_opt_state(pt)
    data = SyntheticLM(cfg_t, 4, 32, seed=0)
    for _ in range(5):
        b = data.next()
        loss_j, _, pj, opt_j = step_j(pj, opt_j,
                                      {k: jnp.asarray(v) for k, v in
                                       b.items()})
        loss_t, _ = step_t(pt, opt_t, {k: torch.from_numpy(v)
                                       for k, v in b.items()})
        assert abs(float(loss_t) - float(loss_j)) \
            < TOL_LOSS * abs(float(loss_j))
        assert all(p.grad is None for p in topt.tree_leaves(pt))
    assert int(opt_t.step) == 5


def _ref_state():
    """micro's reference params and an AdamW state one step in (nonzero
    moments), as the reference's train step leaves them."""
    cfg = ref_config("micro")
    pj = jlm.init_params(cfg, jax.random.PRNGKey(0))
    env = ShardingEnv(None, {"remat": False, "sp": False,
                             "moe_impl": "dense"})
    step = jax.jit(jtrain.make_train_step(cfg, env, 2e-3))
    b = SyntheticLM(get_config("micro"), 2, 16, seed=1).next()
    _, _, pj, oj = step(pj, jopt.init_opt_state(pj),
                        {k: jnp.asarray(v) for k, v in b.items()})
    return pj, oj


def test_reference_checkpoint_restores_in_the_port_bit_exact():
    pj, oj = _ref_state()
    with tempfile.TemporaryDirectory() as d:
        jckpt.save_checkpoint(d, 1, pj, oj, data_state={"step": 1,
                                                        "seed": 0})
        ap = lm.abstract_params(get_config("micro"))
        step, pt, ot, meta = ckpt.restore_checkpoint(
            d, ap, topt.abstract_opt_state(ap), device="cpu")
    assert step == 1 and meta["data_state"] == {"step": 1, "seed": 0}
    pairs = [*_pairs(pj, pt), *_pairs(oj, ot)]
    assert len(pairs) == 37
    for name, a, t in pairs:
        assert str(t.dtype).split(".")[-1] == str(a.dtype), name
        np.testing.assert_array_equal(
            _bits(t), a.view(np.int16) if a.dtype == jnp.bfloat16 else a,
            err_msg=name)


def test_port_checkpoint_restores_in_the_reference_bit_exact():
    pj, oj = _ref_state()
    pt = lm.params_from_jax(_np(pj), "cpu")
    ot = topt.OptState(lm.params_from_jax(_np(oj.mu), "cpu"),
                       lm.params_from_jax(_np(oj.nu), "cpu"),
                       torch.tensor(int(oj.step), dtype=torch.int32))
    with tempfile.TemporaryDirectory() as d:
        ckpt.save_checkpoint(d, 1, pt, ot, data_state={"step": 1,
                                                       "seed": 0})
        files = sorted(np.load(f"{d}/step_00000001.npz").files)
        jd = tempfile.mkdtemp(dir=d)
        jckpt.save_checkpoint(jd, 1, pj, oj, data_state={"step": 1,
                                                         "seed": 0})
        assert files == sorted(np.load(f"{jd}/step_00000001.npz").files)
        for name in ("step_00000001.json", "LATEST"):
            assert open(f"{d}/{name}").read() == open(f"{jd}/{name}").read()
        ap = jlm.abstract_params(ref_config("micro"))
        step, p2, o2, _ = jckpt.restore_checkpoint(
            d, ap, jopt.abstract_opt_state(ap))
    assert step == 1
    for a, b in zip(jax.tree_util.tree_leaves((pj, oj)),
                    jax.tree_util.tree_leaves((p2, o2))):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.atleast_1d(a).view(np.uint8),
                                      np.atleast_1d(b).view(np.uint8))


def test_restore_reads_a_compressed_checkpoint():
    """A stored member (``np.savez``, ``save_checkpoint``) is read from its
    offset in the file; a compressed one (``np.savez_compressed``) through
    ``zipfile``: both restore the same state."""
    cfg = get_config("micro")
    params = lm.init_params(cfg, 0, device="cpu")
    opt = topt.init_opt_state(params)
    ap = lm.abstract_params(cfg)
    with tempfile.TemporaryDirectory() as d:
        ckpt.save_checkpoint(d, 2, params, opt)
        path = f"{d}/step_00000002.npz"
        with np.load(path) as z:
            arrays = {k: z[k] for k in z.files}
        np.savez_compressed(path, **arrays)
        _, p2, o2, _ = ckpt.restore_checkpoint(
            d, ap, topt.abstract_opt_state(ap), device="cpu")
    for a, b in zip(topt.tree_leaves(params) + topt.tree_leaves(opt.mu),
                    topt.tree_leaves(p2) + topt.tree_leaves(o2.mu)):
        np.testing.assert_array_equal(_bits(a), _bits(b))


def test_forward_train_refuses_options_it_does_not_port():
    """A remat policy other than None, "full" and "dots" (the ones the
    reference's dry run names) is refused, and so is a key its one-device
    training path does not read."""
    cfg = get_config("micro")
    params = lm.init_params(cfg, 0, device="cpu")
    toks = torch.zeros(1, 8, dtype=torch.long)
    batch = {"tokens": toks, "labels": toks}
    with pytest.raises(ValueError, match="remat_policy"):
        lm.forward_train(params, batch, cfg,
                         opts={"remat": True, "remat_policy": "offload"})
    with pytest.raises(ValueError, match="options"):
        lm.forward_train(params, batch, cfg, opts={"unroll_layers": True})


def test_train_loop_refuses_a_mesh():
    """A mesh must be a ``DeviceMesh`` with the axes ("data", "model")
    (training on one: tests/test_torch_sharded_train_loop.py)."""
    with pytest.raises(ValueError, match='DeviceMesh with the axes'):
        ttrain.train_loop("micro", steps=1, mesh=object(), device="cpu")


def test_train_loop_resumes_at_the_checkpointed_batch():
    """micro: 4 steps with a checkpoint at 2, then a fresh loop resumed
    from it runs steps 2-3 on the same batches to the same losses (the
    CPU sums in one order: equal)."""
    kw = dict(batch=2, seq=16, lr=2e-3, log_every=100, device="cpu")
    _, _, whole = ttrain.train_loop("micro", steps=4, **kw)
    with tempfile.TemporaryDirectory() as d:
        ttrain.train_loop("micro", steps=2, ckpt_dir=d, ckpt_every=2, **kw)
        _, opt, resumed = ttrain.train_loop("micro", steps=4, ckpt_dir=d,
                                            resume=True, **kw)
    assert resumed == whole[2:]
    assert int(opt.step) == 4
