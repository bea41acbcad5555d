"""``launch.train.train_loop(mesh=...)`` in every rank of a mesh of
thread-ranks, and checkpoints that move between meshes, one device and
the reference.

- micro and llama3.2-tiny (registered under their names in both
  packages), 4 steps of 2 x 16 tokens at lr 2e-3 on a (2, 2) mesh, from
  the reference's ``PRNGKey(0)`` params saved by the reference at step 0
  (so the three runs start alike): the losses, equal on every rank,
  within 2e-2 (relative) of the port's one-device ``train_loop`` and of
  the reference's (mesh None); the params at the end within the bf16
  limit of the sharded serving tests (2e-2 of the leaf's largest
  magnitude where that passes 1, torch_sharded.py): AdamW moves an
  element whose gradient is at the rounding's scale by +-lr a step
  whatever that gradient's size, so the losses carry the comparison.
- micro: a checkpoint saved at step 2 from the (2, 2) mesh holds whole
  leaves; the reference's ``restore_checkpoint``, the port's on one
  device and the port's on a (1, 2) mesh (each rank its blocks) read the
  saving run's state exactly; the steps after the restart give the
  uninterrupted run's losses within 1e-3 (relative).
- a ``mesh`` that is not a ``DeviceMesh`` with the axes ("data",
  "model") is refused."""
import shutil
import tempfile

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro import configs as jconfigs  # noqa: E402
from repro.configs import llama3_2_3b  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.configs import llama3_2_3b as t_llama  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import sharding as tsh  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from torch_mesh import on_mesh  # noqa: E402

KW = dict(batch=2, seq=16, lr=2e-3, log_every=100)
TOL, TOL_RESTART = 2e-2, 1e-3
jconfigs.register(llama3_2_3b.tiny())
tconfigs.register(t_llama.tiny())


def _start(arch, d):
    """The reference's init of ``arch`` saved at step 0 in ``d``."""
    pj = jlm.init_params(jconfigs.get_config(arch), jax.random.PRNGKey(0))
    jckpt.save_checkpoint(d, 0, pj, jopt.init_opt_state(pj),
                          data_state={"step": 0, "seed": 0})


def _whole(tree):
    return topt.tree_map(lambda t: tsh.whole(t).detach(), tree)


def _mesh_run(arch, dp, tp, **kw):
    """``train_loop`` on every rank: (every rank's losses, rank 0's params
    and state gathered whole)."""
    def rank(env):
        params, opt, losses = ttrain.train_loop(arch, mesh=env.mesh, **kw)
        return losses, _whole(params), _whole(opt.mu), _whole(opt.nu), \
            int(opt.step)
    out = on_mesh(dp, tp, rank, timeout=300)
    assert all(o[0] == out[0][0] for o in out)
    return out[0]


@pytest.mark.parametrize("arch", ["micro", "llama3.2-tiny"])
def test_train_loop_on_a_mesh_matches_one_device_and_reference(arch):
    d = tempfile.mkdtemp()
    try:
        _start(arch, d)
        kw = dict(KW, steps=4, ckpt_dir=d, resume=True)
        pj, _, ref = jtrain.train_loop(arch, **kw)
        _, _, one = ttrain.train_loop(arch, device="cpu", **kw)
        losses, params = _mesh_run(arch, 2, 2, **kw)[:2]
    finally:
        shutil.rmtree(d)
    for a, b, c in zip(losses, one, ref):
        assert abs(a - b) < TOL * abs(b) and abs(a - c) < TOL * abs(c)
    pt = lm.params_from_jax(jax.tree_util.tree_map(np.asarray, pj), "cpu")
    for a, b in zip(topt.tree_leaves(params), topt.tree_leaves(pt)):
        top = max(1.0, float(b.float().abs().max()))
        assert float((a.float() - b.float()).abs().max()) < TOL * top


def test_checkpoint_moves_between_meshes_one_device_and_reference():
    d = tempfile.mkdtemp()
    try:
        _start("micro", d)
        kw = dict(KW, ckpt_dir=d, resume=True)
        whole = _mesh_run("micro", 2, 2, steps=4, **kw)[0]
        _, params, mu, nu, step = _mesh_run("micro", 2, 2, steps=2,
                                            ckpt_every=2, **kw)
        assert step == 2 and ckpt.latest_step(d) == 2
        saved = (topt.tree_leaves(params) + topt.tree_leaves(mu)
                 + topt.tree_leaves(nu))
        ap = jlm.abstract_params(jconfigs.get_config("micro"))
        _, pj, oj, _ = jckpt.restore_checkpoint(
            d, ap, jopt.abstract_opt_state(ap), step=2)
        ref = [lm.params_from_jax(np.asarray(a), "cpu")
               for a in jax.tree_util.tree_leaves((pj, oj.mu, oj.nu))]
        tp = lm.abstract_params(tconfigs.get_config("micro"))
        _, p1, o1, _ = ckpt.restore_checkpoint(
            d, tp, topt.abstract_opt_state(tp), step=2, device="cpu")
        one = (topt.tree_leaves(p1) + topt.tree_leaves(o1.mu)
               + topt.tree_leaves(o1.nu))
        for a, b, c in zip(saved, ref, one):
            assert torch.equal(a, b) and torch.equal(a, c)
        after = _mesh_run("micro", 1, 2, steps=4, **kw)
        restored = (topt.tree_leaves(_mesh_run("micro", 1, 2, steps=2,
                                               **kw)[1]))
    finally:
        shutil.rmtree(d)
    for a, b in zip(restored, topt.tree_leaves(params)):
        assert torch.equal(a, b)
    assert after[4] == 4 and len(after[0]) == 2
    for a, b in zip(after[0], whole[2:]):
        assert abs(a - b) < TOL_RESTART * abs(b)


def test_train_loop_refuses_a_mesh_without_data_and_model_axes():
    from repro_torch.launch.mesh import make_worker_mesh

    def rank(env):
        with pytest.raises(ValueError, match="DeviceMesh"):
            ttrain.train_loop("micro", steps=1, mesh=object())
        mesh = make_worker_mesh(2, tp=2, device_type="cpu")["model"]
        with pytest.raises(ValueError, match="axes"):
            ttrain.train_loop("micro", steps=1, mesh=mesh)
        return True
    assert all(on_mesh(1, 2, rank))
