"""Soft-capped attention on a mesh: llama3.2-tiny (dense) and
seamless-tiny (audio) with ``attn_logit_softcap`` set, on a (2, 2) mesh
of thread-ranks (each rank caps the scores of its own rows and heads),
against the reference's one-device run (tests/torch_softcap.py: the same
capped configs, scaled attention and carried params):

- ``lm.prefill``'s logits and every cache leaf, gathered whole, within
  2e-2 (bf16) of the largest magnitude where that passes 1, under the
  dry run's default options (sp, fsdp);
- one training step, ``train_loop``'s mesh options (sp, fsdp,
  ``moe_impl="ep"``) with attention and loss blocks of 8: the loss and
  every gradient leaf against ``jax.value_and_grad`` of the reference's
  ``forward_train``, in f32 as tests/test_torch_softcap.py holds them,
  within 1e-3.

Each also shows the cap bites: the mesh's capped output moves from the
one-device uncapped one by at least 10x its tolerance."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models.sharding import distribute  # noqa: E402
from torch_mesh import on_mesh  # noqa: E402
from torch_softcap import (BITE, CAP, TOL, TOL_F32, configs, err,  # noqa: E402
                           f32_frames, grad_errs, port_grads, reference,
                           train_reference)

MESH = (2, 2)
TRAIN_OPTS = {"remat": False, "sp": True, "moe_impl": "ep", "attn_block": 8,
              "loss_chunk": 8, "attn_mode": "full"}
NAMES = ["llama3.2-tiny", "seamless-tiny"]


@pytest.mark.parametrize("name", NAMES)
def test_sharded_capped_prefill_matches_reference(name):
    ref = reference(name)
    _, ct = configs(name)
    _, plain = configs(name, 0.0)

    def rank(env):
        ps = distribute(ref["params"], tlm.param_shardings(ct, env))
        with torch.no_grad():
            last, cache = tlm.prefill(ps, ref["batch"], ct, env,
                                      max_len=ref["max_len"])
            return last.full_tensor(), {k: v.full_tensor()
                                        for k, v in cache.items()}

    last, cache = on_mesh(*MESH, rank, {})[0]
    assert err(last, ref["last"]) < TOL, err(last, ref["last"])
    assert sorted(cache) == sorted(ref["cache"])
    for leaf, c in cache.items():
        assert err(c, ref["cache"][leaf]) < TOL, (leaf,
                                                  err(c, ref["cache"][leaf]))
    with torch.no_grad():
        uncapped, _ = tlm.prefill(ref["params"], ref["batch"], plain,
                                  max_len=ref["max_len"])
    moved = err(uncapped, last)
    assert moved > BITE * TOL, f"{name}: the cap moved the logits {moved}"


@pytest.mark.parametrize("name", NAMES)
def test_sharded_capped_training_step_matches_reference(name, monkeypatch):
    ref = train_reference(name, "full")
    ct = configs(name)[1]
    if ct.enc_dec:
        f32_frames(monkeypatch)

    def rank(env):
        ps = distribute(ref["params"], tlm.param_shardings(ct, env))
        return port_grads(name, ps, ref["batch"], CAP, env=env)

    out = on_mesh(*MESH, rank, TRAIN_OPTS)
    losses = [o[0] for o in out]
    loss, grads = out[0]
    assert len(set(losses)) == 1, losses
    assert abs(loss - ref["loss"]) < TOL_F32 * abs(ref["loss"]), (
        loss, ref["loss"])
    bad = {n: e for n, e in grad_errs(grads, ref["grads"]).items()
           if not e < TOL_F32}
    assert not bad, bad
    _, uncapped = port_grads(name, ref["params"], ref["batch"], 0.0)
    moved = max(grad_errs(uncapped, grads).values())
    assert moved > BITE * TOL_F32, f"{name}: the cap moved a leaf by {moved}"
