"""Training on a mesh, mixtral-tiny (``moe_ep``'s expert parallelism) and
deepseek-v2-tiny (MLA, EP and a shared expert): the loss and every
gradient leaf on (1, 2) and (2, 2) meshes of thread-ranks under the four
option sets, and deepseek-v2-tiny with ``remat`` on (2, 2), against
``jax.value_and_grad`` of the reference's one-device ``forward_train``;
and with every param in f32 in both packages on (2, 2), within 1e-3
(torch_sharded_train.py says what is held)."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch_sharded_train import (TOL_F32, check_case, cases,  # noqa: E402
                                 errors, run)

NAMES = ["mixtral-tiny", "deepseek-v2-tiny"]


@pytest.mark.parametrize("name,mesh,opt", cases(NAMES))
def test_sharded_training_matches_reference(name, mesh, opt, monkeypatch):
    check_case(name, mesh, opt, monkeypatch)


def test_sharded_training_with_remat_matches_reference(monkeypatch):
    """Every layer recomputed in the backward (its router too, replaying
    the rank's own picks): the results without it."""
    check_case("deepseek-v2-tiny", (2, 2), None, monkeypatch,
               opts={"remat": True})


@pytest.mark.parametrize("name", NAMES)
def test_sharded_f32_gradients_match_reference(name, monkeypatch):
    """f32 params: the loss and every gradient leaf within 1e-3, the EP
    dispatch, combine and their transposes without bf16's rounding."""
    got = run(name, (2, 2), {}, monkeypatch, f32=True)
    losses, _, laid, drops = got
    assert len(set(losses)) == 1 and laid and drops == 0
    loss_err, leaf = errors(name, got, f32=True)
    assert loss_err < TOL_F32, loss_err
    bad = {n: e for n, e in leaf.items() if not e < TOL_F32}
    assert not bad, bad
