"""Training on a mesh, jamba-tiny (each rank's ``d_inner / tp`` channels
through ``_ssm_scan_train``, the conv on the whole sequence, the
attention slot and the MoE slots through ``moe_ep``): the loss and every
gradient leaf in f32 on (1, 2), (2, 2) and (1, 4) meshes of thread-ranks
under the four option sets, and with ``remat`` on (2, 2), against
``jax.value_and_grad`` of the reference's one-device ``forward_train``
(torch_sharded_train.py says what is held)."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch_sharded_train import check_case, cases  # noqa: E402


@pytest.mark.parametrize("name,mesh,opt", cases(
    ["jamba-tiny"], meshes=((1, 2), (2, 2), (1, 4))))
def test_sharded_training_matches_reference(name, mesh, opt, monkeypatch):
    check_case(name, mesh, opt, monkeypatch)


def test_sharded_training_with_remat_matches_reference(monkeypatch):
    check_case("jamba-tiny", (2, 2), None, monkeypatch, opts={"remat": True})
