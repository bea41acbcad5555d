"""Training on a mesh, mistral-nemo-tiny and command-r-tiny: the loss and
every gradient leaf on (1, 2) and (2, 2) meshes of thread-ranks under the
four option sets against ``jax.value_and_grad`` of the reference's
one-device ``forward_train`` (torch_sharded_train.py says what is
held)."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch_sharded_train import check_case, cases  # noqa: E402


@pytest.mark.parametrize("name,mesh,opt",
                         cases(["mistral-nemo-tiny", "command-r-tiny"]))
def test_sharded_training_matches_reference(name, mesh, opt, monkeypatch):
    check_case(name, mesh, opt, monkeypatch)
