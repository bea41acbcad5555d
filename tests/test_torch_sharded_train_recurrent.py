"""Training on a mesh, rwkv6-tiny (each rank's heads through
``_wkv6_scan``, the token shifts on the whole sequence): the loss and
every gradient leaf in f32 on (1, 2), (2, 2) and (1, 4) meshes of
thread-ranks under the four option sets against ``jax.value_and_grad``
of the reference's one-device ``forward_train`` (torch_sharded_train.py
says what is held)."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch_sharded_train import check_case, cases  # noqa: E402


@pytest.mark.parametrize("name,mesh,opt", cases(
    ["rwkv6-tiny"], meshes=((1, 2), (2, 2), (1, 4))))
def test_sharded_training_matches_reference(name, mesh, opt, monkeypatch):
    check_case(name, mesh, opt, monkeypatch)
