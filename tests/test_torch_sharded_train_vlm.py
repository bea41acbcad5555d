"""Training on a mesh, llava-next-tiny (8 patches before the tokens, their
labels -100, and half of row 0's labels masked: the data ranks count
different numbers of valid labels) and seamless-tiny (the encoder, the
decoder's cross-attention over the encoder's rows): the loss and every
gradient leaf on (1, 2) and (2, 2) meshes of thread-ranks under the four
option sets against ``jax.value_and_grad`` of the reference's one-device
``forward_train`` (torch_sharded_train.py says what is held).  With a
vocabulary of 258, which 2 divides and 4 does not, as seamless-m4t's
256,206, the loss splits the vocabulary over 'model' at tp 2 and keeps
it whole at tp 4."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch_sharded_train import check_case, cases  # noqa: E402


@pytest.mark.parametrize("name,mesh,opt",
                         cases(["llava-next-tiny", "seamless-tiny"]))
def test_sharded_training_matches_reference(name, mesh, opt, monkeypatch):
    check_case(name, mesh, opt, monkeypatch)


@pytest.mark.parametrize("mesh", [(1, 2), (1, 4)])
def test_sharded_loss_follows_the_pruned_vocab_split(mesh, monkeypatch):
    check_case("seamless-tiny", mesh, "defaults", monkeypatch, vocab=258)
