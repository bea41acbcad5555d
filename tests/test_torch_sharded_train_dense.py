"""Training on a mesh, llama3.2-tiny and qwen3-tiny: the loss and every
gradient leaf of ``lm.forward_train(params, batch, cfg, env)`` on (1, 2)
and (2, 2) meshes of thread-ranks (llama3.2-tiny also on (1, 4)) under
the four option sets, and with ``remat`` on (2, 2), against
``jax.value_and_grad`` of the reference's one-device ``forward_train``
(torch_sharded_train.py says what is held).  llama3.2-tiny's 3 heads
divide no tp: its attention runs batch-parallel over data x model."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch_sharded_train import check_case, cases  # noqa: E402


@pytest.mark.parametrize(
    "name,mesh,opt", cases(["llama3.2-tiny", "qwen3-tiny"])
    + cases(["llama3.2-tiny"], meshes=((1, 4),)))
def test_sharded_training_matches_reference(name, mesh, opt, monkeypatch):
    check_case(name, mesh, opt, monkeypatch)


def test_sharded_training_with_remat_matches_reference(monkeypatch):
    """Every layer under ``torch.utils.checkpoint`` (its collectives run
    again in the recompute): the results without it."""
    check_case("llama3.2-tiny", (2, 2), None, monkeypatch,
               opts={"remat": True})
