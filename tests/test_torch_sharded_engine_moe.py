"""The serving engine on a mesh for mixtral-tiny (MoE, window 32 that
session a passes) on (1, 2) and (2, 2) meshes, under the reference
engine's own options (``moe_impl="dense"``: a prefill under "ep" could
drop tokens, which no one-device run does), its router picks and greedy
near-ties held to the reference engine's (run under
``jax.disable_jit()``).  torch_sharded_engine.py says what is held."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch_sharded_engine import check, scripts  # noqa: E402


@pytest.mark.parametrize("mesh", [(1, 2), (2, 2)])
def test_sharded_moe_engine_matches_reference_engine(mesh, monkeypatch):
    ref, res = scripts("mixtral-tiny", mesh, monkeypatch,
                       opts={"moe_impl": "dense"})
    check(ref, res, mesh[1])
