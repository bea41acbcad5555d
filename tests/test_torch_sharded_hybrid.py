"""Sharded serving of jamba-tiny (mamba d_inner 128 over 'model',
attention slot of 4 q over 2 kv heads, MoE of 4 experts: EP at tp 2 and
4) against the reference's one-device run: ``forward_logits``,
``prefill`` and four teacher-forced ``decode_step``s on (1, 2), (2, 2)
and (1, 4) meshes of thread-ranks under the four option sets; the logits,
the attention slot's ``k`` / ``v`` and the mamba slots' ``conv`` /
``ssm`` states after the prefill and after the steps, and their
placements (torch_sharded_rest.py says what is held; the MoE picks
replay the reference's, ``SameRouting``).  The f32 run and the planted
fault are in test_torch_sharded_hybrid_checks.py (each file's reference
run takes ~20 s)."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch_sharded_rest import cases, check_case  # noqa: E402

NAME = "jamba-tiny"


@pytest.mark.parametrize("name,mesh,opts", cases(NAME))
def test_sharded_jamba_matches_reference(name, mesh, opts, monkeypatch):
    check_case(name, mesh, opts, monkeypatch)
