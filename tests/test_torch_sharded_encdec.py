"""Sharded serving of seamless-tiny (encoder-decoder, 4 q heads over 4
kv heads, 16 frames) against the reference's one-device run:
``forward_logits``, ``prefill`` and four teacher-forced ``decode_step``s
on (1, 2), (2, 2) and (1, 4) meshes of thread-ranks under the four option
sets; the logits, the self and cross caches after the prefill and after
the steps (the cross caches' sequence over 'model'), and their
placements (torch_sharded_rest.py says what is held).  The pruned
vocabulary and the cross-attention decode alone are in
test_torch_sharded_encdec_checks.py."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch_sharded_rest import cases, check_case  # noqa: E402


@pytest.mark.parametrize("name,mesh,opts", cases("seamless-tiny"))
def test_sharded_seamless_matches_reference(name, mesh, opts, monkeypatch):
    check_case(name, mesh, opts, monkeypatch)
