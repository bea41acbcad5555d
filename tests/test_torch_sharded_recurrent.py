"""Sharded serving of rwkv6-tiny (4 heads: 2 a rank at tp 2, 1 at tp 4)
against the reference's one-device run: ``forward_logits``, ``prefill``
and four teacher-forced ``decode_step``s on (1, 2), (2, 2) and (1, 4)
meshes of thread-ranks under the dry run's default options, then
``rs_matmul``, ``fsdp=False`` and ``serve_fullshard``; the logits, the
carried ``wkv`` / ``shift_tm`` / ``shift_cm`` states after the prefill
and after the steps, and their placements (torch_sharded_rest.py says
what is held).  Once more with every param in f32, within the f32
tolerance.  A token shift taken on the sequence shard (under ``sp`` the
stream arrives split over 'model') must break the limit."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.models import rwkv as R  # noqa: E402
from torch_sharded_rest import (TOL, cases, check_case, err,  # noqa: E402
                                reference, run, shift_on_shards)
from torch_sharded import OPTS  # noqa: E402

NAME = "rwkv6-tiny"


@pytest.mark.parametrize("name,mesh,opts", cases(NAME))
def test_sharded_rwkv6_matches_reference(name, mesh, opts, monkeypatch):
    check_case(name, mesh, opts, monkeypatch)


def test_sharded_rwkv6_matches_reference_in_f32(monkeypatch):
    check_case(NAME, (2, 2), "defaults", monkeypatch, dtype="float32")


def test_token_shift_on_the_sequence_shard_is_caught(monkeypatch):
    monkeypatch.setattr(R, "_token_shift", shift_on_shards(R._token_shift,
                                                           2))
    ref = reference(NAME)
    out, _ = run(NAME, (1, 2), OPTS["defaults"], monkeypatch)
    assert err(out["full"][0], ref["full"]) > TOL["bfloat16"]
