"""Sharded serving of mistral-nemo-tiny and command-r-tiny (4 q heads
over 2 KV heads: on 'model' of 2 each rank holds one whole group) against
the reference's one-device run, on (1, 2) and (2, 2) meshes of
thread-ranks under the four option sets (torch_sharded.py says what is
held)."""
import pytest

pytest.importorskip("torch")

from torch_sharded import cases, check_case  # noqa: E402


@pytest.mark.parametrize("name,mesh,opts",
                         cases(["mistral-nemo-tiny", "command-r-tiny"]))
def test_sharded_serving_matches_reference(name, mesh, opts, monkeypatch):
    check_case(name, mesh, opts, monkeypatch)
