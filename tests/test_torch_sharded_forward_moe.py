"""Sharded serving of mixtral-tiny (4 experts, top 2, a window of 32; EP
over 'model' of 2 and 4) against the reference's one-device run, on
(1, 2), (2, 2) and (1, 4) meshes of thread-ranks under the four option
sets; decode through ``moe_ep``, its picks held to the reference's
(torch_sharded.py says what is held)."""
import pytest

pytest.importorskip("torch")

from torch_sharded import cases, check_case  # noqa: E402


@pytest.mark.parametrize("name,mesh,opts",
                         cases(["mixtral-tiny"], extra=["mixtral-tiny"]))
def test_sharded_serving_matches_reference(name, mesh, opts, monkeypatch):
    check_case(name, mesh, opts, monkeypatch)
