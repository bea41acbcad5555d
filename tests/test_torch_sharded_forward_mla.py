"""Sharded serving of deepseek-v2-tiny (MLA's latent cache, its sequence
over 'model'; 8 experts and a shared one) against the reference's
one-device run, on (1, 2) and (2, 2) meshes of thread-ranks under the
four option sets; decode through ``moe_ep``, its picks held to the
reference's (torch_sharded.py says what is held)."""
import pytest

pytest.importorskip("torch")

from torch_sharded import cases, check_case  # noqa: E402


@pytest.mark.parametrize("name,mesh,opts", cases(["deepseek-v2-tiny"]))
def test_sharded_serving_matches_reference(name, mesh, opts, monkeypatch):
    check_case(name, mesh, opts, monkeypatch)
