"""Sharded serving of llama3.2-tiny (3 q heads: heads do not split, so
attention runs on batch rows over data x model) and qwen3-tiny (qk-norm;
on (1, 4) each rank holds one q head of a two-head group) against the
reference's one-device run: ``forward_logits``, ``prefill`` and four
teacher-forced ``decode_step``s on (1, 2), (2, 2) and (for qwen) (1, 4)
meshes of thread-ranks under the dry run's default options, then
``rs_matmul``, ``fsdp=False`` and ``serve_fullshard`` (torch_sharded.py
says what is held)."""
import pytest

pytest.importorskip("torch")

from torch_sharded import cases, check_case  # noqa: E402


@pytest.mark.parametrize("name,mesh,opts",
                         cases(["llama3.2-tiny", "qwen3-tiny"],
                               extra=["qwen3-tiny"]))
def test_sharded_serving_matches_reference(name, mesh, opts, monkeypatch):
    check_case(name, mesh, opts, monkeypatch)
