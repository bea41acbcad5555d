"""jamba-tiny's sharded serving in f32 (every param cast in both
packages) against the reference's one-device run on a (2, 2) mesh,
within the f32 tolerance; and a causal conv taken on the sequence shard
(under ``sp`` the stream arrives split over 'model': each shard after the
first would miss the d_conv - 1 tokens before it), which must break the
bf16 limit (torch_sharded_rest.py says what is held)."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.models import mamba as M  # noqa: E402
from torch_sharded import OPTS  # noqa: E402
from torch_sharded_rest import (TOL, check_case,  # noqa: E402
                                conv_on_shards, err, reference, run)

NAME = "jamba-tiny"


def test_sharded_jamba_matches_reference_in_f32(monkeypatch):
    check_case(NAME, (2, 2), "defaults", monkeypatch, dtype="float32")


def test_conv_on_the_sequence_shard_is_caught(monkeypatch):
    monkeypatch.setattr(M, "_causal_depthwise_conv",
                        conv_on_shards(M._causal_depthwise_conv, 2))
    ref = reference(NAME)
    out, _ = run(NAME, (1, 2), OPTS["defaults"], monkeypatch)
    assert err(out["full"][0], ref["full"]) > TOL["bfloat16"]
