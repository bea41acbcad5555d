"""The serving engine on a mesh (``Engine(env=mesh)``) against the
reference's one-device engine, for micro (2 kv heads: the pool's kv
heads split over 'model' at tp 2), llama3.2-tiny (3 q heads over 1 kv
head: the q rows split over data x model, the pool replicated) and
llava-tiny (text only), on (1, 2) and (2, 2) meshes of thread-ranks:
admit, decode rounds, park, a resume with a delta prefill into a slot on
the other data rank, release, and export / import between two engines on
one mesh (torch_sharded_engine.py says what is held: ids and host state
equal, pool replicas byte-equal).  A data rank that appends its own rows
only (skipping the gather of the new K/V over 'data') must leave its
replica unlike the others'.  The gather mode and mixtral are in
test_torch_sharded_engine_moe.py."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.models import layers as tl  # noqa: E402
from torch_sharded_engine import check, replicas_equal, scripts  # noqa: E402


@pytest.mark.parametrize("mesh", [(1, 2), (2, 2)])
@pytest.mark.parametrize("name", ["micro", "llama3.2-tiny", "llava-tiny"])
def test_sharded_engine_matches_reference_engine(name, mesh, monkeypatch):
    ref, res = scripts(name, mesh, monkeypatch)
    check(ref, res, mesh[1])


def test_skipped_gather_over_data_is_caught(monkeypatch):
    append = tl.append_rows

    def skip_gather(kp, vp, k, v, block_ids, offsets, env, rows, heads):
        if rows is None or env.mesh.get_local_rank("data") != 1:
            return append(kp, vp, k, v, block_ids, offsets, env, rows,
                          heads)
        # data rank 1 still meets the others in the collective, into a
        # throwaway copy, and appends its own rows alone
        append(kp.clone(), vp.clone(), k, v, block_ids, offsets, env, rows,
               heads)
        k0, nk = heads
        tl.paged_kv_update(kp, vp, k[:, :, k0:k0 + nk], v[:, :, k0:k0 + nk],
                           tl.shard_of(block_ids, env, [rows]),
                           tl.shard_of(offsets, env, [rows]))

    monkeypatch.setattr(tl, "append_rows", skip_gather)
    _, res = scripts("micro", (2, 2), monkeypatch, held=False)
    assert not replicas_equal(res, 2)
