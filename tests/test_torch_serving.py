"""Hand-written twins of tests/test_serving.py (7 tests) and of
tests/test_paged_decode.py::test_failed_repark_keeps_existing_blocks /
::test_extend_rejects_bucket_splitting_blocks on the port: the same
tests with ``torch.ones`` / a seeded ``torch.randn`` where the reference
builds ``jnp`` arrays, the pools on the CPU, and the port's own seeded
micro params.  Then ``PagedKVPool.block_table_array`` against the
reference pool's after the same operations (exact)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)           # tiny shapes: threads only add overhead

from repro_torch.configs import get_config, load_all  # noqa: E402
from repro_torch.core.coordinator import SAGAConfig  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402
from repro_torch.serving.kvcache import PagedKVPool  # noqa: E402
from repro_torch.serving.server import AgentRequest, MultiWorkerServer  # noqa

load_all()
CFG = get_config("micro")
PARAMS = lm.init_params(CFG, seed=0, device="cpu")
BF16 = torch.bfloat16


def ones(*shape):
    return torch.ones(shape, dtype=BF16)


def randn(seed, *shape):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed)
                       ).to(BF16)


def pool(*args, **kw):
    return PagedKVPool(*args, device="cpu", **kw)


# --- paged pool --------------------------------------------------------------
def test_pool_alloc_free_invariants():
    p = pool(2, num_blocks=8, block_size=4, n_kv_heads=2, head_dim=8)
    k = ones(2, 10, 2, 8)
    assert p.park("a", k, k, 10)
    assert p.used_blocks() == 3           # ceil(10/4)
    assert p.session_bytes("a") == 3 * p.bytes_per_block
    got = p.resume("a")
    assert got is not None and got[2] == 10
    p.free_session("a")
    assert p.used_blocks() == 0
    assert len(set(p.free)) == 8          # no double-free


def test_pool_park_roundtrip_exact():
    p = pool(3, num_blocks=16, block_size=4, n_kv_heads=2, head_dim=8)
    k = randn(1, 3, 11, 2, 8)
    v = randn(2, 3, 11, 2, 8)
    p.park("s", k, v, 11)
    k2, v2, n = p.resume("s")
    assert n == 11
    assert torch.equal(k2, k[:, :11]) and torch.equal(v2, v[:, :11])


def test_pool_rejects_when_full():
    p = pool(1, num_blocks=2, block_size=4, n_kv_heads=1, head_dim=4)
    k = ones(1, 8, 1, 4)
    assert p.park("a", k, k, 8)
    assert not p.park("b", k, k, 8)       # caller must evict


# --- engine park/resume exactness --------------------------------------------
def test_park_resume_preserves_generation():
    """Decoding with a parked+resumed cache matches uninterrupted decode."""
    rng = np.random.RandomState(0)
    prompt = rng.randint(1, CFG.vocab, size=24).astype(np.int32)

    eng1 = Engine(CFG, PARAMS, n_slots=1, max_len=128, pool_blocks=32)
    s1 = eng1.start_session("x", prompt, cached_hit=False)
    out_straight = eng1.decode({s1: int(prompt[-1])}, n_steps=8)[s1]

    eng2 = Engine(CFG, PARAMS, n_slots=1, max_len=128, pool_blocks=32)
    s2 = eng2.start_session("x", prompt, cached_hit=False)
    first = eng2.decode({s2: int(prompt[-1])}, n_steps=4)[s2]
    eng2.park_session("x")
    ctx = np.concatenate([prompt, np.asarray(first, np.int32)])
    s2b = eng2.start_session("x", ctx, cached_hit=True)
    rest = eng2.decode({s2b: int(ctx[-1])}, n_steps=4)[s2b]
    assert out_straight == first + rest


def test_resume_prefills_only_delta():
    rng = np.random.RandomState(1)
    prompt = rng.randint(1, CFG.vocab, size=20).astype(np.int32)
    eng = Engine(CFG, PARAMS, n_slots=1, max_len=128, pool_blocks=32)
    s = eng.start_session("x", prompt, cached_hit=False)
    assert eng.prefill_tokens == 20
    eng.decode({s: int(prompt[-1])}, n_steps=2)
    eng.park_session("x")
    ctx = np.concatenate([prompt, rng.randint(1, CFG.vocab, size=6)
                          .astype(np.int32)])
    eng.start_session("x", ctx, cached_hit=True)
    # the delta is ctx beyond the parked length 20 + 2 -> 4 new tokens
    assert eng.prefill_tokens == 20 + (len(ctx) - 22)


# --- multi-worker server ------------------------------------------------------
def _mk_req(i, vocab, n_steps=3, rng=None):
    rng = rng or np.random.RandomState(i)
    steps = []
    for _ in range(n_steps):
        steps.append((list(rng.randint(1, vocab, size=8)), 4,
                      "code_execution", 0.2))
    return AgentRequest(f"sess{i}", "tenant0", steps)


def test_server_saga_reduces_regeneration():
    saga_cfg = SAGAConfig()
    req_cfg = SAGAConfig(cache_policy="none", enable_affinity=False,
                         enable_ttl=False, enable_prefetch=False,
                         enable_afs=False, observability="none")
    results = {}
    for name, cfg in [("saga", saga_cfg), ("reqlevel", req_cfg)]:
        srv = MultiWorkerServer(CFG, PARAMS, n_workers=2, saga=cfg,
                                n_slots=2, max_len=256, pool_blocks=64)
        for i in range(3):
            srv.run_task(_mk_req(i, CFG.vocab))
        results[name] = srv.stats()
    assert results["saga"]["regen_tokens"] < \
        results["reqlevel"]["regen_tokens"]
    assert results["saga"]["coordinator_hits"] > 0
    assert results["reqlevel"]["coordinator_hits"] == 0
    # identical decode work either way (policies change prefill only)
    assert results["saga"]["decode_steps"] == \
        results["reqlevel"]["decode_steps"]


def test_server_stats_surface_lifecycle_counters():
    """``MultiWorkerServer.stats()`` exposes the runtime's full counter
    set, matching the runtime's own values."""
    srv = MultiWorkerServer(CFG, PARAMS, n_workers=2, n_slots=2,
                            max_len=256, pool_blocks=64)
    for i in range(2):
        srv.run_task(_mk_req(i, CFG.vocab))
    st = srv.stats()
    for key in ("park_copy_bytes", "resume_copy_bytes",
                "migration_copy_bytes", "steals", "migrations",
                "prefetch_copies", "faults_injected",
                "cancelled_attempts", "preemptions", "afs_dev_max"):
        assert key in st, f"server stats missing {key}"
        assert st[key] == srv.runtime.stats()[key]
    # a clean serial run injects no faults and preempts nothing
    assert st["faults_injected"] == 0
    assert st["cancelled_attempts"] == 0
    assert st["preemptions"] == 0


# --- twins of two tests/test_paged_decode.py pool tests ----------------------
def test_failed_repark_keeps_existing_blocks():
    """A re-park that does not fit leaves the session's previously parked
    KV intact."""
    p = pool(1, num_blocks=3, block_size=4, n_kv_heads=1, head_dim=4)
    k = ones(1, 8, 1, 4)
    assert p.park("a", k, k, 8)           # 2 blocks
    big = ones(1, 24, 1, 4)
    assert not p.park("a", big, big, 24)  # net demand 6-2 > 3-2
    assert p.has("a") and p.lens["a"] == 8
    assert p.audit_blocks() == []


def test_extend_rejects_bucket_splitting_blocks():
    p = pool(1, num_blocks=4, block_size=16, n_kv_heads=1, head_dim=4)
    p.alloc("s")
    k = ones(1, 8, 1, 4)
    with pytest.raises(AssertionError, match="bucket"):
        p.extend("s", k, k, bucket=24)    # 24 % 16 != 0
    p.extend("s", k, k, bucket=32)        # lcm quantum: fine


# --- block_table_array against the reference pool ------------------------------
def test_block_table_array_matches_reference_pool():
    """The same parks, frees and extends on the port's pool and the
    reference's: every session's padded int32 table equal, padded with
    zeros, an unknown session all zeros."""
    import jax.numpy as jnp
    from repro.serving.kvcache import PagedKVPool as RefPool
    ours = pool(2, num_blocks=12, block_size=4, n_kv_heads=1, head_dim=4)
    ref = RefPool(2, num_blocks=12, block_size=4, n_kv_heads=1, head_dim=4)
    for n, sid in ((10, "a"), (5, "b"), (13, "c")):
        assert ours.park(sid, ones(2, n, 1, 4), ones(2, n, 1, 4), n)
        kj = jnp.ones((2, n, 1, 4), jnp.bfloat16)
        assert ref.park(sid, kj, kj, n)
    ours.free_session("b")
    ref.free_session("b")
    ours.alloc("d")
    ref.alloc("d")
    ours.extend("d", ones(2, 8, 1, 4), ones(2, 8, 1, 4), bucket=8)
    kj = jnp.ones((2, 8, 1, 4), jnp.bfloat16)
    ref.extend("d", kj, kj, bucket=8)
    for sid in ("a", "c", "d", "b", "nobody"):
        got = ours.block_table_array(sid, 6)
        want = ref.block_table_array(sid, 6)
        assert got.dtype == want.dtype == np.int32
        assert np.array_equal(got, want), sid
        n = len(ours.tables.get(sid, []))
        assert list(got[:n]) == ours.tables.get(sid, [])
        assert not got[n:].any()
