"""The port's serving engine and paged KV pool against the JAX reference:
the same admit -> decode -> park -> resume-with-delta -> decode sequence
on the same carried params gives identical token ids and identical
host-side state (block tables, lens, free list), and the pool's random
lifecycle interleavings draw the same block ids as the reference pool."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)           # tiny shapes: threads only add overhead

from repro.configs import get_config, llama3_2_3b, load_all  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serving.engine import Engine as JEngine  # noqa: E402
from repro.serving.kvcache import PagedKVPool as JPool  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.configs import llama3_2_3b as tllama  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.serving.engine import Engine as TEngine  # noqa: E402
from repro_torch.serving.kvcache import PagedKVPool as TPool  # noqa: E402

load_all()
CONFIGS = {"micro": (get_config("micro"), tget("micro")),
           "llama3.2-tiny": (llama3_2_3b.tiny(), tllama.tiny())}


def _state(eng):
    p = eng.pool
    return (dict(p.tables), dict(p.lens), list(p.free), sorted(p.resident),
            [(s.session_id, s.length) for s in eng.slots],
            eng.prefill_tokens, eng.regen_tokens, eng.decode_steps,
            eng.park_copy_bytes, eng.resume_copy_bytes)


def _script(eng, rng_seed, vocab):
    """Two sessions batched together, a park, a resume whose delta
    prefill continues a partly filled tail block, and a release.
    Returns the emitted ids and the host state after each phase."""
    rng = np.random.RandomState(rng_seed)
    a = rng.randint(1, vocab, size=37).astype(np.int32)
    b = rng.randint(1, vocab, size=20).astype(np.int32)
    tool = rng.randint(1, vocab, size=11).astype(np.int32)
    ids, states = [], []
    sa = eng.start_session("a", a, cached_hit=False)
    sb = eng.start_session("b", b, cached_hit=False)
    out = eng.decode({sa: int(a[-1]), sb: int(b[-1])}, n_steps=6)
    ids += [out[sa], out[sb]]
    states.append(_state(eng))
    assert eng.park_session("a")
    out = eng.decode({sb: out[sb][-1]}, n_steps=3)
    ids.append(out[sb])
    ctx = np.concatenate([a, np.asarray(ids[0], np.int32), tool])
    sa = eng.start_session("a", ctx, cached_hit=True)
    states.append(_state(eng))
    out = eng.decode({sa: int(ctx[-1])}, n_steps=5)
    ids.append(out[sa])
    assert eng.release_session("b")
    states.append(_state(eng))
    return ids, states


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_engine_matches_jax_engine(name):
    cj, ct = CONFIGS[name]
    pj = jlm.init_params(cj, jax.random.PRNGKey(4))
    pt = tlm.params_from_jax(jax.tree_util.tree_map(np.asarray, pj), "cpu")
    kw = dict(n_slots=3, max_len=96, pool_blocks=12, block_size=8)
    ej, et = JEngine(cj, pj, **kw), TEngine(ct, pt, **kw)
    ids_j, states_j = _script(ej, 5, cj.vocab)
    ids_t, states_t = _script(et, 5, cj.vocab)
    assert ids_t == ids_j
    assert states_t == states_j
    assert et.pool.audit_blocks() == []
    assert et.park_copy_bytes == 0 and et.resume_copy_bytes == 0


def test_export_import_and_handoff_match_jax():
    """Migration export/import and the disaggregated staging + handoff
    land the same blocks with the same accounting."""
    cj, ct = CONFIGS["micro"]
    pj = jlm.init_params(cj, jax.random.PRNGKey(6))
    pt = tlm.params_from_jax(jax.tree_util.tree_map(np.asarray, pj), "cpu")
    toks = np.random.RandomState(6).randint(1, cj.vocab, 45).astype(np.int32)
    out = []
    for E, p, c in ((JEngine, pj, cj), (TEngine, pt, ct)):
        src, dst = (E(c, p, n_slots=2, max_len=64, pool_blocks=16)
                    for _ in range(2))
        assert src.stage_prefill("s", toks, 0)
        k, v, n = src.export_kv("s")
        assert dst.import_kv("s", k, v, n)
        assert src.stage_prefill("h", toks, 30)
        hk, hv, hn = src.export_kv("h")
        assert dst.import_handoff("s", hk, hv, hn, append=True)
        kd, vd, nd = dst.export_kv("s")
        out.append((_state(src), _state(dst), src.handoff_copy_bytes,
                    dst.migration_copy_bytes, dst.handoff_copy_bytes, nd,
                    np.asarray(jnp.asarray(kd).astype(jnp.float32))
                    if E is JEngine else kd.float().numpy()))
        lost = dst.fail()
        assert lost == ["s"] and dst.pool.audit_blocks() == []
    *host_j, kv_j = out[0]
    *host_t, kv_t = out[1]
    assert host_t == host_j
    assert np.max(np.abs(kv_t - kv_j)) < 2e-2


def test_random_lifecycle_interleavings_match_reference_pool():
    """Port twin of tests/test_paged_decode.py::
    test_random_lifecycle_interleavings_keep_pool_clean: the same 300
    random alloc/extend/append/park/resume/import/free operations drive
    the reference pool and the port's side by side; block tables, lens,
    free list and residents match after every step, the audit stays
    clean, and the pools hold the same bits at the end."""
    L, blk, Kh, dh = 2, 4, 1, 4
    n_slots, max_nb = 3, 4
    max_len = max_nb * blk
    nominal = 6
    jp = JPool(L, nominal, blk, Kh, dh, headroom_blocks=n_slots * max_nb)
    tp = TPool(L, nominal, blk, Kh, dh, headroom_blocks=n_slots * max_nb,
               device="cpu")
    rng = np.random.RandomState(0)
    resident, parked = [], []
    next_sid = [0]

    def kv(n):
        a = jnp.asarray(rng.randn(L, n, Kh, dh), jnp.bfloat16)
        t = torch.from_numpy(np.array(a.astype(jnp.float32))).to(
            torch.bfloat16)
        return a, t

    for step in range(300):
        op = rng.choice(["alloc", "extend", "append", "park", "resume",
                         "import", "free"])
        if op == "alloc" and len(resident) < n_slots:
            sid = f"s{next_sid[0]}"
            next_sid[0] += 1
            jp.alloc(sid)
            tp.alloc(sid)
            resident.append(sid)
        elif op == "extend" and resident:
            sid = resident[rng.randint(len(resident))]
            room = max_len - jp.lens[sid]
            if room:
                a, t = kv(rng.randint(1, room + 1))
                jp.extend(sid, a, a, bucket=blk * 2)
                tp.extend(sid, t, t, bucket=blk * 2)
        elif op == "append" and resident:
            sid = resident[rng.randint(len(resident))]
            if jp.lens[sid] < max_len:
                for p in (jp, tp):
                    p.ensure_tail_room(sid)
                    p.append_token(sid)
        elif op == "park" and resident:
            sid = resident[rng.randint(len(resident))]
            if jp.lens[sid]:
                ok = jp.park_resident(sid)
                assert tp.park_resident(sid) == ok
                if ok:
                    resident.remove(sid)
                    parked.append(sid)
        elif op == "resume" and parked and len(resident) < n_slots:
            sid = parked[rng.randint(len(parked))]
            jp.mark_resident(sid)
            tp.mark_resident(sid)
            parked.remove(sid)
            resident.append(sid)
        elif op == "import":
            sid = f"m{next_sid[0]}"
            next_sid[0] += 1
            n = rng.randint(1, nominal * blk + 1)
            a, t = kv(n)
            ok = jp.park(sid, a, a, n)
            assert tp.park(sid, t, t, n) == ok
            if ok:
                parked.append(sid)
        elif op == "free" and (resident or parked):
            pop = resident if (resident and
                               (not parked or rng.rand() < 0.5)) \
                else parked
            sid = pop[rng.randint(len(pop))]
            assert tp.free_session(sid) == jp.free_session(sid)
            pop.remove(sid)
        tag = f"step {step} op {op}"
        assert tp.tables == jp.tables, tag
        assert tp.lens == jp.lens and tp.free == jp.free, tag
        assert tp.resident == jp.resident, tag
        assert tp.audit_blocks() == [], tag
        assert tp.used_blocks() == jp.used_blocks() <= tp.num_blocks, tag

    assert np.array_equal(
        tp.k_pool.view(torch.int16).numpy(),
        np.asarray(jp.k_pool).view(np.int16))
    for sid in list(tp.tables):
        tp.free_session(sid)
    assert tp.audit_blocks() == [] and len(tp.free) == tp.total_blocks
