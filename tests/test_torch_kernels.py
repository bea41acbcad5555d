"""The port's kernel modules against the JAX package.

On the CPU each wrapper runs its plain PyTorch version; these hold the
plain versions against the Pallas kernels (interpret mode, as
tests/test_kernels.py runs them) and the reference's jnp oracles, on the
same numpy inputs (tests/test_torch_cuda.py holds the Hopper kernels
against the plain versions on a card).  Tolerances are tests/test_kernels.py's: 2e-5 in f32, 2e-2 in bf16."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")
torch.set_num_threads(1)           # tiny shapes: threads only add overhead

from repro.kernels.flash_attention.ops import flash_attention  # noqa: E402
from repro.kernels.flash_attention.ref import flash_attention_ref  # noqa
from repro.kernels.paged_attention import ops as jops  # noqa: E402
from repro.kernels.paged_attention.ref import paged_decode_ref  # noqa
from repro.models import layers as jl  # noqa: E402
from repro_torch.kernels.flash_attention import ops as F  # noqa: E402
from repro_torch.kernels.paged_attention import ops as P  # noqa: E402

TOL = {"f32": 2e-5, "bf16": 2e-2}
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


def _pair(a: np.ndarray, dt: str):
    """The same values as a JAX array and a torch tensor of type dt."""
    j = jnp.asarray(a, JDT[dt])
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(TDT[dt])


def _err(t, j) -> float:
    return float(np.max(np.abs(t.float().numpy()
                               - np.asarray(j.astype(jnp.float32)))))


# --- flash prefill ----------------------------------------------------------
@pytest.mark.parametrize("D", [16, 64])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0),
                                           (True, 64)])
def test_flash_plain_matches_pallas_and_ref(D, dt, causal, window):
    rng = np.random.RandomState(D)
    B, S, H, K = 1, 128, 4, 2
    qj, qt = _pair(rng.randn(B, S, H, D), dt)
    kj, kt = _pair(rng.randn(B, S, K, D), dt)
    vj, vt = _pair(rng.randn(B, S, K, D), dt)
    out = F.flash_prefill(qt, kt, vt, causal=causal, window=window)
    assert out.dtype == TDT[dt] and out.shape == (B, S, H, D)
    pallas = flash_attention(qj, kj, vj, causal=causal, window=window)
    ref = flash_attention_ref(qj, kj, vj, causal=causal, window=window)
    assert _err(out, pallas) < TOL[dt]
    assert _err(out, ref) < TOL[dt]


def test_flash_plain_ragged_length_matches_ref():
    """A length that is no multiple of any tile (the kernel masks the
    ragged edge itself) against the reference's dense oracle."""
    rng = np.random.RandomState(7)
    qj, qt = _pair(rng.randn(2, 77, 6, 16), "f32")
    kj, kt = _pair(rng.randn(2, 77, 3, 16), "f32")
    vj, vt = _pair(rng.randn(2, 77, 3, 16), "f32")
    out = F.flash_prefill(qt, kt, vt, causal=True, window=20)
    assert _err(out, flash_attention_ref(qj, kj, vj, causal=True,
                                         window=20)) < TOL["f32"]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_value_width_apart_matches_chunked(dt, causal):
    """deepseek-v2-tiny's MLA prefill: query-key width 24 (nope 16 + rope
    8) over value width 16, scale 1/sqrt(24), against the reference's
    ``chunked_attention`` (which takes Dv = v.shape[-1]); the output takes
    v's width."""
    rng = np.random.RandomState(24)
    B, S, H = 2, 40, 4
    qj, qt = _pair(rng.randn(B, S, H, 24), dt)
    kj, kt = _pair(rng.randn(B, S, H, 24), dt)
    vj, vt = _pair(rng.randn(B, S, H, 16), dt)
    out = F.flash_prefill(qt, kt, vt, causal=causal)
    assert out.dtype == TDT[dt] and out.shape == (B, S, H, 16)
    assert _err(out, jl.chunked_attention(qj, kj, vj, causal=causal)) \
        < TOL[dt]


@pytest.mark.parametrize("D", [16, 64])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_flash_plain_cross_attention_matches_ref(D, dt):
    """A cross-attention: non-causal, 24 queries over 40 keys (Sq != Sk),
    GQA, against the reference's ``attention_dense`` and
    ``chunked_attention`` (the kv heads expanded, as its callers do)."""
    rng = np.random.RandomState(D + 1)
    B, Sq, Sk, H, K = 2, 24, 40, 4, 2
    qj, qt = _pair(rng.randn(B, Sq, H, D), dt)
    kj, kt = _pair(rng.randn(B, Sk, K, D), dt)
    vj, vt = _pair(rng.randn(B, Sk, K, D), dt)
    out = F.flash_prefill(qt, kt, vt, causal=False)
    assert out.dtype == TDT[dt] and out.shape == (B, Sq, H, D)
    assert _err(out, jl.attention_dense(qj, kj, vj, causal=False)) < TOL[dt]
    chunked = jl.chunked_attention(qj, jl.expand_kv(kj, H),
                                   jl.expand_kv(vj, H), causal=False)
    assert _err(out, chunked) < TOL[dt]


# --- paged decode ------------------------------------------------------------
def _paged_inputs(rng, B, H, K, dh, block, nblocks, nb, dt):
    qj, qt = _pair(rng.randn(B, H, dh), dt)
    kj, kt = _pair(rng.randn(nblocks, block, K, dh), dt)
    vj, vt = _pair(rng.randn(nblocks, block, K, dh), dt)
    tables = np.stack([rng.choice(nblocks, size=nb, replace=False)
                       for _ in range(B)]).astype(np.int32)
    lens = rng.randint(1, nb * block + 1, size=B).astype(np.int32)
    return (qj, kj, vj, jnp.asarray(tables), jnp.asarray(lens)), \
        (qt, kt, vt, torch.from_numpy(tables), torch.from_numpy(lens))


@pytest.mark.parametrize("B,H,K,dh,block,nblocks,nb", [
    (2, 4, 2, 64, 16, 32, 4),
    (3, 6, 2, 16, 8, 24, 5),
])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_paged_plain_matches_pallas(B, H, K, dh, block, nblocks, nb, dt):
    rng = np.random.RandomState(B)
    js, ts = _paged_inputs(rng, B, H, K, dh, block, nblocks, nb, dt)
    out = P.paged_decode(*ts)
    assert out.dtype == TDT[dt] and out.shape == (B, H, dh)
    assert _err(out, jops.paged_attention(*js)) < TOL[dt]


@pytest.mark.parametrize("window", [1, 7, 32])
def test_paged_plain_window_matches_decode_attention(window):
    """The kernel takes the model path's sliding window, which the Pallas
    kernel lacks: hold it against the reference's decode_attention over
    gathered blocks (mask pos - window < idx <= pos)."""
    rng = np.random.RandomState(window)
    (qj, kj, vj, tj, lj), ts = _paged_inputs(rng, 3, 4, 2, 16, 8, 24, 5,
                                             "f32")
    out = P.paged_decode(*ts, window=window)
    kg, vg = jl.paged_kv_gather(kj, vj, tj)
    ref = jl.decode_attention(qj[:, None], kg, vg, lj - 1,
                              window=window)[:, 0]
    assert _err(out, ref) < TOL["f32"]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_append_then_attend_matches_paged_decode_step(dt):
    """Plain append + attend per layer against ops.paged_decode_step,
    with an idle row carrying the drop sentinel (the shape of
    tests/test_paged_decode.py::test_paged_decode_step_matches_ref)."""
    L, B, H, K, dh, NB, blk = 3, 4, 4, 2, 16, 12, 4
    rng = np.random.RandomState(0)
    qj, qt = _pair(rng.randn(L, B, H, dh), dt)
    knj, knt = _pair(rng.randn(L, B, K, dh), dt)
    vnj, vnt = _pair(rng.randn(L, B, K, dh), dt)
    kpj, kpt = _pair(rng.randn(L, NB, blk, K, dh), dt)
    vpj, vpt = _pair(rng.randn(L, NB, blk, K, dh), dt)
    tables = np.asarray([[0, 1, 2], [3, 4, 5], [6, 7, 8], [9, 10, 11]],
                        np.int32)
    lens = np.asarray([7, 3, 1, 12], np.int32)
    ablk = np.asarray([1, 3, NB, 11], np.int32)         # NB: drop sentinel
    aoff = np.asarray([2, 2, 0, 3], np.int32)
    out_j, kp_j, vp_j = jops.paged_decode_step(
        qj, knj, vnj, kpj, vpj, jnp.asarray(tables), jnp.asarray(lens),
        jnp.asarray(ablk), jnp.asarray(aoff))
    T = torch.from_numpy
    for l in range(L):
        P.paged_append(kpt[l], vpt[l], knt[l], vnt[l], T(ablk), T(aoff))
        out = P.paged_decode(qt[l], kpt[l], vpt[l], T(tables), T(lens))
        for b in (0, 1, 3):                              # row 2 is idle
            assert _err(out[b], out_j[l, b]) < TOL[dt], (l, b)
    assert _err(kpt, kp_j) == 0.0 and _err(vpt, vp_j) == 0.0


def test_append_plain_drops_out_of_range_rows():
    pool = torch.zeros(4, 2, 1, 8)
    new = torch.arange(3 * 8, dtype=torch.float32).reshape(3, 1, 8) + 1
    ids = torch.tensor([1, 4, -1], dtype=torch.int32)   # 4, -1: dropped
    P.paged_append(pool, pool.clone(), new, new, ids,
                   torch.tensor([1, 0, 0], dtype=torch.int32))
    assert torch.equal(pool[1, 1], new[0])
    assert int((pool != 0).sum()) == 8


# --- the decode kernel's split schedule --------------------------------------
def _split_decode(q, k_pool, v_pool, tables, lens, window, span):
    """The arithmetic of csrc/paged_attention.cu's split decode on the CPU:
    per span of ``split_schedule``, an online softmax over CHUNK-token
    chunks with p rounded to q's dtype relative to the running max; then
    the partials rescaled by exp(m_split - m) in f32 and summed."""
    B, H, dh = q.shape
    _, block, K, _ = k_pool.shape
    G, nb = H // K, tables.shape[1]
    kf = k_pool.reshape(-1, K, dh).float()
    vf = v_pool.reshape(-1, K, dh).float()
    out = torch.zeros(B, H, dh, dtype=q.dtype)
    for b in range(B):
        n = min(int(lens[b]), nb * block)
        lo = max(0, n - window) if window else 0
        if n <= 0:
            continue
        for h in range(K):
            qg = q[b, h * G:(h + 1) * G].float()
            parts = []
            for s in range(lo // span, (n - 1) // span + 1):
                m = torch.full((G,), -math.inf)
                l, acc = torch.zeros(G), torch.zeros(G, dh)
                t_end = min((s + 1) * span, n)
                for c0 in range(max(s * span, lo), t_end, P.CHUNK):
                    t = torch.arange(c0, min(c0 + P.CHUNK, t_end))
                    rows = tables[b, t // block].long() * block + t % block
                    sc = qg @ kf[rows, h].T / math.sqrt(dh)
                    m_new = torch.maximum(m, sc.max(-1).values)
                    alpha = torch.exp(m - m_new)
                    p = torch.exp(sc - m_new[:, None])
                    l = l * alpha + p.sum(-1)
                    acc = acc * alpha[:, None] \
                        + p.to(q.dtype).float() @ vf[rows, h]
                    m = m_new
                parts.append((m, l, acc))
            if len(parts) == 1:
                o = parts[0][2] / parts[0][1][:, None]
            else:
                mm = torch.stack([p[0] for p in parts]).max(0).values
                w = [torch.exp(p[0] - mm) for p in parts]
                lt = sum(wi * p[1] for wi, p in zip(w, parts))
                o = sum((wi / lt)[:, None] * p[2] for wi, p in zip(w, parts))
            out[b, h * G:(h + 1) * G] = o.to(q.dtype)
    return out


@settings(max_examples=30, deadline=None)
@given(block=st.sampled_from([4, 16, 1058]), nb=st.integers(1, 6),
       B=st.integers(1, 3), G=st.integers(1, 4),
       n_sm=st.sampled_from([1, 8, 132]), window=st.integers(0, 300),
       dt=st.sampled_from(["f32", "bf16"]), seed=st.integers(0, 2**16),
       data=st.data())
def test_split_schedule_merge_matches_plain_and_ref(block, nb, B, G, n_sm,
                                                    window, dt, seed, data):
    """Per-span partials on ``split_schedule``'s spans, merged as the
    kernel merges them, against ``paged_decode_plain`` (2e-5 f32, 2e-2
    bf16) and, without a window, the reference's paged_decode_ref."""
    if block == 1058:
        nb = 1                  # jamba's contiguous cache: one block a row
    K, dh = 2, 16
    cap = nb * block
    span, splits = P.split_schedule(nb, block, B * K, n_sm)
    assert span % P.CHUNK == 0 and 1 <= splits <= P.MAX_SPLITS
    assert span * splits >= cap > span * (splits - 1)
    lens = np.asarray(data.draw(st.lists(st.integers(0, cap), min_size=B,
                                         max_size=B)), np.int32)
    rng = np.random.RandomState(seed)
    nblocks = B * nb + 1
    qj, qt = _pair(rng.randn(B, G * K, dh), dt)
    kj, kt = _pair(rng.randn(nblocks, block, K, dh), dt)
    vj, vt = _pair(rng.randn(nblocks, block, K, dh), dt)
    tables = np.stack([rng.choice(nblocks, size=nb, replace=False)
                       for _ in range(B)]).astype(np.int32)
    tt, lt = torch.from_numpy(tables), torch.from_numpy(lens)
    out = _split_decode(qt, kt, vt, tt, lt, window, span)
    ref = P.paged_decode_plain(qt, kt, vt, tt, lt, window=window)
    assert float((out.float() - ref.float()).abs().max()) < TOL[dt]
    if window == 0:
        live = lens > 0         # the reference averages a row that sees none
        jref = paged_decode_ref(qj, kj, vj, jnp.asarray(tables),
                                jnp.asarray(lens))
        if live.any():
            assert _err(out[live], jref[live]) < TOL[dt]
        assert not out[~live].any()
