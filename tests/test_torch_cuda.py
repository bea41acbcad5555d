"""The port's Hopper kernels against their plain PyTorch versions, on a
card.  Every test here is marked ``cuda`` and skips without one; the file
imports no JAX, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Tolerance: bf16 2e-2 (tests/test_kernels.py); the append moves bits and
must match exactly.  The two recurrences (wkv6, mamba_scan) keep f32
state and sum in another order than their plain versions: 1e-3 on their
outputs and final states (tests/test_kernels.py's wkv6 tolerance).
Where the model's decay and long sequences grow the wkv6 state to tens,
1e-3 of the largest magnitude, as chip_smoke.py holds it.  Where
mamba_scan rounds h.C to bf16, its outputs must equal the plain version's
past an f32 slack at the scale of the sum h.C, but on under 1 % of
elements, each one bf16 step of h.C off (``M.rounding_errs``); at its
chunk edges and up to 1024 steps, 1e-3 of the largest magnitude, as for
wkv6."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import ops as F  # noqa: E402
from repro_torch.kernels.mamba_scan import ops as M  # noqa: E402
from repro_torch.kernels.paged_attention import ops as P  # noqa: E402
from repro_torch.kernels.rwkv6 import ops as R  # noqa: E402

TOL = 2e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA) and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("D", [16, 64, 128])
@pytest.mark.parametrize("G", [1, 3, 4, 8])
@pytest.mark.parametrize("S", [32, 200, 1000, 1056])
@pytest.mark.parametrize("window", [0, 32, 4096])
def test_flash_kernel_matches_plain_on_card(cuda, D, G, S, window):
    """Causal, with a window of 0 (none), 32, and one longer than S; S
    ragged against the 128-row query and key tiles."""
    g = torch.Generator(device=cuda).manual_seed(D * S + G)
    K = 2
    q, k, v = (torch.randn(2, S, h, D, generator=g, device=cuda)
               .to(torch.bfloat16) for h in (G * K, K, K))
    before = F.flash_prefill.launches
    out = F.flash_prefill(q, k, v, causal=True, window=window)
    assert F.flash_prefill.launches == before + 1
    ref = F.flash_prefill_plain(q, k, v, causal=True, window=window)
    assert float((out.float() - ref.float()).abs().max()) < TOL


def _paged_case(cuda, g, lens, G, dh, K=2, blk=16, nb=16):
    """Pools of random bf16, each row's table a random draw of distinct
    blocks, the append's drop sentinel on the last row."""
    B = len(lens)
    mk = lambda *s: torch.randn(s, generator=g, device=cuda).to(  # noqa
        torch.bfloat16)
    nblocks = B * nb + 4
    q, kn, vn = mk(B, G * K, dh), mk(B, K, dh), mk(B, K, dh)
    kp, vp = mk(nblocks, blk, K, dh), mk(nblocks, blk, K, dh)
    perm = torch.randperm(nblocks, generator=g, device=cuda)
    tables = perm[:B * nb].reshape(B, nb).to(torch.int32).contiguous()
    lens = torch.tensor(lens, device=cuda, dtype=torch.int32)
    pos = (lens - 1).clamp_min(0).long()
    ablk = tables[torch.arange(B, device=cuda), pos // blk].contiguous()
    ablk[-1] = nblocks
    aoff = (pos % blk).to(torch.int32)
    return q, kn, vn, kp, vp, tables, lens, ablk, aoff


def _paged_lens(blk, nb, rows):
    """0, 1, a block boundary +- 1, a split boundary +- 1 (the span the
    card's schedule gives this table) and the table's capacity."""
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    span, _ = P.split_schedule(nb, blk, rows, n_sm)
    cap = nb * blk
    return [0, 1, blk - 1, blk, blk + 1, span - 1, span, span + 1,
            2 * span + 1, cap - 1, cap]


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [16, 64, 128])
@pytest.mark.parametrize("G", [3, 4, 8])
@pytest.mark.parametrize("window", [0, 32, 4096])
def test_paged_kernels_match_plain_on_card(cuda, dh, G, window):
    """Append (with the drop sentinel) then decode, every row at a length
    on an edge of the blocks or of the split schedule."""
    g = torch.Generator(device=cuda).manual_seed(dh + G)
    blk, nb, K = 16, 16, 2
    lens = _paged_lens(blk, nb, 11 * K)
    q, kn, vn, kp, vp, tables, lens, ablk, aoff = _paged_case(
        cuda, g, lens, G, dh, K=K, blk=blk, nb=nb)
    kp2, vp2 = kp.clone(), vp.clone()
    P.paged_append(kp, vp, kn, vn, ablk, aoff)
    before = P.paged_decode.launches
    out = P.paged_decode(q, kp, vp, tables, lens, window=window)
    assert P.paged_decode.launches == before + 1
    P.paged_append_plain(kp2, vp2, kn, vn, ablk, aoff)
    ref = P.paged_decode_plain(q, kp2, vp2, tables, lens, window=window)
    assert torch.equal(kp, kp2) and torch.equal(vp, vp2)
    assert float((out.float() - ref.float()).abs().max()) < TOL


@pytest.mark.cuda
@pytest.mark.parametrize("live", [1056, 2048])
def test_paged_decode_served_shape_twice_without_sync(cuda, live):
    """The served path's shape: B=4 rows of 24 heads over 8 KV heads,
    dh=128, block 16, nb=128; one live row, three idle rows of len 1 on
    table rows of zeros.  Two calls in a row on other queries (the
    combine's tickets must be back at 0 after the first), the second under
    ``set_sync_debug_mode("error")``: the wrapper reads nothing back to
    the host."""
    g = torch.Generator(device=cuda).manual_seed(live)
    B, H, K, dh, blk, nb = 4, 24, 8, 128, 16, 128
    mk = lambda *s: torch.randn(s, generator=g, device=cuda).to(  # noqa
        torch.bfloat16)
    kp, vp = mk(B * nb + 1, blk, K, dh), mk(B * nb + 1, blk, K, dh)
    tables = torch.zeros(B, nb, dtype=torch.int32, device=cuda)
    tables[0] = torch.arange(1, nb + 1, dtype=torch.int32, device=cuda)
    lens = torch.tensor([live, 1, 1, 1], dtype=torch.int32, device=cuda)
    for call in range(2):
        q = mk(B, H, dh)
        if call:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            out = P.paged_decode(q, kp, vp, tables, lens)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        ref = P.paged_decode_plain(q, kp, vp, tables, lens)
        assert float((out.float() - ref.float()).abs().max()) < TOL, call


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    q = torch.zeros(1, 64, 4, 16, device=cuda)               # float32
    with pytest.raises(ValueError, match="bf16"):
        F.flash_prefill(q, q[:, :, :2], q[:, :, :2])
    qb = q.to(torch.bfloat16)[..., :8].contiguous()          # head_dim 8
    with pytest.raises(ValueError, match="head_dim"):
        F.flash_prefill(qb, qb[:, :, :2], qb[:, :, :2])
    pool = torch.zeros(4, 16, 2, 16, device=cuda, dtype=torch.bfloat16)
    ids = torch.zeros(1, device=cuda, dtype=torch.int64)     # not int32
    new = torch.zeros(1, 2, 16, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="int32"):
        P.paged_append(pool, pool.clone(), new, new, ids, ids)


@pytest.mark.cuda
def test_engine_on_card_matches_cpu(cuda):
    """micro served through the kernels on the card lands the same KV in
    the same blocks as the plain versions on the CPU."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.serving.engine import Engine

    cfg = get_config("micro")
    cpu = lm.init_params(cfg, seed=3, device="cpu")
    params = {"cpu": cpu, "cuda": _to(cpu, cuda)}
    prompt = np.random.RandomState(3).randint(1, cfg.vocab, 45)
    engines = {}
    for dev, p in params.items():
        eng = Engine(cfg, p, n_slots=2, max_len=128, pool_blocks=16)
        slot = eng.start_session("s", prompt, cached_hit=False)
        # one step: its input is fixed, so its KV must agree whatever
        # id a near-tie gives later steps
        eng.decode({slot: int(prompt[-1])}, n_steps=1)
        engines[dev] = eng
    a, b = engines["cpu"].pool, engines["cuda"].pool
    assert a.tables == b.tables and a.lens == b.lens
    assert engines["cuda"].pool.audit_blocks() == []
    for x, y in ((a.k_pool, b.k_pool), (a.v_pool, b.v_pool)):
        assert float((x.float() - y.float().cpu()).abs().max()) < TOL


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [16, 64])
@pytest.mark.parametrize("T", [1, 37, 96])
def test_wkv6_kernel_matches_plain_on_card(cuda, dh, T):
    """Model layout, a non-zero state in, and r/k/v read as strided views
    of one wider tensor; outputs and final state against the plain scan."""
    g = torch.Generator(device=cuda).manual_seed(dh + T)
    B, H = 2, 3
    rkv = (torch.randn(B, T, 3, H, dh, generator=g, device=cuda) * 0.5
           ).to(torch.bfloat16)
    r, k, v = rkv[:, :, 0], rkv[:, :, 1], rkv[:, :, 2]
    w = torch.sigmoid(torch.randn(B, T, H, dh, generator=g, device=cuda)) \
        * 0.5 + 0.45
    u = torch.randn(H, dh, generator=g, device=cuda) * 0.3
    s0 = torch.randn(B, H, dh, dh, generator=g, device=cuda)
    before = R.wkv6.launches
    out, s_T = R.wkv6(r, k, v, w, u, s0)
    assert R.wkv6.launches == before + 1
    ref, ref_T = R.wkv6_plain(r, k, v, w, u, s0)
    assert float((out - ref).abs().max()) < 1e-3
    assert float((s_T - ref_T).abs().max()) < 1e-3


def _wkv6_model_inputs(cuda, seed, B, T, H, dh):
    """r, k, v as strided views of one (B, T, 3, H, dh) bf16 tensor, the
    model's decay exp(-exp(U(-5, 3))) (w from ~0 to 0.993), a state in."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    rkv = (torch.randn(B, T, 3, H, dh, generator=g, device=cuda) * 0.5
           ).to(torch.bfloat16)
    dec = -5 + 8 * torch.rand(B, T, H, dh, generator=g, device=cuda)
    return (rkv[:, :, 0], rkv[:, :, 1], rkv[:, :, 2],
            torch.exp(-torch.exp(dec)),
            torch.randn(H, dh, generator=g, device=cuda) * 0.3,
            torch.randn(B, H, dh, dh, generator=g, device=cuda))


def _rel(x, ref) -> float:
    """Max abs error over the reference's largest magnitude (at least 1),
    as chip_smoke.py holds the scans: under the model's slowest decay the
    state and outputs grow to tens over a long sequence."""
    return float((x - ref).abs().max()) / max(1.0,
                                             float(ref.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [16, 64])
@pytest.mark.parametrize("T", [1, 15, 16, 17, 33, 1000, 1024])
def test_wkv6_kernel_model_decay_any_length(cuda, dh, T):
    """The model's decay range, T on both sides of the 16-step ring
    chunk and up to rwkv6-7b's prefill length, a non-zero state in:
    outputs and final state within 1e-3 of the largest magnitude."""
    args = _wkv6_model_inputs(cuda, 100 * dh + T, 2, T, 4, dh)
    out, s_T = R.wkv6(*args)
    ref, ref_T = R.wkv6_plain(*args)
    assert _rel(out, ref) < 1e-3 and _rel(s_T, ref_T) < 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [16, 64])
def test_wkv6_prefill_then_decode_without_sync(cuda, dh):
    """A prefill of 37 steps and a T = 1 step from its final state, back
    to back on one stream with no sync between: both as the plain scan
    gives them."""
    r, k, v, w, u, s0 = _wkv6_model_inputs(cuda, dh, 2, 38, 3, dh)
    before = R.wkv6.launches
    out1, s1 = R.wkv6(r[:, :37], k[:, :37], v[:, :37], w[:, :37], u, s0)
    out2, s2 = R.wkv6(r[:, 37:], k[:, 37:], v[:, 37:], w[:, 37:], u, s1)
    assert R.wkv6.launches == before + 2
    ref, ref_T = R.wkv6_plain(r, k, v, w, u, s0)
    assert _rel(torch.cat([out1, out2], 1), ref) < 1e-3
    assert _rel(s2, ref_T) < 1e-3


@pytest.mark.cuda
def test_wkv6_refuses_views_its_16_byte_copies_cannot_read(cuda):
    B, T, H, dh = 1, 4, 2, 16
    n = B * T * H * dh
    flat = torch.zeros(n + 8, device=cuda, dtype=torch.bfloat16)
    r = flat[:n].view(B, T, H, dh)
    w = torch.zeros(B, T, H, dh, device=cuda)
    u = torch.zeros(H, dh, device=cuda)
    R.wkv6(r, r, r, w, u)                                    # aligned: runs
    off = flat[4:n + 4].view(B, T, H, dh)                    # 8 bytes in
    with pytest.raises(ValueError, match="16-byte"):
        R.wkv6(off, off, off, w, u)
    wide = torch.zeros(B, T, H, dh + 4, device=cuda,
                       dtype=torch.bfloat16)[..., :dh]       # stride 20
    with pytest.raises(ValueError, match="16-byte"):
        R.wkv6(wide, wide, wide, w, u)
    wflat = torch.zeros(n + 4, device=cuda)
    with pytest.raises(ValueError, match="16-byte"):
        R.wkv6(r, r, r, wflat[1:n + 1].view(B, T, H, dh), u)


@pytest.mark.cuda
@pytest.mark.parametrize("ds", [8, 16])
@pytest.mark.parametrize("T", [1, 45])
@pytest.mark.parametrize("round_y", [False, True])
def test_mamba_scan_kernel_matches_plain_on_card(cuda, ds, T, round_y):
    """A ragged channel count, B and C as strided slices of one projection
    (as mamba_layer passes them), a non-zero state in; both rounding
    modes."""
    g = torch.Generator(device=cuda).manual_seed(ds + T)
    B, di, dtr = 2, 200, 5
    mk = lambda *s: torch.randn(s, generator=g, device=cuda)  # noqa: E731
    x = mk(B, T, di).to(torch.bfloat16)
    dt = torch.nn.functional.softplus(mk(B, T, di) - 2).to(torch.bfloat16)
    dbc = mk(B, T, dtr + 2 * ds).to(torch.bfloat16)
    Bc, Cc = dbc[..., dtr:dtr + ds], dbc[..., dtr + ds:]
    A = -torch.arange(1, ds + 1, device=cuda, dtype=torch.float32
                      ).expand(di, ds).contiguous()
    D = mk(di)
    h0 = mk(B, di, ds)
    before = M.mamba_scan.launches
    y, h_T = M.mamba_scan(x, dt, Bc, Cc, A, D, h0, round_y=round_y)
    assert M.mamba_scan.launches == before + 1
    ref, ref_T = M.mamba_scan_plain(x, dt, Bc, Cc, A, D, h0,
                                    round_y=round_y)
    if round_y:
        steps, share = M.rounding_errs(y, ref, x, dt, Bc, Cc, A, D, h0)
        assert steps <= M.ROUND_STEPS and share < M.ROUND_SHARE, \
            (steps, share)
    else:
        assert float((y - ref).abs().max()) < 1e-3
    assert float((h_T - ref_T).abs().max()) < 1e-3


def _mamba_inputs(cuda, seed, B, T, di, ds, dtr=5):
    """x, dt (B, T, di) bf16; B and C strided slices of one (B, T, dtr +
    2 ds) projection at an odd element offset (dtr 5: 10 bytes in, rows of
    42 or 74 bytes); A = -(1 .. ds); D random; a state in."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    mk = lambda *s: torch.randn(s, generator=g, device=cuda)  # noqa: E731
    x = mk(B, T, di).to(torch.bfloat16)
    dt = torch.nn.functional.softplus(mk(B, T, di) - 2).to(torch.bfloat16)
    dbc = mk(B, T, dtr + 2 * ds).to(torch.bfloat16)
    A = -torch.arange(1, ds + 1, device=cuda, dtype=torch.float32
                      ).expand(di, ds).contiguous()
    return [x, dt, dbc[..., dtr:dtr + ds], dbc[..., dtr + ds:], A, mk(di),
            mk(B, di, ds)]


def _hold_mamba(y, h_T, args, round_y):
    """y and h_T against the plain scan: rounding_errs in the rounding
    mode, else 1e-3 of the largest magnitude; h_T within 1e-3 of it."""
    ref, ref_T = M.mamba_scan_plain(*args, round_y=round_y)
    if round_y:
        steps, share = M.rounding_errs(y, ref, *args)
        assert steps <= M.ROUND_STEPS and share < M.ROUND_SHARE, \
            (steps, share)
    else:
        assert _rel(y, ref) < 1e-3
    assert _rel(h_T, ref_T) < 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("ds", [8, 16])
@pytest.mark.parametrize("T", [1, 31, 32, 33, 1024])
@pytest.mark.parametrize("round_y", [False, True])
def test_mamba_scan_ring_chunk_edges(cuda, ds, T, round_y):
    """T on both sides of the 32-step ring chunk and up to jamba's prefill
    length, a ragged channel count (200), B and C at an odd offset."""
    args = _mamba_inputs(cuda, 10 * ds + T, 2, T, 200, ds)
    y, h_T = M.mamba_scan(*args, round_y=round_y)
    _hold_mamba(y, h_T, args, round_y)


@pytest.mark.cuda
@pytest.mark.parametrize("ds", [8, 16])
def test_mamba_scan_kernel_uses_no_local_memory(cuda, ds):
    """Neither entry spills: its local memory a thread, from the CUDA
    runtime, is 0 (whether or not this run built the library)."""
    lanes, regs, smem, ctas, local = M.kernel_config(ds)
    assert local == 0 and ds % lanes == 0 and ctas >= 1, \
        (lanes, regs, smem, ctas, local)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 1024])
def test_mamba_scan_is_deterministic(cuda, T):
    """Two calls on the same inputs give the same bits: the lanes' sum
    h.C runs in one fixed shuffle order."""
    args = _mamba_inputs(cuda, T, 2, T, 8192, 16, dtr=256)
    y1, h1 = M.mamba_scan(*args, round_y=True)
    y2, h2 = M.mamba_scan(*args, round_y=True)
    assert torch.equal(y1, y2) and torch.equal(h1, h2)


@pytest.mark.cuda
@pytest.mark.parametrize("ds", [8, 16])
def test_mamba_scan_prefill_then_step_without_sync(cuda, ds):
    """A scan over 45 steps and a T = 1 step from its final state, back to
    back on one stream with no sync between, equal one scan over 46 (the
    kernel's and the plain version's) within 1e-3."""
    x, dt, Bc, Cc, A, D, h0 = _mamba_inputs(cuda, ds, 2, 46, 200, ds)
    before = M.mamba_scan.launches
    y1, h1 = M.mamba_scan(x[:, :45], dt[:, :45], Bc[:, :45], Cc[:, :45], A,
                          D, h0)
    y2, h2 = M.mamba_scan(x[:, 45:], dt[:, 45:], Bc[:, 45:], Cc[:, 45:], A,
                          D, h1)
    assert M.mamba_scan.launches == before + 2
    y, h_T = torch.cat([y1, y2], 1), h2
    for ref, ref_T in (M.mamba_scan(x, dt, Bc, Cc, A, D, h0),
                       M.mamba_scan_plain(x, dt, Bc, Cc, A, D, h0)):
        assert _rel(y, ref) < 1e-3 and _rel(h_T, ref_T) < 1e-3


@pytest.mark.cuda
def test_mamba_scan_refuses_views_its_16_byte_copies_cannot_read(cuda):
    x, dt, Bc, Cc, A, D, h0 = _mamba_inputs(cuda, 0, 1, 4, 64, 16)
    M.mamba_scan(x, dt, Bc, Cc, A, D, h0)                 # aligned: runs
    flat = torch.zeros(4 * 64 + 8, device=cuda, dtype=torch.bfloat16)
    off = flat[4:4 * 64 + 4].view(1, 4, 64)               # 8 bytes in
    with pytest.raises(ValueError, match="16-byte"):
        M.mamba_scan(off, dt, Bc, Cc, A, D, h0)
    wide = torch.zeros(1, 4, 68, device=cuda,
                       dtype=torch.bfloat16)[..., :64]    # stride 68
    with pytest.raises(ValueError, match="16-byte"):
        M.mamba_scan(x, wide, Bc, Cc, A, D, h0)
    hflat = torch.zeros(64 * 16 + 1, device=cuda)
    with pytest.raises(ValueError, match="16-byte"):
        M.mamba_scan(x, dt, Bc, Cc, A, D, hflat[1:].view(1, 64, 16))


@pytest.mark.cuda
def test_recurrence_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    r = torch.zeros(1, 4, 2, 16, device=cuda)                # float32 r
    w = torch.zeros(1, 4, 2, 16, device=cuda)
    u = torch.zeros(2, 16, device=cuda)
    with pytest.raises(ValueError, match="bf16"):
        R.wkv6(r, r, r, w, u)
    rb = torch.zeros(1, 4, 2, 8, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head size"):
        R.wkv6(rb, rb, rb, w[..., :8], u[:, :8])
    x = torch.zeros(1, 4, 32, device=cuda, dtype=torch.bfloat16)
    bc = torch.zeros(1, 4, 4, device=cuda, dtype=torch.bfloat16)
    A = torch.zeros(32, 4, device=cuda)
    with pytest.raises(ValueError, match="d_state"):
        M.mamba_scan(x, x, bc, bc, A, torch.zeros(32, device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1056, 1058])
@pytest.mark.parametrize("window", [0, 32])
def test_contiguous_cache_decode_through_paged_kernels(cuda, S, window):
    """jamba's decode attention: the (B, max_len, K, dh) cache as B blocks
    of max_len tokens, through paged_append + paged_decode, against the
    plain versions (which the CPU tests hold against the reference's
    gqa_attention_decode)."""
    from repro_torch.models import layers as L
    g = torch.Generator(device=cuda).manual_seed(5)
    B, K, dh, H = 3, 8, 128, 32
    kc = torch.randn(B, S, K, dh, generator=g, device=cuda).to(torch.bfloat16)
    vc = torch.randn(B, S, K, dh, generator=g, device=cuda).to(torch.bfloat16)
    q = torch.randn(B, H, dh, generator=g, device=cuda).to(torch.bfloat16)
    kn = torch.randn(B, 1, K, dh, generator=g, device=cuda).to(torch.bfloat16)
    pos = torch.tensor([S - 1, 1030, 7], device=cuda, dtype=torch.int32)
    kc2, vc2 = kc.clone(), vc.clone()
    L._cache_insert(kc, vc, kn, kn, pos)
    out = P.paged_decode(q, kc, vc, *L._contiguous_table(pos),
                         window=window)
    rows = torch.arange(B, device=cuda)
    kc2[rows, pos.long()] = kn[:, 0]
    vc2[rows, pos.long()] = kn[:, 0]
    tables, lens = L._contiguous_table(pos)
    ref = P.paged_decode_plain(q, kc2, vc2, tables, lens, window=window)
    assert torch.equal(kc, kc2) and torch.equal(vc, vc2)
    assert float((out.float() - ref.float()).abs().max()) < TOL


@pytest.mark.cuda
@pytest.mark.parametrize("window", [0, 32])
def test_paged_decode_over_the_gather_cache_of_llama3_2_3b(cuda, window):
    """The gather engine's launch at llama3.2-3b's max_len: B=4 rows of
    one 2048-token block each (H=24, K=8, dh=128), a full row, a
    mid-length one, an idle one (len 1) and a short one, against the
    plain version (split_schedule(nb=1, block=2048, ...))."""
    g = torch.Generator(device=cuda).manual_seed(7)
    B, H, K, dh, S = 4, 24, 8, 128, 2048
    kc, vc = (torch.randn(B, S, K, dh, generator=g, device=cuda)
              .to(torch.bfloat16) for _ in range(2))
    q = torch.randn(B, H, dh, generator=g, device=cuda).to(torch.bfloat16)
    tables = torch.arange(B, dtype=torch.int32, device=cuda)[:, None]
    lens = torch.tensor([2048, 1056, 1, 300], dtype=torch.int32,
                        device=cuda)
    out = P.paged_decode(q, kc, vc, tables, lens, window=window)
    ref = P.paged_decode_plain(q, kc, vc, tables, lens, window=window)
    assert float((out.float() - ref.float()).abs().max()) < TOL


@pytest.mark.cuda
def test_gather_engine_on_card_matches_cpu(cuda):
    """micro through Engine(paged=False) on the card and on the CPU: two
    sessions, a park, a resume with a delta, a round the resumed slot
    sits out, more decoding and a release give the same ids and the same
    host state (slot lengths, block tables, free list, copy bytes)."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.serving.engine import Engine

    cfg = get_config("micro")
    cpu = lm.init_params(cfg, seed=3, device="cpu")
    rng = np.random.RandomState(3)
    a, b, tool = (rng.randint(1, cfg.vocab, n).astype(np.int32)
                  for n in (37, 20, 11))
    runs = []
    for p in (cpu, _to(cpu, cuda)):
        eng = Engine(cfg, p, n_slots=3, max_len=96, pool_blocks=12,
                     block_size=8, paged=False)
        sa = eng.start_session("a", a, cached_hit=False)
        sb = eng.start_session("b", b, cached_hit=False)
        out = eng.decode({sa: int(a[-1]), sb: int(b[-1])}, n_steps=4)
        ids = [out[sa], out[sb]]
        assert eng.park_session("a")
        ctx = np.concatenate([a, np.asarray(ids[0], np.int32), tool])
        sa = eng.start_session("a", ctx, cached_hit=True)
        ids.append(eng.decode({sb: ids[1][-1]}, n_steps=2)[sb])
        ids.append(eng.decode({sa: int(ctx[-1])}, n_steps=3)[sa])
        assert eng.release_session("b")
        pool = eng.pool
        runs.append((ids, dict(pool.tables), dict(pool.lens),
                     list(pool.free),
                     [(s.session_id, s.length) for s in eng.slots],
                     eng.park_copy_bytes, eng.resume_copy_bytes))
    assert runs[1] == runs[0]
    assert runs[1][-2] > 0 and runs[1][-1] > 0


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)
