"""The port's recurrences and the layers of its ssm (rwkv6) and hybrid
(jamba) paths against the JAX package, on the same numpy inputs.

On the CPU the ``wkv6`` and ``mamba_scan`` wrappers run their plain
versions; these hold them against the Pallas kernels in interpret mode
(as tests/test_kernels.py runs them), the reference's jnp oracles and the
model's own scans (tests/test_torch_cuda.py holds the Hopper kernels
against the plain versions on a card).  Tolerances: tests/test_kernels.py's
1e-3 for wkv6 and 1e-4 for the f32 mamba scan; bf16 layer outputs 2e-2
(its bf16 TOL), relative to the largest magnitude where that passes 1
(``_rel``); f32 states 1e-4 (the same f32 math summed in another
order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)           # tiny shapes: threads only add overhead

from repro.configs import jamba_v0_1_52b, rwkv6_7b  # noqa: E402
from repro.kernels.mamba_scan.ops import mamba_scan as pallas_mamba  # noqa
from repro.kernels.mamba_scan.ref import mamba_scan_ref  # noqa: E402
from repro.kernels.rwkv6.ops import wkv6 as pallas_wkv6  # noqa: E402
from repro.kernels.rwkv6.ref import wkv6_ref  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import mamba as jmamba  # noqa: E402
from repro.models import rwkv as jrwkv  # noqa: E402
from repro.models.sharding import ShardingEnv  # noqa: E402
from repro_torch.configs import jamba_v0_1_52b as tjamba  # noqa: E402
from repro_torch.configs import rwkv6_7b as trwkv  # noqa: E402
from repro_torch.kernels.mamba_scan import ops as M  # noqa: E402
from repro_torch.kernels.rwkv6 import ops as R  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import mamba as tmamba  # noqa: E402
from repro_torch.models import rwkv as trwkv_m  # noqa: E402

TOL = 2e-2
ENV = ShardingEnv(None, opts={"remat": False, "sp": False,
                              "moe_impl": "dense"})


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.array(jnp.asarray(x).astype(jnp.float32))


def _err(a, b) -> float:
    return float(np.max(np.abs(_np(a) - _np(b))))


def _rel(a, b) -> float:
    """Max abs error over the reference's largest magnitude (at least 1):
    for bf16 values that reach past 2, where one rounding is 1.6e-2 or
    more."""
    return _err(a, b) / max(1.0, float(np.max(np.abs(_np(b)))))


def _pair(a, dtype=jnp.float32):
    """The same values as a JAX array and a torch tensor of its type."""
    j = jnp.asarray(a, dtype)
    t = torch.from_numpy(np.array(j.astype(jnp.float32)))
    return j, (t.to(torch.bfloat16) if dtype == jnp.bfloat16 else t)


def _carry_tree(tree):
    return tlm.params_from_jax(jax.tree_util.tree_map(np.asarray, tree),
                               "cpu")


# --- wkv6 ----------------------------------------------------------------------
def _wkv_inputs(rng, B, T, H, dh, rkv_dtype=jnp.float32):
    r = _pair(rng.randn(B, T, H, dh) * 0.5, rkv_dtype)
    k = _pair(rng.randn(B, T, H, dh) * 0.5, rkv_dtype)
    v = _pair(rng.randn(B, T, H, dh), rkv_dtype)
    w = _pair(1 / (1 + np.exp(-rng.randn(B, T, H, dh))) * 0.5 + 0.45)
    u = _pair(rng.randn(H, dh) * 0.3)
    return r, k, v, w, u


@pytest.mark.parametrize("B,T,H,dh,chunk", [
    (2, 128, 2, 16, 32), (1, 64, 4, 64, 64), (2, 96, 2, 32, 32),
])
def test_wkv6_plain_matches_pallas_and_ref(B, T, H, dh, chunk):
    """tests/test_kernels.py::test_wkv6's shapes and tolerance."""
    ins = _wkv_inputs(np.random.RandomState(T + dh), B, T, H, dh)
    js, ts = zip(*ins)
    out, s_T = R.wkv6(*ts)
    assert out.dtype == torch.float32 and out.shape == (B, T, H, dh)
    assert s_T.shape == (B, H, dh, dh)
    assert _err(out, pallas_wkv6(*js, chunk=chunk)) < 1e-3
    assert _err(out, wkv6_ref(*js)) < 1e-3


@pytest.mark.parametrize("T", [1, 40])
def test_wkv6_plain_with_state_matches_model_scan(T):
    """bf16 r/k/v and f32 w as the model passes them, a non-zero state in:
    outputs and the final state against repro.models.rwkv._wkv6_scan."""
    rng = np.random.RandomState(T)
    B, H, dh = 2, 3, 16
    (rj, rt), (kj, kt), (vj, vt), (wj, wt), (uj, ut) = _wkv_inputs(
        rng, B, T, H, dh, jnp.bfloat16)
    sj, st = _pair(rng.randn(B, H, dh, dh))
    out_j, s_j = jrwkv._wkv6_scan(rj, kj, vj, wj, uj, sj)
    out_t, s_t = R.wkv6(rt, kt, vt, wt, ut, st)
    assert _err(out_t, out_j) < 1e-3
    assert _err(s_t, s_j) < 1e-3


# --- mamba scan ----------------------------------------------------------------
def _mamba_inputs(rng, B, T, di, ds, dtype=jnp.float32):
    x = _pair(rng.randn(B, T, di), dtype)
    dt = _pair(np.log1p(np.exp(rng.randn(B, T, di))) * 0.1, dtype)
    Bc = _pair(rng.randn(B, T, ds), dtype)
    Cc = _pair(rng.randn(B, T, ds), dtype)
    A_log = np.log(np.broadcast_to(np.arange(1, ds + 1, dtype=np.float32),
                                   (di, ds)))
    return x, dt, Bc, Cc, _pair(A_log), _pair(np.ones(di))


@pytest.mark.parametrize("B,T,di,ds,bd,chunk", [
    (2, 64, 32, 8, 32, 32), (1, 128, 64, 16, 32, 64), (2, 96, 48, 8, 16, 32),
])
def test_mamba_scan_plain_matches_pallas_and_ref(B, T, di, ds, bd, chunk):
    """The f32 mode at tests/test_kernels.py::test_mamba_scan's shapes
    and tolerance.  The port takes A = -exp(A_log) as the model does."""
    (xj, xt), (dj, dt_), (bj, bt), (cj, ct), (aj, at), (Dj, Dt) = \
        _mamba_inputs(np.random.RandomState(T + di), B, T, di, ds)
    y, h_T = M.mamba_scan(xt, dt_, bt, ct, -torch.exp(at), Dt)
    assert y.dtype == torch.float32 and y.shape == (B, T, di)
    assert h_T.shape == (B, di, ds)
    assert _err(y, pallas_mamba(xj, dj, bj, cj, aj, Dj, block_d=bd,
                                chunk=chunk)) < 1e-4
    assert _err(y, mamba_scan_ref(xj, dj, bj, cj, aj, Dj)) < 1e-4


def test_mamba_scan_rounding_mode_matches_model_scan():
    """round_y (bf16 h.C before D*x) on bf16 inputs against
    repro.models.mamba._ssm_scan: y (bf16) and the final state."""
    B, T, di, ds = 2, 48, 32, 8
    (xj, xt), (dj, dt_), (bj, bt), (cj, ct), (aj, at), _ = _mamba_inputs(
        np.random.RandomState(5), B, T, di, ds, jnp.bfloat16)
    Dj, Dt = _pair(np.random.RandomState(6).randn(di), jnp.bfloat16)
    y_j, h_j = jmamba._ssm_scan(xj, dj, bj, cj, -jnp.exp(aj), Dj)
    y_t, h_t = tmamba._ssm_scan(xt, dt_, bt, ct, -torch.exp(at), Dt)
    assert y_t.dtype == torch.bfloat16 and y_t.shape == y_j.shape
    assert _rel(y_t, y_j) < TOL
    assert _err(h_t, h_j) < 1e-4


@pytest.mark.parametrize("round_y", [False, True])
def test_mamba_scan_state_in_continues_the_scan(round_y):
    """The state-in mode: a scan split in two with the state carried
    across is the whole scan, bit for bit (the same operations in the same
    order); decode continues a prefill this way."""
    B, T, di, ds, cut = 2, 20, 16, 8, 13
    (_, x), (_, dt), (_, Bc), (_, Cc), (_, a), (_, D) = _mamba_inputs(
        np.random.RandomState(7), B, T, di, ds, jnp.bfloat16)
    A = -torch.exp(a)
    y, h = M.mamba_scan(x, dt, Bc, Cc, A, D, round_y=round_y)
    y1, h1 = M.mamba_scan(x[:, :cut], dt[:, :cut], Bc[:, :cut], Cc[:, :cut],
                          A, D, round_y=round_y)
    y2, h2 = M.mamba_scan(x[:, cut:], dt[:, cut:], Bc[:, cut:], Cc[:, cut:],
                          A, D, h1, round_y=round_y)
    assert torch.equal(torch.cat([y1, y2], 1), y) and torch.equal(h2, h)


# --- layers on carried tiny params ------------------------------------------------
def _tiny_layer(mod_j, mod_t, pick):
    cj, ct = mod_j.tiny(), mod_t.tiny()
    pj = jlm.init_params(cj, jax.random.PRNGKey(0))
    lj = pick(pj)
    return cj, ct, lj, _carry_tree(lj)


def _rwkv_layer():
    return _tiny_layer(rwkv6_7b, trwkv,
                       lambda p: jax.tree_util.tree_map(lambda a: a[1],
                                                        p["layers"]))


@pytest.mark.parametrize("with_state", [False, True])
def test_rwkv6_time_mix_matches_jax(with_state):
    cj, ct, lj, lt = _rwkv_layer()
    rng = np.random.RandomState(int(with_state))
    B, S, d = 2, 9, cj.d_model
    H, hs = cj.rwkv_n_heads, cj.rwkv_head_size
    xj, xt = _pair(rng.randn(B, S, d), jnp.bfloat16)
    kw_j, kw_t = {}, {}
    if with_state:
        sj, st = _pair(rng.randn(B, d), jnp.bfloat16)
        wj, wt = _pair(rng.randn(B, H, hs, hs) * 0.3)
        kw_j = {"shift_state": sj, "wkv_state": wj}
        kw_t = {"shift_state": st, "wkv_state": wt}
    yj, shj, swj = jrwkv.rwkv6_time_mix(xj, lj["tm"], cj, ENV,
                                        return_state=True, **kw_j)
    yt, sht, swt = trwkv_m.rwkv6_time_mix(xt, lt["tm"], ct,
                                          return_state=True, **kw_t)
    assert yt.dtype == torch.bfloat16 and yt.shape == yj.shape
    assert _err(yt, yj) < TOL
    assert _err(sht, shj) == 0.0                 # the input's last row
    assert _err(swt, swj) < 1e-3


def test_rwkv6_channel_mix_matches_jax():
    cj, ct, lj, lt = _rwkv_layer()
    rng = np.random.RandomState(2)
    xj, xt = _pair(rng.randn(2, 9, cj.d_model), jnp.bfloat16)
    sj, st = _pair(rng.randn(2, cj.d_model), jnp.bfloat16)
    yj, _ = jrwkv.rwkv6_channel_mix(xj, lj["cm"], cj, ENV, shift_state=sj,
                                    return_state=True)
    yt, _ = trwkv_m.rwkv6_channel_mix(xt, lt["cm"], ct, shift_state=st,
                                      return_state=True)
    assert _err(yt, yj) < TOL


def _jamba_part(key):
    return _tiny_layer(
        jamba_v0_1_52b, tjamba,
        lambda p: jax.tree_util.tree_map(lambda a: a[0, 1],
                                         p["superblocks"][key]))


@pytest.mark.parametrize("decode", [False, True])
def test_mamba_layer_matches_jax(decode):
    """Full sequence (the rounding scan from zero) and decode (one token,
    conv and ssm states in: the state-in mode of the scan)."""
    cj, ct, lj, lt = _jamba_part("mamba")
    rng = np.random.RandomState(3)
    B, S = 2, (1 if decode else 10)
    di, ds = cj.mamba_d_inner, cj.mamba_d_state
    xj, xt = _pair(rng.randn(B, S, cj.d_model), jnp.bfloat16)
    kw_j, kw_t = {}, {}
    if decode:
        cj_, ct_ = _pair(rng.randn(B, cj.mamba_d_conv - 1, di),
                         jnp.bfloat16)
        sj, st = _pair(rng.randn(B, di, ds) * 0.5)
        kw_j = {"conv_state": cj_, "ssm_state": sj}
        kw_t = {"conv_state": ct_, "ssm_state": st}
    yj, cvj, hj = jmamba.mamba_layer(xj, lj, cj, ENV, return_state=True,
                                     **kw_j)
    yt, cvt, ht = tmamba.mamba_layer(xt, lt, ct, return_state=True, **kw_t)
    assert yt.shape == yj.shape and _err(yt, yj) < TOL
    assert tuple(cvt.shape) == cvj.shape and _err(cvt, cvj) < TOL
    assert _err(ht, hj) < TOL


def test_moe_block_dense_matches_jax():
    cj, ct, lj, lt = _jamba_part("moe")
    xj, xt = _pair(np.random.RandomState(4).randn(2, 7, cj.d_model),
                   jnp.bfloat16)
    yj = jl.moe_block(xj, lj, cj, ENV, impl="dense")
    yt = tl.moe_block(xt, lt, ct)
    assert yt.dtype == torch.bfloat16 and _err(yt, yj) < TOL
    # without a mesh every impl is the dense one, as in the reference
    assert torch.equal(tl.moe_block(xt, lt, ct, impl="ep"), yt)


def test_moe_router_top_k_agrees_away_from_near_ties():
    """Top-k expert ids agree wherever the reference's k-th vs (k+1)-th
    probability gap exceeds the cross-framework probability difference;
    a flip inside that margin is a bf16 near-tie, not a fault."""
    cj, ct, lj, lt = _jamba_part("moe")
    xj, xt = _pair(np.random.RandomState(8).randn(64, cj.d_model),
                   jnp.bfloat16)
    pj, ej = jl.moe_router(xj, lj["router"], cj.top_k)
    pt, et = tl.moe_router(xt, lt["router"], ct.top_k)
    probs_j = np.asarray(jax.nn.softmax(
        (xj @ lj["router"]).astype(jnp.float32), axis=-1))
    probs_t = torch.softmax((xt @ lt["router"]).float(), -1).numpy()
    diff = np.abs(probs_j - probs_t).max(axis=-1)
    srt = -np.sort(-probs_j, axis=-1)
    gap = srt[:, cj.top_k - 1] - srt[:, cj.top_k]
    clear = gap > 2 * diff
    assert clear.mean() > 0.9
    ids_j = np.sort(np.asarray(ej), -1)
    ids_t = np.sort(et.numpy(), -1)
    assert np.array_equal(ids_t[clear], ids_j[clear])
    assert _err(pt[torch.from_numpy(clear)], np.asarray(pj)[clear]) < TOL


def test_gqa_attention_decode_matches_jax():
    """jamba's decode attention over a contiguous cache, read by the paged
    kernels' plain versions as one block per row, against the reference's
    dynamic-update-slice insert + decode_attention; rows at different
    positions."""
    cj, ct, _, _ = _jamba_part("mamba")
    pj = jlm.init_params(cj, jax.random.PRNGKey(0))
    aj = jax.tree_util.tree_map(lambda a: a[0], pj["superblocks"]["attn"])
    at = _carry_tree(aj)
    rng = np.random.RandomState(9)
    B, S, K, dh = 2, 24, cj.n_kv_heads, cj.head_dim
    xj, xt = _pair(rng.randn(B, 1, cj.d_model), jnp.bfloat16)
    kj, kt = _pair(rng.randn(B, S, K, dh), jnp.bfloat16)
    vj, vt = _pair(rng.randn(B, S, K, dh), jnp.bfloat16)
    pos = np.asarray([17, 4], np.int32)
    yj, kj2, vj2 = jl.gqa_attention_decode(xj, aj, cj, ENV, kj, vj,
                                           jnp.asarray(pos))
    yt, kt2, vt2 = tl.gqa_attention_decode(xt, at, ct, kt, vt,
                                           torch.from_numpy(pos))
    assert yt.shape == yj.shape and _err(yt, yj) < TOL
    assert _err(kt2, kj2) < TOL and _err(vt2, vj2) < TOL


def test_init_draws_stacked_expert_weights_in_slices(monkeypatch):
    """No randn call is larger than the init's chunk, so jamba's stacked
    expert weights (4 x 16 x 4096 x 14336 per superblock at full width)
    never have a full-size f32 temporary; here with the chunk cut to 4096
    elements on jamba-tiny."""
    sizes = []
    real = torch.randn

    def spy(size, **kw):
        sizes.append(int(np.prod(size)))
        return real(size, **kw)

    monkeypatch.setattr(tlm._Init, "CHUNK", 4096)
    monkeypatch.setattr(torch, "randn", spy)
    cfg = tjamba.tiny()
    params = tlm.init_params(cfg, 0, device="cpu")
    w1 = params["superblocks"]["moe"]["w1"]
    assert w1.numel() > 4096 and max(sizes) <= 4096
    assert 0.015 < float(w1.float().std()) < 0.025
