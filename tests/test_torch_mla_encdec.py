"""deepseek-v2's MLA and seamless's encoder-decoder in the port
(``repro_torch.models.{layers,lm,encdec}``) against the JAX package, on
the same carried params (``lm.params_from_jax``) and the same inputs drawn
with numpy: the parameter bridge is bit-exact and ``init_params`` gives the
reference's tree; ``mla_attention_full`` / ``mla_attention_decode`` and the
cross-attention agree at tiny width; ``lm.prefill``, ``forward_logits``
and four ``decode_step``s agree for ``deepseek-v2-tiny`` (held to the
reference's router picks, ``torch_routing.SameRouting``) and
``seamless-tiny`` (16 and 24 frames: prefill's last logits, every cache
entry, the decode steps' logits and self caches); their training loss
and gradients are held in tests/test_torch_forward_train.py.  Tolerance:
the lm tests' bf16 2e-2, relative to the largest magnitude where that
passes 1 (tests/test_kernels.py)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)           # tiny shapes: threads only add overhead

from repro.configs import deepseek_v2_236b, seamless_m4t_large_v2  # noqa
from repro.models import encdec as jencdec  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models.sharding import ShardingEnv  # noqa: E402
from repro_torch.configs import deepseek_v2_236b as tds  # noqa: E402
from repro_torch.configs import seamless_m4t_large_v2 as tsm  # noqa: E402
from repro_torch.models import encdec as tencdec  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from torch_routing import SameRouting  # noqa: E402

TOL = 2e-2
ENV = ShardingEnv(None, opts={"remat": False, "sp": False,
                              "moe_impl": "dense"})
# the reference's layers unrolled, so its router picks are concrete
ENV_UNROLLED = ShardingEnv(None, opts={"remat": False, "sp": False,
                                       "moe_impl": "dense",
                                       "unroll_layers": True})
CONFIGS = {"deepseek-v2-tiny": (deepseek_v2_236b.tiny(), tds.tiny()),
           "seamless-tiny": (seamless_m4t_large_v2.tiny(), tsm.tiny())}
MLA, ENCDEC = "deepseek-v2-tiny", "seamless-tiny"


@functools.lru_cache(maxsize=None)
def _carry(name, seed):
    """The reference's params for ``name`` and their carry to the port,
    made once a module (the tests only read them)."""
    cj, ct = CONFIGS[name]
    pj = jlm.init_params(cj, jax.random.PRNGKey(seed))
    pt = tlm.params_from_jax(jax.tree_util.tree_map(np.asarray, pj), "cpu")
    return cj, ct, pj, pt


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.array(jnp.asarray(x).astype(jnp.float32))


def _err(a, b) -> float:
    return float(np.max(np.abs(_np(a) - _np(b))))


def _close(a, b) -> bool:
    """Within TOL, relative to b's largest magnitude where that passes 1."""
    return _err(a, b) < TOL * max(1.0, float(np.max(np.abs(_np(b)))))


def _bf16(a: np.ndarray):
    """The same bf16 values for each framework."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.array(j).view(np.int16)).view(
        torch.bfloat16)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def _encdec_batch(cj, B, n_frames, toks):
    """frames (B, n_frames, d_model): bf16 normals x 0.02, the reference's
    front-end stub, drawn with numpy; and the target tokens."""
    fj, ft = _bf16(np.random.RandomState(n_frames).randn(
        B, n_frames, cj.d_model) * 0.02)
    return ({"frames": fj, "tgt_tokens": jnp.asarray(toks)},
            {"frames": ft, "tgt_tokens": torch.from_numpy(toks)})


# --- parameters --------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_params_from_jax_is_bit_exact(name):
    _, _, pj, pt = _carry(name, 0)
    flat_j = {tuple(k.key for k in path): leaf for path, leaf
              in jax.tree_util.tree_flatten_with_path(pj)[0]}
    flat_t = dict(_leaves(pt))
    assert sorted(flat_t) == sorted(flat_j)
    for key, leaf in flat_j.items():
        a, t = np.asarray(leaf), flat_t[key]
        assert a.dtype.name == "bfloat16" and t.dtype == torch.bfloat16, key
        assert tuple(t.shape) == a.shape, key
        assert np.array_equal(t.view(torch.int16).numpy(),
                              a.view(np.int16)), key


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_init_params_shapes_match_the_reference_tree(name):
    cj, ct, pj, _ = _carry(name, 0)
    pt = tlm.init_params(ct, seed=0, device="cpu")
    shapes_j = jax.tree_util.tree_map(lambda a: (a.shape, str(a.dtype)), pj)
    shapes_t = jax.tree_util.tree_map(
        lambda t: (tuple(t.shape), str(t.dtype).removeprefix("torch.")), pt)
    assert shapes_t == shapes_j
    assert torch.equal(pt["embed"], tlm.init_params(
        ct, seed=0, device="cpu")["embed"])             # seeded


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_init_cache_matches_the_reference(name):
    cj, ct = CONFIGS[name]
    cache_j = jlm.init_cache(cj, 2, 12, src_len=20)
    cache_t = tlm.init_cache(ct, 2, 12, device="cpu", src_len=20)
    assert sorted(cache_t) == sorted(cache_j)
    for key, a in cache_j.items():
        assert tuple(cache_t[key].shape) == a.shape, key
        assert cache_t[key].dtype == torch.bfloat16 and not \
            cache_t[key].any(), key


# --- the layers --------------------------------------------------------------
def _layer0(pj, pt, key):
    return (jax.tree_util.tree_map(lambda a: a[0], pj["layers"][key]),
            tlm._layer(pt["layers"][key], 0))


def test_mla_attention_full_matches_jax():
    cj, ct, pj, pt = _carry(MLA, 1)
    aj, at = _layer0(pj, pt, "attn")
    xj, xt = _bf16(np.random.RandomState(5).randn(2, 24, cj.d_model))
    positions = np.arange(24, dtype=np.int32)[None]
    yj, ckv_j, kr_j = jl.mla_attention_full(xj, aj, cj, ENV,
                                            jnp.asarray(positions))
    yt, ckv_t, kr_t = tl.mla_attention_full(xt, at, ct,
                                            torch.from_numpy(positions))
    assert yt.dtype == torch.bfloat16 and yt.shape == yj.shape
    assert ckv_t.shape == ckv_j.shape and kr_t.shape == kr_j.shape
    assert _close(yt, yj)
    assert _close(ckv_t, ckv_j) and _close(kr_t, kr_j)


def test_mla_attention_decode_matches_jax():
    """From a random latent cache, per-row positions: the written entries
    and the output agree; the rest of the caches is untouched."""
    cj, ct, pj, pt = _carry(MLA, 1)
    aj, at = _layer0(pj, pt, "attn")
    rng = np.random.RandomState(6)
    B, S = 3, 16
    xj, xt = _bf16(rng.randn(B, 1, cj.d_model))
    cj_, ct_ = _bf16(rng.randn(B, S, cj.kv_lora_rank))
    rj, rt = _bf16(rng.randn(B, S, cj.qk_rope_head_dim))
    pos = np.asarray([9, 15, 0], np.int32)
    yj, cj2, rj2 = jl.mla_attention_decode(xj, aj, cj, ENV, cj_, rj,
                                           jnp.asarray(pos))
    before = ct_.clone(), rt.clone()
    yt, ct2, rt2 = tl.mla_attention_decode(xt, at, ct, ct_, rt,
                                           torch.from_numpy(pos))
    assert yt.shape == yj.shape and _close(yt, yj)
    assert _close(ct2, cj2) and _close(rt2, rj2)
    rows = np.arange(B)
    for new, old in zip((ct2, rt2), before):
        keep = np.ones((B, S), bool)
        keep[rows, pos] = False
        assert torch.equal(new[torch.from_numpy(keep)],
                           old[torch.from_numpy(keep)])


def test_cross_attention_matches_jax():
    """The decoder's cross-attention: prefill (``kv_override``: q roped at
    the target positions, the cross K/V unroped) and one decode step over
    the frozen cross cache, against the reference's."""
    cj, ct, pj, pt = _carry(ENCDEC, 1)
    lj = jax.tree_util.tree_map(lambda a: a[0], pj["dec_layers"]["cross"])
    lt = tlm._layer(pt["dec_layers"]["cross"], 0)
    rng = np.random.RandomState(7)
    B, St, Ss = 2, 10, 18
    xj, xt = _bf16(rng.randn(B, St, cj.d_model))
    ej, et = _bf16(rng.randn(B, Ss, cj.d_model))
    ckj, cvj = jencdec._cross_kv(lj, ej, cj, ENV)
    ckt, cvt = tencdec._cross_kv(lt, et)
    assert _close(ckt, ckj) and _close(cvt, cvj)
    positions = np.arange(St, dtype=np.int32)[None]
    yj, _, _ = jl.gqa_attention_full(xj, lj, cj, ENV, jnp.asarray(positions),
                                     causal=False, kv_override=(ckj, cvj))
    yt, _, _ = tl.gqa_attention_full(xt, lt, ct, torch.from_numpy(positions),
                                     causal=False, kv_override=(ckt, cvt))
    assert _close(yt, yj)
    # one decode step at per-row positions, as encdec.decode_step runs it
    pos = np.asarray([St, 3], np.int32)
    q = jnp.einsum("bsd,dhx->bshx", xj[:, :1], lj["wq"])
    q = jl.apply_rope(q, jnp.asarray(pos)[:, None], cj.rope_theta)
    yj = jnp.einsum("bshx,hxd->bsd", jl.decode_attention(
        q, ckj, cvj, jnp.full((B,), Ss - 1)), lj["wo"])
    yt = tl.cross_attention_decode(xt[:, :1], lt, ct, ckt, cvt,
                                   torch.from_numpy(pos))
    assert yt.shape == yj.shape and _close(yt, yj)


# --- deepseek-v2-tiny through the model entry points -------------------------
@pytest.mark.parametrize("S", [24, 70])
def test_mla_prefill_matches_jax(S, monkeypatch):
    cj, ct, pj, pt = _carry(MLA, 1)
    SameRouting(monkeypatch)
    toks = np.random.RandomState(S).randint(1, cj.vocab, size=(2, S))
    last_j, cache_j = jlm.prefill(pj, {"tokens": jnp.asarray(toks)}, cj,
                                  ENV_UNROLLED, max_len=96)
    last_t, cache_t = tlm.prefill(pt, {"tokens": torch.from_numpy(toks)},
                                  ct, max_len=96)
    assert last_t.dtype == torch.float32 and last_t.shape == last_j.shape
    assert _err(last_t, last_j) < TOL
    assert sorted(cache_t) == sorted(cache_j) == ["ckv", "krope"]
    for key in cache_j:
        assert tuple(cache_t[key].shape) == cache_j[key].shape, key
        assert cache_t[key].dtype == torch.bfloat16, key
        assert _close(cache_t[key], cache_j[key]), key
        assert not cache_t[key][:, :, S:].any()             # zero padding


def test_mla_forward_logits_matches_jax(monkeypatch):
    cj, ct, pj, pt = _carry(MLA, 1)
    SameRouting(monkeypatch)
    toks = np.random.RandomState(2).randint(0, cj.vocab, size=(2, 30))
    full_j = jlm.forward_logits(pj, {"tokens": jnp.asarray(toks)}, cj,
                                ENV_UNROLLED)
    full_t = tlm.forward_logits(pt, {"tokens": torch.from_numpy(toks)}, ct)
    assert full_t.dtype == torch.float32 and full_t.shape == full_j.shape
    assert _err(full_t, full_j) < TOL


def test_mla_decode_steps_match_jax(monkeypatch):
    """Prefill, then four decode steps over the latent cache at per-row
    positions: logits and both cache entries agree after each step."""
    cj, ct, pj, pt = _carry(MLA, 1)
    routing = SameRouting(monkeypatch)
    rng = np.random.RandomState(5)
    B, S = 2, 10
    toks = rng.randint(1, cj.vocab, size=(B, S + 4))
    _, cache_j = jlm.prefill(pj, {"tokens": jnp.asarray(toks[:, :S])}, cj,
                             ENV_UNROLLED, max_len=S + 6)
    _, cache_t = tlm.prefill(pt, {"tokens": torch.from_numpy(toks[:, :S])},
                             ct, max_len=S + 6)
    pos = np.asarray([S, S - 2], np.int32)
    for step in range(4):
        tok = toks[:, S + step:S + step + 1]
        lj, cache_j = jlm.decode_step(pj, jnp.asarray(tok), cache_j,
                                      jnp.asarray(pos), cj, ENV_UNROLLED)
        lt, cache_t = tlm.decode_step(pt, torch.from_numpy(tok), cache_t,
                                      torch.from_numpy(pos), ct)
        assert lt.dtype == torch.float32 and lt.shape == lj.shape
        assert _err(lt, lj) < TOL, step
        for key in cache_j:
            assert _close(cache_t[key], cache_j[key]), (step, key)
        pos = pos + 1
    assert not routing.calls                  # every pick was replayed


# --- seamless-tiny through the model entry points ----------------------------
@pytest.mark.parametrize("n_frames", [16, 24])
def test_encdec_prefill_matches_jax(n_frames):
    """Prefill's last logits and every cache entry: the self K/V padded
    to max_len with zeros, the cross K/V over the frames."""
    cj, ct, pj, pt = _carry(ENCDEC, 1)
    B, St = 2, 12
    toks = np.random.RandomState(n_frames).randint(1, cj.vocab,
                                                   size=(B, St))
    bj, bt = _encdec_batch(cj, B, n_frames, toks)
    last_j, cache_j = jlm.prefill(pj, bj, cj, ENV, max_len=St + 6)
    last_t, cache_t = tlm.prefill(pt, bt, ct, max_len=St + 6)
    assert last_t.dtype == torch.float32 and last_t.shape == last_j.shape
    assert _err(last_t, last_j) < TOL
    assert sorted(cache_t) == sorted(cache_j)
    for key in cache_j:
        assert tuple(cache_t[key].shape) == cache_j[key].shape, key
        assert cache_t[key].dtype == torch.bfloat16, key
        assert _close(cache_t[key], cache_j[key]), key
    assert cache_t["cross_k"].shape[2] == n_frames
    for key in ("k", "v"):
        assert not cache_t[key][:, :, St:].any()             # zero padding


@pytest.mark.parametrize("n_frames", [16, 24])
def test_encdec_forward_logits_matches_jax(n_frames):
    cj, ct, pj, pt = _carry(ENCDEC, 1)
    toks = np.random.RandomState(3).randint(0, cj.vocab, size=(2, 14))
    bj, bt = _encdec_batch(cj, 2, n_frames, toks)
    full_j = jlm.forward_logits(pj, bj, cj, ENV)
    full_t = tlm.forward_logits(pt, bt, ct)
    assert full_t.dtype == torch.float32 and full_t.shape == full_j.shape
    assert _err(full_t, full_j) < TOL


@pytest.mark.parametrize("n_frames", [16, 24])
def test_encdec_decode_steps_match_jax(n_frames):
    """Prefill, then four decode steps: logits and the self K/V agree after
    each step, and the cross K/V stay as the prefill left them."""
    cj, ct, pj, pt = _carry(ENCDEC, 1)
    rng = np.random.RandomState(n_frames + 1)
    B, St = 2, 9
    toks = rng.randint(1, cj.vocab, size=(B, St + 4))
    bj, bt = _encdec_batch(cj, B, n_frames, toks[:, :St])
    _, cache_j = jlm.prefill(pj, bj, cj, ENV, max_len=St + 6)
    _, cache_t = tlm.prefill(pt, bt, ct, max_len=St + 6)
    cross = cache_t["cross_k"].clone(), cache_t["cross_v"].clone()
    for step in range(4):
        tok = toks[:, St + step:St + step + 1]
        lj, cache_j = jlm.decode_step(pj, jnp.asarray(tok), cache_j,
                                      jnp.int32(St + step), cj, ENV)
        lt, cache_t = tlm.decode_step(pt, torch.from_numpy(tok), cache_t,
                                      St + step, ct)
        assert lt.dtype == torch.float32 and lt.shape == lj.shape
        assert _err(lt, lj) < TOL, step
        for key in cache_j:
            assert _close(cache_t[key], cache_j[key]), (step, key)
    assert torch.equal(cache_t["cross_k"], cross[0])
    assert torch.equal(cache_t["cross_v"], cross[1])
