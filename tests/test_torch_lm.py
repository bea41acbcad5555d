"""The port's model code (``repro_torch.models.lm``) against the JAX
reference on the same carried params: the parameter bridge is bit-exact,
and prefill agrees within the bf16 tolerance 2e-2 (tests/test_kernels.py)
for ``micro``, ``llama3.2-tiny`` (tied embeddings), ``mixtral-tiny``
(moe, a window of 32 that S = 70 passes), ``llava-tiny`` (vlm, an empty
patch stream; 8 patches in the vlm tests), ``rwkv6-tiny`` (ssm) and
``jamba-tiny`` (hybrid); paged decode and the contiguous-cache
``decode_step`` for the four uniform ones, and ``decode_step`` over
carried states for the ssm and hybrid ones.  The MoE configs are held to
the reference's router picks (``torch_routing.SameRouting``).  bf16
states that reach past 2 (rwkv's token-shift states are normed
activations) are held to 2e-2 of their largest magnitude, since one bf16
rounding there is 1.6e-2 or more."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)           # tiny shapes: threads only add overhead

from repro.configs import (get_config, jamba_v0_1_52b, llama3_2_3b,  # noqa
                           llava_next_34b, load_all, mixtral_8x22b, rwkv6_7b)
from repro.models import lm as jlm  # noqa: E402
from repro.models.sharding import ShardingEnv  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.configs import jamba_v0_1_52b as tjamba  # noqa: E402
from repro_torch.configs import llama3_2_3b as tllama  # noqa: E402
from repro_torch.configs import llava_next_34b as tllava  # noqa: E402
from repro_torch.configs import mixtral_8x22b as tmixtral  # noqa: E402
from repro_torch.configs import rwkv6_7b as trwkv  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from torch_routing import SameRouting  # noqa: E402

load_all()
TOL = 2e-2
ENV = ShardingEnv(None, opts={"remat": False, "sp": False,
                              "moe_impl": "dense"})
CONFIGS = {"micro": (get_config("micro"), tget("micro")),
           "llama3.2-tiny": (llama3_2_3b.tiny(), tllama.tiny()),
           "rwkv6-tiny": (rwkv6_7b.tiny(), trwkv.tiny()),
           "jamba-tiny": (jamba_v0_1_52b.tiny(), tjamba.tiny()),
           "mixtral-tiny": (mixtral_8x22b.tiny(), tmixtral.tiny()),
           "llava-tiny": (llava_next_34b.tiny(), tllava.tiny())}
UNIFORM = ["llama3.2-tiny", "llava-tiny", "micro", "mixtral-tiny"]
STATEFUL = ["jamba-tiny", "rwkv6-tiny"]        # decode_step's families


ENV_UNROLLED = ShardingEnv(None, opts={"remat": False, "sp": False,
                                       "moe_impl": "dense",
                                       "unroll_layers": True})


def _env(name, monkeypatch):
    """The reference's env for ``name``; for the MoE configs (jamba,
    mixtral), with its layers unrolled and the port held to its picks
    (``torch_routing.SameRouting``)."""
    return _routed(name, monkeypatch)[0]


def _routed(name, monkeypatch):
    """``_env``'s env and its ``SameRouting`` (None without MoE)."""
    if not CONFIGS[name][0].n_experts:
        return ENV, None
    return ENV_UNROLLED, SameRouting(monkeypatch)


def _batch(name, toks, n_patches=0):
    """The same batch for each framework: tokens, and for vlm a patch
    stream (B, n_patches, d_model) of bf16 normals x 0.02 drawn with
    numpy; empty, as the engine serves text, unless asked."""
    cj = CONFIGS[name][0]
    bj, bt = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    if cj.family == "vlm":
        pa = np.random.RandomState(n_patches).randn(
            toks.shape[0], n_patches, cj.d_model).astype(np.float32) * 0.02
        bj["patches"] = jnp.asarray(pa, jnp.bfloat16)
        bt["patches"] = torch.from_numpy(_np(bj["patches"])).to(
            torch.bfloat16)
    return bj, bt


def _carry(name, seed):
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


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_params_from_jax_is_bit_exact(name):
    _, _, pj, pt = _carry(name, 0)
    flat_j = jax.tree_util.tree_flatten_with_path(pj)[0]
    assert len(flat_j) == sum(1 for _ in _leaves(pt))
    for path, leaf in flat_j:
        keys = [k.key for k in path]
        t = pt
        for k in keys:
            t = t[k]
        a = np.asarray(leaf)
        assert tuple(t.shape) == a.shape, keys
        bits = {"bfloat16": (torch.bfloat16, torch.int16, np.int16),
                "float32": (torch.float32, torch.int32, np.int32)}
        tdt, tint, nint = bits[a.dtype.name]         # mamba's A_log: f32
        assert t.dtype == tdt, keys
        assert np.array_equal(t.view(tint).numpy(), a.view(nint)), keys


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def test_params_from_jax_takes_numpy_only():
    with pytest.raises(TypeError, match="numpy"):
        tlm.params_from_jax({"embed": [1.0, 2.0]}, "cpu")


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("S", [24, 70])
def test_prefill_matches_jax(name, S, monkeypatch):
    cj, ct, pj, pt = _carry(name, 1)
    env = _env(name, monkeypatch)
    toks = np.random.RandomState(S).randint(1, cj.vocab, size=(2, S))
    bj, bt = _batch(name, toks)
    last_j, cache_j = jlm.prefill(pj, bj, cj, env, max_len=96)
    last_t, cache_t = tlm.prefill(pt, bt, ct, max_len=96)
    assert last_t.dtype == torch.float32 and last_t.shape == last_j.shape
    assert _err(last_t, last_j) < TOL
    assert sorted(cache_t) == sorted(cache_j)
    for key in cache_j:
        assert tuple(cache_t[key].shape) == cache_j[key].shape, key
        assert cache_t[key].dtype == _TDT[str(cache_j[key].dtype)], key
        assert _close(cache_t[key], cache_j[key]), key
    for key in set(cache_j) & {"k", "v"}:
        assert not cache_t[key][:, :, S:].any()             # zero padding


_TDT = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@pytest.mark.parametrize("name", STATEFUL)
def test_decode_step_matches_jax(name, monkeypatch):
    """Prefill, then three decode steps carrying the cache (rwkv's states;
    jamba's mamba states and its attention slot's contiguous cache):
    logits and every cache entry agree after each step."""
    cj, ct, pj, pt = _carry(name, 4)
    env = _env(name, monkeypatch)
    rng = np.random.RandomState(5)
    S, B = 10, 2
    toks = rng.randint(1, cj.vocab, size=(B, S + 3))
    _, cache_j = jlm.prefill(pj, {"tokens": jnp.asarray(toks[:, :S])}, cj,
                             env, max_len=S + 4)
    _, cache_t = tlm.prefill(pt, {"tokens": torch.from_numpy(toks[:, :S])},
                             ct, max_len=S + 4)
    for step in range(3):
        tok = toks[:, S + step:S + step + 1]
        lj, cache_j = jlm.decode_step(pj, jnp.asarray(tok), cache_j,
                                      jnp.int32(S + step), cj, env)
        lt, cache_t = tlm.decode_step(pt, torch.from_numpy(tok), cache_t,
                                      S + step, ct)
        assert lt.dtype == torch.float32 and lt.shape == lj.shape
        assert _err(lt, lj) < TOL, step
        for key in cache_j:
            assert _close(cache_t[key], cache_j[key]), (step, key)


@pytest.mark.parametrize("name", STATEFUL)
def test_prefill_decode_matches_full_forward(name):
    """The port alone, as tests/test_models_smoke.py holds the reference:
    prefill(S-1) + decode(1) == forward_logits(S), within 1e-2 and 2e-2."""
    _, ct, _, pt = _carry(name, 0)
    B, S = 2, 12
    toks = torch.from_numpy(np.random.RandomState(1).randint(
        0, ct.vocab, size=(B, S)))
    full = tlm.forward_logits(pt, {"tokens": toks}, ct)
    assert full.shape == (B, S, ct.vocab) and bool(full.isfinite().all())
    last, cache = tlm.prefill(pt, {"tokens": toks[:, :S - 1]}, ct,
                              max_len=S + 2)
    assert float((last[:, 0] - full[:, -2]).abs().max()) < 1e-2
    logits, _ = tlm.decode_step(pt, toks[:, S - 1:S], cache, S - 1, ct)
    assert float((logits[:, 0] - full[:, -1]).abs().max()) < 2e-2


@pytest.mark.parametrize("name", UNIFORM)
def test_decode_step_paged_matches_jax(name, monkeypatch):
    """Three decode steps over random pool contents, with one idle row on
    the drop sentinel: logits and the updated pools agree."""
    cj, ct, pj, pt = _carry(name, 2)
    env = _env(name, monkeypatch)
    rng = np.random.RandomState(3)
    L, K, dh, blk, NB = cj.n_layers, cj.n_kv_heads, cj.head_dim, 4, 10
    pools = [jnp.asarray(rng.randn(L, NB, blk, K, dh) * 0.5, jnp.bfloat16)
             for _ in range(2)]
    kj, vj = pools
    kt, vt = (torch.from_numpy(_np(p)).to(torch.bfloat16) for p in pools)
    tables = np.asarray([[0, 1, 2], [3, 4, 5], [6, 7, 8]], np.int32)
    pos = np.asarray([5, 9, 0], np.int32)
    for step in range(3):
        toks = rng.randint(1, cj.vocab, size=(3, 1)).astype(np.int32)
        ablk = tables[np.arange(3), pos // blk].copy()
        ablk[2] = NB                                     # idle row
        aoff = (pos % blk).astype(np.int32)
        lj, kj, vj = jlm.decode_step_paged(
            pj, jnp.asarray(toks), kj, vj, jnp.asarray(tables),
            jnp.asarray(pos), jnp.asarray(ablk), jnp.asarray(aoff), cj, env)
        T = torch.from_numpy
        lt, kt, vt = tlm.decode_step_paged(
            pt, T(toks).long(), kt, vt, T(tables), T(pos), T(ablk),
            T(aoff), ct)
        assert lt.dtype == torch.float32 and lt.shape == lj.shape
        assert _err(lt[:2], lj[:2]) < TOL, step        # active rows
        assert _err(kt, kj) < TOL and _err(vt, vj) < TOL, step
        pos = pos + np.asarray([1, 1, 0], np.int32)


@pytest.mark.parametrize("name", ["jamba-tiny", "llama3.2-tiny",
                                  "llava-tiny", "mixtral-tiny",
                                  "rwkv6-tiny"])
def test_init_params_shapes_match_the_reference_tree(name):
    cj, ct, pj, _ = _carry(name, 0)
    pt = tlm.init_params(ct, seed=0, device="cpu")
    shapes_j = jax.tree_util.tree_map(lambda a: (a.shape, str(a.dtype)), pj)
    shapes_t = jax.tree_util.tree_map(
        lambda t: (tuple(t.shape), str(t.dtype).removeprefix("torch.")), pt)
    assert shapes_t == shapes_j
    again = tlm.init_params(ct, seed=0, device="cpu")
    assert torch.equal(pt["embed"], again["embed"])     # seeded


@pytest.mark.parametrize("name", UNIFORM)
def test_dense_decode_step_matches_jax(name, monkeypatch):
    """The uniform families' contiguous-cache ``decode_step`` (the gather
    engine's): from the reference's prefill cache, carried bit-exactly,
    three steps at per-row positions, the last row at position 0 as the
    engine's idle rows are.  Logits agree within TOL.  The caches are bit-identical in bf16
    but for what the steps wrote past the first layer: there the residual
    stream has been through one layer of each framework's rounding, and
    the written K/V may sit one bf16 step apart (seen: 2^-9, 2^-10), held
    to TOL."""
    cj, ct, pj, pt = _carry(name, 2)
    env, routing = _routed(name, monkeypatch)
    rng = np.random.RandomState(7)
    B, S, max_len = 3, 12, 24
    toks = rng.randint(1, cj.vocab, size=(B, S))
    _, cache_j = jlm.prefill(pj, _batch(name, toks)[0], cj, env,
                             max_len=max_len)
    if routing:                    # the port carries this cache: no prefill
        routing.calls.clear()
    cache_t = {k: torch.from_numpy(np.array(a).view(np.int16)).view(
        torch.bfloat16) for k, a in cache_j.items()}
    pos = np.asarray([S, S - 3, 0], np.int32)
    written = np.zeros((B, max_len), bool)
    for step in range(3):
        tok = rng.randint(1, cj.vocab, size=(B, 1)).astype(np.int32)
        lj, cache_j = jlm.decode_step(pj, jnp.asarray(tok), cache_j,
                                      jnp.asarray(pos), cj, env)
        lt, cache_t = tlm.decode_step(pt, torch.from_numpy(tok).long(),
                                      cache_t, torch.from_numpy(pos), ct)
        assert lt.dtype == torch.float32 and lt.shape == lj.shape
        assert _err(lt, lj) < TOL, step
        written[np.arange(B), pos] = True
        for key in ("k", "v"):
            a = cache_t[key].view(torch.int16).numpy()
            b = np.asarray(cache_j[key]).view(np.int16)
            assert np.array_equal(a[0], b[0]), (step, key)
            assert np.array_equal(a[1:, ~written], b[1:, ~written]), \
                (step, key)
            assert _close(cache_t[key][1:], cache_j[key][1:]), (step, key)
        pos = pos + np.asarray([1, 1, 0], np.int32)


def test_decode_step_refuses_a_position_past_the_cache():
    """The reference clamps such a write to the last slot, the port's
    append would drop it: the port raises instead of parting silently."""
    _, ct, _, pt = _carry("micro", 0)
    cache = tlm.init_cache(ct, 2, 16, device="cpu")
    tok = torch.ones(2, 1, dtype=torch.long)
    tlm.decode_step(pt, tok, cache, torch.tensor([15, 3]), ct)
    with pytest.raises(RuntimeError, match="max_len"):
        tlm.decode_step(pt, tok, cache, torch.tensor([16, 3]), ct)


def test_vlm_patch_stream_matches_jax():
    """llava-tiny with 8 patch embeddings before 12 tokens: the port's
    ``forward_logits`` and ``prefill`` (logits and K/V over all 20
    positions) agree with the reference's; then the port alone, as
    tests/test_models_smoke.py holds the reference: prefill(S-1) +
    ``decode_step`` at position P+S-1 equals ``forward_logits``."""
    cj, ct, pj, pt = _carry("llava-tiny", 3)
    B, S, P = 2, 12, 8
    toks = np.random.RandomState(8).randint(0, cj.vocab, size=(B, S))
    bj, bt = _batch("llava-tiny", toks, n_patches=P)
    full_j = jlm.forward_logits(pj, bj, cj, ENV)
    full = tlm.forward_logits(pt, bt, ct)
    assert full.shape == (B, P + S, ct.vocab) == full_j.shape
    assert _err(full, full_j) < TOL
    last_j, cache_j = jlm.prefill(pj, bj, cj, ENV, max_len=P + S + 2)
    last_t, cache_t = tlm.prefill(pt, bt, ct, max_len=P + S + 2)
    assert _err(last_t, last_j) < TOL
    for key in ("k", "v"):
        assert tuple(cache_t[key].shape) == cache_j[key].shape
        assert _close(cache_t[key], cache_j[key]), key
        assert cache_t[key][:, :, :P + S].any(-1).all()   # every position

    short = {"tokens": bt["tokens"][:, :S - 1], "patches": bt["patches"]}
    last, cache = tlm.prefill(pt, short, ct, max_len=P + S + 2)
    assert float((last[:, 0] - full[:, -2]).abs().max()) < 1e-2
    logits, _ = tlm.decode_step(pt, bt["tokens"][:, S - 1:], cache,
                                P + S - 1, ct)
    assert float((logits[:, 0] - full[:, -1]).abs().max()) < 2e-2


def test_vlm_batch_without_patches_raises():
    """A vlm batch must carry its patch stream, as in the reference (a
    ``KeyError`` there too); it is not read as an empty one."""
    cj, ct, pj, pt = _carry("llava-tiny", 0)
    toks = np.ones((1, 4), np.int64)
    with pytest.raises(KeyError, match="patches"):
        jlm.forward_logits(pj, {"tokens": jnp.asarray(toks)}, cj, ENV)
    for call in (lambda b: tlm.forward_logits(pt, b, ct),
                 lambda b: tlm.prefill(pt, b, ct, max_len=8)):
        with pytest.raises(KeyError, match="patches"):
            call({"tokens": torch.from_numpy(toks)})
