"""The port's model code (``repro_torch.models.lm``) against the JAX
reference on the same carried params: the parameter bridge is bit-exact,
and prefill agrees within the bf16 tolerance 2e-2 (tests/test_kernels.py)
for ``micro``, ``llama3.2-tiny`` (tied embeddings), ``rwkv6-tiny`` (ssm)
and ``jamba-tiny`` (hybrid); paged decode for the two dense ones, and
``decode_step`` over carried states for the ssm and hybrid ones.  bf16 states that reach past 2 (rwkv's token-shift
states are normed activations) are held to 2e-2 of their largest
magnitude, since one bf16 rounding there is 1.6e-2 or more."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)           # tiny shapes: threads only add overhead

from repro.configs import (get_config, jamba_v0_1_52b, llama3_2_3b,  # noqa
                           load_all, rwkv6_7b)
from repro.models import layers as jl  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models.sharding import ShardingEnv  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.configs import jamba_v0_1_52b as tjamba  # noqa: E402
from repro_torch.configs import llama3_2_3b as tllama  # noqa: E402
from repro_torch.configs import rwkv6_7b as trwkv  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402

load_all()
TOL = 2e-2
ENV = ShardingEnv(None, opts={"remat": False, "sp": False,
                              "moe_impl": "dense"})
CONFIGS = {"micro": (get_config("micro"), tget("micro")),
           "llama3.2-tiny": (llama3_2_3b.tiny(), tllama.tiny()),
           "rwkv6-tiny": (rwkv6_7b.tiny(), trwkv.tiny()),
           "jamba-tiny": (jamba_v0_1_52b.tiny(), tjamba.tiny())}
DENSE = ["llama3.2-tiny", "micro"]
STATEFUL = ["jamba-tiny", "rwkv6-tiny"]        # decode_step's families


class _SameRouting:
    """Holds jamba's MoE to the reference's expert picks.

    The two frameworks round the residual stream at other places, so a
    one-ulp difference meets a near-tie of the top-2 pick on a few tokens
    per prompt (seen: a reference gap of 2.4e-4 against a logit
    difference of 2.9e-3, ROADMAP.md Queue 3), and one other expert moves
    that row's logits far past TOL.  So the reference runs each call first,
    with its layers unrolled so its picks are concrete, and records them;
    the port's router then returns the reference's expert ids in the same
    call order, weighted by its own probabilities.  Each token where the
    port would have picked otherwise must be a near-tie of the reference
    (its k-th vs (k+1)-th gap below 4x the frameworks' probability
    difference); tests/test_torch_ssm.py holds the router's own picks."""

    def __init__(self, monkeypatch):
        self.calls, self.flips = [], 0
        j_router, t_router = jl.moe_router, tl.moe_router

        def record(x2d, w, k):
            p, e = j_router(x2d, w, k)
            probs = jax.nn.softmax((x2d @ w).astype(jnp.float32), axis=-1)
            self.calls.append((np.array(probs), np.array(e)))
            return p, e

        def replay(x2d, w, k):
            probs_j, ids_j = self.calls.pop(0)
            _, own = t_router(x2d, w, k)
            probs = torch.softmax((x2d @ w).float(), dim=-1)
            flip = (np.sort(own.numpy(), -1) != np.sort(ids_j, -1)).any(-1)
            if flip.any():
                srt = -np.sort(-probs_j[flip], axis=-1)
                gap = srt[:, k - 1] - srt[:, k]
                diff = np.abs(probs.numpy()[flip] - probs_j[flip]).max(-1)
                assert (gap < 4 * diff).all(), (gap, diff)
                self.flips += int(flip.sum())
            ids = torch.from_numpy(ids_j).long()
            top_p = probs.gather(1, ids)
            return top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9), ids

        monkeypatch.setattr(jl, "moe_router", record)
        monkeypatch.setattr(tl, "moe_router", replay)


ENV_UNROLLED = ShardingEnv(None, opts={"remat": False, "sp": False,
                                       "moe_impl": "dense",
                                       "unroll_layers": True})


def _env(name, monkeypatch):
    """The reference's env for ``name``; for jamba, with its layers
    unrolled and the port held to its MoE picks (``_SameRouting``)."""
    if "jamba" not in name:
        return ENV
    _SameRouting(monkeypatch)
    return ENV_UNROLLED


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
    last_j, cache_j = jlm.prefill(pj, {"tokens": jnp.asarray(toks)}, cj,
                                  env, max_len=96)
    last_t, cache_t = tlm.prefill(pt, {"tokens": torch.from_numpy(toks)},
                                  ct, max_len=96)
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


@pytest.mark.parametrize("name", DENSE)
def test_decode_step_paged_matches_jax(name):
    """Three decode steps over random pool contents, with one idle row on
    the drop sentinel: logits and the updated pools agree."""
    cj, ct, pj, pt = _carry(name, 2)
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
            jnp.asarray(pos), jnp.asarray(ablk), jnp.asarray(aoff), cj, ENV)
        T = torch.from_numpy
        lt, kt, vt = tlm.decode_step_paged(
            pt, T(toks).long(), kt, vt, T(tables), T(pos), T(ablk),
            T(aoff), ct)
        assert lt.dtype == torch.float32 and lt.shape == lj.shape
        assert _err(lt[:2], lj[:2]) < TOL, step        # active rows
        assert _err(kt, kj) < TOL and _err(vt, vj) < TOL, step
        pos = pos + np.asarray([1, 1, 0], np.int32)


@pytest.mark.parametrize("name", ["jamba-tiny", "llama3.2-tiny",
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
