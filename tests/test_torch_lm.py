"""The port's model code (``repro_torch.models.lm``) against the JAX
reference on the same carried params: the parameter bridge is bit-exact,
and prefill and paged decode agree within the bf16 tolerance 2e-2
(tests/test_kernels.py) for ``micro`` and ``llama3.2-tiny`` (tied
embeddings)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)           # tiny shapes: threads only add overhead

from repro.configs import get_config, llama3_2_3b, load_all  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models.sharding import ShardingEnv  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.configs import llama3_2_3b as tllama  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402

load_all()
TOL = 2e-2
ENV = ShardingEnv(None, opts={"remat": False, "sp": False,
                              "moe_impl": "dense"})
CONFIGS = {"micro": (get_config("micro"), tget("micro")),
           "llama3.2-tiny": (llama3_2_3b.tiny(), tllama.tiny())}


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
        assert t.dtype == torch.bfloat16, keys
        assert np.array_equal(t.view(torch.int16).numpy(),
                              a.view(np.int16)), keys


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
def test_prefill_matches_jax(name, S):
    cj, ct, pj, pt = _carry(name, 1)
    toks = np.random.RandomState(S).randint(1, cj.vocab, size=(2, S))
    last_j, cache_j = jlm.prefill(pj, {"tokens": jnp.asarray(toks)}, cj,
                                  ENV, max_len=96)
    last_t, cache_t = tlm.prefill(pt, {"tokens": torch.from_numpy(toks)},
                                  ct, max_len=96)
    assert last_t.dtype == torch.float32 and last_t.shape == last_j.shape
    assert _err(last_t, last_j) < TOL
    for key in ("k", "v"):
        assert tuple(cache_t[key].shape) == cache_j[key].shape
        assert _err(cache_t[key], cache_j[key]) < TOL
        assert not cache_t[key][:, :, S:].any()             # zero padding


@pytest.mark.parametrize("name", sorted(CONFIGS))
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


def test_init_params_shapes_match_the_reference_tree():
    cj, ct, pj, _ = _carry("llama3.2-tiny", 0)
    pt = tlm.init_params(ct, seed=0, device="cpu")
    shapes_j = jax.tree_util.tree_map(lambda a: a.shape, pj)
    shapes_t = jax.tree_util.tree_map(lambda t: tuple(t.shape), pt)
    assert shapes_t == shapes_j
    assert all(t.dtype == torch.bfloat16 for t in _leaves(pt))
    again = tlm.init_params(ct, seed=0, device="cpu")
    assert torch.equal(pt["embed"], again["embed"])     # seeded
