"""seamless's sharded serving where the vocabulary does not split, and
its cross-attention decode on a mesh alone:

- seamless-tiny with a vocabulary of 258 (2 divides it, 4 does not, as
  seamless-m4t's 256,206) on (1, 2) and (1, 4): ``embed`` / ``unembed``
  split over 'model' at tp 2 and replicated at tp 4, the logits' layout
  and the greedy picks following the pruned spec, held to the
  reference's one-device run as torch_sharded_rest.py holds them;
- ``layers.cross_attention_decode`` on a mesh against the reference's
  computation of it (tests/test_torch_cross_decode.py's), in f32 and
  bf16, and a query roped at pos - 1 moving it past both limits."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.configs import seamless_m4t_large_v2  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.configs import seamless_m4t_large_v2 as tsm  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from test_torch_cross_decode import TOL, _pair, _reference  # noqa: E402
from torch_mesh import on_mesh  # noqa: E402
from torch_sharded_rest import check_case  # noqa: E402


@pytest.mark.parametrize("name,mesh,opts",
                         [("seamless-tiny-v258", m, o) for m in ((1, 2), (1, 4))
                          for o in ("defaults", "serve_fullshard")])
def test_sharded_vocab_split_follows_the_pruned_spec(name, mesh, opts,
                                                     monkeypatch):
    out = check_case(name, mesh, opts, monkeypatch)
    model = out["full"][1][-1]
    assert model.is_shard(2) == (mesh[1] == 2), model


def _err(a, b):
    b = np.array(jnp.asarray(b, jnp.float32))
    return float(np.abs(a.float().numpy() - b).max()) / float(
        np.abs(b).max())


@pytest.mark.parametrize("mesh", [(1, 2), (2, 2), (1, 4)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sharded_cross_attention_decode_matches_reference(dtype, mesh):
    """The cross cache laid out as ``cache_pspecs`` puts it (its 20
    frames over 'model'), the rows over 'data', the params by
    ``param_rules``; the rank's output summed over 'model'."""
    cj, ct = seamless_m4t_large_v2.tiny(), tsm.tiny()
    pj = jlm.init_params(cj, jax.random.PRNGKey(1))
    lj = {k: np.asarray(v[0], np.float32)
          for k, v in pj["dec_layers"]["cross"].items() if k in ("wq", "wo")}
    rng = np.random.RandomState(5)
    B, Ss = 4, 20
    xj, xt = _pair(rng.randn(B, 1, cj.d_model), dtype)
    ckj, ckt = _pair(rng.randn(B, Ss, cj.n_kv_heads, cj.head_dim), dtype)
    cvj, cvt = _pair(rng.randn(B, Ss, cj.n_kv_heads, cj.head_dim), dtype)
    pj_l, pt_l = {}, {}
    for k, v in lj.items():
        pj_l[k], pt_l[k] = _pair(v, dtype)
    pos = np.asarray([Ss + 2, 7, 0, 3], np.int32)
    ref = _reference(xj, pj_l, cj, ckj, cvj, pos)

    def rank(env):
        from repro_torch.models.sharding import distribute
        bt = env.batch_axes
        rules = tlm.param_rules(ct, env)
        p = {k: distribute(v, env.named(v.shape, rules(
            f"dec_layers/cross/{k}", v.shape))) for k, v in pt_l.items()}
        x = distribute(xt, env.named(xt.shape, [bt, None, None]))
        cache = [distribute(c, env.named(c.shape, [bt, "model", None, None]))
                 for c in (ckt, cvt)]
        outs = []
        for shift in (0, 1):
            y = tl.cross_attention_decode(x, p, ct, *cache,
                                          torch.from_numpy(pos - shift), env)
            outs.append(env.cs(y, bt, None, None).full_tensor().to(xt.dtype))
        return outs, tuple(cache[0].placements)

    (out, shifted), pls = on_mesh(*mesh, rank)[0]
    assert pls[-1].is_shard(1)                # the frames over 'model'
    assert out.dtype == getattr(torch, dtype) and out.shape == ref.shape
    assert _err(out, ref) < TOL[dtype]
    assert _err(shifted, ref) > TOL["bfloat16"]
