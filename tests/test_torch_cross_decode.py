"""seamless's cross-attention decode alone: the port's
``layers.cross_attention_decode`` against the reference's own
computation of it, written inline in ``repro/models/encdec.py``'s
``decode_step`` (the q einsum, ``apply_rope`` at ``pos``,
``decode_attention`` at ``Ss - 1`` over the frozen cross cache, the
out-projection), built here from ``repro.models.layers``' functions on
the same cross cache and query.  In f32 (params and inputs cast in both
packages) within the f32 tolerance 2e-5, and in bf16 within 2e-2
(tests/test_kernels.py), both relative to the output's largest
magnitude (well below 1 here, so this is stricter than the lm tests'
floor of 1).  A query roped at pos - 1 (the fault the card's logits check
sees only 1.73x above its sound reading) moves the output past both
limits."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.configs import seamless_m4t_large_v2  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.configs import seamless_m4t_large_v2 as tsm  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _pair(a, dtype):
    j = jnp.asarray(a, dtype)
    n = np.array(j.astype(jnp.float32))
    t = torch.from_numpy(n).to(getattr(torch, dtype))
    assert np.array_equal(t.float().numpy(), n)          # the same values
    return j, t


def _reference(x, p, cfg, ck, cv, pos):
    """encdec.decode_step's cross-attention, as the reference writes it."""
    B, Ss = x.shape[0], ck.shape[1]
    q = jnp.einsum("bsd,dhx->bshx", x, p["wq"])
    q = jl.apply_rope(q, jnp.broadcast_to(jnp.asarray(pos), (B,))[:, None],
                      cfg.rope_theta)
    y = jl.decode_attention(q, ck, cv, jnp.full((B,), Ss - 1))
    return jnp.einsum("bshx,hxd->bsd", y, p["wo"])


def _err(a, b):
    a = a.float().numpy() if isinstance(a, torch.Tensor) else a
    b = np.array(jnp.asarray(b, jnp.float32))
    return float(np.abs(a - b).max()) / float(np.abs(b).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_attention_decode_matches_reference(dtype):
    cj, ct = seamless_m4t_large_v2.tiny(), tsm.tiny()
    pj = jlm.init_params(cj, jax.random.PRNGKey(1))
    lj = {k: np.asarray(v[0], np.float32)
          for k, v in pj["dec_layers"]["cross"].items() if k in ("wq", "wo")}
    rng = np.random.RandomState(5)
    B, Ss = 3, 19
    xj, xt = _pair(rng.randn(B, 1, cj.d_model), dtype)
    ckj, ckt = _pair(rng.randn(B, Ss, cj.n_kv_heads, cj.head_dim), dtype)
    cvj, cvt = _pair(rng.randn(B, Ss, cj.n_kv_heads, cj.head_dim), dtype)
    pj_l, pt_l = {}, {}
    for k, v in lj.items():
        pj_l[k], pt_l[k] = _pair(v, dtype)
    pos = np.asarray([Ss + 2, 7, 0], np.int32)
    ref = _reference(xj, pj_l, cj, ckj, cvj, pos)
    out = tl.cross_attention_decode(xt, pt_l, ct, ckt, cvt,
                                    torch.from_numpy(pos))
    assert out.dtype == getattr(torch, dtype) and out.shape == ref.shape
    assert _err(out, ref) < TOL[dtype]
    shifted = tl.cross_attention_decode(xt, pt_l, ct, ckt, cvt,
                                        torch.from_numpy(pos - 1))
    assert _err(shifted, ref) > TOL["bfloat16"]
