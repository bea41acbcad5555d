"""``lm.decode_step_paged`` on a mesh (``env``) against the reference's
one-device ``decode_step_paged``: four rows (one idle, on the drop
sentinel) over a seeded pool through shuffled block tables, 4
teacher-forced steps, for micro (2 kv heads: on (1, 2) and (2, 2) the
pool splits its kv heads over 'model', on (1, 4) it is replicated and a
rank reads its q head's kv head from its rows' gathered blocks),
llama3.2-tiny (3 q heads: rows over data x model), llava-tiny and
mixtral-tiny (its decode through ``moe_ep``'s EP branch, where no token
may be dropped).  Held: each step's logits within the bf16 tolerance
(2e-2 of the largest magnitude where that passes 1) and the greedy picks
equal or parted at a near-tie; the pools after the steps within the same
tolerance, laid out by ``kvcache.pool_sharding``, and every data
replica byte-equal.  Then the gather mode of ``Engine(env=mesh)`` once
(torch_sharded_engine.py says what is held)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.models import lm as jlm  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models.sharding import distribute  # noqa: E402
from repro_torch.serving.kvcache import pool_sharding  # noqa: E402
from torch_mesh import data_rows, on_mesh  # noqa: E402
from torch_routing import SameRouting, parted_argmax  # noqa: E402
from torch_sharded import ENV_J, OPTS, _bf16, _close, _np  # noqa: E402
from torch_sharded_engine import CONFIGS, check, scripts  # noqa: E402

TOL = 2e-2
B, BLOCK, NB, STEPS = 4, 8, 4, 4
LENS = np.array([10, 17, 0, 5], np.int32)        # row 2 idle
TOTAL = 20                                       # pool blocks
CASES = [("micro", (1, 2), "defaults"), ("micro", (2, 2), "defaults"),
         ("micro", (1, 4), "defaults"), ("micro", (2, 2), "serve_fullshard"),
         ("llama3.2-tiny", (1, 2), "defaults"),
         ("llama3.2-tiny", (2, 2), "defaults"),
         ("llava-tiny", (2, 2), "defaults"),
         ("mixtral-tiny", (1, 2), "defaults"),
         ("mixtral-tiny", (2, 2), "defaults")]


@functools.lru_cache(maxsize=None)
def reference(name):
    """The reference's steps, jitted (its MoE picks recorded inside), and
    the port's carried params and inputs."""
    cj, _ = CONFIGS[name]
    pj = jlm.init_params(cj, jax.random.PRNGKey(4))
    rng = np.random.RandomState(2)
    shape = (cj.n_layers, TOTAL, BLOCK, cj.n_kv_heads, cj.head_dim)
    kj, kt = _bf16(rng.randn(*shape))
    vj, vt = _bf16(rng.randn(*shape))
    tables = rng.permutation(TOTAL)[:B * NB].reshape(B, NB).astype(np.int32)
    tables[LENS == 0] = 0
    tok = rng.randint(1, cj.vocab, size=(B, 1)).astype(np.int32)
    live = LENS > 0
    with pytest.MonkeyPatch.context() as mp:
        routing = SameRouting(mp, traced=True) if cj.n_experts else None
        step = jax.jit(lambda p, *a: jlm.decode_step_paged(p, *a, cj, ENV_J))
        steps = []
        for t in range(STEPS):
            pos = np.where(live, LENS + t, 0).astype(np.int32)
            bids = np.where(live, tables[np.arange(B), pos // BLOCK],
                            TOTAL).astype(np.int32)
            offs = (pos % BLOCK).astype(np.int32)
            args = (tok, tables, pos, bids, offs)
            lg, kj, vj = step(pj, jnp.asarray(tok), kj, vj,
                              *map(jnp.asarray, args[1:]))
            steps.append((args, _np(lg)))
            tok = np.asarray(jnp.argmax(lg, -1), np.int32)
        jax.effects_barrier()
    pt = tlm.params_from_jax(jax.tree_util.tree_map(np.asarray, pj), "cpu")
    return {"params": pt, "pools": (kt, vt), "steps": steps,
            "after": (_np(kj), _np(vj)),
            "calls": routing.calls if routing else None}


@pytest.mark.parametrize("name,mesh,opts", CASES)
def test_sharded_paged_decode_matches_reference(name, mesh, opts,
                                                monkeypatch):
    ref = reference(name)
    _, ct = CONFIGS[name]
    drops = []
    if ct.n_experts:
        routing = SameRouting(monkeypatch, rows=data_rows(mesh[1]))
        routing.calls = list(ref["calls"])
        dispatch = tl._dispatch

        def counted(top_p, top_e, e_start, e_local, capacity):
            out = dispatch(top_p, top_e, e_start, e_local, capacity)
            routed = (top_e >= e_start) & (top_e < e_start + e_local)
            drops.append(int(routed.sum()) - int(out[0].sum()))
            return out

        monkeypatch.setattr(tl, "_dispatch", counted)

    def rank(env):
        ps = distribute(ref["params"], tlm.param_shardings(ct, env))
        sh = pool_sharding(env, tuple(ref["pools"][0].shape))
        kp, vp = (distribute(t.clone(), sh) for t in ref["pools"])
        out = []
        with torch.no_grad():
            for args, _ in ref["steps"]:
                tok, *ints = (torch.from_numpy(np.array(a)) for a in args)
                lg, kp, vp = tlm.decode_step_paged(ps, tok, kp, vp, *ints,
                                                   ct, env)
                out.append(lg.full_tensor())
        return (out, [t.full_tensor().float().numpy() for t in (kp, vp)],
                kp.placements == sh.placements,
                kp.to_local().clone(), sh.spec)

    res = on_mesh(*mesh, rank, OPTS[opts])
    out, pools, laid_out, _, spec = res[0]
    assert laid_out
    assert spec[3] == ("model" if ct.n_kv_heads % mesh[1] == 0 else None)
    for lg, (_, want) in zip(out, ref["steps"]):
        assert _close(lg.numpy(), want)
        parted_argmax(lg.numpy(), want, TOL)
    for got, want in zip(pools, ref["after"]):
        assert _close(got, want)
    for r, other in enumerate(res):           # the data replicas
        assert torch.equal(other[3].view(torch.int16),
                           res[r % mesh[1]][3].view(torch.int16))
    if ct.n_experts:                          # the EP branch ran, dropping none
        assert drops and max(drops) == 0


def test_sharded_gather_engine_matches_reference_engine(monkeypatch):
    ref, res = scripts("micro", (2, 2), monkeypatch, paged=False)
    check(ref, res, 2)
    park, resume = res[0][1][2][-3:-1]      # the gather copies, counted
    assert park > 0 and resume > 0
