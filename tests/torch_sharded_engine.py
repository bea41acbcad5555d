"""The serving engine on a mesh of thread-ranks (``Engine(env=...)``)
against the reference's one-device engine, for
tests/test_torch_sharded_engine{,_moe}.py.

``script`` drives an engine through admit, batched decode rounds, a
park, a new session taking the parked one's slot, a resume with a delta
prefill into another slot (with 4 slots over 'data' = 2, the session's
row moves to the other data rank), a release, a second park, and an
``export_kv`` into a second engine's ``import_kv``, which then resumes
and decodes it.  The reference's engines run it once on one device; the
port's run it on every rank of the mesh.  Held: the ids (parted only at
a near-tie of the reference's logits, ``SameArgmaxOnMesh``: micro's
script meets one on one device already, session a's first step after its
resume, a top-2 gap of 5.6e-4 against a difference of 1.8e-3 between the
two frameworks' logits), the host state after each phase (tables, lens, free list, resident set, slots, counters, copy
bytes) exactly, the exported K/V within the bf16 tolerance, and every
rank's pool replica byte-equal to those of the ranks at the same 'model'
coordinate."""
import contextlib
import threading

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import (get_config, llama3_2_3b, llava_next_34b,
                           load_all, mixtral_8x22b)
from repro.models import lm as jlm
from repro.serving.engine import Engine as JEngine
from repro_torch.configs import get_config as tget
from repro_torch.configs import llama3_2_3b as tllama
from repro_torch.configs import llava_next_34b as tllava
from repro_torch.configs import mixtral_8x22b as tmixtral
from repro_torch.models import lm as tlm
from repro_torch.models.sharding import distribute
from repro_torch.serving.engine import Engine as TEngine
from torch_mesh import data_rows, on_mesh
from torch_routing import SameRouting, parted_argmax

load_all()
CONFIGS = {"micro": (get_config("micro"), tget("micro")),
           "llama3.2-tiny": (llama3_2_3b.tiny(), tllama.tiny()),
           "mixtral-tiny": (mixtral_8x22b.tiny(), tmixtral.tiny()),
           "llava-tiny": (llava_next_34b.tiny(), tllava.tiny())}
KW = dict(n_slots=4, max_len=96, pool_blocks=12, block_size=8)
TOL = 2e-2


def state(eng):
    p = eng.pool
    return (dict(p.tables), dict(p.lens), list(p.free), sorted(p.resident),
            [(s.session_id, s.length) for s in eng.slots],
            eng.prefill_tokens, eng.regen_tokens, eng.decode_steps,
            eng.park_copy_bytes, eng.resume_copy_bytes,
            eng.migration_copy_bytes)


def script(eng, eng2, vocab):
    """Returns (ids, host states, exported (k, v) as f32 numpy)."""
    rng = np.random.RandomState(5)
    a = rng.randint(1, vocab, size=37).astype(np.int32)
    b = rng.randint(1, vocab, size=20).astype(np.int32)
    c = rng.randint(1, vocab, size=9).astype(np.int32)
    tool = rng.randint(1, vocab, size=11).astype(np.int32)
    ids, states = [], []
    sa = eng.start_session("a", a, cached_hit=False)
    sb = eng.start_session("b", b, cached_hit=False)
    out = eng.decode({sa: int(a[-1]), sb: int(b[-1])}, n_steps=4)
    ids += [out[sa], out[sb]]
    states.append(state(eng))
    assert eng.park_session("a")
    sc = eng.start_session("c", c, cached_hit=False)     # a's old slot
    out = eng.decode({sb: ids[1][-1], sc: int(c[-1])}, n_steps=2)
    ids += [out[sb], out[sc]]
    ctx = np.concatenate([a, np.asarray(ids[0], np.int32), tool])
    sa2 = eng.start_session("a", ctx, cached_hit=True)
    assert sa2 not in (sa, sb, sc)
    states.append(state(eng))
    out = eng.decode({sa2: int(ctx[-1]), sb: ids[2][-1], sc: ids[3][-1]},
                     n_steps=3)
    ids += [out[sa2], out[sb], out[sc]]
    assert eng.release_session("b")
    assert eng.park_session("a")
    states.append(state(eng))
    k, v, n = eng.export_kv("a")
    assert eng2.import_kv("a", k, v, n)
    s2 = eng2.start_session("a", np.concatenate(
        [ctx, np.asarray(ids[4], np.int32)]), cached_hit=True)
    out = eng2.decode({s2: ids[4][-1]}, n_steps=2)
    ids.append(out[s2])
    states.append(state(eng2))
    f32 = (lambda t: np.array(jnp.asarray(t, jnp.float32))
           if not isinstance(t, torch.Tensor) else t.float().numpy())
    return ids, states, (f32(k), f32(v), n)


class SameArgmaxOnMesh:
    """``torch_routing.SameArgmax`` for engines on a mesh: the reference
    engine's jitted decode functions record each step's logits; each rank
    thread holds its port engine's whole logits (``full_tensor``) to them
    in call order, from its own queue.  A row whose greedy pick parts must
    be a near-tie of the reference; at most ``max_flips`` rows a rank may
    part, and only those rows' logits become the reference's."""

    def __init__(self, monkeypatch, ref_engines, tol=TOL, max_flips=1):
        self.logits, self.tol, self.max_flips = [], tol, max_flips
        self.mine = threading.local()
        for eng in ref_engines:
            for attr in ("_jit_decode", "_jit_paged_decode"):
                monkeypatch.setattr(eng, attr,
                                    self._record(getattr(eng, attr)))
        for name in ("decode_step", "decode_step_paged"):
            monkeypatch.setattr(tlm, name, self._hold(getattr(tlm, name)))

    def _record(self, fn):
        def call(*args):
            out = fn(*args)
            self.logits.append(np.array(out[0][:, 0].astype(jnp.float32)))
            return out
        return call

    def _hold(self, fn):
        def call(*args, **kw):
            from torch.distributed.tensor import DTensor, Replicate
            out = fn(*args, **kw)
            if not hasattr(self.mine, "queue"):
                self.mine.queue, self.mine.flips = list(self.logits), 0
            ref = self.mine.queue.pop(0)
            whole = out[0].full_tensor()
            part = parted_argmax(whole[:, 0].float().numpy(), ref, self.tol)
            if not part.any():
                return out
            self.mine.flips += int(part.sum())
            assert self.mine.flips <= self.max_flips, self.mine.flips
            whole = whole.clone()
            whole[torch.from_numpy(part), 0] = torch.from_numpy(
                ref[part]).to(whole.dtype)
            mesh = out[0].device_mesh
            return (DTensor.from_local(whole, mesh,
                                       [Replicate()] * mesh.ndim,
                                       run_check=False), *out[1:])
        return call


def scripts(name, mesh, monkeypatch, opts=None, paged=True, held=True):
    """The reference engines' run of ``script``, then the port's on each
    rank of ``mesh`` (without ``held``, the port's alone, its picks its
    own).  Returns (the reference's (ids, states, export) or None, each
    rank's (ids, states, export, its local k pool replicas, the pools'
    audits))."""
    cj, ct = CONFIGS[name]
    pj = jlm.init_params(cj, jax.random.PRNGKey(4))
    pt = tlm.params_from_jax(jax.tree_util.tree_map(np.asarray, pj), "cpu")
    kw = dict(KW, paged=paged)
    ref = routing = None
    if held:
        ej, ej2 = JEngine(cj, pj, **kw), JEngine(cj, pj, **kw)
        if cj.n_experts:
            routing = SameRouting(monkeypatch, rows=data_rows(mesh[1]))
        SameArgmaxOnMesh(monkeypatch, (ej, ej2))
        with jax.disable_jit() if routing else contextlib.nullcontext():
            ref = script(ej, ej2, cj.vocab)

    def rank(env):
        ps = distribute(pt, tlm.param_shardings(ct, env))
        with torch.no_grad():
            e1 = TEngine(ct, ps, env=env, **kw)
            e2 = TEngine(ct, ps, env=env, **kw)
            out = script(e1, e2, ct.vocab)
        pools = [e.pool.k_pool.to_local().clone() for e in (e1, e2)]
        return (*out, pools, [e.pool.audit_blocks() for e in (e1, e2)])

    return ref, on_mesh(*mesh, rank, opts)


def replicas_equal(res, tp):
    """Every rank's pool replicas byte-equal to those of the ranks at its
    'model' coordinate (rank = data * tp + model)."""
    for r, out in enumerate(res):
        for mine, first in zip(out[3], res[r % tp][3]):
            if not torch.equal(mine.view(torch.int16),
                               first.view(torch.int16)):
                return False
    return True


def check(ref, res, tp):
    ids_j, states_j, (kj, vj, nj) = ref
    for ids, states, (k, v, n), _, audits in res:
        assert ids == ids_j
        assert states == states_j
        assert n == nj and k.shape == kj.shape
        for a, b in ((k, kj), (v, vj)):
            assert np.max(np.abs(a - b)) < TOL * max(1.0, np.max(np.abs(b)))
        assert audits == [[], []]
    assert replicas_equal(res, tp)
