"""The port's training on a mesh (``lm.forward_train(params, batch, cfg,
env)`` and its backward, on a DTensor mesh of thread-ranks) against
``jax.value_and_grad`` of the reference's one-device ``forward_train``,
for tests/test_torch_sharded_train_*.py.

The reference runs once a module per arch (``reference``), jitted, under
``ShardingEnv(None, {"remat": False, "sp": False, "moe_impl":
"dense"})``, as tests/test_torch_forward_train.py runs it, on the
``PRNGKey(0)`` params carried bit-exactly and a numpy-drawn batch of
B x S tokens (vlm: 8 patches first, and row 0's last labels masked with
-100, so the data ranks hold different counts of valid labels).  ``check_case`` runs the port on each rank
of a (dp, tp) mesh under ``train_loop``'s mesh options (sp, fsdp,
``moe_impl="ep"``) with one change (``OPTS``), and holds:

- the loss, equal on every rank, within 2e-2 of the reference's
  (relative);
- every gradient leaf, gathered whole, within 2e-2 of the reference's
  largest magnitude in that leaf (tests/test_kernels.py's bf16
  tolerance); rwkv6 and jamba (``F32``) run with every param in f32 in
  both packages, within 1e-3, since their bf16 gradients part from the
  reference's on one device already (tests/test_torch_forward_train.py),
  rwkv6 also with its ln_x output unrounded in both (``unrounded_ln_x``);
  tests/test_torch_sharded_train_moe.py holds the MoE archs in f32 too;
- each gradient's placements equal to its param's (``param_shardings``);
- no kernel wrapper called: the five are replaced by stubs that raise.

The MoE archs replay the reference's router picks
(``torch_routing.SameRouting``, each rank its data shard's rows, a
recomputed call its own pick).  The reference's one-device MoE is the
dense impl, which drops nothing; the port's ``moe_ep`` has a capacity,
so these runs give each expert room for all of a rank's tokens
(``capacity_factor`` E / top_k) and assert that its dispatch dropped no
pair.  tests/test_torch_sharded_train_faults.py holds the drops."""
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import lm as jlm
from repro.models.sharding import ShardingEnv as JEnv
from repro_torch.models import layers as tl
from repro_torch.models import lm as tlm
from repro_torch.models import mamba as tmamba
from repro_torch.models import rwkv as trwkv
from repro_torch.models import sharding as tsh
from repro_torch.models.sharding import distribute
from repro_torch.train.optimizer import tree_leaves
from torch_mesh import data_rows, on_mesh
from torch_routing import SameRouting

ARCHS = {
    "llama3.2-tiny": "llama3_2_3b", "qwen3-tiny": "qwen3_32b",
    "mistral-nemo-tiny": "mistral_nemo_12b",
    "command-r-tiny": "command_r_35b", "mixtral-tiny": "mixtral_8x22b",
    "deepseek-v2-tiny": "deepseek_v2_236b",
    "llava-next-tiny": "llava_next_34b", "rwkv6-tiny": "rwkv6_7b",
    "jamba-tiny": "jamba_v0_1_52b", "seamless-tiny": "seamless_m4t_large_v2",
}
# held in f32 (the module docstring)
F32 = ("rwkv6-tiny", "jamba-tiny")
# train_loop's mesh options, then one change each
BASE = {"remat": False, "sp": True, "moe_impl": "ep"}
OPTS = {"defaults": {}, "no_fsdp": {"fsdp": False},
        "rs_matmul": {"rs_matmul": True}, "no_sp": {"sp": False}}
ENV_J = JEnv(None, {"remat": False, "sp": False, "moe_impl": "dense"})
B, S, FRAMES, PATCHES = 2, 16, 24, 8
TOL, TOL_F32 = 2e-2, 1e-3
KERNELS = ((tl, "flash_prefill"), (tl, "paged_decode"),
           (tl, "paged_append"), (trwkv, "wkv6"), (tmamba, "mamba_scan"))


def cases(names, meshes=((1, 2), (2, 2)), opts=tuple(OPTS)):
    return [(n, m, o) for n in names for m in meshes for o in opts]


def configs(name):
    mod = ARCHS[name]
    return (importlib.import_module(f"repro.configs.{mod}").tiny(),
            importlib.import_module(f"repro_torch.configs.{mod}").tiny())


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield "/".join(prefix), tree


def _ln_x_jax(x, scale, n_heads, eps=1e-5):
    orig = x.shape
    x = x.reshape(orig[:-1] + (n_heads, orig[-1] // n_heads)).astype(
        jnp.float32)
    x = (x - x.mean(axis=-1, keepdims=True)) * jax.lax.rsqrt(
        jnp.var(x, axis=-1, keepdims=True) + eps)
    return x.reshape(orig) * scale.astype(jnp.float32)


def _ln_x_torch(x, scale, n_heads, eps=1e-5):
    orig = x.shape
    x = x.reshape(*orig[:-1], n_heads, orig[-1] // n_heads).float()
    x = (x - x.mean(dim=-1, keepdim=True)) * torch.rsqrt(
        x.var(dim=-1, unbiased=False, keepdim=True) + eps)
    return x.reshape(orig) * scale.float()


def unrounded_ln_x(monkeypatch):
    """rwkv6's ``group_norm_heads`` (ln_x) with its output left in f32 in
    both packages, which round it to bf16: in an f32 run the sharded
    sums' order flips single roundings there, and rwkv6's gradients then
    move past 1e-3 of a leaf's largest magnitude from the port's own
    one-device run while its loss agrees to f32 noise."""
    from repro.models import rwkv as jrwkv
    monkeypatch.setattr(jrwkv, "group_norm_heads", _ln_x_jax)
    monkeypatch.setattr(trwkv, "group_norm_heads", _ln_x_torch)


def _batch(cfg, rng):
    """The reference's and the port's batch (the port's tensors every rank
    holds whole)."""
    ints = lambda: rng.randint(0, cfg.vocab, size=(B, S))  # noqa: E731
    if cfg.enc_dec:
        arrs = {"frames": rng.randn(B, FRAMES, cfg.d_model) * 0.02,
                "tgt_tokens": ints(), "tgt_labels": ints()}
    else:
        arrs = {"tokens": ints(), "labels": ints()}
        if cfg.family == "vlm":
            arrs["patches"] = rng.randn(B, PATCHES, cfg.d_model) * 0.02
            arrs["labels"][0, S // 2:] = -100
    ref, port = {}, {}
    for k, a in arrs.items():
        if a.dtype == np.float64:
            ref[k] = jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)
            port[k] = torch.from_numpy(a.astype(np.float32)).bfloat16()
        else:
            ref[k] = a.astype(np.int32)
            port[k] = torch.from_numpy(a)
    return ref, port


def reference(name, vocab=None, f32=None):
    """The reference's loss and gradients (numpy f32, by leaf path) on the
    arch's carried params (in f32 where ``f32``, by default for ``F32``),
    with the port's params, batch and config."""
    return _reference(name, vocab, name in F32 if f32 is None else f32)


@functools.lru_cache(maxsize=None)
def _reference(name, vocab, f32):
    import dataclasses
    cj, ct = configs(name)
    if vocab:
        cj, ct = (dataclasses.replace(c, vocab=vocab) for c in (cj, ct))
    rng = np.random.RandomState(0)
    pj = jlm.init_params(cj, jax.random.PRNGKey(0))
    if f32:
        pj = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), pj)
    bj, bt = _batch(cj, rng)
    with pytest.MonkeyPatch.context() as mp:
        routing = SameRouting(mp, traced=True) if cj.n_experts else None
        if cj.family == "ssm":
            unrounded_ln_x(mp)
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: jlm.forward_train(p, bj, cj, ENV_J)))(pj)
        jax.effects_barrier()
    grads = dict(_leaves(jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), grads)))
    return {"cfg": ct, "batch": bt, "loss": float(loss), "grads": grads,
            "f32": f32,
            "params": tlm.params_from_jax(
                jax.tree_util.tree_map(np.asarray, pj), "cpu"),
            "calls": routing.calls if routing else None}


def no_kernels(monkeypatch):
    """Each kernel wrapper the model modules call replaced by a stub that
    raises: the training path must call none."""
    for mod, fn in KERNELS:
        def stub(*a, _fn=fn, **kw):
            raise AssertionError(f"training called the {_fn} kernel")
        monkeypatch.setattr(mod, fn, stub)


def count_drops(monkeypatch):
    """``layers._dispatch`` wrapped to count the (token, pick) pairs routed
    to a rank's experts that its capacity drops; returns the list the
    counts go to."""
    drops, dispatch = [], tl._dispatch

    def counted(top_p, top_e, e_start, e_local, capacity):
        out = dispatch(top_p, top_e, e_start, e_local, capacity)
        mine = (top_e >= e_start) & (top_e < e_start + e_local)
        drops.append(int(mine.sum()) - int(out[0].sum()))
        return out

    monkeypatch.setattr(tl, "_dispatch", counted)
    return drops


def room_for_all(monkeypatch, cfg):
    """``moe_ep`` with each expert's capacity the rank's whole token count
    (no pair can drop), so the dense reference applies."""
    moe_ep = tl.moe_ep
    monkeypatch.setattr(tl, "moe_ep", functools.partial(
        moe_ep, capacity_factor=cfg.n_experts / cfg.top_k))


def run(name, mesh, opts, monkeypatch, *, vocab=None, wrap=None, f32=None):
    """The port's loss and gradients on each rank of ``mesh`` under
    ``BASE`` changed by ``opts``: (every rank's loss, rank 0's gradients
    whole by leaf path, whether every rank's gradients are laid out as
    its params, the MoE dispatch's dropped pairs).  ``wrap`` (a test's
    planted fault) runs before the ranks start."""
    ref = reference(name, vocab, f32)
    ct = ref["cfg"]
    no_kernels(monkeypatch)
    drops = count_drops(monkeypatch)
    if ct.family == "ssm":
        unrounded_ln_x(monkeypatch)
    if ct.n_experts:
        routing = SameRouting(monkeypatch, traced=True,
                              rows=data_rows(mesh[1]))
        routing.calls = list(ref["calls"])
        room_for_all(monkeypatch, ct)
    if wrap:
        wrap(monkeypatch)

    def rank(env):
        ps = distribute(ref["params"], tlm.param_shardings(ct, env))
        for t in tree_leaves(ps):
            t.requires_grad_(True)
        loss = tlm.forward_train(ps, ref["batch"], ct, env)
        loss.backward()
        laid = all(t.grad is not None and t.grad.placements == t.placements
                   for t in tree_leaves(ps))
        with torch.no_grad():
            grads = {n: tsh.whole(t.grad).float().numpy()
                     for n, t in _leaves(ps)}
        return float(loss.detach()), grads, laid

    out = on_mesh(*mesh, rank, dict(BASE, **opts))
    return ([o[0] for o in out], out[0][1], all(o[2] for o in out),
            sum(drops))


def errors(name, got, vocab=None, f32=None):
    """(loss error relative to the reference's, {leaf: its error over the
    reference's largest magnitude in the leaf})."""
    ref = reference(name, vocab, f32)
    losses, grads = got[0], got[1]
    loss_err = abs(losses[0] - ref["loss"]) / abs(ref["loss"])
    leaf = {}
    for n, gj in ref["grads"].items():
        top = max(float(np.abs(gj).max()), 1e-30)
        leaf[n] = float(np.abs(grads[n] - gj).max()) / top
    return loss_err, leaf


def check_case(name, mesh, opt_name, monkeypatch, vocab=None, opts=None):
    """One case, every check of the module docstring; returns (the loss
    error, the leaves' errors)."""
    got = run(name, mesh, OPTS[opt_name] if opts is None else opts,
              monkeypatch, vocab=vocab)
    losses, _, laid, drops = got
    tol = TOL_F32 if reference(name, vocab)["f32"] else TOL
    assert len(set(losses)) == 1, losses
    assert laid, "a gradient is not laid out as its param"
    assert drops == 0, f"moe_ep dropped {drops} pairs"
    loss_err, leaf = errors(name, got, vocab)
    assert np.isfinite(losses[0]) and loss_err < tol, (losses[0], loss_err)
    bad = {n: e for n, e in leaf.items() if not e < tol}
    assert not bad, bad
    return loss_err, leaf
