"""The sharded layers alone, llava-next-tiny's sharded serving, and the
guards of the sharded path:

- llava-next-tiny (a patch stream before the tokens) through the sharded
  entry points on (1, 2) and (2, 2) under the four option sets
  (torch_sharded.py says what is held);
- ``rs_out_proj`` on a mesh against the reference's (with no mesh, the
  einsum): the reduce-scatter onto the sequence under ``rs_matmul``;
- ``gqa_attention_full`` on a mesh against the reference's, for each way
  a rank's q heads read the kv heads (``_kv_for_heads``): whole groups,
  inside one group, and neither (kv expanded to H heads);
- the kernel wrappers refuse a DTensor; ``forward_train`` on a mesh
  raises ``NotImplementedError`` naming its ROADMAP item, for every
  family, and ``decode_step_paged`` on a mesh refuses only the families
  it does not cover; ``threaded_world`` fails, and does not hang, when a
  rank raises or overruns its limit."""
import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import torch.distributed as dist  # noqa: E402

from repro.configs import qwen3_32b  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models.sharding import ShardingEnv as JEnv  # noqa: E402
from repro_torch.configs import jamba_v0_1_52b as t_jamba  # noqa: E402
from repro_torch.configs import llama3_2_3b as t_llama  # noqa: E402
from repro_torch.configs import qwen3_32b as t_qwen  # noqa: E402
from repro_torch.configs import rwkv6_7b as t_rwkv  # noqa: E402
from repro_torch.configs import seamless_m4t_large_v2 as t_seamless  # noqa
from repro_torch.kernels.flash_attention.ops import flash_prefill  # noqa
from repro_torch.kernels.mamba_scan.ops import mamba_scan  # noqa: E402
from repro_torch.kernels.paged_attention.ops import (paged_append,  # noqa
                                                     paged_decode)
from repro_torch.kernels.rwkv6.ops import wkv6  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.launch.mesh import fake_world, threaded_world  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models.sharding import distribute  # noqa: E402
from torch_mesh import on_mesh, replicated  # noqa: E402
from torch_sharded import cases, check_case  # noqa: E402

TOL = 2e-2
ENV_J = JEnv(None, opts={"sp": False})


def _bf16(a):
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.array(j).view(np.int16)).view(
        torch.bfloat16)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.array(jnp.asarray(x).astype(jnp.float32))


def _close(a, b) -> bool:
    a, b = _np(a), _np(b)
    return float(np.max(np.abs(a - b))) < TOL * max(
        1.0, float(np.max(np.abs(b))))


@pytest.mark.parametrize("name,mesh,opts", cases(["llava-next-tiny"]))
def test_sharded_serving_matches_reference(name, mesh, opts, monkeypatch):
    check_case(name, mesh, opts, monkeypatch)


@pytest.mark.parametrize("mesh", [(1, 2), (2, 2)])
@pytest.mark.parametrize("rs", [True, False])
def test_rs_out_proj_matches_reference(mesh, rs):
    """y (B, S, H, dh) with its heads over 'model' times wo (H, dh, d)
    FSDP'd over 'data': under ``rs_matmul`` the sum lands reduce-scattered
    onto the sequence; without it the local products' sum is pending over
    'model'.  Either way the value is the reference's, whose
    ``rs_out_proj`` without a mesh is the einsum."""
    rng = np.random.RandomState(3)
    B, S, H, dh, d = 2, 8, 4, 16, 32
    yj, yt = _bf16(rng.randn(B, S, H, dh))
    wj, wt = _bf16(rng.randn(H, dh, d) * 0.1)
    ref = jl.rs_out_proj(yj, wj, ENV_J, "bshx,hxd->bsd")

    def rank(env):
        bt = env.batch_axes
        y = distribute(yt, env.named(yt.shape, [bt, None, "model", None]))
        w = distribute(wt, env.named(wt.shape,
                                     ["model", None, env.fsdp_axis]))
        out = tl.rs_out_proj(y, w, env, "bshx,hxd->bsd")
        return (out.full_tensor(), out.placements,
                env.named((B, S, d), [bt, "model", None]).placements)

    out, pls, want = on_mesh(*mesh, rank, {"rs_matmul": rs})[0]
    assert _close(out, ref)
    if rs:
        assert pls == want
    else:
        assert any(p.is_partial() for p in pls)


@pytest.mark.parametrize("H,K,tp", [(4, 2, 2), (4, 2, 4), (12, 2, 3),
                                    (4, 4, 2)])
def test_kv_for_heads_gives_each_q_head_its_kv_head(H, K, tp):
    """A rank's local q head i must read the kv head global q head h0 + i
    reads, under the kernels' map (local kv head i // (Hl / K'))."""
    k = torch.randn(2, 5, K, 8)
    v = torch.randn(2, 5, K, 8)
    Hl = H // tp
    for r in range(tp):
        h0 = r * Hl
        kk, vv = tl._kv_for_heads(k, v, h0, Hl, H)
        assert Hl % kk.shape[2] == 0 and kk.is_contiguous()
        for out, src in ((kk, k), (vv, v)):
            local = tl.expand_kv(out, Hl)
            whole = tl.expand_kv(src, H)[:, :, h0:h0 + Hl]
            assert torch.equal(local, whole)


@pytest.mark.parametrize("H,K,mesh", [(4, 2, (1, 2)), (4, 2, (1, 4)),
                                      (12, 2, (1, 3)), (4, 2, (2, 2))])
def test_gqa_attention_full_on_a_mesh_matches_reference(H, K, mesh):
    cj = dataclasses.replace(qwen3_32b.tiny(), n_heads=H, n_kv_heads=K)
    ct = dataclasses.replace(t_qwen.tiny(), n_heads=H, n_kv_heads=K)
    pj = jax.tree_util.tree_map(
        lambda a: np.asarray(a[0]),
        jlm.init_params(cj, jax.random.PRNGKey(2))["layers"]["attn"])
    pt = tlm.params_from_jax({k: np.array(v) for k, v in pj.items()}, "cpu")
    B, S = 2, 8
    xj, xt = _bf16(np.random.RandomState(4).randn(B, S, cj.d_model))
    pos = np.arange(S, dtype=np.int32)[None]
    yj, kj, vj = jl.gqa_attention_full(xj, pj, cj, ENV_J, jnp.asarray(pos))

    def rank(env):
        rules = tlm.param_rules(ct, env)
        p = {k: distribute(v, env.named(v.shape, rules(
            f"layers/attn/{k}", (1, *v.shape))[1:])) for k, v in pt.items()}
        y, k, v = tl.gqa_attention_full(replicated(xt, env), p, ct,
                                        torch.from_numpy(pos), env=env)
        return y.full_tensor(), k.full_tensor(), v.full_tensor()

    y, k, v = on_mesh(*mesh, rank)[0]
    assert _close(y, yj) and _close(k, kj) and _close(v, vj)


def test_kernel_wrappers_refuse_a_dtensor():
    """A kernel takes a rank's shard: on the CPU a DTensor would pass the
    device test and run the plain version under DTensor's propagation,
    which is not what the card runs."""
    def rank(env):
        def dt(*shape, dtype=torch.bfloat16):
            return replicated(torch.zeros(shape, dtype=dtype), env)
        calls = [
            lambda: flash_prefill(dt(1, 4, 2, 16), dt(1, 4, 2, 16),
                                  dt(1, 4, 2, 16)),
            lambda: paged_decode(dt(1, 2, 16), dt(2, 4, 2, 16),
                                 dt(2, 4, 2, 16),
                                 dt(1, 1, dtype=torch.int32),
                                 dt(1, dtype=torch.int32)),
            lambda: paged_append(dt(2, 4, 2, 16), dt(2, 4, 2, 16),
                                 dt(1, 2, 16), dt(1, 2, 16),
                                 dt(1, dtype=torch.int32),
                                 dt(1, dtype=torch.int32)),
            lambda: wkv6(dt(1, 2, 1, 16), dt(1, 2, 1, 16), dt(1, 2, 1, 16),
                         dt(1, 2, 1, 16, dtype=torch.float32),
                         dt(1, 16, dtype=torch.float32)),
            lambda: mamba_scan(dt(1, 2, 4), dt(1, 2, 4), dt(1, 2, 8),
                               dt(1, 2, 8), dt(4, 8, dtype=torch.float32),
                               dt(4, dtype=torch.float32))]
        for call in calls:
            with pytest.raises(TypeError, match="DTensor"):
                call()
        return len(calls)

    assert on_mesh(1, 2, rank) == [5, 5]


@pytest.mark.parametrize("cfg", [t_rwkv.tiny(), t_jamba.tiny(),
                                 t_seamless.tiny()],
                         ids=lambda c: c.name)
def test_unported_families_refuse_a_mesh(cfg):
    """Paged decode refuses the families served on a mesh since ROADMAP
    Queue 1 item 3b, as it does on one device (they train on a mesh since
    item 3c: tests/test_torch_sharded_train_*.py)."""
    def rank(env):
        toks = torch.ones(2, 4, dtype=torch.int32)
        with pytest.raises(ValueError, match="uniform GQA"):
            tlm.decode_step_paged({}, toks[:, :1], None, None, None, None,
                                  None, None, cfg, env)
        return True

    assert all(on_mesh(1, 2, rank))


def test_training_and_paged_decode_refuse_a_mesh():
    """Paged decode on a mesh gets past the mesh check (it then reads the
    pool, here missing).  Training runs on a mesh since ROADMAP Queue 1
    item 3c: ``forward_train`` then takes its options from ``env.opts``
    and refuses ``opts=``, and ``train_loop`` refuses a mesh that is not a
    ``DeviceMesh``."""
    cfg = t_llama.tiny()

    def rank(env):
        toks = torch.ones(2, 4, dtype=torch.int32)
        with pytest.raises(ValueError, match="env.opts"):
            tlm.forward_train({}, {"tokens": toks, "labels": toks}, cfg,
                              env, opts={"remat": True})
        with pytest.raises(KeyError, match="embed"):
            tlm.decode_step_paged({}, toks[:, :1], None, None, None, None,
                                  None, None, cfg, env)
        return True

    assert all(on_mesh(1, 2, rank))
    with pytest.raises(ValueError, match="DeviceMesh"):
        ttrain.train_loop("micro", steps=1, mesh=object(), device="cpu")


def test_threaded_world_fails_fast_and_cleans_up():
    """A rank that raises while the others wait in a collective ends the
    run with its exception, not a hang; a rank past the time limit ends
    it with ``TimeoutError``; leaving the block leaves no process group
    (the fake world of the sharding tests can then be set up)."""
    def boom(rank):
        if rank == 2:
            raise ValueError("rank 2 fails")
        t = torch.ones(3)
        dist.all_reduce(t)
        return float(t[0])

    t0 = time.monotonic()
    with threaded_world(4) as run:
        with pytest.raises(ValueError, match="rank 2 fails"):
            run(boom)
        assert run(lambda r: dist.get_world_size()) == [4] * 4
    assert time.monotonic() - t0 < 30
    with threaded_world(2, timeout=1.0) as run:
        with pytest.raises(TimeoutError, match="rank1"):
            run(lambda r: time.sleep(4 * r))
    assert not dist.is_initialized()
    with fake_world(8):
        assert dist.get_world_size() == 8


def test_launch_counts_hold_under_threads():
    """The ranks of a threaded world launch kernels from several threads;
    the wrappers' counters (``build.count``) must lose no update: 16
    threads, a short switch interval."""
    import sys
    import threading

    from repro_torch.kernels import build

    class Wrapper:
        launches = 0

    def launch_many():
        for _ in range(2000):
            build.count(Wrapper)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=launch_many) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert Wrapper.launches == 16 * 2000
