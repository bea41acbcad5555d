"""The port's sharding specs (``repro_torch.models.sharding``,
``lm.param_rules`` / ``param_shardings`` / ``abstract_cache`` /
``cache_pspecs``, ``optimizer.opt_pspecs``, ``launch/{mesh,specs}.py``)
against the reference's, all exact:

- a hand-written twin of tests/test_sharding.py (it imports
  ``jax.sharding.PartitionSpec``, so ``torch_twin`` cannot make one);
- every param, optimizer, cache and input leaf of every supported
  (arch x shape) cell on the (16, 16), (2, 16, 16) and (8, 8) axis sizes
  under four option sets gets the reference's spec, the reference
  computed live without a mesh as test_sharding.py's ``fake_env`` does;
- on DTensor meshes over a fake process group of 512 ranks (this process
  rank 0, ``launch.mesh.fake_world``): each leaf's local shape is the one
  its spec implies, and each mesh coordinate's slice is the one JAX's
  ``NamedSharding`` gives the device there (JAX run in a child process
  with 512 host devices)."""
import functools
import itertools
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402
from torch.distributed.device_mesh import DeviceMesh  # noqa: E402
from torch.distributed.tensor import (DTensor, Replicate, Shard,  # noqa
                                      distribute_tensor)
from torch.distributed.tensor._utils import (  # noqa: E402
    _compute_local_shape_and_global_offset,
    compute_local_shape_and_global_offset)

from repro.configs import get_config as jget  # noqa: E402
from repro.configs import load_all as jload  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models.sharding import ShardingEnv as JEnv  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config, load_all  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import specs as tspecs  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.sharding import (P, NamedSharding,  # noqa: E402
                                         ShardingEnv, placements)
from repro_torch.train import optimizer as topt  # noqa: E402

load_all()
jload()
ROOT = Path(__file__).resolve().parents[1]
LAYOUTS = {"16x16": ((16, 16), ("data", "model")),
           "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
           "8x8": ((8, 8), ("data", "model"))}
OPTS = [{}, {"fsdp": False}, {"serve_fullshard": True}, {"cache_2d": True}]


# --- twin of tests/test_sharding.py ------------------------------------------
def fake_env(pod=False):
    env = ShardingEnv(None)
    env.axis_sizes = ({"pod": 2, "data": 16, "model": 16} if pod
                      else {"data": 16, "model": 16})
    return env


def leaves(tree, path=()):
    """{"/"-joined key path: leaf} of nested dicts, NamedTuples and
    tuples (a None is a leaf)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    elif isinstance(tree, (tuple, list)) and not isinstance(tree, P):
        items = enumerate(tree)
    else:
        return {"/".join(map(str, path)): tree}
    out = {}
    for k, v in items:
        out.update(leaves(v, path + (k,)))
    return out


def test_spec_prunes_indivisible_dims():
    env = fake_env()
    # seamless vocab is not divisible by 16 -> pruned to None
    assert env.spec((256206, 1024), ["model", None]) == P(None, None)
    assert env.spec((151936, 1024), ["model", None]) == P("model", None)
    # multi-axis want keeps only the divisible prefix
    assert env.spec((256,), [("data", "model")]) == P(("data", "model"))
    assert env.spec((32,), [("data", "model")]) == P("data")
    assert env.spec((24,), [("data", "model")]) == P(None)


def test_batch_axes_single_vs_multipod():
    assert fake_env().batch_axes == ("data",)
    assert fake_env(pod=True).batch_axes == ("pod", "data")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_rules_cover_every_leaf(arch):
    """Every parameter leaf gets a wish list of the right rank, and 2D+
    weight matrices are 2D-sharded (FSDP x TP) where divisible."""
    cfg = get_config(arch)
    env = fake_env()
    rules = lm.param_rules(cfg, env)
    ab = lm.abstract_params(cfg)
    n_sharded = 0
    for key, leaf in leaves(ab).items():
        wants = rules(key, leaf.shape)
        assert len(wants) == len(leaf.shape), key
        spec = env.spec(leaf.shape, wants)
        for dim, s in zip(leaf.shape, spec):
            if s is not None:
                n_sharded += 1
                axes = (s,) if isinstance(s, str) else s
                f = 1
                for a in axes:
                    f *= env.axis_sizes[a]
                assert dim % f == 0, (key, dim, s)
    assert n_sharded > 0, "no parameter sharded at all"


@pytest.mark.parametrize("arch", ["llama3.2-3b", "llava-next-34b"])
def test_indivisible_heads_fall_back_to_head_dim(arch):
    """24/56 q heads don't divide tp=16: rules must shard head_dim."""
    cfg = get_config(arch)
    env = fake_env()
    assert not env.heads_shardable(cfg.n_heads)
    rules = lm.param_rules(cfg, env)
    wants = rules("layers/attn/wq", (cfg.n_layers, cfg.d_model,
                                     cfg.n_heads, cfg.head_dim))
    assert wants[-2] is None and wants[-1] == "model"


def test_moe_ep_vs_tp_decision():
    env = fake_env()
    assert env.moe_ep(160)      # deepseek: 160 % 16 == 0 -> EP
    assert env.moe_ep(16)       # jamba
    assert not env.moe_ep(8)    # mixtral: d_ff TP fallback


# --- the parity sweep against the reference ----------------------------------
_REF_ABSTRACT = jlm.abstract_params
_REF_OPT_STATE = jopt.abstract_opt_state


@functools.lru_cache(maxsize=None)
def _ref_abstract_by_name(name):
    return _REF_ABSTRACT(jget(name))


_OPT_STATES = {}


def _ref_opt_state(ap):
    """``abstract_opt_state`` once per abstract tree (each is cached, so
    its id stays its own)."""
    if id(ap) not in _OPT_STATES:
        _OPT_STATES[id(ap)] = (ap, _REF_OPT_STATE(ap))
    return _OPT_STATES[id(ap)][1]


@pytest.fixture
def cached_reference(monkeypatch):
    """The reference's ``jax.eval_shape`` of the params (and of the
    optimizer state) once per arch: the sweep takes ~1,000 of them."""
    monkeypatch.setattr(jlm, "abstract_params",
                        lambda cfg: _ref_abstract_by_name(cfg.name))
    monkeypatch.setattr(jopt, "abstract_opt_state", _ref_opt_state)


def ref_env(layout, opts):
    """The reference's env without a mesh, as test_sharding.py's
    ``fake_env``, with ``named`` giving the spec itself."""
    shape, axes = LAYOUTS[layout]
    env = JEnv(None, opts)
    env.axis_sizes = dict(zip(axes, shape))
    env.named = lambda dims, wants: env.spec(dims, wants)
    return env


def port_spec_env(layout, opts):
    """The port's env the same way: its specs without a mesh."""
    shape, axes = LAYOUTS[layout]
    env = ShardingEnv(None, opts)
    env.axis_sizes = dict(zip(axes, shape))
    env.named = lambda dims, wants: env.spec(dims, wants)
    return env


def ref_leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: x is None or isinstance(x, JP))
    key = lambda k: getattr(k, "key", getattr(k, "idx",  # noqa: E731
                                              getattr(k, "name", k)))
    return {"/".join(str(key(k)) for k in kp): leaf for kp, leaf in flat}


def _spec(s):
    return None if s is None else tuple(s)


def _reused_axis(spec) -> bool:
    axes = [a for e in spec if e is not None
            for a in ((e,) if isinstance(e, str) else e)]
    return len(axes) != len(set(axes))


@pytest.fixture(scope="module")
def world():
    """The three meshes on one fake process group of 512 ranks, torn down
    with the module (xdist runs other files in this process)."""
    with tmesh.fake_world(512):
        yield {"16x16": tmesh.make_production_mesh(device_type="cpu"),
               "2x16x16": tmesh.make_production_mesh(multi_pod=True,
                                                     device_type="cpu"),
               "8x8": tmesh.make_worker_mesh(64, tp=8, device_type="cpu")}


def _cells(arch):
    cfg = get_config(arch)
    return [s for s in tspecs.SHAPES if tspecs.cell_supported(cfg, s)[0]]


def _out_shapes(cfg, shape_name):
    """The global shapes of ``out_shardings``' leaves: the logits and the
    cache."""
    info = tspecs.SHAPES[shape_name]
    S, B = info["seq"], info["batch"]
    if info["kind"] == "prefill":
        cache = lm.abstract_cache(cfg, B, S)
    else:
        tgt = max(S // 4, 8) if cfg.enc_dec else S
        cache = lm.abstract_cache(cfg, B, tgt, src_len=S)
    out = {"0": (B, 1, cfg.vocab)}
    out.update({f"1/{k}": tuple(v.shape) for k, v in cache.items()})
    return out


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_leaf_spec_matches_reference(arch, layout, world,
                                           cached_reference):
    """Every param, optimizer, cache and input leaf, matched by key path:
    the port's spec equals the reference's; the port's meta stand-ins
    have the reference's shapes and dtypes; on the mesh each leaf's
    ``NamedSharding`` holds that spec and its placements give the local
    shape the spec implies.  Where the reference's spec maps one mesh
    axis to two dims (``cache_2d`` with a batch that splits over
    "data"), JAX's ``NamedSharding`` refuses it (``DuplicateSpecError``)
    and the port's refuses it too."""
    cfg, jcfg = get_config(arch), jget(arch)
    mesh = world[layout]
    n_leaves = 0
    for opts in OPTS:
        for shape_name in _cells(arch):
            where = (arch, layout, opts, shape_name)
            ref = jspecs.input_specs(jcfg, shape_name, ref_env(layout, opts))
            got = tspecs.input_specs(cfg, shape_name,
                                     port_spec_env(layout, opts))
            assert sorted(got) == sorted(ref), where
            assert got["kind"] == ref["kind"], where
            assert got["donate_argnums"] == ref["donate_argnums"], where
            ra, ga = ref_leaves(ref["args"]), leaves(got["args"])
            assert {k: (tuple(v.shape), np.dtype(v.dtype).name)
                    for k, v in ra.items()} == \
                {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
                 for k, v in ga.items()}, where
            want = {}
            for key in ("in_shardings", "out_shardings"):
                if key not in ref:
                    continue
                w = {f"{key}/{k}": _spec(v)
                     for k, v in ref_leaves(ref[key]).items()}
                assert {f"{key}/{k}": v for k, v in
                        leaves(got[key]).items()} == w, where
                want.update(w)
            n_leaves += len(want)

            env = ShardingEnv(mesh, opts)
            if any(s is not None and _reused_axis(s) for s in want.values()):
                with pytest.raises(ValueError, match="shards two tensor"):
                    tspecs.input_specs(cfg, shape_name, env)
                continue
            on_mesh = tspecs.input_specs(cfg, shape_name, env)
            shapes = {f"in_shardings/{k}": tuple(v.shape)
                      for k, v in leaves(on_mesh["args"]).items()}
            shapes.update({f"out_shardings/{k}": v for k, v in
                           _out_shapes(cfg, shape_name).items()})
            for key in ("in_shardings", "out_shardings"):
                for k, sh in leaves(on_mesh.get(key, {})).items():
                    path = f"{key}/{k}"
                    if sh is None:
                        assert want[path] is None, (where, path)
                        continue
                    assert isinstance(sh, NamedSharding), (where, path)
                    assert sh.spec == want[path], (where, path)
                    local, _ = compute_local_shape_and_global_offset(
                        shapes[path], mesh, sh.placements)
                    assert tuple(local) == sh.shard_shape(shapes[path]), \
                        (where, path, sh)
    assert n_leaves > 0


def test_opt_pspecs_reuse_the_param_shardings(world):
    env = ShardingEnv(world["8x8"])
    cfg = get_config("llama3.2-3b")
    ps = lm.param_shardings(cfg, env)
    st = topt.opt_pspecs(ps)
    assert st.mu is ps and st.nu is ps and st.step is None


# --- on the fake mesh ---------------------------------------------------------
@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("arch", ["llama3.2-3b", "deepseek-v2-236b"])
def test_meta_leaves_shard_to_their_spec_shapes(arch, layout, world):
    """``distribute_tensor`` of each meta leaf (params, moments, cache,
    inputs; the default options and ``serve_fullshard``'s decode, whose
    sequence dim runs over ("model", "data")) gives rank 0 the local
    shape its spec implies, and a DTensor of the global shape."""
    cfg = get_config(arch)
    mesh = world[layout]
    n = 0
    for opts in ({}, {"serve_fullshard": True}):
        env = ShardingEnv(mesh, opts)
        for shape_name in _cells(arch):
            if opts and tspecs.SHAPES[shape_name]["kind"] != "decode":
                continue
            cell = tspecs.input_specs(cfg, shape_name, env)
            args, shs = leaves(cell["args"]), leaves(cell["in_shardings"])
            assert sorted(args) == sorted(shs)
            for k, leaf in args.items():
                sh = shs[k]
                if sh is None:
                    continue
                dt = distribute_tensor(leaf, mesh, sh.placements)
                assert isinstance(dt, DTensor)
                assert dt.shape == leaf.shape, (shape_name, k)
                assert tuple(dt.to_local().shape) == \
                    sh.shard_shape(leaf.shape), (shape_name, k, sh)
                assert dt.to_local().dtype == leaf.dtype
                n += 1
    assert n > 0


# JAX's slices, from a child process with 512 host devices: mesh shape,
# axis names, tensor shape, spec (a list entry is a tuple of axes)
ORDER_CASES = [
    ((16, 16), ("data", "model"), (512, 2), [["data", "model"], None]),
    ((16, 16), ("data", "model"), (512, 2), [["model", "data"], None]),
    ((16, 16), ("data", "model"), (64, 512), ["data", "model"]),
    ((16, 16), ("data", "model"), (2, 4, 512, 2, 2),
     [None, None, ["model", "data"], None, None]),
    ((2, 16, 16), ("pod", "data", "model"), (64, 512),
     [["pod", "data"], "model"]),
    ((2, 16, 16), ("pod", "data", "model"), (2, 1024, 2),
     [None, ["model", "data"], None]),
    ((8, 8), ("data", "model"), (128, 8), [["model", "data"], None]),
] + [((2, 3, 4), ("a", "b", "c"), (48, 2), [list(p), None])
     for p in itertools.permutations("abc")]

_JAX_ORDER = """
import json, os, sys
import jax, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
out = []
for shape, axes, tshape, spec in json.loads(sys.stdin.read()):
    n = int(np.prod(shape))
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(shape), tuple(axes))
    sh = NamedSharding(mesh, P(*[tuple(e) if isinstance(e, list) else e
                                 for e in spec]))
    idx = sh.devices_indices_map(tuple(tshape))
    rows = []
    for coord in np.ndindex(*shape):
        sl = idx[mesh.devices[coord]]
        rows.append([list(coord), [s.start or 0 for s in sl],
                     [(s.stop if s.stop is not None else d) - (s.start or 0)
                      for s, d in zip(sl, tshape)]])
    out.append(rows)
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_slices():
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=512",
               PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", _JAX_ORDER],
                         input=json.dumps(ORDER_CASES), capture_output=True,
                         text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("case", range(len(ORDER_CASES)),
                         ids=lambda i: "{}-{}".format(
                             "x".join(map(str, ORDER_CASES[i][0])),
                             "-".join("+".join(e) if isinstance(e, list)
                                      else str(e)
                                      for e in ORDER_CASES[i][3])))
def test_every_rank_holds_the_slice_jax_gives_it(case, world, jax_slices):
    """A dim over two or three mesh axes, in the mesh's order or against
    it (("model", "data") on a ("data", "model") mesh): at every mesh
    coordinate the port's placements give the offset and shape JAX's
    ``devices_indices_map`` gives the device there."""
    shape, axes, tshape, spec = ORDER_CASES[case]
    mesh = DeviceMesh("cpu", torch.arange(int(np.prod(shape))).view(shape),
                      mesh_dim_names=axes)
    spec = P(*[tuple(e) if isinstance(e, list) else e for e in spec])
    pls = placements(mesh, spec)
    assert tuple(NamedSharding(mesh, spec).placements) == pls
    for coord, start, size in jax_slices[case]:
        local, offset = _compute_local_shape_and_global_offset(
            tshape, shape, coord, pls)
        assert list(offset) == start and list(local) == size, \
            (coord, pls, offset, start)


def test_axis_order_against_the_mesh_is_a_strided_shard(world):
    from torch.distributed.tensor.placement_types import _StridedShard
    mesh = world["16x16"]
    assert placements(mesh, P(("data", "model"), None)) == (Shard(0),
                                                            Shard(0))
    pls = placements(mesh, P(None, ("model", "data")))
    assert isinstance(pls[0], _StridedShard) and pls[0].dim == 1
    assert pls[0].split_factor == 16 and pls[1] == Shard(1)
    assert placements(mesh, P()) == (Replicate(), Replicate())
    with pytest.raises(ValueError, match="shards two tensor dims"):
        placements(mesh, P("data", ("model", "data")))


def test_cs_is_identity_without_a_mesh_and_redistributes_on_one(world):
    x = torch.zeros(4, 8)
    assert ShardingEnv(None).cs(x, "data", None) is x
    env = ShardingEnv(world["8x8"])
    with pytest.raises(TypeError, match="DTensor"):
        env.cs(x, "data", None)
    dt = distribute_tensor(torch.zeros(64, 16), world["8x8"],
                           [Replicate(), Replicate()])
    out = env.cs(dt, "data", "model")
    assert out.placements == (Shard(0), Shard(1))
    assert tuple(out.to_local().shape) == (8, 2)


def test_spec_equals_the_reference_partition_spec():
    assert P("data", None) == tuple(JP("data", None))
    assert P(None, ("model", "data")) == tuple(JP(None, ("model", "data")))
    assert P() == tuple(JP())
    assert repr(P("data", None)) == "P('data', None)"


def test_production_mesh_refuses_a_world_too_small():
    """The counterpart of the reference's XLA_FLAGS message: a mesh of
    256 ranks on a fake world of 64 raises, naming the fake world (a
    child process: this module's world is already set up)."""
    code = ("from repro_torch.launch import mesh\n"
            "with mesh.fake_world(64):\n"
            "    mesh.make_worker_mesh(64, tp=8, device_type='cpu')\n"
            "    mesh.make_production_mesh(device_type='cpu')\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert res.returncode != 0
    assert "RuntimeError: mesh (16, 16) needs 256 ranks but the process " \
           "group has 64" in res.stderr
    assert "fake_world(256)" in res.stderr


def test_meshes_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmesh.make_production_mesh()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmesh.make_worker_mesh(64, tp=8)
