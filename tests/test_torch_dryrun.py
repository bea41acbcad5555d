"""The port's dry run (``repro_torch.launch.dryrun``) against the
reference's and against a real run:

- every (arch x shape) cell's status on the 512-rank production meshes
  (the single-pod 16x16 under the reference's option sets, the multi-pod
  2x16x16 under its defaults): ``skip`` exactly where
  ``repro.launch.specs.cell_supported`` says so, ``error`` exactly where
  the reference's ``input_specs`` raises on its 512-device mesh (JAX in a
  child process with 512 host devices);
- the argument bytes of full-size cells: the local bytes each leaf's spec
  implies (the shapes tests/test_torch_sharding.py holds);
- a tiny cell on a (2, 2) mesh measured on meta (``fake_world(4)``) and
  run for real on CPU tensors (``threaded_world(4)``, the kernel wrappers
  stubbed to allocate what their CUDA paths allocate and return zeros):
  equal aten FLOPs, collectives by kind, peak bytes, and kernel calls;
- a process's first step (DTensor's propagation caches empty) counted as
  a later one;
- each kernel's work formula against a hand count at two shapes;
- ``remat_policy="dots"`` counting fewer backward FLOPs than whole-layer
  remat, and ``attn_mode="tri"`` fewer FLOPs than "full";
- the command line writing a cell's JSON with the reference's keys."""
import json
import math
import os
import subprocess
import sys
import threading
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.configs import load_all as jload  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config, load_all  # noqa: E402
from repro_torch.kernels.flash_attention import ops as F  # noqa: E402
from repro_torch.kernels.mamba_scan import ops as MS  # noqa: E402
from repro_torch.kernels.paged_attention import ops as P  # noqa: E402
from repro_torch.kernels.rwkv6 import ops as R  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import specs as tspecs  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import mamba as tmamba  # noqa: E402
from repro_torch.models import rwkv as trwkv  # noqa: E402

load_all()
jload()
ROOT = Path(__file__).resolve().parents[1]
# the reference's option sets (its command-line flags)
OPTION_SETS = {"defaults": {}, "cache_2d": {"cache_2d": True},
               "serve_fullshard": {"serve_fullshard": True},
               "no_fsdp": {"fsdp": False}, "rs_matmul": {"rs_matmul": True}}
# the option sets also held on the 2x16x16 multi-pod mesh
MULTI_POD_SETS = {"defaults": {}}

_REF_STATUS = """
import functools, json, sys
from repro.configs import ARCH_IDS, get_config, load_all
from repro.launch import specs
from repro.launch.mesh import make_production_mesh
from repro.models import lm
from repro.models.sharding import ShardingEnv
load_all()
abstract = lm.abstract_params
cached = functools.lru_cache(maxsize=None)(
    lambda name: abstract(get_config(name)))
lm.abstract_params = lambda cfg: cached(cfg.name)
out = {}
for tag, sets in json.loads(sys.stdin.read()).items():
  mesh = make_production_mesh(multi_pod=tag == "multi")
  for key, opts in sets.items():
    if tag == "multi":
        key = "multi:" + key
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape in specs.SHAPES:
            if not specs.cell_supported(cfg, shape)[0]:
                st = "skip"
            else:
                try:
                    specs.input_specs(cfg, shape, ShardingEnv(mesh, opts))
                    st = "ok"
                except Exception:
                    st = "error"
            out[f"{key}|{arch}|{shape}"] = st
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref_status():
    """The reference's status of every cell under each option set (on the
    single-pod mesh; ``multi:<set>`` keys on the multi-pod one), from a
    child process with 512 host devices."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=512",
               PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", _REF_STATUS],
                         input=json.dumps({"single": OPTION_SETS,
                                           "multi": MULTI_POD_SETS}),
                         capture_output=True,
                         text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.fixture
def world():
    """The single-pod production mesh on a fake world of 512, torn down
    with the test (the tests below set up worlds of their own)."""
    with tmesh.fake_world(512):
        yield tmesh.make_production_mesh(device_type="cpu")


def port_status(arch, shape, mesh, opts):
    cfg = get_config(arch)
    if not tspecs.cell_supported(cfg, shape)[0]:
        return "skip"
    try:
        D.prepare(cfg, shape, mesh, dict(D.DEFAULT_OPTS, **opts))
    except Exception:                   # noqa: BLE001 (the cell's error)
        return "error"
    return "ok"


@pytest.mark.parametrize("key", list(OPTION_SETS))
def test_every_cell_status_is_the_reference_s(key, world, ref_status):
    """skip where the reference's ``cell_supported`` skips; error where the
    reference's ``input_specs`` raises on its 512-device mesh (``cache_2d``
    with a batch split over "data" maps "data" to two dims); ok elsewhere."""
    got = {f"{key}|{a}|{s}": port_status(a, s, world, OPTION_SETS[key])
           for a in ARCH_IDS for s in tspecs.SHAPES}
    want = {k: v for k, v in ref_status.items() if k.startswith(key + "|")}
    assert got == want
    assert sum(v == "ok" for v in got.values()) > 0
    for k, v in got.items():
        a, s = k.split("|")[1:]
        assert (v == "skip") == (not jspecs.cell_supported(jget(a), s)[0])


@pytest.mark.parametrize("key", list(MULTI_POD_SETS))
def test_every_cell_status_on_the_multi_pod_mesh_is_the_reference_s(
        key, ref_status):
    """As above on the 2x16x16 ("pod", "data", "model") mesh, where
    "data" spans the pods."""
    with tmesh.fake_world(512):
        mesh = tmesh.make_production_mesh(multi_pod=True, device_type="cpu")
        got = {f"multi:{key}|{a}|{s}": port_status(a, s, mesh,
                                                   MULTI_POD_SETS[key])
               for a in ARCH_IDS for s in tspecs.SHAPES}
    want = {k: v for k, v in ref_status.items()
            if k.startswith(f"multi:{key}|")}
    assert got == want
    assert sum(v == "ok" for v in got.values()) > 0
    assert got[f"multi:{key}|command-r-35b|decode_32k"] == "ok"


def spec_local_bytes(spec):
    """Bytes of every argument leaf at the local shape its spec implies
    (``NamedSharding.shard_shape``), as tests/test_torch_sharding.py holds
    the shapes."""
    from repro_torch.train.optimizer import OptState
    n = 0
    for x, sh in zip(spec["args"], spec["in_shardings"]):
        pairs = ([(x.mu, sh.mu), (x.nu, sh.nu), (x.step, None)]
                 if isinstance(x, OptState) else [(x, sh)])
        for tree, shs in pairs:
            if isinstance(tree, dict):
                for k in tree:
                    n += spec_local_bytes({"args": [tree[k]],
                                           "in_shardings": [shs[k]]})
                continue
            shape = tree.shape if shs is None else shs.shard_shape(
                tree.shape)
            n += math.prod(shape) * tree.element_size()
    return n


@pytest.mark.parametrize("arch,shape", [
    ("llama3.2-3b", "train_4k"), ("llama3.2-3b", "prefill_32k"),
    ("llama3.2-3b", "decode_32k"), ("mixtral-8x22b", "decode_32k"),
    ("rwkv6-7b", "prefill_32k"), ("jamba-v0.1-52b", "long_500k")])
def test_argument_bytes_are_the_specs_local_bytes(arch, shape, world):
    """The dry run's argument bytes (rank 0's meta shards, placed) equal
    the bytes of each leaf at its spec's local shape, and so does
    MemTracker's peak over a step that only reads its arguments (it sees
    the DTensors' local storages)."""
    cfg = get_config(arch)
    _, spec, _ = D.prepare(cfg, shape, world, D.DEFAULT_OPTS)
    args = D.place(spec, world)
    got = D.local_bytes(args)
    assert got == spec_local_bytes(spec) > 0
    assert all(t.device.type == "meta" for t in D._tensors(args))
    _, c = D.measure(lambda *a: [t.sum() for t in D._tensors(a)[:3]], args)
    assert c.peak() - got == sum(
        t.element_size() for t in D._tensors(args)[:3])


# --- the meta measurement against a real run on CPU tensors ----------------
TINY = {"llama3.2-3b": "llama3_2_3b", "jamba-v0.1-52b": "jamba_v0_1_52b",
        "rwkv6-7b": "rwkv6_7b"}
REAL_CELLS = [("llama3.2-3b", "train", 4, 32),
              ("llama3.2-3b", "decode", 4, 64),
              ("jamba-v0.1-52b", "prefill", 4, 32),
              ("rwkv6-7b", "prefill", 4, 32)]


def tiny(arch):
    import importlib
    return importlib.import_module(
        f"repro_torch.configs.{TINY[arch]}").tiny()


class Stubs:
    """The kernel wrappers the model modules call, replaced for a real CPU
    run by stubs that allocate what the CUDA path allocates (output and
    scratch, ``paged_decode``'s split buffer and tickets) and return zeros;
    rank 0's calls counted."""

    def __init__(self, monkeypatch):
        self.calls = {}
        self.mine = threading.local()   # a rank's tickets, as a card's
        for mod, name, fn in ((tl, "flash_prefill", self.flash),
                              (tl, "paged_decode", self.decode),
                              (tl, "paged_append", self.append),
                              (trwkv, "wkv6", self.wkv6),
                              (tmamba, "mamba_scan", self.mamba)):
            monkeypatch.setattr(mod, name, self._counted(name, fn))

    def _counted(self, name, fn):
        def call(*a, **kw):
            if dist.get_rank() == 0:
                self.calls[name] = self.calls.get(name, 0) + 1
            return fn(*a, **kw)
        return call

    @staticmethod
    def flash(q, k, v, *, causal=True, window=0, cap=0.0):
        return q.new_zeros(*q.shape[:3], v.shape[3])

    def decode(self, q, k_pool, v_pool, tables, lens, *, window=0):
        B, H, dh = q.shape
        _, block, K, _ = k_pool.shape
        _, splits = P.split_schedule(tables.shape[1], block, B * K,
                                     P.H100_SMS)
        torch.empty(B * K * splits * (H // K) * (dh + 2))
        if not hasattr(self.mine, "tickets"):
            self.mine.tickets = torch.zeros(max(B * K, 256),
                                            dtype=torch.int32)
        return torch.zeros_like(q)

    @staticmethod
    def append(k_pool, v_pool, k_new, v_new, block_ids, offsets):
        return k_pool, v_pool

    @staticmethod
    def wkv6(r, k, v, w, u, state0=None):
        B, T, H, dh = r.shape
        return (torch.zeros(B, T, H, dh), torch.zeros(B, H, dh, dh))

    @staticmethod
    def mamba(x, dt, Bc, Cc, A, D, h0=None, *, round_y=False):
        B, T, di = x.shape
        return torch.zeros(B, T, di), torch.zeros(B, di, A.shape[1])


class ThreadedCollectives:
    """The threaded process group's collectives (which reach no dispatch
    mode, where the fake group's ``c10d`` ops do) counted by the
    reference's kinds on rank 0 while its counters are open (the dry
    run's ``Counters``), their own tensor work run outside the
    counters' modes, and each rank's tensors let go by the collective as
    its call returns (the group's shared record of a collective would
    otherwise hold them until the last rank's thread leaves, so the
    tensors' lifetimes, and the peak, would follow the threads' timing);
    ``close`` puts the methods back."""

    KINDS = {"allreduce": "all-reduce", "allreduce_coalesced": "all-reduce",
             "allgather": "all-gather", "all_gather_single": "all-gather",
             "reduce_scatter": "reduce-scatter",
             "reduce_scatter_single": "reduce-scatter",
             "alltoall": "all-to-all", "alltoall_base": "all-to-all",
             "broadcast": "collective-permute"}

    def __init__(self):
        from torch.testing._internal.distributed import multi_threaded_pg
        from torch.utils._python_dispatch import (
            _disable_current_modes, _get_current_dispatch_mode_stack)
        self.cls = multi_threaded_pg.ProcessLocalGroup
        self.kept = {n: getattr(self.cls, n) for n in self.KINDS}
        self.counts = {k: 0 for k in D._COLL_KINDS}
        self.depth = threading.local()

        def counted(name, fn):
            def call(pg, *a, **kw):
                outer = not getattr(self.depth, "n", 0)
                if outer and dist.get_rank() == 0 and any(
                        isinstance(m, D.Traffic)
                        for m in _get_current_dispatch_mode_stack()):
                    self.counts[self.KINDS[name]] += 1
                self.depth.n = getattr(self.depth, "n", 0) + 1
                try:
                    with _disable_current_modes():
                        work = fn(pg, *a, **kw)
                        if outer:          # done: a handle on nothing
                            work.wait()
                            work = multi_threaded_pg.ret_work(None)
                        return work
                finally:
                    self.depth.n -= 1
            return call

        for name, fn in self.kept.items():
            setattr(self.cls, name, counted(name, fn))
        self.coll = multi_threaded_pg.Collective
        self.join = self.coll.join

        def join(coll, rank, data, _join=self.join):
            try:
                return _join(coll, rank, data)
            finally:
                coll._data[rank] = None

        self.coll.join = join

    def close(self):
        for name, fn in self.kept.items():
            setattr(self.cls, name, fn)
        self.coll.join = self.join


def measured(cfg, kind, B, S, mesh, values=None):
    """(aten FLOPs, collectives by kind, peak bytes, kernel calls) of the
    cell's step on ``mesh``: meta stand-ins, or ``values``."""
    info = dict(seq=S, batch=B, kind=kind)
    _, spec, step = D.prepare(cfg, kind, mesh, D.DEFAULT_OPTS, info)
    args = D.place(spec, mesh, values(spec) if values else None)
    _, c = D.measure(step, args)
    return (c.aten_flops(), dict(c.traffic.counts), c.peak(),
            {k: v["calls"] for k, v in c.kernels.items()})


@pytest.mark.parametrize("arch,kind,B,S", REAL_CELLS)
def test_meta_measurement_is_a_real_run_s(arch, kind, B, S, monkeypatch):
    """On a (2, 2) mesh: the step measured on meta shards equals the same
    step run on real CPU shards (seeded, every rank computing, rank 0
    counted) in aten FLOPs, collectives by kind and count, peak bytes,
    and kernel calls (the meta route's tally, the stubs' calls)."""
    cfg = tiny(arch)
    with tmesh.fake_world(4):
        meta = measured(cfg, kind, B, S,
                        tmesh.make_worker_mesh(4, tp=2, device_type="cpu"))
    stubs = Stubs(monkeypatch)

    def make(spec):
        return D.materialize(cfg, spec, "cpu", seed=0)

    def rank(r):
        mesh = tmesh.make_worker_mesh(4, tp=2, device_type="cpu")
        got = measured(cfg, kind, B, S, mesh, make) if r == 0 else None
        if r:
            info = dict(seq=S, batch=B, kind=kind)
            _, spec, step = D.prepare(cfg, kind, mesh, D.DEFAULT_OPTS, info)
            step(*D.place(spec, mesh, make(spec)))
        return got

    coll = ThreadedCollectives()
    try:
        with tmesh.threaded_world(4, timeout=300) as run:
            real = run(rank)[0]
    finally:
        coll.close()
    flops, by_kind, peak, calls = meta
    assert (real[0], real[2]) == (flops, peak)
    assert coll.counts == by_kind and sum(by_kind.values()) > 0
    assert calls == stubs.calls and (kind == "train") == (not calls)
    assert flops > 0 and peak > 0


@pytest.mark.parametrize("kind,S", [("train", 32), ("decode", 64)])
def test_a_first_step_counts_as_a_later_one(kind, S):
    """DTensor's sharding propagation runs ops on fake tensors where its
    caches miss (emptied here, as in a process's first step); neither
    counter counts them, and ``paged_decode``'s tickets, which a card
    makes once a process, are made in every dry run: the first step's
    peak, aten FLOPs, bytes and kernel tally equal the second's (a tiny
    llama3.2 cell on a (2, 2) mesh); the train step's first did run such
    ops (the decode step's propagation needs none)."""
    from torch._guards import active_fake_mode
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode

    class FakeOps(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(t is DTensor for t in types):
                return NotImplemented
            self.n += active_fake_mode() is not None
            return func(*args, **(kwargs or {}))

    cfg = tiny("llama3.2-3b")
    info = dict(seq=S, batch=4, kind=kind)
    got = []
    with tmesh.fake_world(4):
        mesh = tmesh.make_worker_mesh(4, tp=2, device_type="cpu")
        prop = DTensor._op_dispatcher.sharding_propagator
        torch._C._clear_DTensor_sharding_propagator_cache()
        prop.propagate_op_sharding.cache_clear()
        prop._propagate_tensor_meta_cached.cache_clear()
        for _ in range(2):
            _, spec, step = D.prepare(cfg, kind, mesh, D.DEFAULT_OPTS,
                                      info)
            args = D.place(spec, mesh)
            with FakeOps() as fake:
                _, c = D.measure(step, args)
            got.append((c.peak(), c.aten_flops(), c.traffic.bytes,
                        c.kernels, fake.n))
    assert got[0][:4] == got[1][:4]
    assert got[1][4] == 0 and (got[0][4] > 0) == (kind == "train")
    assert (kind == "decode") == ("paged_decode" in got[0][3])


# --- each kernel's work ------------------------------------------------------
@pytest.mark.parametrize("B,Sq,Sk,H,K,D_,Dv,causal,window", [
    (1, 8, 8, 2, 1, 16, 16, True, 0), (2, 6, 10, 4, 2, 192, 128, False, 3)])
def test_flash_work_is_a_hand_count(B, Sq, Sk, H, K, D_, Dv, causal, window):
    pairs = sum(1 for t in range(Sq) for j in range(Sk)
                if (j <= t or not causal) and (not window or t - j < window))
    flops, nbytes = F.flash_prefill_work(B, Sq, Sk, H, K, D_, Dv,
                                         causal=causal, window=window)
    assert flops == 2 * (D_ + Dv) * B * H * pairs
    assert nbytes == 2 * (B * Sq * H * (D_ + Dv) + B * Sk * K * (D_ + Dv))
    if (Sq, causal, window) == (8, True, 0):
        assert pairs == 36


@pytest.mark.parametrize("B,H,K,dh,nb,lens", [
    (4, 24, 8, 128, 128, [2048, 1531, 1, 77]), (1, 12, 4, 128, 1, [1040])])
def test_paged_work_is_a_hand_count(B, H, K, dh, nb, lens):
    n_tok = sum(lens)
    flops, nbytes = P.paged_decode_work(B, H, K, dh, nb, n_tok)
    assert flops == sum(n * H * 2 * dh * 2 for n in lens)
    q_out = 2 * B * H * dh * 2
    assert nbytes == q_out + B * nb * 4 + B * 4 + 2 * n_tok * K * dh * 2
    assert P.paged_append_work(B, K, dh, B - 1) == \
        (0, 2 * (B - 1) * K * dh * 2 * 2 + 2 * B * 4)


@pytest.mark.parametrize("B,T,H,dh,state", [(4, 1024, 64, 64, False),
                                            (1, 1, 32, 64, True)])
def test_wkv6_work_is_a_hand_count(B, T, H, dh, state):
    flops, nbytes = R.wkv6_work(B, T, H, dh, state)
    steps = B * T * H
    assert flops == steps * (dh * dh * 5 + dh * 5)
    assert nbytes == (steps * dh * (2 + 2 + 2 + 4 + 4) + H * dh * 4
                      + (2 if state else 1) * B * H * dh * dh * 4)


@pytest.mark.parametrize("B,T,di,ds,state", [(2, 1024, 8192, 16, False),
                                             (1, 1, 4096, 16, True)])
def test_mamba_work_is_a_hand_count(B, T, di, ds, state):
    flops, nbytes = MS.mamba_scan_work(B, T, di, ds, state)
    assert flops == B * T * di * (7 * ds + 3)
    assert nbytes == (B * T * di * (2 + 2 + 4) + B * T * ds * (2 + 2)
                      + di * ds * 4 + di * 4
                      + (2 if state else 1) * B * di * ds * 4)


# --- remat, and the command line ---------------------------------------------
def train_flops(**opts):
    """(forward, backward) aten FLOPs of a tiny llama3.2 train cell on a
    (2, 2) mesh under the dry run's options changed by ``opts``: the
    backward's are those run inside an autograd node, the optimizer's are
    none."""
    cfg = tiny("llama3.2-3b")
    info = dict(seq=32, batch=4, kind="train")
    with tmesh.fake_world(4):
        mesh = tmesh.make_worker_mesh(4, tp=2, device_type="cpu")
        rec = D.run_cell(cfg.name, "train", mesh, dict(D.DEFAULT_OPTS,
                                                       **opts),
                         cfg=cfg, info=info)
    back = rec["aten_backward_flops_per_device"]
    return rec["aten_flops_per_device"] - back, back


def test_dots_counts_fewer_backward_flops_than_full_remat():
    """The forward's aten FLOPs equal under both policies, the backward's
    fewer under "dots" (the matmuls' outputs kept, not recomputed)."""
    fwd_full, back_full = train_flops(remat_policy="full")
    fwd_dots, back_dots = train_flops(remat_policy="dots")
    assert fwd_dots == fwd_full > 0
    assert 0 < back_dots < back_full


def test_tri_skips_the_key_blocks_no_query_sees():
    """``--attn-mode tri`` in blocks of 8 over 32 positions: the forward
    leaves out the 6 of 16 (query, key) block pairs above the causal
    diagonal, each layer's two products (scores and P.V) at the rank's
    rows and heads (tiny llama3.2's 3 heads do not split over 'model', so
    the attention takes the batch over both axes: one row a rank, every
    head); the backward counts fewer too."""
    cfg = tiny("llama3.2-3b")
    assert cfg.n_heads % 2
    fwd_full, back_full = train_flops(attn_block=8)
    fwd_tri, back_tri = train_flops(attn_block=8, attn_mode="tri")
    rows, heads, dh = 4 // 4, cfg.n_heads, cfg.head_dim
    pair = 2 * rows * heads * 8 * 8 * (dh + dh)
    assert fwd_full - fwd_tri == cfg.n_layers * 6 * pair
    assert 0 < back_tri < back_full


KEYS = {"arch", "shape", "status", "kind", "mesh", "axis_names", "n_chips",
        "opts", "memory", "collectives_by_kind", "roofline",
        "model_flops_per_chip", "useful_flops_ratio", "params_total",
        "params_active", "mesh_tag", "tag", "wall_s"}


def test_command_line_writes_a_cell(tmp_path):
    """``python -m repro_torch.launch.dryrun`` for one decode cell: its JSON
    at ``{out}/{tag}.{arch}.{shape}.{mesh}.json`` with the reference's keys
    and the H100's memory fields."""
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "llama3.2-3b", "--shape", "decode_32k", "--out", str(tmp_path),
         "--tag", "t"], capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")), cwd=tmp_path)
    assert res.returncode == 0, res.stderr[-3000:]
    rec = json.loads((tmp_path / "t.llama3.2-3b.decode_32k.single.json")
                     .read_text())
    assert KEYS <= set(rec), KEYS - set(rec)
    assert rec["status"] == "ok" and rec["mesh"] == [16, 16]
    mem = rec["memory"]
    assert {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
            "peak_per_device_gb", "fits_hbm_80gb"} <= set(mem)
    assert mem["alias_bytes"] > 0 and mem["fits_hbm_80gb"]
    assert set(rec["roofline"]) == {"compute_s", "memory_s", "collective_s",
                                    "dominant", "step_lower_bound_s"}
    assert rec["kernels"]["paged_decode"]["calls"] == 28
    assert not (tmp_path / "build").exists()
