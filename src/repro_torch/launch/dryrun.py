"""Dry run of every (arch x shape) cell on the production meshes: the twin
of ``repro.launch.dryrun``.

    python -m repro_torch.launch.dryrun --arch all --shape all --mesh single

This process is rank 0 of a fake world of 512 (``launch.mesh.fake_world``:
torch's fake backend, no data moves) and builds the reference's meshes,
``make_production_mesh(multi_pod=..., device_type="cpu")``.  Each cell's
params, AdamW moments, caches and inputs are meta-device DTensors laid out
by ``launch.specs.input_specs`` (``param_shardings``, ``opt_pspecs``,
``cache_pspecs``): nothing is allocated.  The cell's step (``make_step_fn``,
the twin of the reference's: train = ``launch.train.make_train_step``,
``forward_train`` + backward + AdamW, with remat on; prefill; one
``decode_step`` over a cache of the cell's length) runs once, eagerly, on
rank 0's meta shards under two counters:

- ``Memory`` (torch's ``MemTracker``): the peak bytes live on rank 0's
  device;
- ``Traffic``, this module's: each rank-local aten op's FLOPs by
  ``FlopCounterMode``'s formulas (``torch.utils.flop_counter.
  flop_registry``; the mode itself would count a DTensor-level matmul at
  its global shapes, and tries a decomposition of every other op, which
  triples the step's dispatches), those run inside an autograd node
  counted as the backward's (a remat's recompute among them), its input
  and output bytes (the counterpart of XLA's "bytes accessed"; a view
  costs nothing), and each collective (the ``c10d`` ops
  ``models/sharding.py`` calls and DTensor's functional ones) by kind,
  count, bytes and group.

Neither counter counts the ops DTensor's sharding propagation runs on
fake tensors to learn an op's output shapes: it runs them where its
caches miss, the first time a process meets an op at its shapes and
layouts, and a card allocates and computes nothing for them.  torch
2.13's MemTracker skips them itself; torch 2.11's counts them, which put
a process's first llama3.2-3b train step vocab x d_model x 6 bytes (an
f32 and a bf16 copy of the embedding) above every later one.  So a
cell's counts do not depend on where it falls in a process or a sweep
(``chip_smoke.py`` phase 16 measures its first cell twice on the card's
torch and holds the two equal).

``--attn-mode tri`` reaches the train cells' blocked attention
(``layers.chunked_attention_train`` skips the key blocks a query block
cannot see); a prefill cell's ``flash_prefill`` skips them under either
mode, so its counts do not change.

The five kernel wrappers take their dry-run route (``kernels.build.
dry_run``): the CUDA path's output and scratch on meta, their calls and
work tallied, nothing launched.  The FLOPs and bytes are the aten counts
plus the kernels' tallied work.  The eager step runs every layer, so the
counts are those of the full depth: ``--no-slopes`` is taken and changes
nothing (the reference extrapolates two unrolled reduced-depth compiles
because XLA counts a loop body once).

``memory``, for eager PyTorch (bytes on rank 0's device):
  argument_bytes  the step's inputs (params, moments, batch or cache);
  output_bytes    the step's outputs (loss, logits, a new cache) and the
                  arguments it writes in place (params, moments, cache);
  alias_bytes     the outputs written in place of an argument (a decode's
                  cache, the train step's params and moments);
  peak_bytes      ``Memory``'s peak, the arguments included;
  temp_bytes      peak less arguments.
The numbers are not XLA's and are not compared with them; ``chip_smoke.py``
phase 16 holds the peak, the FLOPs and the kernels' calls to the same step
run on the card.

The roofline takes an H100 SXM5 80GB's data sheet (700 W): dense bf16
989e12 FLOP/s, HBM3 3.35e12 B/s, NVLink 4 at 450e9 B/s each way within a
node of 8 cards, one 400 Gb/s NDR port (50e9 B/s) a card for a group that
spans nodes (every axis of the production meshes: "model" is 16 wide, and
"data" strides by 16).  ``fits_hbm_80gb`` compares the peak against the
card's ``total_memory`` as an NVIDIA H100 80GB HBM3 reports it.

One JSON a cell, ``{out}/{tag}.{arch}.{shape}.{mesh}.json``; a cell that
raises is recorded as ``status: "error"`` and the sweep goes on.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist
from torch._guards import active_fake_mode
from torch.distributed._tools.mem_tracker import MemTracker
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import ARCH_IDS, get_config, load_all
from repro_torch.kernels import build
from repro_torch.launch.mesh import fake_world, make_production_mesh
from repro_torch.launch.specs import SHAPES, cell_supported, input_specs
from repro_torch.launch.train import make_train_step
from repro_torch.models import lm
from repro_torch.models.sharding import ShardingEnv, distribute

# --- NVIDIA H100 SXM5 80GB (700 W) data sheet -----------------------------
PEAK_FLOPS = 989e12          # dense bf16 FLOP/s a card
HBM_BW = 3.35e12             # HBM3, B/s a card
NVLINK_BW = 450e9            # NVLink 4, B/s each way, within a node
NET_BW = 50e9                # one 400 Gb/s NDR port a card, across nodes
NODE = 8                     # cards a node
HBM_BYTES = 85_017_493_504   # total_memory an NVIDIA H100 80GB HBM3 reports

# the reference's command-line defaults (``repro/launch/dryrun.py``)
DEFAULT_OPTS = {"attn_mode": "full", "moe_impl": "ep", "sp": True,
                "remat_policy": "full", "fsdp": True, "rs_matmul": False,
                "cache_2d": False, "serve_fullshard": False}

_COLL_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")
# the collective ops (c10d's in-place ones, and the functional ones DTensor
# calls) by the reference's kinds; the tensor whose bytes count is the
# largest one the op touches (the full tensor), as the reference takes
# the largest shape on the HLO line
_COLLECTIVES = {
    "allreduce_": "all-reduce", "all_reduce": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "all_to_all_single": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
    "broadcast_": "collective-permute",
}
# ops that move no data
_FREE = {"detach", "empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "lift_fresh", "_local_scalar_dense", "wait",
         "wait_tensor", "_assert_async", "set_", "resize_"}


def _is_dtensor_type(types) -> bool:
    from torch.distributed.tensor import DTensor
    return any(t is DTensor for t in types)


def _tensors(tree):
    """The tensors of nested lists, tuples and dicts, in order (a loop, not
    a recursive closure: a closure that calls itself is a reference
    cycle, which would hold the op's outputs until the cyclic collector
    ran and so move the measured peak)."""
    out, todo = [], [tree]
    while todo:
        x = todo.pop()
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            todo.extend(reversed(x))
        elif isinstance(x, dict):
            todo.extend(reversed(list(x.values())))
    return out


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _group_ranks(arg):
    """The global ranks of a collective's group, given as a process group
    (c10d's ops) or its name (the functional ones); None if neither."""
    from torch.distributed.distributed_c10d import _resolve_process_group
    try:
        pg = _resolve_process_group(arg) if isinstance(arg, str) else arg
        return dist.get_process_group_ranks(pg)
    except Exception:                   # noqa: BLE001 (not a group)
        return None


class Traffic(TorchDispatchMode):
    """Counts each rank-local aten op: its FLOPs by ``FlopCounterMode``'s
    formulas (``torch.utils.flop_counter.flop_registry``: the matmuls,
    convolutions and attentions), in ``backward_flops`` too where it runs
    inside an autograd node, its input and output bytes (a view op none;
    an in-place op reads its inputs and writes its output), and each
    collective's kind, bytes and whether its group spans nodes of
    ``NODE`` cards.  DTensor-level ops are left to DTensor, whose local
    ops come back through the mode (counted at the DTensor level, a
    matmul would count its global shapes)."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.formulas = flop_registry
        self.flops = 0
        self.backward_flops = 0
        self.bytes = 0
        self.coll = {k: 0 for k in _COLL_KINDS}
        self.counts = {k: 0 for k in _COLL_KINDS}
        self.coll_s = 0.0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _is_dtensor_type(types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if active_fake_mode() is not None:      # DTensor's propagation
            return out
        packet = func._overloadpacket
        if packet in self.formulas:
            n = self.formulas[packet](*args, **kwargs, out_val=out)
            self.flops += n
            if torch._C._current_autograd_node() is not None:
                self.backward_flops += n
        name = packet.__name__
        kind = _COLLECTIVES.get(name) if func.namespace in (
            "c10d", "_c10d_functional") else None
        if kind is not None:
            n = max((_nbytes(t) for t in _tensors((args, kwargs, out))),
                    default=0)
            self.coll[kind] += n
            self.counts[kind] += 1
            ranks = next((r for r in map(_group_ranks, list(args)
                                         + list(kwargs.values()))
                          if r is not None), None)
            spans = ranks is None or max(ranks) // NODE != min(ranks) // NODE
            self.coll_s += (2 if kind == "all-reduce" else 1) * n / (
                NET_BW if spans else NVLINK_BW)
        elif not func.is_view and name not in _FREE:
            self.bytes += sum(map(_nbytes, _tensors((args, kwargs)))) \
                + sum(map(_nbytes, _tensors(out)))
        return out


class Memory(MemTracker):
    """MemTracker without the ops run under a fake mode (DTensor's
    sharding propagation: the module docstring)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not _is_dtensor_type(types) and active_fake_mode() is not None:
            return func(*args, **(kwargs or {}))
        return super().__torch_dispatch__(func, types, args, kwargs)


class Counters:
    """The kernels' tally, ``Memory`` and ``Traffic`` over one step,
    entered in that order (``with Counters() as c:``); ``track(*trees)``
    before entering registers the arguments with ``Memory``."""

    def __init__(self):
        self.mem = Memory()
        self.traffic = Traffic()
        self.kernels = {}
        self._stack = None

    def track(self, *trees):
        self.mem.track_external(*_tensors(list(trees)))

    def __enter__(self):
        self._stack = contextlib.ExitStack()
        self.kernels = self._stack.enter_context(build.dry_run())
        for mode in (self.mem, self.traffic):
            self._stack.enter_context(mode)
        return self

    def __exit__(self, *exc):
        return self._stack.__exit__(*exc)

    def peak(self) -> int:
        return sum(snap["Total"] for snap in
                   self.mem.get_tracker_snapshot("peak").values())

    def aten_flops(self) -> int:
        return int(self.traffic.flops)


def local_bytes(tree) -> int:
    """Bytes of rank 0's storages under ``tree`` (a DTensor's local
    shard), each storage once."""
    from torch.distributed.tensor import DTensor
    seen, n = set(), 0
    for t in _tensors(tree):
        st = (t.to_local() if isinstance(t, DTensor) else t).untyped_storage()
        if st._cdata not in seen:
            seen.add(st._cdata)
            n += st.nbytes()
    return n


def make_step_fn(cfg, env, kind: str, seq: int):
    """The cell's step, the twin of the reference's ``make_step_fn``.
    train: ``launch.train.make_train_step``'s (``forward_train`` on the
    mesh, its backward, one AdamW step on the params and moments in place;
    returns (loss, gnorm)).  prefill: ``lm.prefill(..., max_len=seq)``.
    decode: one ``lm.decode_step``.  The serving steps run under
    ``torch.no_grad()``."""
    if kind == "train":
        return make_train_step(cfg, 3e-4, env=env)
    if kind == "prefill":
        @torch.no_grad()
        def prefill_step(params, batch):
            return lm.prefill(params, batch, cfg, env, max_len=seq)
        return prefill_step

    @torch.no_grad()
    def serve_step(params, tokens, cache, pos):
        return lm.decode_step(params, tokens, cache, pos, cfg, env)
    return serve_step


def _put(x, sh, mesh):
    from torch.distributed.tensor import distribute_tensor
    if sh is None:
        return x
    if isinstance(x, dict):
        return distribute(x, sh)
    return distribute_tensor(x, mesh, sh.placements)


def place(spec, mesh, values=None):
    """The cell's arguments laid out on ``mesh`` by their shardings, as
    DTensors of rank 0's shards (a None sharding leaves its leaf as is):
    the meta stand-ins of ``spec``, or ``values``, real tensors of the
    same trees.  The train cell's params require grad."""
    from repro_torch.train.optimizer import OptState
    args = []
    for x, sh in zip(values or spec["args"], spec["in_shardings"]):
        if isinstance(x, OptState):
            x = OptState(mu=_put(x.mu, sh.mu, mesh),
                         nu=_put(x.nu, sh.nu, mesh), step=x.step)
        else:
            x = _put(x, sh, mesh)
        args.append(x)
    if spec["kind"] == "train":
        for t in _tensors(args[0]):
            t.requires_grad_(True)
    return args


def materialize(cfg, spec, device, seed: int = 0):
    """Real tensors on ``device`` for the trees of ``spec["args"]``: the
    params of ``lm.init_params(cfg, seed)``, zero moments and cache, token
    ids drawn from a generator seeded with ``seed`` (patches and frames
    normal x 0.02), a decode's position the cache's last one."""
    from repro_torch.train.optimizer import OptState, init_opt_state
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def fill(x):
        if isinstance(x, dict):
            return {k: fill(v) for k, v in x.items()}
        if x.dtype in (torch.int32, torch.int64):
            return torch.randint(0, cfg.vocab, tuple(x.shape), generator=gen,
                                 device=device, dtype=x.dtype)
        return (torch.randn(tuple(x.shape), generator=gen, device=device)
                * 0.02).to(x.dtype)

    params = lm.init_params(cfg, seed, device=device)
    kind = spec["kind"]
    if kind == "train":
        return [params, init_opt_state(params), fill(spec["args"][2])]
    if kind == "prefill":
        return [params, fill(spec["args"][1])]
    _, tokens, cache, _ = spec["args"]
    seq = next(iter(cache.values())).shape[2] \
        if "k" in cache or "ckv" in cache else 1
    return [params, fill(tokens),
            {k: torch.zeros(tuple(v.shape), dtype=v.dtype, device=device)
             for k, v in cache.items()},
            torch.tensor(seq - 1, dtype=torch.int32, device=device)]


def prepare(cfg, shape_name: str, mesh, opts: dict, info=None):
    """(env, spec, step) of a cell: its env (remat on for a train cell),
    ``input_specs`` and ``make_step_fn``.  Raises where the cell's
    layout does."""
    info = info or SHAPES[shape_name]
    opts = dict(opts, remat=(info["kind"] == "train"))
    env = ShardingEnv(mesh, opts=opts)
    spec = input_specs(cfg, shape_name, env, info=info)
    return env, spec, make_step_fn(cfg, env, spec["kind"], info["seq"])


def measure(step, args):
    """Run ``step(*args)`` once under ``Counters``; returns (outputs,
    counters)."""
    c = Counters()
    c.track(args)
    with c:
        out = step(*args)
    return out, c


def _roofline(flops, nbytes, coll_s):
    t_compute, t_memory = flops / PEAK_FLOPS, nbytes / HBM_BW
    dominant = max([("compute", t_compute), ("memory", t_memory),
                    ("collective", coll_s)], key=lambda kv: kv[1])[0]
    return {"compute_s": t_compute, "memory_s": t_memory,
            "collective_s": coll_s, "dominant": dominant,
            "step_lower_bound_s": max(t_compute, t_memory, coll_s)}


def _aliased(kind, args):
    """The arguments the step writes in place: the train step's params
    and moments, a decode's cache."""
    if kind == "train":
        return (args[0], args[1].mu, args[1].nu, args[1].step)
    return args[2] if kind == "decode" else ()


def _model_flops(cfg, info, n_chips):
    total, active = cfg.param_counts()
    total += cfg.vocab * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    B, S = info["batch"], info["seq"]
    if info["kind"] == "train":
        mf = 6 * active * B * S
    elif info["kind"] == "prefill":
        mf = 2 * active * B * S
    else:
        mf = 2 * active * B
    return mf / n_chips, total, active


def summarize(cfg, info, spec, mesh, args, out, c) -> dict:
    """The cell's record from one measured step (``measure``)."""
    arg_b, peak = local_bytes(args), c.peak()
    aliased = _aliased(spec["kind"], args)
    kern = {k: dict(v) for k, v in sorted(c.kernels.items())}
    aten = c.aten_flops()
    flops = aten + sum(v["flops"] for v in kern.values())
    nbytes = c.traffic.bytes + sum(v["bytes"] for v in kern.values())
    n_chips = int(mesh.mesh.numel())
    mf_chip, total, active = _model_flops(cfg, info, n_chips)
    rec = {
        "kind": spec["kind"], "mesh": list(mesh.mesh.shape),
        "axis_names": list(mesh.mesh_dim_names), "n_chips": n_chips,
        "memory": {
            "argument_bytes": arg_b,
            "output_bytes": local_bytes((out, aliased)),
            "temp_bytes": peak - arg_b,
            "alias_bytes": local_bytes(aliased),
            "peak_bytes": peak,
            "peak_per_device_gb": round(peak / 2**30, 3),
            "fits_hbm_80gb": bool(peak <= HBM_BYTES),
        },
        "aten_flops_per_device": aten,
        "flops_per_device": flops,
        "bytes_per_device": nbytes,
        "kernels": kern,
        "collective_bytes_per_device": sum(
            v * (2 if k == "all-reduce" else 1)
            for k, v in c.traffic.coll.items()),
        "collectives_by_kind": dict(c.traffic.coll),
        "collective_counts": dict(c.traffic.counts),
        "roofline": _roofline(flops, nbytes, c.traffic.coll_s),
        "model_flops_per_chip": mf_chip,
        "useful_flops_ratio": (mf_chip / flops) if flops else 0.0,
        "params_total": total, "params_active": active,
    }
    if spec["kind"] == "train":
        rec["aten_backward_flops_per_device"] = int(c.traffic.backward_flops)
    return rec


def run_cell(arch: str, shape_name: str, mesh, opts: dict, *, cfg=None,
             info=None):
    """One cell on ``mesh`` (meta DTensors, rank 0's shards): its status,
    memory, counts and roofline.  ``cfg`` replaces the arch's config (a
    cut depth, a tiny width), ``info`` the shape's (seq, batch, kind)."""
    cfg = cfg or get_config(arch)
    ok, why = cell_supported(cfg, shape_name)
    if not ok:
        return {"arch": arch, "shape": shape_name, "status": "skip",
                "reason": why}
    info = info or SHAPES[shape_name]
    env, spec, step = prepare(cfg, shape_name, mesh, opts, info)
    args = place(spec, mesh)
    t0 = time.time()
    out, c = measure(step, args)
    return {"arch": arch, "shape": shape_name, "status": "ok",
            "opts": dict(env.opts), "step_s": round(time.time() - t0, 1),
            **summarize(cfg, info, spec, mesh, args, out, c)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all",
                    help="one of %s or 'all'" % list(SHAPES))
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--attn-mode", default="full", choices=["full", "tri"],
                    help="the train cells' blocked attention: 'tri' skips "
                         "the key blocks a query block cannot see")
    ap.add_argument("--moe-impl", default="ep", choices=["ep", "dense"])
    ap.add_argument("--no-sp", action="store_true")
    ap.add_argument("--remat-policy", default="full",
                    choices=["full", "dots"])
    ap.add_argument("--no-fsdp", action="store_true",
                    help="serving mode: weights replicated over 'data' "
                         "(TP-only): no FSDP gathers")
    ap.add_argument("--cache-2d", action="store_true",
                    help="shard KV-cache sequence over (model x data)")
    ap.add_argument("--rs-matmul", action="store_true",
                    help="explicit reduce-scatter out-projections "
                         "(sequence-parallel)")
    ap.add_argument("--serve-fullshard", action="store_true",
                    help="decode mode: batch replicated, KV sharded over "
                         "(model x data), weights fully sharded")
    ap.add_argument("--no-slopes", action="store_true",
                    help="taken for the reference's command lines; the "
                         "eager step counts every layer, so it changes "
                         "nothing")
    args = ap.parse_args(argv)

    load_all()
    archs = ARCH_IDS if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    opts = {"attn_mode": args.attn_mode, "moe_impl": args.moe_impl,
            "sp": not args.no_sp, "remat_policy": args.remat_policy,
            "fsdp": not args.no_fsdp, "rs_matmul": args.rs_matmul,
            "cache_2d": args.cache_2d,
            "serve_fullshard": args.serve_fullshard}

    with fake_world(512):
        for multi in meshes:
            mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
            mesh_tag = "multi" if multi else "single"
            for arch in archs:
                for shape in shapes:
                    fname = outdir / (f"{args.tag}.{arch}.{shape}."
                                      f"{mesh_tag}.json")
                    if fname.exists() and not args.force:
                        print(f"[skip-existing] {fname}", flush=True)
                        continue
                    print(f"=== {arch} x {shape} x {mesh_tag} ===", flush=True)
                    t0 = time.time()
                    try:
                        res = run_cell(arch, shape, mesh, opts)
                    except Exception as e:  # record failures, keep sweeping
                        res = {"arch": arch, "shape": shape,
                               "status": "error", "error": repr(e),
                               "traceback": traceback.format_exc()[-4000:]}
                    res["mesh_tag"] = mesh_tag
                    res["tag"] = args.tag
                    res["wall_s"] = round(time.time() - t0, 1)
                    fname.write_text(json.dumps(res, indent=1))
                    _report(res)


def _report(res):
    if res["status"] == "ok":
        r = res["roofline"]
        print(f"  mem={res['memory']['peak_per_device_gb']}GB "
              f"compute={r['compute_s']:.4f}s hbm={r['memory_s']:.4f}s "
              f"net={r['collective_s']:.4f}s dom={r['dominant']} "
              f"useful={res['useful_flops_ratio']:.2f} "
              f"wall={res['wall_s']}s", flush=True)
    else:
        print(f"  {res['status']}: {res.get('reason', res.get('error'))}",
              flush=True)


if __name__ == "__main__":
    main()
