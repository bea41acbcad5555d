"""Logical-axis sharding rules for the model zoo, on DTensor meshes.

The twin of ``repro.models.sharding``, with its names and its logic:

  * The production mesh is ("data","model") single-pod or
    ("pod","data","model") multi-pod (``repro_torch.launch.mesh``), a
    ``torch.distributed.device_mesh.DeviceMesh`` with those dim names.
    "pod" behaves as an outer data-parallel axis; batch shards over
    ``batch_axes = ("pod","data")``.
  * Weights are 2-D sharded (FSDP over "data" x TP over "model").
  * Every rule is divisibility-checked: ``spec`` drops any mesh axis that
    does not divide the dim (e.g. seamless vocab=256206 is not divisible
    by 16 -> vocab stays unsharded).

A spec is the port's ``P``: one entry per tensor dim, ``None``, an axis
name, or a tuple of names with the major axis first, equal to
``tuple(jax_spec)`` of the reference's ``PartitionSpec``.  ``named`` puts
it on the mesh as DTensor placements, one per mesh dim.  A tensor dim
over two mesh axes is two shards of the same dim; where the spec's major
axis comes later in the mesh than its minor one (``("model", "data")`` on
a ("data","model") mesh) the earlier mesh dim is a ``_StridedShard``, so
that each rank holds JAX's slice, and that layout is checked against
JAX's order on every mesh coordinate before it is used (``placements``
raises where DTensor cannot give it).

``ShardingEnv(mesh=None)`` makes every constraint a no-op, so the same
model code runs on one device.  DTensor is imported where a mesh is used:
importing it adds about a second to importing the model code.
"""
from __future__ import annotations

import itertools
import math
from functools import lru_cache
from typing import Optional, Sequence, Tuple, Union

AxisEntry = Union[None, str, Tuple[str, ...]]


class P(tuple):
    """A partition spec: one entry per tensor dim (``None``, an axis name
    or a tuple of axis names, major first).  Compares equal to the tuple
    of the reference's ``PartitionSpec`` entries."""

    def __new__(cls, *entries: AxisEntry):
        return super().__new__(cls, entries)

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return "P(" + ", ".join(map(repr, self)) + ")"


def _axes(entry: AxisEntry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(mesh, spec: Sequence[AxisEntry]) -> tuple:
    """DTensor placements (one per mesh dim) that give every rank the
    slice JAX's ``NamedSharding(mesh, spec)`` gives the device at the same
    mesh coordinate."""
    from torch.distributed.tensor import Replicate
    names = tuple(mesh.mesh_dim_names)
    sizes = tuple(mesh.shape)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        dims = tuple(names.index(a) for a in _axes(entry))
        for i, m in enumerate(dims):
            if not isinstance(out[m], Replicate):
                raise ValueError(f"spec {spec}: mesh axis {names[m]!r} "
                                 "shards two tensor dims")
            out[m] = _placement(d, _split_factor(sizes, dims, i))
        if any(dims[i] > dims[i + 1] for i in range(len(dims) - 1)):
            _check_jax_order(sizes, dims)
    return tuple(out)


def _split_factor(sizes, dims, i) -> int:
    """The shards of the tensor dim already cut by axes more major than
    ``dims[i]`` that come after it in the mesh (DTensor cuts in mesh
    order)."""
    return math.prod(sizes[m] for m in dims[:i] if m > dims[i])


def _placement(d: int, split_factor: int):
    from torch.distributed.tensor import Shard
    if split_factor == 1:
        return Shard(d)
    try:
        from torch.distributed.tensor.placement_types import _StridedShard
    except ImportError as e:
        raise NotImplementedError(
            "a tensor dim sharded over mesh axes against the mesh's order "
            "needs DTensor's _StridedShard, which this torch lacks") from e
    return _StridedShard(d, split_factor=split_factor)


@lru_cache(maxsize=None)
def _check_jax_order(sizes: Tuple[int, ...], dims: Tuple[int, ...]) -> None:
    """Raise unless the placements for one tensor dim over mesh ``dims``
    (major first) put, at every mesh coordinate, the block JAX's order
    puts there: block index = the coordinates along ``dims`` read as one
    mixed-radix number, major first."""
    from torch.distributed.tensor import Replicate
    try:
        from torch.distributed.tensor._utils import \
            _compute_local_shape_and_global_offset as local_and_offset
    except ImportError as e:
        raise NotImplementedError(
            "cannot check a DTensor layout against JAX's order on this "
            "torch") from e
    pls = [Replicate()] * len(sizes)
    for i, m in enumerate(dims):
        pls[m] = _placement(0, _split_factor(sizes, dims, i))
    n = math.prod(sizes[m] for m in dims)
    for coord in itertools.product(*map(range, sizes)):
        want = 0
        for m in dims:
            want = want * sizes[m] + coord[m]
        shape, offset = local_and_offset((n,), sizes, list(coord), pls)
        if tuple(shape) != (1,) or tuple(offset) != (want,):
            raise NotImplementedError(
                f"DTensor places block {tuple(offset)} of shape "
                f"{tuple(shape)} at mesh coordinate {coord} where JAX's "
                f"order puts block {want} (mesh {sizes}, dims {dims})")


def spec_of(mesh, pls, ndim: int) -> P:
    """The spec whose ``placements`` on ``mesh`` are ``pls``: the inverse
    of ``placements``, a tensor dim over two or more mesh axes read back
    in the major-first order that gives the same placements."""
    names = tuple(mesh.mesh_dim_names)
    per_dim = [[] for _ in range(ndim)]
    for m, pl in enumerate(pls):
        if pl.is_replicate():
            continue
        if not pl.is_partial() and isinstance(getattr(pl, "dim", None), int):
            per_dim[pl.dim].append(names[m])     # Shard or _StridedShard
        else:
            raise ValueError(f"spec_of: {pl} on mesh axis {names[m]!r} is "
                             "not a layout (reduce it first)")
    out = []
    for d, axes in enumerate(per_dim):
        if len(axes) <= 1:
            out.append(axes[0] if axes else None)
            continue
        for order in itertools.permutations(axes):
            want = placements(mesh, [None] * d + [order])
            if all(type(want[m]) is type(pls[m]) and want[m] == pls[m]
                   for m in map(names.index, axes)):
                out.append(order)
                break
        else:
            raise ValueError(f"spec_of: no axis order of {axes} gives "
                             f"{pls}")
    return P(*out)


class NamedSharding:
    """A spec on a mesh: ``placements`` holds one DTensor placement per
    mesh dim (the reference's ``jax.sharding.NamedSharding``)."""

    def __init__(self, mesh, spec: P):
        self.mesh = mesh
        self.spec = spec
        self.placements = placements(mesh, spec)

    def shard_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        """Every rank's local shape (the spec divides each dim evenly)."""
        sizes = dict(zip(self.mesh.mesh_dim_names, self.mesh.shape))
        out = []
        for dim, entry in zip(shape, self.spec):
            n = math.prod(sizes[a] for a in _axes(entry))
            if dim % n:
                raise ValueError(f"dim {dim} does not split {n} ways "
                                 f"({self.spec})")
            out.append(dim // n)
        return tuple(out)

    def __repr__(self) -> str:
        return f"NamedSharding({self.spec!r}, {self.placements})"


class ShardingEnv:
    """Mesh-aware helper: builds divisible specs and their placements."""

    def __init__(self, mesh=None, opts: Optional[dict] = None):
        self.mesh = mesh
        # forward-pass options: attn_mode (full|tri), moe_impl (ep|dense),
        # remat (bool), remat_policy (full|dots), sp (bool), loss_chunk (int)
        self.opts = dict(opts or {})
        self._named = {}
        if mesh is not None:
            if mesh.mesh_dim_names is None:
                raise ValueError("ShardingEnv needs a mesh with "
                                 "mesh_dim_names")
            self.axis_sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
        else:
            self.axis_sizes = {}

    # -- axis groups -------------------------------------------------
    @property
    def batch_axes(self) -> Tuple[str, ...]:
        if "pod" in self.axis_sizes:
            return ("pod", "data")
        return ("data",) if "data" in self.axis_sizes else ()

    @property
    def fsdp_axis(self) -> Optional[str]:
        # opts['fsdp']=False: serving deployments replicate weights over
        # 'data' (no optimizer state to shard) and kill weight gathers
        if not self.opts.get("fsdp", True):
            return None
        return "data" if "data" in self.axis_sizes else None

    @property
    def tp_axis(self) -> Optional[str]:
        return "model" if "model" in self.axis_sizes else None

    @property
    def tp(self) -> int:
        return self.axis_sizes.get("model", 1)

    @property
    def dp(self) -> int:
        n = self.axis_sizes.get("data", 1)
        n *= self.axis_sizes.get("pod", 1)
        return n

    def axis_size(self, entry: AxisEntry) -> int:
        if entry is None:
            return 1
        if isinstance(entry, str):
            return self.axis_sizes.get(entry, 1)
        n = 1
        for a in entry:
            n *= self.axis_sizes.get(a, 1)
        return n

    # -- spec construction -------------------------------------------
    def spec(self, dims: Sequence[int], wants: Sequence[AxisEntry]) -> P:
        """Spec keeping only axes that divide the dim evenly."""
        assert len(dims) == len(wants), (dims, wants)
        out = []
        for dim, want in zip(dims, wants):
            if want is None or not self.axis_sizes:
                out.append(None)
                continue
            entries = (want,) if isinstance(want, str) else tuple(want)
            kept = []
            size = 1
            for a in entries:
                asz = self.axis_sizes.get(a, 1)
                if asz > 1 and dim % (size * asz) == 0:
                    kept.append(a)
                    size *= asz
            if not kept:
                out.append(None)
            elif len(kept) == 1:
                out.append(kept[0])
            else:
                out.append(tuple(kept))
        return P(*out)

    def named(self, dims: Sequence[int], wants: Sequence[AxisEntry]):
        """The ``NamedSharding`` of ``spec(dims, wants)`` (None without a
        mesh), made once per spec: the sharded model asks for the same
        ones at every layer and step."""
        if self.mesh is None:
            return None
        spec = self.spec(dims, wants)
        sh = self._named.get(spec)
        if sh is None:
            sh = self._named[spec] = NamedSharding(self.mesh, spec)
        return sh

    def cs(self, x, *wants: AxisEntry):
        """Redistribute a DTensor to the divisibility-checked spec (the
        reference's ``with_sharding_constraint``).  A change that only
        sums, gathers or cuts whole dims (``_direct``) runs as those
        collectives on x's shard, past DTensor's ``redistribute``: the
        sharded decode is host-bound, and that machinery costs several
        times the collective."""
        if self.mesh is None:
            return x
        from torch.distributed.tensor import DTensor
        if not isinstance(x, DTensor):
            raise TypeError(f"ShardingEnv.cs takes a DTensor on a mesh, "
                            f"not {type(x).__name__}")
        target = self.named(x.shape, list(wants)).placements
        if tuple(x.placements) == target:
            return x
        local = _direct(x, self, target)
        if local is None:
            return x.redistribute(self.mesh, target)
        return DTensor.from_local(local, self.mesh, target, run_check=False,
                                  shape=x.shape,
                                  stride=contiguous_strides(x.shape))

    # -- family decisions --------------------------------------------
    def heads_shardable(self, n_heads: int) -> bool:
        return self.tp > 1 and n_heads % self.tp == 0

    def moe_ep(self, n_experts: int) -> bool:
        """True -> expert-parallel over 'model'; False -> d_ff TP."""
        return self.tp > 1 and n_experts % self.tp == 0


def axis_index(env: ShardingEnv, entry: AxisEntry) -> int:
    """The block of a dim split over ``entry``'s mesh axes that this rank
    holds, in JAX's order: the axes' coordinates read as one mixed-radix
    number, major first."""
    i = 0
    for a in _axes(entry):
        i = i * env.axis_sizes[a] + env.mesh.get_local_rank(a)
    return i


def psum(t, env: ShardingEnv, axis: Optional[str]):
    """``lax.psum`` of a rank's tensor over mesh axis ``axis`` (a new
    tensor)."""
    import torch
    import torch.distributed as dist
    if axis is None or env.axis_sizes.get(axis, 1) == 1:
        return t
    out = t.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=env.mesh.get_group(axis))
    return out


def all_gather(t, env: ShardingEnv, axis: str, dim: int):
    """``lax.all_gather(t, axis, axis=dim, tiled=True)``: the ranks'
    blocks along ``dim`` in the axis' order."""
    import torch.distributed as dist
    n = env.axis_sizes.get(axis, 1)
    if n == 1:
        return t
    x = t.movedim(dim, 0).contiguous()
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    gather = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    gather(out, x, group=env.mesh.get_group(axis))
    return out.movedim(0, dim)


def _direct(x, env: ShardingEnv, target):
    """x's shard laid out as ``target``, where each mesh dim that changes
    goes from a partial sum to Replicate or Shard(d) (a psum, then a cut),
    from Shard(d) to Replicate (an all-gather over its axis) or from
    Replicate to Shard(d) (a cut of this rank's block), and no tensor dim
    is split by two mesh dims before or after: the sums first, then the
    gathers, then the cuts.  None for any other change (a strided shard,
    a dim over two axes): DTensor's redistribute takes those."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    src = tuple(x.placements)
    for pls in (src, target):
        dims = [pl.dim for pl in pls if isinstance(pl, Shard)]
        if len(dims) != len(set(dims)) or any(
                type(pl) not in (Shard, Replicate, Partial) for pl in pls):
            return None
    if any(isinstance(pl, Partial) for pl in target) or any(
            isinstance(pl, Partial) and pl.reduce_op != "sum" for pl in src):
        return None
    t = x.to_local()
    names = env.mesh.mesh_dim_names
    for m, a in enumerate(src):
        if isinstance(a, Partial):
            t = psum(t, env, names[m])
    for m, (a, b) in enumerate(zip(src, target)):
        if isinstance(a, Shard) and a != b:
            if not isinstance(b, Replicate):
                return None
            t = all_gather(t, env, names[m], a.dim)
    for m, (a, b) in enumerate(zip(src, target)):
        if isinstance(b, Shard) and a != b:
            n = t.shape[b.dim] // env.axis_sizes[names[m]]
            t = t.narrow(b.dim, env.mesh.get_local_rank(names[m]) * n, n)
    return t.contiguous()


def tree_map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` on every leaf of a nested dict, ``path`` the
    tuple of keys down to it (a dict flattens by key, as in JAX)."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    return fn(path, tree)


def param_pspecs(abstract_params, env: ShardingEnv, rules):
    """Map an abstract param tree -> tree of ``NamedSharding`` via path
    rules.

    ``rules(path, shape) -> list[AxisEntry]`` must return the per-dim axis
    wish list; divisibility pruning happens here.
    """
    def visit(path, leaf):
        wants = rules("/".join(str(p) for p in path), leaf.shape)
        return env.named(leaf.shape, wants)

    return tree_map_with_path(visit, abstract_params)


def distribute(tree, shardings):
    """Every leaf of a nested dict (each rank holding it whole) as the
    DTensor its ``NamedSharding`` in ``shardings`` lays out: each rank
    copies its own block out of its own whole tensor (no data moves), so
    no two ranks share memory and a cache can be updated in place."""
    if isinstance(tree, dict):
        return {k: distribute(v, shardings[k]) for k, v in tree.items()}
    import torch
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh, pls = shardings.mesh, shardings.placements
    shape, offset = compute_local_shape_and_global_offset(tree.shape, mesh,
                                                          pls)
    local = tree[tuple(slice(o, o + n) for o, n in zip(offset, shape))
                 ].clone(memory_format=torch.contiguous_format)
    return DTensor.from_local(local, mesh, pls, run_check=False,
                              shape=tree.shape,
                              stride=contiguous_strides(tree.shape))


def contiguous_strides(shape) -> Tuple[int, ...]:
    """The strides of a contiguous tensor of ``shape``: a DTensor's global
    strides."""
    out, n = [], 1
    for d in reversed(tuple(shape)):
        out.append(n)
        n *= d
    return tuple(reversed(out))
