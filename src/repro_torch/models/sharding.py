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
        if self.mesh is None:
            return None
        return NamedSharding(self.mesh, self.spec(dims, wants))

    def cs(self, x, *wants: AxisEntry):
        """Redistribute a DTensor to the divisibility-checked spec (the
        reference's ``with_sharding_constraint``)."""
        if self.mesh is None:
            return x
        from torch.distributed.tensor import DTensor
        if not isinstance(x, DTensor):
            raise TypeError(f"ShardingEnv.cs takes a DTensor on a mesh, "
                            f"not {type(x).__name__}")
        sh = self.named(x.shape, list(wants))
        return x.redistribute(self.mesh, sh.placements)

    # -- family decisions --------------------------------------------
    def heads_shardable(self, n_heads: int) -> bool:
        return self.tp > 1 and n_heads % self.tp == 0

    def moe_ep(self, n_experts: int) -> bool:
        """True -> expert-parallel over 'model'; False -> d_ff TP."""
        return self.tp > 1 and n_experts % self.tp == 0


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
