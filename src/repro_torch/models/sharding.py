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

Gradients on a mesh.  Every rank differentiates its own program on its
local tensors: ``DTensor.from_local`` / ``to_local`` only wrap and unwrap
a shard, and every value that crosses ranks goes through a collective of
this module (``psum``, ``all_gather``, the gathers and cuts of
``ShardingEnv.cs``), an autograd function whose backward is its transpose
over the ranks.  The convention is that of the sum of the ranks'
programs: the objective is the sum over ranks of each rank's seeded
cotangent, each rank's copy of a value is a variable of its own, and a
collective transposes as a linear map of all the ranks' tensors:

  * a psum transposes to a psum;
  * an all-gather over an axis to a reduce-scatter over it (psum, then
    the rank's block), and a psum-then-cut to a psum of the padded
    cotangent, the values an all-gather gives;
  * a cut of a rank's own copy (``Replicate`` -> ``Shard``) is local: its
    transpose pads with zeros, with no collective;
  * a param leaf is the same value copied to every rank along the mesh
    axes it is replicated over: ``copies`` wraps each leaf so that its
    gradient is summed over those axes, and over no other;
  * the loss, equal on every rank, is seeded with each rank's share
    1/n of the cotangent (``rank_share``), so the ranks' seeds add up to
    the one loss's.

A computation that the ranks along an axis duplicate (``wk`` / ``wv`` on
a stream whole over 'model') is then counted once per rank at 1/n of the
cotangent each, and summed once where its inputs were copied; a value
used on the rank's shard of the sequence or the batch gets the rank's
share only, and the same sum adds the others'.  Backward sums run in f32
and round once.  ``even`` evens the ranks' shares of a replicated
value's cotangent: the sum is the same, but bf16 rounds it once, as on
one device (without it the CPU tests' bf16 ``sp=False`` cases of llava,
mixtral and deepseek-v2 read 2.07-2.36e-2 against their 2e-2 limit).  An FSDP-gathered weight is not kept
from its product to its transpose (``gathered_bmm`` gathers it again
there).  The ranks run their backward in the same order of
collectives, each on its own thread (a threaded world's rank threads take
the calling-thread backward, ``launch.mesh.threaded_world``).
"""
from __future__ import annotations

import itertools
import math
from functools import lru_cache
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

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
        reference's ``with_sharding_constraint``), by ``relayout``."""
        if self.mesh is None:
            return x
        from torch.distributed.tensor import DTensor
        if not isinstance(x, DTensor):
            raise TypeError(f"ShardingEnv.cs takes a DTensor on a mesh, "
                            f"not {type(x).__name__}")
        target = self.named(x.shape, list(wants)).placements
        if tuple(x.placements) == target:
            return x
        return relayout(x, target)

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


def _group(mesh, axis: str):
    return mesh.get_group(axis)


def _f32_psum(g, group):
    """The sum over ``group`` of every rank's ``g``, taken in f32 and
    rounded once to g's type: the backward's sums."""
    out = g.to(torch.float32, memory_format=torch.contiguous_format,
               copy=True)
    dist.all_reduce(out, group=group)
    return out.to(g.dtype)


def _gather(t, group, n, dim):
    """The ranks' blocks of ``t`` along ``dim`` (a new tensor)."""
    x = t.movedim(dim, 0).contiguous()
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    gather = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    gather(out, x, group=group)
    return out.movedim(0, dim)


def _reduce_scatter(g, group, dim):
    """This rank's block along ``dim`` of the sum over ``group`` of every
    rank's ``g``, summed in f32 and rounded once to g's type."""
    n = dist.get_world_size(group)
    x = g.movedim(dim, 0).to(torch.float32,
                             memory_format=torch.contiguous_format)
    out = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
    scatter = getattr(dist, "reduce_scatter_single", None) \
        or dist.reduce_scatter_tensor
    scatter(out, x, group=group)
    return out.to(g.dtype).movedim(0, dim)


class _AllReduce(torch.autograd.Function):
    """psum; transpose: psum."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return _f32_psum(g, ctx.group), None

class _AllGather(torch.autograd.Function):
    """Tiled all-gather along ``dim``; transpose: reduce-scatter."""

    @staticmethod
    def forward(ctx, t, group, n, dim):
        ctx.group, ctx.dim = group, dim
        return _gather(t, group, n, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.group, ctx.dim), None, None, None

class _GatheredBmm(torch.autograd.Function):
    """``bmm(x, w gathered along dim)``, the gathered weight kept for
    neither pass: the transpose gathers it again, and reduce-scatters
    its cotangent one row of the batch dim at a time."""

    @staticmethod
    def forward(ctx, x, w, group, n, dim):
        ctx.save_for_backward(x, w)
        ctx.group, ctx.n, ctx.dim = group, n, dim
        return torch.bmm(x, _gather(w, group, n, dim))

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        whole = _gather(w, ctx.group, ctx.n, ctx.dim)
        gx = torch.bmm(g, whole.transpose(1, 2))
        del whole
        gw = torch.bmm(x.transpose(1, 2), g)
        parts = [_reduce_scatter(gw[e:e + 1], ctx.group, ctx.dim)
                 for e in range(gw.shape[0])]
        return gx, torch.cat(parts), None, None, None

class _Copies(torch.autograd.Function):
    """Identity; transpose: the sum over ``groups`` (a param's
    copies)."""

    @staticmethod
    def forward(ctx, t, groups):
        ctx.groups = groups
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        if not ctx.groups:
            return g, None
        out = g.float()
        for group in ctx.groups:
            out = _f32_psum(out, group)
        return out.to(g.dtype), None

class _Share(torch.autograd.Function):
    """Identity; transpose: 1/n of the cotangent."""

    @staticmethod
    def forward(ctx, t, n):
        ctx.n = n
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None

class _Even(torch.autograd.Function):
    """Identity; transpose: the psum of the cotangent over ``groups``
    (f32), divided by their size."""

    @staticmethod
    def forward(ctx, t, groups):
        ctx.groups = groups
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        m, n = g.float(), 1
        for group in ctx.groups:
            m = _f32_psum(m, group)
            n *= dist.get_world_size(group)
        return (m / n).to(g.dtype), None


def _psum_mesh(t, mesh, axis: Optional[str]):
    names = tuple(mesh.mesh_dim_names)
    if axis is None or mesh.shape[names.index(axis)] == 1:
        return t
    return _AllReduce.apply(t, _group(mesh, axis))


def _gather_mesh(t, mesh, axis: str, dim: int):
    n = mesh.shape[tuple(mesh.mesh_dim_names).index(axis)]
    if n == 1:
        return t
    return _AllGather.apply(t, _group(mesh, axis), n, dim)


def psum(t, env: ShardingEnv, axis: Optional[str]):
    """``lax.psum`` of a rank's tensor over mesh axis ``axis`` (a new
    tensor); its transpose is a psum (summed in f32)."""
    if axis is None or env.axis_sizes.get(axis, 1) == 1:
        return t
    return _psum_mesh(t, env.mesh, axis)


def all_gather(t, env: ShardingEnv, axis: str, dim: int):
    """``lax.all_gather(t, axis, axis=dim, tiled=True)``: the ranks'
    blocks along ``dim`` in the axis' order; its transpose is a
    reduce-scatter (summed in f32)."""
    if env.axis_sizes.get(axis, 1) == 1:
        return t
    return _gather_mesh(t, env.mesh, axis, dim)


def gathered_bmm(x, w, env: ShardingEnv, axis: Optional[str], dim: int):
    """``torch.bmm(x, all_gather(w, axis, dim))`` for a weight split over
    ``axis`` (FSDP's), gathered in the forward and again in the backward
    and kept for neither, as FSDP reshards a weight after its use: a rank
    holds one gathered weight at a time.  The same arithmetic as the
    gather then the product."""
    if axis is None or env.axis_sizes.get(axis, 1) == 1:
        return torch.bmm(x, w)
    return _GatheredBmm.apply(x, w, _group(env.mesh, axis),
                        env.axis_sizes[axis], dim)


def pmax(t, env: ShardingEnv, axis: Optional[str]):
    """The largest value over mesh axis ``axis``, elementwise, outside
    autograd (a detached tensor)."""
    if axis is None or env.axis_sizes.get(axis, 1) == 1:
        return t.detach()
    out = t.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=_group(env.mesh, axis))
    return out


def rank_share(t, env: ShardingEnv):
    """``t``, a value equal on every rank (the loss), whose cotangent is
    each rank's 1/n share: the seeds of the n ranks add up to one."""
    n = math.prod(env.mesh.shape) if env.mesh is not None else 1
    return t if n == 1 else _Share.apply(t, n)


def even(t, env: ShardingEnv, axes):
    """``t``, a rank's copy of a value replicated over mesh ``axes``, as
    is; its transpose replaces each rank's share of the cotangent by the
    mean of the ranks' shares (an f32 psum, divided by their number).
    The sum over ranks, so the gradient, is the same; where the ranks
    along ``axes`` feed different work (their heads, their vocab slice)
    from one copied value, each share is otherwise a partial sum rounded
    on its own (bf16) through the layers below, where one device rounds
    the whole sum once."""
    groups = [_group(env.mesh, a) for a in axes
              if env.axis_sizes.get(a, 1) > 1]
    return _Even.apply(t, groups) if groups else t


def copies(tree):
    """Each DTensor leaf of a nested dict (a param) as a DTensor over an
    identity of its shard whose gradient is summed over the mesh axes
    the leaf is replicated over: the ranks along them hold copies of one
    value, and each computes with its own.  Other leaves pass."""
    if isinstance(tree, dict):
        return {k: copies(v) for k, v in tree.items()}
    from torch.distributed.tensor import DTensor
    if not isinstance(tree, DTensor):
        return tree
    mesh = tree.device_mesh
    groups = [_group(mesh, a) for a, pl, n in zip(mesh.mesh_dim_names,
                                                  tree.placements, mesh.shape)
              if pl.is_replicate() and n > 1]
    if not groups or not tree.requires_grad:
        return tree
    return DTensor.from_local(_Copies.apply(tree.to_local(), groups), mesh,
                              tree.placements, run_check=False,
                              shape=tree.shape, stride=tree.stride())


def _splits(pls, d: int):
    """The mesh dims that split tensor dim ``d``, in mesh order."""
    return [m for m, pl in enumerate(pls)
            if pl.is_shard() and pl.dim == d]


def _direct(x, mesh, target):
    """x's shard laid out as ``target`` by the collectives of this module:
    each ``Partial`` mesh dim summed (``psum``), then each tensor dim's
    shards that ``target`` does not keep gathered (innermost mesh dim
    first), then the shards it adds cut out of the rank's block (outermost
    first).  Shards of one tensor dim over several mesh dims nest in mesh
    order, as DTensor's ``Shard`` does.  None for a change it cannot make
    so (a strided shard, an uneven cut, a sum other than 'sum', a partial
    target)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    src = tuple(x.placements)
    if any(type(pl) not in (Shard, Replicate, Partial)
           for pl in src + tuple(target)):
        return None
    if any(isinstance(pl, Partial) for pl in target) or any(
            isinstance(pl, Partial) and pl.reduce_op != "sum" for pl in src):
        return None
    names, sizes = tuple(mesh.mesh_dim_names), tuple(mesh.shape)
    gathers, cuts = [], []
    for d in range(x.dim()):
        s, g = _splits(src, d), _splits(target, d)
        k = 0
        while k < min(len(s), len(g)) and s[k] == g[k]:
            k += 1
        gathers += [(m, d) for m in s[k:]]
        cuts += [(m, d) for m in g[k:]]
    t = x.to_local()
    for m, pl in enumerate(src):
        if isinstance(pl, Partial):
            t = _psum_mesh(t, mesh, names[m])
    for m, d in sorted(gathers, reverse=True):
        t = _gather_mesh(t, mesh, names[m], d)
    for m, d in sorted(cuts):
        if t.shape[d] % sizes[m]:
            return None
        n = t.shape[d] // sizes[m]
        t = t.narrow(d, mesh.get_local_rank(names[m]) * n, n)
    return t.contiguous()


def relayout(x, target):
    """The DTensor x laid out as ``target`` (placements): the sums,
    gathers and cuts of ``_direct`` on x's shard, past DTensor's
    ``redistribute`` (the sharded decode is host-bound, and that
    machinery costs several times the collective), under autograd with
    this module's transposes.  A change ``_direct`` cannot make goes
    through ``redistribute``, outside autograd only: its gradient follows
    another convention."""
    from torch.distributed.tensor import DTensor
    mesh = x.device_mesh
    local = _direct(x, mesh, target)
    if local is None:
        if x.requires_grad and torch.is_grad_enabled():
            raise NotImplementedError(
                f"relayout {tuple(x.placements)} -> {tuple(target)} under "
                f"autograd: only sums, gathers and cuts of whole shards "
                f"have their transposes here")
        return x.redistribute(mesh, target)
    return DTensor.from_local(local, mesh, target, run_check=False,
                              shape=x.shape,
                              stride=contiguous_strides(x.shape))


def whole(t):
    """A DTensor whole on this rank, as a local tensor (its shards
    gathered and its pending sums taken where it has any)."""
    from torch.distributed.tensor import Replicate
    if all(isinstance(pl, Replicate) for pl in t.placements):
        return t.to_local()
    return relayout(t, (Replicate(),) * t.device_mesh.ndim).to_local()


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
    no two ranks share memory and a cache can be updated in place.  The
    blocks are new leaves, outside any graph the whole tensors are in."""
    if isinstance(tree, dict):
        return {k: distribute(v, shardings[k]) for k, v in tree.items()}
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh, pls = shardings.mesh, shardings.placements
    shape, offset = compute_local_shape_and_global_offset(tree.shape, mesh,
                                                          pls)
    local = tree.detach()[tuple(slice(o, o + n)
                                for o, n in zip(offset, shape))].clone(
        memory_format=torch.contiguous_format)
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
