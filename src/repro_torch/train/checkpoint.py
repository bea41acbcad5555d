"""Checkpoint / restart for the port's training, in the reference's file
format (``repro.train.checkpoint``): a checkpoint written by either
package restores in the other.

``step_%08d.npz`` holds ``params/<a>/<b>/...``, ``opt/.mu/<...>``,
``opt/.nu/<...>`` and ``opt/.step``, the key paths that
``jax.tree_util.tree_flatten_with_path`` gives the reference's trees (a
dict's keys sorted, the ``OptState`` fields as ``.mu``), bf16 stored as
f32 (npz has no bf16); ``step_%08d.json`` holds the step, the data
cursor and any extra; ``LATEST`` the last step written.  The archive is
written leaf by leaf as ``np.savez`` writes it (an uncompressed zip of
``.npy`` members), so no more than one leaf is ever on the host, and
read back member by member straight from the file (``_Npz``).

On a mesh the trees hold DTensors.  ``save_checkpoint`` is then called
by every rank: each leaf is gathered whole on every rank, one at a time,
and rank 0 alone writes it, so the file is the same one device writes.
``restore_checkpoint(..., shardings=...)`` reads each rank's block of
each leaf from the file and lays the leaves out as the given shardings,
so a checkpoint moves between one device, any mesh and the reference.
"""
from __future__ import annotations

import contextlib
import json
import struct
import sys
import zipfile
from pathlib import Path
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from numpy.lib import format as npy_format

from repro_torch.models import sharding


def _items(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(key path, leaf) in the reference's order and naming."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], f"{prefix}{k}/")
    elif hasattr(tree, "_fields"):                 # OptState
        for name in tree._fields:
            yield from _items(getattr(tree, name), f"{prefix}.{name}/")
    else:
        yield prefix[:-1], tree


def _host(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:               # npz cannot store bf16
        t = t.float()
    return t.cpu().numpy()


def _is_dtensor(t) -> bool:
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(t, mod.DTensor)


def save_checkpoint(ckpt_dir: str, step: int, params, opt_state=None,
                    data_state: Optional[dict] = None,
                    extra: Optional[dict] = None) -> str:
    """Writes the trees (plain tensors, or on a mesh DTensors: then every
    rank calls it, every rank gathers each leaf and rank 0 writes, and
    the ranks leave together)."""
    entries = [(f"params/{k}", v) for k, v in _items(params)]
    if opt_state is not None:
        entries += [(f"opt/{k}", v) for k, v in _items(opt_state)]
    meshed = any(_is_dtensor(v) for _, v in entries)
    writer = not meshed or dist.get_rank() == 0
    d = Path(ckpt_dir)
    path = d / f"step_{step:08d}.npz"
    if writer:
        d.mkdir(parents=True, exist_ok=True)
    with (zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                          allowZip64=True) if writer
          else contextlib.nullcontext()) as zf:
        for key, leaf in entries:
            if _is_dtensor(leaf):                # every rank gathers
                leaf = sharding.whole(leaf.detach())
            if writer:
                with zf.open(key + ".npy", "w", force_zip64=True) as fid:
                    npy_format.write_array(fid, _host(leaf),
                                           allow_pickle=False)
            del leaf
    if writer:
        meta = {"step": step, "data_state": data_state or {},
                "extra": extra or {}}
        (d / f"step_{step:08d}.json").write_text(json.dumps(meta))
        (d / "LATEST").write_text(str(step))
    if meshed:
        dist.barrier()
    return str(path)


class _Npz:
    """The arrays of an npz by key.  A stored (uncompressed) member, as
    ``np.savez`` and ``save_checkpoint`` write them, is read with one
    ``np.fromfile`` from its offset in the file: ``np.load`` streams it
    through ``zipfile`` 256 KiB at a time and checks its CRC, about 1 GB/s
    at best.  A compressed member goes through ``zipfile``."""

    def __init__(self, path):
        self.zip = zipfile.ZipFile(path)
        self.file = open(path, "rb")
        self.members = {i.filename[:-len(".npy")]: i
                        for i in self.zip.infolist()}

    def _header(self, info):
        """(shape, fortran order, dtype) of a stored member, the file
        positioned at its data."""
        f = self.file
        f.seek(info.header_offset)
        local = f.read(30)                      # the local file header
        name_len, extra_len = struct.unpack("<HH", local[26:30])
        f.seek(info.header_offset + 30 + name_len + extra_len)
        version = npy_format.read_magic(f)
        read_header = {(1, 0): npy_format.read_array_header_1_0,
                       (2, 0): npy_format.read_array_header_2_0}[version]
        return read_header(f)

    def __getitem__(self, key: str) -> np.ndarray:
        info = self.members[key]
        if info.compress_type != zipfile.ZIP_STORED:
            with self.zip.open(info) as fid:
                return npy_format.read_array(fid, allow_pickle=False)
        shape, fortran, dtype = self._header(info)
        arr = np.fromfile(self.file, dtype=dtype, count=int(np.prod(shape)))
        return arr.reshape(shape, order="F" if fortran else "C")

    def block(self, key: str, index) -> np.ndarray:
        """``self[key][index]`` (a tuple of slices), reading no more of a
        stored C-order member than the rows the block spans."""
        info = self.members[key]
        if info.compress_type != zipfile.ZIP_STORED:
            return self[key][index]
        shape, fortran, dtype = self._header(info)
        if fortran:
            return self[key][index]
        arr = np.memmap(self.file, dtype=dtype, mode="r",
                        offset=self.file.tell(), shape=tuple(shape))
        return np.array(arr[index])

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.file.close()
        self.zip.close()


def latest_step(ckpt_dir: str) -> Optional[int]:
    f = Path(ckpt_dir) / "LATEST"
    if not f.exists():
        return None
    return int(f.read_text().strip())


def _rebuild(abstract, data, prefix: str, device, shardings=None):
    """The tree of ``abstract`` (meta tensors: shapes and types) filled
    from ``data``'s arrays, on ``device``; where ``shardings`` (a tree like
    ``abstract``) gives a leaf a ``NamedSharding``, the leaf is this
    rank's block of it, as a DTensor laid out so."""
    def leaf(key, a, sh):
        name = f"{prefix}/{key}"
        if sh is None:
            arr = np.asarray(data[name])
            if tuple(arr.shape) != tuple(a.shape):
                raise ValueError(f"checkpoint {name}: shape {arr.shape}, "
                                 f"expected {tuple(a.shape)}")
            return torch.from_numpy(arr).to(device=device, dtype=a.dtype)
        from torch.distributed.tensor import DTensor
        from torch.distributed.tensor._utils import \
            compute_local_shape_and_global_offset
        info = data.members[name]
        shape = (data._header(info)[0]
                 if info.compress_type == zipfile.ZIP_STORED
                 else data[name].shape)
        if tuple(shape) != tuple(a.shape):
            raise ValueError(f"checkpoint {name}: shape {tuple(shape)}, "
                             f"expected {tuple(a.shape)}")
        local, offset = compute_local_shape_and_global_offset(
            a.shape, sh.mesh, sh.placements)
        arr = data.block(name, tuple(slice(o, o + n)
                                     for o, n in zip(offset, local)))
        return DTensor.from_local(
            torch.from_numpy(np.ascontiguousarray(arr)).to(
                device=device, dtype=a.dtype),
            sh.mesh, sh.placements, run_check=False, shape=a.shape,
            stride=sharding.contiguous_strides(a.shape))

    def walk(tree, sh, path=""):
        if isinstance(tree, dict):
            return {k: walk(v, None if sh is None else sh[k], f"{path}{k}/")
                    for k, v in tree.items()}
        if hasattr(tree, "_fields"):
            return type(tree)(*(walk(getattr(tree, n),
                                     None if sh is None else getattr(sh, n),
                                     f"{path}.{n}/")
                                for n in tree._fields))
        return leaf(path[:-1], tree, sh)

    return walk(abstract, shardings)


def restore_checkpoint(ckpt_dir: str, abstract_params, abstract_opt=None,
                       step: Optional[int] = None, device="cuda",
                       shardings=None
                       ) -> Tuple[int, Dict[str, Any], Any, dict]:
    """(step, params, opt state or None, meta) from the checkpoint at
    ``step`` (the latest where not given), rebuilt on the trees of
    ``lm.abstract_params`` / ``optimizer.abstract_opt_state`` and put on
    ``device``.  ``shardings``: on a mesh, (the params' shardings, the
    state's), as ``lm.param_shardings`` and ``optimizer.opt_pspecs`` give
    them (a None leaf, as the step's, is read whole); each rank then
    reads its blocks and gets DTensors laid out so."""
    sh_p, sh_o = shardings if shardings is not None else (None, None)
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    d = Path(ckpt_dir)
    meta = json.loads((d / f"step_{step:08d}.json").read_text())
    with _Npz(d / f"step_{step:08d}.npz") as data:
        params = _rebuild(abstract_params, data, "params", device, sh_p)
        opt = (_rebuild(abstract_opt, data, "opt", device, sh_o)
               if abstract_opt is not None else None)
    return step, params, opt, meta
