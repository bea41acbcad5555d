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
"""
from __future__ import annotations

import json
import struct
import zipfile
from pathlib import Path
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
from numpy.lib import format as npy_format


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


def save_checkpoint(ckpt_dir: str, step: int, params, opt_state=None,
                    data_state: Optional[dict] = None,
                    extra: Optional[dict] = None) -> str:
    d = Path(ckpt_dir)
    d.mkdir(parents=True, exist_ok=True)
    path = d / f"step_{step:08d}.npz"
    entries = [(f"params/{k}", v) for k, v in _items(params)]
    if opt_state is not None:
        entries += [(f"opt/{k}", v) for k, v in _items(opt_state)]
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, leaf in entries:
            with zf.open(key + ".npy", "w", force_zip64=True) as fid:
                npy_format.write_array(fid, _host(leaf), allow_pickle=False)
    meta = {"step": step, "data_state": data_state or {},
            "extra": extra or {}}
    (d / f"step_{step:08d}.json").write_text(json.dumps(meta))
    (d / "LATEST").write_text(str(step))
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

    def __getitem__(self, key: str) -> np.ndarray:
        info = self.members[key]
        if info.compress_type != zipfile.ZIP_STORED:
            with self.zip.open(info) as fid:
                return npy_format.read_array(fid, allow_pickle=False)
        f = self.file
        f.seek(info.header_offset)
        local = f.read(30)                      # the local file header
        name_len, extra_len = struct.unpack("<HH", local[26:30])
        f.seek(info.header_offset + 30 + name_len + extra_len)
        version = npy_format.read_magic(f)
        read_header = {(1, 0): npy_format.read_array_header_1_0,
                       (2, 0): npy_format.read_array_header_2_0}[version]
        shape, fortran, dtype = read_header(f)
        arr = np.fromfile(f, dtype=dtype, count=int(np.prod(shape)))
        return arr.reshape(shape, order="F" if fortran else "C")

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


def _rebuild(abstract, data, prefix: str, device):
    """The tree of ``abstract`` (meta tensors: shapes and types) filled
    from ``data``'s arrays, on ``device``."""
    def leaf(key, a):
        arr = np.asarray(data[f"{prefix}/{key}"])
        if tuple(arr.shape) != tuple(a.shape):
            raise ValueError(f"checkpoint {prefix}/{key}: shape "
                             f"{arr.shape}, expected {tuple(a.shape)}")
        return torch.from_numpy(arr).to(device=device, dtype=a.dtype)

    def walk(tree, path=""):
        if isinstance(tree, dict):
            return {k: walk(v, f"{path}{k}/") for k, v in tree.items()}
        if hasattr(tree, "_fields"):
            return type(tree)(*(walk(getattr(tree, n), f"{path}.{n}/")
                                for n in tree._fields))
        return leaf(path[:-1], tree)

    return walk(abstract)


def restore_checkpoint(ckpt_dir: str, abstract_params, abstract_opt=None,
                       step: Optional[int] = None, device="cuda"
                       ) -> Tuple[int, Dict[str, Any], Any, dict]:
    """(step, params, opt state or None, meta) from the checkpoint at
    ``step`` (the latest where not given), rebuilt on the trees of
    ``lm.abstract_params`` / ``optimizer.abstract_opt_state`` and put on
    ``device``."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    d = Path(ckpt_dir)
    meta = json.loads((d / f"step_{step:08d}.json").read_text())
    with _Npz(d / f"step_{step:08d}.npz") as data:
        params = _rebuild(abstract_params, data, "params", device)
        opt = (_rebuild(abstract_opt, data, "opt", device)
               if abstract_opt is not None else None)
    return step, params, opt, meta
