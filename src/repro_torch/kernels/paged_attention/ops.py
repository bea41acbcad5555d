"""Paged decode: the Hopper kernels' wrappers and their plain versions.

``paged_decode`` is the port of the Pallas kernel
``repro/kernels/paged_attention/kernel.py::paged_decode_attention`` (and
its wrapper ``ops.py::paged_attention``), with the model path's sliding
window added.  ``paged_append`` is the port of the ``mode="drop"``
scatter in ``ops.py::paged_decode_step`` / ``layers.paged_kv_update``.
A CPU tensor goes to the plain version; a CUDA tensor launches
``csrc/paged_attention.cu`` (bf16, head_dim 16, 64 or 128, int32
indices).  The decode kernel splits each row's positions across CTAs
(``split_schedule``) and merges the splits in the same launch.  Torch
indexing raises (or device-asserts) on the engine's out-of-range drop
sentinel, which is why the append is a kernel and not ``index_put_``.
Inside ``build.dry_run()`` a meta tensor takes the dry run's route: the
CUDA path's checks, outputs and scratch on meta, the work
(``paged_decode_work``, ``paged_append_work``) tallied, nothing launched.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
HEAD_DIMS = (16, 64, 128)
CHUNK = 32          # tokens per ring chunk of the decode kernel (CH)
MAX_SPLITS = 64     # the decode kernel's bound on splits per row
CTAS_PER_SM = 8     # decode CTAs aimed at per SM when every row is full
H100_SMS = 132      # H100 SXM5's SMs: the dry run's split schedule

_DECODE_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 10
                    + [ctypes.c_float, ctypes.c_void_p])
_APPEND_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 \
    + [ctypes.c_void_p]


# ---------------------------------------------------------------------------
# plain versions: the CPU path and the oracle
# ---------------------------------------------------------------------------
def decode_attention(q, k_cache, v_cache, pos, *, window: int = 0):
    """Twin of ``repro.models.layers.decode_attention``.

    q: (B,1,H,D); k_cache/v_cache: (B,S,K,D); pos: (B,) position of the
    current token (already in the cache).  Masks pos-window < idx <= pos."""
    B, _, H, D = q.shape
    S, K = k_cache.shape[1], k_cache.shape[2]
    qr = q.reshape(B, K, H // K, D)
    s = torch.einsum("bkgd,bskd->bkgs", qr.float(), k_cache.float()) \
        * (1.0 / math.sqrt(D))
    idx = torch.arange(S, device=q.device)[None, :]
    pos_b = torch.as_tensor(pos, device=q.device).broadcast_to((B,))[:, None]
    valid = idx <= pos_b
    if window:
        valid &= idx > pos_b - window
    s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p.to(v_cache.dtype).float(),
                     v_cache.float())
    return o.reshape(B, 1, H, v_cache.shape[-1]).to(q.dtype)


def paged_kv_gather(k_pool, v_pool, tables):
    """Per-row block tables (B, nb) -> contiguous (B, nb*block, K, dh)."""
    B, nb = tables.shape
    _, blk, K, dh = k_pool.shape
    idx = tables.long()
    return (k_pool[idx].reshape(B, nb * blk, K, dh),
            v_pool[idx].reshape(B, nb * blk, K, dh))


def paged_decode_plain(q, k_pool, v_pool, tables, lens, *, window: int = 0):
    """Gather the blocks, then ``decode_attention`` at position lens-1.
    A row with no visible position (len <= 0) gives 0, as the Pallas
    kernel's body does (``decode_attention`` would average every
    position)."""
    k, v = paged_kv_gather(k_pool, v_pool, tables)
    out = decode_attention(q[:, None], k, v, lens.long() - 1,
                           window=window)[:, 0]
    return out.masked_fill((lens <= 0)[:, None, None], 0)


def paged_append_plain(k_pool, v_pool, k_new, v_new, block_ids, offsets):
    """Masked ``index_put_``: rows whose block id or offset is out of
    range are dropped, like JAX's ``mode="drop"``.  In place."""
    nblk, blk = k_pool.shape[0], k_pool.shape[1]
    keep = (block_ids >= 0) & (block_ids < nblk) & (offsets >= 0) \
        & (offsets < blk)
    bids, offs = block_ids[keep].long(), offsets[keep].long()
    k_pool[bids, offs] = k_new[keep].to(k_pool.dtype)
    v_pool[bids, offs] = v_new[keep].to(v_pool.dtype)
    return k_pool, v_pool


def split_schedule(nb: int, block: int, rows: int, n_sm: int):
    """(span, splits) of the decode kernel's grid (splits, K, B).

    Split s of a (batch row, KV head) pair takes positions
    [s * span, (s + 1) * span).  ``rows`` = B * K pairs.  The schedule
    reads only the table's capacity nb * block, never ``lens``, so the
    wrapper needs no host sync: it aims at CTAS_PER_SM CTAs per SM when
    every row is full, with span a multiple of CHUNK and at most
    MAX_SPLITS splits, and span * splits covering the capacity."""
    cap = max(1, nb * block)
    want = max(1, min(MAX_SPLITS, -(-CTAS_PER_SM * n_sm // max(1, rows))))
    span = -(-cap // want)
    span = -(-span // CHUNK) * CHUNK
    return span, -(-cap // span)


_TICKETS = {}
_SCHEDULES = {}


def _schedule(device, nb: int, block: int, rows: int):
    """``split_schedule`` on ``device``'s SM count (a meta device: an
    H100 SXM5's), kept per shape: the decode loop calls it with the same
    shape every step."""
    key = (device, nb, block, rows)
    if key not in _SCHEDULES:
        n_sm = H100_SMS if device.type == "meta" else \
            torch.cuda.get_device_properties(device).multi_processor_count
        _SCHEDULES[key] = split_schedule(nb, block, rows, n_sm)
    return _SCHEDULES[key]


def paged_decode_work(B, H, K, dh, nb, visible, itemsize=2):
    """(operations, bytes) of one decode call over ``visible`` K/V
    positions in all (the rows' visible lengths summed): 4 dh a query head
    and position (q.k and p.v), q read and the output written once, the
    tables and lens, each visible K and V row read once."""
    nbytes = (2 * B * H * dh * itemsize + B * nb * 4 + B * 4
              + visible * K * dh * itemsize * 2)
    return 4 * H * dh * visible, nbytes


def paged_append_work(B, K, dh, rows, itemsize=2):
    """(operations, bytes) of one append of ``rows`` kept rows: each kept
    row's new K and V read and written once, the block ids and offsets
    read."""
    return 0, 2 * 2 * rows * K * dh * itemsize + 2 * B * 4


def _tickets(store, device, n: int) -> torch.Tensor:
    """The decode kernel's per-(row, KV head) tickets on ``device``: int32
    zeros, which every launch leaves at zero.  Made once per device in
    ``store`` (``_TICKETS``; a dry run's own, ``build.dry_kept``), and
    again when a call needs more."""
    t = store.get(device)
    if t is None or t.numel() < n:
        t = store[device] = torch.zeros(max(n, 256), dtype=torch.int32,
                                        device=device)
    return t


def kept_buffers(device) -> tuple:
    """The buffers the decode wrapper keeps on ``device`` between calls
    (its tickets), for a CUDA graph that captured a call to hold: a later
    call that needs more tickets makes a larger buffer and drops this one,
    which the graph's launches still read."""
    t = _TICKETS.get(device)
    return () if t is None else (t,)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------
def _cuda_checks(name, bf16s, ints, head_dim, device="cuda"):
    """The kernel's conditions on its inputs, every one on ``device``
    ("meta" on the dry run's route)."""
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"{name} kernel takes head_dim {HEAD_DIMS}, "
                         f"not {head_dim}")
    for label, t in bf16s:
        if t.device.type != device or t.dtype != torch.bfloat16 \
                or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} kernel wants contiguous, 16-byte "
                             f"aligned bf16 {device} {label}; got {t.dtype} "
                             f"on {t.device}")
    for label, t in ints:
        if t.device.type != device or t.dtype != torch.int32 \
                or not t.is_contiguous():
            raise ValueError(f"{name} kernel wants contiguous int32 {device} "
                             f"{label}; got {t.dtype} on {t.device}")


def paged_decode(q, k_pool, v_pool, tables, lens, *, window: int = 0):
    """q: (B, H, dh); pools: (num_blocks, block, K, dh); tables: (B, nb)
    int32; lens: (B,) int32 token counts including the current token.
    Returns (B, H, dh)."""
    build.refuse_dtensor("paged_decode", q, k_pool, v_pool, tables, lens)
    B, H, dh = q.shape
    num_blocks, block, K, _ = k_pool.shape
    if v_pool.shape != k_pool.shape or k_pool.shape[3] != dh or H % K \
            or tables.shape[0] != B or lens.shape != (B,):
        raise ValueError(f"paged_decode: incompatible q {tuple(q.shape)}, "
                         f"pool {tuple(k_pool.shape)}, tables "
                         f"{tuple(tables.shape)}, lens {tuple(lens.shape)}")
    if q.device.type == "cpu":
        return paged_decode_plain(q, k_pool, v_pool, tables, lens,
                                  window=window)
    dry = build.on_meta("paged_decode", q)
    build.refuse_autograd("paged_decode", q, k_pool, v_pool)
    if H // K > 8:
        raise ValueError(f"paged_decode kernel takes at most 8 query heads "
                         f"per KV head, not {H // K}")
    _cuda_checks("paged_decode",
                 (("q", q), ("k_pool", k_pool), ("v_pool", v_pool)),
                 (("tables", tables), ("lens", lens)), dh,
                 "meta" if dry else "cuda")
    nb = tables.shape[1]
    span, splits = _schedule(q.device, nb, block, B * K)
    out = torch.empty_like(q)
    part = torch.empty(B * K * splits * (H // K) * (dh + 2),
                       dtype=torch.float32, device=q.device)
    store = build.dry_kept() if dry else _TICKETS
    had = store.get(q.device)
    tickets = _tickets(store, q.device, B * K)
    if dry:
        # lens is a meta value: every row counted at the table's capacity
        # (clipped by the window), an upper bound on the kernel's work
        cap = nb * block
        build.tally("paged_decode", paged_decode_work(
            B, H, K, dh, nb, B * (min(cap, window) if window else cap)),
            out, part, *(() if tickets is had else (tickets,)))
        return out
    fn = build.function("paged_attention", "paged_decode", _DECODE_ARGTYPES)
    err = build.launch(q.device, fn, q.data_ptr(), k_pool.data_ptr(),
                       v_pool.data_ptr(), tables.data_ptr(), lens.data_ptr(),
                       out.data_ptr(), part.data_ptr(), tickets.data_ptr(),
                       B, H, K, dh, num_blocks, block, nb, int(window), span,
                       splits, 1.0 / math.sqrt(dh))
    if err:
        raise RuntimeError(f"paged_decode launch failed: CUDA error {err}")
    build.count(paged_decode)
    return out


def paged_append(k_pool, v_pool, k_new, v_new, block_ids, offsets):
    """Write row b's k_new/v_new (B, K, dh) into the pools
    (num_blocks, block, K, dh) at (block_ids[b], offsets[b]), in place;
    out-of-range rows are dropped.  Returns (k_pool, v_pool)."""
    build.refuse_dtensor("paged_append", k_pool, v_pool, k_new, v_new,
                         block_ids, offsets)
    num_blocks, block, K, dh = k_pool.shape
    B = k_new.shape[0]
    if v_pool.shape != k_pool.shape or k_new.shape != (B, K, dh) \
            or v_new.shape != k_new.shape or block_ids.shape != (B,) \
            or offsets.shape != (B,):
        raise ValueError(f"paged_append: incompatible pool "
                         f"{tuple(k_pool.shape)}, new {tuple(k_new.shape)}, "
                         f"ids {tuple(block_ids.shape)}")
    if k_pool.device.type == "cpu":
        return paged_append_plain(k_pool, v_pool, k_new, v_new, block_ids,
                                  offsets)
    dry = build.on_meta("paged_append", k_pool)
    build.refuse_autograd("paged_append", k_pool, v_pool, k_new, v_new)
    _cuda_checks("paged_append",
                 (("k_pool", k_pool), ("v_pool", v_pool), ("k_new", k_new),
                  ("v_new", v_new)),
                 (("block_ids", block_ids), ("offsets", offsets)), dh,
                 "meta" if dry else "cuda")
    if dry:
        # the ids are meta values: every row counted as kept, the bound
        build.tally("paged_append", paged_append_work(B, K, dh, B))
        return k_pool, v_pool
    fn = build.function("paged_attention", "paged_append", _APPEND_ARGTYPES)
    err = build.launch(k_pool.device, fn, k_new.data_ptr(), v_new.data_ptr(),
                       k_pool.data_ptr(), v_pool.data_ptr(),
                       block_ids.data_ptr(), offsets.data_ptr(), B, K, dh,
                       num_blocks, block)
    if err:
        raise RuntimeError(f"paged_append launch failed: CUDA error {err}")
    build.count(paged_append)
    return k_pool, v_pool


paged_decode.launches = 0
paged_append.launches = 0
