"""Prefill attention: the Hopper kernel's wrapper and its plain version.

``flash_prefill`` is the port of the Pallas kernel
``repro/kernels/flash_attention/kernel.py::flash_attention_bhsd`` and of
its wrapper ``ops.py::flash_attention``.  It takes model-layout tensors,
q (B, Sq, H, D), k (B, Sk, K, D) and v (B, Sk, K, Dv), and returns
(B, Sq, H, Dv) with the scale 1/sqrt(D), as the reference's
``layers.chunked_attention`` takes a value width apart from the query-key
width (deepseek-v2's MLA prefill: D 192, Dv 128).  A CPU tensor goes to
``flash_prefill_plain``, at any widths; a CUDA tensor launches
``csrc/flash_attention.cu`` (bf16, (D, Dv) one of ``WIDTHS``: wgmma on the
tensor cores, K/V streamed by TMA through a two-stage ring), which reads
KV head h // (H/K) in place instead of expanding GQA.  Inside
``build.dry_run()`` a meta tensor takes the dry run's route: the CUDA
path's checks and output on meta, its work (``flash_prefill_work``)
tallied, nothing launched.

A nonzero ``cap`` soft-caps the scaled scores, ``cap * tanh(s / cap)`` before
the mask, as the reference's ``attention_dense`` / ``chunked_attention``
apply ``logit_cap`` (``cfg.attn_logit_softcap``); 0 leaves them as they
are.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
WIDTHS = ((16, 16), (64, 64), (128, 128), (192, 128))   # (D, Dv) built

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
             + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])


def expand_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B,S,K,D) -> (B,S,H,D) by repeating each kv head H/K times."""
    K = k.shape[2]
    return k if K == n_heads else k.repeat_interleave(n_heads // K, dim=2)


def flash_prefill_plain(q, k, v, *, causal: bool = True, window: int = 0,
                        cap: float = 0.0):
    """Masked softmax attention with GQA expanded, scores and sums in f32;
    v may be narrower or wider than q and k (the output takes v's width);
    the scaled scores soft-capped where ``cap`` is set.

    The arithmetic of ``_flash_kernel`` (and of the reference's
    ``layers.chunked_attention`` when the sequence fits one tile): the
    unnormalised probabilities are rounded to v's dtype before the P.V
    product and the f32 sum divides at the end."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    kx = expand_kv(k, H)
    vx = expand_kv(v, H)
    s = torch.einsum("bqhd,bshd->bhqs", q.float(), kx.float()) \
        * (1.0 / math.sqrt(D))
    if cap:
        s = cap * torch.tanh(s / cap)
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones(Sq, Sk, dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= qpos - kpos < window
    s = s.masked_fill(~mask, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m).masked_fill(~mask, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqs,bshd->bhqd", p.to(v.dtype).float(), vx.float())
    o = o / l.clamp_min(1e-30)
    return o.transpose(1, 2).to(q.dtype)


def _check(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 \
            or k.shape[:3] != v.shape[:3]:
        raise ValueError(f"flash_prefill wants q (B,Sq,H,D), k (B,Sk,K,D), "
                         f"v (B,Sk,K,Dv); got {tuple(q.shape)} "
                         f"{tuple(k.shape)} {tuple(v.shape)}")
    B, _, H, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or H % k.shape[2]:
        raise ValueError(f"flash_prefill: incompatible q {tuple(q.shape)} "
                         f"and k/v {tuple(k.shape)}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_prefill: q, k, v on different devices")


@functools.lru_cache(maxsize=None)
def visible_pairs(Sq: int, Sk: int, causal: bool, window: int) -> int:
    """The (query, key) pairs one head scores: key j visible to query t
    where j <= t (causal) and t - j < window (window > 0), as the kernel
    and ``flash_prefill_plain`` mask them."""
    n = 0
    for t in range(Sq):
        hi = min(t, Sk - 1) if causal else Sk - 1
        lo = max(0, t - window + 1) if window else 0
        n += max(0, hi - lo + 1)
    return n


def flash_prefill_work(B, Sq, Sk, H, K, D, Dv, *, causal=True, window=0,
                       cap=0.0, itemsize=2):
    """(operations, bytes) of one call: 2 (D + Dv) a visible pair (the
    q.k and p.v products), and with a cap 3 more (the divide, the tanh and
    the multiply); q, k, v read once and the output written once."""
    pairs = B * H * visible_pairs(Sq, Sk, causal, window)
    flops = (2 * (D + Dv) + (3 if cap else 0)) * pairs
    nbytes = itemsize * (B * Sq * H * (D + Dv) + B * Sk * K * (D + Dv))
    return flops, nbytes


def flash_prefill(q, k, v, *, causal: bool = True, window: int = 0,
                  cap: float = 0.0):
    """q: (B, Sq, H, D); k: (B, Sk, K, D); v: (B, Sk, K, Dv).  Returns
    (B, Sq, H, Dv); a nonzero ``cap`` soft-caps the scores."""
    build.refuse_dtensor("flash_prefill", q, k, v)
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_prefill_plain(q, k, v, causal=causal, window=window,
                                   cap=cap)
    dry = build.on_meta("flash_prefill", q)
    if not dry and q.device.type != "cuda":
        raise ValueError(f"flash_prefill: unsupported device {q.device}")
    build.refuse_autograd("flash_prefill", q, k, v)
    B, Sq, H, D = q.shape
    Sk, K, Dv = k.shape[1], k.shape[2], v.shape[3]
    if (D, Dv) not in WIDTHS:
        raise ValueError(f"flash_prefill kernel takes head_dim (D, Dv) in "
                         f"{WIDTHS}, not {(D, Dv)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16 or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError(f"flash_prefill kernel wants contiguous, "
                             f"16-byte aligned bf16 {name}; got {t.dtype}")
    out = q.new_empty(B, Sq, H, Dv)
    if dry:
        build.tally("flash_prefill", flash_prefill_work(
            B, Sq, Sk, H, K, D, Dv, causal=causal, window=window, cap=cap),
            out)
        return out
    fn = build.function("flash_attention", "flash_prefill", _ARGTYPES)
    err = build.launch(q.device, fn, q.data_ptr(), k.data_ptr(),
                       v.data_ptr(), out.data_ptr(), B, Sq, Sk, H, K, D,
                       Dv, int(causal), int(window), 1.0 / math.sqrt(D),
                       float(cap))
    if err < 0:
        raise RuntimeError(f"flash_prefill: the K/V tensor maps could not be "
                           f"made (code {err}: -1 no cuTensorMapEncodeTiled "
                           f"in libcuda, -1000 - n CUresult n)")
    if err:
        raise RuntimeError(f"flash_prefill launch failed: CUDA error {err}")
    build.count(flash_prefill)
    return out


flash_prefill.launches = 0
