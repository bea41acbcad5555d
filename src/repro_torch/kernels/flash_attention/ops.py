"""Prefill attention: the Hopper kernel's wrapper and its plain version.

``flash_prefill`` is the port of the Pallas kernel
``repro/kernels/flash_attention/kernel.py::flash_attention_bhsd`` and of
its wrapper ``ops.py::flash_attention``.  It takes model-layout tensors,
q (B, Sq, H, D) and k/v (B, Sk, K, D), and returns (B, Sq, H, D).  A CPU
tensor goes to ``flash_prefill_plain``; a CUDA tensor launches
``csrc/flash_attention.cu`` (bf16, head_dim 16, 64 or 128: wgmma on the
tensor cores, K/V streamed by TMA through a two-stage ring), which reads
KV head h // (H/K) in place instead of expanding GQA.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
HEAD_DIMS = (16, 64, 128)

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
             + [ctypes.c_float, ctypes.c_void_p])


def expand_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B,S,K,D) -> (B,S,H,D) by repeating each kv head H/K times."""
    K = k.shape[2]
    return k if K == n_heads else k.repeat_interleave(n_heads // K, dim=2)


def flash_prefill_plain(q, k, v, *, causal: bool = True, window: int = 0):
    """Masked softmax attention with GQA expanded, scores and sums in f32.

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
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_prefill wants q (B,Sq,H,D), k/v (B,Sk,K,D); "
                         f"got {tuple(q.shape)} {tuple(k.shape)} "
                         f"{tuple(v.shape)}")
    B, _, H, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or H % k.shape[2]:
        raise ValueError(f"flash_prefill: incompatible q {tuple(q.shape)} "
                         f"and k/v {tuple(k.shape)}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_prefill: q, k, v on different devices")


def flash_prefill(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B, Sq, H, D); k/v: (B, Sk, K, D).  Returns (B, Sq, H, D)."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_prefill_plain(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_prefill: unsupported device {q.device}")
    B, Sq, H, D = q.shape
    Sk, K = k.shape[1], k.shape[2]
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_prefill kernel takes head_dim {HEAD_DIMS}, "
                         f"not {D}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16 or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError(f"flash_prefill kernel wants contiguous, "
                             f"16-byte aligned bf16 {name}; got {t.dtype}")
    out = torch.empty_like(q)
    fn = build.function("flash_attention", "flash_prefill", _ARGTYPES)
    err = build.launch(q.device, fn, q.data_ptr(), k.data_ptr(),
                       v.data_ptr(), out.data_ptr(), B, Sq, Sk, H, K, D,
                       int(causal), int(window), 1.0 / math.sqrt(D))
    if err < 0:
        raise RuntimeError(f"flash_prefill: the K/V tensor maps could not be "
                           f"made (code {err}: -1 no cuTensorMapEncodeTiled "
                           f"in libcuda, -1000 - n CUresult n)")
    if err:
        raise RuntimeError(f"flash_prefill launch failed: CUDA error {err}")
    flash_prefill.launches += 1
    return out


flash_prefill.launches = 0
