"""Main-path model primitives in PyTorch: the twins of the functions of
``repro.models.layers`` that the serving engine runs for the uniform GQA
decoder.

Attention goes through the port's kernels: ``gqa_attention_full`` calls
``flash_prefill`` and ``gqa_attention_decode_paged`` calls
``paged_append`` then ``paged_decode``, each of which takes its plain
PyTorch version on a CPU tensor.  The plain attention (``decode_attention``,
``paged_kv_gather``, ``expand_kv``) lives beside the kernels in
``repro_torch.kernels``.  Projections and the FFN stay ``torch.einsum`` /
``matmul``, as the reference leaves them to XLA.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention.ops import flash_prefill
from repro_torch.kernels.paged_attention.ops import paged_append, paged_decode

F32 = torch.float32


def pin_bf16(x):
    """Identity.  The reference needs ``lax.reduce_precision`` because XLA
    may elide an f32->bf16->f32 round trip inside a fusion; eager PyTorch
    stores every bf16 tensor it produces, so the rounding always happens."""
    return x


def rms_norm(x, scale, eps: float = 1e-5):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return pin_bf16((out * scale.float()).to(x.dtype))


def rope_freqs(head_dim: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=F32,
                                         device=device) / head_dim))


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, D); positions broadcastable to (..., S)."""
    D = x.shape[-1]
    freqs = rope_freqs(D, theta, x.device)             # (D/2,)
    ang = positions.to(F32)[..., None] * freqs          # (..., S, D/2)
    cos = torch.cos(ang)[..., None, :]                  # (..., S, 1, D/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def paged_kv_update(k_pool, v_pool, k_new, v_new, block_ids, offsets):
    """Write one decode step's K/V per batch row into paged pool blocks.

    k_pool/v_pool: (num_blocks, block, K, dh), ONE layer's blocks;
    k_new/v_new: (B, 1, K, dh); block_ids/offsets: (B,) int32 append
    destinations.  Rows whose block id is out of range are dropped (idle
    batch rows pass ``num_blocks`` as a sentinel).  The reference returns
    new arrays; here the pools are updated in place and returned."""
    return paged_append(k_pool, v_pool, k_new[:, 0].contiguous(),
                        v_new[:, 0].contiguous(), block_ids, offsets)


def gqa_qkv(x, p, cfg, positions):
    """Project + rope.  Head-factored weights (d,H,dh)/(d,K,dh).
    Returns q (B,S,H,D), k,v (B,S,K,D), contiguous."""
    q = torch.einsum("bsd,dhx->bshx", x, p["wq"])
    k = torch.einsum("bsd,dkx->bskx", x, p["wk"])
    v = torch.einsum("bsd,dkx->bskx", x, p["wv"])
    if cfg.qk_norm:
        q = rms_norm(q, p["qnorm"], cfg.norm_eps)
        k = rms_norm(k, p["knorm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q.contiguous(), k.contiguous(), v.contiguous()


def gqa_attention_full(x, p, cfg, positions, *, causal: bool = True):
    """Full-sequence attention (prefill) through the flash kernel.
    Returns (y, k, v)."""
    if cfg.attn_logit_softcap:
        raise NotImplementedError("attention logit soft-capping is not "
                                  "ported: the flash kernel has no cap")
    q, k, v = gqa_qkv(x, p, cfg, positions)
    y = flash_prefill(q, k, v, causal=causal, window=cfg.sliding_window)
    return torch.einsum("bshx,hxd->bsd", y, p["wo"]), k, v


def gqa_attention_decode_paged(x, p, cfg, k_pool, v_pool, tables, pos,
                               block_ids, offsets):
    """One-token decode over pool blocks: appends the new token's K/V into
    each row's tail block, then attends through the block tables.
    pos: (B,) int32 position of the new token.  Returns (y, k_pool,
    v_pool), the pools updated in place."""
    q, k, v = gqa_qkv(x, p, cfg, pos[:, None])
    k_pool, v_pool = paged_kv_update(k_pool, v_pool, k, v, block_ids,
                                     offsets)
    y = paged_decode(q[:, 0].contiguous(), k_pool, v_pool, tables, pos + 1,
                     window=cfg.sliding_window)
    return torch.einsum("bhx,hxd->bd", y, p["wo"])[:, None], k_pool, v_pool


def ffn_swiglu(x, p):
    h = F.silu(x @ p["w1"]) * (x @ p["w3"])
    return h @ p["w2"]
