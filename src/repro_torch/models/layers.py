"""Model primitives in PyTorch: the twins of the functions of
``repro.models.layers`` that the port's model paths run (the uniform GQA
decoder, rwkv6's group norm, jamba's attention slot and dense-impl MoE).

Attention goes through the port's kernels: ``gqa_attention_full`` calls
``flash_prefill``; ``gqa_attention_decode_paged`` and
``gqa_attention_decode`` (over a contiguous per-layer cache, read as one
block per row) call ``paged_append`` then ``paged_decode``.  Each kernel
takes its plain PyTorch version on a CPU tensor.  The plain attention (``decode_attention``,
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


def group_norm_heads(x, scale, n_heads: int, eps: float = 1e-5):
    """Per-head group norm over the trailing dim split into n_heads groups
    (RWKV's ln_x), in f32, returned as bf16."""
    orig = x.shape
    x = x.reshape(*orig[:-1], n_heads, orig[-1] // n_heads).float()
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, unbiased=False, keepdim=True)
    x = ((x - mean) * torch.rsqrt(var + eps)).reshape(orig)
    return (x * scale.float()).to(torch.bfloat16)


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


def _contiguous_table(pos):
    """A per-layer contiguous cache (B, max_len, K, dh) read as a pool of B
    blocks of max_len tokens: block table ``arange(B)[:, None]`` and, for a
    new token at ``pos`` (B,) int32, lens ``pos + 1``."""
    B = pos.shape[0]
    tables = torch.arange(B, dtype=torch.int32, device=pos.device)[:, None]
    return tables, pos + 1


def _cache_insert(k_cache, v_cache, k, v, pos):
    """Write row b's (B, 1, K, dh) k/v into the contiguous caches at
    position ``pos[b]``, in place, through ``paged_append`` (block b,
    offset pos).  The reference's dynamic_update_slice returns new caches
    and clamps a position past the end, where the append would drop it:
    ``lm.decode_step`` refuses such a position before it gets here."""
    B = k.shape[0]
    ids = torch.arange(B, dtype=torch.int32, device=k.device)
    return paged_append(k_cache, v_cache, k[:, 0].contiguous(),
                        v[:, 0].contiguous(), ids, pos)


def gqa_attention_decode(x, p, cfg, k_cache, v_cache, pos):
    """One-token decode over contiguous caches (B, max_len, K, dh), updated
    in place.  pos: (B,) int32 position of the new token.  Returns
    (y, k_cache, v_cache)."""
    q, k, v = gqa_qkv(x, p, cfg, pos[:, None])
    k_cache, v_cache = _cache_insert(k_cache, v_cache, k, v, pos)
    y = paged_decode(q[:, 0].contiguous(), k_cache, v_cache,
                     *_contiguous_table(pos), window=cfg.sliding_window)
    return torch.einsum("bhx,hxd->bd", y, p["wo"])[:, None], k_cache, v_cache


def ffn_swiglu(x, p):
    h = F.silu(x @ p["w1"]) * (x @ p["w3"])
    return h @ p["w2"]


# ---------------------------------------------------------------------------
# MoE: the reference's dense impl (every expert computed, then gated)
# ---------------------------------------------------------------------------
def moe_router(x2d, router_w, top_k: int):
    """Top-k experts by probability; equal probabilities (frequent: the
    logits are rounded to bf16) go to the lower expert id first, as
    ``lax.top_k`` orders them (a stable sort; ``torch.topk`` promises no
    order among equals)."""
    logits = (x2d @ router_w).float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :top_k], top_e[:, :top_k]
    top_p = top_p / top_p.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    return top_p, top_e


def moe_dense_ref(x2d, p, cfg):
    """Computes every expert then gates: the reference's oracle, which its
    engine and model paths run under ``moe_impl="dense"``.  The expert
    products are batched over the expert axis of the weights, with no
    copy of them."""
    top_p, top_e = moe_router(x2d, p["router"], cfg.top_k)
    h = F.silu(torch.matmul(x2d, p["w1"])) * torch.matmul(x2d, p["w3"])
    y_e = torch.matmul(h, p["w2"])                        # (E, T, d)
    gate = torch.zeros(x2d.shape[0], cfg.n_experts, dtype=F32,
                       device=x2d.device).scatter_add_(1, top_e, top_p)
    y = torch.einsum("etd,te->td", y_e.float(), gate)
    return y.to(x2d.dtype)


def moe_block(x, p, cfg, impl: str = "dense"):
    """MoE FFN + optional shared experts.  Only the dense impl is ported;
    expert parallelism (``moe_ep``) comes with the sharding slice."""
    if impl != "dense":
        raise NotImplementedError(f"moe_block impl={impl!r}: only the dense "
                                  f"impl is ported; moe_ep comes with the "
                                  f"sharding slice")
    B, S, d = x.shape
    y = moe_dense_ref(x.reshape(-1, d), p, cfg).reshape(B, S, d)
    if cfg.n_shared_experts:
        y = y + ffn_swiglu(x, {"w1": p["ws1"], "w3": p["ws3"],
                               "w2": p["ws2"]})
    return y
