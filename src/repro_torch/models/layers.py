"""Model primitives in PyTorch: the twins of the functions of
``repro.models.layers`` that the port's model paths run (the uniform GQA
decoder, deepseek-v2's MLA, seamless's cross-attention, the dense-impl
MoE of mixtral's and deepseek's layers and jamba's slots, rwkv6's group
norm).

Attention goes through the port's kernels: ``gqa_attention_full`` and
``mla_attention_full`` call ``flash_prefill`` (with ``train=True`` they
call ``chunked_attention_train`` instead, the plain blocked attention
that the reference trains through: no kernel has a backward);
``gqa_attention_decode_paged`` and ``gqa_attention_decode`` (over a
contiguous per-layer cache, read as one block per row) call
``paged_append`` then ``paged_decode``;
``cross_attention_decode`` calls ``paged_decode`` over the frozen cross
cache.  MLA's decode is absorbed-matrix products over the latent cache, as
the reference computes it outside any kernel.  Each kernel takes its
plain PyTorch version on a CPU tensor.  The plain attention
(``decode_attention``, ``paged_kv_gather``, ``expand_kv``) lives beside
the kernels in ``repro_torch.kernels``.  Projections and the FFN stay
``torch.einsum`` / ``matmul``, as the reference leaves them to XLA.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.flash_attention.ops import expand_kv, flash_prefill
from repro_torch.kernels.paged_attention.ops import paged_append, paged_decode

F32 = torch.float32
NEG_INF = -1e30


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


# ---------------------------------------------------------------------------
# training: blocked attention and the chunked scan, under autograd
# ---------------------------------------------------------------------------
def _pick_block(S: int, target: int) -> int:
    if S <= target:
        return S
    b = target
    while S % b:
        b -= 1
    return b


def _attn_q_block(q, k, v, i, qb, kb, causal, window):
    """Query block i over every key block (mode="full": each pair, masked):
    the online softmax of the reference's ``_chunked_attention_bwd_safe``.
    Scores are bf16 products summed in f32; m, l and acc are f32; p is
    rounded to v's type before P.V; ``torch.minimum`` / ``maximum`` split
    the gradient at a tie as ``jnp.minimum`` / ``maximum`` do.  Returns
    (B, H, qb, Dv) f32."""
    B, _, H, D = q.shape
    Sk, Dv = k.shape[1], v.shape[-1]
    dev = q.device
    qi = q[:, i * qb:(i + 1) * qb].float()
    qpos = i * qb + torch.arange(qb, device=dev)
    m = torch.full((B, H, qb), NEG_INF, dtype=F32, device=dev)
    l = torch.zeros(B, H, qb, dtype=F32, device=dev)
    acc = torch.zeros(B, H, qb, Dv, dtype=F32, device=dev)
    zero = torch.zeros((), dtype=F32, device=dev)
    for j in range(Sk // kb):
        kj = k[:, j * kb:(j + 1) * kb].float()
        vj = v[:, j * kb:(j + 1) * kb]
        s = torch.einsum("bqhd,bshd->bhqs", qi, kj) * (1.0 / math.sqrt(D))
        kpos = j * kb + torch.arange(kb, device=dev)
        msk = torch.ones(qb, kb, dtype=torch.bool, device=dev)
        if causal:
            msk &= kpos[None, :] <= qpos[:, None]
        if window:
            msk &= qpos[:, None] - kpos[None, :] < window
        s = torch.where(msk, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        # guard all-masked rows (m_new == NEG_INF) against inf - inf
        alpha = torch.exp(torch.minimum(m - m_new, zero))
        p = torch.where(msk, torch.exp(s - m_new[..., None]), 0.0)
        l = l * alpha + p.sum(-1)
        pv = torch.einsum("bhqs,bshd->bhqd", p.to(v.dtype).float(),
                          vj.float())
        acc = acc * alpha[..., None] + pv
        m = m_new
    return acc / torch.clamp(l, min=1e-30)[..., None]


def chunked_attention_train(q, k, v, *, causal: bool = True,
                            window: int = 0, q_block: int = 512,
                            kv_block: int = 512):
    """The training attention, twin of the reference's
    ``_chunked_attention_bwd_safe`` (``repro/models/layers.py:244``): a
    Python loop over query blocks, each under ``torch.utils.checkpoint`` so
    the backward recomputes its scores instead of keeping (Sq, Sk) of
    them.  q (B, Sq, H, D); k, v (B, Sk, H, D|Dv), already expanded to H
    heads.  Returns (B, Sq, H, Dv) in q's type."""
    B, Sq, H, D = q.shape
    if k.shape[2] != H:
        raise ValueError("expand_kv before chunked_attention_train")
    qb = _pick_block(Sq, q_block)
    kb = _pick_block(k.shape[1], kv_block)
    outs = [checkpoint(_attn_q_block, q, k, v, i, qb, kb, causal, window,
                       use_reentrant=False) for i in range(Sq // qb)]
    return torch.cat(outs, dim=2).transpose(1, 2).to(q.dtype)


def seq_scan(step, carry0, xs, *, chunk: int = 64):
    """Twin of the reference's ``seq_scan`` (``repro/models/layers.py:395``):
    ``carry, y = step(carry, x_t)`` over the leading axis of the tuple
    ``xs``, ys stacked.  Where T is a multiple of ``chunk`` above it, each
    chunk of steps runs under ``torch.utils.checkpoint``, so the backward
    keeps the carry at chunk edges only; otherwise a plain loop."""
    T = xs[0].shape[0]

    def run(c, part):
        ys = []
        for t in range(part[0].shape[0]):
            c, y = step(c, tuple(a[t] for a in part))
            ys.append(y)
        return c, torch.stack(ys)

    if T <= chunk or T % chunk:
        return run(carry0, xs)
    c, ys = carry0, []
    for s in range(0, T, chunk):
        c, y = checkpoint(run, c, tuple(a[s:s + chunk] for a in xs),
                          use_reentrant=False)
        ys.append(y)
    return c, torch.cat(ys)


def gqa_q(x, p, cfg, positions, *, qk_norm: bool = True):
    """The query half of ``gqa_qkv``: q (B,S,H,D) projected, normed where
    ``cfg.qk_norm`` (and ``qk_norm``), roped at ``positions``; contiguous."""
    q = torch.einsum("bsd,dhx->bshx", x, p["wq"])
    if cfg.qk_norm and qk_norm:
        q = rms_norm(q, p["qnorm"], cfg.norm_eps)
    return apply_rope(q, positions, cfg.rope_theta).contiguous()


def gqa_qkv(x, p, cfg, positions):
    """Project + rope.  Head-factored weights (d,H,dh)/(d,K,dh).
    Returns q (B,S,H,D), k,v (B,S,K,D), contiguous."""
    k = torch.einsum("bsd,dkx->bskx", x, p["wk"])
    v = torch.einsum("bsd,dkx->bskx", x, p["wv"])
    if cfg.qk_norm:
        k = rms_norm(k, p["knorm"], cfg.norm_eps)
    k = apply_rope(k, positions, cfg.rope_theta)
    return gqa_q(x, p, cfg, positions), k.contiguous(), v.contiguous()


def _attend(q, k, v, *, causal, train, attn_block, window=0):
    """Prefill through ``flash_prefill``, or with ``train`` the blocked
    training attention over ``expand_kv``'d K/V, as the reference's
    ``bwd_safe`` route expands them."""
    if not train:
        return flash_prefill(q, k, v, causal=causal, window=window)
    H = q.shape[2]
    return chunked_attention_train(q, expand_kv(k, H), expand_kv(v, H),
                                   causal=causal, window=window,
                                   q_block=attn_block, kv_block=attn_block)


def gqa_attention_full(x, p, cfg, positions, *, causal: bool = True,
                       kv_override=None, train: bool = False,
                       attn_block: int = 512):
    """Full-sequence attention: prefill through the flash kernel, or with
    ``train`` through ``chunked_attention_train`` (blocks of
    ``attn_block``).  ``kv_override`` (k, v), each (B, Sk, K, dh): a
    cross-attention's keys and values, taken as they are (no rope), while
    q is roped at ``positions``, as the reference does; the projections it
    replaces are not computed.  Returns (y, k, v)."""
    if cfg.attn_logit_softcap:
        raise NotImplementedError("attention logit soft-capping is not "
                                  "ported: the flash kernel has no cap")
    if kv_override is None:
        q, k, v = gqa_qkv(x, p, cfg, positions)
    else:
        q, (k, v) = gqa_q(x, p, cfg, positions), kv_override
    y = _attend(q, k, v, causal=causal, train=train,
                attn_block=attn_block, window=cfg.sliding_window)
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


def cross_attention_decode(x, p, cfg, k_cross, v_cross, pos):
    """One-token cross-attention over a frozen cross cache (B, Ss, K, dh):
    q projected and roped at ``pos`` (B,) int32, the cross K/V unroped, as
    the reference's ``encdec.decode_step`` does; every one of the Ss
    positions visible (its ``decode_attention`` at position Ss - 1).  Read
    through ``paged_decode`` as one block of Ss a row.  The reference's
    decode applies no qk_norm to this q (its prefill does)."""
    B, Ss = k_cross.shape[0], k_cross.shape[1]
    q = gqa_q(x, p, cfg, pos[:, None], qk_norm=False)
    tables = torch.arange(B, dtype=torch.int32, device=x.device)[:, None]
    lens = torch.full((B,), Ss, dtype=torch.int32, device=x.device)
    y = paged_decode(q[:, 0], k_cross, v_cross, tables, lens)
    return torch.einsum("bhx,hxd->bd", y, p["wo"])[:, None]


# ---------------------------------------------------------------------------
# MLA (deepseek-v2)
# ---------------------------------------------------------------------------
def _mla_q(x, p, cfg, positions):
    """q (B, S, H, nope + rope), its rope part roped at ``positions``."""
    nope = cfg.qk_nope_head_dim
    cq = rms_norm(x @ p["wdq"], p["q_ln"], cfg.norm_eps)
    q = torch.einsum("bsr,rhx->bshx", cq, p["wuq"])
    q_rope = apply_rope(q[..., nope:], positions, cfg.rope_theta)
    return q[..., :nope], q_rope


def _mla_latent(x, p, cfg, positions):
    """The compressed cache entries of x: the normed latent (B, S, r) and
    the rope key (B, S, rope), roped at ``positions``."""
    r = cfg.kv_lora_rank
    ckv_full = x @ p["wdkv"]
    ckv = rms_norm(ckv_full[..., :r], p["kv_ln"], cfg.norm_eps)
    k_rope = apply_rope(ckv_full[:, :, None, r:], positions,
                        cfg.rope_theta)[:, :, 0, :]
    return ckv, k_rope


def mla_attention_full(x, p, cfg, positions, *, train: bool = False,
                       attn_block: int = 512):
    """Prefill MLA: the latent expanded to per-head keys and values, k's
    rope part shared by the H heads, causal attention through
    ``flash_prefill`` (with ``train``, ``chunked_attention_train``) at
    query-key width nope + rope and value width v_head_dim.  Returns (y,
    ckv (B, S, r), k_rope (B, S, rope))."""
    B, S, _ = x.shape
    H, nope = cfg.n_heads, cfg.qk_nope_head_dim
    q_nope, q_rope = _mla_q(x, p, cfg, positions)
    ckv, k_rope = _mla_latent(x, p, cfg, positions)
    kv = torch.einsum("bsr,rhx->bshx", ckv, p["wukv"])
    k = torch.cat([kv[..., :nope], k_rope[:, :, None, :].expand(
        B, S, H, cfg.qk_rope_head_dim)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    v = kv[..., nope:].contiguous()
    y = _attend(q, k, v, causal=True, train=train, attn_block=attn_block)
    return torch.einsum("bshv,hvd->bsd", y, p["wo"]), ckv, k_rope


def mla_attention_decode(x, p, cfg, ckv_cache, krope_cache, pos):
    """Absorbed-matrix MLA decode over the compressed latent cache
    (B, max_len, r) and rope keys (B, max_len, rope), updated in place:
    the new entries are written at ``pos`` (B,) int32, then every slot at
    or before it is attended, in f32 over the upcast cache as the
    reference computes it.  Returns (y, ckv_cache, krope_cache)."""
    B, nope = x.shape[0], cfg.qk_nope_head_dim
    q_nope, q_rope = _mla_q(x, p, cfg, pos[:, None])
    ckv_new, krope_new = _mla_latent(x, p, cfg, pos[:, None])
    rows = torch.arange(B, device=x.device)
    ckv_cache[rows, pos.long()] = ckv_new[:, 0]
    krope_cache[rows, pos.long()] = krope_new[:, 0]
    wk_b, wv_b = p["wukv"][..., :nope], p["wukv"][..., nope:]
    q_lat = torch.einsum("bxhn,rhn->bhr", q_nope.float(), wk_b.float())
    ckv = ckv_cache.float()
    s = (torch.einsum("bhr,bsr->bhs", q_lat, ckv)
         + torch.einsum("bxhp,bsp->bhs", q_rope.float(),
                        krope_cache.float())) \
        * (1.0 / math.sqrt(nope + cfg.qk_rope_head_dim))
    S = ckv_cache.shape[1]
    valid = torch.arange(S, device=x.device)[None, :] <= pos[:, None]
    s = s.masked_fill(~valid[:, None, :], NEG_INF)
    o_lat = torch.einsum("bhs,bsr->bhr", torch.softmax(s, dim=-1), ckv)
    o = torch.einsum("bhr,rhv->bhv", o_lat, wv_b.float())
    y = o[:, None].to(x.dtype)                          # (B, 1, H, vd)
    return torch.einsum("bshv,hvd->bsd", y, p["wo"]), ckv_cache, krope_cache


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
    expert parallelism (``moe_ep``) comes with Sharding II (ROADMAP Queue
    1 item 3)."""
    if impl != "dense":
        raise NotImplementedError(f"moe_block impl={impl!r}: only the dense "
                                  f"impl is ported; moe_ep comes with "
                                  f"Sharding II (ROADMAP Queue 1 item 3)")
    B, S, d = x.shape
    y = moe_dense_ref(x.reshape(-1, d), p, cfg).reshape(B, S, d)
    if cfg.n_shared_experts:
        y = y + ffn_swiglu(x, {"w1": p["ws1"], "w3": p["ws3"],
                               "w2": p["ws2"]})
    return y
