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

On a mesh (an ``env`` whose ``ShardingEnv`` carries one) the attention
(seamless's cross-attention and the paged decode included), FFN and MoE
functions take and return DTensors, in serving and (``train=True``) in
training.  At each of the reference's ``env.cs`` points the tensor is
laid out as the reference's spec, and each function body is the
reference's ``shard_map`` body (or what GSPMD makes of its einsums)
written out on each rank's local shards: the kernels are called on local
tensors only (a wrapper refuses a DTensor), and the collectives are the
reference's ``psum`` / ``all_gather`` / ``psum_scatter`` on the mesh axes'
groups (``models.sharding``, whose autograd functions carry their
transposes, so the backward runs through the same bodies).  With ``env``
None or ``ShardingEnv(None)`` every function runs the one-device path
unchanged.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.flash_attention.ops import expand_kv, flash_prefill
from repro_torch.kernels.paged_attention.ops import (paged_append,
                                                     paged_decode,
                                                     paged_kv_gather)
from repro_torch.models.sharding import (all_gather, axis_index,
                                         contiguous_strides, gathered_bmm,
                                         psum, spec_of, whole)

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
# the training attention's modes, the reference's ``attn_mode``
ATTN_MODES = ("full", "tri")


def _pick_block(S: int, target: int) -> int:
    if S <= target:
        return S
    b = target
    while S % b:
        b -= 1
    return b


def _visible(i, j, qb, kb, causal, window) -> bool:
    """Whether query block i sees any key of key block j (the reference's
    ``_visible`` at q_offset 0)."""
    if causal and j * kb > i * qb + qb - 1:
        return False
    return not (window and i * qb - (j * kb + kb - 1) >= window)


def _attn_q_block(q, k, v, i, qb, kb, causal, window, mode="full",
                  cap=0.0):
    """Query block i over every key block (mode="full": each pair, masked)
    or over the blocks it sees (mode="tri": the causal triangle or the
    window's band, ``_visible``): the online softmax of the reference's
    ``_chunked_attention_bwd_safe``, the scaled scores soft-capped
    (``cap * tanh(s / cap)``, before the mask) where ``cap`` is set.
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
        if mode == "tri" and not _visible(i, j, qb, kb, causal, window):
            continue
        kj = k[:, j * kb:(j + 1) * kb].float()
        vj = v[:, j * kb:(j + 1) * kb]
        s = torch.einsum("bqhd,bshd->bhqs", qi, kj) * (1.0 / math.sqrt(D))
        if cap:
            s = cap * torch.tanh(s / cap)
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
                            kv_block: int = 512, mode: str = "full",
                            cap: float = 0.0):
    """The training attention, twin of the reference's
    ``_chunked_attention_bwd_safe`` (``repro/models/layers.py:244``): a
    Python loop over query blocks, each under ``torch.utils.checkpoint`` so
    the backward recomputes its scores instead of keeping (Sq, Sk) of
    them.  q (B, Sq, H, D); k, v (B, Sk, H, D|Dv), already expanded to H
    heads; ``mode`` "full" (every block pair, masked) or "tri" (the
    visible pairs only: the same result, fewer FLOPs); ``cap`` soft-caps
    the scores inside the checkpointed block, so the backward goes through
    the tanh.  Returns (B, Sq, H, Dv) in q's type."""
    B, Sq, H, D = q.shape
    if k.shape[2] != H:
        raise ValueError("expand_kv before chunked_attention_train")
    if mode not in ATTN_MODES:
        raise ValueError(f"attention mode {mode!r}: takes {ATTN_MODES}")
    qb = _pick_block(Sq, q_block)
    kb = _pick_block(k.shape[1], kv_block)
    outs = [checkpoint(_attn_q_block, q, k, v, i, qb, kb, causal, window,
                       mode, cap, use_reentrant=False)
            for i in range(Sq // qb)]
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


# ---------------------------------------------------------------------------
# on a mesh: DTensor layouts at the reference's constraint points, and the
# rank-local bodies between them
# ---------------------------------------------------------------------------
def on_mesh(env) -> bool:
    """True where ``env`` carries a mesh: the model functions then take
    and return DTensors."""
    return env is not None and env.mesh is not None


def _local(x, env, *wants):
    """``env.cs(x, *wants)``: the DTensor x laid out as the reference's
    constraint puts it; returns this rank's shard."""
    return env.cs(x, *wants).to_local()


def shard_of(t, env, wants):
    """This rank's block of a plain tensor every rank holds whole (token
    ids, positions, patch embeddings), laid out as spec(``wants``)."""
    for d, entry in enumerate(env.spec(t.shape, list(wants))):
        if entry is not None:
            n = t.shape[d] // env.axis_size(entry)
            t = t.narrow(d, axis_index(env, entry) * n, n)
    return t.contiguous()


def dt_add(x, y):
    """x + y of two DTensors laid out alike, shard by shard."""
    from torch.distributed.tensor import DTensor
    if tuple(x.placements) != tuple(y.placements):
        raise ValueError(f"dt_add: {x.placements} and {y.placements}")
    return DTensor.from_local(x.to_local() + y.to_local(), x.device_mesh,
                              x.placements, run_check=False, shape=x.shape,
                              stride=x.stride())


def _global(t, env, shape, wants, partial=None):
    """This rank's ``t`` as its shard of the DTensor of global ``shape``
    laid out as ``env.spec(shape, wants)``; where ``partial`` names a mesh
    axis, the ranks along it hold addends (a ``psum`` still to come)."""
    from torch.distributed.tensor import DTensor, Partial
    pls = list(env.named(shape, wants).placements)
    if partial is not None and env.axis_sizes.get(partial, 1) > 1:
        pls[env.mesh.mesh_dim_names.index(partial)] = Partial()
    return DTensor.from_local(t, env.mesh, pls, run_check=False,
                              shape=torch.Size(shape),
                              stride=contiguous_strides(shape))


def rowwise(fn, x, *args):
    """``fn(x, *args)`` for a function that reads each row's last dim
    whole (a norm).  On a DTensor x: ``fn`` of x's shard and of each
    DTensor argument whole (a replicated weight), laid out as x."""
    from torch.distributed.tensor import DTensor, Shard
    if not isinstance(x, DTensor):
        return fn(x, *args)
    if any(pl.is_partial() or (isinstance(pl, Shard)
                               and pl.dim == x.dim() - 1)
           for pl in x.placements):
        raise ValueError(f"rowwise: x is laid out as {x.placements}; its "
                         f"rows must be whole and summed")
    out = fn(x.to_local(), *(_whole_tensor(a) if isinstance(a, DTensor)
                             else a for a in args))
    return DTensor.from_local(out, x.device_mesh, x.placements,
                              run_check=False, shape=x.shape,
                              stride=x.stride())


def _attn_q_spec(cfg, env):
    """Shard q heads over 'model' if divisible; otherwise run attention
    pure-DP with batch over (data x model), as the reference does."""
    if env.heads_shardable(cfg.n_heads):
        return (env.batch_axes, None, "model", None)
    combined = tuple(env.batch_axes) + ("model",)
    return (combined, None, None, None)


def _heads(env, entry, H):
    """(first, count) of the q heads this rank holds under a heads entry
    of a spec."""
    n = env.axis_size(entry)
    return axis_index(env, entry) * (H // n), H // n


def _kv_for_heads(k, v, h0, Hl, H):
    """The K/V heads (B, S, K, dh) that q heads [h0, h0 + Hl) of H read,
    so that local q head i reads local kv head i // (Hl / K'), the map the
    kernels apply: a contiguous run of kv heads where the rank's q heads
    are whole groups; the one kv head where they sit inside a group;
    otherwise K/V expanded to H heads and sliced like q (G = 1), as the
    reference expands them."""
    K = k.shape[2]
    G = H // K
    if Hl == H:
        return k, v
    if Hl % G == 0:
        sl = slice(h0 // G, (h0 + Hl) // G)
    elif G % Hl == 0:
        sl = slice(h0 // G, h0 // G + 1)
    else:
        return (expand_kv(k, H)[:, :, h0:h0 + Hl].contiguous(),
                expand_kv(v, H)[:, :, h0:h0 + Hl].contiguous())
    return k[:, :, sl].contiguous(), v[:, :, sl].contiguous()


def _q_params(p, env, heads, keys=("wq", "qnorm")):
    """The local params of the q projection: its weight's heads as the q
    spec's ``heads`` entry splits them, gathered over FSDP's axis."""
    out = {}
    for key in keys:
        if key in p:
            w = p[key]
            out[key] = (_local(w, env, None, heads, None) if w.dim() == 3
                        else _whole_tensor(w))
    return out


def _whole_tensor(t):
    """A DTensor whole on this rank (a gather where it is sharded)."""
    return whole(t)


def _whole(p, env, keys):
    """The named params whole on every rank."""
    return {k: _local(p[k], env, *[None] * p[k].dim())
            for k in keys if k in p}


def _out_proj(y, w, env, wants, eq="bshx,hxd->bsd"):
    """The out-projection of y (laid out as spec(``wants``)): each rank's
    heads times its heads' rows of w (gathered over FSDP's axis), a sum
    pending over 'model' where the heads are split there.  In f32: the
    bf16 products are exact there, so the ranks' sum rounds once, where
    the caller rounds it to the stream's type, as one device rounds the
    whole contraction once."""
    heads = env.spec(y.shape, wants)[2]
    out = torch.einsum(eq, _local(y, env, *wants).float(),
                       _local(w, env, wants[2], None, None).float())
    return _global(out, env, (y.shape[0], y.shape[1], w.shape[-1]),
                   [wants[0], wants[1], None], partial=heads)


def gqa_q(x, p, cfg, positions, *, qk_norm: bool = True):
    """The query half of ``gqa_qkv``: q (B,S,H,D) projected, normed where
    ``cfg.qk_norm`` (and ``qk_norm``), roped at ``positions``; contiguous."""
    q = torch.einsum("bsd,dhx->bshx", x, p["wq"])
    if cfg.qk_norm and qk_norm:
        q = rms_norm(q, p["qnorm"], cfg.norm_eps)
    return apply_rope(q, positions, cfg.rope_theta).contiguous()


def _gqa_kv(x, p, cfg, positions):
    k = torch.einsum("bsd,dkx->bskx", x, p["wk"])
    v = torch.einsum("bsd,dkx->bskx", x, p["wv"])
    if cfg.qk_norm:
        k = rms_norm(k, p["knorm"], cfg.norm_eps)
    k = apply_rope(k, positions, cfg.rope_theta)
    return k.contiguous(), v.contiguous()


def gqa_qkv(x, p, cfg, positions, env=None):
    """Project + rope.  Head-factored weights (d,H,dh)/(d,K,dh).
    Returns q (B,S,H,D), k,v (B,S,K,D), contiguous.  On a mesh: DTensors,
    q laid out as ``_attn_q_spec``, k and v with their batch over the
    batch axes and every head on every rank (the reference's ``cs``)."""
    if on_mesh(env):
        qw = _attn_q_spec(cfg, env)
        q, k, v = _gqa_qkv_local(x, p, cfg, positions, env)
        B, S, _ = x.shape
        return (_global(q, env, (B, S, cfg.n_heads, cfg.head_dim), qw),
                k, v)
    k, v = _gqa_kv(x, p, cfg, positions)
    return gqa_q(x, p, cfg, positions), k, v


def _gqa_qkv_local(x, p, cfg, positions, env):
    """The rank's q (its rows and heads of ``_attn_q_spec``) and the k, v
    DTensors, for positions (1, S) shared by every row."""
    B, S, _ = x.shape
    bt, qw = env.batch_axes, _attn_q_spec(cfg, env)
    q = gqa_q(_local(x, env, qw[0], None, None),
              _q_params(p, env, qw[2]), cfg, positions)
    k, v = _gqa_kv(_local(x, env, bt, None, None),
                   _whole(p, env, ("wk", "wv", "knorm")), cfg, positions)
    shape = (B, S, cfg.n_kv_heads, cfg.head_dim)
    return (q, _global(k, env, shape, [bt, None, None, None]),
            _global(v, env, shape, [bt, None, None, None]))


def _attend(q, k, v, *, causal, train, attn_block, window=0,
            attn_mode="full", cap=0.0):
    """Prefill through ``flash_prefill``, or with ``train`` the blocked
    training attention over ``expand_kv``'d K/V (in ``attn_mode``), as the
    reference's ``bwd_safe`` route expands them; either soft-capped by
    ``cap``.

    Only the full-sequence GQA attention takes a cap
    (``cfg.attn_logit_softcap``): the reference's ``decode_attention``
    has no cap argument and its ``mla_attention_full`` passes none
    (``repro/models/layers.py:310,540``), so every decode path here (the
    contiguous, paged and cross-attention ones) and MLA stay uncapped,
    and a capped model's decode parts from its own forward, as the
    reference's does."""
    if not train:
        return flash_prefill(q, k, v, causal=causal, window=window, cap=cap)
    H = q.shape[2]
    return chunked_attention_train(q, expand_kv(k, H), expand_kv(v, H),
                                   causal=causal, window=window,
                                   q_block=attn_block, kv_block=attn_block,
                                   mode=attn_mode, cap=cap)


def gqa_attention_full(x, p, cfg, positions, *, causal: bool = True,
                       kv_override=None, train: bool = False,
                       attn_block: int = 512, attn_mode: str = "full",
                       env=None):
    """Full-sequence attention: prefill through the flash kernel, or with
    ``train`` through ``chunked_attention_train`` (blocks of
    ``attn_block``, in ``attn_mode``), either soft-capped by
    ``cfg.attn_logit_softcap`` (``_attend``).  ``kv_override`` (k, v),
    each (B, Sk, K, dh): a cross-attention's keys and values, taken as
    they are (no rope), while q is roped at ``positions``, as the
    reference does; the projections it replaces are not computed.
    Returns (y, k, v).

    On a mesh: each rank runs ``flash_prefill`` (with ``train``,
    ``chunked_attention_train``) on its q rows and heads
    (``_attn_q_spec``) over the kv heads they read (``_kv_for_heads``);
    y is the out-projection, ``rs_out_proj``'s reduce-scatter onto the
    sequence under ``opts["rs_matmul"]`` (heads sharded), else a sum
    pending over 'model'; in f32 (``_out_proj``).  ``kv_override`` is
    then a pair of DTensors (any layout); the rank takes its q rows of
    them."""
    if on_mesh(env):
        B, S, _ = x.shape
        H, dh = cfg.n_heads, cfg.head_dim
        qw = _attn_q_spec(cfg, env)
        if kv_override is None:
            q, k, v = _gqa_qkv_local(x, p, cfg, positions, env)
        else:
            q = gqa_q(_local(x, env, qw[0], None, None),
                      _q_params(p, env, qw[2]), cfg, positions)
            k, v = kv_override
        h0, Hl = _heads(env, env.spec((B, S, H, dh), qw)[2], H)
        kk, vv = _kv_for_heads(_local(k, env, qw[0], None, None, None),
                               _local(v, env, qw[0], None, None, None),
                               h0, Hl, H)
        y = _global(_attend(q, kk, vv, causal=causal, train=train,
                            attn_block=attn_block, attn_mode=attn_mode,
                            window=cfg.sliding_window,
                            cap=cfg.attn_logit_softcap),
                    env, (B, S, H, dh), qw)
        if env.opts.get("rs_matmul") and env.heads_shardable(H):
            return rs_out_proj(y, p["wo"], env, "bshx,hxd->bsd"), k, v
        return _out_proj(y, p["wo"], env, qw), k, v
    if kv_override is None:
        q, k, v = gqa_qkv(x, p, cfg, positions)
    else:
        q, (k, v) = gqa_q(x, p, cfg, positions), kv_override
    y = _attend(q, k, v, causal=causal, train=train,
                attn_block=attn_block, attn_mode=attn_mode,
                window=cfg.sliding_window, cap=cfg.attn_logit_softcap)
    return torch.einsum("bshx,hxd->bsd", y, p["wo"]), k, v


def gqa_attention_decode_paged(x, p, cfg, k_pool, v_pool, tables, pos,
                               block_ids, offsets, env=None):
    """One-token decode over pool blocks: appends the new token's K/V into
    each row's tail block, then attends through the block tables.
    pos: (B,) int32 position of the new token.  Returns (y, k_pool,
    v_pool), the pools updated in place.  On a mesh the pools are one
    layer's DTensors (``lm.decode_step_paged`` says how they are laid
    out) and ``tables`` / ``pos`` / ``block_ids`` / ``offsets`` tensors
    every rank holds whole (``_paged_decode_sharded``)."""
    if on_mesh(env):
        return _paged_decode_sharded(x, p, cfg, k_pool, v_pool, tables, pos,
                                     block_ids, offsets, env)
    q, k, v = gqa_qkv(x, p, cfg, pos[:, None])
    k_pool, v_pool = paged_kv_update(k_pool, v_pool, k, v, block_ids,
                                     offsets)
    y = paged_decode(q[:, 0].contiguous(), k_pool, v_pool, tables, pos + 1,
                     window=cfg.sliding_window)
    return torch.einsum("bhx,hxd->bd", y, p["wo"])[:, None], k_pool, v_pool


def append_rows(kp, vp, k, v, block_ids, offsets, env, rows, heads):
    """Append the new K/V of every row into this rank's pool replica:
    ``k`` / ``v`` (its rows under the batch entry ``rows``, every kv
    head) gathered over the batch axes, then its kv heads ``heads`` of
    each row appended (the drop sentinel skips the idle rows), so every
    data replica writes the same blocks."""
    B = block_ids.shape[0]
    k0, nk = heads
    k, v = (_local(_global(t, env, (B, *t.shape[1:]), [rows, None, None,
                                                        None]),
                   env, None, None, None, None) for t in (k, v))
    paged_kv_update(kp, vp, k[:, :, k0:k0 + nk], v[:, :, k0:k0 + nk],
                    block_ids, offsets)


def _paged_decode_sharded(x, p, cfg, k_pool, v_pool, tables, pos, block_ids,
                          offsets, env):
    """``gqa_attention_decode_paged`` on a mesh: each rank computes the
    new token's K/V for its batch rows, ``append_rows`` lands every row
    in its replica, and it runs ``paged_decode`` on its q rows and heads
    (``_attn_q_spec``): in place over its kv heads of the pool where the
    pool splits them over 'model' or its q heads are all H, else over its
    rows' gathered blocks, the kv heads chosen by ``_kv_for_heads``."""
    B = x.shape[0]
    H, K, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    kp, vp = k_pool.to_local(), v_pool.to_local()
    k0, nk = _heads(env, sharding_spec(k_pool, env)[2], K)
    bt = env.spec(x.shape, [env.batch_axes, None, None])[0]
    xb, pb = _decode_rows(x, pos, env, bt)
    k, v = _gqa_kv(xb, _whole(p, env, ("wk", "wv", "knorm")), cfg,
                   pb[:, None])
    append_rows(kp, vp, k, v, block_ids, offsets, env, bt, (k0, nk))
    qw = _attn_q_spec(cfg, env)
    xq, pq = _decode_rows(x, pos, env, qw[0])
    q = gqa_q(xq, _q_params(p, env, qw[2]), cfg, pq[:, None])
    h0, Hl = _heads(env, env.spec((B, 1, H, dh), qw)[2], H)
    tq = shard_of(tables, env, [qw[0], None])
    if nk == K and Hl != H:
        kk, vv = _kv_for_heads(*paged_kv_gather(kp, vp, tq), h0, Hl, H)
        y = paged_decode(q[:, 0].contiguous(), kk, vv,
                         *_contiguous_table(pq), window=cfg.sliding_window)
    else:
        y = paged_decode(q[:, 0].contiguous(), kp, vp, tq, pq + 1,
                         window=cfg.sliding_window)
    y = _global(y[:, None], env, (B, 1, H, dh), qw)
    return _out_proj(y, p["wo"], env, qw), k_pool, v_pool


def _contiguous_table(pos):
    """A per-layer contiguous cache (B, max_len, K, dh) read as a pool of B
    blocks of max_len tokens: block table ``arange(B)[:, None]`` and, for a
    new token at ``pos`` (B,) int32, lens ``pos + 1``."""
    B = pos.shape[0]
    tables = torch.arange(B, dtype=torch.int32, device=pos.device)[:, None]
    return tables, pos + 1


def _cache_insert(k_cache, v_cache, k, v, pos, start=None):
    """Write row b's (B, 1, K, dh) k/v into the contiguous caches at
    position ``pos[b]``, in place, through ``paged_append`` (block b,
    offset pos).  The reference's dynamic_update_slice returns new caches
    and clamps a position past the end, where the append would drop it:
    ``lm.decode_step`` refuses such a position before it gets here.

    With ``start``, the caches are one rank's shard of a sequence split
    over ranks, holding positions [start, start + their length): a row
    whose position lies outside gets the drop sentinel (block id B), so
    only the rank that owns the position writes it."""
    B = k.shape[0]
    ids = torch.arange(B, dtype=torch.int32, device=k.device)
    if start is not None:
        own = (pos >= start) & (pos < start + k_cache.shape[1])
        ids = torch.where(own, ids, B)
        pos = torch.where(own, pos - start, 0)
    return paged_append(k_cache, v_cache, k[:, 0].contiguous(),
                        v[:, 0].contiguous(), ids, pos)


def sharding_spec(x, env):
    """The spec a DTensor is laid out as (``sharding.spec_of``)."""
    return spec_of(env.mesh, x.placements, x.dim())


def _cache_layout(cache, env):
    """(batch entry, sequence entry, first position) of a rank's shard of
    a (B, max_len, ...) cache DTensor."""
    spec = sharding_spec(cache, env)
    n = cache.shape[1] // env.axis_size(spec[1])
    return spec[0], spec[1], axis_index(env, spec[1]) * n


def _decode_rows(x, pos, env, entry):
    """This rank's rows of the decode input x (B, 1, d) and of pos (B,)
    under a batch entry."""
    return _local(x, env, entry, None, None), shard_of(pos, env, [entry])


def _gqa_decode_sharded(x, p, cfg, k_cache, v_cache, pos, env):
    """``gqa_attention_decode`` on a mesh.  Each rank computes the new
    token's K/V for its cache rows and appends it where its sequence shard
    holds ``pos`` (the others pass the drop sentinel), gathers the layer's
    K/V sequence shards for its q rows, and runs ``paged_decode`` on its q
    rows and heads (``_attn_q_spec``) over the kv heads they read."""
    B = x.shape[0]
    H, dh = cfg.n_heads, cfg.head_dim
    qw = _attn_q_spec(cfg, env)
    cb, _, start = _cache_layout(k_cache, env)
    xc, pc = _decode_rows(x, pos, env, cb)
    k, v = _gqa_kv(xc, _whole(p, env, ("wk", "wv", "knorm")), cfg,
                   pc[:, None])
    _cache_insert(k_cache.to_local(), v_cache.to_local(), k, v, pc, start)
    xq, pq = _decode_rows(x, pos, env, qw[0])
    q = gqa_q(xq, _q_params(p, env, qw[2]), cfg, pq[:, None])
    h0, Hl = _heads(env, env.spec((B, 1, H, dh), qw)[2], H)
    kk, vv = _kv_for_heads(_local(k_cache, env, qw[0], None, None, None),
                           _local(v_cache, env, qw[0], None, None, None),
                           h0, Hl, H)
    y = paged_decode(q[:, 0].contiguous(), kk, vv,
                     *_contiguous_table(pq), window=cfg.sliding_window)
    y = _global(y[:, None], env, (B, 1, H, dh), qw)
    return _out_proj(y, p["wo"], env, qw), k_cache, v_cache


def gqa_attention_decode(x, p, cfg, k_cache, v_cache, pos, env=None):
    """One-token decode over contiguous caches (B, max_len, K, dh), updated
    in place.  pos: (B,) int32 position of the new token.  Returns
    (y, k_cache, v_cache).  On a mesh the caches are DTensors laid out as
    ``lm.cache_pspecs`` puts them (``_gqa_decode_sharded``)."""
    if on_mesh(env):
        return _gqa_decode_sharded(x, p, cfg, k_cache, v_cache, pos, env)
    q, k, v = gqa_qkv(x, p, cfg, pos[:, None])
    k_cache, v_cache = _cache_insert(k_cache, v_cache, k, v, pos)
    y = paged_decode(q[:, 0].contiguous(), k_cache, v_cache,
                     *_contiguous_table(pos), window=cfg.sliding_window)
    return torch.einsum("bhx,hxd->bd", y, p["wo"])[:, None], k_cache, v_cache


def cross_attention_decode(x, p, cfg, k_cross, v_cross, pos, env=None):
    """One-token cross-attention over a frozen cross cache (B, Ss, K, dh):
    q projected and roped at ``pos`` (B,) int32, the cross K/V unroped, as
    the reference's ``encdec.decode_step`` does; every one of the Ss
    positions visible (its ``decode_attention`` at position Ss - 1).  Read
    through ``paged_decode`` as one block of Ss a row.  The reference's
    decode applies no qk_norm to this q (its prefill does).

    On a mesh the cross cache is a DTensor (``lm.cache_pspecs`` puts its
    sequence over 'model'): each rank gathers its q rows' shards, as
    ``_gqa_decode_sharded`` does for the self cache, and runs the kernel
    on its q rows and heads over the kv heads they read; y is the
    out-projection, a sum pending over 'model' (``_out_proj``)."""
    if on_mesh(env):
        B, Ss = k_cross.shape[0], k_cross.shape[1]
        H, dh = cfg.n_heads, cfg.head_dim
        qw = _attn_q_spec(cfg, env)
        xq, pq = _decode_rows(x, pos, env, qw[0])
        q = gqa_q(xq, _q_params(p, env, qw[2]), cfg, pq[:, None],
                  qk_norm=False)
        h0, Hl = _heads(env, env.spec((B, 1, H, dh), qw)[2], H)
        kk, vv = _kv_for_heads(_local(k_cross, env, qw[0], None, None, None),
                               _local(v_cross, env, qw[0], None, None, None),
                               h0, Hl, H)
        Bq = q.shape[0]
        tables = torch.arange(Bq, dtype=torch.int32, device=q.device)[:, None]
        lens = torch.full((Bq,), Ss, dtype=torch.int32, device=q.device)
        y = paged_decode(q[:, 0], kk, vv, tables, lens)
        return _out_proj(_global(y[:, None], env, (B, 1, H, dh), qw),
                         p["wo"], env, qw)
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


def _mla_heads(x, p, cfg, positions, ckv, k_rope):
    """q, k, v of the heads of ``p["wuq"]`` / ``p["wukv"]`` (all H, or a
    rank's), k's rope part shared by those heads."""
    B, S, _ = x.shape
    nope = cfg.qk_nope_head_dim
    q_nope, q_rope = _mla_q(x, p, cfg, positions)
    kv = torch.einsum("bsr,rhx->bshx", ckv, p["wukv"])
    k = torch.cat([kv[..., :nope], k_rope[:, :, None, :].expand(
        B, S, kv.shape[2], cfg.qk_rope_head_dim)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    return q, k, kv[..., nope:].contiguous()


_MLA_Q = ("wdq", "q_ln", "wdkv", "kv_ln")


def mla_attention_full(x, p, cfg, positions, *, train: bool = False,
                       attn_block: int = 512, attn_mode: str = "full",
                       env=None):
    """Prefill MLA: the latent expanded to per-head keys and values, k's
    rope part shared by the H heads, causal attention through
    ``flash_prefill`` (with ``train``, ``chunked_attention_train``) at
    query-key width nope + rope and value width v_head_dim.  Returns (y,
    ckv (B, S, r), k_rope (B, S, rope)).

    On a mesh each rank expands its heads of the latent (``_attn_q_spec``:
    its rows, and its heads where they split over 'model') and attends
    over them as above; the latent and rope keys are DTensors of the same
    rows, y a sum pending over 'model'."""
    if on_mesh(env):
        B, S, _ = x.shape
        hw = _attn_q_spec(cfg, env)
        xl = _local(x, env, hw[0], None, None)
        lp = {**_whole(p, env, _MLA_Q),
              **_q_params(p, env, hw[2], ("wuq", "wukv"))}
        ckv, k_rope = _mla_latent(xl, lp, cfg, positions)
        q, k, v = _mla_heads(xl, lp, cfg, positions, ckv, k_rope)
        y = _global(_attend(q, k, v, causal=True, train=train,
                            attn_block=attn_block, attn_mode=attn_mode),
                    env, (B, S, cfg.n_heads, cfg.v_head_dim), hw)
        rows = [hw[0], None, None]
        return (_out_proj(y, p["wo"], env, hw, "bshv,hvd->bsd"),
                _global(ckv, env, (B, S, ckv.shape[-1]), rows),
                _global(k_rope, env, (B, S, k_rope.shape[-1]), rows))
    ckv, k_rope = _mla_latent(x, p, cfg, positions)
    q, k, v = _mla_heads(x, p, cfg, positions, ckv, k_rope)
    y = _attend(q, k, v, causal=True, train=train, attn_block=attn_block,
                attn_mode=attn_mode)
    return torch.einsum("bshv,hvd->bsd", y, p["wo"]), ckv, k_rope


def _mla_attend(q_nope, q_rope, ckv_cache, krope_cache, wukv, pos, cfg,
                dtype):
    """The absorbed-matrix attention of q's heads over a whole latent
    cache, in f32: returns y (B, 1, heads, vd) in ``dtype``."""
    nope = cfg.qk_nope_head_dim
    wk_b, wv_b = wukv[..., :nope], wukv[..., nope:]
    q_lat = torch.einsum("bxhn,rhn->bhr", q_nope.float(), wk_b.float())
    ckv = ckv_cache.float()
    s = (torch.einsum("bhr,bsr->bhs", q_lat, ckv)
         + torch.einsum("bxhp,bsp->bhs", q_rope.float(),
                        krope_cache.float())) \
        * (1.0 / math.sqrt(nope + cfg.qk_rope_head_dim))
    S = ckv_cache.shape[1]
    valid = torch.arange(S, device=pos.device)[None, :] <= pos[:, None]
    s = s.masked_fill(~valid[:, None, :], NEG_INF)
    o_lat = torch.einsum("bhs,bsr->bhr", torch.softmax(s, dim=-1), ckv)
    o = torch.einsum("bhr,rhv->bhv", o_lat, wv_b.float())
    return o[:, None].to(dtype)


def _mla_decode_sharded(x, p, cfg, ckv_cache, krope_cache, pos, env):
    """``mla_attention_decode`` on a mesh: the new latent entries written
    by the rank whose sequence shard holds ``pos`` (an indexed write that
    keeps the old value on the other rows), the shards gathered for the
    rank's q rows, its heads attended and projected."""
    B = x.shape[0]
    hw = _attn_q_spec(cfg, env)
    cb, _, start = _cache_layout(ckv_cache, env)
    xc, pc = _decode_rows(x, pos, env, cb)
    ckv_new, krope_new = _mla_latent(xc, _whole(p, env, _MLA_Q), cfg,
                                     pc[:, None])
    ckv_l, krope_l = ckv_cache.to_local(), krope_cache.to_local()
    own = (pc >= start) & (pc < start + ckv_l.shape[1])
    rows = torch.arange(pc.shape[0], device=x.device)
    off = torch.where(own, pc - start, 0).long()
    for cache, new in ((ckv_l, ckv_new), (krope_l, krope_new)):
        cache[rows, off] = torch.where(own[:, None], new[:, 0],
                                       cache[rows, off])
    xq, pq = _decode_rows(x, pos, env, hw[0])
    lp = {**_whole(p, env, _MLA_Q),
          **_q_params(p, env, hw[2], ("wuq", "wukv"))}
    q_nope, q_rope = _mla_q(xq, lp, cfg, pq[:, None])
    y = _mla_attend(q_nope, q_rope,
                    _local(ckv_cache, env, hw[0], None, None),
                    _local(krope_cache, env, hw[0], None, None),
                    lp["wukv"], pq, cfg, x.dtype)
    y = _global(y, env, (B, 1, cfg.n_heads, cfg.v_head_dim), hw)
    return (_out_proj(y, p["wo"], env, hw, "bshv,hvd->bsd"), ckv_cache,
            krope_cache)


def mla_attention_decode(x, p, cfg, ckv_cache, krope_cache, pos, env=None):
    """Absorbed-matrix MLA decode over the compressed latent cache
    (B, max_len, r) and rope keys (B, max_len, rope), updated in place:
    the new entries are written at ``pos`` (B,) int32, then every slot at
    or before it is attended, in f32 over the upcast cache as the
    reference computes it.  Returns (y, ckv_cache, krope_cache)."""
    if on_mesh(env):
        return _mla_decode_sharded(x, p, cfg, ckv_cache, krope_cache, pos,
                                   env)
    B = x.shape[0]
    q_nope, q_rope = _mla_q(x, p, cfg, pos[:, None])
    ckv_new, krope_new = _mla_latent(x, p, cfg, pos[:, None])
    rows = torch.arange(B, device=x.device)
    ckv_cache[rows, pos.long()] = ckv_new[:, 0]
    krope_cache[rows, pos.long()] = krope_new[:, 0]
    y = _mla_attend(q_nope, q_rope, ckv_cache, krope_cache, p["wukv"], pos,
                    cfg, x.dtype)
    return torch.einsum("bshv,hvd->bsd", y, p["wo"]), ckv_cache, krope_cache


# ---------------------------------------------------------------------------
# reduce-scatter TP matmul
# ---------------------------------------------------------------------------
def rs_out_proj(y, w, env, einsum_str: str):
    """Tensor-parallel output projection with an explicit reduce-scatter
    over 'model' onto the SEQUENCE dim, producing the sequence-parallel
    layout directly: each rank's heads times its rows of w (an FSDP'd w
    gathered over 'data' first), the partial sums then ``Partial`` ->
    ``Shard(1)`` on 'model'.  Taken where ``opts["rs_matmul"]`` is set, tp
    > 1 and tp divides S; otherwise the plain einsum (on a mesh: the same
    local products, their sum still pending over 'model')."""
    if not on_mesh(env):
        return torch.einsum(einsum_str, y, w)
    bt = env.batch_axes
    out = _out_proj(y, w, env, [bt, None, "model", None], einsum_str)
    if env.tp > 1 and y.shape[1] % env.tp == 0 \
            and env.opts.get("rs_matmul", False):
        return env.cs(out, bt, "model", None)
    return out


# ---------------------------------------------------------------------------
# dense FFN (SwiGLU)
# ---------------------------------------------------------------------------
def ffn_swiglu(x, p, env=None):
    """On a mesh: each rank's rows times its d_ff columns of w1 / w3 (h
    laid out as the reference's ``cs(h, batch, None, "model")``) and its
    rows of w2, the weights gathered over FSDP's axis; the sum pending
    over 'model' where d_ff splits there, in f32 (as ``_out_proj``)."""
    if not on_mesh(env):
        h = F.silu(x @ p["w1"]) * (x @ p["w3"])
        return h @ p["w2"]
    bt = env.batch_axes
    xl = _local(x, env, bt, None, None)
    h = F.silu(xl @ _local(p["w1"], env, None, "model")) \
        * (xl @ _local(p["w3"], env, None, "model"))
    split = env.spec((*x.shape[:2], p["w1"].shape[-1]), [bt, None, "model"])
    return _global(h.float() @ _local(p["w2"], env, "model", None).float(),
                   env, x.shape, [bt, None, None], partial=split[2])


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


# ---------------------------------------------------------------------------
# MoE: capacity-buffer dispatch (expert parallelism), rank-local math
# ---------------------------------------------------------------------------
def _dispatch(top_p, top_e, e_start: int, e_local: int, capacity: int):
    """The reference's static-capacity dispatch of the (token, pick) pairs
    routed to experts [e_start, e_start + e_local): stably sorted by local
    expert, so each expert's pairs keep token order, and each expert's
    first ``capacity`` kept.  Returns (keep, slot, token, weight) in that
    order; slot ``e_local * capacity`` is the overflow row of the pairs
    not kept."""
    T, k = top_e.shape
    dev = top_e.device
    flat_e, flat_p = top_e.reshape(-1), top_p.reshape(-1)
    flat_t = torch.arange(T, device=dev).repeat_interleave(k)
    local = (flat_e >= e_start) & (flat_e < e_start + e_local)
    loc_e = torch.where(local, flat_e - e_start, e_local)
    order = torch.sort(loc_e, stable=True).indices
    s_e, s_t, s_p = loc_e[order], flat_t[order], flat_p[order]
    # each local expert's pairs (and the overflow's), counted into a fixed
    # (e_local + 1,) tensor: the same counts as ``bincount`` (s_e <=
    # e_local), with a static shape that a meta tensor can carry
    counts = torch.zeros(e_local + 1, dtype=s_e.dtype, device=dev
                         ).index_add_(0, s_e, torch.ones_like(s_e))
    pos = torch.arange(s_e.shape[0], device=dev) \
        - (torch.cumsum(counts, 0) - counts)[s_e]
    keep = (pos < capacity) & (s_e < e_local)
    slot = torch.where(keep, s_e * capacity + pos, e_local * capacity)
    return keep, slot, s_t, s_p


def _buffer(x2d, keep, slot, s_t, e_local: int, capacity: int):
    """The kept pairs' token rows in their expert's slots:
    (e_local, capacity, d), empty slots zero."""
    buf = x2d.new_zeros(e_local * capacity + 1, x2d.shape[1])
    buf[slot] = torch.where(keep[:, None], x2d[s_t], 0)
    return buf[:-1].reshape(e_local, capacity, x2d.shape[1])


def _combine(out, keep, slot, s_t, s_p, T: int):
    """Each token's sum of its kept pairs' expert outputs times their
    weights, in f32: (T, d)."""
    rows = out.reshape(-1, out.shape[-1])
    got = torch.where(keep[:, None], rows[slot.clamp(max=rows.shape[0] - 1)],
                      0)
    y = torch.zeros(T, rows.shape[-1], dtype=F32, device=rows.device)
    return y.index_add_(0, s_t, got.float() * s_p[:, None])


def _moe_local(x2d, router_w, w1, w3, w2, *, n_experts: int, top_k: int,
               e_start: int, e_local: int, capacity: int):
    """Route local tokens to experts [e_start, e_start+e_local) with a
    static-capacity buffer: the twin of the reference's ``_moe_local``
    (``repro/models/layers.py:658``), routed by ``moe_router``.  No
    collectives."""
    top_p, top_e = moe_router(x2d, router_w, top_k)
    keep, slot, s_t, s_p = _dispatch(top_p, top_e, e_start, e_local,
                                     capacity)
    return _experts(x2d, s_p, w1, w3, w2, keep=keep, slot=slot, s_t=s_t,
                    e_local=e_local, capacity=capacity).to(x2d.dtype)


def _experts(x2d, s_p, w1, w3, w2, *, keep, slot, s_t, e_local: int,
             capacity: int, bmm=None):
    """The dispatched pairs through their experts' SwiGLU, combined by
    their gates ``s_p``: (T, d) f32.  ``bmm(x, w, dim)`` multiplies by a
    weight whose d_model is ``dim`` (``torch.bmm``, or on a mesh the
    FSDP-gathered product)."""
    bmm = bmm or (lambda a, w, dim: torch.bmm(a, w))
    buf = _buffer(x2d, keep, slot, s_t, e_local, capacity)
    h = F.silu(bmm(buf, w1, 1)) * bmm(buf, w3, 1)
    out = bmm(h, w2, 2)                                 # (e_local, C, d)
    return _combine(out, keep, slot, s_t, s_p, x2d.shape[0])


def _maybe_gather(w, axis_name, dim, env, full_dim):
    """all_gather a weight block along `axis_name` if it was FSDP-sharded."""
    if axis_name is None or env.axis_sizes.get(axis_name, 1) == 1:
        return w
    if w.shape[dim] == full_dim:    # divisibility pruning left it whole
        return w
    return all_gather(w, env, axis_name, dim)


def _expert_specs(p, env, ep: bool, fullshard: bool):
    """The wants of (router, w1 and w3, w2) in ``moe_ep``'s body: experts
    over 'model' (EP), or d_ff over 'model' (d_ff TP), d_model over FSDP's
    axis; under ``serve_fullshard`` d_model over 'data'.  The d_ff-TP
    layout with a tp that divides neither E nor d_ff raises: there the
    reference's spec leaves every expert whole on every shard, and its
    psum over 'model' returns tp times the output (ROADMAP Queue 3)."""
    tp_ax, fsdp = env.tp_axis, env.fsdp_axis
    if fullshard:
        return [None, None], [tp_ax, "data", None], [tp_ax, None, "data"]
    if ep:
        return [fsdp, None], [tp_ax, fsdp, None], [tp_ax, None, fsdp]
    w1 = [None, fsdp, tp_ax]
    if env.tp > 1 and env.spec(p["w1"].shape, w1)[2] is None:
        E, f = p["w1"].shape[0], p["w1"].shape[2]
        raise ValueError(
            f"moe_ep: tp {env.tp} divides neither n_experts {E} nor d_ff "
            f"{f}; the reference's d_ff-TP branch would sum {env.tp} whole "
            f"copies of the output (ROADMAP Queue 3)")
    return [fsdp, None], w1, [None, tp_ax, fsdp]


def moe_ep(x, p, cfg, env, capacity_factor: float = 1.25):
    """Expert-parallel MoE over the 'model' axis: the reference's
    ``moe_ep`` (``repro/models/layers.py:697``), its ``shard_map`` bodies
    run on each rank's shards.

    Experts shard over 'model' when divisible, summed by a psum over
    'model'; otherwise every shard computes all experts over a d_ff
    slice (same psum).  The ranks' gated sums are summed in f32 and
    rounded once, as one device rounds a token's sum over its experts
    once (the reference's body rounds each rank's sum to bf16 before its
    psum).  Expert weights are FSDP-sharded over 'data' on d_model and
    gathered inside the body, each one in its product and again in its
    transpose (``sharding.gathered_bmm``).  Under ``serve_fullshard``
    (EP, a 'data' axis) the tokens are replicated, each rank dispatches
    its d_model slice, and the partial-d contraction is summed over
    'data', the experts over 'model', then the d slices gathered.
    Capacity: max(4, ceil(t_local * k / E * capacity_factor)), t_local
    from the pruned batch spec.  Returns a DTensor laid out as x's batch
    spec."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    if not on_mesh(env):
        return moe_dense_ref(x.reshape(-1, d), p, cfg).reshape(B, S, d)
    ep = env.moe_ep(E)
    fullshard = bool(env.opts.get("serve_fullshard")) and ep \
        and "data" in env.axis_sizes
    tp_ax = env.tp_axis
    x_spec = env.spec(x.shape, [None if fullshard else env.batch_axes,
                                None, None])
    r_w, w1_w, w2_w = _expert_specs(p, env, ep, fullshard)
    e_local = E // env.tp if ep else E
    t_local = (B // env.axis_size(x_spec[0])) * S
    capacity = max(4, int(math.ceil(t_local * k / E * capacity_factor)))
    xb = _local(x, env, *x_spec)
    x2 = xb.reshape(-1, d)
    rw = _local(p["router"], env, *r_w)
    w1, w3 = (_local(p[n], env, *w1_w) for n in ("w1", "w3"))
    w2 = _local(p["w2"], env, *w2_w)
    e0 = axis_index(env, tp_ax) * e_local if ep else 0
    if fullshard:
        y2 = _moe_fullshard_body(x2, rw, w1, w3, w2, env, k, e0, e_local,
                                 capacity)
    else:
        fsdp = env.fsdp_axis
        rw = _maybe_gather(rw, fsdp, 0, env, p["router"].shape[0])
        top_p, top_e = moe_router(x2, rw, k)
        keep, slot, s_t, s_p = _dispatch(top_p, top_e, e0, e_local,
                                         capacity)
        full = p["w1"].shape[1]

        def bmm(a, w, dim):        # unless divisibility left w whole
            split = fsdp if w.shape[dim] != full else None
            return gathered_bmm(a, w, env, split, dim)

        y2 = psum(_experts(x2, s_p, w1, w3, w2, keep=keep, slot=slot,
                           s_t=s_t, e_local=e_local, capacity=capacity,
                           bmm=bmm), env, tp_ax).to(xb.dtype)
    return _global(y2.reshape(xb.shape), env, x.shape, list(x_spec))


def _moe_fullshard_body(x2, rw, w1, w3, w2, env, k, e0, e_local, capacity):
    """``moe_ep``'s ``serve_fullshard`` body: every token routed on every
    rank, the rank's d_model slice of each kept pair dispatched to its
    experts, h summed over 'data' (the weights never move), the f32
    outputs summed over 'model' and the d slices gathered over 'data'."""
    T, d = x2.shape
    d_local = d // env.axis_sizes.get("data", 1)
    top_p, top_e = moe_router(x2, rw, k)
    keep, slot, s_t, s_p = _dispatch(top_p, top_e, e0, e_local, capacity)
    didx = axis_index(env, "data") * d_local
    buf = _buffer(x2[:, didx:didx + d_local], keep, slot, s_t, e_local,
                  capacity)
    h1 = psum(torch.bmm(buf, w1), env, "data")
    h3 = psum(torch.bmm(buf, w3), env, "data")
    out = torch.bmm(F.silu(h1) * h3, w2)          # (e_local, C, d_local)
    y2 = psum(_combine(out, keep, slot, s_t, s_p, T), env, env.tp_axis)
    return all_gather(y2, env, "data", 1).to(x2.dtype)


def _moe_dense_sharded(x, p, cfg, env):
    """The dense impl on a mesh (the reference's ``moe_block(impl=
    "dense")``): no capacity.  Each rank computes, for its rows, the
    experts (or the d_ff slice of every expert) of ``moe_ep``'s layout,
    the weights gathered over FSDP's axis, gated in f32; the f32 sums are
    then summed over 'model'."""
    B, S, d = x.shape
    E = cfg.n_experts
    ep = env.moe_ep(E)
    r_w, w1_w, w2_w = _expert_specs(p, env, ep, False)
    x_spec = env.spec(x.shape, [env.batch_axes, None, None])
    xb = _local(x, env, *x_spec)
    x2 = xb.reshape(-1, d)
    top_p, top_e = moe_router(x2, _whole_tensor(p["router"]), cfg.top_k)
    full = [None if a == env.fsdp_axis else a for a in w1_w]
    w1, w3 = (_local(p[n], env, *full) for n in ("w1", "w3"))
    w2 = _local(p["w2"], env, *[None if a == env.fsdp_axis else a
                                for a in w2_w])
    e_local = w1.shape[0]
    e0 = axis_index(env, env.tp_axis) * e_local if ep else 0
    h = F.silu(torch.matmul(x2, w1)) * torch.matmul(x2, w3)
    y_e = torch.matmul(h, w2)                       # (e_local, T, d)
    gate = torch.zeros(x2.shape[0], E, dtype=F32, device=x2.device
                       ).scatter_add_(1, top_e, top_p)[:, e0:e0 + e_local]
    y = psum(torch.einsum("etd,te->td", y_e.float(), gate), env,
              env.tp_axis)
    return _global(y.to(x.dtype).reshape(xb.shape), env, x.shape,
                   list(x_spec))


def moe_block(x, p, cfg, impl: str = "ep", env=None):
    """MoE FFN + optional shared experts.  Without a mesh every impl is
    the dense one, as in the reference; on a mesh ``impl="ep"`` is
    ``moe_ep`` and ``"dense"`` the capacity-free ``_moe_dense_sharded``."""
    B, S, d = x.shape
    if not on_mesh(env):
        y = moe_dense_ref(x.reshape(-1, d), p, cfg).reshape(B, S, d)
    elif impl == "dense":
        y = _moe_dense_sharded(x, p, cfg, env)
    elif impl == "ep":
        y = moe_ep(x, p, cfg, env)
    else:
        raise ValueError(f"moe_block: impl {impl!r} is not 'ep' or 'dense'")
    if cfg.n_shared_experts:
        shared = ffn_swiglu(x, {"w1": p["ws1"], "w3": p["ws3"],
                                "w2": p["ws2"]}, env)
        if on_mesh(env):          # summed, then rounded as on one device
            shared = env.cs(shared, *sharding_spec(y, env))
            y = dt_add(y, rowwise(lambda t: t.to(y.dtype), shared))
        else:
            y = y + shared
    return y
