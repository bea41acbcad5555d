"""Encoder-decoder (seamless-m4t) in PyTorch: the twin of
``repro.models.encdec``.  The speech front end is a stub there too: the
encoder takes precomputed frame embeddings.  A decode step's state is the
decoder's self-attention cache and the frozen cross-attention K/V.

Params (bf16): ``embed``, ``unembed``, ``enc_norm``, ``final_norm``;
``enc_layers`` stacks ``ln1``, ``ln2``, ``attn.{wq,wk,wv,wo}`` and
``mlp.{w1,w3,w2}`` on a leading layer axis; ``dec_layers`` stacks
``ln1``, ``ln_cross``, ``ln2``, ``attn``, ``cross`` (the same tree as
``attn``; its ``wk``/``wv`` project the encoder output) and ``mlp``.  A
batch is ``frames`` (B, Ss, d_model) and ``tgt_tokens`` (B, St).

Attention goes through the port's kernels: the encoder's non-causal
``flash_prefill`` over the frames, the decoder's causal one over the
target, and the cross-attention's non-causal one with St queries over Ss
keys; a decode step runs ``paged_append`` + ``paged_decode`` over the
self cache and ``paged_decode`` over the cross cache; ``forward_train``
runs each attention through ``layers.chunked_attention_train`` instead
(no kernel has a backward).  As in the
reference, the decoder's residual adds are not pinned, the cross
queries are roped at the target positions and the cross keys are not.
Each layer loop is a Python loop over the stacked axis; the caches are
updated in place, where the reference returns new ones.

On a mesh (an ``env`` whose ``ShardingEnv`` carries one) ``prefill``,
``decode_step`` and ``forward_logits`` take and return DTensors, as
``lm``'s do: the encoder is the uniform stack's non-causal attention and
FFN with the stream at the reference's ``_res_cs`` points; each decoder
layer's cross K/V are projected from the rank's rows of the encoder
output (gathered once, whole sequence), and the cross-attention runs on
the rank's q rows and heads over them (``layers.gqa_attention_full``
with ``kv_override``); the prefill's caches come back laid out by
``lm.cache_pspecs`` (every sequence, the cross caches' too, over
'model'), and a decode step gathers the cross cache's shards for its q
rows (``layers.cross_attention_decode``).  ``forward_train`` on a mesh
runs the same layers on the training route (``train_loss_sharded``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import lm

BF16 = torch.bfloat16


def init_params(cfg: ModelConfig, seed: int = 0,
                device="cuda") -> Dict[str, Any]:
    """Random params with the reference's tree, shapes and init
    distributions (``lm.init_params`` sends an enc-dec config here)."""
    I = lm._Init(seed, device)
    d, ne, nd = cfg.d_model, cfg.n_enc_layers, cfg.n_dec_layers
    return {
        "embed": I.dense(cfg.vocab, d), "unembed": I.dense(d, cfg.vocab),
        "enc_norm": I.full(d), "final_norm": I.full(d),
        "enc_layers": {"ln1": I.full(ne, d), "ln2": I.full(ne, d),
                       "attn": lm._attn_init(I, cfg, ne),
                       "mlp": lm._ffn_init(I, cfg, ne)},
        "dec_layers": {"ln1": I.full(nd, d), "ln_cross": I.full(nd, d),
                       "ln2": I.full(nd, d),
                       "attn": lm._attn_init(I, cfg, nd),
                       "cross": lm._attn_init(I, cfg, nd),
                       "mlp": lm._ffn_init(I, cfg, nd)},
    }


def _positions(n: int, device):
    return torch.arange(n, dtype=torch.int32, device=device)[None, :]


def _encoder_block(x, lp, cfg, positions, opts=None):
    h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
    y, _, _ = L.gqa_attention_full(h, lp["attn"], cfg, positions,
                                   causal=False, **lm._attn_kw(opts))
    x = x + y
    h = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + L.ffn_swiglu(h, lp["mlp"])


def _run_encoder(params, frames, cfg, opts=None, env=None):
    """The encoder over the frames, non-causal; its output normed.
    ``opts``: ``lm.train_opts`` for the training route, None for
    inference."""
    if L.on_mesh(env):
        return _run_encoder_sharded(params, frames, cfg, env)
    x = frames.to(BF16)
    positions = _positions(x.shape[1], x.device)
    block = lm._maybe_remat(_encoder_block, opts)
    for lp in lm._layers(params["enc_layers"]):
        x = block(x, lp, cfg, positions, opts)
    return L.rms_norm(x, params["enc_norm"], cfg.norm_eps)


def _encoder_block_sharded(x, lp, cfg, positions, env, sp, opts=None):
    h = lm._norm(x, lp["ln1"], cfg)
    y, _, _ = L.gqa_attention_full(h, lp["attn"], cfg, positions,
                                   causal=False, env=env,
                                   **lm._attn_kw(opts))
    x = lm._add(x, y, env, sp)
    h = lm._norm(x, lp["ln2"], cfg)
    return lm._add(x, L.ffn_swiglu(h, lp["mlp"], env), env, sp)


def _run_encoder_sharded(params, frames, cfg, env, opts=None):
    """``_run_encoder`` on a mesh: the frames (a tensor every rank holds
    whole, or a DTensor) laid out as the stream; the output normed, laid
    out as the stream.  ``opts``: ``lm.mesh_train_opts`` for the training
    route."""
    sp, bt = env.opts.get("sp", True), env.batch_axes
    fl = (L._local(frames, env, bt, None, None) if lm._is_dtensor(frames)
          else L.shard_of(frames, env, [bt, None, None]))
    x = lm._res_cs(L._global(fl.to(BF16), env, frames.shape,
                             [bt, None, None]), env, sp)
    positions = _positions(x.shape[1], fl.device)
    block = lm._maybe_remat(_encoder_block_sharded, opts)
    for lp in lm._layers(params["enc_layers"]):
        x = block(x, lp, cfg, positions, env, sp, opts)
    return lm._norm(x, params["enc_norm"], cfg)


def _cross_kv(lp_cross, enc_out):
    """One layer's cross K/V (B, Ss, K, dh) from the encoder output."""
    k = torch.einsum("bsd,dkx->bskx", enc_out, lp_cross["wk"])
    v = torch.einsum("bsd,dkx->bskx", enc_out, lp_cross["wv"])
    return k.contiguous(), v.contiguous()


def _decoder_block(x, lp, cfg, positions, enc_out, opts=None):
    """Returns (x, (self k, self v, cross k, cross v))."""
    kw = lm._attn_kw(opts)
    h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
    y, sk, sv = L.gqa_attention_full(h, lp["attn"], cfg, positions, **kw)
    x = x + y
    h = L.rms_norm(x, lp["ln_cross"], cfg.norm_eps)
    ck, cv = _cross_kv(lp["cross"], enc_out)
    y, _, _ = L.gqa_attention_full(h, lp["cross"], cfg, positions,
                                   causal=False, kv_override=(ck, cv), **kw)
    x = x + y
    h = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + L.ffn_swiglu(h, lp["mlp"]), (sk, sv, ck, cv)


def _decoder_block_sharded(x, lp, cfg, positions, enc_rows, env, sp,
                           opts=None):
    """``_decoder_block`` on a mesh; ``enc_rows`` is the rank's rows of
    the encoder output, whole sequence.  The cache entries are DTensors
    (self k, v with their rows over the batch axes; cross k, v as well);
    with ``opts`` (the training route) there are none."""
    bt = env.batch_axes
    kw = lm._attn_kw(opts)
    h = lm._norm(x, lp["ln1"], cfg)
    y, sk, sv = L.gqa_attention_full(h, lp["attn"], cfg, positions, env=env,
                                     **kw)
    x = lm._add(x, y, env, sp)
    h = lm._norm(x, lp["ln_cross"], cfg)
    ck, cv = _cross_kv(L._whole(lp["cross"], env, ("wk", "wv")), enc_rows)
    shape = (x.shape[0], enc_rows.shape[1], *ck.shape[2:])
    ck, cv = (L._global(t, env, shape, [bt, None, None, None])
              for t in (ck, cv))
    y, _, _ = L.gqa_attention_full(h, lp["cross"], cfg, positions,
                                   causal=False, kv_override=(ck, cv),
                                   env=env, **kw)
    x = lm._add(x, y, env, sp)
    h = lm._norm(x, lp["ln2"], cfg)
    x = lm._add(x, L.ffn_swiglu(h, lp["mlp"], env), env, sp)
    return x, (None if opts is not None else (sk, sv, ck, cv))


def _run_decoder_sharded(params, batch, cfg, env, max_len=None, opts=None):
    """``_run_decoder`` on a mesh; the per-layer caches padded (self) and
    laid out with their sequence over 'model' (with ``opts``, the training
    route: (x, None))."""
    sp, bt = env.opts.get("sp", True), env.batch_axes
    enc_rows = L._local(_run_encoder_sharded(params, batch["frames"], cfg,
                                             env, opts), env, bt, None, None)
    x = lm._res_cs(lm.embed_tokens(params, batch["tgt_tokens"], cfg, env),
                   env, sp)
    positions = _positions(x.shape[1], enc_rows.device)
    max_len = max_len or x.shape[1]
    seq = [bt, "model", None, None]
    if opts is not None:
        block = lm._maybe_remat(_decoder_block_sharded, opts)
        for lp in lm._layers(params["dec_layers"]):
            x, _ = block(x, lp, cfg, positions, enc_rows, env, sp, opts)
        return x, None
    kvs = []
    for lp in lm._layers(params["dec_layers"]):
        x, (sk, sv, ck, cv) = _decoder_block_sharded(x, lp, cfg, positions,
                                                     enc_rows, env, sp)
        kvs.append((lm._pad_seq_local(sk, max_len, env, seq),
                    lm._pad_seq_local(sv, max_len, env, seq),
                    env.cs(ck, *seq), env.cs(cv, *seq)))
    return x, kvs


def _run_decoder(params, batch, cfg, opts=None):
    """The decoder over the target tokens; returns (x, [per-layer (sk,
    sv, ck, cv)]), or (x, None) in training."""
    enc_out = _run_encoder(params, batch["frames"], cfg, opts)
    x = params["embed"][batch["tgt_tokens"]]
    positions = _positions(x.shape[1], x.device)
    block = lm._maybe_remat(_decoder_block, opts)
    kvs = []
    for lp in lm._layers(params["dec_layers"]):
        x, kv = block(x, lp, cfg, positions, enc_out, opts)
        kvs.append(kv)
    return x, (None if opts is not None else kvs)


def forward_train(params, batch, cfg, env=None, *, opts=None):
    """The training loss over ``tgt_labels`` (B, St): the encoder and the
    decoder on the training route, then ``lm.chunked_xent``; the twin of
    the reference's ``encdec.forward_train`` (``repro/models/encdec.py:
    113``).  ``lm.forward_train`` sends an enc-dec config here; on a mesh
    it runs ``train_loss_sharded`` and this sends it there."""
    if L.on_mesh(env):
        return lm.forward_train(params, batch, cfg, env, opts=opts)
    opts = lm.train_opts(opts)
    x, _ = _run_decoder(params, batch, cfg, opts)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return lm.chunked_xent(params, x, batch["tgt_labels"], cfg,
                           opts["loss_chunk"])


def train_loss_sharded(params, batch, cfg, env, opts):
    """The training loss on a mesh, before ``lm.forward_train`` seeds it:
    the encoder and the decoder on the rank's shards (the cross K/V from
    the rank's rows of the encoder output, gathered once, whole
    sequence), then ``lm.chunked_xent`` on the mesh over ``tgt_labels``
    (``embed`` / ``unembed`` split over 'model' where tp divides the
    vocabulary, else whole)."""
    x, _ = _run_decoder_sharded(params, batch, cfg, env, opts=opts)
    x = lm._norm(x, params["final_norm"], cfg)
    return lm.chunked_xent(params, x, batch["tgt_labels"], cfg,
                           opts["loss_chunk"], env)


def forward_logits(params, batch, cfg, env=None):
    """Logits (B, St, V) f32 over the target tokens (on a mesh a DTensor
    laid out as ``lm.logits_wants``)."""
    if L.on_mesh(env):
        x, _ = _run_decoder_sharded(params, batch, cfg, env)
        return lm._final(params, x, cfg, env)
    x, _ = _run_decoder(params, batch, cfg)
    return lm._final(params, x, cfg)


def init_cache(cfg, batch, max_len, dtype=BF16, device="cuda",
               src_len: Optional[int] = None):
    """Self-attention cache (decoder) and cross K/V (filled by prefill)."""
    K, dh, n = cfg.n_kv_heads, cfg.head_dim, cfg.n_dec_layers
    src_len = src_len or max_len

    def zeros(s):
        return torch.zeros(n, batch, s, K, dh, dtype=dtype, device=device)

    return {"k": zeros(max_len), "v": zeros(max_len),
            "cross_k": zeros(src_len), "cross_v": zeros(src_len)}


def prefill(params, batch, cfg, env=None, max_len: Optional[int] = None):
    """Encode the frames and prefill the decoder over the target prefix.
    Returns (last_logits (B,1,V) f32, cache {k, v: (Ld, B, max_len, K,
    dh), cross_k, cross_v: (Ld, B, Ss, K, dh)}); on a mesh DTensors, the
    cache laid out by ``lm.cache_pspecs``."""
    if L.on_mesh(env):
        x, kvs = _run_decoder_sharded(params, batch, cfg, env, max_len)
        B, St = x.shape[:2]
        cache = dict(zip(("k", "v", "cross_k", "cross_v"),
                         (lm._stack(z) for z in zip(*kvs))))
        specs = lm.cache_pspecs(cfg, env, B, max_len or St,
                                src_len=cache["cross_k"].shape[2])
        return (lm._final(params, lm._last(x, env), cfg, env),
                lm.laid_out(cache, specs, env))
    x, kvs = _run_decoder(params, batch, cfg)
    max_len = max_len or x.shape[1]
    sk, sv, ck, cv = (torch.stack(z) for z in zip(*kvs))
    cache = {"k": lm._pad_seq(sk, max_len, 2),
             "v": lm._pad_seq(sv, max_len, 2), "cross_k": ck, "cross_v": cv}
    return lm._final(params, x[:, -1:, :], cfg), cache


def decode_step(params, tokens, cache, pos, cfg, env=None):
    """One decode step: tokens (B, 1) ids at ``pos`` (an int or (B,)); the
    self cache written in place.  Returns (logits (B,1,V) f32, cache)."""
    if L.on_mesh(env):
        return _decode_step_sharded(params, tokens, cache, pos, cfg, env)
    x = params["embed"][tokens]
    pos = lm.decode_positions(pos, x, cache)
    for i, lp in enumerate(lm._layers(params["dec_layers"])):
        h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
        y, _, _ = L.gqa_attention_decode(h, lp["attn"], cfg, cache["k"][i],
                                         cache["v"][i], pos)
        x = x + y
        h = L.rms_norm(x, lp["ln_cross"], cfg.norm_eps)
        x = x + L.cross_attention_decode(h, lp["cross"], cfg,
                                         cache["cross_k"][i],
                                         cache["cross_v"][i], pos)
        h = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + L.ffn_swiglu(h, lp["mlp"])
    return lm._final(params, x, cfg), cache


def _decode_step_sharded(params, tokens, cache, pos, cfg, env):
    """``decode_step`` on a mesh: the self cache's shards written where
    they hold ``pos``, the cross cache's shards gathered for the q rows;
    the stream laid out with its batch over the batch axes."""
    x = lm.embed_tokens(params, tokens, cfg, env)
    pos = lm.decode_positions(pos, x, cache)
    for i, lp in enumerate(lm._layers(params["dec_layers"])):
        h = lm._norm(x, lp["ln1"], cfg)
        y, _, _ = L.gqa_attention_decode(
            h, lp["attn"], cfg, lm._select(cache["k"], i),
            lm._select(cache["v"], i), pos, env=env)
        x = lm._add(x, y, env, False)
        h = lm._norm(x, lp["ln_cross"], cfg)
        x = lm._add(x, L.cross_attention_decode(
            h, lp["cross"], cfg, lm._select(cache["cross_k"], i),
            lm._select(cache["cross_v"], i), pos, env), env, False)
        h = lm._norm(x, lp["ln2"], cfg)
        x = lm._add(x, L.ffn_swiglu(h, lp["mlp"], env), env, False)
    return lm._decode_logits(params, x, cfg, env), cache
