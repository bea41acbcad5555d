"""Decoder-only LM in PyTorch: init, the JAX parameter bridge, prefill and
paged decode for the uniform GQA decoder (the dense family).

The twin of ``repro.models.lm`` on the serving engine's main path.
Params are a plain dict with the reference tree's keys and shapes (bf16;
math accumulates in f32 where the reference's does): ``embed``,
``final_norm``, ``unembed`` when untied, and ``layers`` holding
``ln1``, ``ln2``, ``attn.{wq,wk,wv,wo}`` and ``mlp.{w1,w3,w2}`` stacked
on a leading layer axis.  The reference's layer ``scan`` is a Python loop
over that axis.  The moe and vlm families (router, patch stream) and the
other families are later slices of the port and raise here.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L

F32 = torch.float32
BF16 = torch.bfloat16


def check_family(cfg: ModelConfig) -> None:
    if cfg.family != "dense" or cfg.enc_dec or cfg.use_mla \
            or cfg.attn_period:
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family}): the port covers the dense GQA "
            f"family; moe and vlm come in the next slice, the rest later")


# ===========================================================================
# init
# ===========================================================================
def init_params(cfg: ModelConfig, seed: int = 0,
                device="cuda") -> Dict[str, Any]:
    """Random bf16 params (normal * 0.02, norms 1) from a ``torch.Generator``
    seeded with ``seed`` on ``device``.  The numbers differ from the
    reference's ``jax.random`` init; carry JAX params with
    ``params_from_jax``.  Raises when ``device`` is CUDA and there is no
    card: nothing falls back to the CPU."""
    check_family(cfg)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("init_params: CUDA is not available; pass "
                           "device='cpu' to run on the CPU")
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def dense(*shape):
        return (torch.randn(shape, generator=gen, dtype=F32, device=device)
                * 0.02).to(BF16)

    def ones(*shape):
        return torch.ones(shape, dtype=BF16, device=device)

    d, f, n = cfg.d_model, cfg.d_ff, cfg.n_layers
    H, K, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    params: Dict[str, Any] = {"embed": dense(cfg.vocab, d),
                              "final_norm": ones(d)}
    if not cfg.tie_embeddings:
        params["unembed"] = dense(d, cfg.vocab)
    attn = {"wq": dense(n, d, H, dh), "wk": dense(n, d, K, dh),
            "wv": dense(n, d, K, dh), "wo": dense(n, H, dh, d)}
    if cfg.qk_norm:
        attn["qnorm"] = ones(n, dh)
        attn["knorm"] = ones(n, dh)
    params["layers"] = {
        "ln1": ones(n, d), "ln2": ones(n, d), "attn": attn,
        "mlp": {"w1": dense(n, d, f), "w3": dense(n, d, f),
                "w2": dense(n, f, d)},
    }
    return params


def params_from_jax(tree, device="cuda"):
    """The reference's ``lm.init_params`` tree, as numpy arrays
    (``np.asarray`` on each leaf), to the port's params with the same keys
    and shapes.  bf16 leaves (``ml_dtypes.bfloat16``) travel as their
    16-bit patterns, so the carry is bit-exact."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if not isinstance(tree, np.ndarray):
        raise TypeError(f"params_from_jax takes numpy arrays, not "
                        f"{type(tree).__name__}")
    a = np.array(tree)            # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(BF16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def _layer(tree, i: int):
    """Layer ``i`` of a stacked param tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


# ===========================================================================
# embedding / logits
# ===========================================================================
def embed_tokens(params, tokens, cfg):
    return params["embed"][tokens]


def unembed(params, x, cfg):
    """f32 logits: the operands are upcast before the product, as the
    reference's ``preferred_element_type=F32`` accumulates in f32."""
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    return torch.einsum("bsd,dv->bsv", x.float(), w.float())


# ===========================================================================
# layer stacks
# ===========================================================================
def _uniform_block(x, lp, cfg, positions):
    h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
    y, k, v = L.gqa_attention_full(h, lp["attn"], cfg, positions)
    x = L.pin_bf16(x + L.pin_bf16(y))
    h = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
    y = L.ffn_swiglu(h, lp["mlp"])
    return L.pin_bf16(x + L.pin_bf16(y)), (k, v)


def _run_uniform(params, x, cfg, positions):
    ks, vs = [], []
    for i in range(cfg.n_layers):
        x, (k, v) = _uniform_block(x, _layer(params["layers"], i), cfg,
                                   positions)
        ks.append(k)
        vs.append(v)
    return x, (torch.stack(ks), torch.stack(vs))


def _uniform_decode_block_paged(x, lp, kp, vp, tables, pos, block_ids,
                                offsets, cfg):
    """Twin of ``_uniform_block`` for one token over pool blocks, with
    the same residual-stream rounding points."""
    h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
    y, kp, vp = L.gqa_attention_decode_paged(h, lp["attn"], cfg, kp, vp,
                                             tables, pos, block_ids, offsets)
    x = L.pin_bf16(x + L.pin_bf16(y))
    h = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
    y = L.ffn_swiglu(h, lp["mlp"])
    return L.pin_bf16(x + L.pin_bf16(y)), kp, vp


# ===========================================================================
# public entry points
# ===========================================================================
def _assemble_inputs(params, batch, cfg):
    """Text only.  Returns (x, positions), positions counted from 0."""
    x = embed_tokens(params, batch["tokens"], cfg)
    positions = torch.arange(x.shape[1], dtype=torch.int32,
                             device=x.device)[None, :]
    return x, positions


def prefill(params, batch, cfg: ModelConfig,
            max_len: Optional[int] = None):
    """Full-sequence prefill.  batch["tokens"]: (B, S) integer ids.
    Returns (last_logits (B,1,V) f32, {"k", "v": (L, B, max_len, K, dh)})."""
    check_family(cfg)
    x, positions = _assemble_inputs(params, batch, cfg)
    max_len = max_len or x.shape[1]
    x, (k, v) = _run_uniform(params, x, cfg, positions)
    cache = {"k": _pad_seq(k, max_len, 2), "v": _pad_seq(v, max_len, 2)}
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return unembed(params, x[:, -1:, :], cfg), cache


def _pad_seq(x, max_len, axis):
    if x.shape[axis] == max_len:
        return x
    shape = list(x.shape)
    shape[axis] = max_len - x.shape[axis]
    return torch.cat([x, x.new_zeros(shape)], dim=axis)


def decode_step_paged(params, tokens, k_pool, v_pool, tables, pos,
                      block_ids, offsets, cfg: ModelConfig):
    """One decode step attending over the serving pool's blocks in place.

    tokens: (B, 1) ids; k_pool/v_pool: (L, num_blocks, block, K, dh);
    tables: (B, max_blocks) int32 (rows padded with any in-range id);
    pos: (B,) int32 position of the new token; block_ids/offsets: (B,)
    int32 append destination of its K/V (idle rows pass num_blocks, a
    drop sentinel).  The pools are updated in place, where the reference
    returns new arrays.  Returns (logits (B,1,V) f32, k_pool, v_pool)."""
    check_family(cfg)
    x = embed_tokens(params, tokens, cfg)
    for i in range(cfg.n_layers):
        x, _, _ = _uniform_decode_block_paged(
            x, _layer(params["layers"], i), k_pool[i], v_pool[i], tables,
            pos, block_ids, offsets, cfg)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return unembed(params, x, cfg), k_pool, v_pool
