"""Decoder-only LM in PyTorch: init, the JAX parameter bridge, prefill,
decode and full-sequence logits for the dense (uniform GQA), ssm (rwkv6)
and hybrid (jamba superblocks) families.

The twin of ``repro.models.lm``.  Params are a plain dict with the
reference tree's keys and shapes (bf16, except mamba's f32 ``A_log``;
math accumulates in f32 where the reference's does):

- dense: ``layers`` holds ``ln1``, ``ln2``, ``attn.{wq,wk,wv,wo}`` and
  ``mlp.{w1,w3,w2}`` stacked on a leading layer axis;
- ssm: ``layers`` holds ``ln1``, ``ln2``, ``tm`` (time mix) and ``cm``
  (channel mix) stacked the same way;
- hybrid: ``superblocks`` stacks, per superblock of ``attn_period`` slots,
  ``attn``/``attn_ln`` and the per-slot ``mamba``, ``moe`` and ``ffn``
  stacks with their norms.

The reference's layer ``scan`` is a Python loop over the stacked axis.
Caches: dense {k, v} (L, B, max_len, K, dh); ssm {wkv, shift_tm,
shift_cm}; hybrid {k, v} per superblock plus {conv, ssm} per mamba slot.
``decode_step`` (every family, over these caches) and ``decode_step_paged``
(dense, over the serving pool) update them in place, where the reference
returns new ones.  The moe and vlm families (uniform MoE, the patch
stream), MLA and enc-dec are later slices of the port and raise.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models import rwkv as R

F32 = torch.float32
BF16 = torch.bfloat16
FAMILIES = ("dense", "ssm", "hybrid")


def check_family(cfg: ModelConfig) -> None:
    """The families the model functions take.  The serving engine has its
    own, narrower guard (``serving/engine.py``)."""
    if cfg.family not in FAMILIES or cfg.enc_dec or cfg.use_mla \
            or bool(cfg.attn_period) != (cfg.family == "hybrid"):
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family}): the port's model functions cover "
            f"the dense, ssm and hybrid families; moe, vlm, MLA and "
            f"enc-dec come in a later slice")


# ===========================================================================
# init
# ===========================================================================
class _Init:
    """The reference's init distributions from a ``torch.Generator``:
    normal * scale in bf16, drawn in slices of at most 2**26 elements so a
    stacked expert weight never has a full-size f32 temporary."""

    CHUNK = 1 << 26

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)

    def dense(self, *shape, scale: float = 0.02):
        out = torch.empty(shape, dtype=BF16, device=self.device)
        flat = out.view(-1, shape[-1])
        rows = max(1, self.CHUNK // shape[-1])
        for i in range(0, flat.shape[0], rows):
            part = flat[i:i + rows]
            part.copy_(torch.randn(part.shape, generator=self.gen, dtype=F32,
                                   device=self.device) * scale)
        return out

    def full(self, *shape, value: float = 1.0):
        return torch.full(shape, value, dtype=BF16, device=self.device)


def _attn_init(I: _Init, cfg: ModelConfig, *n):
    d, H, K, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {"wq": I.dense(*n, d, H, dh), "wk": I.dense(*n, d, K, dh),
         "wv": I.dense(*n, d, K, dh), "wo": I.dense(*n, H, dh, d)}
    if cfg.qk_norm:
        p["qnorm"] = I.full(*n, dh)
        p["knorm"] = I.full(*n, dh)
    return p


def _ffn_init(I: _Init, cfg: ModelConfig, *n):
    d, f = cfg.d_model, cfg.d_ff
    return {"w1": I.dense(*n, d, f), "w3": I.dense(*n, d, f),
            "w2": I.dense(*n, f, d)}


def _moe_init(I: _Init, cfg: ModelConfig, *n):
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {"router": I.dense(*n, d, E), "w1": I.dense(*n, E, d, f),
         "w3": I.dense(*n, E, d, f), "w2": I.dense(*n, E, f, d)}
    if cfg.n_shared_experts:
        fs = cfg.n_shared_experts * f
        p.update(ws1=I.dense(*n, d, fs), ws3=I.dense(*n, d, fs),
                 ws2=I.dense(*n, fs, d))
    return p


def _mamba_init(I: _Init, cfg: ModelConfig, *n):
    d, di, ds = cfg.d_model, cfg.mamba_d_inner, cfg.mamba_d_state
    dtr = cfg.dt_rank
    A = torch.arange(1, ds + 1, dtype=F32, device=I.device)
    return {
        "in_proj": I.dense(*n, d, 2 * di),
        "conv_w": I.dense(*n, di, cfg.mamba_d_conv, scale=0.2),
        "conv_b": I.full(*n, di, value=0.0),
        "x_proj": I.dense(*n, di, dtr + 2 * ds),
        "dt_w": I.dense(*n, dtr, di),
        "dt_b": I.full(*n, di, value=-4.6),
        "A_log": torch.log(A).expand(*n, di, ds).contiguous(),
        "D": I.full(*n, di),
        "out_proj": I.dense(*n, di, d),
    }


def _rwkv_init(I: _Init, cfg: ModelConfig, n: int):
    d, H, hs, f = cfg.d_model, cfg.rwkv_n_heads, cfg.rwkv_head_size, cfg.d_ff
    dec = -5.0 + 8.0 * (torch.arange(d, dtype=F32, device=I.device)
                        / max(d - 1, 1)) ** 0.7
    zeros = lambda: I.full(n, d, value=0.0)  # noqa: E731
    tm = {
        "maa_x": zeros(), "maa_w": zeros(), "maa_k": zeros(),
        "maa_v": zeros(), "maa_r": zeros(), "maa_g": zeros(),
        "maa_w1": I.dense(n, d, 5 * R.DDLERP_W, scale=0.01),
        "maa_w2": I.dense(n, 5, R.DDLERP_W, d, scale=0.01),
        "decay": dec.to(BF16).expand(n, d).contiguous(),
        "decay_w1": I.dense(n, d, R.DECAY_W, scale=0.01),
        "decay_w2": I.dense(n, R.DECAY_W, d, scale=0.01),
        "faaaa": I.dense(n, H, hs, scale=0.5),
        "Wr": I.dense(n, d, d), "Wk": I.dense(n, d, d),
        "Wv": I.dense(n, d, d), "Wg": I.dense(n, d, d),
        "Wo": I.dense(n, d, d),
        "ln_x": I.full(n, d),
    }
    cm = {"cmix_maa_k": zeros(), "cmix_maa_r": zeros(),
          "Wck": I.dense(n, d, f), "Wcv": I.dense(n, f, d),
          "Wcr": I.dense(n, d, d)}
    return {"tm": tm, "cm": cm, "ln1": I.full(n, d), "ln2": I.full(n, d)}


def _jamba_counts(cfg: ModelConfig):
    """(mamba, moe, ffn) slots per superblock.  Like the reference's init,
    MoE placement is read from the global layer index; the forward reads
    it from the slot (``_jamba_superblock``)."""
    per = cfg.attn_period
    n_moe = sum(cfg.layer_is_moe(gi) for gi in range(per))
    return per - 1, n_moe, per - n_moe


def init_params(cfg: ModelConfig, seed: int = 0,
                device="cuda") -> Dict[str, Any]:
    """Random params with the reference's tree, shapes and init
    distributions, from a ``torch.Generator`` seeded with ``seed`` on
    ``device``.  The numbers differ from the reference's ``jax.random``
    init; carry JAX params with ``params_from_jax``.  Raises when
    ``device`` is CUDA and there is no card: nothing falls back to the
    CPU."""
    check_family(cfg)
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("init_params: CUDA is not available; pass "
                           "device='cpu' to run on the CPU")
    I = _Init(seed, device)
    d, n = cfg.d_model, cfg.n_layers
    params: Dict[str, Any] = {"embed": I.dense(cfg.vocab, d),
                              "final_norm": I.full(d)}
    if not cfg.tie_embeddings:
        params["unembed"] = I.dense(d, cfg.vocab)
    if cfg.family == "ssm":
        params["layers"] = _rwkv_init(I, cfg, n)
    elif cfg.family == "hybrid":
        nsb = n // cfg.attn_period
        nm, ne, nf = _jamba_counts(cfg)
        params["superblocks"] = {
            "attn": _attn_init(I, cfg, nsb), "attn_ln": I.full(nsb, d),
            "mamba": _mamba_init(I, cfg, nsb, nm),
            "mamba_ln": I.full(nsb, nm, d),
            "moe": _moe_init(I, cfg, nsb, ne), "moe_ln": I.full(nsb, ne, d),
            "ffn": _ffn_init(I, cfg, nsb, nf), "ffn_ln": I.full(nsb, nf, d),
        }
    else:
        params["layers"] = {"ln1": I.full(n, d), "ln2": I.full(n, d),
                            "attn": _attn_init(I, cfg, n),
                            "mlp": _ffn_init(I, cfg, n)}
    return params


def params_from_jax(tree, device="cuda"):
    """The reference's ``lm.init_params`` tree, as numpy arrays
    (``np.asarray`` on each leaf), to the port's params with the same keys
    and shapes.  bf16 leaves (``ml_dtypes.bfloat16``) travel as their
    16-bit patterns and f32 leaves as they are, so the carry is
    bit-exact."""
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


def _uniform_decode_block(x, lp, kc, vc, cfg, pos):
    """Twin of ``_uniform_block`` for one token over a contiguous per-layer
    cache (B, max_len, K, dh), updated in place, with the same
    residual-stream rounding points."""
    h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
    y, kc, vc = L.gqa_attention_decode(h, lp["attn"], cfg, kc, vc, pos)
    x = L.pin_bf16(x + L.pin_bf16(y))
    h = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
    y = L.ffn_swiglu(h, lp["mlp"])
    return L.pin_bf16(x + L.pin_bf16(y))


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


# --- jamba superblocks -----------------------------------------------------
def _jamba_superblock(x, sb, cfg, positions, *, states=None, collect=False,
                      pos=None):
    """One superblock (attn_period slots).  states: this superblock's
    decode states (``k``, ``v`` caches updated in place, ``conv``,
    ``ssm``) or None.  Returns (x, (k, v) or None, {conv, ssm} or None).

    The reference's quirks are mirrored: the attention sits at slot
    ``per // 2`` and ``layer_is_moe`` is asked with the slot, not the
    global layer index."""
    per = cfg.attn_period
    eps = cfg.norm_eps
    mi = ji = fi = 0
    conv, ssm = [], []
    kv_out = None
    for slot in range(per):
        if slot == per // 2:
            h = L.rms_norm(x, sb["attn_ln"], eps)
            if states is None:
                y, k, v = L.gqa_attention_full(h, sb["attn"], cfg, positions)
                if collect:
                    kv_out = (k, v)
            else:
                y, kc, vc = L.gqa_attention_decode(
                    h, sb["attn"], cfg, states["k"], states["v"], pos)
                kv_out = (kc, vc)
        else:
            lp = _layer(sb["mamba"], mi)
            h = L.rms_norm(x, sb["mamba_ln"][mi], eps)
            if states is None and not collect:
                y = M.mamba_layer(h, lp, cfg)
            else:
                y, conv_s, ssm_s = M.mamba_layer(
                    h, lp, cfg, return_state=True,
                    conv_state=None if states is None else states["conv"][mi],
                    ssm_state=None if states is None else states["ssm"][mi])
                conv.append(conv_s)
                ssm.append(ssm_s)
            mi += 1
        x = L.pin_bf16(x + y)
        if cfg.layer_is_moe(slot):
            h = L.rms_norm(x, sb["moe_ln"][ji], eps)
            y = L.moe_block(h, _layer(sb["moe"], ji), cfg)
            ji += 1
        else:
            h = L.rms_norm(x, sb["ffn_ln"][fi], eps)
            y = L.ffn_swiglu(h, _layer(sb["ffn"], fi))
            fi += 1
        x = L.pin_bf16(x + y)
    new_states = ({"conv": torch.stack(conv), "ssm": torch.stack(ssm)}
                  if conv else None)
    return x, kv_out, new_states


def _run_jamba(params, x, cfg, positions, *, collect=False):
    """Returns (x, None) or, with ``collect``, (x, ((k, v), {conv, ssm}))
    stacked over superblocks."""
    nsb = cfg.n_layers // cfg.attn_period
    ks, vs, convs, ssms = [], [], [], []
    for s in range(nsb):
        x, kv, st = _jamba_superblock(x, _layer(params["superblocks"], s),
                                      cfg, positions, collect=collect)
        if collect:
            ks.append(kv[0])
            vs.append(kv[1])
            convs.append(st["conv"])
            ssms.append(st["ssm"])
    if not collect:
        return x, None
    return x, ((torch.stack(ks), torch.stack(vs)),
               {"conv": torch.stack(convs), "ssm": torch.stack(ssms)})


# --- rwkv ------------------------------------------------------------------
def _rwkv_block(x, lp, cfg, *, collect=False):
    h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
    if collect:
        y, s_tm, wkv = R.rwkv6_time_mix(h, lp["tm"], cfg, return_state=True)
    else:
        y = R.rwkv6_time_mix(h, lp["tm"], cfg)
    x = x + y
    h = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
    if collect:
        y, s_cm = R.rwkv6_channel_mix(h, lp["cm"], cfg, return_state=True)
    else:
        y = R.rwkv6_channel_mix(h, lp["cm"], cfg)
    x = L.pin_bf16(x + y)
    return x, ((wkv, s_tm, s_cm) if collect else None)


def _run_rwkv(params, x, cfg, *, collect=False):
    """Returns (x, None) or, with ``collect``, (x, (wkv, shift_tm,
    shift_cm)) stacked over layers."""
    sts = []
    for i in range(cfg.n_layers):
        x, st = _rwkv_block(x, _layer(params["layers"], i), cfg,
                            collect=collect)
        sts.append(st)
    if not collect:
        return x, None
    return x, tuple(torch.stack(z) for z in zip(*sts))


def _rwkv_decode_block(x, lp, st, cfg):
    wkv, s_tm, s_cm = st
    h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
    y, s_tm2, wkv2 = R.rwkv6_time_mix(h, lp["tm"], cfg, shift_state=s_tm,
                                      wkv_state=wkv, return_state=True)
    x = x + y
    h = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
    y, s_cm2 = R.rwkv6_channel_mix(h, lp["cm"], cfg, shift_state=s_cm,
                                   return_state=True)
    x = x + y
    return x, (wkv2, s_tm2, s_cm2)


# ===========================================================================
# public entry points
# ===========================================================================
def _assemble_inputs(params, batch, cfg):
    """Text only.  Returns (x, positions), positions counted from 0."""
    x = embed_tokens(params, batch["tokens"], cfg)
    positions = torch.arange(x.shape[1], dtype=torch.int32,
                             device=x.device)[None, :]
    return x, positions


def _final(params, x, cfg):
    return unembed(params, L.rms_norm(x, params["final_norm"], cfg.norm_eps),
                   cfg)


def forward_logits(params, batch, cfg: ModelConfig):
    """Full-sequence forward.  batch["tokens"]: (B, S) integer ids.
    Returns logits (B, S, V) f32."""
    check_family(cfg)
    x, positions = _assemble_inputs(params, batch, cfg)
    if cfg.family == "ssm":
        x, _ = _run_rwkv(params, x, cfg)
    elif cfg.family == "hybrid":
        x, _ = _run_jamba(params, x, cfg, positions)
    else:
        x, _ = _run_uniform(params, x, cfg, positions)
    return _final(params, x, cfg)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=BF16,
               device="cuda") -> Dict[str, Any]:
    """Zero decode caches with the reference's keys, shapes and types."""
    check_family(cfg)

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    d = cfg.d_model
    if cfg.family == "ssm":
        H, hs, n = cfg.rwkv_n_heads, cfg.rwkv_head_size, cfg.n_layers
        return {"wkv": zeros(n, batch, H, hs, hs, dt=F32),
                "shift_tm": zeros(n, batch, d), "shift_cm": zeros(n, batch, d)}
    K, dh = cfg.n_kv_heads, cfg.head_dim
    if cfg.family == "hybrid":
        nsb, nm = cfg.n_layers // cfg.attn_period, cfg.attn_period - 1
        di, ds = cfg.mamba_d_inner, cfg.mamba_d_state
        return {"k": zeros(nsb, batch, max_len, K, dh),
                "v": zeros(nsb, batch, max_len, K, dh),
                "conv": zeros(nsb, nm, batch, cfg.mamba_d_conv - 1, di),
                "ssm": zeros(nsb, nm, batch, di, ds, dt=F32)}
    n = cfg.n_layers
    return {"k": zeros(n, batch, max_len, K, dh),
            "v": zeros(n, batch, max_len, K, dh)}


def prefill(params, batch, cfg: ModelConfig,
            max_len: Optional[int] = None):
    """Full-sequence prefill.  batch["tokens"]: (B, S) integer ids.
    Returns (last_logits (B,1,V) f32, cache): dense {"k", "v": (L, B,
    max_len, K, dh)}; ssm {"wkv", "shift_tm", "shift_cm"}; hybrid {"k",
    "v": (nsb, B, max_len, K, dh), "conv", "ssm"}."""
    check_family(cfg)
    x, positions = _assemble_inputs(params, batch, cfg)
    max_len = max_len or x.shape[1]
    if cfg.family == "ssm":
        x, (wkv, s_tm, s_cm) = _run_rwkv(params, x, cfg, collect=True)
        cache = {"wkv": wkv, "shift_tm": s_tm, "shift_cm": s_cm}
    elif cfg.family == "hybrid":
        x, ((k, v), st) = _run_jamba(params, x, cfg, positions, collect=True)
        cache = {"k": _pad_seq(k, max_len, 2), "v": _pad_seq(v, max_len, 2),
                 "conv": st["conv"], "ssm": st["ssm"]}
    else:
        x, (k, v) = _run_uniform(params, x, cfg, positions)
        cache = {"k": _pad_seq(k, max_len, 2), "v": _pad_seq(v, max_len, 2)}
    return _final(params, x[:, -1:, :], cfg), cache


def _pad_seq(x, max_len, axis):
    if x.shape[axis] == max_len:
        return x
    shape = list(x.shape)
    shape[axis] = max_len - x.shape[axis]
    return torch.cat([x, x.new_zeros(shape)], dim=axis)


def decode_step(params, tokens, cache, pos, cfg: ModelConfig):
    """One decode step.  tokens: (B, 1) ids; pos: an int or (B,) position
    of the new token; cache: ``prefill``'s or ``init_cache``'s, updated in
    place (the reference returns a new one).  Returns (logits (B,1,V) f32,
    cache).

    A position at or past the k/v cache's ``max_len`` raises (on the card,
    as a device-side assert: no host sync).  The reference's
    ``dynamic_update_slice`` clamps it to the last slot and attends over
    every slot; the port's append would drop it.  The serving runtime
    never gets there: a program's context is capped at ``max_len``
    (``workflow/program.py``), so the last decoded token sits at
    ``max_len - 1``."""
    check_family(cfg)
    x = embed_tokens(params, tokens, cfg)
    B = x.shape[0]
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device
                          ).broadcast_to((B,)).contiguous()
    if "k" in cache:
        torch._assert_async((pos < cache["k"].shape[2]).all(),
                            "decode_step: a position at or past the cache's "
                            "max_len")
    if cfg.family == "dense":
        for i in range(cfg.n_layers):
            x = _uniform_decode_block(x, _layer(params["layers"], i),
                                      cache["k"][i], cache["v"][i], cfg, pos)
    elif cfg.family == "ssm":
        for i in range(cfg.n_layers):
            x, st = _rwkv_decode_block(
                x, _layer(params["layers"], i),
                (cache["wkv"][i], cache["shift_tm"][i], cache["shift_cm"][i]),
                cfg)
            for key, new in zip(("wkv", "shift_tm", "shift_cm"), st):
                cache[key][i].copy_(new)
    elif cfg.family == "hybrid":
        for s in range(cfg.n_layers // cfg.attn_period):
            states = {key: cache[key][s] for key in ("k", "v", "conv", "ssm")}
            x, _, st = _jamba_superblock(
                x, _layer(params["superblocks"], s), cfg, None,
                states=states, pos=pos)
            cache["conv"][s].copy_(st["conv"])
            cache["ssm"][s].copy_(st["ssm"])
    return _final(params, x, cfg), cache


def decode_step_paged(params, tokens, k_pool, v_pool, tables, pos,
                      block_ids, offsets, cfg: ModelConfig):
    """One decode step attending over the serving pool's blocks in place.

    tokens: (B, 1) ids; k_pool/v_pool: (L, num_blocks, block, K, dh);
    tables: (B, max_blocks) int32 (rows padded with any in-range id);
    pos: (B,) int32 position of the new token; block_ids/offsets: (B,)
    int32 append destination of its K/V (idle rows pass num_blocks, a
    drop sentinel).  Covers the uniform GQA-cache families, as the
    reference's does.  The pools are updated in place, where the reference
    returns new arrays.  Returns (logits (B,1,V) f32, k_pool, v_pool)."""
    check_family(cfg)
    if cfg.family == "ssm" or cfg.attn_period:
        raise ValueError("paged decode covers the uniform GQA-cache "
                         "families")
    x = embed_tokens(params, tokens, cfg)
    for i in range(cfg.n_layers):
        x, _, _ = _uniform_decode_block_paged(
            x, _layer(params["layers"], i), k_pool[i], v_pool[i], tables,
            pos, block_ids, offsets, cfg)
    return _final(params, x, cfg), k_pool, v_pool
