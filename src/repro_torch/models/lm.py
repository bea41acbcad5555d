"""Decoder-only LM in PyTorch: init, the JAX parameter bridge, the
training loss, prefill, decode and full-sequence logits for the dense and
moe (uniform GQA, or deepseek-v2's MLA), vlm (uniform GQA after a patch
stream), ssm (rwkv6) and hybrid (jamba superblocks) families; the
encoder-decoder (seamless, family "audio") lives in
``repro_torch.models.encdec``, and the entry points here send it there,
as the reference's do.

The twin of ``repro.models.lm``.  Params are a plain dict with the
reference tree's keys and shapes (bf16, except mamba's f32 ``A_log``;
math accumulates in f32 where the reference's does):

- dense / vlm: ``layers`` holds ``ln1``, ``ln2``, ``attn.{wq,wk,wv,wo}``
  and ``mlp.{w1,w3,w2}`` stacked on a leading layer axis; moe's ``mlp``
  is an expert stack ``{router, w1, w3, w2}`` (the dense impl: every
  expert computed, then gated); MLA's ``attn`` is ``{wdq, q_ln, wuq,
  wdkv, kv_ln, wukv, wo}``;
- ssm: ``layers`` holds ``ln1``, ``ln2``, ``tm`` (time mix) and ``cm``
  (channel mix) stacked the same way;
- hybrid: ``superblocks`` stacks, per superblock of ``attn_period`` slots,
  ``attn``/``attn_ln`` and the per-slot ``mamba``, ``moe`` and ``ffn``
  stacks with their norms.

A vlm batch carries ``patches`` (B, P, d_model), pre-projected embeddings
put before the token embeddings; positions run 0..P+S-1, so a decode step
after it takes positions counted with P.

The reference's layer ``scan`` is a Python loop over the stacked axis,
whose layers are split off with ``unbind`` (``_layers``).
``forward_train`` is the training loss under autograd: attention through
``layers.chunked_attention_train``, the recurrences through
``layers.seq_scan``, the loss through ``chunked_xent``; it reaches no
kernel, as the reference's training path reaches no Pallas kernel.
Caches: dense / moe / vlm {k, v} (L, B, max_len, K, dh); MLA {ckv (L, B,
max_len, kv_lora_rank), krope (L, B, max_len, qk_rope_head_dim)}; ssm
{wkv, shift_tm, shift_cm}; hybrid {k, v} per superblock plus {conv, ssm}
per mamba slot; enc-dec {k, v, cross_k, cross_v}.  ``decode_step`` (every
family, over these caches) and ``decode_step_paged`` (the uniform GQA
families, over the serving pool) update them in place, where the
reference returns new ones.

The sharding specs are the reference's: ``param_rules`` /
``param_shardings`` for the params, ``abstract_cache`` / ``cache_pspecs``
for the caches, as ``NamedSharding`` (DTensor placements) on a
``ShardingEnv``'s mesh.  ``prefill``, ``decode_step`` and
``forward_logits`` take an optional ``env`` after ``cfg``, as the
reference's do, and so does ``decode_step_paged``.  Without one (or
with ``ShardingEnv(None)``) they run on one device.  With a mesh they
serve every family: params and caches are DTensors laid out by
``param_shardings`` / ``cache_pspecs`` (``sharding.distribute`` places a
whole tree; the paged pool by ``serving.kvcache.pool_sharding``), the
residual stream is redistributed at the reference's ``_res_cs`` points,
the layers run their shards (``layers``, ``rwkv``, ``mamba``,
``encdec``), the recurrent states come back laid out as ``cache_pspecs``
puts them, and the logits as DTensors laid out as the reference's dry
run fixes them (batch over the batch axes, vocab over 'model').
``forward_train`` takes the same ``env``: on a mesh the loss is
``chunked_xent`` on the ranks' shards (equal on every rank), each param
leaf enters through ``sharding.copies`` and the loss is seeded with each
rank's share, so ``loss.backward()`` leaves every gradient in its
param's ``.grad`` laid out as the param (``sharding``'s docstring says
how each collective transposes).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import sys

import numpy as np
import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models import rwkv as R
from repro_torch.models import sharding as SH
from repro_torch.models.sharding import (ShardingEnv, axis_index,
                                         contiguous_strides, param_pspecs,
                                         tree_map_with_path)

F32 = torch.float32
BF16 = torch.bfloat16
FAMILIES = ("dense", "moe", "vlm", "ssm", "hybrid", "audio")


def check_family(cfg: ModelConfig) -> None:
    """The families the model functions take: MLA in the uniform stacks
    only, enc-dec as the "audio" family, as the reference builds them.
    The serving engine has its own, narrower guard
    (``serving/engine.py``)."""
    if cfg.family not in FAMILIES or cfg.enc_dec != (cfg.family == "audio") \
            or bool(cfg.attn_period) != (cfg.family == "hybrid") \
            or (cfg.use_mla and cfg.family not in ("dense", "moe", "vlm")):
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family}): the port's model functions cover "
            f"the dense, moe (GQA or MLA), vlm, ssm, hybrid and enc-dec "
            f"families as the reference builds them")


# ===========================================================================
# init
# ===========================================================================
class _Init:
    """The reference's init distributions from a ``torch.Generator``:
    normal * scale in bf16, drawn in slices of at most 2**26 elements so a
    stacked expert weight never has a full-size f32 temporary.  On the
    ``meta`` device nothing is drawn or allocated (``abstract_params``)."""

    CHUNK = 1 << 26

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.gen = None
        if self.device.type != "meta":
            self.gen = torch.Generator(device=self.device)
            self.gen.manual_seed(seed)

    def dense(self, *shape, scale: float = 0.02):
        out = torch.empty(shape, dtype=BF16, device=self.device)
        if self.gen is None:
            return out
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
    if cfg.use_mla:
        nope, rd, vd = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                        cfg.v_head_dim)
        qr, kr = cfg.q_lora_rank, cfg.kv_lora_rank
        return {"wdq": I.dense(*n, d, qr), "q_ln": I.full(*n, qr),
                "wuq": I.dense(*n, qr, H, nope + rd),
                "wdkv": I.dense(*n, d, kr + rd), "kv_ln": I.full(*n, kr),
                "wukv": I.dense(*n, kr, H, nope + vd),
                "wo": I.dense(*n, H, vd, d)}
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
    if cfg.enc_dec:
        from repro_torch.models import encdec
        return encdec.init_params(cfg, seed, device)
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
        moe = {cfg.layer_is_moe(i) for i in range(n)}
        if len(moe) > 1:
            # the reference stacks the per-layer trees, which needs every
            # layer alike: its init fails on such a config as well
            raise ValueError(f"{cfg.name}: a uniform stack with MoE on "
                             f"some layers only (moe_layer_period "
                             f"{cfg.moe_layer_period}) cannot be stacked")
        params["layers"] = {"ln1": I.full(n, d), "ln2": I.full(n, d),
                            "attn": _attn_init(I, cfg, n),
                            "mlp": (_moe_init if moe.pop() else _ffn_init)(
                                I, cfg, n)}
    return params


def abstract_params(cfg: ModelConfig) -> Dict[str, Any]:
    """The params' tree of shapes and types with nothing allocated (meta
    tensors): what a checkpoint restore rebuilds, as the reference's
    ``abstract_params`` (``jax.eval_shape`` of ``init_params``).  Built
    outside any dispatch mode the caller has open (``_shapes_only``)."""
    with _shapes_only():
        return init_params(cfg, 0, device="meta")


def _shapes_only():
    """A block whose meta stand-ins describe shapes, not data: the dispatch
    modes a caller has open (a dry run's memory and FLOP counters) do not
    see them, as a card's allocator never sees a meta tensor."""
    from torch.utils._python_dispatch import _disable_current_modes
    return _disable_current_modes()


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


def _is_dtensor(t) -> bool:
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(t, mod.DTensor)


def _shift(pl, by: int):
    """A placement moved ``by`` tensor dims (a stacking axis added in
    front, or taken away)."""
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.placement_types import _StridedShard
    if isinstance(pl, _StridedShard):
        return _StridedShard(pl.dim + by, split_factor=pl.split_factor)
    if isinstance(pl, Shard):
        if pl.dim + by < 0:
            raise ValueError("a stacked DTensor sharded on its layer axis")
        return Shard(pl.dim + by)
    return pl


def _as_layers(t, parts):
    """``parts``, rank-local slices of the stacked DTensor t along its
    layer axis, as DTensors."""
    from torch.distributed.tensor import DTensor
    pls = tuple(_shift(pl, -1) for pl in t.placements)
    return [DTensor.from_local(part, t.device_mesh, pls, run_check=False,
                               shape=t.shape[1:], stride=part.stride())
            for part in parts]


def _whole_layers(t):
    """A stacked DTensor with its layer axis whole on every rank.  The
    reference's rules (``_n_stack``) take seamless's ``enc_layers`` /
    ``dec_layers`` FFN weights (L, d, f) for an expert stack and split
    their layer axis over 'model', which its layer scan gathers; here the
    axis is gathered over that mesh axis before the layers are split off
    (any other leaf is returned as it is).  Under autograd the gather's
    transpose is a reduce-scatter of the stacked gradient over that axis
    (``sharding.all_gather``)."""
    from torch.distributed.tensor import Replicate
    pls = tuple(Replicate() if getattr(pl, "dim", None) == 0 else pl
                for pl in t.placements)
    if pls == tuple(t.placements):
        return t
    return SH.relayout(t, pls)


def _select(t, i: int):
    """Layer ``i`` of a stacked leaf (a view; a DTensor's as a DTensor
    over the view of its shard)."""
    if _is_dtensor(t):
        t = _whole_layers(t)
        return _as_layers(t, [t.to_local()[i]])[0]
    return t[i]


def _stack(ts):
    """``torch.stack`` of per-layer leaves; DTensors stacked shard by
    shard, laid out as their layers with a layer axis in front."""
    if not _is_dtensor(ts[0]):
        return torch.stack(ts)
    from torch.distributed.tensor import DTensor
    t0 = ts[0]
    local = torch.stack([t.to_local() for t in ts])
    return DTensor.from_local(
        local, t0.device_mesh, tuple(_shift(pl, 1) for pl in t0.placements),
        run_check=False, shape=torch.Size((len(ts), *t0.shape)),
        stride=contiguous_strides((len(ts), *t0.shape)))


def _layer(tree, i: int):
    """Layer ``i`` of a stacked param tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return _select(tree, i)


def _layers(tree):
    """Every layer of a stacked param tree, split with ``unbind`` (views).
    Under autograd a stacked leaf's gradient is then one stack of its
    layers' gradients; indexing layer by layer (``_layer``) would add a
    full-size zero tensor per layer."""
    if not isinstance(tree, dict):
        if _is_dtensor(tree):
            tree = _whole_layers(tree)
            return _as_layers(tree, tree.to_local().unbind(0))
        return tree.unbind(0)
    per = {k: _layers(v) for k, v in tree.items()}
    n = len(next(iter(per.values())))
    return [{k: v[i] for k, v in per.items()} for i in range(n)]


# ===========================================================================
# sharding rules
# ===========================================================================
_COL = {"w1", "w3", "wdq", "wdkv", "in_proj", "x_proj", "dt_w", "ws1",
        "ws3", "Wr", "Wk", "Wv", "Wg", "Wck", "Wcr", "maa_w1", "decay_w1"}
_ROW = {"w2", "out_proj", "ws2", "Wo", "Wcv", "decay_w2"}


def param_rules(cfg: ModelConfig, env: ShardingEnv):
    """rules(path, shape) -> per-dim axis wish list (divisibility-pruned
    later by ShardingEnv.spec)."""
    fsdp, tp = env.fsdp_axis, env.tp_axis

    def rules(path: str, shape):
        name = path.split("/")[-1]
        rank = len(shape)
        if name == "embed":
            base = [tp, None]
        elif name == "unembed":
            base = [None, tp]
        elif name in ("conv_w", "A_log"):
            base = [tp, None]
        elif name in ("conv_b", "D", "dt_b"):
            base = [tp]
        elif name == "faaaa":
            base = [tp, None]
        elif name == "router":
            base = [fsdp, None]
        elif name in ("wq", "wuq", "wukv"):
            # (d|r, H, dh): shard heads over tp if divisible, else head_dim
            if env.heads_shardable(cfg.n_heads):
                base = [fsdp, tp, None]
            else:
                base = [fsdp, None, tp]
        elif name in ("wk", "wv"):
            base = [fsdp, None, None]          # kv heads replicated over tp
        elif name == "wo":
            if env.heads_shardable(cfg.n_heads):
                base = [tp, None, fsdp]
            else:
                base = [None, tp, fsdp]
        elif name in _COL:
            base = [fsdp, tp]
        elif name in _ROW:
            base = [tp, fsdp]
        else:
            base = [None] * min(rank, 2)
        if name in ("w1", "w3", "w2") and rank - _n_stack(path) == 3:
            # MoE expert weights
            ep = env.moe_ep(cfg.n_experts)
            if name == "w2":
                base = [tp, None, fsdp] if ep else [None, tp, fsdp]
            else:
                base = [tp, fsdp, None] if ep else [None, fsdp, tp]
        pad = rank - len(base)
        return [None] * pad + base

    return rules


def _n_stack(path: str) -> int:
    n = 0
    if path.startswith("layers/") or "/layers/" in path:
        n = 1
    if "superblocks" in path:
        parts = path.split("/")
        n = 1 + (1 if parts[-2] in ("mamba", "moe", "ffn") else 0)
    return n


def param_shardings(cfg: ModelConfig, env: ShardingEnv):
    """The params' tree of ``NamedSharding`` (None without a mesh)."""
    return param_pspecs(abstract_params(cfg), env, param_rules(cfg, env))


# ===========================================================================
# embedding / logits
# ===========================================================================
def embed_tokens(params, tokens, cfg, env=None):
    """The token embeddings.  On a mesh: each rank looks its rows' ids up
    in its vocab slice of ``embed`` (zero outside it) and the slices are
    summed over 'model', exactly (one addend is non-zero): (B, S, d) laid
    out as (batch axes, None, None)."""
    if not L.on_mesh(env):
        return params["embed"][tokens]
    bt = env.batch_axes
    ids = (L._local(tokens, env, bt, None) if _is_dtensor(tokens)
           else L.shard_of(tokens, env, [bt, None]))
    emb = params["embed"]
    w = L._local(emb, env, "model", None)
    v0 = axis_index(env, env.spec(emb.shape, ["model", None])[0]) * w.shape[0]
    rel = ids.long() - v0
    hit = (rel >= 0) & (rel < w.shape[0])
    x = torch.where(hit[..., None], w[rel.clamp(0, w.shape[0] - 1)], 0)
    shape = (*tokens.shape, emb.shape[1])
    vocab = env.spec(emb.shape, ["model", None])[0]
    return env.cs(L._global(x, env, shape, [bt, None, None],
                            partial=vocab), bt, None, None)


def unembed(params, x, cfg, env=None):
    """f32 logits: the operands are upcast before the product, as the
    reference's ``preferred_element_type=F32`` accumulates in f32.  On a
    mesh: each rank's rows times its vocab columns, laid out as
    ``logits_wants``."""
    if not L.on_mesh(env):
        w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
        return torch.einsum("bsd,dv->bsv", x.float(), w.float())
    bt = env.batch_axes
    xl = L._local(x, env, bt, None, None).float()
    if cfg.tie_embeddings:
        out = torch.einsum("bsd,vd->bsv", xl, L._local(
            params["embed"], env, "model", None).float())
    else:
        out = torch.einsum("bsd,dv->bsv", xl, L._local(
            params["unembed"], env, None, "model").float())
    return L._global(out, env, (*x.shape[:2], cfg.vocab),
                     logits_wants(env, bt))


def logits_wants(env, batch):
    """The logits' layout on a mesh, the reference dry run's out sharding:
    (batch, None, "model"), ``batch`` the batch axes (None under
    ``serve_fullshard`` decode)."""
    return [batch, None, "model"]


def _xent_chunk(x, labels, w):
    """One chunk's (sum of logsumexp - logit[label] over labels >= 0,
    their count), both f32."""
    logits = torch.einsum("bsd,dv->bsv", x.float(), w.float())
    lse = torch.logsumexp(logits, dim=-1)
    safe = labels.clamp_min(0).long()
    lab = logits.gather(-1, safe[..., None])[..., 0]
    valid = (labels >= 0).float()
    return ((lse - lab) * valid).sum(), valid.sum()


def chunked_xent(params, x, labels, cfg, loss_chunk: int = 512, env=None):
    """Chunked softmax cross-entropy, labels -100 masked: the twin of the
    reference's ``chunked_xent`` (``repro/models/lm.py:311``).  Each chunk
    of ``loss_chunk`` positions runs under ``torch.utils.checkpoint``, so
    its f32 (B, c, V) logits never live whole in the backward; the sums
    are carried chunk by chunk, then divided by max(count, 1).  On a mesh
    (``_xent_sharded``) x is the normed stream as a DTensor and
    ``labels`` (B, S) a tensor every rank holds whole (or a DTensor)."""
    if L.on_mesh(env):
        return _xent_sharded(params, x, labels, cfg, loss_chunk, env)
    S = x.shape[1]
    c = L._pick_block(S, loss_chunk)
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    tot = cnt = torch.zeros((), dtype=F32, device=x.device)
    for i in range(S // c):
        part, n = checkpoint(_xent_chunk, x[:, i * c:(i + 1) * c],
                             labels[:, i * c:(i + 1) * c], w,
                             use_reentrant=False)
        tot, cnt = tot + part, cnt + n
    return tot / torch.clamp(cnt, min=1.0)


def _xent_parts(x, labels, w, v0: int):
    """One chunk's rank-local parts over the vocab rows [v0, v0 + V') that
    ``w`` (d, V') holds: each position's f32 log-sum-exp over them, its
    label's logit where the label falls among them (else 0), and the
    valid mask (labels >= 0) as f32."""
    logits = torch.einsum("bsd,dv->bsv", x.float(), w.float())
    rel = labels.long() - v0
    hit = (rel >= 0) & (rel < w.shape[1])
    lab = logits.gather(-1, rel.clamp(0, w.shape[1] - 1)[..., None])[..., 0]
    return (torch.logsumexp(logits, dim=-1), torch.where(hit, lab, 0.0),
            (labels >= 0).float())


def _xent_sharded(params, x, labels, cfg, loss_chunk, env):
    """``chunked_xent`` on a mesh.  Where the vocabulary splits over
    'model' (the tied ``embed`` [tp, None], an untied ``unembed`` [None,
    tp], pruned where tp does not divide it), each rank takes its rows
    with the whole sequence and its vocab slice: per chunk, its log-sum-
    exps are combined over 'model' (the largest, detached, then a psum of
    the exponentials) and the label's logit comes from the rank that
    holds it (a psum of the others' zeros).  Otherwise each rank takes
    its positions as the stream lays them out, over the whole vocabulary.
    The stream is taken in f32 (so the ranks' partial cotangents of it
    meet unrounded, ``_even``), and each chunk's logits run under
    ``torch.utils.checkpoint``, with no collective inside.  The sums and
    the count are then summed over every mesh axis that splits the
    positions: every rank holds the same f32 loss, under autograd."""
    bt = env.batch_axes
    tied = cfg.tie_embeddings
    w = params["embed"] if tied else params["unembed"]
    split = ["model", None] if tied else [None, "model"]
    vocab = env.spec(w.shape, split)[0 if tied else 1]
    x = L.rowwise(lambda t: t.float(), x)
    if vocab is not None:
        rows = env.spec(x.shape, [bt, None, None])
        xl = _even(env.cs(x, *rows)).to_local()
        wl = L._local(w, env, *split)
        wl = wl.T if tied else wl
        v0 = axis_index(env, vocab) * wl.shape[1]
    else:
        rows = L.sharding_spec(x, env)
        xl = _even(x).to_local()
        wl = L._whole_tensor(w)
        wl, v0 = (wl.T if tied else wl), 0
    lab = (L._local(labels, env, *rows[:2]) if _is_dtensor(labels)
           else L.shard_of(labels, env, list(rows[:2])))
    c = L._pick_block(xl.shape[1], loss_chunk)
    tot = cnt = torch.zeros((), dtype=F32, device=xl.device)
    for i in range(xl.shape[1] // c):
        lse, hit, valid = checkpoint(_xent_parts, xl[:, i * c:(i + 1) * c],
                                     lab[:, i * c:(i + 1) * c], wl, v0,
                                     use_reentrant=False)
        if vocab is not None:
            top = SH.pmax(lse, env, "model")
            lse = top + torch.log(SH.psum(torch.exp(lse - top), env,
                                          "model"))
            hit = SH.psum(hit, env, "model")
        tot = tot + ((lse - hit) * valid).sum()
        cnt = cnt + valid.sum()
    return _xent_mean(tot, cnt, env,
                      [a for e in rows[:2] for a in SH._axes(e)])


def _xent_mean(tot, cnt, env, axes):
    """The mean loss from the ranks' sums and counts over the positions
    they hold: both summed over the mesh ``axes`` that split the
    positions, then divided (ranks hold different counts of valid
    labels, so per-rank means would weigh their positions unequally)."""
    for axis in axes:
        tot, cnt = SH.psum(tot, env, axis), SH.psum(cnt, env, axis)
    return tot / torch.clamp(cnt, min=1.0)


# the keys of the reference's ``env.opts`` that its training path reads on
# one device ("sp" and "moe_impl" change nothing without a mesh)
TRAIN_OPTS = {"attn_block": 512, "attn_mode": "full", "loss_chunk": 512,
              "remat": False, "remat_policy": None}
REMAT_POLICIES = (None, "full", "dots")


def train_opts(opts=None) -> Dict[str, Any]:
    out = dict(TRAIN_OPTS)
    unknown = set(opts or {}) - set(out)
    if unknown:
        raise ValueError(f"forward_train takes the options {sorted(out)}, "
                         f"not {sorted(unknown)}")
    out.update(opts or {})
    if out["remat_policy"] not in REMAT_POLICIES:
        raise ValueError(f"remat_policy {out['remat_policy']!r}: takes "
                         f"{REMAT_POLICIES} (None and 'full' whole-layer "
                         f"remat, 'dots' the matmuls' outputs saved)")
    if out["attn_mode"] not in L.ATTN_MODES:
        raise ValueError(f"attn_mode {out['attn_mode']!r}: takes "
                         f"{L.ATTN_MODES}")
    return out


def mesh_train_opts(env) -> Dict[str, Any]:
    """``TRAIN_OPTS``' keys as ``env.opts`` sets them: on a mesh the
    training options come from the env, as the reference's do (its other
    keys, ``sp``, ``fsdp``, ``moe_impl``, ``rs_matmul``, are read where
    the layers run)."""
    return train_opts({k: env.opts[k] for k in TRAIN_OPTS if k in env.opts})


# the ops whose outputs ``remat_policy="dots"`` saves: the matmuls, the
# aten forms of the reference's ``dot_general`` (einsum and matmul lower
# to them)
DOT_OPS = frozenset((torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                     torch.ops.aten.addmm.default,
                     torch.ops.aten.baddbmm.default))


def _save_dots(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in DOT_OPS \
        else CheckpointPolicy.PREFER_RECOMPUTE


def _dots_context():
    return create_selective_checkpoint_contexts(_save_dots)


def _maybe_remat(fn, opts):
    """``fn`` under ``torch.utils.checkpoint`` where ``opts["remat"]``,
    the reference's ``_maybe_remat``: the whole layer recomputed in the
    backward, or under ``remat_policy="dots"`` all but the matmuls, whose
    outputs are kept (the twin of ``jax.checkpoint_policies.
    checkpoint_dots``)."""
    if not (opts and opts["remat"]):
        return fn
    kw = {"context_fn": _dots_context} if opts["remat_policy"] == "dots" \
        else {}
    return lambda *a, **k: checkpoint(fn, *a, use_reentrant=False, **kw,
                                      **k)


def _attn_kw(opts):
    """The attention functions' training keywords (none for inference)."""
    return {} if opts is None else {"train": True,
                                    "attn_block": opts["attn_block"],
                                    "attn_mode": opts["attn_mode"]}


# ===========================================================================
# layer stacks
# ===========================================================================
def _mlp(h, p, cfg, env=None):
    """The uniform stack's FFN: the dense-impl MoE where the layer has a
    router, as the reference engine runs it.  The dense impl has no
    capacity, so each token's output depends on that token alone: the
    engine's prefill padding goes through the router too and cannot move
    a real token's output (the reference relies on the same fact).  On a
    mesh the MoE impl is ``env.opts["moe_impl"]`` ("ep" by default), as in
    the reference."""
    if "router" in p:
        if L.on_mesh(env):
            return L.moe_block(h, p, cfg, env.opts.get("moe_impl", "ep"),
                               env)
        return L.moe_block(h, p, cfg)
    return L.ffn_swiglu(h, p, env)


def _norm(x, w, cfg):
    """The rms norm of the stream on a mesh (a DTensor), its cotangent's
    shares evened over the axes the stream is replicated over
    (``_even``)."""
    return _even(L.rowwise(L.rms_norm, x, w, cfg.norm_eps))


def _even(h):
    """The DTensor h as is; under autograd its cotangent's shares evened
    over the mesh axes it is replicated over (``sharding.even``: 'model'
    for the stream without ``sp``), so the ranks' partial sums meet
    where h is used, as one device sums them."""
    if not (torch.is_grad_enabled() and h.requires_grad):
        return h
    axes = [a for a, pl in zip(h.device_mesh.mesh_dim_names, h.placements)
            if pl.is_replicate()]
    env = ShardingEnv(h.device_mesh)
    return L._global(SH.even(h.to_local(), env, axes), env, h.shape,
                     list(L.sharding_spec(h, env)))


def _res_cs(x, env, sp: bool):
    """The residual stream's layout at the reference's ``_res_cs`` points:
    batch over the batch axes, the sequence over 'model' under ``sp``
    (``pin_bf16`` is the identity here)."""
    return env.cs(L.pin_bf16(x), env.batch_axes, "model" if sp else None,
                  None)


def _sum_cs(y, x, env, sp: bool):
    """A sublayer's output at its ``_res_cs`` point: the ranks' pending
    (f32) sum taken, then rounded to the stream's type, as one device
    rounds the whole contraction once."""
    return L.rowwise(lambda t: t.to(x.dtype), _res_cs(y, env, sp))


def _add(x, y, env, sp: bool):
    """The stream x plus a sublayer's output y on a mesh: y's pending sum
    taken and rounded (``_sum_cs``), added, the stream at its ``_res_cs``
    point."""
    return _res_cs(L.dt_add(x, _sum_cs(y, x, env, sp)), env, sp)


def _decode_block_sharded(x, lp, cfg, env, attend):
    """One decode layer of the uniform stack on a mesh: ``attend(h)`` is
    the attention's output (its cache updated in place); the stream is
    laid out with its batch over the batch axes at each point."""
    x = _add(x, attend(_norm(x, lp["ln1"], cfg)), env, False)
    return _add(x, _mlp(_norm(x, lp["ln2"], cfg), lp["mlp"], cfg, env), env,
                False)


def _pad_seq_local(x, max_len, env, wants):
    """A (B, S, ...) DTensor whose sequence is whole on every rank, padded
    with zeros to ``max_len`` and laid out as spec(``wants``)."""
    xl = _pad_seq(x.to_local(), max_len, 1)
    spec = L.sharding_spec(x, env)
    return env.cs(L._global(xl, env, (x.shape[0], max_len, *x.shape[2:]),
                            list(spec)), *wants)


def _uniform_block(x, lp, cfg, positions, opts=None):
    """Returns (x, the layer's cache entries): (k, v), or MLA's (ckv,
    k_rope).  ``opts``: ``train_opts`` for the training route, None for
    inference."""
    h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
    attn = L.mla_attention_full if cfg.use_mla else L.gqa_attention_full
    y, c1, c2 = attn(h, lp["attn"], cfg, positions, **_attn_kw(opts))
    x = L.pin_bf16(x + L.pin_bf16(y))
    h = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
    y = _mlp(h, lp["mlp"], cfg)
    return L.pin_bf16(x + L.pin_bf16(y)), (c1, c2)


def _uniform_block_sharded(x, lp, cfg, positions, env, max_len, opts=None):
    """``_uniform_block`` on a mesh, at the reference's constraint points;
    the cache entries padded to ``max_len`` and laid out with their
    sequence over 'model' (with ``opts``, the training route: none)."""
    sp = env.opts.get("sp", True)
    h = _norm(x, lp["ln1"], cfg)
    attn = L.mla_attention_full if cfg.use_mla else L.gqa_attention_full
    y, c1, c2 = attn(h, lp["attn"], cfg, positions, env=env,
                     **_attn_kw(opts))
    # constrain the contraction OUTPUT (the pending sum lands as a
    # reduce-scatter into the sequence-parallel layout), then the sum
    x = _add(x, y, env, sp)
    x = _add(x, _mlp(_norm(x, lp["ln2"], cfg), lp["mlp"], cfg, env), env, sp)
    if opts is not None:
        return x, (None, None)
    bt = env.batch_axes
    return x, tuple(_pad_seq_local(c, max_len or c.shape[1], env,
                                   [bt, "model"] + [None] * (c.dim() - 2))
                    for c in (c1, c2))


def _run_uniform(params, x, cfg, positions, opts=None, env=None,
                 max_len=None):
    """Returns (x, the stacked cache entries), or (x, None) in training."""
    block = _maybe_remat(_uniform_block, opts)
    sharded = _maybe_remat(_uniform_block_sharded, opts)
    c1s, c2s = [], []
    for lp in _layers(params["layers"]):
        if L.on_mesh(env):
            x, (c1, c2) = sharded(x, lp, cfg, positions, env, max_len, opts)
        else:
            x, (c1, c2) = block(x, lp, cfg, positions, opts)
        c1s.append(c1)
        c2s.append(c2)
    if opts is not None:
        return x, None
    return x, (_stack(c1s), _stack(c2s))


def _uniform_decode_block(x, lp, c1, c2, cfg, pos, env=None):
    """Twin of ``_uniform_block`` for one token over a contiguous per-layer
    cache, (B, max_len, K, dh) k and v or MLA's latent (B, max_len, r) and
    rope keys, updated in place, with the same residual-stream rounding
    points.  On a mesh the stream is laid out with its batch over the
    batch axes at each of them."""
    attn = L.mla_attention_decode if cfg.use_mla else L.gqa_attention_decode
    if L.on_mesh(env):
        return _decode_block_sharded(x, lp, cfg, env, lambda h: attn(
            h, lp["attn"], cfg, c1, c2, pos, env=env)[0])
    h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
    y, c1, c2 = attn(h, lp["attn"], cfg, c1, c2, pos)
    x = L.pin_bf16(x + L.pin_bf16(y))
    h = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
    y = _mlp(h, lp["mlp"], cfg)
    return L.pin_bf16(x + L.pin_bf16(y))


def _uniform_decode_block_paged(x, lp, kp, vp, tables, pos, block_ids,
                                offsets, cfg, env=None):
    """Twin of ``_uniform_block`` for one token over pool blocks, with
    the same residual-stream rounding points (on a mesh, those of
    ``_uniform_decode_block``)."""
    if L.on_mesh(env):
        return _decode_block_sharded(
            x, lp, cfg, env, lambda h: L.gqa_attention_decode_paged(
                h, lp["attn"], cfg, kp, vp, tables, pos, block_ids, offsets,
                env)[0]), kp, vp
    h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
    y, kp, vp = L.gqa_attention_decode_paged(h, lp["attn"], cfg, kp, vp,
                                             tables, pos, block_ids, offsets)
    x = L.pin_bf16(x + L.pin_bf16(y))
    h = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
    y = _mlp(h, lp["mlp"], cfg)
    return L.pin_bf16(x + L.pin_bf16(y)), kp, vp


# --- jamba superblocks -----------------------------------------------------
def _jamba_superblock(x, sb, cfg, positions, *, states=None, collect=False,
                      pos=None, opts=None):
    """One superblock (attn_period slots).  states: this superblock's
    decode states (``k``, ``v`` caches updated in place, ``conv``,
    ``ssm``) or None; ``opts``: ``train_opts`` for the training route.
    Returns (x, (k, v) or None, {conv, ssm} or None).

    The reference's quirks are mirrored: the attention sits at slot
    ``per // 2`` and ``layer_is_moe`` is asked with the slot, not the
    global layer index."""
    per = cfg.attn_period
    eps = cfg.norm_eps
    mi = ji = fi = 0
    conv, ssm = [], []
    kv_out = None
    mamba, moe, ffn = (_layers(sb[k]) for k in ("mamba", "moe", "ffn"))
    mamba_ln, moe_ln, ffn_ln = (sb[k].unbind(0)
                                for k in ("mamba_ln", "moe_ln", "ffn_ln"))
    for slot in range(per):
        if slot == per // 2:
            h = L.rms_norm(x, sb["attn_ln"], eps)
            if states is None:
                y, k, v = L.gqa_attention_full(h, sb["attn"], cfg, positions,
                                               **_attn_kw(opts))
                if collect:
                    kv_out = (k, v)
            else:
                y, kc, vc = L.gqa_attention_decode(
                    h, sb["attn"], cfg, states["k"], states["v"], pos)
                kv_out = (kc, vc)
        else:
            lp = mamba[mi]
            h = L.rms_norm(x, mamba_ln[mi], eps)
            if states is None and not collect:
                y = M.mamba_layer(h, lp, cfg, train=opts is not None)
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
            h = L.rms_norm(x, moe_ln[ji], eps)
            y = L.moe_block(h, moe[ji], cfg)
            ji += 1
        else:
            h = L.rms_norm(x, ffn_ln[fi], eps)
            y = L.ffn_swiglu(h, ffn[fi])
            fi += 1
        x = L.pin_bf16(x + y)
    new_states = ({"conv": torch.stack(conv), "ssm": torch.stack(ssm)}
                  if conv else None)
    return x, kv_out, new_states


def _jamba_superblock_sharded(x, sb, cfg, positions, env, *, states=None,
                              pos=None, max_len=None, opts=None):
    """``_jamba_superblock`` on a mesh, the stream at the reference's
    ``_res_cs`` point after every slot (its sequence over 'model' under
    ``sp`` in a prefill, never in a decode).  A prefill returns its k, v
    padded to ``max_len`` and laid out with their sequence over 'model';
    the mamba slots' states come back laid out as ``cache_pspecs`` puts
    them (channels over 'model').  With ``opts`` (the training route) it
    returns (x, None, None)."""
    per = cfg.attn_period
    sp = env.opts.get("sp", True) and states is None
    train = opts is not None
    mi = ji = fi = 0
    conv, ssm = [], []
    kv_out = None
    mamba, moe, ffn, mamba_ln, moe_ln, ffn_ln = (
        _layers(sb[k]) for k in ("mamba", "moe", "ffn", "mamba_ln",
                                 "moe_ln", "ffn_ln"))
    for slot in range(per):
        if slot == per // 2:
            h = _norm(x, sb["attn_ln"], cfg)
            if train:
                y, _, _ = L.gqa_attention_full(h, sb["attn"], cfg, positions,
                                               env=env, **_attn_kw(opts))
            elif states is None:
                y, k, v = L.gqa_attention_full(h, sb["attn"], cfg,
                                               positions, env=env)
                kv_out = tuple(_pad_seq_local(
                    c, max_len or c.shape[1], env,
                    [env.batch_axes, "model", None, None]) for c in (k, v))
            else:
                y, kc, vc = L.gqa_attention_decode(
                    h, sb["attn"], cfg, states["k"], states["v"], pos,
                    env=env)
                kv_out = (kc, vc)
        elif train:
            y = M.mamba_layer(_norm(x, mamba_ln[mi], cfg), mamba[mi], cfg,
                              env, train=True)
            mi += 1
        else:
            h = _norm(x, mamba_ln[mi], cfg)
            y, conv_s, ssm_s = M.mamba_layer(
                h, mamba[mi], cfg, env, return_state=True,
                conv_state=None if states is None
                else _select(states["conv"], mi),
                ssm_state=None if states is None
                else _select(states["ssm"], mi))
            conv.append(conv_s)
            ssm.append(ssm_s)
            mi += 1
        x = _add(x, y, env, sp)
        if cfg.layer_is_moe(slot):
            h, lp = _norm(x, moe_ln[ji], cfg), moe[ji]
            ji += 1
        else:
            h, lp = _norm(x, ffn_ln[fi], cfg), ffn[fi]
            fi += 1
        x = _add(x, _mlp(h, lp, cfg, env), env, sp)
    if train:
        return x, None, None
    return x, kv_out, {"conv": _stack(conv), "ssm": _stack(ssm)}


def _run_jamba(params, x, cfg, positions, *, collect=False, opts=None,
               env=None, max_len=None):
    """Returns (x, None) or, with ``collect``, (x, ((k, v), {conv, ssm}))
    stacked over superblocks."""
    block = _maybe_remat(_jamba_superblock, opts)
    sharded = _maybe_remat(_jamba_superblock_sharded, opts)
    ks, vs, convs, ssms = [], [], [], []
    for sb in _layers(params["superblocks"]):
        if L.on_mesh(env):
            x, kv, st = sharded(x, sb, cfg, positions, env, max_len=max_len,
                                opts=opts)
        else:
            x, kv, st = block(x, sb, cfg, positions, collect=collect,
                              opts=opts)
        if collect:
            ks.append(kv[0])
            vs.append(kv[1])
            convs.append(st["conv"])
            ssms.append(st["ssm"])
    if not collect:
        return x, None
    return x, ((_stack(ks), _stack(vs)),
               {"conv": _stack(convs), "ssm": _stack(ssms)})


# --- rwkv ------------------------------------------------------------------
def _rwkv_block(x, lp, cfg, *, collect=False, opts=None):
    h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
    if collect:
        y, s_tm, wkv = R.rwkv6_time_mix(h, lp["tm"], cfg, return_state=True)
    else:
        y = R.rwkv6_time_mix(h, lp["tm"], cfg, train=opts is not None)
    x = x + y
    h = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
    if collect:
        y, s_cm = R.rwkv6_channel_mix(h, lp["cm"], cfg, return_state=True)
    else:
        y = R.rwkv6_channel_mix(h, lp["cm"], cfg)
    x = L.pin_bf16(x + y)
    return x, ((wkv, s_tm, s_cm) if collect else None)


def _rwkv_block_sharded(x, lp, cfg, env, sp, st=None, train=False):
    """``_rwkv_block`` (``st`` None) or ``_rwkv_decode_block`` (``st`` the
    layer's (wkv, shift_tm, shift_cm)) on a mesh: each mix's output added
    to the stream (``_add``).  Returns (x, (wkv, shift_tm, shift_cm)) laid
    out as ``cache_pspecs`` puts them; with ``train``, the training route,
    (x, None)."""
    if train:
        y = R.rwkv6_time_mix(_norm(x, lp["ln1"], cfg), lp["tm"], cfg, env,
                             train=True)
        x = _add(x, y, env, sp)
        y = R.rwkv6_channel_mix(_norm(x, lp["ln2"], cfg), lp["cm"], cfg, env)
        return _add(x, y, env, sp), None
    wkv, s_tm, s_cm = st or (None, None, None)
    y, s_tm2, wkv2 = R.rwkv6_time_mix(_norm(x, lp["ln1"], cfg), lp["tm"],
                                      cfg, env, shift_state=s_tm,
                                      wkv_state=wkv, return_state=True)
    x = _add(x, y, env, sp)
    y, s_cm2 = R.rwkv6_channel_mix(_norm(x, lp["ln2"], cfg), lp["cm"], cfg,
                                   env, shift_state=s_cm, return_state=True)
    return _add(x, y, env, sp), (wkv2, s_tm2, s_cm2)


def _run_rwkv(params, x, cfg, *, collect=False, opts=None, env=None):
    """Returns (x, None) or, with ``collect``, (x, (wkv, shift_tm,
    shift_cm)) stacked over layers."""
    block = _maybe_remat(_rwkv_block, opts)
    sharded = _maybe_remat(_rwkv_block_sharded, opts)
    sts = []
    for lp in _layers(params["layers"]):
        if L.on_mesh(env):
            x, st = sharded(x, lp, cfg, env, env.opts.get("sp", True),
                            None, opts is not None)
        else:
            x, st = block(x, lp, cfg, collect=collect, opts=opts)
        sts.append(st)
    if not collect:
        return x, None
    return x, tuple(_stack(z) for z in zip(*sts))


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
    """Returns (x, labels, positions), positions counted from 0; labels
    are ``batch["labels"]`` (None where absent).  A vlm batch's
    ``patches`` (B, P, d_model) come first, in bf16, their labels -100; a
    vlm batch without them raises ``KeyError``, as the reference's does
    (text-only serving passes an empty stream)."""
    x = embed_tokens(params, batch["tokens"], cfg)
    labels = batch.get("labels")
    if cfg.family == "vlm":
        patches = batch["patches"]
        x = torch.cat([patches.to(BF16), x], dim=1)
        if labels is not None:
            labels = torch.cat([torch.full(patches.shape[:2], -100,
                                           dtype=labels.dtype,
                                           device=labels.device), labels],
                               dim=1)
    positions = torch.arange(x.shape[1], dtype=torch.int32,
                             device=x.device)[None, :]
    return x, labels, positions


def _assemble_sharded(params, batch, cfg, env):
    """``_assemble_inputs`` on a mesh: x (B, P + S, d) laid out as the
    residual stream, and positions (1, P + S) whole on every rank.  The
    inputs are tensors every rank holds whole, or DTensors."""
    bt = env.batch_axes
    x = embed_tokens(params, batch["tokens"], cfg, env)
    if cfg.family == "vlm":
        patches = batch["patches"]
        patches = (L._local(patches, env, bt, None, None)
                   if _is_dtensor(patches)
                   else L.shard_of(patches, env, [bt, None, None])).to(BF16)
        x = L._global(torch.cat([patches, x.to_local()], dim=1), env,
                      (x.shape[0], patches.shape[1] + x.shape[1],
                       x.shape[2]), [bt, None, None])
    positions = torch.arange(x.shape[1], dtype=torch.int32,
                             device=x.device)[None, :]
    return _res_cs(x, env, env.opts.get("sp", True)), positions


def _final(params, x, cfg, env=None):
    if L.on_mesh(env):
        return unembed(params, _norm(x, params["final_norm"], cfg), cfg, env)
    return unembed(params, L.rms_norm(x, params["final_norm"], cfg.norm_eps),
                   cfg)


def _last(x, env):
    """The last position of a (B, S, d) stream: (B, 1, d)."""
    if not L.on_mesh(env):
        return x[:, -1:, :]
    bt = env.batch_axes
    xl = L._local(x, env, bt, None, None)[:, -1:, :]
    return L._global(xl, env, (x.shape[0], 1, x.shape[2]), [bt, None, None])


def forward_train(params, batch, cfg: ModelConfig, env=None, *,
                  opts=None):
    """The training loss: the mean cross-entropy of ``batch["labels"]``
    (B, S) over the causal forward, a scalar f32 tensor under autograd
    (enc-dec: ``frames``, ``tgt_tokens``, ``tgt_labels``).  The twin of the
    reference's ``forward_train`` (``repro/models/lm.py:595``).  On one
    device ``opts`` takes ``TRAIN_OPTS``' keys (``attn_block``,
    ``attn_mode``, ``loss_chunk``, ``remat``, ``remat_policy``).  On a mesh
    (``_train_sharded``) the options come from ``env.opts``, as the
    reference's do, and ``opts`` must be None.  No kernel is launched: the
    kernels have no backward."""
    check_family(cfg)
    if L.on_mesh(env):
        if opts is not None:
            raise ValueError("forward_train on a mesh takes its options "
                             "from env.opts, not opts=")
        return _train_sharded(params, batch, cfg, env)
    opts = train_opts(opts)
    if cfg.enc_dec:
        from repro_torch.models import encdec
        return encdec.forward_train(params, batch, cfg, opts=opts)
    x, labels, positions = _assemble_inputs(params, batch, cfg)
    if cfg.family == "ssm":
        x, _ = _run_rwkv(params, x, cfg, opts=opts)
    elif cfg.family == "hybrid":
        x, _ = _run_jamba(params, x, cfg, positions, opts=opts)
    else:
        x, _ = _run_uniform(params, x, cfg, positions, opts)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return chunked_xent(params, x, labels, cfg, opts["loss_chunk"])


def _train_sharded(params, batch, cfg, env):
    """``forward_train`` on a mesh: params DTensors laid out by
    ``param_shardings`` (each leaf through ``sharding.copies``, so its
    gradient is summed over the axes it is replicated over), the batch
    tensors every rank holds whole (or DTensors), the layers on each
    rank's shards at the reference's constraint points (``env.opts``:
    ``sp``, ``fsdp``, ``moe_impl``, ``rs_matmul``, ``remat``,
    ``attn_block``, ``attn_mode``, ``loss_chunk``), the loss
    ``chunked_xent`` on the mesh, equal on every rank and seeded with its
    share (``sharding.rank_share``).  The gradients land in the params'
    ``.grad`` as DTensors laid out as the params."""
    opts = mesh_train_opts(env)
    params = SH.copies(params)
    if cfg.enc_dec:
        from repro_torch.models import encdec
        loss = encdec.train_loss_sharded(params, batch, cfg, env, opts)
        return SH.rank_share(loss, env)
    x, positions = _assemble_sharded(params, batch, cfg, env)
    labels = batch["labels"]
    if cfg.family == "vlm":
        if _is_dtensor(labels):
            labels = SH.whole(labels)
        P = batch["patches"].shape[1]
        labels = torch.cat([torch.full((labels.shape[0], P), -100,
                                       dtype=labels.dtype,
                                       device=labels.device), labels], dim=1)
    if cfg.family == "ssm":
        x, _ = _run_rwkv(params, x, cfg, opts=opts, env=env)
    elif cfg.family == "hybrid":
        x, _ = _run_jamba(params, x, cfg, positions, opts=opts, env=env)
    else:
        x, _ = _run_uniform(params, x, cfg, positions, opts, env)
    x = _norm(x, params["final_norm"], cfg)
    return SH.rank_share(chunked_xent(params, x, labels, cfg,
                                      opts["loss_chunk"], env), env)


def forward_logits(params, batch, cfg: ModelConfig, env=None):
    """Full-sequence forward.  batch["tokens"]: (B, S) integer ids, after
    vlm's ``batch["patches"]`` (B, P, d_model).  Returns logits (B, P + S,
    V) f32 (P = 0 outside vlm); on a mesh a DTensor laid out as
    ``logits_wants``."""
    check_family(cfg)
    if L.on_mesh(env):
        if cfg.enc_dec:
            from repro_torch.models import encdec
            return encdec.forward_logits(params, batch, cfg, env)
        x, positions = _assemble_sharded(params, batch, cfg, env)
        if cfg.family == "ssm":
            x, _ = _run_rwkv(params, x, cfg, env=env)
        elif cfg.family == "hybrid":
            x, _ = _run_jamba(params, x, cfg, positions, env=env)
        else:
            x, _ = _run_uniform(params, x, cfg, positions, env=env)
        return _final(params, x, cfg, env)
    if cfg.enc_dec:
        from repro_torch.models import encdec
        return encdec.forward_logits(params, batch, cfg)
    x, _, positions = _assemble_inputs(params, batch, cfg)
    if cfg.family == "ssm":
        x, _ = _run_rwkv(params, x, cfg)
    elif cfg.family == "hybrid":
        x, _ = _run_jamba(params, x, cfg, positions)
    else:
        x, _ = _run_uniform(params, x, cfg, positions)
    return _final(params, x, cfg)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=BF16,
               device="cuda", src_len: Optional[int] = None
               ) -> Dict[str, Any]:
    """Zero decode caches with the reference's keys, shapes and types;
    enc-dec's cross caches hold ``src_len`` frames (``max_len`` where not
    given)."""
    check_family(cfg)
    if cfg.enc_dec:
        from repro_torch.models import encdec
        return encdec.init_cache(cfg, batch, max_len, dtype, device,
                                 src_len=src_len or max_len)

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
    if cfg.use_mla:
        return {"ckv": zeros(n, batch, max_len, cfg.kv_lora_rank),
                "krope": zeros(n, batch, max_len, cfg.qk_rope_head_dim)}
    return {"k": zeros(n, batch, max_len, K, dh),
            "v": zeros(n, batch, max_len, K, dh)}


def abstract_cache(cfg, batch, max_len, dtype=BF16, src_len=None):
    """The cache's tree of shapes and types with nothing allocated (meta
    tensors, outside the caller's dispatch modes: ``_shapes_only``), as
    the reference's ``jax.eval_shape`` of ``init_cache``."""
    with _shapes_only():
        return init_cache(cfg, batch, max_len, dtype, device="meta",
                          src_len=src_len)


def cache_pspecs(cfg: ModelConfig, env: ShardingEnv, batch: int,
                 max_len: int, src_len: Optional[int] = None):
    """Sharding for the serving cache: batch over data axes, seq over
    'model' (flash-decoding layout); rwkv/mamba states shard their inner
    dim over 'model'."""
    ab = abstract_cache(cfg, batch, max_len, src_len=src_len)
    bt = env.batch_axes
    if env.opts.get("serve_fullshard"):
        # decode mode for >100B archs: batch replicated, sequence sharded
        # over (model x data) -> weights stay fully sharded, no gathers
        bt = None
        seq = ("model", "data")
    elif env.opts.get("cache_2d"):
        # serve layout: KV sequence sharded over BOTH axes (batch stays
        # on 'data'); decode reads it back identically
        seq = ("model", "data")
    else:
        seq = "model"

    def spec_of(path, leaf):
        name = path[-1]
        dims = leaf.shape
        if name in ("k", "v", "ckv", "krope", "cross_k", "cross_v"):
            if len(dims) == 4:
                want = [None, bt, seq, None]
            else:
                want = [None, bt, seq, None, None]
            return env.named(dims, want)
        if name == "wkv":
            return env.named(dims, [None, bt, "model", None, None])
        if name in ("shift_tm", "shift_cm"):
            return env.named(dims, [None, bt, None])
        if name == "conv":
            return env.named(dims, [None, None, bt, None, "model"])
        if name == "ssm":
            return env.named(dims, [None, None, bt, "model", None])
        return env.named(dims, [None] * len(dims))

    return tree_map_with_path(spec_of, ab)


def prefill(params, batch, cfg: ModelConfig, env=None,
            max_len: Optional[int] = None):
    """Full-sequence prefill.  batch["tokens"]: (B, S) integer ids, after
    vlm's ``batch["patches"]`` (B, P, d_model); ``max_len`` counts the
    patches too; an enc-dec batch is ``frames`` (B, Ss, d_model) and
    ``tgt_tokens`` (B, St).  Returns (last_logits (B,1,V) f32, cache):
    dense / moe / vlm {"k", "v": (L, B, max_len, K, dh)}, MLA {"ckv",
    "krope"}; ssm {"wkv", "shift_tm", "shift_cm"}; hybrid {"k", "v": (nsb,
    B, max_len, K, dh), "conv", "ssm"}; enc-dec {"k", "v", "cross_k",
    "cross_v"}.

    On a mesh: the last logits laid out as ``logits_wants``, the cache
    leaves as ``cache_pspecs(cfg, env, B, max_len)`` lays them out."""
    check_family(cfg)
    if L.on_mesh(env) and not cfg.enc_dec:
        return _prefill_sharded(params, batch, cfg, env, max_len)
    if cfg.enc_dec:
        from repro_torch.models import encdec
        return encdec.prefill(params, batch, cfg, env, max_len=max_len)
    x, _, positions = _assemble_inputs(params, batch, cfg)
    max_len = max_len or x.shape[1]
    if cfg.family == "ssm":
        x, (wkv, s_tm, s_cm) = _run_rwkv(params, x, cfg, collect=True)
        cache = {"wkv": wkv, "shift_tm": s_tm, "shift_cm": s_cm}
    elif cfg.family == "hybrid":
        x, ((k, v), st) = _run_jamba(params, x, cfg, positions, collect=True)
        cache = {"k": _pad_seq(k, max_len, 2), "v": _pad_seq(v, max_len, 2),
                 "conv": st["conv"], "ssm": st["ssm"]}
    else:
        x, (c1, c2) = _run_uniform(params, x, cfg, positions)
        names = ("ckv", "krope") if cfg.use_mla else ("k", "v")
        cache = {names[0]: _pad_seq(c1, max_len, 2),
                 names[1]: _pad_seq(c2, max_len, 2)}
    return _final(params, x[:, -1:, :], cfg), cache


def _prefill_sharded(params, batch, cfg, env, max_len):
    x, positions = _assemble_sharded(params, batch, cfg, env)
    B, S = x.shape[:2]
    max_len = max_len or S
    if cfg.family == "ssm":
        x, st = _run_rwkv(params, x, cfg, collect=True, env=env)
        cache = dict(zip(_RWKV_STATE, st))
    elif cfg.family == "hybrid":
        x, ((k, v), st) = _run_jamba(params, x, cfg, positions, collect=True,
                                     env=env, max_len=max_len)
        cache = {"k": k, "v": v, **st}
    else:
        x, (c1, c2) = _run_uniform(params, x, cfg, positions, env=env,
                                   max_len=max_len)
        names = ("ckv", "krope") if cfg.use_mla else ("k", "v")
        cache = dict(zip(names, (c1, c2)))
    return (_final(params, _last(x, env), cfg, env),
            laid_out(cache, cache_pspecs(cfg, env, B, max_len), env))


_RWKV_STATE = ("wkv", "shift_tm", "shift_cm")


def laid_out(tree, shardings, env):
    """Each DTensor of ``tree`` laid out by its ``NamedSharding`` in
    ``shardings`` (``env.cs``)."""
    return {k: env.cs(v, *shardings[k].spec) for k, v in tree.items()}


def _copy_local(dst, src):
    """Write the DTensor ``src`` into ``dst`` (a view into a cache), shard
    by shard: the two must be laid out alike."""
    if tuple(dst.placements) != tuple(src.placements):
        raise ValueError(f"a state laid out as {src.placements} written "
                         f"into a cache laid out as {dst.placements}")
    dst.to_local().copy_(src.to_local())


def _pad_seq(x, max_len, axis):
    if x.shape[axis] == max_len:
        return x
    shape = list(x.shape)
    shape[axis] = max_len - x.shape[axis]
    return torch.cat([x, x.new_zeros(shape)], dim=axis)


def decode_step(params, tokens, cache, pos, cfg: ModelConfig, env=None):
    """One decode step.  tokens: (B, 1) ids; pos: an int or (B,) position
    of the new token (after a vlm prefill, counted with its patches);
    cache: ``prefill``'s or ``init_cache``'s, updated in place (the
    reference returns a new one).  Returns (logits (B,1,V) f32, cache).

    A position at or past the k/v (or MLA latent) cache's ``max_len``
    raises (on the card, as a device-side assert: no host sync).  The
    reference's ``dynamic_update_slice`` clamps it to the last slot and
    attends over every slot; the port's append would drop it.  The serving runtime
    never gets there: a program's context is capped at ``max_len``
    (``workflow/program.py``), so the last decoded token sits at
    ``max_len - 1``.

    On a mesh the cache is ``prefill``'s, or laid out by ``cache_pspecs``
    (``sharding.distribute``); its shards are updated in place, and the
    logits are laid out as ``logits_wants`` (batch replicated under
    ``serve_fullshard``)."""
    check_family(cfg)
    if L.on_mesh(env):
        if cfg.enc_dec:
            from repro_torch.models import encdec
            return encdec.decode_step(params, tokens, cache, pos, cfg, env)
        x = embed_tokens(params, tokens, cfg, env)
        pos = decode_positions(pos, x, cache)
        if cfg.family == "ssm":
            for i in range(cfg.n_layers):
                st = tuple(_select(cache[k], i) for k in _RWKV_STATE)
                x, new = _rwkv_block_sharded(x, _layer(params["layers"], i),
                                             cfg, env, False, st)
                for old, n in zip(st, new):
                    _copy_local(old, n)
        elif cfg.family == "hybrid":
            for s in range(cfg.n_layers // cfg.attn_period):
                states = {k: _select(cache[k], s)
                          for k in ("k", "v", "conv", "ssm")}
                x, _, st = _jamba_superblock_sharded(
                    x, _layer(params["superblocks"], s), cfg, None, env,
                    states=states, pos=pos)
                for k in ("conv", "ssm"):
                    _copy_local(states[k], st[k])
        else:
            c1, c2 = ("ckv", "krope") if cfg.use_mla else ("k", "v")
            for i in range(cfg.n_layers):
                x = _uniform_decode_block(
                    x, _layer(params["layers"], i), _select(cache[c1], i),
                    _select(cache[c2], i), cfg, pos, env)
        return _decode_logits(params, x, cfg, env), cache
    if cfg.enc_dec:
        from repro_torch.models import encdec
        return encdec.decode_step(params, tokens, cache, pos, cfg)
    x = embed_tokens(params, tokens, cfg)
    pos = decode_positions(pos, x, cache)
    if cfg.family in ("dense", "moe", "vlm"):
        c1, c2 = ("ckv", "krope") if cfg.use_mla else ("k", "v")
        for i in range(cfg.n_layers):
            x = _uniform_decode_block(x, _layer(params["layers"], i),
                                      cache[c1][i], cache[c2][i], cfg, pos)
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


def _decode_logits(params, x, cfg, env):
    """A decode step's logits on a mesh, laid out as ``logits_wants``
    (batch replicated under ``serve_fullshard``)."""
    bt = None if env.opts.get("serve_fullshard") else env.batch_axes
    return env.cs(_final(params, x, cfg, env), *logits_wants(env, bt))


def decode_positions(pos, x, cache):
    """``decode_step``'s ``pos`` (an int or (B,); on a mesh also a
    DTensor, taken whole, as the reference's step takes it laid out) as
    (B,) int32 on x's device, asserted below the self-attention cache's
    ``max_len`` where the cache has one ("k", or MLA's "ckv")."""
    if _is_dtensor(pos):
        pos = SH.whole(pos)
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device
                          ).broadcast_to((x.shape[0],)).contiguous()
    seq = cache.get("k", cache.get("ckv"))
    if seq is not None:
        torch._assert_async((pos < seq.shape[2]).all(),
                            "decode_step: a position at or past the cache's "
                            "max_len")
    return pos


def decode_step_paged(params, tokens, k_pool, v_pool, tables, pos,
                      block_ids, offsets, cfg: ModelConfig, env=None):
    """One decode step attending over the serving pool's blocks in place.

    tokens: (B, 1) ids; k_pool/v_pool: (L, num_blocks, block, K, dh);
    tables: (B, max_blocks) int32 (rows padded with any in-range id);
    pos: (B,) int32 position of the new token; block_ids/offsets: (B,)
    int32 append destination of its K/V (idle rows pass num_blocks, a
    drop sentinel).  Covers the uniform GQA-cache families (dense, moe,
    vlm) and refuses MLA and enc-dec, as the reference's does.  The pools
    are updated in place, where the reference returns new arrays.  Returns
    (logits (B,1,V) f32, k_pool, v_pool).

    On a mesh the pools are DTensors laid out as
    ``serving.kvcache.pool_sharding`` puts them, the ids and tables tensors every rank holds whole, and the
    logits come back laid out as ``logits_wants``.  The reference gives
    the pool no layout (``jnp.zeros``, placed by GSPMD), so any layout
    computes its function; the port's:

    * over 'data', replicated: a session's slot, and so the data rank of
      its row, changes across park and resume, so each rank computes the
      new K/V of its rows (every kv head: ``wk`` / ``wv`` are replicated
      over 'model'), the rows are gathered over 'data', and every data
      replica appends every row and holds every block;
    * over 'model', by kv heads where ``K % tp == 0`` (the q heads then
      split too): a rank's ``H / tp`` q heads read exactly its ``K / tp``
      kv heads in place, at the kernel's unchanged G;
    * over 'model' otherwise, replicated: a rank gathers its rows' blocks
      and reads the kv heads of its q heads by ``_kv_for_heads``' rule.

    The idle rows' sentinel ``num_blocks`` stays out of range on every
    replica (no layout splits the block axis).

    With no mesh it is ``unembed`` over ``decode_body_paged``."""
    _check_paged(cfg)
    if L.on_mesh(env):
        x = embed_tokens(params, tokens, cfg, env)
        for i in range(cfg.n_layers):
            x, _, _ = _uniform_decode_block_paged(
                x, _layer(params["layers"], i), _select(k_pool, i),
                _select(v_pool, i), tables, pos, block_ids, offsets, cfg,
                env)
        return _decode_logits(params, x, cfg, env), k_pool, v_pool
    x = decode_body_paged(params, tokens, k_pool, v_pool, tables, pos,
                          block_ids, offsets, cfg)
    return unembed(params, x, cfg), k_pool, v_pool


def decode_body_paged(params, tokens, k_pool, v_pool, tables, pos,
                      block_ids, offsets, cfg: ModelConfig):
    """``decode_step_paged`` on one device up to the logits: the
    embedding, every layer (the pools updated in place) and the final
    norm.  Returns the normed stream (B, 1, d); ``unembed`` of it is the
    step's logits.  The engine replays it as a CUDA graph
    (``serving/round_graph.py``)."""
    _check_paged(cfg)
    x = embed_tokens(params, tokens, cfg)
    for i in range(cfg.n_layers):
        x, _, _ = _uniform_decode_block_paged(
            x, _layer(params["layers"], i), k_pool[i], v_pool[i], tables,
            pos, block_ids, offsets, cfg)
    return L.rms_norm(x, params["final_norm"], cfg.norm_eps)


def _check_paged(cfg: ModelConfig) -> None:
    check_family(cfg)
    if cfg.family == "ssm" or cfg.attn_period or cfg.use_mla or cfg.enc_dec:
        raise ValueError("paged decode covers the uniform GQA-cache "
                         "families")
