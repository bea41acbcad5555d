"""Input specs (meta-tensor stand-ins) per (arch x shape) cell: the twin of
``repro.launch.specs``.

Every model input is a meta tensor with the reference's shape and dtype
(``torch.empty(..., device="meta")``, where the reference has a
``jax.ShapeDtypeStruct``), with its ``NamedSharding`` on the env's mesh:
nothing is allocated.

Shape set (assigned):
  train_4k     seq=4096   global_batch=256   (training -> train_step)
  prefill_32k  seq=32768  global_batch=32    (inference prefill)
  decode_32k   seq=32768  global_batch=128   (one token, 32k KV cache)
  long_500k    seq=524288 global_batch=1     (long-context decode;
               sub-quadratic archs only: jamba / rwkv6 / mixtral-SWA)
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm
from repro_torch.models.sharding import ShardingEnv, tree_map_with_path

SHAPES = {
    "train_4k": dict(seq=4096, batch=256, kind="train"),
    "prefill_32k": dict(seq=32768, batch=32, kind="prefill"),
    "decode_32k": dict(seq=32768, batch=128, kind="decode"),
    "long_500k": dict(seq=524288, batch=1, kind="decode"),
}


def SDS(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def subquadratic(cfg: ModelConfig) -> bool:
    return cfg.family in ("hybrid", "ssm") or cfg.sliding_window > 0


def cell_supported(cfg: ModelConfig, shape_name: str) -> Tuple[bool, str]:
    if shape_name == "long_500k" and not subquadratic(cfg):
        return False, ("long_500k needs sub-quadratic attention; "
                       f"{cfg.name} is pure full-attention (skip noted in "
                       "DESIGN.md)")
    return True, ""


def _batch_sds(cfg: ModelConfig, B: int, S: int, *, with_labels: bool):
    """Training/prefill batch meta tensors for every family."""
    d = cfg.d_model
    if cfg.enc_dec:
        out = {"frames": SDS((B, S, d), torch.bfloat16),
               "tgt_tokens": SDS((B, max(S // 4, 8)), torch.int32)}
        if with_labels:
            out["tgt_labels"] = SDS((B, max(S // 4, 8)), torch.int32)
        return out
    if cfg.family == "vlm":
        Pn = min(cfg.n_frontend_tokens, S // 2)
        out = {"patches": SDS((B, Pn, d), torch.bfloat16),
               "tokens": SDS((B, S - Pn), torch.int32)}
        if with_labels:
            out["labels"] = SDS((B, S - Pn), torch.int32)
        return out
    out = {"tokens": SDS((B, S), torch.int32)}
    if with_labels:
        out["labels"] = SDS((B, S), torch.int32)
    return out


def _batch_pspecs(cfg: ModelConfig, batch_sds, env: ShardingEnv):
    bt = env.batch_axes

    def spec(_path, leaf):
        return env.named(leaf.shape, [bt] + [None] * (len(leaf.shape) - 1))

    return tree_map_with_path(spec, batch_sds)


def input_specs(cfg: ModelConfig, shape_name: str, env: ShardingEnv):
    """Returns dict(kind, args=(meta tensors...), in_shardings,
    out_shardings, donate_argnums) for the cell's step function."""
    info = SHAPES[shape_name]
    S, B, kind = info["seq"], info["batch"], info["kind"]
    param_sh = lm.param_shardings(cfg, env)

    if kind == "train":
        from repro_torch.train import optimizer as opt
        ap = lm.abstract_params(cfg)
        aopt = opt.abstract_opt_state(ap)
        opt_sh = opt.opt_pspecs(param_sh)
        batch = _batch_sds(cfg, B, S, with_labels=True)
        batch_sh = _batch_pspecs(cfg, batch, env)
        return dict(kind=kind, args=(ap, aopt, batch),
                    in_shardings=(param_sh, opt_sh, batch_sh),
                    donate_argnums=(0, 1))

    if kind == "prefill":
        ap = lm.abstract_params(cfg)
        batch = _batch_sds(cfg, B, S, with_labels=False)
        batch_sh = _batch_pspecs(cfg, batch, env)
        cache_sh = lm.cache_pspecs(cfg, env, B, S)
        logits_sh = env.named((B, 1, cfg.vocab),
                              [env.batch_axes, None, "model"])
        return dict(kind=kind, args=(ap, batch),
                    in_shardings=(param_sh, batch_sh),
                    out_shardings=(logits_sh, cache_sh),
                    donate_argnums=())

    # decode: one new token with a KV cache of seq_len
    ap = lm.abstract_params(cfg)
    tgt_len = max(S // 4, 8) if cfg.enc_dec else S
    acache = lm.abstract_cache(cfg, B, tgt_len, src_len=S)
    cache_sh = lm.cache_pspecs(cfg, env, B, tgt_len, src_len=S)
    bt = None if env.opts.get("serve_fullshard") else env.batch_axes
    tokens = SDS((B, 1), torch.int32)
    tokens_sh = env.named((B, 1), [bt, None])
    pos = SDS((), torch.int32)
    pos_sh = env.named((), [])
    logits_sh = env.named((B, 1, cfg.vocab), [bt, None, "model"])
    return dict(kind=kind, args=(ap, tokens, acache, pos),
                in_shardings=(param_sh, tokens_sh, cache_sh, pos_sh),
                out_shardings=(logits_sh, cache_sh),
                donate_argnums=(2,))
