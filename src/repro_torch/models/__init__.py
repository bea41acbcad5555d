"""PyTorch model code: the uniform GQA decoder (dense, moe, vlm), rwkv6
(ssm), jamba (hybrid) and the encoder-decoder, with the reference's
sharding specs on DTensor meshes."""
from repro_torch.models.lm import (abstract_cache, abstract_params,
                                   cache_pspecs, decode_step,
                                   forward_logits, forward_train,
                                   init_cache, init_params, param_rules,
                                   param_shardings, prefill)
from repro_torch.models.sharding import ShardingEnv

__all__ = [
    "abstract_cache", "abstract_params", "cache_pspecs", "decode_step",
    "forward_logits", "forward_train", "init_cache", "init_params",
    "param_rules", "param_shardings", "prefill", "ShardingEnv",
]
