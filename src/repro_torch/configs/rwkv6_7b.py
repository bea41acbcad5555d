"""rwkv6-7b [ssm] — Finch, data-dependent decay; attention-free.

32L d_model=4096 (attn-free) d_ff=14336 vocab=65536  [arXiv:2404.05892; hf]
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=0,
    n_kv_heads=0,
    d_ff=14336,
    vocab=65536,
    rwkv_head_size=64,
))


def tiny() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-tiny", family="ssm", n_layers=3, d_model=64,
        n_heads=0, n_kv_heads=0, d_ff=128, vocab=256, rwkv_head_size=16)
