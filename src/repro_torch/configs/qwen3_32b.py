"""qwen3-32b [dense] — qk_norm, GQA.

64L d_model=5120 64H (GQA kv=8) d_ff=25600 vocab=151936  [hf:Qwen/Qwen3-8B; hf]
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen3-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=25600,
    vocab=151936,
    qk_norm=True,
    rope_theta=1e6,
))


def tiny() -> ModelConfig:
    return ModelConfig(
        name="qwen3-tiny", family="dense", n_layers=3, d_model=64,
        n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab=256,
        qk_norm=True)
