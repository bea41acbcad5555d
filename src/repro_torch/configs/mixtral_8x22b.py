"""mixtral-8x22b [moe] — 8 experts top-2, sliding-window attention.

56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768  [arXiv:2401.04088; hf]
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab=32768,
    n_experts=8,
    top_k=2,
    sliding_window=4096,
    rope_theta=1e6,
))


def tiny() -> ModelConfig:
    return ModelConfig(
        name="mixtral-tiny", family="moe", n_layers=4, d_model=64,
        n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab=256,
        n_experts=4, top_k=2, sliding_window=32)
