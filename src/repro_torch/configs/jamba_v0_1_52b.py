"""jamba-v0.1-52b [hybrid] — Mamba+attention 1:7 interleave, MoE 16e top-2.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536  [arXiv:2403.19887; hf]
Attention every 8th layer (1 attn : 7 mamba); MoE every other layer.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=65536,
    n_experts=16,
    top_k=2,
    moe_layer_period=2,
    attn_period=8,
    mamba_d_state=16,
    mamba_d_conv=4,
    mamba_expand=2,
    rope_theta=1e4,
))


def tiny() -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    return ModelConfig(
        name="jamba-tiny", family="hybrid", n_layers=8, d_model=64,
        n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab=256,
        n_experts=4, top_k=2, moe_layer_period=2, attn_period=4,
        mamba_d_state=8, mamba_d_conv=4, mamba_expand=2)
