"""llama3.2-3b [dense] — small llama3.

28L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=128256
[hf:meta-llama/Llama-3.2-1B; unverified]
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="llama3.2-3b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab=128256,
    rope_theta=5e5,
    tie_embeddings=True,
))


def tiny() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-tiny", family="dense", n_layers=3, d_model=48,
        n_heads=3, n_kv_heads=1, head_dim=16, d_ff=128, vocab=256,
        tie_embeddings=True)
