"""command-r-35b [dense] — GQA, no-bias.

40L d_model=8192 64H (GQA kv=8) d_ff=22528 vocab=256000
[hf:CohereForAI/c4ai-command-r-v01; unverified]
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="command-r-35b",
    family="dense",
    n_layers=40,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=22528,
    vocab=256000,
    rope_theta=8e6,
))


def tiny() -> ModelConfig:
    return ModelConfig(
        name="command-r-tiny", family="dense", n_layers=3, d_model=64,
        n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab=256)
