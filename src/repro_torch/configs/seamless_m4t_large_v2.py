"""seamless-m4t-large-v2 [audio] — enc-dec, multimodal; frame frontend STUB.

24L d_model=1024 16H (GQA kv=16) d_ff=8192 vocab=256206  [arXiv:2308.11596; hf]
24 encoder + 24 decoder layers (speech encoder / text decoder, large-v2).
Encoder input is precomputed frame embeddings (the conformer feature
frontend is stubbed per the assignment).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    n_layers=48,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab=256206,
    enc_dec=True,
    n_enc_layers=24,
    n_dec_layers=24,
    frontend="frame_embed",
))


def tiny() -> ModelConfig:
    return ModelConfig(
        name="seamless-tiny", family="audio", n_layers=4, d_model=64,
        n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128, vocab=256,
        enc_dec=True, n_enc_layers=2, n_dec_layers=2,
        frontend="frame_embed")
