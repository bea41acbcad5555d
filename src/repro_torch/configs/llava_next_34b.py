"""llava-next-34b [vlm] — anyres tiling; backbone only, patch frontend STUB.

60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]

Per the assignment the modality frontend is a stub: ``input_specs()``
provides precomputed patch embeddings (B, n_patches, d_model) which are
prepended to the text token embeddings.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="llava-next-34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab=64000,
    frontend="patch_embed",
    n_frontend_tokens=2048,          # anyres tiling budget per image
    rope_theta=5e6,
))


def tiny() -> ModelConfig:
    return ModelConfig(
        name="llava-next-tiny", family="vlm", n_layers=3, d_model=64,
        n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab=256,
        frontend="patch_embed", n_frontend_tokens=16)
