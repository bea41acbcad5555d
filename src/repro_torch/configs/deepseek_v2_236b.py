"""deepseek-v2-236b [moe] — MLA kv_lora=512, 2 shared + 160 routed top-6.

60L d_model=5120 128H (GQA kv=128) d_ff=1536 vocab=102400  [arXiv:2405.04434; hf]
d_ff=1536 is the per-expert (MoE) intermediate size per the assigned spec.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,          # MLA: all heads share the compressed latent
    d_ff=1536,
    vocab=102400,
    n_experts=160,
    top_k=6,
    n_shared_experts=2,
    use_mla=True,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    rope_theta=1e4,
))


def tiny() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-tiny", family="moe", n_layers=4, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=64, vocab=256,
        n_experts=8, top_k=2, n_shared_experts=1,
        use_mla=True, q_lora_rank=32, kv_lora_rank=16,
        qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16)
