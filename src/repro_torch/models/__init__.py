"""PyTorch model code: the uniform GQA decoder (dense, moe, vlm), rwkv6
(ssm) and jamba (hybrid)."""
