"""The paper's own evaluation model + small models for runnable examples.

SAGA's empirical evaluation serves Llama-3-70B-Instruct (GQA, L=80,
n_kv=8, d_h=128; §2.2) — a 32K-context session holds ~10.7 GB of KV.
We register it so the serving stack and dry-run can exercise the exact
model the paper schedules, and a ~100M config for CPU end-to-end drivers.
"""
from repro_torch.configs.base import ModelConfig, register

LLAMA3_70B = register(ModelConfig(
    name="llama3-70b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab=128256,
    rope_theta=5e5,
))

# ~100M-param dense model for the end-to-end train/serve examples on CPU.
SMALL_100M = register(ModelConfig(
    name="small-100m",
    family="dense",
    n_layers=8,
    d_model=512,
    n_heads=8,
    n_kv_heads=4,
    head_dim=64,
    d_ff=2048,
    vocab=32768,
))

# Micro model for fast engine/integration tests.
MICRO = register(ModelConfig(
    name="micro",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab=512,
))
