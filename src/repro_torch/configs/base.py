"""Model configuration schema shared by every assigned architecture.

A single dataclass covers all six families (dense / moe / hybrid / ssm /
vlm / audio).  Family-specific switches are plain fields so a config is a
pure value object: configs never touch jax device state.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# Layer kinds used by hybrid layouts.
ATTN = "attn"
MAMBA = "mamba"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int                     # query heads (0 for attn-free archs)
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 128

    # --- MoE ---
    n_experts: int = 0               # routed experts (0 = dense FFN)
    top_k: int = 0
    n_shared_experts: int = 0
    moe_layer_period: int = 1        # MoE every k-th layer (jamba: 2)

    # --- MLA (deepseek) ---
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128

    # --- attention variants ---
    sliding_window: int = 0          # 0 = full attention
    qk_norm: bool = False            # qwen3
    attn_logit_softcap: float = 0.0

    # --- hybrid (jamba): attention every attn_period layers, mamba else ---
    attn_period: int = 0             # 0 = all layers attention
    # --- mamba ---
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    mamba_dt_rank: int = 0           # 0 -> ceil(d_model/16)

    # --- rwkv6 ---
    rwkv_head_size: int = 64

    # --- enc-dec (seamless) ---
    enc_dec: bool = False
    n_enc_layers: int = 0
    n_dec_layers: int = 0

    # --- modality frontend stub ---
    # none: token ids. patch_embed: precomputed image-patch embeddings are
    # prepended. frame_embed: encoder input is precomputed frames (enc-dec).
    frontend: str = "none"
    n_frontend_tokens: int = 0       # patches per image for vlm

    # --- common ---
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    tie_embeddings: bool = False

    # ------------------------------------------------------------------
    @property
    def mamba_d_inner(self) -> int:
        return self.mamba_expand * self.d_model

    @property
    def dt_rank(self) -> int:
        if self.mamba_dt_rank:
            return self.mamba_dt_rank
        return -(-self.d_model // 16)

    @property
    def rwkv_n_heads(self) -> int:
        return self.d_model // self.rwkv_head_size

    def layer_kind(self, i: int) -> str:
        """attn|mamba for layer i (hybrid layouts)."""
        if self.family == "ssm":
            return "rwkv"
        if self.attn_period:
            # jamba: one attention layer per attn_period block, at the middle
            # slot (index attn_period//2) of each block [arXiv:2403.19887].
            return ATTN if (i % self.attn_period) == self.attn_period // 2 else MAMBA
        return ATTN

    def layer_is_moe(self, i: int) -> bool:
        if self.n_experts == 0:
            return False
        return (i % self.moe_layer_period) == (self.moe_layer_period - 1) \
            if self.moe_layer_period > 1 else True

    # --- parameter counting (for roofline MODEL_FLOPS) -----------------
    def param_counts(self) -> Tuple[int, int]:
        """Returns (total_params, active_params) excluding embeddings.

        active counts only top_k (+shared) experts per MoE layer.
        """
        d, f = self.d_model, self.d_ff
        total = 0
        active = 0
        n_layers = (self.n_enc_layers + self.n_dec_layers) if self.enc_dec \
            else self.n_layers

        def attn_params() -> int:
            if self.use_mla:
                qh = self.qk_nope_head_dim + self.qk_rope_head_dim
                p = d * self.q_lora_rank + self.q_lora_rank * self.n_heads * qh
                p += d * (self.kv_lora_rank + self.qk_rope_head_dim)
                p += self.kv_lora_rank * self.n_heads * (
                    self.qk_nope_head_dim + self.v_head_dim)
                p += self.n_heads * self.v_head_dim * d
                return p
            return (d * self.n_heads * self.head_dim
                    + 2 * d * self.n_kv_heads * self.head_dim
                    + self.n_heads * self.head_dim * d)

        def mamba_params() -> int:
            di = self.mamba_d_inner
            return (d * 2 * di + di * self.mamba_d_conv
                    + di * (self.dt_rank + 2 * self.mamba_d_state)
                    + self.dt_rank * di + di * self.mamba_d_state + di
                    + di * d)

        def rwkv_params() -> int:
            # time-mix ~ 4*d^2 + decay/mix lora; channel-mix ~ 2*d*3.5d
            return int(4 * d * d + 2 * d * 3.5 * d + 6 * d + d * 192 + d * 128)

        for i in range(n_layers):
            kind = self.layer_kind(i)
            if kind == ATTN:
                total += attn_params()
                active += attn_params()
            elif kind == MAMBA:
                total += mamba_params()
                active += mamba_params()
            else:
                total += rwkv_params()
                active += rwkv_params()
                continue  # rwkv params include channel mix
            if self.layer_is_moe(i):
                ffn = 3 * d * f
                total += self.n_experts * ffn + d * self.n_experts
                active += self.top_k * ffn
                if self.n_shared_experts:
                    total += self.n_shared_experts * ffn
                    active += self.n_shared_experts * ffn
            else:
                dense_f = f if not self.n_experts else f  # same width
                total += 3 * d * dense_f
                active += 3 * d * dense_f
        if self.enc_dec:
            # cross attention in decoder layers
            for _ in range(self.n_dec_layers):
                total += attn_params()
                active += attn_params()
        return total, active


_REGISTRY: dict = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        # import side-effect registration
        from repro_torch import configs  # noqa: F401
        import importlib
        for mod in configs.ALL_ARCH_MODULES:
            importlib.import_module(f"repro_torch.configs.{mod}")
    if name not in _REGISTRY:
        raise KeyError(f"unknown config {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> list:
    get_config  # ensure registry populated on demand by callers
    return sorted(_REGISTRY)
