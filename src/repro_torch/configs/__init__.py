"""Assigned-architecture configs (one module per arch) + the paper config.

Canonical ids (use with ``--arch``):
  jamba-v0.1-52b  deepseek-v2-236b  mixtral-8x22b  command-r-35b
  mistral-nemo-12b  qwen3-32b  llama3.2-3b  llava-next-34b
  rwkv6-7b  seamless-m4t-large-v2
"""
from repro_torch.configs.base import ModelConfig, get_config, list_configs, register

ALL_ARCH_MODULES = [
    "jamba_v0_1_52b",
    "deepseek_v2_236b",
    "mixtral_8x22b",
    "command_r_35b",
    "mistral_nemo_12b",
    "qwen3_32b",
    "llama3_2_3b",
    "llava_next_34b",
    "rwkv6_7b",
    "seamless_m4t_large_v2",
    "saga_paper",
]

ARCH_IDS = [
    "jamba-v0.1-52b",
    "deepseek-v2-236b",
    "mixtral-8x22b",
    "command-r-35b",
    "mistral-nemo-12b",
    "qwen3-32b",
    "llama3.2-3b",
    "llava-next-34b",
    "rwkv6-7b",
    "seamless-m4t-large-v2",
]


def load_all() -> None:
    import importlib
    for mod in ALL_ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{mod}")


__all__ = ["ModelConfig", "get_config", "list_configs", "register",
           "ARCH_IDS", "ALL_ARCH_MODULES", "load_all"]
