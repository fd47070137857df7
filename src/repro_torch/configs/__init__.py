"""Assigned architecture configs, copied as data from the JAX package."""
from importlib import import_module

from .base import SHAPES, ArchConfig, ShapeSpec, applicable_shapes, smoke_shape  # noqa: F401

ARCH_MODULES = {
    "whisper-tiny": "whisper_tiny",
    "gemma-2b": "gemma_2b",
    "phi3-medium-14b": "phi3_medium_14b",
    "qwen3-8b": "qwen3_8b",
    "yi-6b": "yi_6b",
    "zamba2-2.7b": "zamba2_2p7b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b",
    "mamba2-2.7b": "mamba2_2p7b",
    "qwen2-vl-2b": "qwen2_vl_2b",
}


def get_config(name: str) -> ArchConfig:
    if name not in ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; choose from {sorted(ARCH_MODULES)}")
    return import_module(f"repro_torch.configs.{ARCH_MODULES[name]}").CONFIG


def all_configs() -> dict[str, ArchConfig]:
    return {name: get_config(name) for name in ARCH_MODULES}
