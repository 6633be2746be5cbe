"""Config registry (port of `repro/configs/`): one module per assigned
architecture, field for field the reference's. `get_config(name)` returns
the exact published config; `get_reduced(name)` returns the same family
scaled down for CPU smoke tests."""
from __future__ import annotations

import importlib

ARCHS = (
    "qwen1_5_32b",
    "gemma_2b",
    "mistral_large_123b",
    "minitron_8b",
    "granite_moe_3b_a800m",
    "qwen3_moe_30b_a3b",
    "whisper_medium",
    "mamba2_370m",
    "jamba_1_5_large_398b",
    "llama_3_2_vision_90b",
)

# canonical ids (as assigned) → module names
IDS = {
    "qwen1.5-32b": "qwen1_5_32b",
    "gemma-2b": "gemma_2b",
    "mistral-large-123b": "mistral_large_123b",
    "minitron-8b": "minitron_8b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "whisper-medium": "whisper_medium",
    "mamba2-370m": "mamba2_370m",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "llama-3.2-vision-90b": "llama_3_2_vision_90b",
}


def _module(name: str):
    mod = IDS.get(name, name).replace("-", "_").replace(".", "_")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(name: str):
    return _module(name).CONFIG


def get_reduced(name: str):
    return _module(name).reduced()


def all_arch_names():
    return list(IDS)
