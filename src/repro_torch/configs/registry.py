"""Architecture registry: ``--arch <id>`` -> ArchConfig.

The port knows and ports every id the reference registers: the dense
qwen2 pair, glm4-9b, starcoder2-7b and yi-34b, the moe olmoe-1b-7b and
grok-1-314b, the ssm mamba2-370m, the hybrid zamba2-1.2b, the vlm
phi-3-vision-4.2b and the audio whisper-small.
"""
from __future__ import annotations

import importlib

from .base import ArchConfig

_MODULES = {
    "glm4-9b": "glm4_9b",
    "whisper-small": "whisper_small",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "yi-34b": "yi_34b",
    "mamba2-370m": "mamba2_370m",
    "phi-3-vision-4.2b": "phi3_vision_4b",
    "qwen2-1.5b": "qwen2_1_5b",
    "qwen2-100m": "qwen2_100m",
    "grok-1-314b": "grok1_314b",
    "zamba2-1.2b": "zamba2_1_2b",
    "starcoder2-7b": "starcoder2_7b",
}
ARCH_IDS = tuple(_MODULES)


def _module(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; choose from {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")


def get_config(arch_id: str) -> ArchConfig:
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str) -> ArchConfig:
    return _module(arch_id).smoke()
