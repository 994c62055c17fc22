"""Architecture registry: ``--arch <id>`` -> ArchConfig.

The port knows every id the reference registers.  The dense qwen2 pair
and the serving archs of the other five families (olmoe, mamba2, zamba2,
phi-3-vision, whisper) are ported; the other dense and moe configs raise
until ROADMAP A15.
"""
from __future__ import annotations

import importlib

from .base import ArchConfig

_PORTED = {"qwen2-100m": "qwen2_100m", "qwen2-1.5b": "qwen2_1_5b",
           "olmoe-1b-7b": "olmoe_1b_7b", "mamba2-370m": "mamba2_370m",
           "zamba2-1.2b": "zamba2_1_2b",
           "phi-3-vision-4.2b": "phi3_vision_4b",
           "whisper-small": "whisper_small"}
ARCH_IDS = ("glm4-9b", "whisper-small", "olmoe-1b-7b", "yi-34b",
            "mamba2-370m", "phi-3-vision-4.2b", "qwen2-1.5b", "qwen2-100m",
            "grok-1-314b", "zamba2-1.2b", "starcoder2-7b")


def _module(arch_id: str):
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; choose from {ARCH_IDS}")
    if arch_id not in _PORTED:
        raise NotImplementedError(
            f"arch {arch_id!r} is not ported yet (ROADMAP A15); ported: "
            f"{sorted(_PORTED)}")
    return importlib.import_module(f"repro_torch.configs.{_PORTED[arch_id]}")


def get_config(arch_id: str) -> ArchConfig:
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str) -> ArchConfig:
    return _module(arch_id).smoke()
