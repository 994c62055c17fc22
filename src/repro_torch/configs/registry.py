"""Architecture registry: ``--arch <id>`` -> ArchConfig.

The port knows every id the reference registers; only ``qwen2-100m`` is
ported, and the others raise until their ROADMAP item (A15).
"""
from __future__ import annotations

import importlib

from .base import ArchConfig

_PORTED = {"qwen2-100m": "qwen2_100m"}
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
