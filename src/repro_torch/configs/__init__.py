"""Config system: ArchConfig + per-architecture modules + registry."""
from .base import ArchConfig
from .registry import ARCH_IDS, get_config, get_smoke_config

__all__ = ["ArchConfig", "ARCH_IDS", "get_config", "get_smoke_config"]
