"""Optimizers of the port: AdamW, as the DDPG controller runs it
(``repro/optim``; SGD-momentum, SGD and ``get_optimizer`` are ROADMAP A15)."""
from .optimizers import (AdamWState, OptimizerConfig, adamw_init,
                         adamw_update, apply_updates, global_norm)

__all__ = ["AdamWState", "OptimizerConfig", "adamw_init", "adamw_update",
           "apply_updates", "global_norm"]
