"""Optimizers of the port (``repro/optim``): AdamW, SGD-momentum and SGD."""
from .optimizers import (AdamWState, OptimizerConfig, SGDMState, SGDState,
                         adamw_init, adamw_update, apply_updates,
                         get_optimizer, global_norm, sgd_init, sgdm_init)

__all__ = ["AdamWState", "OptimizerConfig", "SGDMState", "SGDState",
           "adamw_init", "adamw_update", "apply_updates", "get_optimizer",
           "global_norm", "sgd_init", "sgdm_init"]
