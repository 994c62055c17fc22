"""Error-feedback state for LGC (paper Algorithm 1, lines 8-11).

Port of ``repro/core/error_feedback.py:54-90``.  At a sync of device m:

    u_m  = e_m + w_m - w_hat_m^{t+1/2}          (net progress + carried error)
    g_m  = LGC_k(u_m)                           (compressed update, uploaded)
    e_m' = u_m - g_m                            (error kept for next round)

Between syncs e_m is untouched.  ``u == g + e'`` holds exactly, since g is
a masked copy of u.  The population-scale EF stores (reference :93-195)
wait for the population layer (ROADMAP A11).
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from repro_torch.kernels.ref import ftz_add

from .compressor import LGCCompressor


class EFState(NamedTuple):
    """Flat error memory, one vector per FL device."""
    e: torch.Tensor  # (D,) float32


def init_ef(d: int, device: str | torch.device = "cpu") -> EFState:
    return EFState(e=torch.zeros((d,), dtype=torch.float32, device=device))


def ef_compress(state: EFState, delta: torch.Tensor,
                compressor: LGCCompressor,
                received: Sequence[bool] | None = None
                ) -> tuple[torch.Tensor, EFState]:
    """One error-compensated compression step: returns (g, new state).

    ``received[c]`` False drops layer c on its channel; its mass stays in
    the error memory (e' = u - g_sent), to be sent again later."""
    u = ftz_add(state.e, delta)        # flushed, as the reference adds
    g_sent = compressor(u, received)
    return g_sent, EFState(e=u - g_sent)
