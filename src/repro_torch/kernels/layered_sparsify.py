"""Fused error-feedback layered sparsification: a CUDA kernel.

Port of ``repro/kernels/layered_sparsify.py:32-87``.  Per element

    u  = e + delta
    g  = u * 1[ layer(|u|) received ]
    e' = u - g

The kernel (csrc/sparsify_ef.cu) reads e and delta once and writes g and e'
once; u never reaches device memory.  g and e' are bitwise equal to the plain
version, and u == g + e' holds exactly (tests/test_torch_kernels.py,
chip_smoke.py).  For a CPU tensor the wrapper calls the plain version; for a
CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import torch

from . import _build, ref
from .topk_threshold import _check_same_device, _check_vec, _stream

MAX_LAYERS = 4


def sparsify_ef(e: torch.Tensor, delta: torch.Tensor, thr: torch.Tensor,
                received: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused layered sparsify + error-feedback update on flat f32 vectors.

    Args:
      e, delta: (D,) error memory and net progress.
      thr: (C,) descending layer thresholds (bin edges), C <= 4.
      received: (C,) int/bool channel delivery mask.

    Returns (g, e_new), both (D,) f32.
    """
    _check_vec(e, "e")
    _check_vec(delta, "delta")
    if e.shape != delta.shape:
        raise ValueError(f"e {tuple(e.shape)} and delta {tuple(delta.shape)}")
    n_layers = thr.numel()
    if thr.dim() != 1 or not 1 <= n_layers <= MAX_LAYERS:
        raise ValueError(f"thr must be (C,) with 1 <= C <= {MAX_LAYERS}")
    if received.shape != thr.shape:
        raise ValueError("received must have thr's shape (C,)")
    _check_same_device(e, delta, thr, received)
    thr = thr.to(torch.float32).contiguous()
    recv = received.to(torch.int32).contiguous()
    if e.device.type == "cpu":
        return ref.hist_layered_sparsify(e + delta, thr, recv)
    g = torch.empty_like(e)
    e_new = torch.empty_like(e)
    with torch.cuda.device(e.device):
        err = _build.lib().lgc_sparsify_ef(
            e.data_ptr(), delta.data_ptr(), thr.data_ptr(), recv.data_ptr(),
            n_layers, g.data_ptr(), e_new.data_ptr(), e.numel(), _stream(e))
    _build.check(err, "sparsify_ef")
    return g, e_new
