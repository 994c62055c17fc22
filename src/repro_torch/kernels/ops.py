"""The histogram-LGC pipeline composed from the kernels.

Port of ``repro/kernels/ops.py:26-52``.  ``lgc_compress_hist`` is composed as
the reference composes it (ops.py:36-41):

  1. u = e + delta, materialised once for the statistics passes
  2. maxabs (CUDA kernel)
  3. 256-bin magnitude histogram of u (CUDA kernel)
  4. per-layer thresholds from the CDF (torch ops on 256 scalars)
  5. fused layered sparsify + error feedback (CUDA kernel, recomputes u)

It matches :func:`repro_torch.kernels.ref.hist_lgc_compress` bitwise.
"""
from __future__ import annotations

import torch

from .layered_sparsify import sparsify_ef
from .topk_threshold import histogram, maxabs, thresholds_from_counts


def lgc_compress_hist(e: torch.Tensor, delta: torch.Tensor,
                      cum_ks: torch.Tensor, received: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Histogram-LGC with error feedback.  Returns (g, e_new), f32 (D,)."""
    e = e.to(torch.float32)
    delta = delta.to(torch.float32)
    u_stats = e + delta
    m = maxabs(u_stats)
    counts = histogram(u_stats, m)
    thr = thresholds_from_counts(counts, m, cum_ks)
    return sparsify_ef(e, delta, thr, received)


def selected_counts(g: torch.Tensor) -> torch.Tensor:
    """Number of transmitted coordinates (for wire-byte accounting)."""
    return (g != 0).sum(dtype=torch.int32)
