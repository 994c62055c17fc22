"""Hopper kernels for the LGC compression hot path.

Kernels (CUDA C++ for sm_90a under ``csrc/``, each with its plain torch
version in :mod:`.ref`):
  topk_threshold   -- maxabs + 256-bin magnitude histogram (2-pass Top_k)
  layered_sparsify -- fused layered sparsify + error-feedback update

``swa_decode`` (the reference's sliding-window decode kernel) is not ported
yet (ROADMAP B4).  Nothing here builds or loads the kernels at import: the
library is compiled at the first launch (:mod:`._build`).
"""
from ._build import LAUNCHES, reset_launch_counts
from .layered_sparsify import sparsify_ef
from .ops import lgc_compress_hist, selected_counts
from .topk_threshold import histogram, maxabs, thresholds_from_counts

__all__ = [
    "LAUNCHES", "reset_launch_counts",
    "lgc_compress_hist", "selected_counts",
    "histogram", "maxabs", "thresholds_from_counts", "sparsify_ef",
]
