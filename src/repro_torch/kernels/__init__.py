"""Hopper kernels: the LGC compression hot path and decode attention.

Kernels (CUDA C++ for sm_90a under ``csrc/``, each with its plain torch
version in :mod:`.ref`), one for each Pallas kernel of the reference, the
LGC ones also in an (M, D) row form (one launch over M rows; maxabs and
histogram in a wide form for a few long rows and a short one for many
short rows, any number of them), and
maxabs and histogram also in a segmented form (one launch over every
model-layer slice of every row):
  topk_threshold   -- maxabs + 256-bin magnitude histogram (2-pass Top_k)
  layered_sparsify -- fused layered sparsify + error-feedback update
  swa_attention    -- sliding-window flash decode attention (the serve
                      step's attention, ``models.layers.attention_decode``)
and one kernel of the port's own, with no Pallas counterpart:
  threefry_normal  -- the weights' draw, ``jax.random.normal`` bit for bit

Nothing here builds or loads the kernels at import: the library is compiled
at the first launch (:mod:`._build`).
"""
from ._build import LAUNCHES, reset_launch_counts
from .layered_sparsify import sparsify_ef, sparsify_ef_rows
from .ops import (lgc_compress_hist, lgc_compress_hist_rows,
                  per_layer_candidates_hist_rows, selected_counts)
from .swa_attention import swa_decode, swa_decode_partial
from .threefry_normal import threefry_normal
from .topk_threshold import (SegmentTable, histogram, histogram_rows,
                             histogram_segments, maxabs, maxabs_rows,
                             maxabs_segments, sum_maxabs, sum_maxabs_rows,
                             thresholds_from_counts)

__all__ = [
    "LAUNCHES", "reset_launch_counts",
    "lgc_compress_hist", "lgc_compress_hist_rows",
    "per_layer_candidates_hist_rows", "selected_counts",
    "SegmentTable", "histogram", "histogram_rows", "histogram_segments",
    "maxabs", "maxabs_rows", "maxabs_segments", "sum_maxabs", "sum_maxabs_rows",
    "thresholds_from_counts", "sparsify_ef", "sparsify_ef_rows",
    "swa_decode", "swa_decode_partial", "threefry_normal",
]
