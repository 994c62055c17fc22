"""The histogram-LGC pipeline composed from the kernels.

Port of ``repro/kernels/ops.py:26-52``.  ``lgc_compress_hist`` is composed as
the reference composes it (ops.py:36-41):

  1.-2. u = e + delta, materialised once for the statistics passes, and
       maxabs, in one launch of the maxabs kernel (``sum_maxabs``; the add
       flushes subnormals as the reference's does)
  3. 256-bin magnitude histogram of u (CUDA kernel)
  4. per-layer thresholds from the CDF (torch ops on 256 scalars)
  5. fused layered sparsify + error feedback (CUDA kernel, recomputes u)

It matches :func:`repro_torch.kernels.ref.hist_lgc_compress` bitwise.
``lgc_compress_hist_rows`` composes the (M, D) row forms the same way, one
launch of each kernel over all rows (the reference's ``jax.vmap`` of
``lgc_compress_hist``, ``repro/core/fl_batched.py:201-209``), and matches
``ref.hist_lgc_compress_rows`` bitwise.  ``per_layer_candidates_hist_rows``
is the per-layer budgets' candidate mask, through the segmented forms of
the two statistics kernels.
"""
from __future__ import annotations

import torch

from . import ref
from .layered_sparsify import sparsify_ef, sparsify_ef_rows
from .topk_threshold import (N_BINS, SegmentTable, _check_segments, histogram,
                             histogram_rows, histogram_segments,
                             maxabs_segments, sum_maxabs, sum_maxabs_rows,
                             thresholds_from_counts)


def lgc_compress_hist(e: torch.Tensor, delta: torch.Tensor,
                      cum_ks: torch.Tensor, received: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Histogram-LGC with error feedback.  Returns (g, e_new), f32 (D,)."""
    e = e.to(torch.float32)
    delta = delta.to(torch.float32)
    u_stats, m = sum_maxabs(e, delta)
    counts = histogram(u_stats, m)
    thr = thresholds_from_counts(counts, m, cum_ks)
    return sparsify_ef(e, delta, thr, received)


def lgc_compress_hist_rows(e: torch.Tensor, delta: torch.Tensor,
                           cum_ks: torch.Tensor, received: torch.Tensor
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Histogram-LGC with error feedback on each row of e, delta (M, D),
    with per-row cumulative budgets ``cum_ks`` and delivery masks
    ``received`` (M, C).  Returns (g, e_new), f32 (M, D)."""
    e = e.to(torch.float32).contiguous()
    delta = delta.to(torch.float32).contiguous()
    u_stats, m = sum_maxabs_rows(e, delta)
    counts = histogram_rows(u_stats, m)
    thr = thresholds_from_counts(counts, m, cum_ks)
    return sparsify_ef_rows(e, delta, thr, received)


def per_layer_candidates_hist_rows(u: torch.Tensor,
                                   seg: SegmentTable,
                                   budgets: torch.Tensor) -> torch.Tensor:
    """The per-layer candidate mask of the histogram path (the reference's
    ``per_layer_candidates_hist``, ``repro/core/compressor.py:341-375``) on
    each row of u (M, D) with per-(row, slice) budgets (M, L): max |u| of
    every slice in one launch of ``maxabs_segments``, their histograms in
    one launch of ``histogram_segments``, each slice's threshold from its
    CDF with cum = its budget (torch ops on the (M L, 256) counts), and
    then |u| > thr & b > 0 with each coordinate's slice gathered (a
    subnormal |u| read as 0, as the reference compares).  Returns (M, D)
    bool, bitwise ``ref.hist_candidates_segments``."""
    _check_segments(u, seg)
    mx = maxabs_segments(u, seg)
    counts = histogram_segments(u, mx, seg)
    m, n_l = mx.shape
    thr = thresholds_from_counts(counts.reshape(m * n_l, N_BINS),
                                 mx.reshape(m * n_l),
                                 budgets.reshape(m * n_l, 1)).reshape(m, n_l)
    return ((ref.ftz(u.abs()) > thr.index_select(1, seg.ids))
            & (budgets.index_select(1, seg.ids) > 0))


def selected_counts(g: torch.Tensor) -> torch.Tensor:
    """Number of transmitted coordinates (for wire-byte accounting)."""
    return (g != 0).sum(dtype=torch.int32)
