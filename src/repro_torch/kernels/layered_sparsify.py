"""Fused error-feedback layered sparsification: a CUDA kernel.

Port of ``repro/kernels/layered_sparsify.py:32-87``.  Per element

    u  = e + delta
    g  = u * 1[ layer(|u|) received ]
    e' = u - g

The kernel (csrc/sparsify_ef.cu) reads e and delta once and writes g and e'
once; u never reaches device memory.  g and e' are bitwise equal to the plain
version, and u == g + e' holds exactly (tests/test_torch_kernels.py,
chip_smoke.py).  For a CPU tensor the wrapper calls the plain version; for a
CUDA tensor it launches the kernel or raises.  ``sparsify_ef_rows`` is the
(M, D) form over one row per device, each row with its own thresholds and
delivery mask, in one launch of the same kernel (a flat vector is one row;
each wrapper counts its own launches).
"""
from __future__ import annotations

import torch

from . import _build, ref
from .topk_threshold import (_check_rows, _check_same_device, _check_vec,
                             _on_device, _sm_count, _stream, rows_grid)

MAX_LAYERS = 4
_BLOCKS_PER_SM = 8             # resident blocks per SM (the flat launch's)


def _launch(e: torch.Tensor, delta: torch.Tensor, thr: torch.Tensor,
            recv: torch.Tensor, name: str) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch of the kernel over e, delta (M, D) with thr, recv (M, C);
    counted under ``name``."""
    rows, n = e.shape
    g = torch.empty_like(e)
    e_new = torch.empty_like(e)
    grid = rows_grid(rows, n, 4 * 256, _BLOCKS_PER_SM * _sm_count(e.device))
    with _on_device(e):
        err = _build.lib().lgc_sparsify_ef(
            e.data_ptr(), delta.data_ptr(), thr.data_ptr(), recv.data_ptr(),
            thr.shape[1], g.data_ptr(), e_new.data_ptr(), rows, n, grid,
            _stream(e))
    _build.check(err, name)
    return g, e_new


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
        return ref.hist_layered_sparsify(ref.ftz_add(e, delta), thr, recv)
    g, e_new = _launch(e[None], delta[None], thr[None], recv[None],
                       "sparsify_ef")
    return g[0], e_new[0]


def sparsify_ef_rows(e: torch.Tensor, delta: torch.Tensor, thr: torch.Tensor,
                     received: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`sparsify_ef` of each row: e, delta (M, D) f32, thr (M, C)
    descending thresholds per row and received (M, C) delivery masks,
    C <= 4.  Returns (g, e_new), both (M, D) f32, in one launch."""
    _check_rows(e, "e")
    _check_rows(delta, "delta")
    if e.shape != delta.shape:
        raise ValueError(f"e {tuple(e.shape)} and delta {tuple(delta.shape)}")
    rows = e.shape[0]
    if thr.dim() != 2 or thr.shape[0] != rows or not (
            1 <= thr.shape[1] <= MAX_LAYERS):
        raise ValueError(f"thr must be ({rows}, C) with 1 <= C <= "
                         f"{MAX_LAYERS}, got {tuple(thr.shape)}")
    if received.shape != thr.shape:
        raise ValueError("received must have thr's shape (M, C)")
    _check_same_device(e, delta, thr, received)
    thr = thr.to(torch.float32).contiguous()
    recv = received.to(torch.int32).contiguous()
    if e.device.type == "cpu":
        return ref.hist_layered_sparsify_rows(ref.ftz_add(e, delta), thr,
                                              recv)
    return _launch(e, delta, thr, recv, "sparsify_ef_rows")
