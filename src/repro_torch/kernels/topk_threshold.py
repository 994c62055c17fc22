"""Magnitude statistics for histogram-Top_k selection: two CUDA kernels and
the thresholds.

Port of ``repro/kernels/topk_threshold.py:32-116``:

  pass 1: ``maxabs``    -- CUDA kernel, csrc/maxabs.cu
  pass 2: ``histogram`` -- CUDA kernel, csrc/histogram.cu
  then  : ``thresholds_from_counts`` -- torch ops on 256 counts, on the device

A wrapper checks its inputs, allocates the outputs, launches on the current
stream and raises if the launch failed.  For a CPU tensor it calls the plain
version in :mod:`repro_torch.kernels.ref`; for a CUDA tensor it launches the
kernel or raises -- there is no fallback.  Results are bitwise equal to the
plain versions (chip_smoke.py on the card, tests/test_torch_kernels.py).
"""
from __future__ import annotations

import torch

from . import _build, ref

N_BINS = ref.N_BINS


def _check_vec(x: torch.Tensor, name: str, dtype=torch.float32) -> None:
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if x.dim() != 1 or x.numel() == 0:
        raise ValueError(f"{name} must be a non-empty flat vector, got "
                         f"shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_same_device(x: torch.Tensor, *others: torch.Tensor) -> None:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    for o in others:
        if o.device != x.device:
            raise ValueError(f"tensors on {x.device} and {o.device}")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def maxabs(x: torch.Tensor) -> torch.Tensor:
    """max |x| over a flat f32 vector.  Returns (1, 1) f32."""
    _check_vec(x, "x")
    _check_same_device(x)
    if x.device.type == "cpu":
        return ref.hist_maxabs(x).reshape(1, 1)
    out = torch.zeros((1, 1), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = _build.lib().lgc_maxabs(x.data_ptr(), x.numel(), out.data_ptr(),
                                      _stream(x))
    _build.check(err, "maxabs")
    return out


def histogram(x: torch.Tensor, maxabs_val: torch.Tensor) -> torch.Tensor:
    """256-bin |x| histogram over [0, maxabs_val].  Returns (256,) int32."""
    _check_vec(x, "x")
    if maxabs_val.numel() != 1 or maxabs_val.dtype != torch.float32:
        raise ValueError("maxabs_val must be one f32 value")
    _check_same_device(x, maxabs_val)
    if x.device.type == "cpu":
        return ref.hist_counts(x, maxabs_val)
    m = maxabs_val.reshape(1).contiguous()
    counts = torch.zeros(N_BINS, dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        err = _build.lib().lgc_histogram(x.data_ptr(), x.numel(), m.data_ptr(),
                                         counts.data_ptr(), _stream(x))
    _build.check(err, "histogram")
    return counts


def thresholds_from_counts(counts: torch.Tensor, maxabs_val: torch.Tensor,
                           cum_ks: torch.Tensor) -> torch.Tensor:
    """Per-layer thresholds from the histogram CDF: (C,) f32.

    Torch ops on 256 scalars, on the counts' device with no host sync;
    the same semantics as ``ref.hist_thresholds``."""
    return ref.hist_thresholds(counts, maxabs_val, cum_ks)
