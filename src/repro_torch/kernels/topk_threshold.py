"""Magnitude statistics for histogram-Top_k selection: two CUDA kernels and
the thresholds.

Port of ``repro/kernels/topk_threshold.py:32-116``:

  pass 1: ``maxabs``    -- CUDA kernel, csrc/maxabs.cu (``sum_maxabs``: the
                           same kernel forming u = e + delta on the way)
  pass 2: ``histogram`` -- CUDA kernel, csrc/histogram.cu
  then  : ``thresholds_from_counts`` -- torch ops on 256 counts, on the device

A wrapper checks its inputs, allocates the outputs, launches on the current
stream and raises if the launch failed.  For a CPU tensor it calls the plain
version in :mod:`repro_torch.kernels.ref`; for a CUDA tensor it launches the
kernel or raises -- there is no fallback.  Results are bitwise equal to the
plain versions (chip_smoke.py on the card, tests/test_torch_kernels.py).
"""
from __future__ import annotations

import contextlib

import torch

from . import _build, ref

N_BINS = ref.N_BINS
_THREADS = 256                 # threads per block of the LGC kernels (lgc::kThreads)
_MAXABS_LOADS = 4              # float4 loads per thread per pass (maxabs.cu kLoads)
_MAXABS_BLOCKS_PER_SM = 8      # resident blocks of maxabs per SM

_HIST_LOADS = 4                # float4 loads per thread per pass (histogram.cu kLoads)
# blocks of histogram per SM: of 2, 4 and 6 (its occupancy limit, 38
# registers a thread) 4 was the fastest on the H100
# (python -m repro_torch.launch.bench_histogram --blocks-per-sm 2,4,6)
_HIST_BLOCKS_PER_SM = 4

_sm_counts: dict[int, int] = {}
_counters: dict[tuple[str, int], torch.Tensor] = {}


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


def _on_device(x: torch.Tensor) -> contextlib.AbstractContextManager:
    """The context for a launch on x's card: nothing when it is current."""
    if x.device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(x.device)


def _sm_count(device: torch.device) -> int:
    n = _sm_counts.get(device.index)
    if n is None:
        n = torch.cuda.get_device_properties(device).multi_processor_count
        _sm_counts[device.index] = n
    return n


def _zeroed_counters(kernel: str, device: torch.device, n: int
                     ) -> torch.Tensor:
    """``n`` int32 counters on ``device`` that ``kernel`` keeps at zero
    between launches (its last block resets what it counted).  Kept per
    kernel and card, and grown, never shrunk; launches of one kernel on one
    card must not run concurrently on two streams."""
    key = (kernel, device.index)
    c = _counters.get(key)
    if c is None or c.numel() < n:
        c = torch.zeros(max(n, 64), dtype=torch.int32, device=device)
        _counters[key] = c
    return c


def _launch_maxabs(x: torch.Tensor, d: torch.Tensor | None,
                   u: torch.Tensor | None) -> torch.Tensor:
    per_block = _THREADS * _MAXABS_LOADS * 4        # floats of one block's pass
    grid = min(-(-x.numel() // per_block),
               _MAXABS_BLOCKS_PER_SM * _sm_count(x.device))
    out = torch.empty((1, 1), dtype=torch.float32, device=x.device)
    partials = torch.empty(grid, dtype=torch.int32, device=x.device)
    counter = _zeroed_counters("maxabs", x.device, 1)
    with _on_device(x):
        err = _build.lib().lgc_maxabs(
            x.data_ptr(), None if d is None else d.data_ptr(),
            None if u is None else u.data_ptr(), x.numel(), out.data_ptr(),
            partials.data_ptr(), counter.data_ptr(), grid, _stream(x))
    _build.check(err, "maxabs")
    return out


def maxabs(x: torch.Tensor) -> torch.Tensor:
    """max |x| over a flat f32 vector (a subnormal |x| counts as 0).
    Returns (1, 1) f32."""
    _check_vec(x, "x")
    _check_same_device(x)
    if x.device.type == "cpu":
        return ref.hist_maxabs(x).reshape(1, 1)
    return _launch_maxabs(x, None, None)


def sum_maxabs(e: torch.Tensor, delta: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """u = e + delta, added as the reference adds (subnormals flushed,
    ``ref.ftz_add``), and max |u|, in one launch of the maxabs kernel.
    Returns u (D,) f32 and (1, 1) f32."""
    _check_vec(e, "e")
    _check_vec(delta, "delta")
    if e.shape != delta.shape:
        raise ValueError(f"e {tuple(e.shape)} and delta {tuple(delta.shape)}")
    _check_same_device(e, delta)
    if e.device.type == "cpu":
        u = ref.ftz_add(e, delta)
        return u, ref.hist_maxabs(u).reshape(1, 1)
    # u starts at e's offset from a 16-byte boundary, so both move as float4s
    n, off = e.numel(), e.data_ptr() % 16 // 4
    u = torch.empty(n + 3, dtype=torch.float32, device=e.device)[off:off + n]
    return u, _launch_maxabs(e, delta, u)


def histogram_grid(n: int, device: torch.device) -> int:
    """Blocks of a ``histogram`` launch over n floats: 4 per SM, fewer for
    a short vector."""
    per_block = _THREADS * _HIST_LOADS * 4          # floats of one block's pass
    return min(-(-n // per_block), _HIST_BLOCKS_PER_SM * _sm_count(device))


def histogram(x: torch.Tensor, maxabs_val: torch.Tensor) -> torch.Tensor:
    """256-bin |x| histogram over [0, maxabs_val].  Returns (256,) int32."""
    _check_vec(x, "x")
    if maxabs_val.numel() != 1 or maxabs_val.dtype != torch.float32:
        raise ValueError("maxabs_val must be one f32 value")
    _check_same_device(x, maxabs_val)
    if x.device.type == "cpu":
        return ref.hist_counts(x, maxabs_val)
    m = maxabs_val.reshape(1).contiguous()
    counts = torch.empty(N_BINS, dtype=torch.int32, device=x.device)
    acc = _zeroed_counters("histogram", x.device, N_BINS + 1)
    grid = histogram_grid(x.numel(), x.device)
    with _on_device(x):
        err = _build.lib().lgc_histogram(x.data_ptr(), x.numel(), m.data_ptr(),
                                         counts.data_ptr(), acc.data_ptr(),
                                         grid, _stream(x))
    _build.check(err, "histogram")
    return counts


def thresholds_from_counts(counts: torch.Tensor, maxabs_val: torch.Tensor,
                           cum_ks: torch.Tensor) -> torch.Tensor:
    """Per-layer thresholds from the histogram CDF: (C,) f32.

    Torch ops on 256 scalars, on the counts' device with no host sync;
    the same semantics as ``ref.hist_thresholds``."""
    return ref.hist_thresholds(counts, maxabs_val, cum_ks)
