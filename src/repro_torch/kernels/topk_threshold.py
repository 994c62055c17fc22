"""Magnitude statistics for histogram-Top_k selection: two CUDA kernels and
the thresholds.

Port of ``repro/kernels/topk_threshold.py:32-116``:

  pass 1: ``maxabs``    -- CUDA kernel, csrc/maxabs.cu (``sum_maxabs``: the
                           same kernel forming u = e + delta on the way)
  pass 2: ``histogram`` -- CUDA kernel, csrc/histogram.cu
  then  : ``thresholds_from_counts`` -- torch ops on 256 counts, on the device

and their (M, D) row forms, one row per simulated device, each one launch
of the same kernel over all rows (the reference reaches its kernels
through ``jax.vmap`` there, ``repro/core/fl_batched.py:201-209``):
``sum_maxabs_rows``, ``histogram_rows`` and ``thresholds_from_counts`` on
(M, 256) counts.  A flat vector is one row of the kernel, so each row of a
launch gets the bits of a flat launch on it.

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

_MAX_ROWS = 65535              # the grid's y extent, one row a step
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


def _check_rows(x: torch.Tensor, name: str, dtype=torch.float32) -> None:
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if x.dim() != 2 or x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"{name} must be (M, D) with M, D >= 1, got shape "
                         f"{tuple(x.shape)}")
    if x.shape[0] > _MAX_ROWS:
        raise ValueError(f"{name} has {x.shape[0]} rows; at most {_MAX_ROWS}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def rows_grid(rows: int, n: int, per_block: int, target: int) -> int:
    """Blocks per row of a row kernel over (rows, n): enough for one pass of
    ``per_block`` floats a block, at most ``target // rows`` (the flat
    kernel's grid shared by the rows), at least one."""
    return max(1, min(-(-n // per_block), target // rows))


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
            None if u is None else u.data_ptr(), 1, x.numel(), out.data_ptr(),
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


def sum_maxabs_rows(e: torch.Tensor, delta: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`sum_maxabs` of each row: u = e + delta (flushed) and max |u|
    of each row, over (M, D) rows in one launch.  Returns u (M, D) f32 and
    (M,) f32."""
    _check_rows(e, "e")
    _check_rows(delta, "delta")
    if e.shape != delta.shape:
        raise ValueError(f"e {tuple(e.shape)} and delta {tuple(delta.shape)}")
    _check_same_device(e, delta)
    if e.device.type == "cpu":
        u = ref.ftz_add(e, delta)
        return u, ref.hist_maxabs_rows(u)
    rows, n = e.shape
    # u starts at e's offset from a 16-byte boundary, so both move as float4s
    off = e.data_ptr() % 16 // 4
    u = torch.empty(rows * n + 3, dtype=torch.float32,
                    device=e.device)[off:off + rows * n].view(rows, n)
    per_block = _THREADS * _MAXABS_LOADS * 4
    grid = rows_grid(rows, n, per_block,
                     _MAXABS_BLOCKS_PER_SM * _sm_count(e.device))
    out = torch.empty(rows, dtype=torch.float32, device=e.device)
    partials = torch.empty(rows * grid, dtype=torch.int32, device=e.device)
    counters = _zeroed_counters("maxabs_rows", e.device, rows)
    with _on_device(e):
        err = _build.lib().lgc_maxabs(
            e.data_ptr(), delta.data_ptr(), u.data_ptr(), rows, n,
            out.data_ptr(), partials.data_ptr(), counters.data_ptr(), grid,
            _stream(e))
    _build.check(err, "maxabs_rows")
    return u, out


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
        err = _build.lib().lgc_histogram(x.data_ptr(), 1, x.numel(),
                                         m.data_ptr(), counts.data_ptr(),
                                         acc.data_ptr(), grid, _stream(x))
    _build.check(err, "histogram")
    return counts


def histogram_rows(x: torch.Tensor, maxabs_val: torch.Tensor
                   ) -> torch.Tensor:
    """:func:`histogram` of each row of x (M, D) over [0, maxabs_val[r]],
    in one launch.  Returns (M, 256) int32."""
    _check_rows(x, "x")
    rows, n = x.shape
    if maxabs_val.numel() != rows or maxabs_val.dtype != torch.float32:
        raise ValueError(f"maxabs_val must be {rows} f32 values")
    _check_same_device(x, maxabs_val)
    if x.device.type == "cpu":
        return ref.hist_counts_rows(x, maxabs_val)
    m = maxabs_val.reshape(rows).contiguous()
    counts = torch.empty((rows, N_BINS), dtype=torch.int32, device=x.device)
    acc = _zeroed_counters("histogram_rows", x.device, rows * (N_BINS + 1))
    per_block = _THREADS * _HIST_LOADS * 4
    grid = rows_grid(rows, n, per_block,
                     _HIST_BLOCKS_PER_SM * _sm_count(x.device))
    with _on_device(x):
        err = _build.lib().lgc_histogram(
            x.data_ptr(), rows, n, m.data_ptr(), counts.data_ptr(),
            acc.data_ptr(), grid, _stream(x))
    _build.check(err, "histogram_rows")
    return counts


def thresholds_from_counts(counts: torch.Tensor, maxabs_val: torch.Tensor,
                           cum_ks: torch.Tensor) -> torch.Tensor:
    """Per-layer thresholds from the histogram CDF: (C,) f32 from (256,)
    counts, or (M, C) from (M, 256) counts, (M,) maxima and (M, C) budgets.

    Torch ops on 256 scalars a row, on the counts' device with no host
    sync; the same semantics as ``ref.hist_thresholds``."""
    if counts.dim() == 2:
        return ref.hist_thresholds_rows(counts, maxabs_val, cum_ks)
    return ref.hist_thresholds(counts, maxabs_val, cum_ks)
