"""Magnitude statistics for histogram-Top_k selection: two CUDA kernels and
the thresholds.

Port of ``repro/kernels/topk_threshold.py:32-116``:

  pass 1: ``maxabs``    -- CUDA kernel, csrc/maxabs.cu (``sum_maxabs``: the
                           same kernel forming u = e + delta on the way)
  pass 2: ``histogram`` -- CUDA kernel, csrc/histogram.cu
  then  : ``thresholds_from_counts`` -- torch ops on 256 counts, on the device

and their (M, D) row forms, one row per simulated device or per row of a
leaf's model-dim view, each one launch over all rows (the reference
reaches its kernels through ``jax.vmap`` there,
``repro/core/fl_batched.py:201-209``): ``sum_maxabs_rows``,
``maxabs_rows``, ``histogram_rows`` and ``thresholds_from_counts`` on
(M, 256) counts.  Each row of a launch gets the bits of a flat launch on
it.  A row launch takes one of two forms (:func:`row_form`): the wide one,
the flat kernel with a row on each ``blockIdx.y`` (a few long rows, at
most 65,535), or the short one, a warp a row on a persistent grid (many
short rows, any number of them).

The segmented forms, ``maxabs_segments`` and ``histogram_segments``, take
every model-layer slice of every row in one launch (the per-layer budgets,
where the reference calls ``maxabs`` and ``histogram`` once per slice,
``repro/core/compressor.py:363-364``), through a :class:`SegmentTable`
built once per slicing.

A wrapper checks its inputs, allocates the outputs, launches on the current
stream and raises if the launch failed.  For a CPU tensor it calls the plain
version in :mod:`repro_torch.kernels.ref`; for a CUDA tensor it launches the
kernel or raises -- there is no fallback.  Results are bitwise equal to the
plain versions (chip_smoke.py on the card, tests/test_torch_kernels.py).
"""
from __future__ import annotations

import contextlib
import itertools

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

_SEG_PER_BLOCK = _THREADS * _HIST_LOADS * 4     # floats of a segment block's pass

_MAX_ROWS = 65535              # the grid's y extent, one row a step
_WARPS = _THREADS // 32        # rows a block of the short form holds at once
# resident blocks a SM of the short forms (``kShortBlocksPerSM`` of
# maxabs.cu and histogram.cu, their ``__launch_bounds__``)
_SHORT_BLOCKS_PER_SM = {"maxabs": 3, "histogram": 4}
# The longest row that takes the short form once the rows are many (8 or
# more for every SM): the crossover of the two forms, measured at 2**26
# floats of rows (256 MB of u) by the sweep of ``chip_smoke.py --rows``
# (H100 80GB HBM3, 700.00 W).  Device ms short / wide at n = 68, 768,
# 1,536, 3,072, 9,216 and 65,536 (1,024 rows; at 68 and 768 the wide form
# in launches of 65,535 rows):
#   sum_maxabs_rows  0.455 / 4.770, 0.280 / 0.541, 0.280 / 0.382,
#                    0.281 / 0.306, 0.283 / 0.280, 0.281 / 0.283
#   histogram_rows   0.517 / 5.304, 0.127 / 0.508, 0.112 / 0.301,
#                    0.104 / 0.192, 0.096 / 0.106, 0.142 / 0.106
# Each is the largest n of the sweep where the short form was faster
# (maxabs ties within 1% from 9,216 on; histogram loses at 65,536).
SHORT_ROW_MAX_N = {"maxabs": 3_072, "histogram": 9_216}
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


def _check_rows(x: torch.Tensor, name: str, dtype=torch.float32,
                max_rows: int | None = _MAX_ROWS) -> None:
    """x must be contiguous (M, D) of ``dtype``, M at most ``max_rows``
    (None: any M; the kernels with a row on each ``blockIdx.y`` take
    65,535)."""
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if x.dim() != 2 or x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"{name} must be (M, D) with M, D >= 1, got shape "
                         f"{tuple(x.shape)}")
    if max_rows is not None and x.shape[0] > max_rows:
        raise ValueError(f"{name} has {x.shape[0]} rows; this kernel puts a "
                         f"row on each blockIdx.y and takes at most "
                         f"{max_rows}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def rows_grid(rows: int, n: int, per_block: int, target: int) -> int:
    """Blocks per row of a row kernel over (rows, n): enough for one pass of
    ``per_block`` floats a block, at most ``target // rows`` (the flat
    kernel's grid shared by the rows), at least one."""
    return max(1, min(-(-n // per_block), target // rows))


def _form_grid(form: str, rows: int, n: int, sms: int, kernel: str) -> int:
    """The grid of a row launch of ``kernel`` in ``form``: short, the
    blocks of its persistent grid; wide, the blocks of each row."""
    if form == "short":
        return min(-(-rows // _WARPS), _SHORT_BLOCKS_PER_SM[kernel] * sms)
    loads, per_sm = ((_MAXABS_LOADS, _MAXABS_BLOCKS_PER_SM)
                     if kernel == "maxabs" else
                     (_HIST_LOADS, _HIST_BLOCKS_PER_SM))
    return rows_grid(rows, n, _THREADS * loads * 4, per_sm * sms)


def row_form(rows: int, n: int, sms: int, kernel: str) -> tuple[str, int]:
    """The form of a row launch of ``kernel`` ("maxabs" or "histogram")
    over (rows, n) on a card of ``sms`` SMs, and its grid.

    "short" (a warp a row on a persistent grid of at most the resident
    blocks) where the rows are many -- at least 8 for every SM, a row for
    every warp of a block a SM -- and at most ``SHORT_ROW_MAX_N`` long, and
    beyond 65,535 rows, which the wide form cannot take.  Otherwise "wide"
    (the flat kernel with a row on each ``blockIdx.y``).  A flat vector is
    one row: always wide."""
    short = rows > _MAX_ROWS or (rows >= _WARPS * sms
                                 and n <= SHORT_ROW_MAX_N[kernel])
    form = "short" if short else "wide"
    return form, _form_grid(form, rows, n, sms, kernel)


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


def _maxabs_rows_launch(x: torch.Tensor, d: torch.Tensor | None,
                       u: torch.Tensor | None, form: str | None = None
                       ) -> torch.Tensor:
    """One launch of the maxabs kernel over the rows of x (with d: of u =
    x + d, written to u), in ``form`` (None: :func:`row_form`'s).  Returns
    (M,) f32."""
    rows, n = x.shape
    sms = _sm_count(x.device)
    form = form or row_form(rows, n, sms, "maxabs")[0]
    grid = _form_grid(form, rows, n, sms, "maxabs")
    out = torch.empty(rows, dtype=torch.float32, device=x.device)
    dp = None if d is None else d.data_ptr()
    up = None if u is None else u.data_ptr()
    with _on_device(x):
        if form == "short":
            err = _build.lib().lgc_maxabs_short(
                x.data_ptr(), dp, up, rows, n, out.data_ptr(), grid,
                _stream(x))
        else:
            partials = torch.empty(rows * grid, dtype=torch.int32,
                                   device=x.device)
            counters = _zeroed_counters("maxabs_rows", x.device, rows)
            err = _build.lib().lgc_maxabs(
                x.data_ptr(), dp, up, rows, n, out.data_ptr(),
                partials.data_ptr(), counters.data_ptr(), grid, _stream(x))
    _build.check(err, "maxabs_rows")
    return out


def sum_maxabs_rows(e: torch.Tensor, delta: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`sum_maxabs` of each row: u = e + delta (flushed) and max |u|
    of each row, over (M, D) rows in one launch (any M).  Returns u (M, D)
    f32 and (M,) f32."""
    _check_rows(e, "e", max_rows=None)
    _check_rows(delta, "delta", max_rows=None)
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
    return u, _maxabs_rows_launch(e, delta, u)


def maxabs_rows(x: torch.Tensor) -> torch.Tensor:
    """:func:`maxabs` of each row of x (M, D), in one launch (any M): the
    reference's ``jax.vmap(maxabs)``.  Returns (M,) f32."""
    _check_rows(x, "x", max_rows=None)
    _check_same_device(x)
    if x.device.type == "cpu":
        return ref.hist_maxabs_rows(x)
    return _maxabs_rows_launch(x, None, None)


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


def _histogram_rows_launch(x: torch.Tensor, maxabs_val: torch.Tensor,
                          form: str | None = None) -> torch.Tensor:
    """One launch of the histogram kernel over the rows of x against
    maxabs_val (M,), in ``form`` (None: :func:`row_form`'s).  Returns
    (M, 256) int32."""
    rows, n = x.shape
    sms = _sm_count(x.device)
    form = form or row_form(rows, n, sms, "histogram")[0]
    grid = _form_grid(form, rows, n, sms, "histogram")
    m = maxabs_val.reshape(rows).contiguous()
    counts = torch.empty((rows, N_BINS), dtype=torch.int32, device=x.device)
    with _on_device(x):
        if form == "short":
            err = _build.lib().lgc_histogram_short(
                x.data_ptr(), rows, n, m.data_ptr(), counts.data_ptr(), grid,
                _stream(x))
        else:
            acc = _zeroed_counters("histogram_rows", x.device,
                                   rows * (N_BINS + 1))
            err = _build.lib().lgc_histogram(
                x.data_ptr(), rows, n, m.data_ptr(), counts.data_ptr(),
                acc.data_ptr(), grid, _stream(x))
    _build.check(err, "histogram_rows")
    return counts


def histogram_rows(x: torch.Tensor, maxabs_val: torch.Tensor
                   ) -> torch.Tensor:
    """:func:`histogram` of each row of x (M, D) over [0, maxabs_val[r]],
    in one launch (any M).  Returns (M, 256) int32."""
    _check_rows(x, "x", max_rows=None)
    rows = x.shape[0]
    if maxabs_val.numel() != rows or maxabs_val.dtype != torch.float32:
        raise ValueError(f"maxabs_val must be {rows} f32 values")
    _check_same_device(x, maxabs_val)
    if x.device.type == "cpu":
        return ref.hist_counts_rows(x, maxabs_val)
    return _histogram_rows_launch(x, maxabs_val)


# ---------------------------------------------------------------------------
# segmented forms: every model-layer slice of every row in one launch
# ---------------------------------------------------------------------------

class SegmentTable:
    """The model-layer slices of a flat vector as the segmented kernels take
    them: the L + 1 slice edges ``offsets`` (host ints, from 0 to D) and, on
    ``device``, ``sizes`` (L,) int32 and ``ids`` (D,) int64, each
    coordinate's slice.  On a card also the launch table: the edges as int64
    (``edges``) and, as int32 (``table``), the first block of each slice (L +
    1 ints) followed by the block -> slice map of the ``n_blocks`` blocks of
    the grid's x axis.  A slice gets ceil(length / 4096) blocks, at least one
    and at most the flat histogram's grid.

    The slices of a model never change, so a simulator builds its table once
    and every launch reads it with no host work (nothing is copied to the
    card inside a sync)."""

    def __init__(self, offsets, device: str | torch.device):
        offs = [int(o) for o in offsets]
        if len(offs) < 2 or offs[0] != 0 or any(
                hi <= lo for lo, hi in zip(offs, offs[1:])):
            raise ValueError(f"slice edges must rise strictly from 0, got "
                             f"{offs}")
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.offsets = tuple(offs)
        self.device = device
        sizes = [hi - lo for lo, hi in zip(offs, offs[1:])]
        self.sizes = torch.tensor(sizes, dtype=torch.int32, device=device)
        self.ids = torch.repeat_interleave(
            torch.arange(len(sizes)), torch.tensor(sizes)).to(device)
        self.n_blocks = 0
        if device.type == "cuda":
            cap = _HIST_BLOCKS_PER_SM * _sm_count(device)
            per_slice = [max(1, min(-(-n // _SEG_PER_BLOCK), cap))
                         for n in sizes]
            first = [0, *itertools.accumulate(per_slice)]
            block_slice = [s for s, k in enumerate(per_slice)
                           for _ in range(k)]
            self.n_blocks = first[-1]
            self.edges = torch.tensor(offs, dtype=torch.int64, device=device)
            self.table = torch.tensor(first + block_slice, dtype=torch.int32,
                                      device=device)

    @property
    def n_slices(self) -> int:
        return len(self.offsets) - 1

    @property
    def spans(self) -> list[tuple[int, int]]:
        """The slices as half-open (lo, hi) pairs."""
        return list(zip(self.offsets[:-1], self.offsets[1:]))


def _check_segments(u: torch.Tensor, seg: SegmentTable) -> None:
    """``seg`` must be a :class:`SegmentTable` on u's device that tiles
    u's rows."""
    if not isinstance(seg, SegmentTable):
        raise TypeError(f"segments must be a SegmentTable, got "
                        f"{type(seg).__name__}")
    if seg.offsets[-1] != u.shape[1]:
        raise ValueError(f"slices cover {seg.offsets[-1]} floats; u has "
                         f"{u.shape[1]} a row")
    if seg.device != u.device:
        raise ValueError(f"segment table on {seg.device}, u on {u.device}")


def maxabs_segments(u: torch.Tensor, seg: SegmentTable) -> torch.Tensor:
    """max |u| of every model-layer slice of ``seg`` of every row of u
    (M, D), in one launch (a subnormal |u| counts as 0).  Returns (M, L)
    f32."""
    _check_rows(u, "u")
    _check_same_device(u)
    _check_segments(u, seg)
    if u.device.type == "cpu":
        return ref.hist_maxabs_segments(u, seg.offsets)
    rows, n = u.shape
    out = torch.empty((rows, seg.n_slices), dtype=torch.float32,
                      device=u.device)
    partials = torch.empty(rows * seg.n_blocks, dtype=torch.int32,
                           device=u.device)
    counters = _zeroed_counters("maxabs_segments", u.device,
                                rows * seg.n_slices)
    with _on_device(u):
        err = _build.lib().lgc_maxabs_segments(
            u.data_ptr(), rows, n, seg.edges.data_ptr(), seg.table.data_ptr(),
            seg.n_slices, seg.n_blocks, out.data_ptr(), partials.data_ptr(),
            counters.data_ptr(), _stream(u))
    _build.check(err, "maxabs_segments")
    return out


def histogram_segments(u: torch.Tensor, maxabs_val: torch.Tensor,
                       seg: SegmentTable) -> torch.Tensor:
    """The 256-bin |u| histogram of every model-layer slice of every row of
    u (M, D), each over [0, maxabs_val[r, l]], in one launch.  Returns
    (M, L, 256) int32."""
    _check_rows(u, "u")
    _check_segments(u, seg)
    rows = u.shape[0]
    if (maxabs_val.shape != (rows, seg.n_slices)
            or maxabs_val.dtype != torch.float32):
        raise ValueError(f"maxabs_val must be ({rows}, {seg.n_slices}) f32")
    _check_same_device(u, maxabs_val)
    if u.device.type == "cpu":
        return ref.hist_counts_segments(u, maxabs_val, seg.offsets)
    m = maxabs_val.contiguous()
    counts = torch.empty((rows, seg.n_slices, N_BINS), dtype=torch.int32,
                         device=u.device)
    acc = _zeroed_counters("histogram_segments", u.device,
                           rows * seg.n_slices * (N_BINS + 1))
    with _on_device(u):
        err = _build.lib().lgc_histogram_segments(
            u.data_ptr(), rows, u.shape[1], seg.edges.data_ptr(),
            seg.table.data_ptr(), seg.n_slices, seg.n_blocks, m.data_ptr(),
            counts.data_ptr(), acc.data_ptr(), _stream(u))
    _build.check(err, "histogram_segments")
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
