"""Time the ``histogram`` CUDA kernel on the four inputs that decide its
design, beside ``torch.histc`` and its bytes bound.

    python -m repro_torch.launch.bench_histogram [--blocks-per-sm 2,4,6,8]
        [--seed 0] [--label NAME]

The inputs, each with m = maxabs of it:

* ``gaussian``: u = e + x at the largest leaf of qwen2_100m (28,311,552
  floats), x ~ N(0, 1e-3^2) and e ~ N(0, 1e-4^2), as ``chip_smoke.py`` times it;
* ``embed``: the same at the size of ``embed`` (24,576,000 floats);
* ``main_path_u``: the real u = e + delta of the largest leaf in round 2 of
  ``make_task("qwen2_100m", preset="full", aggregate="dense_masked",
  backend="cuda")`` with M=2, taken by wrapping the train step's
  ``lgc_compress_hist_rows`` for that one call (device 0's row);
* ``one_bin``: a constant vector of the largest leaf's size, every element in
  bin 255 (the most contention the data can put on one bin).

For each it prints, in one JSON line with the card's name and power limit:
the wrapper's single-call time (``ms``, the median of calls each between two
CUDA events, host code included) and its device time per call
(``repro_torch.device.device_ms``), the same two for ``torch.histc``, the
bytes bound (4n + 4 + 1024 B over 3.35 TB/s), whether the counts equal the
plain version's, and with ``--blocks-per-sm`` the device time of the kernel's
C entry point at each grid of that many blocks per SM (beyond the kernel's
occupancy the blocks run in more than one wave).  It needs the card.

The script uses only the package's public kernels, ``device.device_ms`` and
the task, so with another checkout's ``src`` first on ``PYTHONPATH`` and
``--blocks-per-sm ''`` it times that checkout's kernel on the same inputs.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import statistics

import torch

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory rate (data sheet)
LARGEST_LEAF = 28_311_552        # blocks/mlp/w_* of qwen2_100m: 12 x 768 x 3072
EMBED = 24_576_000               # embed of qwen2_100m: 32000 x 768
M_DEVICES, KERNEL_LEAVES = 2, 8  # the main path's FL devices and kernel leaves


@contextlib.contextmanager
def capture_leaf_inputs(n: int, first_call: int):
    """Keep copies of device 0's (e, delta) of the first call of the train
    step's ``lgc_compress_hist_rows`` on an n-element leaf at or after call
    number ``first_call`` (counting every call from 0, one per leaf and
    round); yields the list they go in.  The wrapped call runs as it would:
    no launch is added."""
    from repro_torch.launch import steps
    orig = steps.lgc_compress_hist_rows
    kept: list = []
    calls = iter(range(1 << 30))

    def wrapped(e, delta, cum_ks, received):
        if next(calls) >= first_call and e.shape[1] == n and not kept:
            kept.append((e[0].clone(), delta[0].clone()))
        return orig(e, delta, cum_ks, received)

    steps.lgc_compress_hist_rows = wrapped
    try:
        yield kept
    finally:
        steps.lgc_compress_hist_rows = orig


def main_path_u(rounds: int = 2) -> torch.Tensor:
    """u = e + delta of the largest leaf in round ``rounds`` of the main path."""
    from repro_torch.models.paper_models import make_task
    task = make_task("qwen2_100m", m_devices=M_DEVICES, preset="full",
                     aggregate="dense_masked", backend="cuda")
    with capture_leaf_inputs(LARGEST_LEAF,
                             (rounds - 1) * KERNEL_LEAVES) as kept:
        task.run(rounds)
    (e, delta), = kept
    return e + delta


def inputs(seed: int) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(seed)
    out = {}
    for name, n in (("gaussian", LARGEST_LEAF), ("embed", EMBED)):
        x = torch.randn(n, generator=gen, device="cuda") * 1e-3
        e = torch.randn(n, generator=gen, device="cuda") * 1e-4
        out[name] = e + x
    out["main_path_u"] = main_path_u()
    out["one_bin"] = torch.full((LARGEST_LEAF,), 1e-3, device="cuda")
    return out


def time_ms(fn, reps: int = 30, warmup: int = 5) -> float:
    """Median over ``reps`` single calls, each between two CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def histogram_bound_ms(n: int) -> float:
    """Read n floats and m, write 256 counts, over the memory rate."""
    return (4 * n + 4 + 4 * 256) / HBM_BYTES_PER_S * 1e3


def time_histogram(u: torch.Tensor, blocks_per_sm: list[int]) -> dict:
    from repro_torch.device import device_ms
    from repro_torch.kernels import histogram, maxabs, ref
    m = maxabs(u)
    m_host = float(m)
    a = u.abs()
    want = ref.hist_counts(u, m)

    def kern():
        return histogram(u, m)

    def lib():
        return torch.histc(a, bins=256, min=0.0, max=m_host)
    row = {"n": u.numel(), "bound_ms": histogram_bound_ms(u.numel()),
           "equal": bool(torch.equal(kern(), want)),
           "ms": time_ms(kern), "device_ms": device_ms(kern),
           "library_ms": time_ms(lib), "library_device_ms": device_ms(lib)}
    if blocks_per_sm:
        row["by_blocks_per_sm"] = sweep_grid(u, m, want, blocks_per_sm)
    return row


def sweep_grid(u: torch.Tensor, m: torch.Tensor, want: torch.Tensor,
               blocks_per_sm: list[int]) -> dict:
    """Device time of the kernel's C entry point at other grids."""
    from repro_torch.device import device_ms
    from repro_torch.kernels import _build
    from repro_torch.kernels.topk_threshold import _sm_count, _zeroed_counters
    lib = _build.lib()
    need = -(-u.numel() // (256 * 4 * 4))      # blocks of one pass each
    acc = _zeroed_counters("histogram", u.device, 257)
    stream = torch.cuda.current_stream().cuda_stream
    rows = {}
    for bps in blocks_per_sm:
        grid = min(need, bps * _sm_count(u.device))

        def run(grid=grid):
            counts = torch.empty(256, dtype=torch.int32, device=u.device)
            _build.check(lib.lgc_histogram(u.data_ptr(), 1, u.numel(),
                                           m.data_ptr(), counts.data_ptr(),
                                           acc.data_ptr(), grid, stream),
                         "histogram")
            return counts
        rows[bps] = {"grid": grid, "equal": bool(torch.equal(run(), want)),
                     "device_ms": device_ms(run)}
    return rows


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--blocks-per-sm", default="2,4,6,8",
                    help="grids to sweep, in blocks per SM ('' for none)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_histogram times the CUDA kernel: it needs a "
                         "card")
    from repro_torch.device import card_name_and_power_limit
    bps = [int(b) for b in args.blocks_per_sm.split(",") if b]
    rows = {name: time_histogram(u, bps)
            for name, u in inputs(args.seed).items()}
    result = {"label": args.label, "card": card_name_and_power_limit(),
              "inputs": rows}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
