"""Where a sync round of the qwen2_100m LGC trainer spends the card's time.

    python -m repro_torch.launch.profile_trainer [--m-devices 2] [--rounds 5]

Builds ``make_task("qwen2_100m", preset="full", aggregate="dense_masked",
backend="cuda")`` on the card, times ``--rounds`` rounds after one warm-up
round (host clock around each round; a round ends in a device sync), then
runs one more round under ``torch.profiler`` and sums the device time of
its kernels by group: the three LGC compression kernels, matrix products
(cuBLAS), and everything else, and lists the kernels that took the most
device time.  The device's idle share is one minus the union of
kernel intervals over the profiled round's wall time (and, since the
profiler slows the host and not the card, over the median unprofiled
round).  Prints one JSON
line; it needs a card and fails without one.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import torch

from repro_torch.kernels import LAUNCHES, reset_launch_counts
from repro_torch.models.paper_models import make_task

LGC_KERNELS = ("maxabs_kernel", "histogram_kernel", "sparsify_ef_kernel")
GEMM_MARKS = ("gemm", "xmma", "cutlass", "cublas", "nvjet")


def _group(name: str) -> str:
    for k in LGC_KERNELS:
        if k in name:
            return k
    low = name.lower()
    return "matmul" if any(m in low for m in GEMM_MARKS) else "other"


def _union_us(intervals: list[tuple[float, float]]) -> float:
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        busy += e - max(s, end)
        end = e
    return busy


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--m-devices", type=int, default=2)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_trainer needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    task = make_task("qwen2_100m", m_devices=args.m_devices, seed=args.seed,
                     preset="full", aggregate="dense_masked", backend="cuda")
    task.run(1)                                   # build + first-call set-up
    round_s = []
    for _ in range(args.rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        task.run(1)                               # ends in float(loss)
        round_s.append(time.perf_counter() - t0)

    reset_launch_counts()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        task.run(1)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_group: dict[str, float] = {}
    by_name: dict[str, list] = {}
    for e in kernels:
        us = e.time_range.elapsed_us()
        g = _group(e.name)
        by_group[g] = by_group.get(g, 0.0) + us
        row = by_name.setdefault(e.name[:80], [0.0, 0])
        row[0] += us
        row[1] += 1
    busy_us = _union_us([(e.time_range.start, e.time_range.end)
                         for e in kernels])
    out = {
        "card": card,
        "device": torch.cuda.get_device_name(0),
        "m_devices": args.m_devices,
        "local_steps": task.step_cfg.local_steps,
        "round_ms_median": statistics.median(round_s) * 1e3,
        "round_ms_all": [x * 1e3 for x in round_s],
        "profiled_round_ms": wall_us / 1e3,
        "device_busy_ms": busy_us / 1e3,
        "device_idle_share": (1.0 - busy_us / wall_us) if kernels else None,
        # the profiler slows the host, not the card: the same busy time
        # over an unprofiled round
        "device_idle_share_unprofiled": 1.0 - busy_us / 1e3 / (
            statistics.median(round_s) * 1e3),
        "kernel_ms_by_group": {k: v / 1e3 for k, v in sorted(by_group.items())},
        "top_kernels": [
            {"name": k, "ms": v[0] / 1e3, "count": v[1]}
            for k, v in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]],
        "kernel_launches": len(kernels),
        "lgc_launches": dict(LAUNCHES),
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
