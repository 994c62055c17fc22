"""Device resolution shared by the port's entry points."""
from __future__ import annotations

import subprocess
import time

import torch

SM_MAX_HZ = 1.98e9     # H100 SXM boost clock: a sleep of N cycles lasts at
                       # least N / SM_MAX_HZ seconds


def resolve_device(device: str | torch.device | None) -> torch.device:
    """``None`` means the card.  There is no silent CPU fallback: without
    CUDA the caller must ask for ``device="cpu"`` explicitly."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the port "
                "on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def upload(x: torch.Tensor, device: str | torch.device) -> torch.Tensor:
    """A small host tensor to ``device`` without waiting for the card:
    pinned memory and an asynchronous copy (a no-op on its own device)."""
    device = torch.device(device)
    if x.device == device:
        return x
    if x.device.type == "cpu" and device.type == "cuda":
        return x.pin_memory().to(device, non_blocking=True)
    return x.to(device)


def card_name_and_power_limit() -> str:
    """The card's name and power limit, as ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader`` gives them (first card)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def device_ms(fn, reps: int = 100, warmup: int = 5) -> float:
    """Device time per call of ``fn`` on the current card: CUDA events
    around ``reps`` back-to-back calls, divided by ``reps``, after warm-up.

    A sleep kernel holds the stream while the host enqueues the calls, so
    they run back to back on the card whatever the host's dispatch rate;
    the hold doubles until it outlasts the enqueue.  An enqueue that ends
    with the hold, twice running, is blocked on the card's full launch
    queue, which no longer hold can outlast: it raises at once."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    hold_ms, blocked = 20.0, 0
    for _ in range(8):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(hold_ms * 1e-3 * SM_MAX_HZ))
        t0 = time.perf_counter()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        end.synchronize()
        if enqueue_ms < 0.5 * hold_ms:
            return start.elapsed_time(end) / reps
        blocked = blocked + 1 if (hold_ms <= enqueue_ms
                                  <= 1.5 * hold_ms + 10.0) else 0
        if blocked == 2:
            break
        hold_ms *= 2
    else:
        hold_ms /= 2
    raise RuntimeError(f"device_ms: a hold of {hold_ms:.0f} ms did not "
                       f"outlast an enqueue of {enqueue_ms:.1f} ms")


PORT_KERNELS = ("maxabs_kernel", "histogram_kernel", "sparsify_ef_kernel",
                "swa_decode_kernel", "maxabs_segments_kernel",
                "histogram_segments_kernel")
GEMM_MARKS = ("gemm", "gemv", "xmma", "cutlass", "cublas", "nvjet")


def kernel_group(name: str) -> str:
    """A device kernel's group: the port's kernel by name, ``matmul`` for
    cuBLAS's, ``other`` for the rest."""
    for k in PORT_KERNELS:
        if k in name:
            return k
    low = name.lower()
    return "matmul" if any(m in low for m in GEMM_MARKS) else "other"


def union_us(intervals: list[tuple[float, float]]) -> float:
    """Length of the union of (start, end) intervals: the time the card was
    busy with at least one kernel."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        busy += e - max(s, end)
        end = e
    return busy
