#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (``src/repro_torch``) on one
NVIDIA H100.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits non-zero:

1. device: the card's name and power limit, the kernels' build from
   ``src/repro_torch/kernels/csrc`` and its time;
2. kernels against their plain torch versions on the card, bitwise, at
   D in {63, 100_003, 28_311_552} and C in {1, 3} with a dropped channel:
   maxabs, histogram, sparsify_ef (and u == g + e'), lgc_compress_hist;
3. a small f32 trainer on the card, kernel backend against the plain backend
   (every leaf through the kernels), to the CPU tests' tolerances;
4. the main path: ``make_task("qwen2_100m", preset="full")`` at full width
   (128,419,584 parameters, bf16) with ``aggregate="dense_masked"`` and the
   CUDA kernels, 3 sync rounds of 2 FL devices; every launch counter must be
   3 rounds x 2 devices x 8 leaves = 48;
5. the ``kernels`` line: each kernel's time (CUDA events, median of 30 after
   warm-up) at the largest leaf and at ``embed``, beside its plain version,
   its bound (bytes over 3.35 TB/s) and one PyTorch call as a yardstick;
   the TPU kernels not ported yet are listed under ``not_ported``;
6. the last line: ``{"ok": true, "device": {...}}``.

It imports nothing of JAX or of the JAX package ``repro``.
"""
from __future__ import annotations

import json
import math
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory rate (data sheet)
F32_OPS_PER_S = 67e12            # H100 SXM f32 rate outside the tensor cores
LARGEST_LEAF = 28_311_552        # blocks/mlp/w_* of qwen2_100m: 12 x 768 x 3072
EMBED = 24_576_000               # embed of qwen2_100m: 32000 x 768
N_KERNEL_LEAVES = 8
ROUNDS, M_DEVICES = 3, 2

TPU_KERNELS = {
    "maxabs": ("src/repro_torch/kernels/csrc/maxabs.cu",
               "src/repro/kernels/topk_threshold.py:32"),
    "histogram": ("src/repro_torch/kernels/csrc/histogram.cu",
                  "src/repro/kernels/topk_threshold.py:42"),
    "sparsify_ef": ("src/repro_torch/kernels/csrc/sparsify_ef.cu",
                    "src/repro/kernels/layered_sparsify.py:32"),
}
NOT_PORTED = {"swa_decode": "src/repro/kernels/swa_attention.py:23"}


def log(msg: str) -> None:
    print(msg, flush=True)


def bits_equal(a, b) -> bool:
    import torch
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def max_abs_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(f"chip_smoke: {what}")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def phase_kernels(gen, errs: dict) -> None:
    import torch
    from repro_torch.kernels import (histogram, lgc_compress_hist, maxabs,
                                     ref, sparsify_ef)
    for n in (63, 100_003, LARGEST_LEAF):
        x = torch.randn(n, generator=gen, device="cuda") * 1e-3
        e = torch.randn(n, generator=gen, device="cuda") * 1e-4
        u = e + x
        views = [("aligned", u), ("offset", u[1:])] if n > 63 else [("", u)]
        for tag, v in views:
            m = maxabs(v)
            m_ref = ref.hist_maxabs(v).reshape(1, 1)
            check(bits_equal(m, m_ref), f"maxabs D={n} {tag}")
            c = histogram(v, m)
            c_ref = ref.hist_counts(v, m)
            check(bits_equal(c, c_ref) and int(c.sum()) == v.numel(),
                  f"histogram D={n} {tag}")
            errs["maxabs"] = max(errs["maxabs"], max_abs_err(m, m_ref))
            errs["histogram"] = max(errs["histogram"], max_abs_err(c, c_ref))
        m = maxabs(u)
        counts = histogram(u, m)
        for recv_list in ([1], [0], [1, 0, 1]):
            c_n = len(recv_list)
            recv = torch.tensor(recv_list, dtype=torch.int32, device="cuda")
            k0 = max(1, n // 100)
            cum = torch.tensor([k0 * (i + 1) for i in range(c_n)],
                               dtype=torch.int32, device="cuda")
            thr = ref.hist_thresholds(counts, m, cum)
            g, e_new = sparsify_ef(e, x, thr, recv)
            g_ref, e_ref = ref.hist_layered_sparsify(e + x, thr, recv)
            check(bits_equal(g, g_ref) and bits_equal(e_new, e_ref),
                  f"sparsify_ef D={n} recv={recv_list}")
            check(bits_equal(g + e_new, u), f"u == g + e' D={n}")
            errs["sparsify_ef"] = max(errs["sparsify_ef"],
                                      max_abs_err(g, g_ref),
                                      max_abs_err(e_new, e_ref))
            g2, e2 = lgc_compress_hist(e, x, cum, recv)
            g2_ref, e2_ref = ref.hist_lgc_compress(e, x, cum, recv)
            check(bits_equal(g2, g2_ref) and bits_equal(e2, e2_ref),
                  f"lgc_compress_hist D={n} recv={recv_list}")
            sent = int((g2 != 0).sum())
            log(f"kernels D={n} C={c_n} recv={recv_list}: bitwise equal to "
                f"the plain versions, {sent} coordinates sent")
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# phase 3: small trainer, kernel backend against the plain backend
# ---------------------------------------------------------------------------

def phase_small_trainer() -> None:
    import dataclasses
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.paper_models import make_task
    arch = dataclasses.replace(get_smoke_config("qwen2-100m"),
                               dtype=torch.float32)
    runs = {}
    for backend in ("exact", "cuda"):
        t = make_task("qwen2_100m", m_devices=2, arch=arch,
                      aggregate="dense_masked", sparsity=(0.05, 0.1, 0.1),
                      backend=backend, pallas_min_elems=1, seq=32,
                      device="cuda")
        out = t.run(3)
        runs[backend] = (out["losses"], t._built["params"], t._built["ef"])
    (l0, p0, e0), (l1, p1, e1) = runs["exact"], runs["cuda"]
    check(all(math.isclose(a, b, rel_tol=1e-5) for a, b in zip(l0, l1)),
          f"small trainer losses {l0} vs {l1}")
    worst, bitwise = 0.0, True
    for tree0, tree1 in ((p0, p1), (e0, e1)):
        for k in tree0:
            a, b = tree0[k], tree1[k]
            bitwise &= bits_equal(a, b)
            off = ~torch.isclose(b, a, rtol=1e-5, atol=1e-6)
            worst = max(worst, float(off.float().mean()))
    check(worst <= 1e-3, f"small trainer: {worst:.2%} of a leaf differs")
    log(f"small f32 trainer on the card (smoke config, 3 rounds, M=2, every "
        f"leaf through the kernels): losses {l1} match the plain backend; "
        f"params and EF bitwise equal: {bitwise}; worst leaf share off "
        f"tolerance {worst:.2e}")


# ---------------------------------------------------------------------------
# phase 4: the main path at full width
# ---------------------------------------------------------------------------

def phase_main_path() -> dict:
    import torch
    from repro_torch.kernels import LAUNCHES, reset_launch_counts
    from repro_torch.models import transformer as tf
    from repro_torch.models.paper_models import make_task
    task = make_task("qwen2_100m", m_devices=M_DEVICES, preset="full",
                     aggregate="dense_masked", backend="cuda")
    n_params = task.param_count()
    check(n_params == 128_419_584, f"param_count {n_params}")
    b = task.build()
    kernel_leaves = [k for k, v in b["params"].items()
                     if v.numel() >= task.step_cfg.pallas_min_elems]
    check(len(kernel_leaves) == N_KERNEL_LEAVES, f"kernel leaves "
          f"{kernel_leaves}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    out = task.run(ROUNDS)
    torch.cuda.synchronize()
    counts = dict(LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = out["losses"]
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    params, ef = b["params"], b["ef"]
    shapes = {k: v.shape for k, v in
              tf.init_params(task.arch, device="meta").items()}
    for k, v in params.items():
        check(v.dtype == torch.bfloat16 and bool(torch.isfinite(v).all()),
              f"param {k}")
        check(ef[k].shape == (M_DEVICES,) + tuple(shapes[k])
              and bool(torch.isfinite(ef[k]).all()), f"ef {k}")
    want = ROUNDS * M_DEVICES * N_KERNEL_LEAVES
    for name, c in counts.items():
        check(c == want, f"{name} launched {c} times on the main path, "
              f"expected {want}")
    log(f"main path: qwen2_100m full width, {n_params:,} params (bf16), "
        f"M={M_DEVICES}, H={task.step_cfg.local_steps}, sparsity "
        f"{task.step_cfg.sparsity}, seq {task.seq}, {ROUNDS} rounds")
    log(f"main path: losses {losses}")
    log(f"main path: wire bytes/round/device "
        f"{out['wire_bytes_per_round_per_device']:,}; device-steps/s "
        f"{out['device_steps_per_s']:.3f} (rounds 2-{ROUNDS}); peak device "
        f"memory {peak_gib:.2f} GiB")
    log(f"main path: kernel launches {counts} (want {want} each)")
    return counts


# ---------------------------------------------------------------------------
# phase 5: timings
# ---------------------------------------------------------------------------

def time_ms(fn, reps: int = 30, warmup: int = 5) -> float:
    """Median over ``reps`` single calls, each between two CUDA events."""
    import torch
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


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_timings(gen) -> dict:
    import torch
    from repro_torch.kernels import histogram, maxabs, ref, sparsify_ef
    rows: dict = {}
    c_n = 3
    recv = torch.tensor([1, 1, 1], dtype=torch.int32, device="cuda")
    for n in (LARGEST_LEAF, EMBED):
        x = torch.randn(n, generator=gen, device="cuda") * 1e-3
        e = torch.randn(n, generator=gen, device="cuda") * 1e-4
        u = e + x
        a = u.abs()
        m = maxabs(u)
        m_host = float(m)
        counts = histogram(u, m)
        cum = torch.tensor([n // 100, 3 * n // 100, 5 * n // 100],
                           dtype=torch.int32, device="cuda")
        thr = ref.hist_thresholds(counts, m, cum)
        inf = float("inf")
        cases = {
            "maxabs": (lambda: maxabs(u), lambda: ref.hist_maxabs(u),
                       lambda: torch.linalg.vector_norm(u, inf),
                       4 * n + 4, n),
            "histogram": (lambda: histogram(u, m),
                          lambda: ref.hist_counts(u, m),
                          lambda: torch.histc(a, bins=256, min=0.0,
                                              max=m_host),
                          4 * n + 4 + 4 * 256, 3 * n),
            "sparsify_ef": (lambda: sparsify_ef(e, x, thr, recv),
                            lambda: ref.hist_layered_sparsify(e + x, thr,
                                                              recv),
                            None, 16 * n + 8 * c_n, (2 + 4 * c_n) * n),
        }
        for name, (kern, plain, lib, n_bytes, n_ops) in cases.items():
            bnd, by = bound_ms(n_bytes, n_ops)
            row = {"n": n, "ms": time_ms(kern), "plain_ms": time_ms(plain),
                   "library_ms": time_ms(lib) if lib else None,
                   "bound_ms": bnd, "bound_by": by}
            rows.setdefault(name, {})[n] = row
            log(f"timing {name} D={n}: kernel {row['ms']:.4f} ms, plain "
                f"{row['plain_ms']:.4f} ms, library "
                f"{row['library_ms'] if lib else None} ms, bound "
                f"{bnd:.4f} ms ({by})")
    return rows


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs one "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    # parity runs keep TF32 off (the defaults for matmul, set explicitly)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(smi)                      # the card's name and power limit
    log(f"device: {kind}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} card(s)")
    t0 = time.perf_counter()
    so = _build.build()
    log(f"build: {so.name} in {time.perf_counter() - t0:.1f} s "
        f"({'cached' if not _build.build_log else 'compiled'})")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = {k: 0.0 for k in TPU_KERNELS}
    phase_kernels(gen, errs)
    phase_small_trainer()
    launches = phase_main_path()
    rows = phase_timings(gen)

    kernels = []
    for name, (source, replaces) in TPU_KERNELS.items():
        big = rows[name][LARGEST_LEAF]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": launches[name], "max_abs_err": errs[name],
            "ms": big["ms"], "plain_ms": big["plain_ms"],
            "bound_ms": big["bound_ms"], "bound_by": big["bound_by"],
            "library_ms": big["library_ms"], "n": LARGEST_LEAF,
            "at_embed": rows[name][EMBED]})
    not_ported = [{"name": name, "replaces": replaces, "ported": False}
                  for name, replaces in NOT_PORTED.items()]
    print(json.dumps({"kernels": kernels, "not_ported": not_ported}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
