"""The population layer on the card: every EF store over 100,000 devices.

    python -m repro_torch.launch.bench_population [--n-devices 100000]
        [--m-cohort 64] [--rounds 24]

The port's counterpart of ``benchmarks/bench_population.py``: the same
sampled-cohort workload (:func:`repro_torch.core.population.run_population`,
batched blocking, uniform sampler, H = 4, ``backend="cuda"``) once per
store (``dense``, ``int8``, ``server``), at the
reference bench's configuration (``population``: the synthetic population
task, 8 shards of 2,048 samples, D = 68) and at ``lr_mnist`` (8 shards of
the factory's 6,000 samples, D = 7,850: the dense store takes 3.14 GB on
the card).  Each (configuration, store) runs once to warm up, once timed
and once under ``torch.profiler``, each from a fresh population, and
prints one JSON line:

* ``ef_bytes`` (the store's exact footprint) and the card's peak memory;
* host ms per window, in total and by phase (``cohort``: the draw on the
  host; ``gather``: the ids' upload, the EF rows and carries; ``window``:
  the device phase and the server step, enqueued; ``scatter``;
  ``accounting``: the host spend), from the timed run;
* device-steps/s (M x rounds over the timed run's wall time);
* the card's busy ms per window (the union of kernel intervals in the
  profiled run) and its idle share against the timed run;
* final loss and accuracy, the card's name and power limit.

It needs a card and fails without one.
"""
from __future__ import annotations

import argparse
import json
import statistics
import time

import torch

from repro_torch.core import FLConfig
from repro_torch.core.population import (make_population,
                                         make_population_task,
                                         run_population)
from repro_torch.device import card_name_and_power_limit, union_us
from repro_torch.models.paper_models import make_task

H = 4
N_SHARDS = 8
CONFIGS = ("population", "lr_mnist")
STORES = ("dense", "int8", "server")


def make_config(name: str):
    """The task of a configuration: ``population`` (the reference bench's,
    ``benchmarks/bench_population.py:30``) or ``lr_mnist``."""
    if name == "population":
        return make_population_task(n_shards=N_SHARDS, n_train=2048, seed=0)
    return make_task(name, m_devices=N_SHARDS)


def bench(config: str, store: str, n: int, m: int, rounds: int) -> dict:
    task = make_config(config)
    eval_every = max(rounds // 4, 1)

    def run(n_rounds: int):
        pop = make_population(task, n, ef_store=store)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hist = run_population(pop, FLConfig(
            rounds=n_rounds, eval_every=eval_every, backend="cuda"),
            "lgc", h=H, m_cohort=m, engine="batched")
        torch.cuda.synchronize()
        return pop, hist, time.perf_counter() - t0

    run(H)                                       # warm-up: one window
    torch.cuda.reset_peak_memory_stats()
    pop, hist, wall = run(rounds)
    peak = torch.cuda.max_memory_allocated()
    windows = len(pop.phase_ms["window"])
    by_phase = {k: statistics.fmean(v) for k, v in pop.phase_ms.items()}
    ef_bytes, d = pop.ef_nbytes, pop.d
    del pop                                      # free the store first
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        run(rounds)
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = union_us([(e.time_range.start, e.time_range.end)
                        for e in kernels]) / 1e3
    return {
        "config": config, "ef_store": store, "engine": "batched",
        "n_devices": n, "m_cohort": m, "rounds": rounds, "h": H,
        "params_d": d, "ef_bytes": ef_bytes,
        "peak_memory_bytes": peak,
        "windows": windows,
        "host_ms_per_window": wall * 1e3 / windows,
        "host_ms_per_window_by_phase": by_phase,
        "device_steps_per_s": m * rounds / wall,
        "device_busy_ms_per_window": busy_ms / windows,
        "device_idle_share": 1.0 - busy_ms / (wall * 1e3),
        "kernel_launches_per_window": len(kernels) / windows,
        "final_loss": hist.loss[-1], "final_accuracy": hist.accuracy[-1],
        "uplink_mb": hist.uplink_mb[-1],
        "card": card_name_and_power_limit(),
    }


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-devices", type=int, default=100_000)
    ap.add_argument("--m-cohort", type=int, default=64)
    ap.add_argument("--rounds", type=int, default=24)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_population needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = []
    for config in CONFIGS:
        for store in STORES:
            row = bench(config, store, args.n_devices, args.m_cohort,
                        args.rounds)
            print(json.dumps(row), flush=True)
            rows.append(row)
    return rows


if __name__ == "__main__":
    main()
