"""Quickstart of the port: LGC federated learning against FedAvg.

The counterpart of ``examples/quickstart.py``: logistic regression on
synthetic MNIST across 3 edge devices with 3 channels (3G / 4G / 5G),
layered gradient compression with error feedback (fixed H=4, 5% of the
coordinates split 1/2, 1/4, 1/4 over the channels), against FedAvg's dense
upload; then the same resource table, and the host time per round of each
run.  ``--task cnn_mnist`` runs the paper's CNN instead, ``--task
rnn_shakespeare`` its char-RNN (``--n-train`` windows of 48 characters),
and ``--scenario`` any registry scenario (evolving channels, dropout).

    PYTHONPATH=src python -m repro_torch.launch.quickstart            # the card
    PYTHONPATH=src python -m repro_torch.launch.quickstart --device cpu

It runs on the card unless ``--device cpu`` is given (without CUDA it
raises).  The backend is ``"cuda"``: each sync compresses through the CUDA
LGC kernels on the card and through their plain versions on the CPU.
``--engine`` picks the batched engine (the default: one launch of each LGC
row kernel per sync boundary over the M device rows) or the loop engine
(one launch of each flat kernel per device and sync).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.core import FLConfig, run_baseline
from repro_torch.core.scenario import SCENARIOS
from repro_torch.device import resolve_device
from repro_torch.models.paper_models import make_task


def _timed_run(task, cfg, mode, device) -> tuple:
    """History and host ms per round (the run ends in host reads)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    hist = run_baseline(task, cfg, mode, h=4, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return hist, (time.perf_counter() - t0) * 1e3 / cfg.rounds


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--task", default="lr_mnist",
                    choices=("lr_mnist", "cnn_mnist", "rnn_shakespeare"))
    ap.add_argument("--scenario", default="static", choices=sorted(SCENARIOS))
    ap.add_argument("--rounds", type=int, default=120)
    ap.add_argument("--n-train", type=int, default=3000)
    ap.add_argument("--device", default=None,
                    help="torch device; default: the card")
    ap.add_argument("--engine", default="batched",
                    choices=("loop", "batched"))
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    task = make_task(args.task, m_devices=3, n_train=args.n_train,
                     scenario=args.scenario)
    cfg = FLConfig(rounds=args.rounds, eval_every=max(args.rounds // 6, 1),
                   backend="cuda", engine=args.engine, scenario=args.scenario)
    print(f"== {args.task} on {device}, M=3, {args.rounds} rounds, "
          f"{args.engine} engine, scenario {args.scenario} ==")

    print("== LGC (layered compression, 3 channels, fixed H=4) ==")
    lgc, lgc_ms = _timed_run(task, cfg, "lgc", device)
    for step, loss, acc in zip(lgc.step, lgc.loss, lgc.accuracy):
        print(f"  t={step:4d} loss={loss:.4f} acc={acc:.3f}")

    print("== FedAvg (dense upload) ==")
    avg, avg_ms = _timed_run(task, cfg, "fedavg", device)
    print(f"  final loss={avg.loss[-1]:.4f} acc={avg.accuracy[-1]:.3f}")

    print("\n== resource comparison (total across devices) ==")
    rows = [("", "LGC", "FedAvg"),
            ("energy (J)", f"{lgc.energy_j[-1]:.0f}", f"{avg.energy_j[-1]:.0f}"),
            ("money", f"{lgc.money[-1]:.4f}", f"{avg.money[-1]:.4f}"),
            ("uplink (MB)", f"{lgc.uplink_mb[-1]:.2f}",
             f"{avg.uplink_mb[-1]:.2f}"),
            ("wall time (s)", f"{lgc.time_s[-1]:.1f}", f"{avg.time_s[-1]:.1f}"),
            ("host ms per round", f"{lgc_ms:.2f}", f"{avg_ms:.2f}")]
    for r in rows:
        print(f"  {r[0]:>18s}  {r[1]:>10s}  {r[2]:>10s}")
    return {"lgc": lgc, "fedavg": avg, "lgc_ms_per_round": lgc_ms,
            "fedavg_ms_per_round": avg_ms}


if __name__ == "__main__":
    main()
