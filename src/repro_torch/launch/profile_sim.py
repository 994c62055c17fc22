"""Where a round of the LGC simulator spends its time.

    python -m repro_torch.launch.profile_sim [--task lr_mnist] [--m-devices 3]
        [--n-train 3000] [--rounds 40] [--mode lgc] [--engine batched]
        [--scenario static] [--layer-policy global] [--aggregator mean]
        [--controller fixed] [--action-space shared]

Runs ``run_baseline``'s simulator on the card with ``backend="cuda"`` (H=4,
5% of D per sync) on ``lr_mnist``, ``cnn_mnist`` or ``rnn_shakespeare``
(``--n-train`` defaults to 3,000 for the MNIST tasks and to the factory's
2,000 windows per device for the RNN) under a registry scenario, a layer
policy (``--layer-policy``: ``global`` or a ``LAYER_POLICIES`` name, whose
syncs take the segmented kernels), a server (``--aggregator``: ``mean``,
``diloco`` or ``semi_sync``, the last with a staleness cap of 2) and a
controller (``--controller``: ``fixed``, or ``ddpg``, the paper's fleet on
the card with a replay batch of 4 so that it trains within the run;
``--action-space per_device`` runs it pipelined with ``max_gap=4``, h at
most 4 and the compute prior 1.5 of the reference's hetero runs), once
to warm up, once timed and once under ``torch.profiler``:

* host ms per round (the timed run's time over its rounds) and the split
  over the engine's phases, each wrapped with a host clock.  The loop
  engine (``--engine loop``): ``sample_batch`` (threefry keys and the
  minibatch index upload, which waits for the card), ``sgd`` (forward,
  ``autograd.grad``, update; enqueued), ``sync`` (channel draw,
  compression, cost model) and ``record`` (eval), the rest being the
  server mean and the controller; with the median sync round and the
  median other round (with H=4 three rounds in four sync no device).
  Both engines: ``scenario`` (stepping the (M, C) channel-chain carry
  through the rounds, on the host; nothing under ``static``).  The
  batched engine (the default): ``channels`` (the sync's channel draw and
  cost model, on the host), ``draw_batches`` (the window's keys and
  minibatch indices, on the card), ``sgd`` (the vmapped gradients and
  updates), ``sync`` (the LGC row kernels, per-layer budgets and the
  segmented kernels, QSGD, the server step; enqueued)
  and ``record`` (eval, the only wait for the card); with the median
  window;
* with ``--controller ddpg``: the fleet's host ms per boundary split into
  ``act`` (``LGCSimulator._fleet_decide``), ``reward`` (enqueueing the
  reward eval and reading it: ``_reward_enqueue`` / ``_reward_read``) and
  ``observe`` (the fleet's ``observe``: replay and training), outside the
  phases above, and the kernels one fleet boundary launches (a fresh
  fleet of the run's M, every device acting and training once, profiled);
* device busy ms per round (union of kernel intervals in the profiled
  run), the idle share against the unprofiled round, kernel launches per
  round, device ms by group (the LGC kernels, matmuls, the rest).

Prints one JSON line; it needs a card and fails without one.
"""
from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np
import torch

from repro_torch.core import FLConfig, LGCSimulator, prng, tree_size
from repro_torch.core.controller import (DDPGConfig, FleetDDPG, obs_dim)
from repro_torch.core.compressor import LAYER_POLICIES
from repro_torch.core.server import AGGREGATORS
from repro_torch.core.fl import baseline_simulator
from repro_torch.core.fl_batched import BatchedEngine
from repro_torch.core.scenario import SCENARIOS
from repro_torch.device import (card_name_and_power_limit, kernel_group,
                                 union_us)
from repro_torch.models.paper_models import make_task

H = 4                  # the baselines' fixed sync gap
SEMI_SYNC_CAP = 2      # semi_sync's staleness cap, as in the reference's straggler test
PD_MAX_GAP = 4         # per_device: the window, and the fleet's h_max
# the fleet's phases: (object, method) as in PHASES, "fleet" the controller
CONTROLLER = {"act": ("sim", "_fleet_decide"),
              "reward": ("sim", "_reward_enqueue"),
              "reward_read": ("sim", "_reward_read"),
              "observe": ("fleet", "observe")}
# phase -> (object, method): "sim" is the simulator, "engine" the batched
# engine that drives it
PHASES = {
    "loop": {"scenario": ("sim", "_step_scenario"),
             "sample_batch": ("sim", "_sample_batch"),
             "sgd": ("sim", "_sgd_step"), "sync": ("sim", "_sync_device"),
             "record": ("sim", "_record")},
    "batched": {"scenario": ("sim", "_step_scenario"),
                "channels": ("engine", "_channels"),
                "draw_batches": ("engine", "_draw_batches"),
                "sgd": ("engine", "_local_steps"),
                "sync": ("engine", "_sync"),
                "record": ("sim", "_record")},
}


def _run(sim, spent: dict | None = None, ctrl: dict | None = None):
    """Run the simulator on its engine; with ``spent``, each phase method
    is wrapped with a host clock that adds its seconds there (``ctrl``:
    the same for the fleet's phases, and ``boundaries`` counts the
    observe calls).  Returns the batched engine, or None on the loop
    engine."""
    engine = BatchedEngine(sim) if sim.engine == "batched" else None

    def wrap(table, key, fn):
        def timed(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                table[key] += time.perf_counter() - t0
        return timed
    owners = {"sim": sim, "engine": engine, "fleet": sim.fleet}
    if spent is not None:
        for key, (owner, attr) in PHASES[sim.engine].items():
            obj = owners[owner]
            setattr(obj, attr, wrap(spent, key, getattr(obj, attr)))
    if ctrl is not None:
        for key, (owner, attr) in CONTROLLER.items():
            obj = owners[owner]
            setattr(obj, attr, wrap(ctrl, key, getattr(obj, attr)))
        observe = sim._observe_devices

        def counted(*a, **k):
            ctrl["boundaries"] += 1
            return observe(*a, **k)
        sim._observe_devices = counted
    if engine is None:
        sim.run()
    else:
        engine.run()
    return engine


def fleet_kernels(m: int, cfg: DDPGConfig) -> dict:
    """CUDA kernels of one fleet boundary on the card: every device acts,
    then observes and trains once (its replay warm), under torch.profiler."""
    fleet = FleetDDPG(m, cfg, device="cuda")
    rng = np.random.default_rng(0)

    def states():
        return np.abs(rng.normal(size=(m, cfg.state_dim))).astype(
            np.float32) * 10
    for _ in range(cfg.batch_size):          # warm every replay buffer
        fleet.act(states())
        fleet.observe(rng.normal(size=m), states())
    acts = [torch.profiler.ProfilerActivity.CUDA]
    out = {}
    for name, call in (("act", lambda: fleet.act(states())),
                       ("observe", lambda: fleet.observe(
                           rng.normal(size=m), states()))):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            call()
            torch.cuda.synchronize()
        out[name] = sum(1 for e in prof.events()
                        if e.device_type == torch.autograd.DeviceType.CUDA)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--task", default="lr_mnist",
                    choices=("lr_mnist", "cnn_mnist", "rnn_shakespeare"))
    ap.add_argument("--m-devices", type=int, default=3)
    ap.add_argument("--n-train", type=int, default=None)
    ap.add_argument("--rounds", type=int, default=40)
    ap.add_argument("--mode", default="lgc",
                    choices=("lgc", "topk", "fedavg", "lgc_q8"))
    ap.add_argument("--engine", default="batched",
                    choices=("loop", "batched"))
    ap.add_argument("--scenario", default="static", choices=sorted(SCENARIOS))
    ap.add_argument("--layer-policy", default="global",
                    choices=("global", *sorted(LAYER_POLICIES)))
    ap.add_argument("--aggregator", default="mean", choices=sorted(AGGREGATORS))
    ap.add_argument("--controller", default="fixed", choices=("fixed", "ddpg"))
    ap.add_argument("--action-space", default="shared",
                    choices=("shared", "per_device"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_sim needs a CUDA card")
    card = card_name_and_power_limit()
    n_train = args.n_train
    if n_train is None and args.task != "rnn_shakespeare":
        n_train = 3000
    kw = {} if n_train is None else {"n_train": n_train}
    task = make_task(args.task, m_devices=args.m_devices,
                     scenario=args.scenario, **kw)
    per_device = args.action_space == "per_device"
    extra = (dict(action_space="per_device", pipeline_decisions=True,
                  max_gap=PD_MAX_GAP) if per_device else {})
    cfg = FLConfig(rounds=args.rounds, eval_every=10, backend="cuda",
                   engine=args.engine, scenario=args.scenario,
                   layer_policy=args.layer_policy, aggregator=args.aggregator,
                   staleness_cap=(SEMI_SYNC_CAP
                                  if args.aggregator == "semi_sync" else 0),
                   **extra)
    ddpg = args.controller == "ddpg"
    if per_device and not ddpg:
        raise SystemExit("--action-space per_device needs --controller ddpg")

    def fleet_cfg(d: int) -> DDPGConfig:
        k_total = max(3, int(0.05 * d))
        if per_device:
            return DDPGConfig(state_dim=obs_dim(3, "per_device"),
                              n_channels=3, action_space="per_device",
                              h_max=PD_MAX_GAP, h_prior=1.5,
                              k_total_max=k_total, batch_size=4, seed=0)
        return DDPGConfig(k_total_max=k_total, batch_size=4, seed=0)

    d = tree_size(task.init(prng.PRNGKey(0)))

    def simulator():
        if ddpg:
            return LGCSimulator(task, cfg, FleetDDPG(
                args.m_devices, fleet_cfg(d), device="cuda"),
                mode=args.mode, device="cuda")
        return baseline_simulator(task, cfg, args.mode, h=H, device="cuda")
    _run(simulator())                             # build + first-call set-up
    sim = simulator()
    spent = {k: 0.0 for k in PHASES[args.engine]}
    ctrl = ({k: 0.0 for k in CONTROLLER} | {"boundaries": 0} if ddpg
            else None)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine = _run(sim, spent, ctrl)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    if engine is None:
        sync = [ms for t, ms in enumerate(sim.round_ms) if (t + 1) % H == 0]
        other = [ms for t, ms in enumerate(sim.round_ms) if (t + 1) % H]
        medians = {"median_sync_round_ms": statistics.median(sync),
                   "median_other_round_ms": statistics.median(other)}
    else:
        medians = {"median_window_ms": statistics.median(engine.window_ms),
                   "windows": len(engine.window_ms)}

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    prof_sim = simulator()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        _run(prof_sim)
        torch.cuda.synchronize()
        prof_wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_group: dict[str, float] = {}
    for e in kernels:
        g = kernel_group(e.name)
        by_group[g] = by_group.get(g, 0.0) + e.time_range.elapsed_us()
    busy_us = union_us([(e.time_range.start, e.time_range.end)
                         for e in kernels])
    rounds = args.rounds
    out = {
        "card": card,
        "device": torch.cuda.get_device_name(0),
        "task": args.task, "m_devices": args.m_devices, "mode": args.mode,
        "engine": args.engine, "scenario": args.scenario,
        "layer_policy": args.layer_policy, "aggregator": args.aggregator,
        "d": sim.d,
        "rounds": rounds,
        "h": H,
        "host_ms_per_round": wall_s * 1e3 / args.rounds,
        **medians,
        "device_steps_per_s": args.m_devices * rounds / wall_s,
        "host_ms_per_round_by_phase": {
            k: v * 1e3 / rounds for k, v in spent.items()},
        "profiled_round_ms": prof_wall_us / 1e3 / rounds,
        "device_busy_ms_per_round": busy_us / 1e3 / rounds,
        "device_idle_share": 1.0 - busy_us / prof_wall_us,
        # the profiler slows the host, not the card: the same busy time
        # over the unprofiled rounds
        "device_idle_share_unprofiled": 1.0 - busy_us / 1e3 / (wall_s * 1e3),
        "kernel_launches_per_round": len(kernels) / rounds,
        "kernel_ms_per_round_by_group": {
            k: v / 1e3 / rounds for k, v in sorted(by_group.items())},
        "controller": args.controller, "action_space": args.action_space,
    }
    if ddpg:
        n_b = max(ctrl["boundaries"], 1)
        out |= {
            "boundaries": ctrl["boundaries"],
            "controller_ms_per_boundary": {
                "act": ctrl["act"] * 1e3 / n_b,
                "reward": (ctrl["reward"] + ctrl["reward_read"]) * 1e3 / n_b,
                "reward_read": ctrl["reward_read"] * 1e3 / n_b,
                "observe": ctrl["observe"] * 1e3 / n_b},
            "n_train": sim.fleet._n_train.tolist(),
            "fleet_kernels_per_boundary": fleet_kernels(
                args.m_devices, fleet_cfg(d))}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
