"""Decision-log cost auditing: recompute a run's spend from first principles.

Port of ``repro/core/audit.py``.  The engines account energy / money /
wall-time / bytes at every sync.  Every cost depends only on *committed
controller decisions* and *counter-based channel randomness* -- never on
gradient values -- so the whole spend ledger can be recomputed after the
fact from

    (FLConfig, mode, model size d, device profiles, decision_log)

by replaying the scenario chains (:func:`.scenario.step_carry_rows`) and
pricing each logged decision's sync round with the engines' host cost
model (:func:`.scenario.sample_from_carry_rows`, :func:`.scenario.
dropout_mask`, :func:`.channels.comm_cost_mb`, f32 channel math, f64
accumulation in sync order), so the totals are *identical*, not just
close (tests/test_torch_hetero_control.py).
"""
from __future__ import annotations

from typing import Sequence

import torch

from . import prng
from .channels import comm_cost_mb, comp_cost, stack_specs
from .scenario import (TAG_CHANNEL, ScenarioCarry, dropout_mask,
                       get_scenario, init_carry, sample_from_carry_rows,
                       stack_carries, step_carry_rows, stream_keys)

_F32 = torch.float32


def sync_round_of(cfg, t_commit: int, h: int) -> int:
    """The round at which a decision committed at ``t_commit`` syncs.

    ``shared``: the device's own window is h rounds; ``per_device``: every
    window is max_gap rounds and h only masks compute steps inside it."""
    per_device = getattr(cfg, "action_space", "shared") == "per_device"
    return t_commit + (cfg.max_gap if per_device else h) - 1


def _sync_costs(cfg, mode: str, d: int, scn, consts, base, carry, t: int,
                ms: list[int], ks_rows: list[list[int]]) -> torch.Tensor:
    """(S, 4) f32 comm costs (energy, money, time, uplink bytes) of the
    devices ``ms`` syncing at round ``t`` with budgets ``ks_rows``."""
    rows = torch.tensor(ms)
    n_ch = len(cfg.channels)
    keys = stream_keys(base, TAG_CHANNEL, torch.tensor([t]), rows)[0]
    ch = sample_from_carry_rows(
        scn, consts, ScenarioCarry(*(part[rows] for part in carry)), keys)
    if scn.has_dropout:
        ch = ch._replace(up=ch.up & ~dropout_mask(scn, base, t, rows)[:, None])
    if mode == "fedavg":
        any_up = ch.up.any(1)
        best = torch.argmax(ch.bandwidth_mb_s * ch.up, 1)
        nbytes = ((torch.arange(n_ch) == best[:, None]).to(_F32)
                  * float(d * cfg.value_bytes))
        uplink = torch.where(any_up, nbytes.sum(1), torch.zeros(()))
    else:
        if mode == "topk":
            ks_rows = [[sum(ks)] + [0] * (len(ks) - 1) for ks in ks_rows]
        vb = 1 if mode == "lgc_q8" else cfg.value_bytes
        ks = torch.tensor([(list(k) + [0] * n_ch)[:n_ch] for k in ks_rows],
                          dtype=_F32)
        nbytes = ks * float(vb + cfg.index_bytes) * ch.up[:, :n_ch].to(_F32)
        uplink = nbytes.sum(1)
    comm = comm_cost_mb(ch, nbytes / 1e6)
    return torch.stack([comm["energy_j"], comm["money"], comm["time_s"],
                        uplink], 1)


def recompute_spend(cfg, mode: str, d: int, decision_log: Sequence[tuple],
                    m_devices: int, profiles=None) -> list[dict]:
    """Replay ``decision_log`` -> per-device spend dicts.

    ``decision_log`` rows are the simulator's ``(t_commit, m, h, ks)``
    tuples.  Decisions whose window runs past ``cfg.rounds`` never synced
    and cost nothing (exactly like the engines).  Returns a list of M dicts
    with keys energy_j / money / time_s / mb, f64-accumulated in the
    engines' per-device sync order."""
    scn = get_scenario(cfg.scenario)
    if profiles is None:
        profiles = scn.device_profiles(m_devices)
    profiles = list(profiles)
    base = prng.PRNGKey(cfg.seed + 1)
    consts = stack_specs(cfg.channels)
    n_ch = len(cfg.channels)
    dev_ids = torch.arange(m_devices, dtype=torch.int64)
    carry = stack_carries([init_carry(scn, base, m, n_ch)
                           for m in range(m_devices)])
    syncs: dict[int, dict[int, tuple[int, list[int]]]] = {}
    for (t_commit, m, h, ks) in decision_log:
        t_sync = sync_round_of(cfg, t_commit, h)
        if t_sync < cfg.rounds:
            syncs.setdefault(t_sync, {})[m] = (int(h), list(ks))
    spend = [dict(energy_j=0.0, money=0.0, time_s=0.0, mb=0.0)
             for _ in range(m_devices)]
    t_done = 0
    for t in sorted(syncs):
        # the chains through round t, synced or not (the engines' order)
        carry = step_carry_rows(scn, base, carry, range(t_done, t + 1),
                                dev_ids)
        t_done = t + 1
        ms = sorted(syncs[t])
        costs = _sync_costs(cfg, mode, d, scn, consts, base, carry, t, ms,
                            [syncs[t][m][1] for m in ms]).numpy()
        for row, m in enumerate(ms):
            ccomp = comp_cost(profiles[m], syncs[t][m][0])
            s = spend[m]
            s["energy_j"] += float(costs[row, 0]) + ccomp["energy_j"]
            s["money"] += float(costs[row, 1]) + ccomp["money"]
            s["time_s"] += float(costs[row, 2]) + ccomp["time_s"]
            s["mb"] += float(costs[row, 3]) / 1e6
    return spend


def audit_simulator(sim) -> tuple[list[dict], list[dict]]:
    """(recomputed, live) spend for a finished :class:`.fl.LGCSimulator`
    run."""
    recomputed = recompute_spend(sim.cfg, sim.mode, sim.d, sim.decision_log,
                                 sim.m_devices, profiles=sim.profiles)
    return recomputed, sim.spend
