"""Multi-channel communication model (paper §4.1, Table 1).

Port of ``repro/core/channels.py:39-146``.  Each edge device reaches the
server over N channels (3G / 4G / 5G by default); per round and channel it
draws the energy per MB (Gaussian), the bandwidth (lognormal jitter around
a nominal rate) and whether the channel is up (Bernoulli), from the same
threefry keys as the reference (:mod:`repro_torch.core.prng`).

The simulator samples channels and prices uploads on the host, in f32 on
the CPU, whatever device trains the model: the costs become Python floats
at once, as in the reference's loop engine.  ``up`` is bitwise equal to
the reference's (it compares ``uniform`` draws), and so are the energy and
the bandwidth (``normal``, and XLA:CPU's ``exp``: ``prng.xla_exp``), so the
spend of a run equals the reference loop engine's exactly
(tests/test_torch_sim_core.py, tests/test_torch_hetero_control.py).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import torch

from . import prng

_3G_MEAN_J_PER_MB = 1296.0  # Table 1
_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class ChannelSpec:
    name: str
    energy_mean_j_per_mb: float           # Table 1 mean
    energy_std: float                     # Table 1 standard deviation
    bandwidth_mb_s: float                 # nominal throughput
    money_per_mb: float                   # tariff
    availability: float = 1.0             # P(channel up in a round)


DEFAULT_CHANNELS: tuple[ChannelSpec, ...] = (
    ChannelSpec("3G", _3G_MEAN_J_PER_MB, 0.00033, 0.6, 0.01, 0.98),
    ChannelSpec("4G", 2.2 * _3G_MEAN_J_PER_MB, 0.00033, 3.0, 0.02, 0.95),
    ChannelSpec("5G", 2.5 * 2.2 * _3G_MEAN_J_PER_MB, 0.00033, 25.0, 0.05, 0.90),
)


class ChannelSample(NamedTuple):
    """Realised channel conditions for one device in one round, (N,) each."""
    energy_j_per_mb: torch.Tensor
    bandwidth_mb_s: torch.Tensor
    money_per_mb: torch.Tensor
    up: torch.Tensor                     # bool


class ChannelConstants(NamedTuple):
    """Per-channel spec constants stacked into f32 tensors, (N,) each."""
    energy_mean: torch.Tensor
    energy_std: torch.Tensor
    bw_nominal: torch.Tensor
    money_per_mb: torch.Tensor
    availability: torch.Tensor


def stack_specs(specs: Sequence[ChannelSpec] = DEFAULT_CHANNELS
                ) -> ChannelConstants:
    def col(f):
        return torch.tensor([f(s) for s in specs], dtype=_F32)
    return ChannelConstants(
        energy_mean=col(lambda s: s.energy_mean_j_per_mb),
        energy_std=col(lambda s: s.energy_std),
        bw_nominal=col(lambda s: s.bandwidth_mb_s),
        money_per_mb=col(lambda s: s.money_per_mb),
        availability=col(lambda s: s.availability))


def sample_channels_from(key: torch.Tensor, consts: ChannelConstants
                         ) -> ChannelSample:
    """One draw of every channel: three keys split from ``key`` give the
    energy, the bandwidth and the availability draws."""
    n = consts.energy_mean.shape[0]
    k_e, k_b, k_u = prng.split(key, 3)
    energy = consts.energy_mean + consts.energy_std * prng.normal(k_e, (n,))
    # lognormal jitter, sigma=0.3 -- "highly dynamic edge network"
    bw = consts.bw_nominal * prng.xla_exp(0.3 * prng.normal(k_b, (n,)))
    up = prng.uniform(k_u, (n,)) < consts.availability
    return ChannelSample(energy, bw, consts.money_per_mb, up)


def sample_channels_rows(keys: torch.Tensor, consts: ChannelConstants
                         ) -> ChannelSample:
    """:func:`sample_channels_from` for every key of ``keys`` (M, 2), as
    (M, N) tensors on the keys' device (``consts`` on that device too): the
    same draws in a few tensor passes, with no host sync."""
    n = consts.energy_mean.shape[0]
    ks = prng.split_rows(keys, 3)
    energy = consts.energy_mean + consts.energy_std * prng.normal_rows(
        ks[:, 0], n)
    bw = consts.bw_nominal * prng.xla_exp(0.3 * prng.normal_rows(ks[:, 1], n))
    up = prng.uniform_rows(ks[:, 2], n) < consts.availability
    return ChannelSample(energy, bw, consts.money_per_mb.expand_as(energy),
                         up)


def comm_cost(sample: ChannelSample, bytes_per_channel: Sequence[int]
              ) -> dict[str, torch.Tensor]:
    """Energy (J), money and transfer time (s) of one upload.

    Layers travel in parallel, so the time is the max over the channels
    that are up; energy and money are sums.  Byte counts are divided in f32
    (integer-valued, exact below 2**24), as the reference divides them."""
    mb = torch.tensor(list(bytes_per_channel), dtype=_F32) / 1e6
    return comm_cost_mb(sample, mb)


def comm_cost_mb(sample: ChannelSample, mb: torch.Tensor
                 ) -> dict[str, torch.Tensor]:
    """:func:`comm_cost` on an f32 MB tensor (reduces over the last axis)."""
    zero = torch.zeros((), dtype=_F32, device=mb.device)
    mb = torch.where(sample.up, mb, zero)
    energy = torch.sum(mb * sample.energy_j_per_mb, -1)
    money = torch.sum(mb * sample.money_per_mb, -1)
    time_s = torch.amax(torch.where(sample.up, mb / sample.bandwidth_mb_s,
                                    zero), -1)
    return {"energy_j": energy, "money": money, "time_s": time_s}


@dataclasses.dataclass(frozen=True)
class DeviceProfile:
    """Per-local-step compute cost of one device (the paper's E_comp)."""
    name: str = "generic-phone"
    comp_j_per_step: float = 0.75   # J per local SGD step
    comp_time_per_step_s: float = 0.05
    # state of charge in [0, 1]; a static device trait that the per-device
    # controller observes and that caps its local steps
    battery: float = 1.0


def comp_cost(profile: DeviceProfile, h_steps: int) -> dict[str, float]:
    return {
        "energy_j": profile.comp_j_per_step * h_steps,
        "money": 0.0,
        "time_s": profile.comp_time_per_step_s * h_steps,
    }
