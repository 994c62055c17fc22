"""Counter-based key streams and dynamic-environment scenarios.

Port of ``repro/core/scenario.py:79-414``: the stream tags and
:func:`stream_key`, the dynamics specs, :class:`Scenario` and the
:data:`SCENARIOS` registry, the per-device chain carry (Gauss-Markov
log-bandwidth, Gilbert-Elliott availability) with :func:`init_carry`,
:func:`step_carry` and :func:`sample_from_carry` (with the row forms, and
:func:`init_carry_rows` for a population's N devices at once), and
:func:`dropout_mask`.

Every variate of a simulation comes from ``stream_key(base, TAG, round,
device)``, a chain of threefry ``fold_in`` calls, so the port draws the
same minibatches, channel states and dither as the reference
(:mod:`repro_torch.core.prng`).  A carry holds one device's chain state
((C,) fields) or M devices' ((M, C) fields).  Booleans (channel states, up
masks, dropouts) and the carry are bitwise equal to the reference's
(tests/test_torch_sim_core.py, tests/test_torch_scenarios.py).

Both engines keep the (M, C) carry of every device on the host and step
it once per round with :func:`step_carry_rows` (all devices, the draws of
all the window's rounds in a few tensor passes); a sync reads its devices'
rows through :func:`sample_from_carry` / :func:`sample_from_carry_rows`
and drops whole uplinks by :func:`dropout_mask`.

The reference steps the carry inside ``jax.jit`` (the loop engine's
``_scen_step_all``, the batched engine's window scan), where XLA:CPU folds
``sigma * sqrt(1 - rho**2) * sqrt(2)`` into one f32 constant and fuses
``rho * bw_log + innov`` into a multiply-add.  The port does both
(:func:`_gm_step`), so its chains are bitwise the jitted reference's
(tests/test_torch_scenarios.py).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import torch

from . import prng
from .channels import (ChannelConstants, ChannelSample, DeviceProfile,
                       sample_channels_from, sample_channels_rows)

_F32 = torch.float32

# stream tags: minibatch draws, channel realisations, eval subsets,
# controller-reward eval subsets, QSGD dither, controller exploration noise,
# controller replay sampling, scenario chain transitions, scenario chain
# stationary init, sync-round device dropout, population cohort draws
(TAG_BATCH, TAG_CHANNEL, TAG_EVAL, TAG_REWARD, TAG_QUANT,
 TAG_CTRL_NOISE, TAG_CTRL_SAMPLE, TAG_SCEN, TAG_SCEN_INIT,
 TAG_DROP, TAG_COHORT) = range(11)


def stream_key(base: torch.Tensor, tag: int, *ids) -> torch.Tensor:
    """The key of one (stream, round, device) event: ``fold_in`` of the tag,
    then of each id in turn (counter-based, so no consumption order)."""
    k = prng.fold_in(base, tag)
    for i in ids:
        k = prng.fold_in(k, i)
    return k


def stream_keys(base: torch.Tensor, tag: int, ts: torch.Tensor,
                dev_ids: torch.Tensor) -> torch.Tensor:
    """``stream_key(base, tag, t, m)`` for every round t of ``ts`` (L,) and
    device m of ``dev_ids`` (M,), as an (L, M, 2) tensor on their device:
    the tag is folded in on the host (``base`` lies on the CPU), the rounds
    and the devices in two tensor passes, with no copy to the device."""
    k0, k1 = prng.fold_in(base, tag).tolist()
    ts = ts.to(torch.int64)
    y0, y1 = prng.threefry2x32(k0, k1, torch.zeros_like(ts), ts)
    ids = dev_ids.to(torch.int64)[None, :]
    z0, z1 = prng.threefry2x32(y0[:, None], y1[:, None],
                               torch.zeros_like(ids), ids)
    return torch.stack([z0, z1], -1)


# ---------------------------------------------------------------------------
# dynamics specs
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GaussMarkovSpec:
    """AR(1) log-bandwidth evolution (replaces the IID lognormal jitter)."""
    rho: float = 0.95       # per-round memory; 0 degenerates to IID
    sigma: float = 0.4      # stationary std of the log-bandwidth deviation


@dataclasses.dataclass(frozen=True)
class GilbertElliottSpec:
    """Two-state good/bad chain (replaces IID Bernoulli availability)."""
    p_gb: float = 0.05      # P(good -> bad) per round
    p_bg: float = 0.4       # P(bad -> good) per round

    @property
    def stationary_availability(self) -> float:
        return self.p_bg / (self.p_gb + self.p_bg)


@dataclasses.dataclass(frozen=True)
class DropoutSpec:
    """Per-device sync-round dropout: the whole uplink is lost, the EF
    residual carries the undelivered mass, the downlink still arrives."""
    base_prob: float = 0.0      # every device's per-sync drop probability
    flaky_every: int = 0        # every k-th device is flaky (0 = none)
    flaky_prob: float = 0.0     # drop probability of the flaky devices


@dataclasses.dataclass(frozen=True)
class StragglerSpec:
    """Every k-th device computes ``slowdown``x slower (wall-clock cost)."""
    slow_every: int = 0
    slowdown: float = 1.0


@dataclasses.dataclass(frozen=True)
class HeteroFleetSpec:
    """Skewed per-device traits, cycled by *global* device id: battery
    ``batteries[i % len]`` and a compute multiplier ``compute_mults[i %
    len]`` on both compute energy and compute time."""
    batteries: Sequence[float] = (1.0, 1.0, 1.0, 0.7, 0.67)
    compute_mults: Sequence[float] = (1.0, 1.0, 1.5, 2.5, 4.0)


@dataclasses.dataclass(frozen=True)
class Scenario:
    """Channel dynamics, data heterogeneity and device dynamics.

    ``gauss_markov`` / ``gilbert_elliott`` None keeps the memoryless
    bandwidth jitter / Bernoulli availability of :mod:`.channels`; the
    fully-None ``static`` scenario is the seed model.  ``partition`` and
    ``alpha`` say how task factories shard the data."""
    name: str = "static"
    gauss_markov: GaussMarkovSpec | None = None
    gilbert_elliott: GilbertElliottSpec | None = None
    dropout: DropoutSpec | None = None
    straggler: StragglerSpec | None = None
    hetero: HeteroFleetSpec | None = None
    partition: str = "iid"          # "iid" | "noniid" | "dirichlet" | "quantity"
    alpha: float = 0.5              # Dirichlet concentration (data skew)

    @property
    def is_static(self) -> bool:
        """True when per-round carry advancement is a no-op."""
        return self.gauss_markov is None and self.gilbert_elliott is None

    @property
    def has_dropout(self) -> bool:
        d = self.dropout
        return d is not None and (d.base_prob > 0 or
                                  (d.flaky_every > 0 and d.flaky_prob > 0))

    def device_profile_at(self, i: int) -> DeviceProfile:
        """Compute profile of *global* device ``i``: the ``hetero`` skew
        first, a straggler slowdown on top."""
        base = DeviceProfile()
        h = self.hetero
        if h is not None:
            battery = float(h.batteries[i % len(h.batteries)])
            mult = float(h.compute_mults[i % len(h.compute_mults)])
            base = DeviceProfile(
                name=f"{base.name}-hetero{i % len(h.batteries)}",
                comp_j_per_step=base.comp_j_per_step * mult,
                comp_time_per_step_s=base.comp_time_per_step_s * mult,
                battery=battery)
        s = self.straggler
        if (s is None or s.slow_every <= 0 or s.slowdown == 1.0
                or i % s.slow_every != 0):
            return base
        return DeviceProfile(
            name=f"{base.name}-straggler",
            comp_j_per_step=base.comp_j_per_step * s.slowdown,
            comp_time_per_step_s=base.comp_time_per_step_s * s.slowdown,
            battery=base.battery)

    def device_profiles(self, m: int) -> list[DeviceProfile]:
        """Per-device compute profiles with the straggler slowdown applied."""
        return [self.device_profile_at(i) for i in range(m)]

    def drop_probs(self, dev_ids: torch.Tensor) -> torch.Tensor:
        """(M,) f32 per-device sync-dropout probabilities from *global*
        device ids."""
        d = self.dropout or DropoutSpec()
        p = torch.full(dev_ids.shape, d.base_prob, dtype=_F32)
        if d.flaky_every > 0:
            p = torch.where(dev_ids % d.flaky_every == 0,
                            torch.tensor(d.flaky_prob, dtype=_F32), p)
        return p


class ScenarioCarry(NamedTuple):
    """One device's chain state: ``bw_log`` (C,) f32, AR(1) log-bandwidth
    deviation; ``good`` (C,) bool, Gilbert-Elliott state (True = good)."""
    bw_log: torch.Tensor
    good: torch.Tensor


def init_carry(scn: Scenario, base: torch.Tensor, dev_id: int,
               n_channels: int) -> ScenarioCarry:
    """Stationary-draw initial chain state for one device (TAG_SCEN_INIT)."""
    k = stream_key(base, TAG_SCEN_INIT, dev_id)
    k_gm, k_ge = prng.split(k)
    gm, ge = scn.gauss_markov, scn.gilbert_elliott
    if gm is not None:
        bw_log = gm.sigma * prng.normal(k_gm, (n_channels,))
    else:
        bw_log = torch.zeros((n_channels,), dtype=_F32)
    if ge is not None:
        good = (prng.uniform(k_ge, (n_channels,))
                < torch.tensor(ge.stationary_availability, dtype=_F32))
    else:
        good = torch.ones((n_channels,), dtype=torch.bool)
    return ScenarioCarry(bw_log.to(_F32), good)


def init_carry_rows(scn: Scenario, base: torch.Tensor, ids: torch.Tensor,
                    n_channels: int) -> ScenarioCarry:
    """:func:`init_carry` of every device of ``ids`` (N,) as one (N, C)
    carry, the keys and draws of all N in a few tensor passes (the
    reference's ``jax.vmap(init_carry)`` over a population); row i is
    bitwise ``init_carry(scn, base, ids[i], n_channels)``."""
    ids = ids.to(torch.int64)
    k0, k1 = prng.fold_in(base, TAG_SCEN_INIT).tolist()
    y0, y1 = prng.threefry2x32(k0, k1, torch.zeros_like(ids), ids)
    ks = prng.split_rows(torch.stack([y0, y1], -1), 2)       # (N, 2, 2)
    gm, ge = scn.gauss_markov, scn.gilbert_elliott
    n = ids.shape[0]
    if gm is not None:
        bw_log = gm.sigma * prng.normal_rows(ks[:, 0], n_channels)
    else:
        bw_log = torch.zeros((n, n_channels), dtype=_F32, device=ids.device)
    if ge is not None:
        good = (prng.uniform_rows(ks[:, 1], n_channels)
                < torch.tensor(ge.stationary_availability, dtype=_F32,
                               device=ids.device))
    else:
        good = torch.ones((n, n_channels), dtype=torch.bool,
                          device=ids.device)
    return ScenarioCarry(bw_log.to(_F32), good)


def _gm_step(gm: GaussMarkovSpec, bw_log: torch.Tensor,
             erf_inv_u: torch.Tensor) -> torch.Tensor:
    """One AR(1) step from the innovation's ``erf_inv(u)`` (its normal
    without the sqrt(2)): ``fma(rho, bw_log, erf_inv_u * c)`` with ``c =
    f32(sigma * sqrt(1 - rho**2)) * f32(sqrt 2)`` in f32, as XLA:CPU folds
    and fuses the reference's jitted step."""
    f32 = lambda v: torch.tensor(v, dtype=_F32)   # noqa: E731
    scale = f32(gm.sigma) * prng.sqrt_f32(f32(1.0 - gm.rho ** 2))
    innov = erf_inv_u * (scale * f32(prng._SQRT2)).to(erf_inv_u.device)
    rho = torch.full_like(bw_log, gm.rho)
    return prng.fma32(rho, bw_log, innov)


def _ge_step(ge: GilbertElliottSpec, good: torch.Tensor,
             u: torch.Tensor) -> torch.Tensor:
    return torch.where(good, u >= torch.tensor(ge.p_gb, dtype=_F32),
                       u < torch.tensor(ge.p_bg, dtype=_F32))


def step_carry(scn: Scenario, base: torch.Tensor, carry: ScenarioCarry,
               t: int, dev_id: int, valid: bool = True) -> ScenarioCarry:
    """Advance one device's chains through round ``t`` (TAG_SCEN stream);
    ``valid=False`` leaves the carry untouched."""
    if scn.is_static or not valid:
        return carry
    k = stream_key(base, TAG_SCEN, t, dev_id)
    k_gm, k_ge = prng.split(k)
    bw_log, good = carry
    gm, ge = scn.gauss_markov, scn.gilbert_elliott
    if gm is not None:
        n = bw_log.shape[0]
        u = prng.uniform(k_gm, (n,), prng._NORMAL_LO, 1.0)
        bw_log = _gm_step(gm, bw_log, prng.erf_inv(u))
    if ge is not None:
        good = _ge_step(ge, good, prng.uniform(k_ge, tuple(good.shape)))
    return ScenarioCarry(bw_log, good)


def stack_carries(carries: Sequence[ScenarioCarry]) -> ScenarioCarry:
    """Per-device carries stacked into one (M, C) carry."""
    return ScenarioCarry(torch.stack([c.bw_log for c in carries]),
                         torch.stack([c.good for c in carries]))


def step_carry_rows(scn: Scenario, base: torch.Tensor, carry: ScenarioCarry,
                    ts: Sequence[int], dev_ids: torch.Tensor
                    ) -> ScenarioCarry:
    """:func:`step_carry` of every device of ``dev_ids`` (M,) through the
    rounds ``ts`` in turn, on an (M, C) carry: the keys and draws of all
    (round, device) pairs in a few tensor passes, then one elementwise
    step per round.  Each step is bitwise the per-device one."""
    if scn.is_static or len(ts) == 0:
        return carry
    bw_log, good = carry
    m, n_ch = good.shape
    keys = stream_keys(base, TAG_SCEN, torch.tensor(list(ts)), dev_ids)
    ks = prng.split_rows(keys.reshape(-1, 2), 2)        # (L M, 2, 2)
    gm, ge = scn.gauss_markov, scn.gilbert_elliott
    if gm is not None:
        e = prng.erf_inv(prng.uniform_rows(ks[:, 0], n_ch, prng._NORMAL_LO,
                                           1.0)).reshape(len(ts), m, n_ch)
    if ge is not None:
        u = prng.uniform_rows(ks[:, 1], n_ch).reshape(len(ts), m, n_ch)
    for i in range(len(ts)):
        if gm is not None:
            bw_log = _gm_step(gm, bw_log, e[i])
        if ge is not None:
            good = _ge_step(ge, good, u[i])
    return ScenarioCarry(bw_log, good)


def sample_from_carry(scn: Scenario, consts: ChannelConstants,
                      carry: ScenarioCarry, key: torch.Tensor
                      ) -> ChannelSample:
    """One device's channel conditions at a sync round: the memoryless
    draw of :func:`.channels.sample_channels_from`, with the carry-driven
    fields laid over it."""
    return _lay_carry(scn, consts, carry, sample_channels_from(key, consts))


def sample_from_carry_rows(scn: Scenario, consts: ChannelConstants,
                           carry: ScenarioCarry, keys: torch.Tensor
                           ) -> ChannelSample:
    """:func:`sample_from_carry` for the (S, C) carry rows and keys (S, 2)
    of S devices: :func:`.channels.sample_channels_rows` with the carry
    laid over it, (S, C) each."""
    return _lay_carry(scn, consts, carry, sample_channels_rows(keys, consts))


def _lay_carry(scn: Scenario, consts: ChannelConstants, carry: ScenarioCarry,
               s: ChannelSample) -> ChannelSample:
    gm, ge = scn.gauss_markov, scn.gilbert_elliott
    if gm is not None:
        # exp(x - sigma^2/2): long-run mean is exactly the nominal rate
        s = s._replace(bandwidth_mb_s=consts.bw_nominal *
                       prng.xla_exp(carry.bw_log - 0.5 * gm.sigma ** 2))
    if ge is not None:
        s = s._replace(up=carry.good)
    return s


def dropout_mask(scn: Scenario, base: torch.Tensor, t: int,
                 dev_ids: torch.Tensor) -> torch.Tensor:
    """(M,) bool: which devices lose their whole uplink at sync round
    ``t`` (one TAG_DROP uniform per (round, device), all devices in a few
    tensor passes)."""
    if not scn.has_dropout:
        return torch.zeros(dev_ids.shape, dtype=torch.bool)
    keys = stream_keys(base, TAG_DROP, torch.tensor([t]), dev_ids)[0]
    return prng.uniform_rows(keys, 1)[:, 0] < scn.drop_probs(dev_ids)


# ---------------------------------------------------------------------------
# named-scenario registry
# ---------------------------------------------------------------------------

SCENARIOS: dict[str, Scenario] = {
    # the seed environment: memoryless jitter, IID availability, IID data
    "static": Scenario(name="static"),
    # dense urban mobility: slowly-wandering bandwidth, short outage bursts
    "markov_urban": Scenario(
        name="markov_urban",
        gauss_markov=GaussMarkovSpec(rho=0.95, sigma=0.5),
        gilbert_elliott=GilbertElliottSpec(p_gb=0.05, p_bg=0.5)),
    # highway handovers: fast-decorrelating bandwidth, frequent brief outages
    "markov_highway": Scenario(
        name="markov_highway",
        gauss_markov=GaussMarkovSpec(rho=0.7, sigma=0.8),
        gilbert_elliott=GilbertElliottSpec(p_gb=0.15, p_bg=0.6)),
    # bursty loss + flaky devices: every 4th device drops whole uploads
    "gilbert_flaky": Scenario(
        name="gilbert_flaky",
        gilbert_elliott=GilbertElliottSpec(p_gb=0.2, p_bg=0.3),
        dropout=DropoutSpec(base_prob=0.05, flaky_every=4, flaky_prob=0.3)),
    # statistical heterogeneity only: Dirichlet(0.3) label skew, static net
    "dirichlet0.3": Scenario(
        name="dirichlet0.3", partition="dirichlet", alpha=0.3),
    # heterogeneous fleet: skewed battery / compute traits on correlated
    # channels, IID data
    "hetero_fleet": Scenario(
        name="hetero_fleet",
        gauss_markov=GaussMarkovSpec(rho=0.9, sigma=0.5),
        gilbert_elliott=GilbertElliottSpec(p_gb=0.1, p_bg=0.4),
        hetero=HeteroFleetSpec()),
    # correlated channels + skewed data + flaky stragglers; the battery
    # ladder is phase-locked to the i % 4 == 0 straggler tier
    "mobile_noniid": Scenario(
        name="mobile_noniid",
        gauss_markov=GaussMarkovSpec(rho=0.9, sigma=0.5),
        gilbert_elliott=GilbertElliottSpec(p_gb=0.1, p_bg=0.4),
        dropout=DropoutSpec(base_prob=0.02, flaky_every=4, flaky_prob=0.2),
        straggler=StragglerSpec(slow_every=4, slowdown=3.0),
        hetero=HeteroFleetSpec(batteries=(0.55, 1.0, 1.0, 1.0),
                               compute_mults=(1.0, 1.0, 1.0, 1.0)),
        partition="dirichlet", alpha=0.3),
}


def get_scenario(scenario: str | Scenario | None) -> Scenario:
    """Resolve a registry name (or pass a Scenario through; None = static)."""
    if scenario is None:
        return SCENARIOS["static"]
    if isinstance(scenario, Scenario):
        return scenario
    try:
        return SCENARIOS[scenario]
    except KeyError:
        raise ValueError(
            f"unknown scenario {scenario!r}; registered: "
            f"{sorted(SCENARIOS)}") from None


def partition_fn(scn: Scenario):
    """The data partitioner named by ``scn.partition`` as
    ``f(x, y, m, seed) -> [(x_i, y_i)]``."""
    from repro_torch.data import (partition_dirichlet, partition_iid,
                                  partition_noniid, partition_quantity_skew)
    if scn.partition == "iid":
        return lambda x, y, m, seed: partition_iid(x, y, m, seed)
    if scn.partition == "noniid":
        return lambda x, y, m, seed: partition_noniid(x, y, m, seed=seed)
    if scn.partition == "dirichlet":
        return lambda x, y, m, seed: partition_dirichlet(
            x, y, m, alpha=scn.alpha, seed=seed)
    if scn.partition == "quantity":
        return lambda x, y, m, seed: partition_quantity_skew(
            x, y, m, alpha=scn.alpha, seed=seed)
    raise ValueError(f"unknown partition {scn.partition!r}")
