"""Federated learning with Layered Gradient Compression (paper Algorithm 1):
the loop engine.

Port of ``repro/core/fl.py:94-249`` (``FLTask``, ``FLConfig``,
``RoundDecision``, ``FixedController``, ``ControllerFleet``, ``History``)
and of the ``LGCSimulator`` loop path (``_run_loop`` :611, ``_ef_step``
:670, ``_sync_device`` :708, ``_record`` :794) with ``run_baseline`` :806:

    for t in 0..T-1:
      every device m:   w_hat^{t+1/2} = w_hat^t - eta(t) * grad f_m(w_hat^t; D_m^t)
      if t+1 in I_m:    u = e_m + w_m - w_hat^{t+1/2}
                        g_m = LGC_k(u);  upload layers over channels
                        e_m <- u - g_received
                        receive global model: w_m, w_hat_m <- w_global
      server:           w_global <- w_global - (1/M) sum_{m synced} g_m

Every variate comes from ``stream_key(base, TAG, t, m)`` (the ported
threefry, :mod:`.prng`), so for a seed the port draws the reference's
minibatches, channel states, eval subsets and QSGD dither, and its History
agrees with the reference loop engine's to float summation order
(tests/test_torch_fl.py).  Keys, minibatch indices and channel draws live
on the host; parameters, error memories, data and the compression on the
simulator's device.

``backend="cuda"`` (``"pallas"`` is its alias) sends each sync's flat
update through :func:`repro_torch.kernels.lgc_compress_hist` -- one launch
each of ``maxabs``, ``histogram`` and ``sparsify_ef`` on a CUDA device, their
plain versions on the CPU; ``backend="exact"`` keeps the rank-exact oracle
of :mod:`.compressor`.  Modes: ``lgc``, ``topk``, ``fedavg``, ``lgc_q8``.

Three engines run the same algorithm: ``engine="batched"`` (the default,
as in the reference: :mod:`.fl_batched`, stacked (M, D) state, one launch
of each LGC row kernel per sync boundary), ``engine="loop"`` (this module,
the Python loop over devices) and ``engine="sharded"`` (the batched engine
with its device axis spread over the ranks of a ``torch.distributed``
mesh, :class:`.fl_batched.ShardedEngine`; ``mesh`` and ``server_reduce``
pick the ranks and the collective that crosses them).  The batched and
loop Histories agree to float summation order
(tests/test_torch_fl_batched.py); the sharded one under
``server_reduce="gather"`` is bitwise the batched one
(tests/test_torch_sharded.py).

Subnormals.  The reference's XLA:CPU flushes f32 subnormals in every
arithmetic op; PyTorch keeps them.  So the engines flush where the
reference's arithmetic would (:func:`sgd_update`, the net progress, the EF
adds, :func:`server_mean_update`), with ``kernels.ref.ftz`` / ``ftz_add``.

Scenarios.  Every registry scenario runs: the (M, C) channel-chain carry
lives on the host and steps once per round, synced or not
(:meth:`LGCSimulator._step_scenario`, the reference's ``_scen_step_all``);
a sync reads its device's row and loses its whole uplink when
:func:`.scenario.dropout_mask` drops the device (the reference's
``fl.py:713-719``): the device still compresses, with nothing received, so
error feedback keeps the mass, and the downlink still reaches it.

Per-layer budgets (``cfg.layer_policy``, the reference's ``fl.py:670-706``):
a sync shares its budget out over the model's layers under a policy of
:data:`.compressor.LAYER_POLICIES`, takes each layer's top candidates, and
sends the candidates through the unchanged channel layering; error
feedback keeps u - g.  ``backend="cuda"``: the candidates through the
segmented kernels (one launch each of ``maxabs_segments`` and
``histogram_segments`` over every layer slice,
:func:`repro_torch.kernels.per_layer_candidates_hist_rows`), then the three
LGC kernels on the masked update; ``"exact"``:
:func:`.compressor.per_layer_compress`.  ``"uniform"`` is bitwise
``"global"`` on the exact backend.

Server aggregation (``cfg.aggregator``, the reference's ``fl.py:420-484``
and ``:641-653``): ``"mean"`` keeps the inline mean; ``"diloco"`` and
``"semi_sync"`` run :mod:`.server` over the syncing devices' updates, and
under semi_sync the server never waits past the deadline and the share
of a late update it never applies returns to that device's error
feedback.  ``History.server_wall_s`` advances by the slowest syncing
device's window time, under semi_sync by at most the deadline.

Control (the reference's ``fl.py:179-229``, ``:376-418``, ``:509-599``,
``:777-792``).  Both engines talk to ONE fleet-shaped controller through
the batched protocol below: at a sync boundary the syncing devices'
reward-seeking members get one keyed-subset eval of the new global model
each (``TAG_REWARD``, all in one batched call), the fleet observes the
loss drops with the new resource states, and acts for the window after.
:class:`repro_torch.core.controller.FleetDDPG` (the paper's DDPG) and a
list of :class:`~repro_torch.core.controller.DDPGController` run on both
engines, as do ``action_space="per_device"`` (every device syncs each
``max_gap`` rounds and computes only the first h_m of them; observations
grow by the device profile and the channel state) and
``pipeline_decisions=True`` (a boundary commits the decision staged at the
previous one, so the batched engine dispatches the next window before the
controller's reward eval and act).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.ref import div_f32, ftz, ftz_add

from . import prng
from .channels import (DEFAULT_CHANNELS, ChannelSpec, DeviceProfile,
                       comm_cost, comp_cost, stack_specs)
from .compressor import (LAYER_POLICIES, LGCCompressor, flatten_tree,
                         layer_budgets, layer_table, per_layer_compress,
                         qsgd_dequantize, qsgd_quantize, tree_layer_slices,
                         tree_size, unflatten_like, wire_bytes)
from .error_feedback import EFState, ef_compress, init_ef
from .scenario import (TAG_BATCH, TAG_CHANNEL, TAG_EVAL, TAG_QUANT,
                       TAG_REWARD, Scenario, ScenarioCarry, dropout_mask,
                       get_scenario, init_carry, sample_from_carry,
                       stack_carries, step_carry_rows, stream_key,
                       stream_keys)
from .server import (diloco_update, get_aggregator, init_server_state,
                     semi_sync_sums, semi_sync_update, staleness_schedule,
                     window_deadline)

BACKENDS = {"exact": "exact", "cuda": "cuda", "pallas": "cuda"}
MODES = ("lgc", "topk", "fedavg", "lgc_q8")
ENGINES = ("batched", "loop", "sharded")
SERVER_REDUCES = ("gather", "psum")
EVAL_SUBSET = 2048    # eval samples drawn per record (reference fl.py:795)
REWARD_SUBSET = 512   # eval samples per device and reward (reference fl.py:387)
ACTION_SPACES = ("shared", "per_device")


# ---------------------------------------------------------------------------
# model + data interfaces
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FLTask:
    """A learning task: init/loss/eval + per-device data shards (numpy)."""
    init: Callable[[torch.Tensor], dict]               # key -> params dict
    loss_fn: Callable[[dict, tuple], torch.Tensor]     # (params, batch) -> scalar
    metric_fn: Callable[[dict, tuple], torch.Tensor]   # accuracy
    device_data: Sequence[tuple[np.ndarray, np.ndarray]]  # per-device (X, y)
    eval_data: tuple[np.ndarray, np.ndarray]
    name: str = "task"


@dataclasses.dataclass
class FLConfig:
    rounds: int = 500                  # T: global iteration budget
    batch_size: int = 64               # b (paper: 64)
    lr: float = 0.01                   # paper: 0.01
    lr_decay_a: float = 200.0          # eta(t) = lr * a / (a + t) (decaying)
    max_gap: int = 8                   # H: uniform bound on gap(I_m)
    channels: Sequence[ChannelSpec] = DEFAULT_CHANNELS
    device_profiles: Sequence[DeviceProfile] | None = None
    seed: int = 0
    eval_every: int = 10
    value_bytes: int = 4               # fp32 values on the wire
    index_bytes: int = 4
    engine: str = "batched"            # "batched" | "loop" | "sharded"
    backend: str = "exact"             # "exact" | "cuda" ("pallas" = "cuda")
    scenario: str | Scenario = "static"
    # per-model-layer budgets: "global" or a LAYER_POLICIES name
    layer_policy: str = "global"
    # server aggregation: "mean", "diloco" or "semi_sync" (.server)
    aggregator: str = "mean"
    staleness_cap: int = 0             # semi_sync: max windows an update waits
    staleness_alpha: float = 0.5       # semi_sync: w(s) = 1/(1+s)^alpha
    deadline_factor: float = 1.25      # semi_sync: deadline = factor * median
    outer_lr: float = 0.7              # diloco outer step size
    outer_momentum: float = 0.9        # diloco outer Nesterov momentum
    # controller action space: "shared" -- each device's h_m sets its own
    # next sync round; "per_device" -- every device syncs each max_gap
    # rounds and h_m in [1, max_gap] is how many of them it computes (the
    # rest it idles); observations grow by the device profile (battery,
    # compute multiplier) and the per-channel state (controller.obs_dim)
    action_space: str = "shared"
    # commit at each boundary the decision staged at the previous one, so
    # the batched engine can dispatch the next window before the
    # controller's reward eval and act; decisions then act on
    # one-window-old observations
    pipeline_decisions: bool = False


@dataclasses.dataclass
class RoundDecision:
    """Controller output for one device for its next sync window."""
    h: int                              # local steps until next sync
    ks: Sequence[int]                   # coordinates per channel (layer sizes)


class FixedController:
    """LGC without DRL: fixed local computation + fixed traffic allocation."""

    def __init__(self, h: int, ks: Sequence[int]):
        self.h, self.ks = h, list(ks)

    def act(self, state: np.ndarray) -> RoundDecision:
        return RoundDecision(self.h, self.ks)

    def observe(self, *a, **k):  # no learning
        pass


# ---------------------------------------------------------------------------
# batched controller protocol
# ---------------------------------------------------------------------------
#
# Both engines talk to ONE fleet-shaped controller per simulation.  The
# protocol (duck-typed):
#
#   needs_reward : (M,) bool -- which devices want a reward signal (gates the
#                  per-device TAG_REWARD eval so fixed fleets skip it)
#   act(states: (M, S), mask: (M,) bool) -> (h: (M,), ks: (M, C) rows)
#                  decide H_m and the per-channel budgets for every masked
#                  device; unmasked rows are ignored and must not advance
#                  any per-device random stream
#   observe(loss_drops: (M,), new_states: (M, S), mask: (M,) bool)
#                  deliver the post-round reward signal to masked devices

class ControllerFleet:
    """List->fleet shim over per-device controllers (``.act(state) ->
    RoundDecision``, optional ``.reward(loss_drop, new_state)``)."""

    def __init__(self, controllers: Sequence):
        self.controllers = list(controllers)
        self.needs_reward = np.array(
            [hasattr(c, "reward") for c in self.controllers], bool)

    @property
    def m(self) -> int:
        return len(self.controllers)

    def act(self, states: np.ndarray, mask: np.ndarray | None = None):
        mask = np.ones(self.m, bool) if mask is None else np.asarray(mask)
        h = np.zeros(self.m, np.int64)
        ks: list[Sequence[int]] = [()] * self.m
        for i in np.nonzero(mask)[0]:
            dec = self.controllers[i].act(np.asarray(states[i]))
            h[i], ks[i] = dec.h, list(dec.ks)
        return h, ks

    def observe(self, loss_drops: np.ndarray, new_states: np.ndarray,
                mask: np.ndarray | None = None):
        mask = np.ones(self.m, bool) if mask is None else np.asarray(mask)
        for i in np.nonzero(mask)[0]:
            c = self.controllers[i]
            if hasattr(c, "reward"):
                c.reward(float(loss_drops[i]), np.asarray(new_states[i]))
            else:
                c.observe(float(loss_drops[i]), np.asarray(new_states[i]))


@dataclasses.dataclass
class History:
    """Recorded metrics, one entry per eval point."""
    step: list[int] = dataclasses.field(default_factory=list)
    loss: list[float] = dataclasses.field(default_factory=list)
    accuracy: list[float] = dataclasses.field(default_factory=list)
    energy_j: list[float] = dataclasses.field(default_factory=list)
    money: list[float] = dataclasses.field(default_factory=list)
    time_s: list[float] = dataclasses.field(default_factory=list)
    uplink_mb: list[float] = dataclasses.field(default_factory=list)
    rewards: list[float] = dataclasses.field(default_factory=list)
    drl_loss: list[float] = dataclasses.field(default_factory=list)
    # simulated server wall-clock: the slowest syncing device's window time
    # (semi_sync: at most the deadline)
    server_wall_s: list[float] = dataclasses.field(default_factory=list)

    def asdict(self):
        return dataclasses.asdict(self)


# ---------------------------------------------------------------------------
# the simulator
# ---------------------------------------------------------------------------

def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP {item})")


def eta_at(cfg: FLConfig, t: int) -> float:
    """eta(t) = lr * a / (a + t), rounded to f32 as ``jnp.float32(eta)``."""
    a = cfg.lr_decay_a
    return float(np.float32(cfg.lr * a / (a + t)))


def sgd_update(p: torch.Tensor, g: torch.Tensor, eta: float) -> torch.Tensor:
    """p - eta * g in f32, subnormals flushed as the reference's XLA:CPU
    flushes them: each operand, the product and the result."""
    return ftz(ftz(p) - ftz(eta * ftz(g)))


def flushed_sum(updates) -> torch.Tensor:
    """The sum of the updates (a non-empty sequence of (D,) rows), taken
    update by update, every add flushed as the reference's."""
    g_sum = ftz(updates[0])
    for g in updates[1:]:
        g_sum = ftz_add(g_sum, g)
    return g_sum


def server_mean_step(flat: torch.Tensor, g_sum: torch.Tensor, m: int
                     ) -> torch.Tensor:
    """flat - g_sum / M, flushed."""
    return ftz_add(flat, -ftz(div_f32(g_sum, m)))


def server_mean_update(flat: torch.Tensor, updates, m: int) -> torch.Tensor:
    """Algorithm 1 lines 20-21: flat - (sum of the synced updates) / M, the
    sum taken update by update, every op flushed as the reference's."""
    return server_mean_step(flat, flushed_sum(updates), m)


def server_sums(agg: str, cfg: FLConfig, g: torch.Tensor, t32: np.ndarray,
                deadline: float) -> tuple[tuple, torch.Tensor]:
    """The sums over devices that one diloco / semi_sync server round
    reduces, from the updates g (S, D) (S may be 0) with their f32 window
    times ``t32`` (S,): diloco ``(sum of g,)``, semi_sync ``(g_now,
    contrib)`` (:func:`.server.semi_sync_sums`); and the share of each
    update the server never applies, (S,) f32 on the host, zeros under
    diloco.  Sums over disjoint sets of devices add up to the sums over
    their union, which the sharded engine's psum reduce uses."""
    T = torch.from_numpy(np.asarray(t32, np.float32))
    if agg == "diloco":
        return (g.sum(0),), torch.zeros_like(T)
    alpha, cap = float(cfg.staleness_alpha), int(cfg.staleness_cap)
    mask = torch.ones(T.shape, dtype=torch.bool)
    undeliv = staleness_schedule(T, deadline, mask, alpha, cap)[3]
    g_now, contrib, _ = semi_sync_sums(g, T, mask, deadline, alpha, cap)
    return (g_now, contrib), undeliv


def server_step(agg: str, cfg: FLConfig, flat: torch.Tensor, state,
                sums: tuple, m: int) -> tuple[torch.Tensor, object]:
    """One diloco / semi_sync server round from the sums over every
    syncing device (:func:`server_sums`), normalised by ``m``: (new flat
    params, new server state)."""
    if agg == "diloco":
        delta = ftz(div_f32(ftz(sums[0]), m))
        return diloco_update(flat, state, delta, True, float(cfg.outer_lr),
                             float(cfg.outer_momentum))
    return semi_sync_update(flat, state, *sums, True, m)


def server_apply(agg: str, cfg: FLConfig, flat: torch.Tensor, state,
                 g: torch.Tensor, t32: np.ndarray, deadline: float, m: int
                 ) -> tuple[torch.Tensor, object, torch.Tensor]:
    """One diloco / semi_sync server round on the syncing devices'
    updates g (S, D) with their f32 window times ``t32`` (S,), normalised
    by ``m`` (the simulator's M, a population's cohort): (new flat params,
    new server state, the share of each update the server never applies,
    (S,) f32 on the host, zeros under diloco).  Both engines and the
    population call it (the reference's ``fl.py:641-653``,
    ``population.py:357-377``)."""
    sums, undeliv = server_sums(agg, cfg, g, t32, deadline)
    flat, state = server_step(agg, cfg, flat, state, sums, m)
    return flat, state, undeliv


def per_layer_g(u: torch.Tensor, ks: torch.Tensor, recv: torch.Tensor,
                k_cap: int, policy: str, backend: str, segments
                ) -> torch.Tensor:
    """g of the per-layer path on rows u (S, D) with budgets ``ks`` (S, C)
    and delivery masks ``recv`` (S, C) bool, under ``policy`` over the
    layer ``segments`` (a :class:`~repro_torch.kernels.SegmentTable`): both
    engines' and the population's (reference ``fl.py:680-699``,
    ``fl_batched.py:186-200``).

    cuda: the budgets, the candidate mask through the segmented kernels
    (looked up at each call, so a caller may wrap it), and the
    histogram-LGC pipeline on the masked u with zero error memory, its own
    e' dropped (one row launch of each LGC kernel).  exact:
    :func:`.compressor.per_layer_compress`."""
    if backend != "cuda":
        return per_layer_compress(u, ks, recv, segments, policy, k_cap)
    from repro_torch import kernels
    b = layer_budgets(policy, u, segments, ks.sum(1), k_cap)
    mask = kernels.per_layer_candidates_hist_rows(u, segments, b)
    masked = torch.where(mask, u, torch.zeros_like(u))
    g, _ = kernels.lgc_compress_hist_rows(
        torch.zeros_like(masked), masked, torch.cumsum(ks, 1),
        recv.to(torch.int32))
    return g


class _RewardLosses:
    """Reward-eval losses enqueued on the simulator's device: on the card a
    copy into pinned memory behind an event, so the host can dispatch more
    work before it reads them."""

    def __init__(self, losses: torch.Tensor):
        self.event = None
        if losses.device.type == "cuda":
            host = torch.empty(losses.shape, dtype=losses.dtype,
                               pin_memory=True)
            host.copy_(losses, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
            losses = host
        self.losses = losses

    def read(self) -> list[float]:
        if self.event is not None:
            self.event.synchronize()
        return self.losses.tolist()


def check_server_reduce(server_reduce: str) -> None:
    if server_reduce not in SERVER_REDUCES:
        raise ValueError(f"unknown server_reduce: {server_reduce!r}")


class LGCSimulator:
    """Runs Algorithm 1 for M devices with per-device controllers.

    ``device=None`` runs on the card and raises without CUDA; the CPU is
    asked for with ``device="cpu"``.  ``engine="sharded"`` spreads the
    batched engine's devices over the ranks of ``mesh`` (a
    :class:`repro_torch.launch.mesh.Mesh`; default: the ranks present, or
    this process alone) and reduces at the server by ``server_reduce``:
    "gather" (History bitwise the batched engine's) or "psum"."""

    def __init__(self, task: FLTask, cfg: FLConfig, controllers,
                 mode: str = "lgc", engine: str | None = None,
                 backend: str | None = None,
                 device: str | torch.device | None = None,
                 mesh=None, server_reduce: str = "gather"):
        self.task, self.cfg, self.mode = task, cfg, mode
        self.engine = engine or cfg.engine
        backend = backend or cfg.backend
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; expected one of "
                             f"{sorted(BACKENDS)}")
        self.backend = BACKENDS[backend]
        if self.engine not in ENGINES:
            raise ValueError(f"unknown engine {self.engine!r}")
        if self.engine == "sharded":
            check_server_reduce(server_reduce)
        self.mesh, self.server_reduce = mesh, server_reduce
        if (cfg.layer_policy != "global"
                and cfg.layer_policy not in LAYER_POLICIES):
            raise ValueError(
                f"unknown layer_policy {cfg.layer_policy!r}; expected "
                f"'global' or one of {sorted(LAYER_POLICIES)}")
        if cfg.action_space not in ACTION_SPACES:
            raise ValueError(
                f"unknown action_space {cfg.action_space!r}; expected "
                f"'shared' or 'per_device'")
        self.per_device = cfg.action_space == "per_device"
        self.agg = get_aggregator(cfg.aggregator)
        self.scenario = get_scenario(cfg.scenario)
        self.device = resolve_device(device)
        self.m_devices = len(task.device_data)
        self.fleet = (ControllerFleet(controllers)
                      if isinstance(controllers, (list, tuple))
                      else controllers)
        if self.fleet.m != self.m_devices:
            raise ValueError(f"{self.fleet.m} controllers for "
                             f"{self.m_devices} devices")

        dev = self.device
        params = task.init(prng.PRNGKey(cfg.seed))       # global model
        self.params = {k: v.to(dev) for k, v in params.items()}
        self.d = tree_size(self.params)
        self.server_state = (init_server_state(cfg, self.d, dev)
                             if self.agg.carries_state else None)
        self.server_wall_s = 0.0                     # simulated f64, host-side
        # the model's layer slices and their segment table, built once
        self.layer_slices = tree_layer_slices(self.params)
        self._segments = (layer_table(self.layer_slices, dev)
                          if cfg.layer_policy != "global" else None)
        self.profiles = (list(cfg.device_profiles) if cfg.device_profiles
                         else self.scenario.device_profiles(self.m_devices))

        # per-device state (Algorithm 1 line 1)
        self.w_hat = [self.params for _ in range(self.m_devices)]
        self.w_anchor = [flatten_tree(self.params)
                         for _ in range(self.m_devices)]
        self.ef = [init_ef(self.d, dev) for _ in range(self.m_devices)]
        self.next_sync = [0] * self.m_devices        # t at which device syncs
        self.win_start = [0] * self.m_devices        # t the decision committed
        self.decisions: list[RoundDecision | None] = [None] * self.m_devices
        self.staged: list[RoundDecision | None] = [None] * self.m_devices
        self.decision_log: list[tuple] = []          # (t, m, h, ks) committed
        self.prev_loss: list[float | None] = [None] * self.m_devices
        self.spend = [dict(energy_j=0.0, money=0.0, time_s=0.0, mb=0.0)
                      for _ in range(self.m_devices)]
        self.round_ms: list[float] = []              # host time per round

        self._base = prng.PRNGKey(cfg.seed + 1)       # event-key base
        self._data = [(torch.from_numpy(np.asarray(x)).to(dev),
                       torch.from_numpy(np.asarray(y)).to(dev))
                      for x, y in task.device_data]
        xe, ye = task.eval_data
        self._eval_xy = (torch.from_numpy(np.asarray(xe)).to(dev),
                         torch.from_numpy(np.asarray(ye)).to(dev))
        # scenario state: the (M, C) channel-chain carry of every device, on
        # the host (static: never advanced, its fields are never read)
        self._consts = stack_specs(cfg.channels)
        n_ch = len(cfg.channels)
        self._dev_ids = torch.arange(self.m_devices, dtype=torch.int64)
        self.scen_carry = stack_carries(
            [init_carry(self.scenario, self._base, m, n_ch)
             for m in range(self.m_devices)])
        self._reward_loss = torch.func.vmap(task.loss_fn, in_dims=(None, 0))

        # per_device observations: the static profile features (battery,
        # compute multiplier against the generic profile) and a host
        # snapshot of the per-channel chain state, refreshed at each sync
        base_prof = DeviceProfile()
        self._profile_feats = np.array(
            [[p.battery,
              p.comp_time_per_step_s / base_prof.comp_time_per_step_s]
             for p in self.profiles], np.float32)
        self._chan_state = np.ones((self.m_devices, n_ch), np.float32)
        self._update_chan_state()

    # -- environment ---------------------------------------------------------
    def _step_scenario(self, t0: int, te: int) -> None:
        """Step every device's channel chains through rounds t0 .. te-1,
        whether it syncs or not (the reference's ``_scen_step_all``)."""
        self.scen_carry = step_carry_rows(self.scenario, self._base,
                                          self.scen_carry, range(t0, te),
                                          self._dev_ids)

    # -- local computation ---------------------------------------------------
    def _sgd_step(self, params: dict, batch: tuple, eta: float) -> dict:
        """One local SGD step: the explicit gradient, then p - eta * g in
        f32 (``eta`` is an f32 value)."""
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        loss = self.task.loss_fn(leaves, batch)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        return {k: sgd_update(p.detach(), g, eta)
                for (k, p), g in zip(leaves.items(), grads)}

    def _sample_batch(self, m: int, t: int) -> tuple:
        x, y = self._data[m]
        key = stream_key(self._base, TAG_BATCH, t, m)
        idx = prng.randint(key, (self.cfg.batch_size,), 0, x.shape[0])
        idx = idx.to(self.device)
        return x[idx], y[idx]

    @torch.no_grad()
    def _eval_subset(self, tag: int, ids: tuple, n_take: int
                     ) -> tuple[float, float]:
        """(loss, accuracy) of the global model on a keyed eval subset."""
        xb, yb = self._eval_xy
        n = xb.shape[0]
        key = stream_key(self._base, tag, *ids)
        idx = prng.randint(key, (min(n_take, n),), 0, n).to(self.device)
        batch = (xb[idx], yb[idx])
        loss = self.task.loss_fn(self.params, batch)
        acc = self.task.metric_fn(self.params, batch)
        return float(loss), float(acc)

    # -- controller boundary -------------------------------------------------
    def _controller_states(self) -> np.ndarray:
        """Controller state of every device: (M, 4) resource spends, plus --
        under ``action_space="per_device"`` -- the device profile (battery,
        compute multiplier) and the per-channel chain-state snapshot, (M,
        4 + 2 + C) total (``controller.obs_dim``)."""
        spend = np.array([[s["energy_j"], s["money"], s["time_s"], s["mb"]]
                          for s in self.spend], np.float32)
        if not self.per_device:
            return spend
        return np.concatenate([spend, self._profile_feats, self._chan_state],
                              axis=1)

    def _update_chan_state(self) -> None:
        """Snapshot the (M, C) scenario carry into the per_device
        observation features: effective relative bandwidth exp(bw_log) *
        good per channel, f32 on the host."""
        if not self.per_device:
            return
        bw, good = self.scen_carry.bw_log.numpy(), self.scen_carry.good.numpy()
        self._chan_state = (np.exp(bw) * good).astype(np.float32)

    def _reward_rows(self, ms: Sequence[int], t: int) -> torch.Tensor:
        """(S, min(512, n)) eval rows of each device of ``ms``'s reward at
        round ``t``, from ``stream_key(base, TAG_REWARD, t, m)``, on the
        host."""
        n = int(self._eval_xy[0].shape[0])
        keys = stream_keys(self._base, TAG_REWARD, torch.tensor([t]),
                           torch.tensor(list(ms)))[0]
        return prng.randint_rows(keys, min(REWARD_SUBSET, n),
                                 torch.full((len(ms),), n))

    @torch.no_grad()
    def _reward_enqueue(self, ms: Sequence[int], t: int) -> _RewardLosses:
        """Enqueue the keyed-subset eval losses of the global model for the
        devices ``ms`` at round ``t``: all devices in one batched call
        (``vmap`` of the task's loss over their subsets)."""
        idx = self._reward_rows(ms, t)
        if self.device.type == "cuda":
            idx = idx.pin_memory().to(self.device, non_blocking=True)
        xe, ye = self._eval_xy
        return _RewardLosses(self._reward_loss(self.params,
                                               (xe[idx], ye[idx])))

    def _reward_read(self, pending: _RewardLosses) -> list[float]:
        """Wait for and read enqueued reward-eval losses."""
        return pending.read()

    def _reward_losses(self, ms: Sequence[int], t: int) -> list[float]:
        """The reward-eval losses of the devices ``ms`` at round ``t``."""
        return self._reward_read(self._reward_enqueue(ms, t))

    def _reward_need(self, ms: Sequence[int]) -> list[int]:
        return [m for m in ms if self.fleet.needs_reward[m]]

    def _observe_devices(self, ms: Sequence[int], t: int,
                         pending: _RewardLosses | None = None) -> None:
        """Reward Eq. (14)-(16): utility = (loss drop) / (resource spend),
        delivered to every synced reward-seeking device in one fleet call.
        ``pending``: the losses of :meth:`_reward_enqueue` on
        ``_reward_need(ms)``, enqueued earlier (the pipelined batched
        engine)."""
        need = self._reward_need(ms)
        if not need:
            return
        losses = (self._reward_read(pending) if pending is not None
                  else self._reward_losses(need, t))
        loss_drops = np.zeros(self.m_devices, np.float64)
        mask = np.zeros(self.m_devices, bool)
        for m, loss in zip(need, losses):
            if self.prev_loss[m] is not None:
                loss_drops[m] = self.prev_loss[m] - loss
                mask[m] = True
            self.prev_loss[m] = loss
        if mask.any():
            self.fleet.observe(loss_drops, self._controller_states(), mask)

    def _fleet_decide(self, ms: Sequence[int]) -> dict:
        """One fleet act for the devices in ``ms`` -> {m: RoundDecision}."""
        mask = np.zeros(self.m_devices, bool)
        mask[list(ms)] = True
        h_arr, ks_arr = self.fleet.act(self._controller_states(), mask)
        n_ch = len(self.cfg.channels)
        out = {}
        for m in ms:
            h = int(np.clip(int(h_arr[m]), 1, self.cfg.max_gap))
            # one layer per channel: pad/trim the controller's budgets
            ks = ([int(k) for k in ks_arr[m]] + [0] * n_ch)[:n_ch]
            out[m] = RoundDecision(h, ks)
        return out

    def _commit_decision(self, m: int, t: int, dec: RoundDecision) -> None:
        """Make ``dec`` the live decision for device ``m``'s next window:
        ``shared``, h_m rounds long; ``per_device``, max_gap rounds of which
        the device computes the first h_m."""
        self.decisions[m] = dec
        self.win_start[m] = t
        self.next_sync[m] = t + (self.cfg.max_gap if self.per_device
                                 else dec.h)
        self.decision_log.append((t, m, dec.h, tuple(dec.ks)))

    def _commit_staged(self, ms: Sequence[int], t: int) -> None:
        """Pipelined commit: adopt the decisions staged at each device's
        previous boundary (at t=0 the first act serves both the first
        window and the first staged decision)."""
        ms = list(ms)
        missing = [m for m in ms if self.staged[m] is None]
        if missing:
            fresh = self._fleet_decide(missing)
            for m in missing:
                self.staged[m] = fresh[m]
        for m in ms:
            self._commit_decision(m, t, self.staged[m])

    def _stage_decisions(self, ms: Sequence[int], t: int) -> None:
        """Pipelined stage: act now, commit at the next boundary."""
        ms = list(ms)
        if not ms:
            return
        fresh = self._fleet_decide(ms)
        for m in ms:
            self.staged[m] = fresh[m]

    def _decide_devices(self, ms: Sequence[int], t: int) -> None:
        """One controller boundary for the devices in ``ms``: commit their
        decisions for the window starting at ``t`` (and, pipelined, stage
        the decisions for the window after it)."""
        ms = list(ms)
        if not ms:
            return
        if self.cfg.pipeline_decisions:
            self._commit_staged(ms, t)
            self._stage_decisions(ms, t)
            return
        fresh = self._fleet_decide(ms)
        for m in ms:
            self._commit_decision(m, t, fresh[m])

    # -- main loop -----------------------------------------------------------
    def run(self) -> History:
        """Run ``cfg.rounds`` rounds of Algorithm 1 on the simulator's
        engine; ``self.round_ms`` gets each round's host time."""
        if self.engine == "loop":
            return self._run_loop()
        from .fl_batched import BatchedEngine, ShardedEngine
        self.batched_engine = (
            ShardedEngine(self, self.mesh, self.server_reduce)
            if self.engine == "sharded" else BatchedEngine(self))
        return self.batched_engine.run()

    def _run_loop(self) -> History:
        hist = History()
        cfg = self.cfg
        self.round_ms = []
        self._decide_devices(range(self.m_devices), 0)
        for t in range(cfg.rounds):
            t0 = time.perf_counter()
            self._step_scenario(t, t + 1)
            eta = eta_at(cfg, t)
            updates, walls, sync_ms, t32s = [], [], [], []
            for m in range(self.m_devices):
                # per_device: the device computes only the first h_m rounds
                # of its max_gap window and idles the rest
                if (not self.per_device
                        or t - self.win_start[m] < self.decisions[m].h):
                    batch = self._sample_batch(m, t)
                    self.w_hat[m] = self._sgd_step(self.w_hat[m], batch, eta)
                if t + 1 >= self.next_sync[m]:
                    g, total, t32 = self._sync_device(m, t)
                    updates.append(g)
                    sync_ms.append(m)
                    walls.append(total["time_s"])
                    t32s.append(t32)
            if updates:
                if self.agg.name == "mean":
                    flat = server_mean_update(flatten_tree(self.params),
                                              updates, self.m_devices)
                    self.params = unflatten_like(flat, self.params)
                    self.server_wall_s += max(walls)
                elif self.agg.name == "diloco":
                    self._apply_server_nonmean(updates, sync_ms, t32s, 1.0)
                    self.server_wall_s += max(walls)
                else:  # semi_sync: the server never waits past the deadline
                    deadline = self._window_deadline(sync_ms)
                    self._apply_server_nonmean(updates, sync_ms, t32s,
                                               deadline)
                    self.server_wall_s += min(deadline, max(walls))
                for m in sync_ms:
                    # broadcast: the device adopts the global model
                    self.w_hat[m] = self.params
                    self.w_anchor[m] = flatten_tree(self.params)
                self._update_chan_state()
                self._observe_devices(sync_ms, t)
                self._decide_devices(sync_ms, t + 1)
            if t % cfg.eval_every == 0 or t == cfg.rounds - 1:
                self._record(hist, t)
            self.round_ms.append((time.perf_counter() - t0) * 1e3)
        return hist

    # -- server --------------------------------------------------------------
    def _window_deadline(self, ms: Sequence[int]) -> float:
        """The semi-sync uplink deadline of the sync set ``ms`` (host f64,
        from the committed decisions, nominal channels and the straggler
        profiles, so both engines derive the same number)."""
        items = [(self.decisions[m].h, self.decisions[m].ks,
                  self.profiles[m]) for m in ms]
        return window_deadline(self.cfg, self.mode, self.d, items)

    def _server_apply(self, g: torch.Tensor, t32: np.ndarray,
                      deadline: float) -> tuple[torch.Tensor, torch.Tensor]:
        """One diloco / semi_sync server round on the syncing devices'
        updates g (S, D) (:func:`server_apply`, normalised by M): updates
        ``self.server_state`` and returns the new flat params and the
        undelivered shares.  ``self.params`` is left to the caller."""
        flat, self.server_state, undeliv = server_apply(
            self.agg.name, self.cfg, flatten_tree(self.params),
            self.server_state, g, t32, deadline, self.m_devices)
        return flat, undeliv

    def _apply_server_nonmean(self, updates: list, sync_ms: Sequence[int],
                              t32s: Sequence, deadline: float) -> None:
        """The loop engine's diloco / semi_sync round: the server math on
        the stacked updates (the reference pads them to a power of two,
        which changes no sum), and under semi_sync the undelivered share of
        each late update back into its device's error feedback."""
        flat, undeliv = self._server_apply(torch.stack(updates),
                                           np.asarray(t32s), deadline)
        self.params = unflatten_like(flat, self.params)
        for j, m in enumerate(sync_ms):
            un = float(undeliv[j])
            if un > 0.0:
                self.ef[m] = EFState(ftz_add(self.ef[m].e,
                                             ftz(un * updates[j])))

    # -- compression ---------------------------------------------------------
    def _ef_step(self, m: int, t: int, delta: torch.Tensor,
                 ks: Sequence[int], received: Sequence[bool]
                 ) -> torch.Tensor:
        """One error-compensated layered compression (backend-dispatched;
        with per-layer budgets under ``cfg.layer_policy``, u as one row of
        :func:`per_layer_g` with k_cap = D, as the reference's)."""
        if self.cfg.layer_policy != "global":
            dev = delta.device
            u = ftz_add(self.ef[m].e, delta)
            g = per_layer_g(
                u[None], torch.tensor([list(ks)], dtype=torch.int64,
                                      device=dev),
                torch.tensor([[bool(r) for r in received]], device=dev),
                self.d, self.cfg.layer_policy, self.backend,
                self._segments)[0]
            self.ef[m] = EFState(ftz_add(u, -g))
            return g
        if self.backend == "cuda":
            from repro_torch.kernels import lgc_compress_hist
            cum_ks = torch.tensor(np.cumsum(ks), dtype=torch.int32,
                                  device=delta.device)
            recv = torch.tensor([int(r) for r in received],
                                dtype=torch.int32, device=delta.device)
            g, e_new = lgc_compress_hist(self.ef[m].e, delta, cum_ks, recv)
            self.ef[m] = EFState(e_new)
            return g
        g, self.ef[m] = ef_compress(self.ef[m], delta, LGCCompressor(ks),
                                    received)
        return g

    def _sync_device(self, m: int, t: int):
        dec = self.decisions[m]
        k_ch = stream_key(self._base, TAG_CHANNEL, t, m)
        carry_m = ScenarioCarry(*(part[m] for part in self.scen_carry))
        ch = sample_from_carry(self.scenario, self._consts, carry_m, k_ch)
        if self.scenario.has_dropout:
            # a dropped sync loses the whole uplink (error feedback keeps
            # the mass); the broadcast still reaches the device
            drop = dropout_mask(self.scenario, self._base, t,
                                self._dev_ids[m:m + 1])[0]
            ch = ch._replace(up=ch.up & ~drop)
        up = [bool(u) for u in ch.up.tolist()]
        delta = ftz_add(self.w_anchor[m], -flatten_tree(self.w_hat[m]))

        if self.mode == "fedavg":
            # dense, no error feedback; the full model over the fastest
            # channel that is up -- with every channel down nothing is sent
            any_up = any(up)
            g = delta if any_up else torch.zeros_like(delta)
            bw = ch.bandwidth_mb_s * ch.up
            best = int(torch.argmax(bw))
            nbytes = [0] * len(self.cfg.channels)
            nbytes[best] = self.d * self.cfg.value_bytes if any_up else 0
        else:
            if self.mode == "topk":
                ks = [sum(dec.ks)] + [0] * (len(dec.ks) - 1)
            else:
                ks = list(dec.ks)
            received = up[:len(ks)]
            received += [True] * (len(ks) - len(received))
            g = self._ef_step(m, t, delta, ks, received)
            value_bytes = self.cfg.value_bytes
            if self.mode == "lgc_q8":
                # LGC + QSGD int8 values on the wire; the quantization
                # residual stays in the error memory
                kq = stream_key(self._base, TAG_QUANT, t, m)
                q, scale = qsgd_quantize(g, kq)
                g_deq = qsgd_dequantize(q, scale)
                self.ef[m] = EFState(ftz_add(self.ef[m].e,
                                             ftz_add(g, -g_deq)))
                g = g_deq
                value_bytes = 1
            nbytes = wire_bytes(ks, value_bytes, self.cfg.index_bytes)
            nbytes = [b if r else 0 for b, r in zip(nbytes, received)]
        cost = comm_cost(ch, nbytes)

        ccomp = comp_cost(self.profiles[m], dec.h)
        total = {
            "energy_j": float(cost["energy_j"]) + ccomp["energy_j"],
            "money": float(cost["money"]) + ccomp["money"],
            "time_s": float(cost["time_s"]) + ccomp["time_s"],
            "mb": float(sum(nbytes)) / 1e6,
        }
        for k, v in total.items():
            self.spend[m][k] += v
        # the f32 window time (comm + compute), the semi-sync staleness input
        t32 = np.float32(np.float32(float(cost["time_s"]))
                         + np.float32(ccomp["time_s"]))
        return g, total, t32

    def _record(self, hist: History, t: int):
        loss, acc = self._eval_subset(TAG_EVAL, (t,), EVAL_SUBSET)
        hist.step.append(t)
        hist.loss.append(loss)
        hist.accuracy.append(acc)
        hist.energy_j.append(sum(s["energy_j"] for s in self.spend))
        hist.money.append(sum(s["money"] for s in self.spend))
        hist.time_s.append(max(s["time_s"] for s in self.spend))
        hist.uplink_mb.append(sum(s["mb"] for s in self.spend))
        hist.server_wall_s.append(self.server_wall_s)


def baseline_ks(d: int) -> list[int]:
    """The baselines' fixed budget: 5% of D split 1/2, 1/4, 1/4 over the
    three channels."""
    k_total = max(1, d // 20)
    return [k_total // 2, k_total // 4, k_total - k_total // 2 - k_total // 4]


def baseline_simulator(task: FLTask, cfg: FLConfig, mode: str,
                       h: int = 4, ks: Sequence[int] | None = None,
                       engine: str | None = None, backend: str | None = None,
                       device: str | torch.device | None = None,
                       mesh=None, server_reduce: str = "gather"
                       ) -> LGCSimulator:
    """The simulator of :func:`run_baseline`, not yet run."""
    if ks is None:
        ks = baseline_ks(tree_size(task.init(prng.PRNGKey(0))))
    ctrls = [FixedController(h, ks) for _ in task.device_data]
    return LGCSimulator(task, cfg, ctrls, mode=mode, engine=engine,
                        backend=backend, device=device, mesh=mesh,
                        server_reduce=server_reduce)


def run_baseline(task: FLTask, cfg: FLConfig, mode: str,
                 h: int = 4, ks: Sequence[int] | None = None,
                 engine: str | None = None, backend: str | None = None,
                 device: str | torch.device | None = None,
                 mesh=None, server_reduce: str = "gather") -> History:
    """FedAvg / LGC-noDRL / Top-k / LGC+QSGD with fixed controllers; ``ks``
    defaults to 5% of D split 1/2, 1/4, 1/4 over the three channels.
    ``mesh`` and ``server_reduce`` are the sharded engine's."""
    return baseline_simulator(task, cfg, mode, h, ks, engine, backend,
                              device, mesh, server_reduce).run()
