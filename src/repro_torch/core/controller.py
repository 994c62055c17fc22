"""Learning-based control algorithm (paper §3): per-device DDPG.

Port of ``repro/core/controller.py``.  Each device runs its own agent
deciding, at every synchronization, its

  * H_m      -- number of local computation steps until the next sync
  * D_{m,n}  -- gradient entries allocated to channel n (the LGC layer sizes)

State  (Eq. 11-12): per-resource communication/computation consumption.
Action (Eq. 13):    a = (H, D_1..D_N), continuous, squashed by tanh.
Reward (Eq. 14-16): weighted ratio of utility U = (loss drop)/(spend).

DDPG (Lillicrap et al. 2015): deterministic actor pi(s|theta_pi), critic
Q(s,a|theta_Q), replay buffer, soft target networks, Gaussian exploration
noise.

Two views share every piece of math and the counter-based
:func:`.scenario.stream_key` randomness (exploration noise on
``TAG_CTRL_NOISE``, replay sampling on ``TAG_CTRL_SAMPLE``), so they are
bitwise equal for a fixed seed on one device:

* :class:`FleetDDPG`      -- M agents.  ``act`` / ``observe`` serve the
  whole fleet at a sync boundary (the batched controller protocol of
  :mod:`.fl`): the masked devices' states go up in one copy and their
  actions come back in one read; the warm devices' replay batches go up
  in one copy and they train together.  Device m is seeded
  ``PRNGKey(seed + 17*m)``.
* :class:`DDPGController` -- one agent, one device: a fleet of size one
  exposing the classic per-device interface; element m of
  :func:`make_ddpg_controllers` equals device m of :func:`make_fleet_ddpg`,
  bit for bit.

The matmuls run device by device, the same calls on the same shapes for
a fleet and for a list (the reference keeps that invariant with
``lax.map``; a batched matmul over M could sum in another order), and
everything elementwise gives each row the bits it would get alone, so the
fleet == list invariant holds on the CPU and on the card
(tests/test_torch_controller.py, tests/test_torch_cuda.py).  The
randomness is bitwise the reference's: the initial nets, the noise, the
replay indices.  So is XLA:CPU's elementwise arithmetic (its ``tanh``,
AdamW's fused multiply-adds) and the policy's forward in training (see
:func:`xla_dot`); the other sums (the act path's and the critics' dots,
the gradients) agree to summation order, so two whole runs on two
backends may part where an action lies on a decode edge.

The nets live on the fleet's device (``device=None``: the card, raising
without CUDA); on the card they run on a stream of their own, so a fleet's
launches and reads never wait behind the engine's window.  States,
rewards, decisions, exploration noise and the replay buffer stay on the
host as numpy.
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.optim import optimizers as optim

from . import prng
from .fl import RoundDecision
from .scenario import TAG_CTRL_NOISE, TAG_CTRL_SAMPLE, stream_key


# ---------------------------------------------------------------------------
# XLA:CPU's f32 tanh
# ---------------------------------------------------------------------------
#
# The reference's tanh is XLA:CPU's rational approximation (Eigen's
# ``generic_fast_tanh_float``: inputs clamped to +-7.99881172, odd degree-13
# over even degree-6 polynomials in x^2 with every multiply-add fused, x
# itself below |x| = 0.0004), not libm's: it saturates to exactly +-1 where
# libm's stays below, which zeroes the gradient there.  Its derivative is
# jax's ``(g + g * y) * (1 - y)`` as XLA fuses it, ``fma(g * (1 - y), y,
# g * (1 - y))``.  Both are bitwise XLA's (tests/test_torch_controller.py).

_TANH_CLAMP = 7.99881172180175781
_TANH_NUM = (-2.76076847742355e-16, 2.00018790482477e-13,
             -8.60467152213735e-11, 5.12229709037114e-08,
             1.48572235717979e-05, 6.37261928875436e-04,
             4.89352455891786e-03)
_TANH_DEN = (1.19825839466702e-06, 1.18534705686654e-04,
             2.26843463243900e-03, 4.89352518554385e-03)


def xla_tanh(x: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's f32 ``tanh``."""
    xc = torch.clamp(x, -_TANH_CLAMP, _TANH_CLAMP)
    x2 = xc * xc
    y = (xc * prng._horner(x2, _TANH_NUM)) / prng._horner(x2, _TANH_DEN)
    return torch.where(x.abs() < 0.0004, x, y)


class _Tanh(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = xla_tanh(x)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        gk = g * (1 - y)
        return prng.fma32(gk, y, gk)


# ---------------------------------------------------------------------------
# XLA:CPU's small dots
# ---------------------------------------------------------------------------
#
# The reference's training dots sum in the orders of XLA:CPU's dot
# emitters, every step a fused multiply-add: an (B, K) x (K, 64) product
# (B >= 2) in K order, the actor's (B, 64) x (64, 4) last layer in four
# lanes of every fourth k, the lanes summed pairwise.  :func:`xla_dot`
# computes these orders exactly (tests/test_torch_controller.py holds them
# against jax), the same on the CPU and on the card, and the actor's
# forward in training takes it, so the policy's tanh sees the reference's
# inputs bit for bit.  Where the tanh saturates, its gradient (1 - y) is a
# few ulps, a last-bit change of its input changes that gradient by its
# whole size, and AdamW's normalization passes it on to the weight in
# full.  Everything else (the act path, the critics, the targets, the
# gradients' dots) is plain matmuls, device by device: their sums need no
# such care.

def _dot_lanes(x: torch.Tensor, w: torch.Tensor, lanes: int
               ) -> torch.Tensor:
    """(T, B, K) x (T, K, N) -> (T, B, N) f32: ``lanes`` accumulators, lane
    l summing the products of k = l, l + lanes, ... in order with fused
    multiply-adds, then the lanes summed pairwise."""
    t, b, k = x.shape
    n = w.shape[-1]
    pad = -k % lanes
    if pad:        # zero products add nothing
        x = torch.nn.functional.pad(x, (0, pad))
        w = torch.nn.functional.pad(w, (0, 0, 0, pad))
    prods = (x.double()[..., :, None] * w.double()[:, None]).reshape(
        t, b, -1, lanes, n)                       # exact f32 products
    acc = torch.zeros((t, b, lanes, n), dtype=torch.float32,
                      device=x.device)
    for i in range(prods.shape[2]):
        acc = prng.add_f32(prods[:, :, i], acc)
    parts = list(acc.unbind(2))
    while len(parts) > 1:
        parts = [parts[2 * i] + parts[2 * i + 1]
                 for i in range(len(parts) // 2)]
    return parts[0]


class _XlaDot(torch.autograd.Function):
    """:func:`_dot_lanes` forward; plain matmuls device by device back."""

    @staticmethod
    def forward(ctx, x, w, lanes):
        ctx.save_for_backward(x, w)
        return _dot_lanes(x, w, lanes)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = torch.stack([g[j] @ w[j].T for j in range(g.shape[0])])
        if ctx.needs_input_grad[1]:
            gw = torch.stack([x[j].T @ g[j] for j in range(g.shape[0])])
        return gx, gw, None


def xla_dot(x: torch.Tensor, w: torch.Tensor, lanes: int = 1
            ) -> torch.Tensor:
    """Per device t: x[t] (B, K) @ w[t] (K, N) in XLA:CPU's order
    (``lanes`` 1: K order; 4: the four-lane order of a 4-wide product)."""
    return _XlaDot.apply(x, w, lanes)


# ---------------------------------------------------------------------------
# tiny MLPs, each net one flat f32 vector
# ---------------------------------------------------------------------------

def _mlp_init(key: torch.Tensor, sizes) -> list[dict]:
    """Layers ``{"w": normal * sqrt(2 / fan_in), "b": 0}`` on the host,
    each weight drawn from its own ``split`` key, as the reference draws
    them."""
    params = []
    for a, b in zip(sizes[:-1], sizes[1:]):
        k1, key = prng.split(key)
        params.append({"w": prng.normal(k1, (a, b)) * (2 / a) ** 0.5,
                       "b": torch.zeros((b,))})
    return params


def _flatten(layers: list[dict]) -> torch.Tensor:
    """Layers -> one flat vector: w0, b0, w1, b1, ..."""
    return torch.cat([t.reshape(-1) for layer in layers
                      for t in (layer["w"], layer["b"])])


def _layers(flat: torch.Tensor, sizes) -> list[dict]:
    """Views of flat nets (..., P) as layers ``{"w" (..., a, b), "b" (...,
    b)}``."""
    out, o = [], 0
    lead = flat.shape[:-1]
    for a, b in zip(sizes[:-1], sizes[1:]):
        w = flat[..., o:o + a * b].reshape(lead + (a, b))
        o += a * b
        out.append({"w": w, "b": flat[..., o:o + b]})
        o += b
    return out


def _mlp_pre(layers: list[dict], x: torch.Tensor,
             lanes: int | None = None) -> torch.Tensor:
    """The MLPs of T devices (layers stacked on a leading T axis) on their
    inputs x (T, B, K), up to the last layer's output (relu between
    layers).  ``lanes=None``: plain matmuls, device by device; else every
    dot in XLA:CPU's order, the last one in ``lanes`` lanes."""
    for i, layer in enumerate(layers):
        w, b = layer["w"], layer["b"][:, None, :]
        if lanes is None:
            x = torch.stack([x[j] @ w[j] for j in range(x.shape[0])]) + b
        else:
            x = xla_dot(x, w, lanes if i == len(layers) - 1 else 1) + b
        if i < len(layers) - 1:
            x = torch.relu(x)
    return x


# ---------------------------------------------------------------------------
# shared pure pieces: state norm, action decode, noise, replay sampling
# ---------------------------------------------------------------------------

def _norm_states(states: np.ndarray) -> np.ndarray:
    """log-scale resources so the MLPs see O(1) numbers."""
    return np.log1p(np.maximum(states, 0)).astype(np.float32)


# observation layouts per action space: the "shared" space observes the
# four Eq. (11) resource spends; "per_device" appends the device's own
# profile -- battery, compute-time multiplier -- and the realized
# per-channel state from the scenario carry.  BATTERY_COL indexes battery in
# the RAW (un-normalized) per_device state vector; decode_actions reads it
# for the energy clamp.
SPEND_DIM = 4                 # energy, money, time, mb (Eq. 11)
PROFILE_DIM = 2               # battery, compute-time multiplier
BATTERY_COL = SPEND_DIM


def obs_dim(n_channels: int, action_space: str) -> int:
    """Width of the observation vector the simulator builds
    (:meth:`.fl.LGCSimulator._controller_states`) for each action space;
    ``DDPGConfig.state_dim`` must equal it."""
    if action_space == "shared":
        return SPEND_DIM
    if action_space == "per_device":
        return SPEND_DIM + PROFILE_DIM + n_channels
    raise ValueError(f"unknown action_space {action_space!r}; "
                     f"expected 'shared' or 'per_device'")


def decode_actions(a: np.ndarray, h_max: int, k_total_max: int,
                   n_channels: int, battery: np.ndarray | None = None
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Decode raw tanh actions ``(..., 1+C)`` into ``h (...,)`` local-step
    counts and ``ks (..., C)`` per-channel budgets with ``1 <= ks`` and
    ``sum(ks) <= max(n_channels, k_total_max)`` -- the per-device budget
    clamp holds row by row, not just in aggregate.

    ``battery`` (same leading shape as ``a``, values in [0, 1]) applies the
    per-device energy clamp of the heterogeneous action space:
    ``h <= 1 + floor(battery * (h_max - 1))``, so a zero-battery device is
    pinned to the one mandatory local step no matter what its policy says.
    ``battery=None`` (the shared action space) leaves ``h`` untouched.

    Elementwise numpy, so decoding one action and decoding a stacked batch
    of them are bit-identical -- the fleet and the per-device agents share
    this decoder.
    """
    a = np.asarray(a, np.float32)
    squeeze = a.ndim == 1
    a = np.atleast_2d(a)
    h = np.rint((a[:, 0] + 1) / 2 * (h_max - 1)).astype(np.int64) + 1
    if battery is not None:
        soc = np.clip(np.atleast_1d(np.asarray(battery, np.float64)), 0.0, 1.0)
        h_cap = 1 + np.floor(soc * (h_max - 1)).astype(np.int64)
        h = np.minimum(h, h_cap)
    # channel allocations: softmax-ish positive split of the budget
    w = np.exp(2.0 * a[:, 1:])
    w = w / w.sum(-1, keepdims=True)
    k_total = max(n_channels, k_total_max)
    ks = np.maximum((w * k_total).astype(np.int64), 1)
    # raising rounded-down layers to >= 1 can overshoot the budget by up to
    # C-1 coordinates; shave the largest layer until the budget holds (the
    # largest is >= 2 whenever the sum exceeds k_total >= C, so ks stays >= 1)
    for _ in range(n_channels):
        over = ks.sum(-1) > k_total
        if not over.any():
            break
        rows = np.nonzero(over)[0]
        ks[rows, np.argmax(ks[rows], -1)] -= 1
    if squeeze:
        return h[0], ks[0]
    return h, ks


def _noise(bases, counters: np.ndarray, n: int) -> torch.Tensor:
    """Standard normal exploration noise (K, n) f32 on the host: row k
    from ``stream_key(bases[k], TAG_CTRL_NOISE, counters[k])``, as the
    reference draws it."""
    keys = torch.stack([stream_key(b, TAG_CTRL_NOISE, int(c))
                        for b, c in zip(bases, counters)])
    return prng.normal_rows(keys, n)


def _replay_indices(base: torch.Tensor, n_train: int, n_filled: int,
                    batch_size: int) -> np.ndarray:
    """The replay rows one train step samples: uniform over the filled
    prefix, from ``stream_key(base, TAG_CTRL_SAMPLE, n_train)``."""
    key = stream_key(base, TAG_CTRL_SAMPLE, int(n_train))
    return prng.randint(key, (batch_size,), 0, max(int(n_filled), 1)).numpy()


# ---------------------------------------------------------------------------
# DDPG agent
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DDPGConfig:
    # observation width: must equal obs_dim(n_channels, action_space) --
    # 4 (energy, money, time, mb per Eq. 11) for "shared", 4 + 2 + C
    # (+ battery, compute multiplier, per-channel state) for "per_device".
    state_dim: int = 4
    n_channels: int = 3
    h_max: int = 8               # cap on local steps (paper's H bound)
    k_total_max: int = 0         # max coords/round; set from model size
    hidden: int = 64
    gamma: float = 0.95          # discount (paper's gamma_m)
    tau: float = 0.01            # soft target update
    buffer_size: int = 4096
    batch_size: int = 64
    noise_sigma: float = 0.2
    noise_decay: float = 0.999
    lr: float = 1e-3
    seed: int = 0
    # optimistic compute prior: added to the raw h action (column 0) before
    # decode, then clipped back to [-1, 1]; decode-side only (the replay
    # buffer stores the raw actor action)
    h_prior: float = 0.0
    # "shared": every device decides (h, k_1..k_C) from the 4-wide spend
    # state; "per_device": profile-augmented observations, battery-clamped
    # h_m, uniform max_gap sync windows with masked steps
    action_space: str = "shared"

    def __post_init__(self):
        expected = obs_dim(self.n_channels, self.action_space)  # validates
        if self.state_dim != expected:
            raise ValueError(
                f"DDPGConfig.state_dim={self.state_dim} does not match the "
                f"observation vector the simulator builds for "
                f"action_space={self.action_space!r} with "
                f"{self.n_channels} channels: expected width {expected} "
                f"(see repro_torch.core.controller.obs_dim)")


class ReplayBuffer:
    """Host-side reference of the fleet's per-device ring buffer semantics
    (insert at idx mod capacity, uniform sample over the filled prefix)."""

    def __init__(self, capacity: int, state_dim: int, action_dim: int):
        self.s = np.zeros((capacity, state_dim), np.float32)
        self.a = np.zeros((capacity, action_dim), np.float32)
        self.r = np.zeros((capacity,), np.float32)
        self.s2 = np.zeros((capacity, state_dim), np.float32)
        self.n, self.idx, self.capacity = 0, 0, capacity

    def add(self, s, a, r, s2):
        i = self.idx
        self.s[i], self.a[i], self.r[i], self.s2[i] = s, a, r, s2
        self.idx = (i + 1) % self.capacity
        self.n = min(self.n + 1, self.capacity)

    def sample(self, rng: np.random.Generator, batch: int):
        idx = rng.integers(0, self.n, batch)
        return self.s[idx], self.a[idx], self.r[idx], self.s2[idx]


class DDPGController:
    """One device's agent: the per-device view of a single-device fleet.

    Implements the classic controller interface (``act(state) ->
    RoundDecision``, ``reward(loss_drop, new_state)``) consumed through the
    :class:`.fl.ControllerFleet` shim.  Internally a :class:`FleetDDPG` of
    size one, running the same calls as each device of a fleet."""

    def __init__(self, cfg: DDPGConfig,
                 device: str | torch.device | None = None):
        self.cfg = cfg
        self.action_dim = 1 + cfg.n_channels
        self._fleet = FleetDDPG(1, cfg, device=device)

    @property
    def actor(self) -> list[dict]:
        return self._fleet.net("actor", 0)

    @property
    def critic(self) -> list[dict]:
        return self._fleet.net("critic", 0)

    @property
    def actor_t(self) -> list[dict]:
        return self._fleet.net("actor_t", 0)

    @property
    def critic_t(self) -> list[dict]:
        return self._fleet.net("critic_t", 0)

    @property
    def sigma(self) -> float:
        return float(self._fleet._sigma[0])

    @property
    def rewards(self) -> list[float]:
        return self._fleet.rewards[0]

    @property
    def critic_losses(self) -> list[float]:
        return self._fleet.critic_losses[0]

    def act(self, state: np.ndarray) -> RoundDecision:
        h, ks = self._fleet.act(np.asarray(state, np.float32)[None])
        return RoundDecision(int(h[0]), [int(k) for k in ks[0]])

    def allocation(self, state: np.ndarray) -> RoundDecision:
        """Greedy decision for ``state`` (no exploration noise; advances no
        random stream) -- the public read-only view of the learned policy."""
        h, ks = self._fleet.allocation(np.asarray(state, np.float32)[None])
        return RoundDecision(int(h[0]), [int(k) for k in ks[0]])

    def reward(self, loss_drop: float, new_state: np.ndarray):
        """Called by the simulator after the round (Eq. 14-16 computed from
        loss drop and the *incremental* spend recorded in the state)."""
        self._fleet.observe(np.array([loss_drop], np.float64),
                            np.asarray(new_state, np.float32)[None])


# ---------------------------------------------------------------------------
# the fleet: M agents, served at once per sync boundary
# ---------------------------------------------------------------------------

class FleetDDPG:
    """A bank of M DDPG agents.

    Implements the batched controller protocol of :mod:`.fl`: ``act`` runs
    every masked device's policy plus exploration noise; ``observe``
    inserts (s, a, r, s') transitions into each device's replay buffer,
    samples replay batches, and runs the DDPG train step for every device
    whose buffer is warm.

    Each net of the M devices is one row of an (M, P) f32 tensor on the
    fleet's device (``actor``, ``critic``, ``actor_t``, ``critic_t``, and
    the AdamW moments ``opt_a`` / ``opt_c`` with host step counts).  The
    matmuls run device by device (one device's rows never meet another's
    in a sum); everything elementwise -- the tanh, the AdamW step, the soft
    target update -- runs once over the rows of the devices concerned,
    which gives each row the bits it would get alone.  A call uploads its
    inputs once and reads its outputs once, on the fleet's own stream on
    the card.

    Per-device randomness is counter-based (``stream_key`` on the device's
    own ``PRNGKey(seed + 17*m)``), so a fleet is bit-identical to the list
    :func:`make_ddpg_controllers` builds with the same arguments.
    ``device=None`` is the card (raising without CUDA); the CPU is asked
    for with ``device="cpu"``."""

    NETS = ("actor", "critic", "actor_t", "critic_t")

    def __init__(self, m_devices: int, cfg: DDPGConfig,
                 device: str | torch.device | None = None):
        self.cfg, self.m = cfg, m_devices
        self.device = resolve_device(device)
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self.action_dim = 1 + cfg.n_channels
        self.sizes = {
            "actor": (cfg.state_dim, cfg.hidden, cfg.hidden,
                      self.action_dim),
            "critic": (cfg.state_dim + self.action_dim, cfg.hidden,
                       cfg.hidden, 1)}
        self.sizes |= {"actor_t": self.sizes["actor"],
                       "critic_t": self.sizes["critic"]}
        self._bases = [prng.PRNGKey(cfg.seed + 17 * i)
                       for i in range(m_devices)]
        actors, critics = [], []
        for base in self._bases:
            ka, kc = prng.split(base)
            actors.append(_flatten(_mlp_init(ka, self.sizes["actor"])))
            critics.append(_flatten(_mlp_init(kc, self.sizes["critic"])))
        with self._on_stream():
            self.actor = torch.stack(actors).to(self.device)
            self.critic = torch.stack(critics).to(self.device)
            self.actor_t = self.actor.clone()
            self.critic_t = self.critic.clone()
            zeros = np.zeros(m_devices, np.int64)
            self.opt_a = optim.AdamWState(
                zeros.copy(), torch.zeros_like(self.actor),
                torch.zeros_like(self.actor))
            self.opt_c = optim.AdamWState(
                zeros.copy(), torch.zeros_like(self.critic),
                torch.zeros_like(self.critic))
        # per-device ring replay buffers, on the host
        cap = cfg.buffer_size
        self._buf_s = np.zeros((m_devices, cap, cfg.state_dim), np.float32)
        self._buf_a = np.zeros((m_devices, cap, self.action_dim), np.float32)
        self._buf_r = np.zeros((m_devices, cap), np.float32)
        self._buf_s2 = np.zeros((m_devices, cap, cfg.state_dim), np.float32)
        self._n = np.zeros(m_devices, np.int64)
        self._idx = np.zeros(m_devices, np.int64)
        # host-side per-device event counters / exploration schedule
        self._n_act = np.zeros(m_devices, np.int64)
        self._n_train = np.zeros(m_devices, np.int64)
        self._sigma = np.full(m_devices, cfg.noise_sigma, np.float64)
        self._last_s = np.zeros((m_devices, cfg.state_dim), np.float32)
        self._last_a = np.zeros((m_devices, self.action_dim), np.float32)
        self._has_last = np.zeros(m_devices, bool)
        self.needs_reward = np.ones(m_devices, bool)
        self.rewards: list[list[float]] = [[] for _ in range(m_devices)]
        self.critic_losses: list[list[float]] = [[] for _ in range(m_devices)]
        self._ocfg = optim.OptimizerConfig(lr=cfg.lr, warmup_steps=1,
                                           weight_decay=0.0)

    def net(self, name: str, i: int) -> list[dict]:
        """Device ``i``'s net ``name`` as layers ``{"w", "b"}`` (views)."""
        return _layers(getattr(self, name)[i], self.sizes[name])

    def _on_stream(self):
        """The fleet's stream on the card (nothing on the CPU)."""
        return (torch.cuda.stream(self._stream) if self._stream is not None
                else contextlib.nullcontext())

    def _mask(self, mask) -> np.ndarray:
        return (np.ones(self.m, bool) if mask is None
                else np.asarray(mask, bool))

    def _check_width(self, states: np.ndarray) -> np.ndarray:
        """Observation width must match cfg.state_dim (the replay buffer and
        MLPs are built from it); raise with both shapes instead of silently
        training on a misaligned state vector."""
        states = np.asarray(states, np.float32)
        if states.shape[-1] != self.cfg.state_dim:
            raise ValueError(
                f"observation width {states.shape[-1]} (states shape "
                f"{states.shape}) does not match DDPGConfig.state_dim="
                f"{self.cfg.state_dim} for action_space="
                f"{self.cfg.action_space!r}")
        return states

    def _battery(self, states: np.ndarray) -> np.ndarray | None:
        """Battery column of the RAW per_device state (None when shared)."""
        if self.cfg.action_space != "per_device":
            return None
        return states[:, BATTERY_COL]

    def _with_prior(self, a: np.ndarray) -> np.ndarray:
        """Apply the optimistic compute prior (cfg.h_prior) to the raw h
        action before decode; identity at the 0.0 default."""
        if not self.cfg.h_prior:
            return a
        a = a.copy()
        a[:, 0] = np.clip(a[:, 0] + self.cfg.h_prior, -1.0, 1.0)
        return a

    def _policy(self, s: np.ndarray, rows) -> torch.Tensor:
        """tanh policy outputs (len(rows), 1+C) f32 on the host of the
        devices ``rows`` on their normalized states ``s`` (len(rows), S):
        one upload, one read."""
        with self._on_stream(), torch.no_grad():
            x = torch.from_numpy(s).to(self.device)[:, None, :]
            idx = torch.as_tensor(np.asarray(rows), device=self.device)
            actor = _layers(self.actor.index_select(0, idx),
                            self.sizes["actor"])
            return xla_tanh(_mlp_pre(actor, x))[:, 0].cpu()

    # -- batched controller protocol ------------------------------------
    def act(self, states: np.ndarray, mask: np.ndarray | None = None
            ) -> tuple[np.ndarray, np.ndarray]:
        """(h (M,), ks (M, C)) for the masked devices (unmasked rows are
        placeholders and advance nothing)."""
        mask = self._mask(mask)
        states = self._check_width(states)
        s = _norm_states(states)
        rows = np.nonzero(mask)[0]
        a = np.zeros((self.m, self.action_dim), np.float32)
        if len(rows):
            pi = self._policy(s[rows], rows)
            noise = _noise([self._bases[i] for i in rows], self._n_act[rows],
                           self.action_dim)
            sigma = torch.from_numpy(self._sigma[rows].astype(np.float32))
            # pi + sigma * noise, fused as XLA fuses it, then clipped
            a[rows] = torch.clamp(prng.fma32(sigma[:, None].expand_as(noise),
                                             noise, pi), -1.0, 1.0).numpy()
        self._last_s[mask] = s[mask]
        self._last_a[mask] = a[mask]
        self._has_last |= mask
        self._n_act[mask] += 1
        self._sigma[mask] *= self.cfg.noise_decay
        cfg = self.cfg
        return decode_actions(self._with_prior(a), cfg.h_max,
                              cfg.k_total_max, cfg.n_channels,
                              battery=self._battery(states))

    def observe(self, loss_drops: np.ndarray, new_states: np.ndarray,
                mask: np.ndarray | None = None):
        """Reward + replay insert + (buffer-warm) train for all masked
        devices at once."""
        new_states = self._check_width(new_states)
        mask = self._mask(mask) & self._has_last
        if not mask.any():
            return
        cfg = self.cfg
        s2 = _norm_states(new_states)
        spend = np.maximum(s2 - self._last_s, 1e-6).sum(-1)
        r = np.clip(np.asarray(loss_drops, np.float64)
                    / spend.astype(np.float64), -10.0, 10.0)
        rows = np.nonzero(mask)[0]
        for i in rows:
            self.rewards[i].append(float(r[i]))
            j = self._idx[i]                         # ring insert
            self._buf_s[i, j] = self._last_s[i]
            self._buf_a[i, j] = self._last_a[i]
            self._buf_r[i, j] = np.float32(r[i])
            self._buf_s2[i, j] = s2[i]
        cap = cfg.buffer_size
        self._n[mask] = np.minimum(self._n[mask] + 1, cap)
        self._idx[mask] = (self._idx[mask] + 1) % cap
        warm = rows[self._n[rows] >= cfg.batch_size]
        if len(warm):
            self._train_rows(warm)
        self._has_last[mask] = False

    def _train_rows(self, warm: np.ndarray) -> None:
        """One DDPG step (critic TD step, actor ascent, soft target update;
        the reference's ``controller.py:183-213``) of each device of
        ``warm`` on its replay sample.  The batches go up in one copy and
        the critic losses come back in one read."""
        cfg, sd, ad = self.cfg, self.cfg.state_dim, self.action_dim
        packed = []
        for i in warm:
            idx = _replay_indices(self._bases[i], self._n_train[i],
                                  self._n[i], cfg.batch_size)
            packed.append(np.concatenate(
                [self._buf_s[i, idx], self._buf_a[i, idx],
                 self._buf_r[i, idx, None], self._buf_s2[i, idx]], 1))
        with self._on_stream():
            batch = torch.from_numpy(np.stack(packed)).to(self.device)
            s, a = batch[..., :sd], batch[..., sd:sd + ad]
            r, s2 = batch[..., sd + ad], batch[..., sd + ad + 1:]
            rows = torch.from_numpy(warm).to(self.device)
            nets = {k: getattr(self, k).index_select(0, rows)
                    for k in self.NETS}
            opt_a, opt_c = (optim.AdamWState(o.step[warm],
                                             o.m.index_select(0, rows),
                                             o.v.index_select(0, rows))
                            for o in (self.opt_a, self.opt_c))
            actor, critic, opt_a, opt_c, cl = self._ddpg_step(
                nets, opt_a, opt_c, s, a, r, s2)
            tau = cfg.tau

            def soft(t, o):
                return prng.fma32(torch.full_like(t, 1 - tau), t, tau * o)
            new = {"actor": actor, "critic": critic,
                   "actor_t": soft(nets["actor_t"], actor),
                   "critic_t": soft(nets["critic_t"], critic)}
            for k in self.NETS:
                getattr(self, k).index_copy_(0, rows, new[k])
            for name, o in (("opt_a", opt_a), ("opt_c", opt_c)):
                full = getattr(self, name)
                full.step[warm] = o.step
                full.m.index_copy_(0, rows, o.m)
                full.v.index_copy_(0, rows, o.v)
            cl_np = cl.cpu().numpy()
        for j, i in enumerate(warm):
            self.critic_losses[i].append(float(cl_np[j]))
        self._n_train[warm] += 1

    def _ddpg_step(self, nets: dict, opt_a, opt_c, s, a, r, s2):
        """The critic and actor updates of the rows of ``nets`` (T, P) on
        their batches (T, B, .): (actor, critic, opt_a, opt_c, critic
        losses (T,))."""
        cfg, sa, sc = self.cfg, self.sizes["actor"], self.sizes["critic"]
        n = s.shape[0]
        with torch.no_grad():
            a2 = xla_tanh(_mlp_pre(_layers(nets["actor_t"], sa), s2))
            q_next = _mlp_pre(_layers(nets["critic_t"], sc),
                              torch.cat([s2, a2], -1))[..., 0]
            y = prng.fma32(torch.full_like(q_next, cfg.gamma), q_next, r)
        with torch.enable_grad():                                # Eq. (18)
            cp = nets["critic"].detach().requires_grad_(True)
            q = _mlp_pre(_layers(cp, sc), torch.cat([s, a], -1))
            cl = torch.stack([torch.mean((q[j, :, 0] - y[j]) ** 2)
                              for j in range(n)])
            (gc,) = torch.autograd.grad(cl.sum(), cp)
        with torch.no_grad():
            critic, opt_c = self._adam(gc, opt_c, nets["critic"], "critic")
        with torch.enable_grad():
            ap = nets["actor"].detach().requires_grad_(True)
            # the policy's tanh input bit for bit the reference's: the
            # gradient through a saturated tanh is a few ulps of (1 - y)
            lanes = 4 if s.shape[1] > 1 else 1
            pi = _Tanh.apply(_mlp_pre(_layers(ap, sa), s, lanes))
            q_pi = _mlp_pre(_layers(critic, sc), torch.cat([s, pi], -1))
            al = torch.stack([-torch.mean(q_pi[j]) for j in range(n)])
            (ga,) = torch.autograd.grad(al.sum(), ap)
        with torch.no_grad():
            actor, opt_a = self._adam(ga, opt_a, nets["actor"], "actor")
        return actor, critic, opt_a, opt_c, cl.detach()

    def _adam(self, g: torch.Tensor, state, params: torch.Tensor,
              name: str):
        """AdamW (``optim.adamw_apply``) on the rows (T, P), each row's
        gradient clipped by its own global norm, summed leaf by leaf in
        the reference's order."""
        leaves = [optim.tree_leaves(_layers(g[j], self.sizes[name]))
                  for j in range(g.shape[0])]
        norms = torch.stack([optim.global_norm(lv) for lv in leaves])
        scale = optim.clip_scale(norms, self._ocfg.grad_clip)
        return optim.adamw_apply(self._ocfg, g * scale[:, None], state,
                                 params, clipped=True)

    def allocation(self, states: np.ndarray
                   ) -> tuple[np.ndarray, np.ndarray]:
        """Greedy (noise-free) decisions for every device; advances no
        random stream -- the public read-only view of the learned policies.
        A single (S,) probe state is broadcast to all M devices."""
        states = self._check_width(np.atleast_2d(states))
        if states.shape[0] == 1:
            states = np.broadcast_to(states, (self.m, states.shape[1]))
        a = self._policy(_norm_states(states), range(self.m)).numpy()
        cfg = self.cfg
        return decode_actions(self._with_prior(a), cfg.h_max,
                              cfg.k_total_max, cfg.n_channels,
                              battery=self._battery(states))


def make_ddpg_controllers(m_devices: int, model_dim: int,
                          n_channels: int = 3, h_max: int = 8,
                          sparsity: float = 0.05, seed: int = 0,
                          action_space: str = "shared",
                          device: str | torch.device | None = None
                          ) -> list[DDPGController]:
    """One agent per device (paper: per-device policies); the reference the
    :func:`make_fleet_ddpg` bank is bit-identical to."""
    return [DDPGController(DDPGConfig(
        state_dim=obs_dim(n_channels, action_space),
        n_channels=n_channels, h_max=h_max,
        k_total_max=max(n_channels, int(model_dim * sparsity)),
        seed=seed + 17 * m, action_space=action_space), device=device)
        for m in range(m_devices)]


def make_fleet_ddpg(m_devices: int, model_dim: int,
                    n_channels: int = 3, h_max: int = 8,
                    sparsity: float = 0.05, seed: int = 0,
                    action_space: str = "shared",
                    device: str | torch.device | None = None) -> FleetDDPG:
    """The fleet equivalent of :func:`make_ddpg_controllers` (same
    per-device seeds, same decisions).  ``action_space="per_device"`` sizes
    the observation width for the profile-augmented heterogeneous space
    (pair with ``FLConfig(action_space="per_device")``)."""
    return FleetDDPG(m_devices, DDPGConfig(
        state_dim=obs_dim(n_channels, action_space),
        n_channels=n_channels, h_max=h_max,
        k_total_max=max(n_channels, int(model_dim * sparsity)),
        seed=seed, action_space=action_space), device=device)
