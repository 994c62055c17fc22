"""Population-scale cohort sampling: N >= 100k devices, M-device windows.

Port of ``repro/core/population.py``.  A :class:`Population` holds the
per-device state of all N devices: the error-feedback residuals behind a
store of :data:`.error_feedback.EF_STORES` ("dense" | "int8" | "server")
on the population's device (the card by default: 3.14 GB for the dense
store of lr_mnist at N = 100,000), and on the host the scenario chain
carries, the f64 resource spend and the participation counts.
:func:`run_population` draws a cohort of M devices per window, gathers
their rows, runs the batched engine's device phase on them
(:mod:`.fl_batched`: minibatch draw, local SGD, channel draw and cost
model, layered compression with error feedback through the LGC row
kernels, QSGD), applies the cohort's server step and scatters the state
back.

Windows are synchronous: each spans ``h`` rounds and the whole cohort
syncs at its end.  :func:`sample_cohort` draws the cohort from the
TAG_COHORT stream keyed by the window's start round alone, without
replacement: ``prng.choice``, bitwise ``jax.random.choice``, so the ids
are the reference's.  Every other stream (TAG_BATCH, TAG_SCEN,
TAG_CHANNEL, TAG_DROP, TAG_QUANT) is keyed by the global device id, and
device i reads shard ``i % n_shards`` of a pool stacked once.  A cohort's
chains advance only in the rounds it takes part in.

Engines: "batched" runs the device phase once on the (M, .) cohort (one
launch of each LGC row kernel a window, ``backend="cuda"``), "loop" on M
single-row blocks (M launches of each), "sharded" on the rank's (M / P, .)
block of a ``torch.distributed`` mesh (:mod:`repro_torch.launch.mesh`;
the reference's ``population.py:290-293, 391-416``): every rank keeps the
whole population (its own copy of the EF store, the carries, the spend),
runs the host side of the window (the carries, the channel draw and the
costs) for the whole cohort, and the device phase for its block; g and e'
are then gathered over the ranks, so the server, the scatter and the
spend run unchanged and alike on every rank.  The reference's population
reduces only by gather.
On the card nothing in a window waits for the device: the ids and up
masks go up from pinned memory, the store is read and written with
``index_select`` / ``index_copy_``, and the host reads only the eval
points.  The channel draw and the costs are host f32 rows, as the batched
engine prices them, so the spend needs nothing from the card.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device, upload
from repro_torch.kernels.ref import ftz, ftz_add

from . import prng
from .channels import DEFAULT_CHANNELS, comp_cost, stack_specs
from .compressor import (LAYER_POLICIES, flatten_tree, k_cap_for,
                         layer_table, tree_layer_slices, tree_size,
                         unflatten_like)
from .error_feedback import EF_STORES, ids_on, make_ef_store
from .fl import (BACKENDS, EVAL_SUBSET, MODES, FLConfig, FLTask, History,
                 eta_at, server_apply, server_mean_update)
from .fl_batched import (_stack_device_data, channels_rows, device_update,
                         draw_batches, flat_grad, local_steps,
                         semi_sync_add_back)
from .scenario import (TAG_COHORT, TAG_EVAL, TAG_QUANT, Scenario,
                       ScenarioCarry, get_scenario, init_carry_rows,
                       partition_fn, step_carry_rows, stream_key,
                       stream_keys)
from .server import get_aggregator, init_server_state, window_deadline

ENGINES = ("batched", "loop", "sharded")


# ---------------------------------------------------------------------------
# cohort samplers (registry; counter-based TAG_COHORT stream)
# ---------------------------------------------------------------------------

def _sample_uniform(key: torch.Tensor, n: int, m: int,
                    weights: np.ndarray | None) -> torch.Tensor:
    return prng.choice(key, n, m)


def _sample_weighted(key: torch.Tensor, n: int, m: int,
                     weights: np.ndarray | None) -> torch.Tensor:
    """``choice(key, n, (m,), replace=False, p=p / jnp.sum(p))`` on the f32
    weights: the sum in XLA:CPU's order (``prng.xla_sum``), the quotient
    flushed as XLA:CPU flushes."""
    if weights is None:
        raise ValueError("'weighted' sampler needs per-device weights")
    p = ftz(torch.from_numpy(np.asarray(weights)).to(torch.float32))
    return prng.choice(key, n, m, ftz(p / prng.xla_sum(p)))


COHORT_SAMPLERS: dict[str, Callable] = {
    # every device equally likely (classic FedAvg client sampling)
    "uniform": _sample_uniform,
    # biased/resource-aware selection (Jung et al. 2024): draw proportional
    # to non-negative per-device weights; zero-weight devices never appear
    "weighted": _sample_weighted,
}


def sample_cohort(base: torch.Tensor, sampler: str, n: int, m: int, t: int,
                  weights: np.ndarray | None = None) -> np.ndarray:
    """The M-device cohort of the window starting at round ``t``: keyed by
    ``stream_key(base, TAG_COHORT, t)`` alone, without replacement, drawn
    on the host.  Global device ids as an (M,) int64 numpy array in draw
    order (which fixes the server's summation order)."""
    if not 0 < m <= n:
        raise ValueError(f"cohort size {m} not in 1..{n}")
    try:
        fn = COHORT_SAMPLERS[sampler]
    except KeyError:
        raise ValueError(f"unknown cohort sampler {sampler!r}; registered: "
                         f"{sorted(COHORT_SAMPLERS)}") from None
    if weights is not None:
        w = np.asarray(weights, np.float64)
        if w.shape != (n,):
            raise ValueError(f"weights shape {w.shape} != ({n},)")
        if (w < 0).any() or w.sum() <= 0:
            raise ValueError("weights must be non-negative with positive sum")
        if sampler == "weighted" and m > int((w > 0).sum()):
            raise ValueError(f"cohort size {m} exceeds the "
                             f"{int((w > 0).sum())} positive-weight devices")
    ids = fn(stream_key(base, TAG_COHORT, t), n, m, weights)
    return ids.numpy().astype(np.int64)


# ---------------------------------------------------------------------------
# the population: per-device state for all N devices
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Population:
    """All-N device state; windows gather / scatter M-device cohorts of it.

    Built by :func:`make_population`.  The EF store lies on ``device``;
    the scenario chain carries, the f64 spend and the participation counts
    are host numpy arrays, as in the reference.  ``task.device_data`` is
    the shard pool: device i reads shard ``i % n_shards``.  ``phase_ms``
    gets the host ms of each window's phases (cohort draw, gather, window,
    scatter, accounting) from :func:`run_population`."""
    task: FLTask
    n: int
    scenario: Scenario
    ef_store: object
    sampler: str
    weights: np.ndarray | None
    seed: int
    d: int
    device: torch.device
    carry_bw: np.ndarray        # (N, C) f32 AR(1) log-bandwidth deviation
    carry_good: np.ndarray      # (N, C) bool Gilbert-Elliott state
    spend: np.ndarray           # (N, 4) f64: energy_j, money, time_s, mb
    participation: np.ndarray   # (N,) int64 windows participated
    phase_ms: dict = dataclasses.field(default_factory=dict)

    @property
    def n_shards(self) -> int:
        return len(self.task.device_data)

    @property
    def ef_nbytes(self) -> int:
        """Exact EF-state footprint (the stores allocate upfront)."""
        return self.ef_store.nbytes


def make_population(task: FLTask, n_devices: int, ef_store: str = "dense",
                    sampler: str = "uniform",
                    weights: np.ndarray | None = None,
                    scenario: str | Scenario | None = None,
                    seed: int = 0,
                    n_channels: int = len(DEFAULT_CHANNELS),
                    device: str | torch.device | None = None) -> Population:
    """An N-device :class:`Population` over ``task``'s shard pool, its EF
    store (``ef_store``: "dense" 4 N D bytes, "int8" N (D + 4), "server"
    4 D) on ``device`` (None: the card; raises without CUDA).  The chain
    carries of all N devices are the stationary draws of TAG_SCEN_INIT
    keyed by global id (:func:`.scenario.init_carry_rows`)."""
    if n_devices < len(task.device_data):
        raise ValueError(f"population of {n_devices} smaller than the "
                         f"{len(task.device_data)}-shard data pool")
    if ef_store not in EF_STORES:
        raise ValueError(f"unknown EF store {ef_store!r}; registered: "
                         f"{sorted(EF_STORES)}")
    if sampler not in COHORT_SAMPLERS:
        raise ValueError(f"unknown cohort sampler {sampler!r}; registered: "
                         f"{sorted(COHORT_SAMPLERS)}")
    dev = resolve_device(device)
    scn = get_scenario(scenario)
    d = tree_size(task.init(prng.PRNGKey(seed)))
    carry = init_carry_rows(scn, prng.PRNGKey(seed + 1),
                            torch.arange(n_devices), n_channels)
    if weights is not None:
        weights = np.asarray(weights, np.float64)
        if weights.shape != (n_devices,):
            raise ValueError(
                f"weights shape {weights.shape} != ({n_devices},)")
    return Population(
        task=task, n=n_devices, scenario=scn,
        ef_store=make_ef_store(ef_store, n_devices, d, dev),
        sampler=sampler, weights=weights, seed=seed, d=d, device=dev,
        carry_bw=carry.bw_log.numpy().copy(),
        carry_good=carry.good.numpy().copy(),
        spend=np.zeros((n_devices, 4), np.float64),
        participation=np.zeros((n_devices,), np.int64))


# ---------------------------------------------------------------------------
# a population-sized task: tiny synthetic classification over a shard pool
# ---------------------------------------------------------------------------

def make_population_task(n_shards: int = 8, n_train: int = 4096,
                         n_eval: int = 1024, n_features: int = 16,
                         n_classes: int = 4, seed: int = 0,
                         partition: str = "iid",
                         alpha: float = 0.5) -> FLTask:
    """Synthetic Gaussian-blob logistic regression sized for N >= 100k:
    D = (n_features + 1) n_classes = 68 at the defaults, so the dense
    100k-device store takes 27.2 MB.  The data (numpy, the reference's
    draws) are dealt into ``n_shards`` pool shards by ``partition``."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_classes, n_features)) * 3.0
    y = rng.integers(0, n_classes, size=n_train + n_eval)
    x = centers[y] + rng.normal(size=(y.size, n_features))
    x = x.astype(np.float32)
    y = y.astype(np.int32)
    xt, yt = x[:n_train], y[:n_train]
    xe, ye = x[n_train:], y[n_train:]
    scn = Scenario(name="population_task", partition=partition, alpha=alpha)
    shards = partition_fn(scn)(xt, yt, n_shards, seed)

    def init(key):
        k1, _ = prng.split(key)
        return {"w": prng.normal(k1, (n_features, n_classes)) * 0.01,
                "b": torch.zeros((n_classes,), dtype=torch.float32)}

    def logits(params, xb):
        return xb @ params["w"] + params["b"]

    def loss_fn(params, batch):
        xb, yb = batch
        logp = torch.log_softmax(logits(params, xb), -1)
        return -torch.mean(torch.gather(logp, -1, yb[..., None].long()))

    def metric_fn(params, batch):
        xb, yb = batch
        pred = torch.argmax(logits(params, xb), -1)
        return torch.mean((pred == yb).to(torch.float32))

    return FLTask(init=init, loss_fn=loss_fn, metric_fn=metric_fn,
                  device_data=shards, eval_data=(xe, ye),
                  name=f"population_blobs_{n_features}x{n_classes}")


# ---------------------------------------------------------------------------
# the cohort window
# ---------------------------------------------------------------------------

class _Cohort:
    """One run's constants and the cohort's device phase: the batched
    engine's phase functions (:mod:`.fl_batched`) on gathered rows."""

    def __init__(self, pop: Population, cfg: FLConfig, mode: str,
                 ks: list[int], backend: str, params: dict):
        self.pop, self.cfg, self.mode, self.backend = pop, cfg, mode, backend
        dev = pop.device
        self.base = prng.PRNGKey(cfg.seed + 1)
        self.consts = stack_specs(cfg.channels)
        self.n_ch = len(cfg.channels)
        self.ks = ks
        self.k_cap = 1 if mode == "fedavg" else k_cap_for(sum(ks), pop.d)
        self.data, self.pool_n = _stack_device_data(pop.task.device_data,
                                                    dev)
        self.grad = flat_grad(params, pop.task.loss_fn)
        self.segments = (layer_table(tree_layer_slices(params), dev)
                         if cfg.layer_policy != "global" else None)
        self._ks_dev: dict[int, torch.Tensor] = {}

    def ks_rows(self, m: int) -> torch.Tensor:
        """The (m, C) budgets on the device, made once per block size."""
        if m not in self._ks_dev:
            self._ks_dev[m] = upload(
                torch.tensor([self.ks] * m, dtype=torch.int64),
                self.pop.device)
        return self._ks_dev[m]

    def phase(self, flat0: torch.Tensor, ef: torch.Tensor,
              carry: ScenarioCarry, ids: torch.Tensor, ids_dev: torch.Tensor,
              t: int, te: int):
        """The phase of one block of the cohort (global ids ``ids`` on the
        host, ``ids_dev`` on the device; error memory rows ``ef``; host
        carry rows ``carry``) through rounds t .. te-1 from the global
        model ``flat0``: (g, e', (S, 4) host costs, the stepped carry)."""
        carry, up, costs = self.host_phase(carry, ids, t, te)
        g, ef_new = self.device_phase(flat0, ef, ids, ids_dev, up, t, te)
        return g, ef_new, costs, carry

    def host_phase(self, carry: ScenarioCarry, ids: torch.Tensor, t: int,
                   te: int) -> tuple[ScenarioCarry, torch.Tensor, np.ndarray]:
        """The host side of the block ``ids``: its carry rows stepped
        through t .. te-1, the sync's (S, N) up mask and (S, 4) costs."""
        pop, base = self.pop, self.base
        carry = step_carry_rows(pop.scenario, base, carry, range(t, te), ids)
        ch, costs = channels_rows(pop.scenario, self.consts, base, carry,
                                  ids, te - 1, self.mode,
                                  [self.ks] * ids.shape[0], pop.d, self.cfg)
        return carry, ch.up, costs

    def device_phase(self, flat0: torch.Tensor, ef: torch.Tensor,
                     ids: torch.Tensor, ids_dev: torch.Tensor,
                     up: torch.Tensor, t: int, te: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
        """The device side of the block ``ids``: local SGD from ``flat0``
        and the sync's compression under the up mask ``up``: (g, e')."""
        pop, cfg, base = self.pop, self.cfg, self.base
        m, dev = ids.shape[0], self.pop.device
        rows = ids_dev % pop.n_shards
        idx = draw_batches(base, t, te, ids_dev, self.pool_n[rows],
                           cfg.batch_size)
        anchor = flat0.expand(m, pop.d)
        w_hat = local_steps(self.grad, anchor.clone(), self.data, rows, idx,
                            [eta_at(cfg, r) for r in range(t, te)])
        keys = None
        if self.mode == "lgc_q8":
            keys = upload(stream_keys(base, TAG_QUANT, torch.tensor([te - 1]),
                                      ids)[0], dev)
        return device_update(
            ef, ftz_add(anchor, -w_hat), self.ks_rows(m), upload(up, dev),
            self.mode, self.n_ch, self.k_cap, self.backend, cfg.layer_policy,
            self.segments, keys)


def _window(cohort: _Cohort, engine: str, flat0: torch.Tensor,
            ef: torch.Tensor, carry: ScenarioCarry, ids: torch.Tensor,
            ids_dev: torch.Tensor, t: int, te: int, mesh=None):
    """The cohort's phase in one (M, .) block ("batched"), M single-row
    blocks ("loop") or, "sharded", the host side whole and the device
    side on the rank's block of ``mesh``, its g and e' gathered: the same
    functions at every size."""
    if engine == "batched":
        return cohort.phase(flat0, ef, carry, ids, ids_dev, t, te)
    if engine == "sharded":
        from repro_torch.launch.mesh import all_gather_rows
        carry, up, costs = cohort.host_phase(carry, ids, t, te)
        b = ids.shape[0] // mesh.size
        blk = slice(mesh.rank * b, (mesh.rank + 1) * b)
        g, ef_new = cohort.device_phase(flat0, ef[blk], ids[blk],
                                        ids_dev[blk], up[blk], t, te)
        return (all_gather_rows(mesh, g), all_gather_rows(mesh, ef_new),
                costs, carry)
    parts = [cohort.phase(flat0, ef[j:j + 1],
                          ScenarioCarry(carry.bw_log[j:j + 1],
                                        carry.good[j:j + 1]),
                          ids[j:j + 1], ids_dev[j:j + 1], t, te)
             for j in range(ids.shape[0])]
    g, ef_new, costs, carries = zip(*parts)
    return (torch.cat(g), torch.cat(ef_new), np.concatenate(costs),
            ScenarioCarry(torch.cat([c.bw_log for c in carries]),
                          torch.cat([c.good for c in carries])))


def run_population(pop: Population, cfg: FLConfig, mode: str = "lgc",
                   h: int = 4, ks: Sequence[int] | None = None,
                   m_cohort: int = 64, engine: str = "batched",
                   backend: str | None = None, mesh=None) -> History:
    """Sampled-cohort LGC over ``pop``; returns a :class:`History`.

    Every window: draw M = ``m_cohort`` devices (:func:`sample_cohort`),
    gather their EF rows and carries, broadcast the global model, run
    ``h`` local rounds and the sync (:func:`_window`), apply the cohort's
    server step (the mean over M, or diloco / semi_sync normalised by M,
    semi_sync's late share going back into the cohort's e'), and scatter
    the state back.  Eval points inside a window see the params and the
    spend from before it.  ``engine="sharded"`` spreads each cohort over
    the ranks of ``mesh`` (a :class:`repro_torch.launch.mesh.Mesh`;
    default: the ranks present, or this process alone)."""
    if engine not in ENGINES:
        raise ValueError(f"unknown population engine {engine!r}")
    if engine == "sharded":
        from repro_torch.launch.mesh import (fl_axis_name, fl_shards,
                                             make_host_mesh)
        mesh = mesh if mesh is not None else make_host_mesh(
            device=pop.device)
        axis = fl_axis_name(mesh)
        n_mesh = fl_shards(mesh)
        if m_cohort % n_mesh != 0:
            raise ValueError(f"cohort size {m_cohort} does not divide over "
                             f"{n_mesh} mesh devices on axis {axis!r}")
    if cfg.seed != pop.seed:
        raise ValueError(f"cfg.seed={cfg.seed} but the population was built "
                         f"with seed={pop.seed}; streams would diverge")
    cfg_scn = get_scenario(cfg.scenario)
    if cfg_scn.name not in ("static", pop.scenario.name):
        raise ValueError(
            f"cfg.scenario={cfg_scn.name!r} conflicts with the population's "
            f"{pop.scenario.name!r}; pass the scenario to make_population")
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")
    backend = backend or cfg.backend
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of "
                         f"{sorted(BACKENDS)}")
    if (cfg.layer_policy != "global"
            and cfg.layer_policy not in LAYER_POLICIES):
        raise ValueError(
            f"unknown layer_policy {cfg.layer_policy!r}; expected "
            f"'global' or one of {sorted(LAYER_POLICIES)}")
    n_ch = len(cfg.channels)
    if pop.carry_bw.shape[1] != n_ch:
        raise ValueError(
            f"population carries cover {pop.carry_bw.shape[1]} channels but "
            f"cfg has {n_ch}; pass n_channels to make_population")
    task, scn, d, dev = pop.task, pop.scenario, pop.d, pop.device
    params = {k: v.to(dev)
              for k, v in task.init(prng.PRNGKey(cfg.seed)).items()}
    if ks is None:
        k_total = max(1, d // 20)                  # 5% sparsity default
        ks = [k_total // 2, k_total // 4,
              k_total - k_total // 2 - k_total // 4]
    ks = (list(ks) + [0] * n_ch)[:n_ch]
    if mode == "topk":
        ks = [sum(ks)] + [0] * (n_ch - 1)
    cohort = _Cohort(pop, cfg, mode, ks, BACKENDS[backend], params)
    agg = get_aggregator(cfg.aggregator)
    server_state = (init_server_state(cfg, d, dev) if agg.carries_state
                    else None)
    server_wall = 0.0

    xe, ye = (torch.from_numpy(np.asarray(a)).to(dev) for a in task.eval_data)
    n_eval = int(xe.shape[0])
    n_take = min(EVAL_SUBSET, n_eval)

    @torch.no_grad()
    def eval_at(p_at: dict, t: int) -> tuple[float, float]:
        key = stream_key(cohort.base, TAG_EVAL, t)
        idx = prng.randint(key, (n_take,), 0, n_eval).to(dev)
        batch = (xe[idx], ye[idx])
        return (float(task.loss_fn(p_at, batch)),
                float(task.metric_fn(p_at, batch)))

    hist = History()

    def rec(r: int, p_at: dict) -> None:
        loss, acc = eval_at(p_at, r)
        hist.step.append(r)
        hist.loss.append(loss)
        hist.accuracy.append(acc)
        hist.energy_j.append(float(pop.spend[:, 0].sum()))
        hist.money.append(float(pop.spend[:, 1].sum()))
        hist.time_s.append(float(pop.spend[:, 2].max()))
        hist.uplink_mb.append(float(pop.spend[:, 3].sum()))
        hist.server_wall_s.append(float(server_wall))

    pop.phase_ms = {k: [] for k in ("cohort", "gather", "window", "scatter",
                                    "accounting")}

    def lap(name: str, since: float) -> float:
        now = time.perf_counter()
        pop.phase_ms[name].append((now - since) * 1e3)
        return now

    comp = comp_cost(scn.device_profile_at(0), h)
    flat = flatten_tree(params)
    t = 0
    while t < cfg.rounds:
        te = min(t + h, cfg.rounds)
        clock = time.perf_counter()
        ids = sample_cohort(cohort.base, pop.sampler, pop.n, m_cohort, t,
                            pop.weights)
        clock = lap("cohort", clock)
        ids_t = torch.from_numpy(ids)
        ids_dev = ids_on(ids_t, dev)
        ef_c = pop.ef_store.gather(ids_dev)
        carry_c = ScenarioCarry(torch.from_numpy(pop.carry_bw[ids]),
                                torch.from_numpy(pop.carry_good[ids]))
        clock = lap("gather", clock)

        g, ef_c, costs, carry_c = _window(cohort, engine, flat, ef_c,
                                          carry_c, ids_t, ids_dev, t, te,
                                          mesh)
        flat_before = flat
        deadline = None
        if agg.name == "mean":
            flat = server_mean_update(flat_before, list(g), m_cohort)
        else:
            profs = [scn.device_profile_at(int(i)) for i in ids]
            deadline = (window_deadline(cfg, mode, d,
                                        [(h, ks, p) for p in profs])
                        if agg.uses_timing else 1.0)
            comp32 = np.array([np.float32(comp_cost(p, h)["time_s"])
                               for p in profs], np.float32)
            flat, server_state, undeliv = server_apply(
                agg.name, cfg, flat_before, server_state, g,
                costs[:, 2].astype(np.float32) + comp32, deadline, m_cohort)
            if agg.name == "semi_sync":
                ef_c = semi_sync_add_back(ef_c, g,
                                          upload(undeliv, dev)[:, None])
        clock = lap("window", clock)

        # eval points falling mid-window precede this window's sync: the
        # params and the spend from before it
        params_before = unflatten_like(flat_before, params)
        for r in range(t, te - 1):
            if r % cfg.eval_every == 0 or r == cfg.rounds - 1:
                rec(r, params_before)
        clock = time.perf_counter()

        pop.ef_store.scatter(ids_dev, ef_c)
        pop.carry_bw[ids] = carry_c.bw_log.numpy()
        pop.carry_good[ids] = carry_c.good.numpy()
        clock = lap("scatter", clock)
        pop.participation[ids] += 1
        costs_np = np.asarray(costs, np.float64)
        t_wins = []
        for j, i in enumerate(ids):
            ccomp = (comp if scn.straggler is None
                     else comp_cost(scn.device_profile_at(int(i)), h))
            pop.spend[i, 0] += costs_np[j, 0] + ccomp["energy_j"]
            pop.spend[i, 1] += costs_np[j, 1] + ccomp["money"]
            pop.spend[i, 2] += costs_np[j, 2] + ccomp["time_s"]
            pop.spend[i, 3] += costs_np[j, 3] / 1e6
            t_wins.append(float(costs_np[j, 2]) + ccomp["time_s"])
        # simulated server wall (f64 host math): sync servers wait for the
        # slowest cohort device, semi_sync for at most the window deadline
        server_wall += (min(deadline, max(t_wins)) if agg.uses_timing
                        else max(t_wins))
        lap("accounting", clock)

        if (te - 1) % cfg.eval_every == 0 or te - 1 == cfg.rounds - 1:
            rec(te - 1, unflatten_like(flat, params))
        t = te
    return hist
