"""The batched engine: every device's state stacked on a leading M axis.

Port of ``repro/core/fl_batched.py``: :func:`_stack_device_data` (:89), the
device phase of :func:`make_device_phase` (:112) and the host loop of
:class:`BatchedEngine` (:308).  A window runs from the last boundary to the
earliest sync point:

    window(t0 .. te):
      keys of every (round, device) in a few tensor passes (TAG_BATCH) and
        the minibatch indices drawn from them, on the simulator's device
      for each round: torch.func.vmap(torch.func.grad(loss)) over the
        stacked (M, D) parameters, then p - eta * g (per_device: only on the
        rows still within their first h_m rounds; the others stay bitwise
        untouched)
      the scenario's channel chains stepped through t0 .. te-1 for every
        device, on the host (:meth:`.fl.LGCSimulator._step_scenario`)
      at te - 1, for the devices that sync: the channel draw (TAG_CHANNEL)
        with their carry rows laid over it and the dropout (TAG_DROP), and
        the cost model, on the host; layered compression with error
        feedback over their rows (``backend="cuda"``: one launch each of
        the three LGC row kernels,
        :func:`repro_torch.kernels.lgc_compress_hist_rows`; ``"exact"``:
        :func:`.compressor.lgc_compress_topk`; per-layer budgets first
        through the segmented kernels, :func:`.fl.per_layer_g`),
        QSGD (``lgc_q8``), the server (the mean, or :mod:`.server`'s
        diloco / semi_sync step, the semi-sync schedule taken on the host
        from the window times) and the broadcast, on the device

At a boundary the controller observes and acts for the syncing devices
(:meth:`.fl.LGCSimulator._observe_devices`, ``_decide_devices``).  With
``pipeline_decisions`` the boundary commits the decisions staged at the
previous one and enqueues the reward eval; the next window is dispatched
first, and only then does the host read the reward losses, let the fleet
observe and train, and stage the next decisions (the reference's
``fl_batched.py:528-630``), so the controller's host time overlaps the
window on the card.

Nothing in a window waits for the device.  Per-round step sizes are host
scalars; the channel draw and the costs are the loop engine's host
arithmetic on (S, N) rows, in f32 on the CPU (a few small tensors, where
the same draw on the card would be thousands of tiny launches), so the
spend accumulates in f64 without reading anything back; the (S, N) up mask
and the QSGD keys go to the device as asynchronous copies from pinned
memory.  Host values that change rarely (the budgets, a sync set) go to
the device once per distinct value and are kept.  Only an eval point reads
the device (its loss and accuracy).

The per-device arithmetic is the loop engine's; the batched matmuls of the
vmapped SGD sum in another order, so History agrees with the loop engine's
to float summation order (tests/test_torch_fl_batched.py), and byte counts
and sync sets exactly, under every scenario (tests/test_torch_scenarios.py),
every layer policy (tests/test_torch_per_layer.py) and every aggregator
(tests/test_torch_server.py), and every controller and action space
(tests/test_torch_controller.py, tests/test_torch_hetero_control.py).

:class:`ShardedEngine` is the same engine with the device axis spread over
the ranks of a ``torch.distributed`` mesh (:mod:`repro_torch.launch.mesh`;
the reference's ``fl_batched.py:680-772``): each rank holds the block of
rows ``[r M / P, (r + 1) M / P)`` and runs the host loop whole, and only
the server aggregation crosses the ranks (gather: History bitwise the
batched engine's; psum: the sums reassociated).

The device phase is a set of module functions on explicit state (global
device ids, the stacked data and the rows each device reads, budgets,
carry rows, backend, layer segments): :func:`draw_batches`,
:func:`local_steps`, :func:`channels_rows`, :func:`compress_rows`,
:func:`device_update`.  :class:`BatchedEngine` calls them on its M rows
and :mod:`.population` on a gathered cohort (the reference's shared
``make_device_phase``).
"""
from __future__ import annotations

import bisect
import time
from typing import Sequence

import numpy as np
import torch

from repro_torch.device import upload
from repro_torch.kernels.ref import ftz, ftz_add

from . import prng
from .channels import ChannelSample, comm_cost_mb, comp_cost
from .compressor import (_leaf_order, flatten_tree, k_cap_for,
                         lgc_compress_topk, qsgd_dequantize,
                         qsgd_quantize_rows, unflatten_like)
from .fl import (History, check_server_reduce, eta_at,
                 flushed_sum, per_layer_g, server_mean_step,
                 server_mean_update, server_step, server_sums, sgd_update)
from .scenario import (TAG_BATCH, TAG_CHANNEL, TAG_QUANT, Scenario,
                       ScenarioCarry, dropout_mask, sample_from_carry_rows,
                       stream_keys)

KEPT_MAX = 256       # host values kept on the device at most


def _stack_device_data(device_data: Sequence, device: torch.device
                       ) -> tuple[tuple[torch.Tensor, ...], torch.Tensor]:
    """Pad the per-device shards to a common row count and stack each part
    on a new leading device axis: (n_i, ...) -> (M, Nmax, ...), with the
    row counts n (M,) int64, on ``device``.

    Padding rows are zeros and never reach the model: the minibatch draw
    takes indices in [0, n_i) per device."""
    ns = [int(np.asarray(shard[0]).shape[0]) for shard in device_data]
    nmax = max(ns)
    parts = []
    for leaves in zip(*device_data):
        leaves = [np.asarray(a) for a in leaves]
        out = np.zeros((len(leaves), nmax) + leaves[0].shape[1:],
                       leaves[0].dtype)
        for i, a in enumerate(leaves):
            out[i, :a.shape[0]] = a
        parts.append(torch.from_numpy(out).to(device))
    return tuple(parts), torch.tensor(ns, dtype=torch.int64, device=device)


# ---------------------------------------------------------------------------
# the device phase: explicit state, shared by the engine and the population
# ---------------------------------------------------------------------------

def flat_grad(params: dict, loss_fn):
    """``torch.func.vmap(torch.func.grad(...))`` of ``loss_fn`` over flat
    (M, D) parameter rows laid out as :func:`.compressor.flatten_tree` lays
    out ``params``; called as ``grad(w_rows, *batch)``."""
    names = _leaf_order(params)
    shapes = [tuple(params[k].shape) for k in names]
    sizes = [int(params[k].numel()) for k in names]

    def loss_of_flat(w, *batch):
        parts = torch.split(w, sizes)
        tree = {k: p.view(s) for k, p, s in zip(names, parts, shapes)}
        return loss_fn(tree, batch)
    return torch.func.vmap(torch.func.grad(loss_of_flat))


def draw_batches(base: torch.Tensor, t0: int, te: int,
                 dev_ids: torch.Tensor, n_dev: torch.Tensor,
                 batch_size: int) -> torch.Tensor:
    """(L, M, b) minibatch indices of rounds t0 .. te-1 for the devices
    ``dev_ids`` (M,) (global ids, on the device), each in [0, n_dev[m]):
    the keys of every (round, device) (TAG_BATCH) and the draws in a few
    tensor passes."""
    ts = torch.arange(t0, te, dtype=torch.int64, device=dev_ids.device)
    keys = stream_keys(base, TAG_BATCH, ts, dev_ids)
    n_l, m = te - t0, dev_ids.shape[0]
    idx = prng.randint_rows(keys.reshape(n_l * m, 2), batch_size,
                            n_dev.repeat(n_l))
    return idx.reshape(n_l, m, -1)


def local_steps(grad, w_hat: torch.Tensor, data: tuple,
                data_rows: torch.Tensor, idx: torch.Tensor,
                etas: Sequence[float], h_arr: torch.Tensor | None = None
                ) -> torch.Tensor:
    """A window's local SGD on the rows ``w_hat`` (M, D): per round one
    vmapped gradient (:func:`flat_grad`) on the minibatch ``idx[i]`` of
    each row's data row ``data_rows`` (M,) of the stacked ``data``, then
    p - eta_i * g.  With ``h_arr`` (M,) (per_device), row m steps only in
    the window's first h_m rounds (the reference's masked-step scan,
    ``fl_batched.py:156-172``): a row whose mask holds takes bitwise the
    shared path's step, the others stay bitwise untouched."""
    rows = data_rows[:, None]
    for i, eta in enumerate(etas):
        batch = tuple(part[rows, idx[i]] for part in data)
        g = grad(w_hat, *batch)
        stepped = sgd_update(w_hat, g, eta)
        if h_arr is not None:
            stepped = torch.where((h_arr > i)[:, None], stepped, w_hat)
        w_hat = stepped
    return w_hat


def channels_rows(scn: Scenario, consts, base: torch.Tensor,
                  carry: ScenarioCarry, ids: torch.Tensor, t_sync: int,
                  mode: str, ks_rows: Sequence[Sequence[int]], d: int, cfg
                  ) -> tuple[ChannelSample, np.ndarray]:
    """The sync's channel draw (TAG_CHANNEL at round ``t_sync``) of the
    devices ``ids`` (S,) (global ids, a CPU tensor) with their carry rows
    ``carry`` (S, C) laid over it, their dropout, and the cost model, on
    the host in f32 as the loop engine prices them: the (S, N) sample and
    the (S, 4) costs (energy, money, time, uplink bytes).  ``ks_rows`` are
    the (S, C) budgets (topk folded into channel 0)."""
    n_ch = len(cfg.channels)
    keys = stream_keys(base, TAG_CHANNEL, torch.tensor([t_sync]), ids)[0]
    ch = sample_from_carry_rows(scn, consts, carry, keys)
    if scn.has_dropout:
        drop = dropout_mask(scn, base, t_sync, ids)
        ch = ch._replace(up=ch.up & ~drop[:, None])
    if mode == "fedavg":
        # the whole model over the fastest channel that is up; with
        # every channel down nothing is sent
        any_up = ch.up.any(1)
        best = torch.argmax(ch.bandwidth_mb_s * ch.up, 1)
        nbytes = ((torch.arange(n_ch) == best[:, None])
                  .to(torch.float32) * float(d * cfg.value_bytes))
        uplink = torch.where(any_up, nbytes.sum(1), torch.zeros(()))
    else:
        value_bytes = 1 if mode == "lgc_q8" else cfg.value_bytes
        ks = torch.tensor(ks_rows, dtype=torch.float32)
        nbytes = (ks * float(value_bytes + cfg.index_bytes)
                  * ch.up[:, :n_ch].to(torch.float32))
        uplink = nbytes.sum(1)
    comm = comm_cost_mb(ch, nbytes / 1e6)
    costs = torch.stack([comm["energy_j"], comm["money"], comm["time_s"],
                         uplink], 1)
    return ch, costs.numpy()


def compress_rows(ef: torch.Tensor, delta: torch.Tensor, ks: torch.Tensor,
                  recv: torch.Tensor, k_cap: int, backend: str, policy: str,
                  segments) -> tuple[torch.Tensor, torch.Tensor]:
    """(g, e') of the syncing rows, backend-dispatched (per-layer budgets:
    the candidates first, :func:`.fl.per_layer_g`, then u - g).  cuda: one
    launch of each LGC row kernel over the rows,
    :func:`repro_torch.kernels.lgc_compress_hist_rows` (looked up at each
    call, so a caller may wrap it)."""
    if policy != "global":
        u = ftz_add(ef, delta)
        g = per_layer_g(u, ks, recv, k_cap, policy, backend, segments)
        return g, ftz_add(u, -g)
    if backend == "cuda":
        from repro_torch import kernels
        return kernels.lgc_compress_hist_rows(
            ef, delta, torch.cumsum(ks, 1), recv.to(torch.int32))
    u = ftz_add(ef, delta)
    g = lgc_compress_topk(u, ks, recv, k_cap)
    return g, u - g


def device_update(ef: torch.Tensor, delta: torch.Tensor, ks: torch.Tensor,
                  up: torch.Tensor, mode: str, n_ch: int, k_cap: int,
                  backend: str, policy: str, segments,
                  quant_keys: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(g, e') of the syncing rows from their error memory ``ef``, net
    progress ``delta`` (S, D), budgets ``ks`` (S, C) and up mask ``up``
    (S, N), on the device: fedavg sends ``delta`` dense where any channel
    is up and keeps no error; the LGC modes go through
    :func:`compress_rows`, and ``lgc_q8`` then quantizes g with the keys
    ``quant_keys`` (S, 2) and keeps the quantization residual in e'."""
    if mode == "fedavg":
        # dense, no error feedback; a lost upload sends nothing
        g = torch.where(up.any(1)[:, None], delta, torch.zeros_like(delta))
        return g, ef
    g, ef_new = compress_rows(ef, delta, ks, up[:, :n_ch], k_cap, backend,
                              policy, segments)
    if mode == "lgc_q8":
        # int8 values on the wire; the quantization residual stays in the
        # error memory
        q, scale = qsgd_quantize_rows(g, quant_keys)
        g_deq = qsgd_dequantize(q, scale)
        ef_new = ftz_add(ef_new, ftz_add(g, -g_deq))
        g = g_deq
    return g, ef_new


def semi_sync_add_back(ef_new: torch.Tensor, g: torch.Tensor,
                       undeliv: torch.Tensor) -> torch.Tensor:
    """Under semi_sync a late row's e' takes back the share ``undeliv``
    (S, 1) of its update g the server never applies (reference
    ``fl_batched.py:425-445``, ``population.py:371-372``)."""
    return torch.where(undeliv > 0, ftz_add(ef_new, ftz(undeliv * g)),
                       ef_new)


class BatchedEngine:
    """Drives one :class:`~.fl.LGCSimulator` with stacked (M, D) state.

    The simulator's host-side attributes (params, spend, decisions,
    next_sync) are kept current at window boundaries, so decisions and
    History recording reuse the simulator's own code.  ``window_ms`` gets
    each window's host time; ``sim.round_ms`` each round's share of it."""

    def __init__(self, sim):
        self.sim = sim
        cfg = sim.cfg
        dev = sim.device
        self.m, self.d = sim.m_devices, sim.d
        self.n_ch = len(cfg.channels)
        self.lo, self.hi = self._block()    # the global ids of the rows held
        self.n_rows = self.hi - self.lo
        self.data, self.n_dev = _stack_device_data(
            sim.task.device_data[self.lo:self.hi], dev)
        self.dev_ids = torch.arange(self.lo, self.hi, dtype=torch.int64,
                                    device=dev)
        self.data_rows = torch.arange(self.n_rows, device=dev)
        flat0 = flatten_tree(sim.params)
        self.w_hat = flat0.expand(self.n_rows, self.d).clone()
        self.anchor = self.w_hat.clone()
        self.ef = torch.zeros((self.n_rows, self.d), dtype=torch.float32,
                              device=dev)
        self.window_ms: list[float] = []
        self._k_cap_hi = 0
        self._kept: dict = {}            # host values already on the device
        self._grad = flat_grad(sim.params, sim.task.loss_fn)

    def _block(self) -> tuple[int, int]:
        """The global ids [lo, hi) of the device rows this engine holds:
        all M."""
        return 0, self.m

    # -- host values kept on the device -------------------------------------
    def _on_device(self, key, make) -> torch.Tensor:
        """``make()`` moved to the device once per distinct ``key`` (a
        learning controller's budgets change at every boundary: the oldest
        half of the values kept is dropped past ``KEPT_MAX``)."""
        t = self._kept.get(key)
        if t is None:
            if len(self._kept) >= KEPT_MAX:
                for k in list(self._kept)[:KEPT_MAX // 2]:
                    del self._kept[k]
            t = upload(make(), self.sim.device)
            self._kept[key] = t
        return t

    def _ks_list(self, ms: tuple[int, ...]) -> list[list[int]]:
        """(S, C) budgets of the devices ``ms`` (topk folds the whole budget
        into channel 0; rows padded or trimmed to the channel count)."""
        rows = []
        for m in ms:
            ks = list(self.sim.decisions[m].ks)
            if self.sim.mode == "topk":
                ks = [sum(ks)] + [0] * (len(ks) - 1)
            rows.append((ks + [0] * self.n_ch)[:self.n_ch])
        return rows

    def _ks_rows(self, ms: tuple[int, ...]) -> torch.Tensor:
        """:meth:`_ks_list` on the device, kept per distinct value."""
        rows = self._ks_list(ms)
        return self._on_device(("ks", tuple(map(tuple, rows))),
                               lambda: torch.tensor(rows, dtype=torch.int64))

    def _h_arr(self) -> torch.Tensor:
        """The committed local-step counts of the rows held, on the device
        (per_device windows), kept per distinct value."""
        hs = tuple(dec.h for dec in self.sim.decisions[self.lo:self.hi])
        return self._on_device(("h", hs), lambda: torch.tensor(hs))

    def _rows_index(self, ms: tuple[int, ...]) -> torch.Tensor:
        return self._on_device(("rows", ms), lambda: torch.tensor(
            ms, dtype=torch.int64))

    def _sync_inputs(self, ms: tuple[int, ...]
                     ) -> tuple[torch.Tensor | None, torch.Tensor | None]:
        """The budgets (S, C) of the syncing rows this engine holds and
        their row indices (None: every row held), on the device."""
        held = tuple(m for m in ms if self.lo <= m < self.hi)
        if not held:
            return None, None
        ks = self._ks_rows(held)
        if len(held) == self.n_rows:
            return ks, None
        return ks, self._rows_index(tuple(m - self.lo for m in held))

    def _k_cap(self) -> int:
        """The top-k bound of the exact backend: a power of two, and the
        largest used so far (the reference's monotone ``_k_cap``)."""
        k_max = max(sum(dec.ks) for dec in self.sim.decisions)
        self._k_cap_hi = max(self._k_cap_hi, k_cap_for(k_max, self.d))
        return self._k_cap_hi

    # -- the window ----------------------------------------------------------
    def _draw_batches(self, t0: int, te: int) -> torch.Tensor:
        """(L, M, b) minibatch indices of rounds t0 .. te-1
        (:func:`draw_batches` over all M devices)."""
        return draw_batches(self.sim._base, t0, te, self.dev_ids,
                            self.n_dev, self.sim.cfg.batch_size)

    def _local_steps(self, t0: int, te: int, idx: torch.Tensor,
                     h_arr: torch.Tensor | None = None) -> None:
        """The window's local SGD on the stacked rows held
        (:func:`local_steps`; each device reads its own data row)."""
        self.w_hat = local_steps(self._grad, self.w_hat, self.data,
                                 self.data_rows, idx,
                                 [eta_at(self.sim.cfg, t)
                                  for t in range(t0, te)],
                                 h_arr)

    def _channels(self, te: int, ms: tuple[int, ...]
                  ) -> tuple[ChannelSample, np.ndarray]:
        """The sync's channel draw at round te - 1 and the cost model of
        the devices ``ms`` (:func:`channels_rows` on their carry rows)."""
        sim = self.sim
        rows = torch.tensor(ms)
        carry = ScenarioCarry(*(part[rows] for part in sim.scen_carry))
        return channels_rows(sim.scenario, sim._consts, sim._base, carry,
                             rows, te - 1, sim.mode, self._ks_list(ms),
                             self.d, sim.cfg)

    def _window_times(self, ms: tuple[int, ...], costs: np.ndarray
                      ) -> torch.Tensor:
        """(S,) f32 window seconds of the devices ``ms``: the comm time of
        the host-priced ``costs`` plus the compute time of their committed
        window, added in f32 as the loop engine adds them."""
        sim = self.sim
        comp = np.array([comp_cost(sim.profiles[m],
                                   sim.decisions[m].h)["time_s"]
                         for m in ms], np.float32)
        return torch.from_numpy(costs[:, 2].astype(np.float32) + comp)

    def _serve(self, g: torch.Tensor, ef_new: torch.Tensor,
               ms: tuple[int, ...], costs: np.ndarray, deadline: float
               ) -> tuple[torch.Tensor, torch.Tensor]:
        """The diloco / semi_sync server round on the syncing rows'
        updates g (S, D): (new flat params, e'), where under semi_sync a
        late row's e' takes back the share of its update the server never
        applies (reference ``fl_batched.py:425-445``)."""
        sim = self.sim
        flat, undeliv = sim._server_apply(g, self._window_times(ms, costs),
                                          deadline)
        if sim.agg.name == "semi_sync":
            ef_new = semi_sync_add_back(ef_new, g,
                                        upload(undeliv, sim.device)[:, None])
        return flat, ef_new

    def _compress(self, te: int, ms: tuple[int, ...], ks: torch.Tensor,
                  rows: torch.Tensor | None, up: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
        """(g, e') of the syncing devices ``ms`` among the rows held (their
        budgets ``ks`` and row indices ``rows`` on the device, None for all
        rows; their (S, N) up mask ``up`` on the host): compression with EF
        and QSGD, enqueued on the device."""
        sim = self.sim

        def take(x):
            return x if rows is None else x.index_select(0, rows)
        ef = take(self.ef)
        delta = ftz_add(take(self.anchor), -take(self.w_hat))
        keys = None
        if sim.mode == "lgc_q8":
            keys = upload(stream_keys(sim._base, TAG_QUANT,
                                      torch.tensor([te - 1]),
                                      torch.tensor(ms))[0], sim.device)
        k_cap = 1 if sim.mode == "fedavg" else self._k_cap()
        return device_update(
            ef, delta, ks, upload(up, sim.device), sim.mode, self.n_ch,
            k_cap, sim.backend, sim.cfg.layer_policy, sim._segments, keys)

    def _broadcast(self, rows: torch.Tensor | None, n: int,
                   ef_new: torch.Tensor, flat: torch.Tensor) -> None:
        """The ``n`` syncing rows held (``rows``, None for all) take their
        e' and adopt the new global model ``flat``."""
        if rows is None:
            self.ef = ef_new
            self.w_hat = flat.expand(self.n_rows, self.d).clone()
            self.anchor = self.w_hat.clone()
        else:
            self.ef.index_copy_(0, rows, ef_new)
            bcast = flat.expand(n, self.d)
            self.w_hat.index_copy_(0, rows, bcast)
            self.anchor.index_copy_(0, rows, bcast)

    def _sync(self, te: int, ms: tuple[int, ...], ks: torch.Tensor,
              rows: torch.Tensor | None, ch: ChannelSample,
              costs: np.ndarray, deadline: float) -> dict:
        """The sync at round te - 1 of the devices ``ms`` (their budgets
        ``ks`` (S, C) and row indices ``rows`` on the device, None for all
        rows; their channel sample ``ch`` and (S, 4) ``costs`` on the host;
        the semi-sync ``deadline``): compression with EF of their rows,
        QSGD, the server and the broadcast, enqueued on the device.
        Returns the new global params."""
        sim = self.sim
        g, ef_new = self._compress(te, ms, ks, rows, ch.up)
        if sim.agg.name == "mean":
            flat = server_mean_update(flatten_tree(sim.params), list(g),
                                      self.m)
        else:
            flat, ef_new = self._serve(g, ef_new, ms, costs, deadline)
        self._broadcast(rows, len(ms), ef_new, flat)
        return unflatten_like(flat, sim.params)

    def _account(self, ms: tuple[int, ...], costs_np: np.ndarray,
                 deadline: float) -> None:
        """Spend in f64 on the host, as the loop engine adds it, and the
        simulated server wall-clock (the slowest syncing device; under
        semi_sync at most the deadline)."""
        sim = self.sim
        walls = []
        for row, m in enumerate(ms):
            ccomp = comp_cost(sim.profiles[m], sim.decisions[m].h)
            total = {
                "energy_j": float(costs_np[row, 0]) + ccomp["energy_j"],
                "money": float(costs_np[row, 1]) + ccomp["money"],
                "time_s": float(costs_np[row, 2]) + ccomp["time_s"],
                "mb": float(costs_np[row, 3]) / 1e6,
            }
            for k, v in total.items():
                sim.spend[m][k] += v
            walls.append(total["time_s"])
        if sim.agg.uses_timing:
            sim.server_wall_s += min(deadline, max(walls))
        else:
            sim.server_wall_s += max(walls)

    # -- host loop: chain windows, decide at boundaries ----------------------
    def run(self) -> History:
        sim, cfg = self.sim, self.sim.cfg
        hist = History()
        sim.round_ms = []
        self.window_ms = []
        sim._decide_devices(range(self.m), 0)
        t = 0
        # pipelined: (sync set, reward round, enqueued reward losses) of the
        # last boundary, observed once the next window is dispatched
        deferred = None
        while t < cfg.rounds:
            t_start = time.perf_counter()
            te = min(min(sim.next_sync), cfg.rounds)
            ms = tuple(m for m in range(self.m) if sim.next_sync[m] <= te)
            sim._step_scenario(t, te)
            if ms:      # host values the window needs, on the device first
                ks, rows = self._sync_inputs(ms)
                ch, costs = self._channels(te, ms)
                deadline = (sim._window_deadline(ms)
                            if sim.agg.uses_timing else 1.0)
            h_arr = self._h_arr() if sim.per_device else None
            self._local_steps(t, te, self._draw_batches(t, te), h_arr)
            params = (self._sync(te, ms, ks, rows, ch, costs, deadline)
                      if ms else None)
            if deferred is not None:
                self._observe_and_stage(*deferred)
                deferred = None
            # eval points inside the window precede its sync: they see the
            # params and the spend from before it
            rec = [r for r in range(t, te)
                   if r % cfg.eval_every == 0 or r == cfg.rounds - 1]
            last_rec = bool(rec) and rec[-1] == te - 1
            for r in rec[:-1] if last_rec else rec:
                sim._record(hist, r)
            if ms:
                self._account(ms, costs, deadline)
                sim.params = params
                sim._update_chan_state()
                if cfg.pipeline_decisions:
                    # commit now (the next window's inputs); the reward eval
                    # goes on the device before the next window, the fleet
                    # reads it once that window is in flight
                    sim._commit_staged(ms, te)
                    need = sim._reward_need(ms)
                    deferred = (ms, te - 1, sim._reward_enqueue(need, te - 1)
                                if need else None)
                else:
                    sim._observe_devices(ms, te - 1)
                    sim._decide_devices(ms, te)
            if last_rec:
                sim._record(hist, te - 1)
            ms_window = (time.perf_counter() - t_start) * 1e3
            self.window_ms.append(ms_window)
            sim.round_ms.extend([ms_window / (te - t)] * (te - t))
            t = te
        if deferred is not None:
            # the last boundary: nothing left to overlap with
            self._observe_and_stage(*deferred)
        return hist

    def _observe_and_stage(self, ms: tuple[int, ...], t: int,
                           pending) -> None:
        """The deferred half of a pipelined boundary at round ``t``: the
        fleet observes the enqueued reward losses and stages the decisions
        for the boundary after next (the same fleet calls, in the same
        order, as the loop engine's)."""
        self.sim._observe_devices(ms, t, pending)
        self.sim._stage_decisions(ms, t + 1)


class ShardedEngine(BatchedEngine):
    """The batched engine with its device axis spread over the ranks of a
    :class:`repro_torch.launch.mesh.Mesh` (the reference's
    ``fl_batched.py:680-772``).

    Rank r holds the rows ``[r M / P, (r + 1) M / P)`` of ``w_hat``,
    ``anchor``, ``ef`` and the stacked data, with their global ids, so
    every stream (minibatches, QSGD dither, per-device windows) is keyed
    as unsharded.  The host loop (decisions, the scenario carry, channel
    draws and costs, the spend, History, the controller and its reward
    eval on the global model) is the base class's and runs whole on every
    rank: it is deterministic, so every rank keeps the same copy.  Only the
    sync differs: the rank compresses its own syncing rows (no row kernel
    when it holds none) and the server aggregation crosses the ranks:

    * ``"gather"``: every rank's update rows are gathered (padded to the
      largest count of syncing rows a rank holds) and every rank runs the
      unsharded server on them in global order, so History is bitwise the
      batched engine's;
    * ``"psum"``: each rank sums its own rows (the mean's flushed adds, or
      :func:`.fl.server_sums`) and the (D,) partial sums are added over the
      ranks: O(D) a link, reassociated.

    Under semi_sync each rank puts the undelivered share of its own late
    rows back into their e'."""

    def __init__(self, sim, mesh=None, server_reduce: str = "gather"):
        from repro_torch.launch.mesh import (fl_axis_name, fl_shards,
                                             make_host_mesh)
        check_server_reduce(server_reduce)
        self.mesh = (mesh if mesh is not None
                     else make_host_mesh(device=sim.device))
        self.axis = fl_axis_name(self.mesh)
        self.n_shards = fl_shards(self.mesh)
        self.server_reduce = server_reduce
        if self.mesh.device.type != sim.device.type:
            raise ValueError(f"ShardedEngine: the mesh holds tensors on "
                             f"{self.mesh.device}, the simulator on "
                             f"{sim.device}")
        m = sim.m_devices
        if m % self.n_shards != 0:
            raise ValueError(
                f"ShardedEngine: M={m} simulated devices do not divide over "
                f"{self.n_shards} mesh devices on axis {self.axis!r}; pick "
                f"M a multiple of the FL axis size")
        super().__init__(sim)

    def _block(self) -> tuple[int, int]:
        b = self.m // self.n_shards
        return self.mesh.rank * b, (self.mesh.rank + 1) * b

    def _gather_rows(self, counts: list[int], g: torch.Tensor
                     ) -> list[torch.Tensor]:
        """Every rank's update rows, ``counts[r]`` of rank r, in global
        order: one gather of each rank's rows padded to the largest
        count."""
        from repro_torch.launch.mesh import all_gather_rows
        top = max(counts)
        if g.shape[0] < top:
            g = torch.cat([g, g.new_zeros((top - g.shape[0], self.d))])
        every = all_gather_rows(self.mesh, g)
        return [every[r * top + i] for r, n in enumerate(counts)
                for i in range(n)]

    def _sync(self, te: int, ms: tuple[int, ...], ks: torch.Tensor | None,
              rows: torch.Tensor | None, ch: ChannelSample,
              costs: np.ndarray, deadline: float) -> dict:
        """The sync at round te - 1 of the devices ``ms`` (all ranks'; the
        budgets ``ks`` and row indices ``rows`` of the rank's own, as
        :meth:`_sync_inputs` gives them): the rank's compression, the
        server reduce across the ranks, the broadcast into the rank's own
        syncing rows."""
        from repro_torch.launch.mesh import psum
        sim = self.sim
        b = self.n_rows
        counts = [bisect.bisect_left(ms, (r + 1) * b)
                  - bisect.bisect_left(ms, r * b)
                  for r in range(self.n_shards)]
        j0 = bisect.bisect_left(ms, self.lo)
        j1 = j0 + counts[self.mesh.rank]
        flat = flatten_tree(sim.params)
        if j1 > j0:
            g, ef_new = self._compress(te, ms[j0:j1], ks, rows,
                                       ch.up[j0:j1])
        else:                   # no syncing row here: no row kernel
            g, ef_new = flat.new_zeros((0, self.d)), None
        agg = sim.agg.name
        if self.server_reduce == "gather":
            g_all = self._gather_rows(counts, g)
            if agg == "mean":
                flat = server_mean_update(flat, g_all, self.m)
            else:
                flat, undeliv = sim._server_apply(
                    torch.stack(g_all), self._window_times(ms, costs),
                    deadline)
                undeliv = undeliv[j0:j1]
        elif agg == "mean":
            part = (flushed_sum(list(g)) if j1 > j0
                    else torch.zeros_like(flat))
            flat = server_mean_step(flat, ftz(psum(self.mesh, part)),
                                    self.m)
        else:
            sums, undeliv = server_sums(
                agg, sim.cfg, g,
                self._window_times(ms[j0:j1], costs[j0:j1]), deadline)
            sums = tuple(ftz(psum(self.mesh, x)) for x in sums)
            flat, sim.server_state = server_step(
                agg, sim.cfg, flat, sim.server_state, sums, self.m)
        if j1 > j0:
            if agg == "semi_sync":
                ef_new = semi_sync_add_back(
                    ef_new, g, upload(undeliv, sim.device)[:, None])
            self._broadcast(rows, j1 - j0, ef_new, flat)
        return unflatten_like(flat, sim.params)
