"""Server aggregation modes: the registry and the server math.

Port of ``repro/core/server.py:84-257``: :class:`AggregatorSpec`,
:data:`AGGREGATORS`, :func:`get_aggregator`, and the math the engines
splice in at the server update:

* ``mean``: the synchronous cohort mean (the default; the engines keep
  their own inline mean for it);
* ``diloco``: the cohort-averaged net delta is an outer gradient, and the
  server takes a Nesterov-momentum step on it (:func:`diloco_update`, with
  ``cfg.outer_lr`` / ``cfg.outer_momentum``);
* ``semi_sync``: each sync gets an uplink deadline (:func:`window_deadline`,
  ``cfg.deadline_factor`` times the median nominal window time of the
  syncing devices).  A device whose realised window time T exceeds it is
  ``s = ceil(T / deadline) - 1`` windows late: its update waits in the
  staleness ring of :class:`ServerState` and folds in s windows later with
  weight ``1 / (1 + s) ** cfg.staleness_alpha``, up to
  ``cfg.staleness_cap`` windows, or is dropped past it.  The mass the
  server never applies goes back into the device's error feedback.

The per-device bookkeeping (:func:`staleness_schedule`) runs where T lives,
on the host in f32 in both engines, so the card and the CPU weigh the
devices alike; the sums over devices and the state updates run on the
updates' device.  Arithmetic outside a reduction flushes f32 subnormals as
the reference's XLA:CPU does (``kernels.ref.ftz``).  The deadline and
:func:`nominal_uplink_s` are host f64 with their own median, so both
engines derive the same deadline for the same sync set.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.device import upload
from repro_torch.kernels.ref import div_f32, ftz, ftz_add


@dataclasses.dataclass(frozen=True)
class AggregatorSpec:
    """One server aggregation mode (an :data:`AGGREGATORS` entry)."""
    name: str
    uses_timing: bool       # window needs per-device times + a deadline
    carries_state: bool     # window threads a ServerState carry
    doc: str


AGGREGATORS: dict[str, AggregatorSpec] = {
    "mean": AggregatorSpec(
        "mean", uses_timing=False, carries_state=False,
        doc="synchronous cohort mean (the default)"),
    "diloco": AggregatorSpec(
        "diloco", uses_timing=False, carries_state=True,
        doc="H inner SGD steps per device, Nesterov-momentum outer step on "
            "the averaged net delta (outer_lr / outer_momentum)"),
    "semi_sync": AggregatorSpec(
        "semi_sync", uses_timing=True, carries_state=True,
        doc="per-window uplink deadline; late updates fold s windows later "
            "with weight 1/(1+s)^alpha up to staleness_cap, EF carrying the "
            "undelivered mass"),
}


def get_aggregator(name: str) -> AggregatorSpec:
    """Resolve a registry name, raising on unknown aggregators."""
    try:
        return AGGREGATORS[name]
    except KeyError:
        raise ValueError(
            f"unknown aggregator {name!r}; registered: "
            f"{sorted(AGGREGATORS)}") from None


class ServerState(NamedTuple):
    """Server-side state carried across syncs: ``momentum`` (D,) f32, the
    DiLoCo outer momentum (zeros under other aggregators); ``stale``
    (cap, D) f32, the semi-sync staleness ring, whose row j folds into the
    aggregate j + 1 server rounds from now."""
    momentum: torch.Tensor
    stale: torch.Tensor


def init_server_state(cfg, d: int, device: str | torch.device = "cpu"
                      ) -> ServerState:
    """Zero state sized for ``cfg`` (ring rows only under semi_sync)."""
    if cfg.staleness_cap < 0:
        raise ValueError(f"staleness_cap must be >= 0, got "
                         f"{cfg.staleness_cap}")
    cap = int(cfg.staleness_cap) if cfg.aggregator == "semi_sync" else 0
    return ServerState(
        momentum=torch.zeros((d,), dtype=torch.float32, device=device),
        stale=torch.zeros((cap, d), dtype=torch.float32, device=device))


# ---------------------------------------------------------------------------
# the deadline: host f64, shared by the engines
# ---------------------------------------------------------------------------

def nominal_uplink_s(cfg, mode: str, ks: Sequence[int], d: int) -> float:
    """Nominal (spec-bandwidth, all channels up) uplink seconds of one
    device's budgets: the layers travel in parallel, so the max over the
    channels."""
    bws = [c.bandwidth_mb_s for c in cfg.channels]
    if mode == "fedavg":
        return d * cfg.value_bytes / 1e6 / max(bws)
    ks = list(ks)
    if mode == "topk":
        ks = [sum(ks)] + [0] * (len(ks) - 1)
    vb = 1 if mode == "lgc_q8" else cfg.value_bytes
    return max(k * (vb + cfg.index_bytes) / 1e6 / bw
               for k, bw in zip(ks, bws))


def window_deadline(cfg, mode: str, d: int, items) -> float:
    """The semi-sync uplink deadline of one sync: ``cfg.deadline_factor``
    times the median nominal window time (compute + nominal uplink) of the
    syncing devices; ``items`` is ``[(h, ks, profile), ...]``.  Host f64."""
    times = [p.comp_time_per_step_s * h + nominal_uplink_s(cfg, mode, ks, d)
             for h, ks, p in items]
    return max(float(cfg.deadline_factor) * float(np.median(times)), 1e-9)


# ---------------------------------------------------------------------------
# the server math
# ---------------------------------------------------------------------------

def staleness_schedule(T: torch.Tensor, deadline, mask: torch.Tensor,
                       alpha: float, cap: int):
    """Per-device lateness of one sync: ``(s, w, on_time, undelivered)``.

    s = max(ceil(T / deadline) - 1, 0) windows (f32, 0 where ``mask`` is
    False), the fold weight w = 1 / (1 + s) ** alpha, the on-time mask, and
    the share of each update the server never applies (0 on time, 1 - w
    while buffered, 1 past the cap).  T (N,) f32; ``deadline`` f32."""
    T = T.to(torch.float32)
    dl = torch.clamp_min(torch.as_tensor(deadline, dtype=torch.float32,
                                         device=T.device), 1e-9)
    s = torch.clamp_min(torch.ceil(T / dl) - 1.0, 0.0)
    s = torch.where(mask, s, torch.zeros_like(s))
    on = mask & (s == 0.0)
    w = 1.0 / (1.0 + s) ** alpha
    undeliv = torch.where(on | ~mask, torch.zeros_like(s),
                          torch.where(s <= cap, 1.0 - w, torch.ones_like(s)))
    return s, w, on, undeliv


def semi_sync_sums(g: torch.Tensor, T: torch.Tensor, mask: torch.Tensor,
                   deadline, alpha: float, cap: int):
    """The sums over devices of one semi-sync fold: ``(g_now, contrib,
    n_sync)``, the on-time aggregate (D,), the ring deposits (cap, D) (row
    j: w(j + 1) g of the devices exactly j + 1 windows late) and the
    syncing-device count.  g (N, D) on its device; T and mask (N,) where
    the schedule is taken (the engines: the host)."""
    s, w, on, _ = staleness_schedule(T, deadline, mask, alpha, cap)
    sel = mask & (s >= 1.0) & (s <= cap)
    wsel = torch.where(sel, w, torch.zeros_like(w))
    onehot = ((s.to(torch.int64) - 1)[:, None]
              == torch.arange(cap, device=s.device)[None, :])
    # column 0: on time; columns 1..cap: the ring rows' weights
    coef = upload(torch.cat([on[:, None].to(torch.float32),
                             onehot.to(torch.float32) * wsel[:, None]], 1),
                  g.device)
    g_now = torch.where(coef[:, :1] > 0, g, torch.zeros_like(g)).sum(0)
    contrib = coef[:, 1:].T @ g
    return ftz(g_now), ftz(contrib), int(mask.sum())


def semi_sync_update(flat: torch.Tensor, state: ServerState,
                     g_now: torch.Tensor, contrib: torch.Tensor, fold,
                     m_total: int):
    """One semi-sync server round on the flat global model: the maturing
    ring row joins the on-time aggregate, the ring shifts by one and takes
    this sync's deposits, and flat loses the aggregate over ``m_total``.
    ``fold`` False leaves flat and the ring untouched."""
    if not bool(fold):
        return flat, state
    cap = state.stale.shape[0]
    g_apply = g_now
    if cap:
        g_apply = ftz_add(g_now, state.stale[0])
        shifted = torch.cat([state.stale[1:],
                             torch.zeros_like(state.stale[:1])])
        state = state._replace(stale=ftz_add(shifted, contrib))
    return ftz_add(flat, -ftz(div_f32(g_apply, m_total))), state


def diloco_update(flat: torch.Tensor, state: ServerState,
                  delta: torch.Tensor, fold, outer_lr: float,
                  outer_mu: float):
    """One Nesterov-momentum outer step on the averaged net delta:
    m' = mu m + delta, flat -= lr (delta + mu m').  At lr 1 and mu 0 this
    is the plain mean.  ``fold`` False leaves flat and m untouched."""
    if not bool(fold):
        return flat, state
    mom = ftz_add(ftz(outer_mu * state.momentum), delta)
    step = ftz(outer_lr * ftz_add(delta, ftz(outer_mu * mom)))
    return ftz_add(flat, -step), state._replace(momentum=mom)
