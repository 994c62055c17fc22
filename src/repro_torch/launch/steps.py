"""The LGC train step: the paper's Algorithm 1 on one card.

Port of ``repro/launch/steps.py:51-166`` and ``:329-518``.  The reference
maps the M FL devices onto a mesh axis with ``shard_map``; here the M devices
live on the one card and run one after another:

  * each device runs H local SGD steps from the same params on its own slice
    of the batch (``w.f32 - lr * g.f32``, cast back to ``w.dtype``);
  * its f32 net progress delta = w0 - w_H is compressed per leaf with
    histogram-LGC and error feedback (``aggregate="dense_masked"``), or sent
    dense (``aggregate="none"``, the FedAvg baseline);
  * the mean over devices replaces ``pmean``, and the server subtracts it.

Leaves of at least ``pallas_min_elems`` elements take the CUDA kernels when
``backend`` is ``"cuda"`` (``"pallas"`` is accepted as a synonym so the
reference's configurations carry over); smaller leaves, and every leaf under
``backend="exact"``, take the plain torch path of :mod:`kernels.ref`.

``sparse_gather`` and ``bucket_sparse`` are not ported yet (ROADMAP A13).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.compressor import PALLAS_MIN_ELEMS
from repro_torch.kernels import lgc_compress_hist
from repro_torch.kernels import ref as kref
from repro_torch.models import transformer as tf

AGGREGATES = ("dense_masked", "none")
NOT_PORTED_AGGREGATES = ("sparse_gather", "bucket_sparse")
BACKENDS = ("exact", "cuda", "pallas")


@dataclasses.dataclass(frozen=True)
class LGCStepConfig:
    local_steps: int = 4                   # H: local SGD steps per sync
    local_lr: float = 1e-3
    sparsity: tuple = (0.01, 0.02, 0.02)   # per-channel k_c / D fractions
    aggregate: str = "dense_masked"        # dense_masked | none
    ef_dtype: str = "float32"
    # dtype of the exchanged masked update; its rounding residue joins the
    # error memory as in the reference
    psum_dtype: str = "float32"
    # "cuda" (or its synonym "pallas") routes leaves of >= pallas_min_elems
    # elements through the CUDA kernels; "exact" keeps every leaf plain
    backend: str = "exact"
    pallas_min_elems: int = PALLAS_MIN_ELEMS

    def __post_init__(self):
        if self.aggregate in NOT_PORTED_AGGREGATES:
            raise NotImplementedError(
                f"aggregate={self.aggregate!r} is not ported yet (ROADMAP "
                f"A13); ported: {AGGREGATES}")
        if self.aggregate not in AGGREGATES:
            raise ValueError(f"unknown aggregate {self.aggregate!r}")
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}; "
                             f"choose from {BACKENDS}")
        if not 1 <= len(self.sparsity) <= 4:
            raise ValueError("1 to 4 channels are supported")

    @property
    def n_channels(self) -> int:
        return len(self.sparsity)


# ---------------------------------------------------------------------------
# per-leaf compression
# ---------------------------------------------------------------------------

def _leaf_ks(size: int, sparsity: Sequence[float]) -> list[int]:
    """Per-channel k budgets, cumulatively clamped to the leaf size: channel
    c owns ranks [cum[c-1], cum[c]) and trailing channels degrade to k=0
    once the leaf is exhausted (the reference's clamp, steps.py:123)."""
    ks = [max(1, int(size * f)) for f in sparsity]
    cum = np.minimum(np.cumsum(ks), size)
    return np.diff(np.concatenate([[0], cum])).tolist()


def _leaf_cum_ks(size: int, sparsity: Sequence[float],
                 device: str | torch.device = "cpu") -> torch.Tensor:
    return torch.tensor(np.cumsum(_leaf_ks(size, sparsity)),
                        dtype=torch.int32, device=device)


def _compress_leaf_dense(e: torch.Tensor, delta: torch.Tensor, sparsity,
                         recv: torch.Tensor, *, backend: str = "exact",
                         pallas_min_elems: int = PALLAS_MIN_ELEMS,
                         cum_ks: torch.Tensor | None = None
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Histogram-LGC on one tensor; returns (g, e_new) with the leaf's shape.

    ``recv`` is this FL device's (C,) delivery mask: masked channels add
    nothing to g and their mass stays in the error memory.  ``cum_ks`` may
    be passed precomputed on the leaf's device (the step does, so that no
    host-to-device copy sits in the loop).
    """
    shape = delta.shape
    e_flat = e.reshape(-1).to(torch.float32)
    d_flat = delta.reshape(-1).to(torch.float32)
    n = d_flat.shape[0]
    if cum_ks is None:
        cum_ks = _leaf_cum_ks(n, sparsity, d_flat.device)
    if backend in ("cuda", "pallas") and n >= pallas_min_elems:
        g, e_new = lgc_compress_hist(e_flat, d_flat, cum_ks, recv)
    elif backend in BACKENDS:
        g, e_new = kref.hist_lgc_compress(e_flat, d_flat, cum_ks, recv)
    else:
        raise ValueError(f"unknown backend {backend!r}")
    return g.reshape(shape), e_new.reshape(shape)


# ---------------------------------------------------------------------------
# the LGC train step
# ---------------------------------------------------------------------------

def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def make_lgc_train_step(cfg: ArchConfig, m_devices: int,
                        step_cfg: LGCStepConfig):
    """Algorithm 1: returns ``f(params, ef, batch, received=None) ->
    (params, ef, loss)``.

    ``batch`` holds ``tokens`` and ``labels`` of shape (M * b, S); device m
    takes rows [m*b, (m+1)*b), split into H microbatches, as the reference's
    ``P(fl_axis)`` batch spec gives it.  ``ef`` is the stacked
    ``(M, *leaf)`` error memory (:func:`init_ef_tree`); row m is device m's
    residual.  ``received`` ((M, C) int, ``None`` = all delivered) is the
    per-device per-channel delivery mask; FedAvg (``"none"``) ignores it.
    The step is functional: it returns new params and error memory.
    """
    h, n_ch, lr = step_cfg.local_steps, step_cfg.n_channels, step_cfg.local_lr
    wire_dt = _dtype(step_cfg.psum_dtype)
    ef_dt = _dtype(step_cfg.ef_dtype)
    cum_ks_cache: dict = {}

    def cum_ks_for(n: int, device) -> torch.Tensor:
        key = (n, str(device))
        if key not in cum_ks_cache:
            cum_ks_cache[key] = _leaf_cum_ks(n, step_cfg.sparsity, device)
        return cum_ks_cache[key]

    def local_sgd(params, tokens, labels):
        """H plain SGD steps from ``params``; returns (params_H, loss_sum)."""
        names = list(params)
        p = params
        loss_sum = torch.zeros((), dtype=torch.float32,
                               device=tokens.device)
        mb = tokens.shape[0] // h
        for i in range(h):
            leaves = [p[k].detach().requires_grad_(True) for k in names]
            rows = slice(i * mb, (i + 1) * mb)
            with torch.enable_grad():
                loss = tf.lm_loss(dict(zip(names, leaves)), cfg,
                                  {"tokens": tokens[rows],
                                   "labels": labels[rows]})
                grads = torch.autograd.grad(loss, leaves)
            with torch.no_grad():
                p = {k: (w.to(torch.float32) - lr * g.to(torch.float32)
                         ).to(w.dtype)
                     for k, w, g in zip(names, leaves, grads)}
                loss_sum = loss_sum + loss.detach()
        return p, loss_sum

    @torch.no_grad()
    def step(params, ef, batch, received=None):
        tokens, labels = batch["tokens"], batch["labels"]
        device = tokens.device
        b_all = tokens.shape[0]
        if b_all % m_devices:
            raise ValueError(f"batch {b_all} is not divisible by "
                             f"{m_devices} FL devices")
        b_local = b_all // m_devices
        if b_local % h or b_local < h:
            raise ValueError(f"per-FL-device batch {b_local} must be "
                             f"divisible by local_steps H={h}")
        if received is None:
            received = torch.ones((m_devices, n_ch), dtype=torch.int32,
                                  device=device)
        if tuple(received.shape) != (m_devices, n_ch):
            raise ValueError(f"received must be ({m_devices}, {n_ch})")

        g_sum: dict[str, torch.Tensor] = {}
        ef_new = {k: torch.empty_like(v) for k, v in ef.items()}
        loss_total = torch.zeros((), dtype=torch.float32, device=device)
        for m in range(m_devices):
            rows = slice(m * b_local, (m + 1) * b_local)
            p_end, loss_sum = local_sgd(params, tokens[rows], labels[rows])
            loss_total = loss_total + loss_sum / h
            recv = received[m].to(torch.int32)
            for k, w0 in params.items():
                delta = w0.to(torch.float32) - p_end[k].to(torch.float32)
                if step_cfg.aggregate == "none":        # FedAvg baseline
                    g_wire = delta
                    ef_new[k][m] = ef[k][m]
                else:                                   # dense_masked
                    g, e_new = _compress_leaf_dense(
                        ef[k][m], delta, step_cfg.sparsity, recv,
                        backend=step_cfg.backend,
                        pallas_min_elems=step_cfg.pallas_min_elems,
                        cum_ks=cum_ks_for(delta.numel(), device))
                    g_wire = g.to(wire_dt)
                    # the wire rounding residue joins the error memory
                    ef_new[k][m] = (e_new + (g - g_wire.to(torch.float32))
                                    ).to(ef_dt)
                g_sum[k] = g_wire if m == 0 else g_sum[k] + g_wire
            del p_end

        # ---- server update (Alg. 1 lines 20-21): w - mean_m g_m ----------
        params_new = {
            k: (w.to(torch.float32)
                - (g_sum[k] / m_devices).to(torch.float32)).to(w.dtype)
            for k, w in params.items()}
        return params_new, ef_new, loss_total / m_devices

    return step


def init_ef_tree(params: dict, n_fl: int = 1, dtype=torch.float32) -> dict:
    """Stacked per-FL-device error memory: leaves ``(n_fl, *param_shape)``;
    row m is device m's residual."""
    return {k: torch.zeros((n_fl,) + tuple(p.shape), dtype=dtype,
                           device=p.device)
            for k, p in params.items()}


def lgc_wire_bytes_per_round(params: dict, step_cfg: LGCStepConfig,
                             value_bytes: int = 4, index_bytes: int = 4
                             ) -> dict[str, int]:
    """Per-device uplink bytes for one sync round, by aggregate mode, from
    the clamped per-leaf budgets (:func:`_leaf_ks`).  ``params`` may live on
    the meta device."""
    leaves = [int(p.numel()) for p in params.values()]
    k_total = sum(sum(_leaf_ks(n, step_cfg.sparsity)) for n in leaves)
    d_total = sum(leaves)
    psum_bytes = _dtype(step_cfg.psum_dtype).itemsize
    return {
        "none": d_total * value_bytes,
        "dense_masked": d_total * psum_bytes,
        "sparse_gather": k_total * (value_bytes + index_bytes),
        "bucket_sparse": k_total * (value_bytes + index_bytes),
    }
