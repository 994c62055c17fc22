"""The LGC train step (the paper's Algorithm 1 on one card) and the serving
steps.

Port of ``repro/launch/steps.py:51-166``, ``:329-518`` and ``:525-537``.
The reference maps the M FL devices onto a mesh axis with ``shard_map``;
here the M devices live on the one card:

  * each device runs H local SGD steps from the same params on its own slice
    of the batch (``w.f32 - lr * g.f32``, cast back to ``w.dtype``), one
    device after another;
  * the f32 net progress delta = w0 - w_H of every device is gathered per
    leaf into (M, n) rows and compressed with histogram-LGC and error
    feedback (``aggregate="dense_masked"``) in one launch of each LGC row
    kernel over the M rows (:func:`kernels.lgc_compress_hist_rows`), or sent
    dense (``aggregate="none"``, the FedAvg baseline);
  * the mean over devices replaces ``pmean``, and the server subtracts it.

Leaves of at least ``pallas_min_elems`` elements take the CUDA kernels when
``backend`` is ``"cuda"`` (``"pallas"`` is accepted as a synonym so the
reference's configurations carry over); smaller leaves, and every leaf under
``backend="exact"``, take the plain torch path of :mod:`kernels.ref`, row by
row.  Each row's bits are the flat kernel's on that row, so the step gives
the same params and error memory as compressing device by device
(``rows=False``, kept to hold the row kernels against, chip_smoke.py).
Arithmetic outside the kernels flushes f32 subnormals as the reference's
does (``core.fl.sgd_update``, ``kernels.ref.ftz``).

``sparse_gather`` and ``bucket_sparse`` are not ported yet (ROADMAP A13).

``make_prefill_step`` and ``make_serve_step`` wrap ``transformer.prefill``
and ``transformer.decode_step`` under ``torch.inference_mode()``, so no
autograd state keeps a layer's activations alive.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.compressor import PALLAS_MIN_ELEMS
from repro_torch.core.fl import sgd_update
from repro_torch.device import resolve_device
from repro_torch.kernels import lgc_compress_hist, lgc_compress_hist_rows
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
                        step_cfg: LGCStepConfig, *, rows: bool = True):
    """Algorithm 1: returns ``f(params, ef, batch, received=None) ->
    (params, ef, loss)``.

    ``batch`` holds ``tokens`` and ``labels`` of shape (M * b, S); device m
    takes rows [m*b, (m+1)*b), split into H microbatches, as the reference's
    ``P(fl_axis)`` batch spec gives it.  ``ef`` is the stacked
    ``(M, *leaf)`` error memory (:func:`init_ef_tree`); row m is device m's
    residual.  ``received`` ((M, C) int, ``None`` = all delivered) is the
    per-device per-channel delivery mask; FedAvg (``"none"``) ignores it.
    The step is functional: it returns new params and error memory.

    ``rows=False`` compresses each device's leaves with the flat kernels
    one device after another: the same bits in M times the launches, kept
    only to hold the row path against.
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
            rows_i = slice(i * mb, (i + 1) * mb)
            with torch.enable_grad():
                loss = tf.lm_loss(dict(zip(names, leaves)), cfg,
                                  {"tokens": tokens[rows_i],
                                   "labels": labels[rows_i]})
                grads = torch.autograd.grad(loss, leaves)
            with torch.no_grad():
                p = {k: sgd_update(w.to(torch.float32),
                                   g.to(torch.float32), lr).to(w.dtype)
                     for k, w, g in zip(names, leaves, grads)}
                loss_sum = loss_sum + loss.detach()
        return p, loss_sum

    def compress_leaf(e: torch.Tensor, delta: torch.Tensor,
                      received: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
        """(g, e_new) of one leaf over the M device rows, (M, n) each."""
        n = delta.shape[1]
        cum_ks = cum_ks_for(n, delta.device)
        kernel = (step_cfg.backend in ("cuda", "pallas")
                  and n >= step_cfg.pallas_min_elems)
        if rows and kernel:
            return lgc_compress_hist_rows(
                e, delta, cum_ks.expand(m_devices, -1), received)
        out = [_compress_leaf_dense(
            e[m], delta[m], step_cfg.sparsity, received[m],
            backend=step_cfg.backend,
            pallas_min_elems=step_cfg.pallas_min_elems, cum_ks=cum_ks)
            for m in range(m_devices)]
        return (torch.stack([g for g, _ in out]),
                torch.stack([en for _, en in out]))

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
        recv = received.to(torch.int32).contiguous()

        # ---- H local SGD steps per device; the (M, n) f32 net progress --
        deltas = {k: torch.empty((m_devices, w.numel()), dtype=torch.float32,
                                 device=device) for k, w in params.items()}
        loss_total = torch.zeros((), dtype=torch.float32, device=device)
        for m in range(m_devices):
            rows_m = slice(m * b_local, (m + 1) * b_local)
            p_end, loss_sum = local_sgd(params, tokens[rows_m],
                                        labels[rows_m])
            loss_total = loss_total + loss_sum / h
            for k, w0 in params.items():
                torch.sub(w0.to(torch.float32).reshape(-1),
                          p_end[k].to(torch.float32).reshape(-1),
                          out=deltas[k][m])
                deltas[k][m] = kref.ftz(deltas[k][m])
            del p_end

        # ---- compression with EF over the M rows, server update ---------
        params_new, ef_new = {}, {}
        for k, w in params.items():
            delta = deltas.pop(k)
            e_rows = ef[k].reshape(m_devices, -1)
            if step_cfg.aggregate == "none":            # FedAvg baseline
                g_wire = delta
                ef_new[k] = ef[k].clone()
            else:                                       # dense_masked
                g, e_new = compress_leaf(e_rows.to(torch.float32), delta,
                                         recv)
                g_wire = g.to(wire_dt)
                # the wire rounding residue joins the error memory
                e_new = kref.ftz_add(e_new, kref.ftz_add(
                    g, -g_wire.to(torch.float32)))
                ef_new[k] = e_new.to(ef_dt).reshape(ef[k].shape)
            # Alg. 1 lines 20-21: w - mean_m g_m, summed device by device
            g_sum = g_wire[0]
            for m in range(1, m_devices):
                g_sum = g_sum + g_wire[m]
            g_mean = kref.ftz(kref.div_f32(g_sum, m_devices).to(torch.float32))
            params_new[k] = kref.ftz_add(w.to(torch.float32).reshape(-1),
                                         -g_mean).to(w.dtype).reshape(w.shape)
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


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def make_prefill_step(cfg: ArchConfig, cache_len: int | None = None, *,
                      device: str | torch.device | None = None):
    """``f(params, batch) -> (logits (B,Vp), cache)`` on ``device`` (None
    means the card); the prompt tokens are moved there."""
    dev = resolve_device(device)

    @torch.inference_mode()
    def prefill_step(params, batch):
        batch = dict(batch, tokens=batch["tokens"].to(dev))
        return tf.prefill(params, cfg, batch, cache_len)
    return prefill_step


def make_serve_step(cfg: ArchConfig, window: int = 0, *,
                    device: str | torch.device | None = None,
                    return_logits: bool = False):
    """``f(params, token (B,1), cache) -> (next_token (B,1) int32, cache)``:
    one greedy decode step on ``device`` (None means the card).  The cache
    is updated in place.  With ``return_logits`` the step also returns the
    step's (B,Vp) f32 logits."""
    dev = resolve_device(device)

    @torch.inference_mode()
    def serve_step(params, token, cache):
        logits, cache = tf.decode_step(params, cfg, token.to(dev), cache,
                                       window=window)
        next_token = torch.argmax(logits, -1).to(torch.int32)[:, None]
        if return_logits:
            return next_token, cache, logits
        return next_token, cache
    return serve_step
