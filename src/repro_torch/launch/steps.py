"""The LGC train step (the paper's Algorithm 1 on one card) and the serving
steps.

Port of ``repro/launch/steps.py``.  The reference maps the M FL devices
onto a mesh axis with ``shard_map``; here the M devices live on the one
card:

  * each device runs H local SGD steps from the same params on its own slice
    of the batch (``w.f32 - lr * g.f32``, cast back to ``w.dtype``), one
    device after another;
  * the f32 net progress delta = w0 - w_H of every device is gathered per
    leaf into (M, n) rows and compressed with histogram-LGC and error
    feedback (``aggregate="dense_masked"``) in one launch of each LGC row
    kernel over the M rows (:func:`kernels.lgc_compress_hist_rows`), or sent
    dense (``aggregate="none"``, the FedAvg baseline);
  * the mean over devices replaces ``pmean``, and the server subtracts it;
  * ``sparse_gather`` sends per channel the top k_eff of the channel's
    magnitude band (u and its row maxima from one launch of the maxabs row
    kernel per leaf, the bands' thresholds from one launch of the histogram
    row kernel), and ``bucket_sparse`` the largest-magnitude element of
    each of K strided buckets (no kernel, as in the reference).  The
    reference's ``all_gather`` of the (values, indices) pairs becomes the
    M stacked rows, and the server adds them channel by channel, device by
    device within a channel, in the reference's order.

Leaves of at least ``pallas_min_elems`` elements take the CUDA kernels when
``backend`` is ``"cuda"`` (``"pallas"`` is accepted as a synonym so the
reference's configurations carry over); smaller leaves, and every leaf under
``backend="exact"``, take the plain torch path of :mod:`kernels.ref`, row by
row.  Each row's bits are the flat kernel's on that row, so the step gives
the same params and error memory as compressing device by device
(``rows=False``, kept to hold the row kernels against, chip_smoke.py).
Arithmetic outside the kernels flushes f32 subnormals as the reference's
does (``core.fl.sgd_update``, ``kernels.ref.ftz``).

``make_sync_train_step`` is the framework baseline: one optimizer step on
the whole batch (microbatches accumulated in f32), through
:mod:`repro_torch.optim`.

Both train steps take a ``mesh`` with a model axis P > 1 (ROADMAP A12:
the dense family; A12c: the moe, ssm, hybrid, vlm and audio families):
params, error memory and gradients are then each rank's shards
(``sharding_rules.param_specs``) for all M devices, the forward and
backward run tensor-parallel (``transformer.lm_loss(..., mesh=)``), the
gradients of the leaves held whole but used a block at a time (the SSD
leaves split by heads, the MoE router by experts) are summed over the
ranks (``transformer.sum_split_use_grads``) before the optimizer or the
local SGD step, and the three LGC row kernels run on each rank's shards
of a split leaf under ``dense_masked`` (an expert-parallel leaf's shard
(L, E / P, D, F) is not a contiguous block of the whole's flat order,
which neither the statistics nor the elementwise step read): the rows' maxima from
``sum_maxabs_rows`` are reduced with a MAX over the model group, the
256-bin counts that ``histogram_rows`` takes of the shard under the global
maxima with a SUM, and the thresholds come from the whole leaf's budgets,
so ``sparsify_ef_rows`` gives each rank bitwise its block of the
unsharded ``lgc_compress_hist_rows`` (max and integer counts are exact).
A replicated leaf is compressed whole on every rank.  The sparse modes
select along rows of each leaf's model-dim view, whose rows a rank holds
a block of, so selection stays on the rank; a rule that selects along
another dim (the driver's whole-leaf rows) gathers the leaf, compresses it
whole and keeps the rank's block.

``make_prefill_step`` and ``make_serve_step`` wrap ``transformer.prefill``
and ``transformer.decode_step`` under ``torch.inference_mode()``, so no
autograd state keeps a layer's activations alive.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch import parallel
from repro_torch.configs.base import ArchConfig
from repro_torch.core.compressor import PALLAS_MIN_ELEMS
from repro_torch.core.fl import sgd_update
from repro_torch.device import resolve_device
from repro_torch.kernels import (histogram_rows, lgc_compress_hist,
                                 lgc_compress_hist_rows, sparsify_ef_rows,
                                 sum_maxabs_rows, thresholds_from_counts)
from repro_torch.kernels import ref as kref
from repro_torch.launch import sharding_rules as rules
from repro_torch.models import transformer as tf
from repro_torch.optim.optimizers import (OptimizerConfig, apply_updates,
                                          get_optimizer)

AGGREGATES = ("dense_masked", "sparse_gather", "bucket_sparse", "none")
BACKENDS = ("exact", "cuda", "pallas")

# the reference's per-arch gradient-accumulation defaults (steps.py:42-46)
ACCUM_STEPS = {
    "glm4-9b": 4, "yi-34b": 8, "grok-1-314b": 8, "starcoder2-7b": 4,
    "phi-3-vision-4.2b": 4, "olmoe-1b-7b": 2, "qwen2-1.5b": 2,
    "mamba2-370m": 2, "zamba2-1.2b": 2, "whisper-small": 2,
}


@dataclasses.dataclass(frozen=True)
class LGCStepConfig:
    local_steps: int = 4                   # H: local SGD steps per sync
    local_lr: float = 1e-3
    sparsity: tuple = (0.01, 0.02, 0.02)   # per-channel k_c / D fractions
    # dense_masked | sparse_gather | bucket_sparse | none
    aggregate: str = "dense_masked"
    ef_dtype: str = "float32"
    # dtype of the exchanged masked update; its rounding residue joins the
    # error memory as in the reference
    psum_dtype: str = "float32"
    # "cuda" (or its synonym "pallas") routes leaves of >= pallas_min_elems
    # elements through the CUDA kernels; "exact" keeps every leaf plain
    backend: str = "exact"
    pallas_min_elems: int = PALLAS_MIN_ELEMS

    def __post_init__(self):
        if self.aggregate not in AGGREGATES:
            raise ValueError(f"unknown aggregate {self.aggregate!r}; "
                             f"choose from {AGGREGATES}")
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}; "
                             f"choose from {BACKENDS}")
        if not 1 <= len(self.sparsity) <= 4:
            raise ValueError("1 to 4 channels are supported")

    @property
    def n_channels(self) -> int:
        return len(self.sparsity)


# ---------------------------------------------------------------------------
# sync (standard data-parallel) training -- the framework baseline
# ---------------------------------------------------------------------------

def _rows_of(batch: dict, rows: slice) -> dict:
    """Rows ``rows`` of every batch leaf (tokens, labels and a modality
    prefix alike), as the reference reshapes every leaf of the batch."""
    return {k: v[rows] for k, v in batch.items()}


def model_specs(cfg: ArchConfig, mesh) -> dict | None:
    """The param specs of ``cfg`` on ``mesh`` when it has a model axis
    above 1 (the leaves are then each rank's shards), else None."""
    if mesh is None or mesh.model_size == 1:
        return None
    tf.model_axis_mesh(cfg, mesh)    # P | the heads and the padded vocab
    if mesh.shape.get("data", 1) != 1:
        raise ValueError(f"the model axis trains on a (data=1, model=P) "
                         f"mesh, the FL devices as rows; got {mesh.shape}")
    return rules.param_specs(cfg, tf.init_params(cfg, device="meta"), mesh)


def make_sync_train_step(cfg: ArchConfig, *, accum_steps: int = 1,
                         opt_cfg: OptimizerConfig | None = None, mesh=None):
    """``f(params, opt_state, batch) -> (params, opt_state, loss)``: one
    step of ``cfg.optimizer`` on the gradient of the whole batch (the
    reference's ``make_sync_train_step``, steps.py:84-114).  With
    ``accum_steps > 1`` the batch (every leaf: tokens, labels and a
    modality ``prefix``) is split into that many microbatches of
    consecutive rows whose gradients are summed in f32, then divided and
    cast to each parameter's dtype, and whose losses are averaged.
    ``mesh`` with a model axis: params and state are this rank's shards,
    the batch is whole on every rank, and the split-use SSD leaves'
    gradients are summed over the ranks before the optimizer sees them."""
    specs = model_specs(cfg, mesh)
    _, opt_update = get_optimizer(cfg.optimizer, opt_cfg, mesh=mesh,
                                  specs=specs)

    def loss_and_grads(params, batch):
        names = list(params)
        leaves = [params[k].detach().requires_grad_(True) for k in names]
        with torch.enable_grad():
            loss = tf.lm_loss(dict(zip(names, leaves)), cfg, batch,
                              mesh=mesh)
            grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), tf.sum_split_use_grads(
            cfg, dict(zip(names, grads)), mesh)

    @torch.no_grad()
    def train_step(params, opt_state, batch):
        tokens = batch["tokens"]
        if accum_steps == 1:
            loss, grads = loss_and_grads(params, batch)
        else:
            if tokens.shape[0] % accum_steps:
                raise ValueError(f"batch {tokens.shape[0]} is not divisible "
                                 f"by accum_steps={accum_steps}")
            mb = tokens.shape[0] // accum_steps
            loss = torch.zeros((), dtype=torch.float32, device=tokens.device)
            g_sum = {k: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for k, p in params.items()}
            for i in range(accum_steps):
                l_i, g_i = loss_and_grads(
                    params, _rows_of(batch, slice(i * mb, (i + 1) * mb)))
                loss = loss + l_i
                g_sum = {k: kref.ftz_add(g_sum[k], g_i[k].float())
                         for k in g_sum}
            loss = kref.div_f32(loss, accum_steps)
            grads = {k: kref.ftz(kref.div_f32(g, accum_steps)).to(
                params[k].dtype) for k, g in g_sum.items()}
        updates, opt_state = opt_update(grads, opt_state, params)
        return apply_updates(params, updates), opt_state, loss

    return train_step


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


def _band_top_k(band: torch.Tensor, k: int) -> torch.Tensor:
    """The non-zero entries of each row of ``band`` (M, n) that
    ``lax.top_k(band, k)`` selects, as a bool mask: those above the row's
    k-th largest value v, and of those equal to v the lowest-index ones
    that fill k.  Ties at v are what ``torch.topk`` leaves unordered, so
    only its values are used, and the tie is resolved with a running count
    of the equal entries (no host sync)."""
    v = torch.topk(band, k, dim=1, sorted=False).values.amin(1, keepdim=True)
    above = band > v
    room = k - above.sum(1, keepdim=True, dtype=torch.int32)
    tied = band == v
    first = torch.cumsum(tied, 1, dtype=torch.int32) <= room
    return (above | (tied & first)) & (band > 0)


# the leaf dim each name's PartitionSpec shards over "model" in the
# reference's sharding_rules.param_specs for the dense family, before the
# stacked-layer dim; the 100M task's sparse uplinks select along rows of
# that dim (it agrees with sharding_rules.param_specs on every dense leaf,
# tests/test_torch_tensor_parallel.py)
_MODEL_DIM = {"embed": 0, "lm_head": 1, "wq": 1, "wk": 1, "wv": 1, "wo": 0,
              "bq": 0, "bk": 0, "bv": 0, "w_gate": 1, "w_up": 1,
              "w_down": 0, "b_up": 0}


def leaf_model_axis(path: str, ndim: int) -> int | None:
    """The dim of leaf ``path`` (``"blocks/attn/wq"``) that the reference's
    spec shards over "model", or None: the dense task's rule, which the
    100M task passes to :func:`make_lgc_train_step` (``model_axis``) as
    the reference's task passes its param specs.  Its sparse uplinks then
    move that dim to the front and select per row of that view; the view
    exists whatever the size of the model axis, also on one card.  It
    knows only the dense leaf names (the MoE's stacked experts would take
    the wrong dim), and the train driver passes no rule, as the
    reference's driver passes no specs."""
    names = path.split("/")
    dim = _MODEL_DIM.get(names[-1])
    if dim is None:
        return None
    dim += names[0] == "blocks"
    return dim if dim < ndim else None


def _server_add(g_sum: torch.Tensor | None, sent: torch.Tensor
                ) -> torch.Tensor:
    """Add one channel's sent rows (M, R, n) to the server's sum, device by
    device, each add flushed: called channel after channel, this is the
    reference's order of scatter-adds of the gathered pairs (channel
    outer, device inner, steps.py:221-249)."""
    for dev in sent.unbind(0):
        g_sum = dev.clone() if g_sum is None else kref.ftz_add(g_sum, dev)
    return g_sum


def _leaf_result(g_sum, u: torch.Tensor, g_own: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """(g_mean, e_new) from the server's sum and the devices' own sent
    mass, all (M, R, n)."""
    if g_sum is None:
        g_sum = torch.zeros_like(u[0])
    return (kref.ftz(kref.div_f32(g_sum, u.shape[0])),
            kref.ftz_add(u, -g_own))


def _row_mask(received: torch.Tensor, rows: int) -> torch.Tensor:
    """(M, C) delivery masks as (M R, C) bools, device m's on its R rows
    (an expand: ``repeat_interleave`` would read the count back to the
    host on the card)."""
    m_dev, n_ch = received.shape
    return (received > 0)[:, None, :].expand(m_dev, rows, n_ch).reshape(
        m_dev * rows, n_ch)


def _row_stats(e: torch.Tensor, delta: torch.Tensor):
    """u = e + delta, its row maxima and 256-bin counts through the maxabs
    and histogram row kernels: one launch of each at any row count."""
    u, mx = sum_maxabs_rows(e, delta)
    return u, mx, histogram_rows(u, mx)


def _compress_leaf_sparse(e: torch.Tensor, delta: torch.Tensor, sparsity,
                          received: torch.Tensor, *, kernels: bool = False,
                          cum_ks: torch.Tensor | None = None
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Layered top-k exchange of one leaf over the M devices: e, delta
    (M, R, n), the leaf viewed as R rows of n (its model dim first, under
    a ``model_axis`` rule such as :func:`leaf_model_axis`; R = 1 without
    one), and received (M, C).
    Returns (g_mean (R, n), e_new (M, R, n)), f32.

    Port of ``_compress_leaf_sparse`` (steps.py:179-257) with the FL axis
    on the devices.  u = e + delta and the maxima of its M R rows come
    from one launch of the maxabs row kernel and their 256-bin counts from
    one of the histogram row kernel when ``kernels``, else from their
    plain versions (the same bits).  Channel c of each row sends the top
    k_eff = k_c + max(1, n // 256) of its band thr_c < |u| <= thr_{c-1}
    (a zero slot sends nothing); what a device sends, or would have sent
    on a dropped channel, is held as rows with zeros elsewhere, one
    channel at a time."""
    m_dev, rows, cols = delta.shape
    e = e.reshape(m_dev * rows, cols)
    delta = delta.reshape(m_dev * rows, cols)
    if kernels:
        u, mx, counts = _row_stats(e.contiguous(), delta.contiguous())
    else:
        u = kref.ftz_add(e, delta)
        mx = kref.hist_maxabs_rows(u)
        counts = kref.hist_counts_rows(u, mx)
    ks = _leaf_ks(cols, sparsity)
    if cum_ks is None:
        cum_ks = _leaf_cum_ks(cols, sparsity, u.device)
    thr = thresholds_from_counts(counts, mx, cum_ks.expand(m_dev * rows, -1))
    recv = _row_mask(received, rows)
    a = u.abs()
    g_own, g_sum = torch.zeros_like(u), None
    for c, k_c in enumerate(ks):
        if k_c == 0:
            continue
        hi = thr[:, c - 1:c] if c else torch.full_like(thr[:, :1], math.inf)
        band = torch.where((a <= hi) & (a > thr[:, c:c + 1]), a,
                           torch.zeros_like(a))
        k_eff = min(k_c + max(1, cols // kref.N_BINS), cols)
        take = _band_top_k(band, k_eff) & recv[:, c:c + 1]
        del band
        sent = torch.where(take, u, torch.zeros_like(u))
        g_own = kref.ftz_add(g_own, sent)
        g_sum = _server_add(g_sum, sent.view(m_dev, rows, cols))
    shape = (m_dev, rows, cols)
    return _leaf_result(g_sum, u.view(shape), g_own.view(shape))


def _compress_leaf_bucket(e: torch.Tensor, delta: torch.Tensor, sparsity,
                          received: torch.Tensor
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Bucketed layered selection of one leaf over the M devices, in the
    layouts of :func:`_compress_leaf_sparse` (``_compress_leaf_bucket``,
    steps.py:259-327): each row split into k_eff = n // bucket strided
    buckets of ``bucket = max(n // K, 1)``, each bucket's first largest
    |u|; channel c carries buckets [sum ks[:c], sum ks[:c+1]), and the
    tail buckets past K and dropped channels stay in the error memory."""
    m_dev, rows, cols = delta.shape
    u = kref.ftz_add(e, delta).reshape(m_dev * rows, cols)
    ks = _leaf_ks(cols, sparsity)
    bucket = max(cols // sum(ks), 1)
    k_eff = cols // bucket
    ub = u[:, :k_eff * bucket].reshape(-1, k_eff, bucket)
    pos = torch.argmax(ub.abs(), -1)                   # first among ties
    idx = torch.arange(k_eff, device=u.device) * bucket + pos
    vals = torch.gather(ub, 2, pos[..., None])[..., 0]
    recv = _row_mask(received, rows)
    g_own, g_sum = torch.zeros_like(u), None
    lo = 0
    for c, k_c in enumerate(ks):
        hi = min(lo + k_c, k_eff)
        if hi <= lo:
            break
        v_c = torch.where(recv[:, c:c + 1], vals[:, lo:hi],
                          torch.zeros_like(vals[:, lo:hi]))
        sent = torch.zeros_like(u).scatter_(1, idx[:, lo:hi], v_c)
        g_own = kref.ftz_add(g_own, sent)
        g_sum = _server_add(g_sum, sent.view(m_dev, rows, cols))
        lo = hi
    shape = (m_dev, rows, cols)
    return _leaf_result(g_sum, u.view(shape), g_own.view(shape))


# ---------------------------------------------------------------------------
# the LGC train step
# ---------------------------------------------------------------------------

def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def split_compress_rows(e: torch.Tensor, delta: torch.Tensor,
                        cum_ks: torch.Tensor, received: torch.Tensor, mesh,
                        kernels: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """Histogram-LGC of a leaf split over the model group, on this rank's
    (M, n / P) rows of it: the rows' maxima of the shard and a MAX over
    the ranks (on the maxima's bits: |u| has its sign bit clear, so the
    bits order as the values, a NaN above +inf as the unsharded maximum
    takes it), the shard's 256-bin counts under those maxima and a SUM,
    the thresholds from ``cum_ks`` of the WHOLE leaf, then the shard's
    (g, e_new).  ``kernels``: through the maxabs, histogram and
    sparsify_ef row kernels, else their plain versions; bitwise the
    rank's block of :func:`kernels.lgc_compress_hist_rows` of the whole
    leaf either way."""
    e = e.to(torch.float32).contiguous()
    delta = delta.to(torch.float32).contiguous()
    if kernels:
        u, mx = sum_maxabs_rows(e, delta)
    else:
        u = kref.ftz_add(e, delta)
        mx = kref.hist_maxabs_rows(u)
    mx = parallel.all_reduce_max(mesh, mx.view(torch.int32)).view(
        torch.float32)
    counts = histogram_rows(u, mx) if kernels else kref.hist_counts_rows(
        u, mx)
    counts = parallel.all_reduce_sum(mesh, counts)
    thr = thresholds_from_counts(counts, mx, cum_ks)
    if kernels:
        return sparsify_ef_rows(e, delta, thr, received)
    return kref.hist_layered_sparsify_rows(u, thr, received)


def make_lgc_compress(cfg: ArchConfig, m_devices: int,
                      step_cfg: LGCStepConfig, *, rows: bool = True,
                      model_axis: Callable[[str, int], int | None]
                      | None = None, mesh=None):
    """The LGC train step's compression of one leaf (arguments as
    :func:`make_lgc_train_step`'s): returns ``compress(k, shape, e_rows,
    delta, recv) -> (g_mean (n,), e_new (M, n) f32 or None under
    FedAvg)``, for leaf ``k`` of (this rank's) ``shape``, from its f32
    error memory and net progress rows (M, n) and the (M, C) int32
    delivery masks: what the step subtracts and keeps."""
    specs = model_specs(cfg, mesh)
    if specs is not None and not rows:
        raise ValueError("rows=False (the flat kernels device by device) "
                         "takes no model axis")
    split = {k: rules.is_sharded(s, mesh.shape) for k, s in
             (specs or {}).items()}

    def whole(k: str, n: int) -> int:
        """The element count of leaf ``k``'s whole leaf from its shard's."""
        return n * mesh.model_size if split.get(k) else n

    wire_dt = _dtype(step_cfg.psum_dtype)
    cum_ks_cache: dict = {}

    def cum_ks_for(n: int, device) -> torch.Tensor:
        key = (n, str(device))
        if key not in cum_ks_cache:
            cum_ks_cache[key] = _leaf_cum_ks(n, step_cfg.sparsity, device)
        return cum_ks_cache[key]

    def compress_leaf(k: str, e: torch.Tensor, delta: torch.Tensor,
                      received: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
        """(g, e_new) of one leaf over the M device rows, (M, n) each."""
        n = whole(k, delta.shape[1])
        cum_ks = cum_ks_for(n, delta.device)
        kernel = (step_cfg.backend in ("cuda", "pallas")
                  and n >= step_cfg.pallas_min_elems)
        if split.get(k):
            return split_compress_rows(e, delta,
                                       cum_ks.expand(m_devices, -1),
                                       received, mesh, kernel)
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

    def compress_sparse(path: str, shape, e: torch.Tensor,
                        delta: torch.Tensor, received: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
        """(g_mean (n,), e_new (M, n)) of one leaf under a sparse
        aggregate, selected along rows of the dim ``model_axis`` names,
        or over the whole leaf.  A split leaf whose selection rows are
        not along its model dim is gathered, compressed whole and cut
        back to this rank's block."""
        ax = model_axis(path, len(shape)) if model_axis else None
        if split.get(path) and ax != rules.model_dim(specs[path]):
            spec, ef_spec = specs[path], (None, *specs[path])
            full = list(shape)
            full[rules.model_dim(spec)] *= mesh.model_size
            e_full, d_full = (parallel.gather_model(
                mesh, t.reshape(m_devices, *shape), ef_spec).reshape(
                    m_devices, -1) for t in (e, delta))
            g_mean, e_new = compress_sparse_whole(
                path, tuple(full), e_full, d_full, received, math.prod(full))
            return (rules.shard(g_mean.reshape(full), spec,
                                mesh).reshape(-1),
                    rules.shard(e_new.reshape(m_devices, *full), ef_spec,
                                mesh).reshape(m_devices, -1))
        return compress_sparse_whole(path, shape, e, delta, received,
                                     whole(path, math.prod(shape)))

    def compress_sparse_whole(path: str, shape, e: torch.Tensor,
                              delta: torch.Tensor, received: torch.Tensor,
                              leaf_n: int
                              ) -> tuple[torch.Tensor, torch.Tensor]:
        ax = model_axis(path, len(shape)) if model_axis else None
        lead = shape[ax] if ax is not None else 1
        rest = [d for i, d in enumerate(shape) if i != ax]

        def to_rows(t):                   # (M, n) -> (M, lead, n / lead)
            if ax is None:
                return t.reshape(m_devices, 1, -1)
            return t.reshape(m_devices, *shape).movedim(ax + 1, 1).reshape(
                m_devices, lead, -1)

        def from_rows(t, dev_dim: int):  # back to (n,) or (M, n)
            if ax is None:
                return t.reshape(*t.shape[:dev_dim], -1)
            t = t.reshape(*t.shape[:dev_dim], lead, *rest)
            return t.movedim(dev_dim, dev_dim + ax).reshape(
                *t.shape[:dev_dim], -1)

        e, delta = to_rows(e), to_rows(delta)
        if step_cfg.aggregate == "bucket_sparse":
            g_mean, e_new = _compress_leaf_bucket(e, delta,
                                                  step_cfg.sparsity, received)
        else:
            n = delta.shape[-1]
            kernel = (step_cfg.backend in ("cuda", "pallas")
                      and leaf_n >= step_cfg.pallas_min_elems)
            g_mean, e_new = _compress_leaf_sparse(
                e, delta, step_cfg.sparsity, received, kernels=kernel,
                cum_ks=cum_ks_for(n, delta.device))
        return from_rows(g_mean, 0), from_rows(e_new, 1)

    def compress(k: str, shape: tuple, e_rows: torch.Tensor,
                 delta: torch.Tensor, recv: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor | None]:
        if step_cfg.aggregate in ("sparse_gather", "bucket_sparse"):
            return compress_sparse(k, shape, e_rows, delta, recv)
        e_new = None
        if step_cfg.aggregate == "none":                # FedAvg baseline
            g_wire = delta
        else:                                           # dense_masked
            g, e_new = compress_leaf(k, e_rows, delta, recv)
            g_wire = g.to(wire_dt)
            # the wire rounding residue joins the error memory
            e_new = kref.ftz_add(e_new, kref.ftz_add(
                g, -g_wire.to(torch.float32)))
        # Alg. 1 lines 20-21: w - mean_m g_m, summed device by device
        g_sum = g_wire[0]
        for m in range(1, m_devices):
            g_sum = g_sum + g_wire[m]
        return kref.ftz(kref.div_f32(g_sum, m_devices).to(torch.float32)), \
            e_new

    return compress


def make_lgc_train_step(cfg: ArchConfig, m_devices: int,
                        step_cfg: LGCStepConfig, *, rows: bool = True,
                        model_axis: Callable[[str, int], int | None]
                        | None = None, donate: bool = False, mesh=None):
    """Algorithm 1: returns ``f(params, ef, batch, received=None) ->
    (params, ef, loss)``.

    ``batch`` holds ``tokens`` and ``labels`` of shape (M * b, S), and a
    modality ``prefix`` (M * b, P, ...) where the arch takes one; device m
    takes rows [m*b, (m+1)*b) of every leaf, split into H microbatches, as
    the reference's ``P(fl_axis)`` batch spec gives it.  ``ef`` is the stacked
    ``(M, *leaf)`` error memory (:func:`init_ef_tree`); row m is device m's
    residual.  ``received`` ((M, C) int, ``None`` = all delivered) is the
    per-device per-channel delivery mask; FedAvg (``"none"``) ignores it.
    The step is functional: it returns new params and error memory.

    ``rows=False`` compresses each device's leaves with the flat kernels
    one device after another: the same bits in M times the launches, kept
    only to hold the row path against (``dense_masked``; the sparse modes
    always take the rows).

    ``model_axis`` is the counterpart of the reference's
    ``param_spec_tree``: a rule ``(path, ndim) -> dim or None`` naming the
    dim along whose rows the sparse modes select (the 100M task passes
    :func:`leaf_model_axis`).  ``None``, the default as in the reference,
    selects over each leaf as one row.

    ``donate=True`` is the reference driver's ``donate_argnums=(0, 1)``: the
    step empties the ``params`` and ``ef`` dicts it is given, leaf by leaf
    as their successors are made, so that the old and the new state are
    not all held at once (phi-3-vision's 3.8B parameters and their f32
    error memory fill most of a card); the caller keeps only the returned
    state.

    ``mesh`` with a model axis P > 1: ``params`` hold this rank's shards
    and ``ef`` its (M, *shard) rows, the batch is whole on every rank,
    and every rank returns the same loss (module docstring).  Kernel
    routing and budgets read each leaf's WHOLE size.
    """
    h, n_ch, lr = step_cfg.local_steps, step_cfg.n_channels, step_cfg.local_lr
    ef_dt = _dtype(step_cfg.ef_dtype)
    compress = make_lgc_compress(cfg, m_devices, step_cfg, rows=rows,
                                 model_axis=model_axis, mesh=mesh)

    def local_sgd(params, batch):
        """H plain SGD steps from ``params`` on the H microbatches of the
        device's ``batch``; returns (params_H, loss_sum)."""
        names = list(params)
        p = params
        loss_sum = torch.zeros((), dtype=torch.float32,
                               device=batch["tokens"].device)
        mb = batch["tokens"].shape[0] // h
        for i in range(h):
            leaves = [p[k].detach().requires_grad_(True) for k in names]
            with torch.enable_grad():
                loss = tf.lm_loss(dict(zip(names, leaves)), cfg,
                                  _rows_of(batch, slice(i * mb,
                                                        (i + 1) * mb)),
                                  mesh=mesh)
                grads = tf.sum_split_use_grads(
                    cfg, dict(zip(names, torch.autograd.grad(loss, leaves))),
                    mesh)
            with torch.no_grad():
                p = {k: sgd_update(w.to(torch.float32),
                                   grads[k].to(torch.float32), lr).to(w.dtype)
                     for k, w in zip(names, leaves)}
                loss_sum = loss_sum + loss.detach()
        return p, loss_sum

    @torch.no_grad()
    def step(params, ef, batch, received=None):
        device = batch["tokens"].device
        b_all = batch["tokens"].shape[0]
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

        # ---- H local SGD steps per device; the (M, n) f32 net progress,
        # allocated once the first device's activations are freed --------
        deltas: dict = {}
        loss_total = torch.zeros((), dtype=torch.float32, device=device)
        for m in range(m_devices):
            p_end, loss_sum = local_sgd(
                params, _rows_of(batch, slice(m * b_local,
                                              (m + 1) * b_local)))
            loss_total = loss_total + loss_sum / h
            for k, w0 in params.items():
                if m == 0:
                    deltas[k] = torch.empty((m_devices, w0.numel()),
                                            dtype=torch.float32,
                                            device=device)
                torch.sub(w0.to(torch.float32).reshape(-1),
                          p_end[k].to(torch.float32).reshape(-1),
                          out=deltas[k][m])
                deltas[k][m] = kref.ftz(deltas[k][m])
            del p_end

        # ---- compression with EF over the M rows, server update ---------
        params_new, ef_new = {}, {}
        for k in list(params):
            w, delta = (params.pop(k) if donate else params[k]), deltas.pop(k)
            e_old = ef.pop(k) if donate else ef[k]
            e_rows = e_old.reshape(m_devices, -1).to(torch.float32)
            g_mean, e_new = compress(k, tuple(w.shape), e_rows, delta, recv)
            if e_new is None:                           # FedAvg: no EF
                ef_new[k] = e_old if donate else e_old.clone()
            else:
                ef_new[k] = e_new.to(ef_dt).reshape(e_old.shape)
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
                      device: str | torch.device | None = None, mesh=None):
    """``f(params, batch) -> (logits (B,Vp), cache)`` on ``device`` (None
    means the card, or ``mesh.device`` under a mesh); the prompt tokens,
    and the modality prefix where the batch has one, are moved there.
    ``mesh`` with a model axis P > 1: ``params`` are this rank's shards
    (``sharding_rules.param_specs``) and the cache this rank's block
    (``cache_specs``), see :func:`transformer.prefill`."""
    dev = resolve_device(device if device is not None or mesh is None
                         else mesh.device)
    tf.model_axis_mesh(cfg, mesh)

    @torch.inference_mode()
    def prefill_step(params, batch):
        batch = {k: v.to(dev) if k in ("tokens", "prefix") else v
                 for k, v in batch.items()}
        return tf.prefill(params, cfg, batch, cache_len, mesh=mesh)
    return prefill_step


def make_serve_step(cfg: ArchConfig, window: int = 0, *,
                    device: str | torch.device | None = None,
                    return_logits: bool = False, mesh=None):
    """``f(params, token (B,1), cache) -> (next_token (B,1) int32, cache)``:
    one greedy decode step on ``device`` (None means the card, or
    ``mesh.device`` under a mesh).  The cache is updated in place.  With
    ``return_logits`` the step also returns the step's (B,Vp) f32 logits.
    ``mesh`` with a model axis P > 1: this rank's params and cache, as
    :func:`make_prefill_step`; every rank takes the same token."""
    dev = resolve_device(device if device is not None or mesh is None
                         else mesh.device)
    tf.model_axis_mesh(cfg, mesh)

    @torch.inference_mode()
    def serve_step(params, token, cache):
        logits, cache = tf.decode_step(params, cfg, token.to(dev), cache,
                                       window=window, mesh=mesh)
        next_token = torch.argmax(logits, -1).to(torch.int32)[:, None]
        if return_logits:
            return next_token, cache, logits
        return next_token, cache
    return serve_step
