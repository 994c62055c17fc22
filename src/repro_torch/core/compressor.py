"""LGC compressors (paper §2.1): the rank-exact oracle, QSGD and the
flat-vector helpers.

Port of ``repro/core/compressor.py:41-131`` and ``:439-511``:

* ``tree_size`` / ``flatten_tree`` / ``unflatten_like`` over the port's
  flat ``{path: Tensor}`` parameter dicts.  Leaves go in sorted-path order,
  the order ``jax.tree_util.tree_leaves`` gives a nested dict (for the CNN:
  ``b1, b2, bw1, bw2, c1, c2, w1, w2``), so the flat vectors line up with
  the reference's coordinate for coordinate.
* ``top_k``, ``lgc_layers``, ``lgc_compress`` -- layer c keeps the
  coordinates whose |x| rank lies in [K_{c-1}, K_c).  Ranks come from a
  stable argsort of -|x| (``jnp.argsort``'s tie rule), so ties go to the
  lower index and the layers are exactly disjoint.
* ``LGCCompressor``, ``wire_bytes``, ``qsgd_quantize`` /
  ``qsgd_dequantize`` (QSGD dither from the ported threefry ``uniform``).

Everything runs on the tensors' own device and is bitwise equal to the
reference on the same inputs (tests/test_torch_sim_core.py).  The
histogram-threshold selection that the CUDA kernels compute lives in
:mod:`repro_torch.kernels`.  The batched engine's exact backend,
``lgc_compress_traced`` and the argsort-free ``lgc_compress_topk``
(reference :132-196), takes budgets and delivery masks as (M, C) tensors
over (M, D) rows.  The per-layer budgets (reference :198-411:
``tree_layer_slices``, ``layer_budgets`` under ``LAYER_POLICIES``,
``per_layer_candidates``, ``per_layer_compress``, ``per_layer_wire_bytes``)
take one row or (M, D) rows; their histogram path, through the segmented
kernels, is :func:`repro_torch.kernels.per_layer_candidates_hist_rows`.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch

from repro_torch.kernels.ref import div_f32, ftz
from repro_torch.kernels.topk_threshold import SegmentTable

from . import prng

#: flat leaves at least this large take the CUDA kernels on the 100M step
#: when the backend is ``"cuda"``; smaller leaves take the plain torch path.
#: The simulator's per-layer path sends every slice through the segmented
#: kernels: the reference's routing at this size never changes the result
PALLAS_MIN_ELEMS = 100_000


# ---------------------------------------------------------------------------
# flat parameter dicts <-> flat vectors
# ---------------------------------------------------------------------------

def _leaf_order(tree: dict[str, torch.Tensor]) -> list[str]:
    """Leaf paths in the order of the nested dict's sorted keys."""
    return sorted(tree, key=lambda path: path.split("/"))


def tree_size(tree: dict[str, torch.Tensor]) -> int:
    """Total number of scalar parameters."""
    return sum(int(v.numel()) for v in tree.values())


def flatten_tree(tree: dict[str, torch.Tensor]) -> torch.Tensor:
    """Concatenate all leaves into one flat f32 vector (sorted-path order)."""
    return torch.cat([tree[k].reshape(-1).to(torch.float32)
                      for k in _leaf_order(tree)])


def unflatten_like(flat: torch.Tensor, tree: dict[str, torch.Tensor]
                   ) -> dict[str, torch.Tensor]:
    """Inverse of :func:`flatten_tree` against a reference dict."""
    out, off = {}, 0
    for k in _leaf_order(tree):
        leaf = tree[k]
        n = int(leaf.numel())
        out[k] = flat[off:off + n].reshape(leaf.shape).to(leaf.dtype)
        off += n
    return out


# ---------------------------------------------------------------------------
# rank-exact compressors (paper semantics)
# ---------------------------------------------------------------------------

def _rank_of(x: torch.Tensor) -> torch.Tensor:
    """rank[i] = 0-based rank of |x_i| among all coordinates (0 = largest),
    ties broken by index (stable argsort)."""
    order = torch.argsort(-torch.abs(x), stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(x.shape[0], device=x.device)
    return rank


def top_k(x: torch.Tensor, k: int) -> torch.Tensor:
    """Keep the k largest-|.| coordinates of x, zero the rest."""
    if k <= 0:
        return torch.zeros_like(x)
    if k >= x.shape[0]:
        return x
    return torch.where(_rank_of(x) < k, x, torch.zeros_like(x))


def lgc_layers(x: torch.Tensor, ks: Sequence[int]) -> list[torch.Tensor]:
    """Split x into C disjoint layers; layer c keeps ranks [K_{c-1}, K_c).
    sum(layers) == top_k(x, sum(ks))."""
    rank = _rank_of(x)
    zero = torch.zeros_like(x)
    layers, lo = [], 0
    for k in ks:
        hi = lo + int(k)
        layers.append(torch.where((rank >= lo) & (rank < hi), x, zero))
        lo = hi
    return layers


def lgc_compress(x: torch.Tensor, ks: Sequence[int],
                 received: Sequence[bool] | None = None) -> torch.Tensor:
    """LGC_k(x) (paper Eq. (2)): the sum of the layers that arrived,
    starting from +0.0 and adding each layer or zeros, as the reference."""
    layers = lgc_layers(x, ks)
    if received is None:
        received = [True] * len(layers)
    out = torch.zeros_like(x)
    for layer, ok in zip(layers, received):
        out = out + (layer if ok else torch.zeros_like(layer))
    return out


# ---------------------------------------------------------------------------
# traced budgets on (M, D) rows: the batched engine's exact backend
# ---------------------------------------------------------------------------

def _as_rows(u: torch.Tensor, ks: torch.Tensor, received: torch.Tensor):
    flat = u.dim() == 1
    if flat:
        u, ks, received = u[None], ks[None], received[None]
    return flat, u, ks.to(torch.int64), received.to(torch.bool)


def lgc_compress_traced(u: torch.Tensor, ks: torch.Tensor,
                        received: torch.Tensor) -> torch.Tensor:
    """LGC_k of each row of u (M, D) with per-row budgets ``ks`` (M, C) and
    delivery masks ``received`` (M, C), as tensors (reference
    ``compressor.py:174``): the rank semantics of :func:`lgc_compress`
    (stable argsort of -|u|, ties to the lower index).  A flat u with (C,)
    budgets is one row."""
    flat, u, ks, received = _as_rows(u, ks, received)
    order = torch.argsort(-torch.abs(u), dim=1, stable=True)
    rank = torch.empty_like(order)
    rank.scatter_(1, order, torch.arange(u.shape[1], device=u.device)
                  .expand_as(order))
    cum = torch.cat([torch.zeros_like(ks[:, :1]), torch.cumsum(ks, 1)], 1)
    g = torch.zeros_like(u)
    for c in range(ks.shape[1]):
        sel = ((rank >= cum[:, c:c + 1]) & (rank < cum[:, c + 1:c + 2])
               & received[:, c:c + 1])
        g = g + torch.where(sel, u, torch.zeros_like(u))
    return g[0] if flat else g


def _rank_below(a: torch.Tensor, vals: torch.Tensor, b: torch.Tensor
                ) -> torch.Tensor:
    """{i : rank(a_i) < b} on each row of a (M, n), ties to the lower
    index (the stable-argsort rank), from the row's largest values ``vals``
    (M, k), descending, with k >= min(b, n); b (M,)."""
    bc = b.clamp(1, vals.shape[1])
    thr = vals.gather(1, (bc - 1)[:, None])                 # b-th largest
    gt = a > thr
    eq = a == thr
    tied_take = bc - gt.sum(1)                              # ties to include
    pos = torch.cumsum(eq, 1)                               # 1-based order
    sel = gt | (eq & (pos <= tied_take[:, None]))
    sel = sel & (b > 0)[:, None]
    return sel | (b >= a.shape[1])[:, None]


def lgc_compress_topk(u: torch.Tensor, ks: torch.Tensor,
                      received: torch.Tensor, k_cap: int) -> torch.Tensor:
    """:func:`lgc_compress_traced` without the full argsort (reference
    ``compressor.py:132``): layer boundaries by threshold, the b-th largest
    |u| of ``torch.topk``, with an index-order cumsum to split ties, which
    keeps the stable-argsort ranks on every coordinate that matters
    (coordinates with u == 0 may change layer but add 0 either way).  So
    each row is bitwise :func:`lgc_compress` of that row.

    ``k_cap`` is a bound with k_cap >= min(max(cumsum(ks)), D); the
    selection does not depend on it above that bound."""
    flat, u, ks, received = _as_rows(u, ks, received)
    a = torch.abs(u)
    vals = torch.topk(a, min(k_cap, u.shape[1]), dim=1).values  # descending
    cum = torch.cumsum(ks, 1)
    g = torch.zeros_like(u)
    prev = torch.zeros_like(a, dtype=torch.bool)
    for c in range(ks.shape[1]):
        cur = _rank_below(a, vals, cum[:, c])
        g = g + torch.where(cur & ~prev & received[:, c:c + 1], u,
                            torch.zeros_like(u))
        prev = cur
    return g[0] if flat else g


def k_cap_for(ks_total_max: int, d: int) -> int:
    """The static top-k bound of :func:`lgc_compress_topk` for a largest
    per-device budget: rounded up to a power of two, at most D (the
    reference's ``BatchedEngine._k_cap``, ``fl_batched.py:645-660``; the
    engine keeps the largest cap it has used, so the cap is monotone)."""
    k_max = max(1, int(ks_total_max))
    return min(d, 1 << (k_max - 1).bit_length())


# ---------------------------------------------------------------------------
# per-model-layer budgets (structure-aware compression)
# ---------------------------------------------------------------------------
#
# The round's budget k_total is first shared out over the MODEL layers (the
# parameter leaves) under a policy, the top-b_l coordinates of each layer
# are the candidates, and only then do the candidates go through the
# unchanged channel layering (reference compressor.py:198-224).  Each
# function takes one flat row or (M, D) rows (the reference vmaps them,
# fl_batched.py:186-203), and the slices as a
# :class:`~repro_torch.kernels.topk_threshold.SegmentTable` (``layer_table``
# of ``tree_layer_slices``) built once on the rows' device, so nothing goes
# to the card inside a sync.

def tree_layer_slices(tree: dict[str, torch.Tensor],
                      skip_leading_axes: int = 0
                      ) -> list[tuple[str, int, int]]:
    """``(name, lo, hi)`` half-open slices of each leaf inside the
    :func:`flatten_tree` vector, in its sorted-path order, named as
    ``jax.tree_util.keystr`` names the nested dict's paths (``['c']['w']``).

    ``skip_leading_axes=1`` treats the leaves as stacked per-device state
    ((M, ...) tensors) and describes the per-device flat vector."""
    out, lo = [], 0
    for path in _leaf_order(tree):
        n = math.prod(tuple(tree[path].shape)[skip_leading_axes:])
        name = "".join(f"[{part!r}]" for part in path.split("/"))
        out.append((name, lo, lo + n))
        lo += n
    return out


def layer_table(slices: Sequence[tuple[str, int, int]],
                device: str | torch.device) -> SegmentTable:
    """``slices`` (``(name, lo, hi)`` tuples that tile the flat vector from
    0) as a table on ``device``."""
    edges = [0]
    for _, lo, hi in slices:
        if lo != edges[-1]:
            raise ValueError(f"slices must tile the vector from 0: {slices}")
        edges.append(hi)
    return SegmentTable(edges, device)


def _per_row(b, rows: int, device: torch.device) -> torch.Tensor:
    """A scalar or (M,) count as (M,) int64."""
    b = torch.as_tensor(b, device=device).to(torch.int64).reshape(-1)
    return b.expand(rows) if b.numel() == 1 else b


def _topb_mask(a: torch.Tensor, b, k_cap: int) -> torch.Tensor:
    """Mask of the ``b`` largest entries of each row of ``a`` (absolute
    values already taken; (n,) or (M, n)), ties to the lower index -- the
    stable-rank semantics of :func:`lgc_compress_topk` (reference
    compressor.py:258).  ``b`` a count or (M,) counts, at most ``k_cap``."""
    flat = a.dim() == 1
    rows = a[None] if flat else a
    vals = torch.topk(rows, min(k_cap, rows.shape[1]), dim=1).values
    sel = _rank_below(rows, vals, _per_row(b, rows.shape[0], a.device))
    return sel[0] if flat else sel


def _largest_remainder(weights: torch.Tensor, sizes: torch.Tensor,
                       k_total) -> torch.Tensor:
    """Apportion ``k_total`` coordinates over the layers in proportion to
    ``weights`` ((L,) or (M, L)) by largest-remainder rounding, capped at
    the layer ``sizes`` (reference compressor.py:277), in f32: quotas
    k * w / sum(w) (by size where sum(w) is 0), their floors, and one more
    to each of the ``k_total - sum(floors)`` layers with the largest
    remainders and room left, ties to the lower layer (stable argsort).
    Returns int32 of weights' shape."""
    flat = weights.dim() == 1
    w = torch.clamp_min(weights.to(torch.float32), 0.0)
    if flat:
        w = w[None]
    k = _per_row(k_total, w.shape[0], w.device)[:, None]
    kf = k.to(torch.float32)
    sizes = sizes.to(torch.int32)
    sf = sizes.to(torch.float32)
    tot = w.sum(1, keepdim=True)
    pos = tot > 0
    quota = torch.where(pos, kf * w / torch.where(pos, tot, 1.0),
                        kf * sf / sf.sum())
    fl = torch.floor(quota)
    base = torch.minimum(fl.to(torch.int32), sizes)
    rem = k - base.sum(1, keepdim=True)
    headroom = (sizes - base) > 0
    key = -torch.where(headroom, quota - fl, -1.0)
    order = torch.argsort(key, dim=1, stable=True)
    rank = torch.empty_like(order).scatter_(
        1, order, torch.arange(order.shape[1], device=w.device)
        .expand_as(order))
    out = base + ((rank < rem) & headroom).to(torch.int32)
    return out[0] if flat else out


def layer_budgets(policy: str, u: torch.Tensor, seg: SegmentTable,
                  k_total, k_cap: int) -> torch.Tensor:
    """Per-model-layer coordinate budgets under ``policy`` (reference
    compressor.py:303): (L,) int32 for a flat u, (M, L) for rows.

    * ``"uniform"``: the per-layer hit counts of the global top-``k_total``,
      so the compression is bitwise the global path's;
    * ``"size_prop"``: in proportion to the layer sizes;
    * ``"divergence"``: in proportion to each layer's update mass
      ||u_l||_2 (its squares flushed as the reference's, summed in f32).
    """
    flat = u.dim() == 1
    rows = u[None] if flat else u
    edges = seg.spans
    if policy == "uniform":
        mask = _topb_mask(rows.abs(), k_total, k_cap)
        b = torch.stack([mask[:, lo:hi].sum(1, dtype=torch.int32)
                         for lo, hi in edges], 1)
    elif policy == "size_prop":
        b = _largest_remainder(
            seg.sizes.to(torch.float32).expand(rows.shape[0], -1),
            seg.sizes, k_total)
    elif policy == "divergence":
        norms = torch.stack(
            [torch.sqrt(torch.sum(ftz(rows[:, lo:hi] * rows[:, lo:hi]), 1))
             for lo, hi in edges], 1)
        b = _largest_remainder(norms, seg.sizes, k_total)
    else:
        raise ValueError(f"unknown layer policy {policy!r}; registered: "
                         f"{sorted(LAYER_POLICIES)}")
    return b[0] if flat else b


#: registry of per-model-layer budget policies (see :func:`layer_budgets`)
LAYER_POLICIES: dict[str, str] = {
    "uniform": "global magnitude threshold (bit-equal to global top-k)",
    "size_prop": "budgets proportional to layer size",
    "divergence": "budgets proportional to layer update mass ||u_l||_2",
}


def per_layer_candidates(u: torch.Tensor, seg: SegmentTable,
                         budgets: torch.Tensor, k_cap: int) -> torch.Tensor:
    """Candidate mask: the top-``budgets[l]`` |u| inside each layer slice,
    ties to the lower index within the layer (reference
    compressor.py:332).  Masks of different layers are disjoint."""
    flat = u.dim() == 1
    rows, b = (u[None], budgets[None]) if flat else (u, budgets)
    a = rows.abs()
    mask = torch.cat([_topb_mask(a[:, lo:hi], b[:, i], min(k_cap, hi - lo))
                      for i, (lo, hi) in enumerate(seg.spans)], 1)
    return mask[0] if flat else mask


def per_layer_compress(u: torch.Tensor, ks: torch.Tensor,
                       received: torch.Tensor, seg: SegmentTable,
                       policy: str, k_cap: int) -> torch.Tensor:
    """Structure-aware LGC (reference compressor.py:378): per-layer budgets,
    the per-layer candidate mask, then :func:`lgc_compress_topk` over the
    masked u.  Under ``"uniform"`` the candidates are the global
    top-k_total, so this is bitwise ``lgc_compress_topk(u, ...)``."""
    flat, rows, ks, received = _as_rows(u, ks, received)
    k_total = ks.sum(1)
    if policy == "uniform":
        mask = _topb_mask(rows.abs(), k_total, k_cap)
    else:
        budgets = layer_budgets(policy, rows, seg, k_total, k_cap)
        mask = per_layer_candidates(rows, seg, budgets, k_cap)
    g = lgc_compress_topk(torch.where(mask, rows, torch.zeros_like(rows)),
                          ks, received, k_cap)
    return g[0] if flat else g


def per_layer_wire_bytes(budgets: Sequence[int],
                         slices: Sequence[tuple[str, int, int]],
                         value_bytes: int = 4) -> int:
    """Bytes on the wire of the per-layer sparse format: layer-local indices
    of ceil(log2(layer size)) bits, in whole bytes (reference
    compressor.py:398)."""
    total = 0
    for b, (_, lo, hi) in zip(budgets, slices):
        idx_bytes = max(1, -(-max(hi - lo, 2).bit_length() // 8))
        total += int(b) * (value_bytes + idx_bytes)
    return total


def wire_bytes(ks: Sequence[int], value_bytes: int = 4,
               index_bytes: int = 4) -> list[int]:
    """Bytes on the wire per channel for the sparse format."""
    return [int(k) * (value_bytes + index_bytes) for k in ks]


class LGCCompressor:
    """Stateless layered compressor bound to layer budgets ``ks``."""

    def __init__(self, ks: Sequence[int]):
        self.ks = [int(k) for k in ks]

    def __call__(self, u: torch.Tensor,
                 received: Sequence[bool] | None = None) -> torch.Tensor:
        return lgc_compress(u, self.ks, received)


# ---------------------------------------------------------------------------
# QSGD quantization (composes with LGC under error feedback)
# ---------------------------------------------------------------------------

def qsgd_quantize(x: torch.Tensor, key: torch.Tensor, levels: int = 255
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Unbiased stochastic quantization: (int32 codes in [-levels // 2,
    levels // 2], f32 scale).  The dither is ``uniform(key, x.shape)``
    drawn on x's device."""
    scale = torch.amax(torch.abs(x)) + 1e-30
    half = levels // 2
    y = x / scale * half
    lo = torch.floor(y)
    p = y - lo                                 # P(round up)
    up = prng.uniform(key, tuple(x.shape), device=x.device) < p
    q = (lo + up.to(torch.float32)).to(torch.int32)
    return torch.clamp(q, -half, half), scale


def qsgd_quantize_rows(x: torch.Tensor, keys: torch.Tensor,
                       levels: int = 255
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`qsgd_quantize` of each row of x (S, D) with its key of
    ``keys`` (S, 2): codes (S, D) and scales (S, 1)."""
    scale = torch.amax(torch.abs(x), 1, keepdim=True) + 1e-30
    half = levels // 2
    y = x / scale * half
    lo = torch.floor(y)
    p = y - lo
    up = prng.uniform_rows(keys, x.shape[1]) < p
    q = (lo + up.to(torch.float32)).to(torch.int32)
    return torch.clamp(q, -half, half), scale


def qsgd_dequantize(q: torch.Tensor, scale: torch.Tensor,
                    levels: int = 255) -> torch.Tensor:
    half = levels // 2
    return q.to(torch.float32) * div_f32(scale, half)
