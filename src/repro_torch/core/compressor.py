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
over (M, D) rows.  The per-layer budgets (reference :225-411) wait for
ROADMAP A8.
"""
from __future__ import annotations

from typing import Sequence

import torch

from . import prng

#: flat leaves at least this large take the CUDA kernels when the backend is
#: ``"cuda"``; smaller leaves take the plain torch path
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
    d = u.shape[1]
    vals = torch.topk(a, min(k_cap, d), dim=1).values       # descending |u|
    cum = torch.cumsum(ks, 1)

    def rank_below(b: torch.Tensor) -> torch.Tensor:
        """{i : rank(|u_i|) < b} per row, b (M,)."""
        bc = b.clamp(1, vals.shape[1])
        thr = vals.gather(1, (bc - 1)[:, None])             # b-th largest
        gt = a > thr
        eq = a == thr
        tied_take = bc - gt.sum(1)                          # ties to include
        pos = torch.cumsum(eq, 1)                           # 1-based order
        sel = gt | (eq & (pos <= tied_take[:, None]))
        sel = sel & (b > 0)[:, None]
        return sel | (b >= d)[:, None]

    g = torch.zeros_like(u)
    prev = torch.zeros_like(a, dtype=torch.bool)
    for c in range(ks.shape[1]):
        cur = rank_below(cum[:, c])
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
    return q.to(torch.float32) * (scale / half)
