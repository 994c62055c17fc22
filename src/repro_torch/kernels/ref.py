"""Plain torch versions of the port's kernels.

Port of ``repro/kernels/ref.py:28-90`` (the ``hist_*`` oracles) and of the
function the Pallas ``swa_decode`` kernel computes.  Each is the plain
version of a CUDA kernel in this package: the wrappers call it for CPU
tensors, and ``chip_smoke.py`` holds each kernel against it on the card.
The ``hist_*`` functions take the same IEEE f32 operations in the same order
as the reference, so they are bit-identical to the JAX oracles
(tests/test_torch_kernels.py); ``swa_decode_ref`` agrees with the Pallas
kernel to f32 rounding (tests/test_torch_swa.py).  ``merge_decode_partials``
merges the partial states of ``swa_decode``'s shards over ranks (decode
attention under the model axis); it is a few elementwise ops, not a
kernel.  Everything stays on the tensor's device: no ``.item()``, no host
sync.

Subnormals.  Both platforms of the reference flush f32 subnormals: XLA:CPU
runs with FTZ and DAZ (an arithmetic op reads a subnormal input as a zero of
its sign and writes a subnormal result as a zero of its sign), and the TPU
has no subnormals; ``abs``, ``where`` and copies keep the bits.  PyTorch
keeps subnormals on both the CPU and the card, so the ``hist_*`` functions
flush where the reference's arithmetic does: the add that forms u, the
inputs of the max, the product and the compares, and the division m / 256.

The ``*_rows`` forms take (M, D) rows, one per simulated device, as the
reference's batched engine reaches the Pallas kernels through ``jax.vmap``
(``repro/core/fl_batched.py:201-209``); they are the plain versions of the
row kernels.  The ``*_segments`` forms take every model-layer slice of
(M, D) rows, the reference's per-slice calls of the per-layer budgets;
they are the plain versions of the segmented kernels.
"""
from __future__ import annotations

import torch

N_BINS = 256
SWA_TILE = 64          # slots per K/V tile of the swa_decode kernel
_MIN_NORMAL_BITS = 0x00800000     # bits of the smallest normal f32, 2**-126
_SIGN_BIT = -0x80000000


def ftz(x: torch.Tensor) -> torch.Tensor:
    """f32 x with every subnormal replaced by a zero of its sign."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    tiny = (bits & 0x7FFFFFFF) < _MIN_NORMAL_BITS
    return torch.where(tiny, bits & _SIGN_BIT, bits).view(torch.float32)


def div_f32(x: torch.Tensor, v: float) -> torch.Tensor:
    """x / v, correctly rounded on every device.  On the card ATen divides
    by a host scalar as a multiply by its reciprocal, one rounding more
    (``x / 3.0`` there can differ from the CPU's in the last bit); a 0-dim
    divisor on x's device keeps the true division."""
    return x / torch.full((), v, dtype=x.dtype, device=x.device)


def ftz_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a + b in f32 as XLA:CPU adds under FTZ/DAZ (PTX ``add.rn.ftz.f32``).

    Exact: after the inputs are flushed, an exact sum below 2**-126 is a
    multiple of 2**-149, so the IEEE sum is exact there and flushing it
    gives the flushed hardware's result."""
    return ftz(ftz(a) + ftz(b))


def hist_maxabs(x: torch.Tensor) -> torch.Tensor:
    """max |x| as a 0-dim f32 tensor, taken on the bits of |x| as integers.

    |x| is x with the sign bit cleared.  For non-negative floats the bit
    order is the value order, so this is the max; a NaN, whose bits sit
    above +inf, comes out with its own bits (sign cleared), as jnp.max
    gives it, on every device.  (On a CUDA tensor ``abs()`` and ``max()``
    of floats return another NaN, 0x7fffffff.)  A subnormal |x| counts as
    0, as the reference's max reads it: all-subnormal input gives +0."""
    bits = x.to(torch.float32).contiguous().view(torch.int32) & 0x7FFFFFFF
    bits = torch.where(bits < _MIN_NORMAL_BITS, 0, bits)
    return bits.max().view(torch.float32)


def hist_counts(x: torch.Tensor, maxabs: torch.Tensor) -> torch.Tensor:
    """256-bin histogram of |x| over [0, maxabs]; bin 255 holds the largest.

    bin = clip(int32(|x| * (256 / maxabs)), 0, 255), with 256 / maxabs an
    IEEE-rounded f32 division (0 when maxabs == 0).  Subnormal |x| and
    maxabs read as 0 (so a subnormal |x| times an infinite scale is NaN, bin
    0).  Returns (256,) int32.
    """
    a = ftz(x.abs().reshape(-1))
    m = ftz(maxabs.reshape(()))
    scale = torch.where(m > 0, N_BINS / m, torch.zeros_like(m))
    # clamp in f32 before the truncating cast: NaN -> bin 0 and overflow ->
    # bin 255, the saturating conversion of XLA and of the CUDA kernel
    v = torch.nan_to_num(a * scale, nan=0.0).clamp_(max=N_BINS - 1)
    bins = v.to(torch.int32)
    counts = torch.zeros(N_BINS, dtype=torch.int32, device=x.device)
    return counts.index_add_(0, bins, torch.ones_like(bins))


def hist_thresholds(counts: torch.Tensor, maxabs: torch.Tensor,
                    cum_ks: torch.Tensor) -> torch.Tensor:
    """Per-layer magnitude thresholds from a histogram.

    cum_ks: (C,) cumulative budgets K_c = k_1 + ... + k_c.  thr[c] is the
    lower edge of the highest bin b with #{bin >= b} >= K_c (bin 0 when no
    bin qualifies).  Returns (C,) f32.
    """
    desc = torch.flip(torch.cumsum(torch.flip(counts, (0,)), 0), (0,))
    # m / 256 is exact unless it falls below 2**-126, where the reference
    # flushes it (also where IEEE rounding would have reached 2**-126)
    m = maxabs.reshape(()).to(torch.float32)
    bin_w = torch.where(m.abs() < 2.0 ** -118, m * 0, m / N_BINS)
    ok = desc[None, :] >= cum_ks.to(desc.dtype)[:, None]          # (C, 256)
    ids = torch.arange(N_BINS, device=counts.device)
    top = torch.where(ok, ids, torch.full_like(ids, -1)).amax(1)
    b = torch.where(ok.any(1), top, torch.zeros_like(top))
    return b.to(torch.float32) * bin_w


def hist_layered_sparsify(u: torch.Tensor, thr: torch.Tensor,
                          received: torch.Tensor
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """g = sum of the received layers, e_new = u - g.

    Layer c keeps thr[c-1] >= |u| > thr[c] with thr[-1] := +inf.  g starts
    at +0.0 and adds u or +0.0 once per layer, as the reference does.  The
    reference's compares and adds read a subnormal u or thr as a zero of
    its sign, so both are flushed first.
    """
    u = ftz(u)
    thr = ftz(thr)
    a = u.abs()
    inf = torch.full((1,), float("inf"), dtype=torch.float32, device=u.device)
    hi = torch.cat([inf, thr[:-1].to(torch.float32)])
    g = torch.zeros_like(u)
    for c in range(thr.shape[0]):
        take = (a <= hi[c]) & (a > thr[c]) & (received[c] > 0)
        g = g + torch.where(take, u, torch.zeros_like(u))
    return g, u - g


def hist_lgc_compress(e: torch.Tensor, delta: torch.Tensor,
                      cum_ks: torch.Tensor, received: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """The whole histogram-LGC pipeline on flat vectors: u = e + delta
    (flushed, :func:`ftz_add`), thresholds from the histogram of |u|, g =
    the received layers, e_new = u - g."""
    u = ftz_add(e, delta)
    m = hist_maxabs(u)
    counts = hist_counts(u, m)
    thr = hist_thresholds(counts, m, cum_ks)
    return hist_layered_sparsify(u, thr, received)


# ---------------------------------------------------------------------------
# row forms: the same functions on (M, D) rows, one row per simulated device
# (the reference's ``jax.vmap`` over the Pallas kernels); each row is
# bitwise the flat version on that row
# ---------------------------------------------------------------------------

def hist_maxabs_rows(x: torch.Tensor) -> torch.Tensor:
    """:func:`hist_maxabs` of each row of x (M, D): (M,) f32."""
    bits = x.to(torch.float32).contiguous().view(torch.int32) & 0x7FFFFFFF
    bits = torch.where(bits < _MIN_NORMAL_BITS, 0, bits)
    return bits.amax(1).view(torch.float32)


def hist_counts_rows(x: torch.Tensor, maxabs: torch.Tensor) -> torch.Tensor:
    """:func:`hist_counts` of each row of x (M, D) over [0, maxabs[r]]:
    (M, 256) int32."""
    a = ftz(x.abs())
    m = ftz(maxabs.reshape(-1, 1))
    scale = torch.where(m > 0, N_BINS / m, torch.zeros_like(m))
    v = torch.nan_to_num(a * scale, nan=0.0).clamp_(max=N_BINS - 1)
    rows = torch.arange(x.shape[0], device=x.device)[:, None] * N_BINS
    bins = (v.to(torch.int32) + rows).reshape(-1)
    counts = torch.zeros(x.shape[0] * N_BINS, dtype=torch.int32,
                         device=x.device)
    counts.index_add_(0, bins, torch.ones_like(bins, dtype=torch.int32))
    return counts.reshape(x.shape[0], N_BINS)


def hist_thresholds_rows(counts: torch.Tensor, maxabs: torch.Tensor,
                         cum_ks: torch.Tensor) -> torch.Tensor:
    """:func:`hist_thresholds` of each row: counts (M, 256), maxabs (M,),
    cum_ks (M, C) -> (M, C) f32, in torch ops with no host sync."""
    desc = torch.flip(torch.cumsum(torch.flip(counts, (1,)), 1), (1,))
    m = maxabs.reshape(-1, 1).to(torch.float32)
    bin_w = torch.where(m.abs() < 2.0 ** -118, m * 0, m / N_BINS)
    ok = desc[:, None, :] >= cum_ks.to(desc.dtype)[:, :, None]   # (M, C, 256)
    ids = torch.arange(N_BINS, device=counts.device)
    top = torch.where(ok, ids, torch.full_like(ids, -1)).amax(2)
    b = torch.where(ok.any(2), top, torch.zeros_like(top))
    return b.to(torch.float32) * bin_w


def hist_layered_sparsify_rows(u: torch.Tensor, thr: torch.Tensor,
                               received: torch.Tensor
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`hist_layered_sparsify` of each row: u (M, D), thr and
    received (M, C) -> g, e_new (M, D)."""
    u = ftz(u)
    thr = ftz(thr)
    a = u.abs()
    inf = torch.full_like(thr[:, :1], float("inf"))
    hi = torch.cat([inf, thr[:, :-1]], 1)
    g = torch.zeros_like(u)
    for c in range(thr.shape[1]):
        take = ((a <= hi[:, c:c + 1]) & (a > thr[:, c:c + 1])
                & (received[:, c:c + 1] > 0))
        g = g + torch.where(take, u, torch.zeros_like(u))
    return g, u - g


def hist_lgc_compress_rows(e: torch.Tensor, delta: torch.Tensor,
                           cum_ks: torch.Tensor, received: torch.Tensor
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`hist_lgc_compress` of each row: e, delta (M, D), cum_ks and
    received (M, C) -> g, e_new (M, D)."""
    u = ftz_add(e, delta)
    m = hist_maxabs_rows(u)
    counts = hist_counts_rows(u, m)
    thr = hist_thresholds_rows(counts, m, cum_ks)
    return hist_layered_sparsify_rows(u, thr, received)


# ---------------------------------------------------------------------------
# segmented forms: the same statistics on every model-layer slice of (M, D)
# rows (the reference's per-slice calls in ``per_layer_candidates_hist``,
# ``repro/core/compressor.py:341-375``); ``offsets`` are the L + 1 slice
# edges, from 0 to D
# ---------------------------------------------------------------------------

def _edges(offsets) -> list[tuple[int, int]]:
    offs = [int(o) for o in offsets]
    return list(zip(offs[:-1], offs[1:]))


def hist_maxabs_segments(u: torch.Tensor, offsets) -> torch.Tensor:
    """:func:`hist_maxabs` of every slice of every row of u (M, D): (M, L)
    f32."""
    return torch.stack([hist_maxabs_rows(u[:, lo:hi])
                        for lo, hi in _edges(offsets)], 1)


def hist_counts_segments(u: torch.Tensor, maxabs: torch.Tensor, offsets
                         ) -> torch.Tensor:
    """:func:`hist_counts` of every slice of every row of u (M, D), each
    against its own maximum ``maxabs[r, l]``: (M, L, 256) int32."""
    return torch.stack([hist_counts_rows(u[:, lo:hi], maxabs[:, i])
                        for i, (lo, hi) in enumerate(_edges(offsets))], 1)


def hist_candidates_segments(u: torch.Tensor, offsets, budgets: torch.Tensor
                             ) -> torch.Tensor:
    """The per-layer candidate mask of the histogram path on u (M, D) with
    budgets (M, L): each slice's threshold from its own histogram with cum =
    its budget, then |u| > thr & b > 0 coordinate by coordinate (the
    reference's ``per_layer_candidates_hist``; its compare reads a
    subnormal |u| as 0).  (M, D) bool."""
    mx = hist_maxabs_segments(u, offsets)
    counts = hist_counts_segments(u, mx, offsets)
    m, n_l = mx.shape
    thr = hist_thresholds_rows(counts.reshape(m * n_l, N_BINS),
                               mx.reshape(m * n_l),
                               budgets.reshape(m * n_l, 1)).reshape(m, n_l)
    parts = [(ftz(u[:, lo:hi].abs()) > thr[:, i:i + 1])
             & (budgets[:, i:i + 1] > 0)
             for i, (lo, hi) in enumerate(_edges(offsets))]
    return torch.cat(parts, 1)


def swa_decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   length: torch.Tensor) -> torch.Tensor:
    """One-token attention over a window cache, as the Pallas kernel
    (``repro/kernels/swa_attention.py:23-50``) computes it.

    q: (B, H, Dh); k, v: (B, Kv, W, Dh) with ``H % Kv == 0``; length: (B,)
    valid slots per row.  Query head h reads KV head ``h // (H // Kv)``
    (the order of ``_expand_kv``).  q, k and v are taken in f32, the logits
    scaled by ``1 / sqrt(f32(Dh))``, slots ``>= length`` excluded, the
    softmax and the value product in f32, and the result cast to q's dtype.
    A row with ``length == 0`` gives zeros (``acc / max(l, 1e-30)``).

    In bf16 this differs from the JAX oracle ``repro.kernels.ref.
    swa_decode_ref``, which takes the logits in q's dtype and rounds the
    softmax weights to v's dtype before the value product; in f32 the two
    agree to rounding.
    """
    return swa_decode_partial_ref(q, k, v, length)[0].to(q.dtype)


def swa_decode_partial_ref(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, length: torch.Tensor
                           ) -> tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """:func:`swa_decode_ref` before its cast, with the softmax state: the
    plain version of the ``swa_decode`` kernel's partial form.

    Returns (out (B, H, Dh) f32, m (B, H), l (B, H)): m is the max of the
    row's scaled logits over its valid slots (-inf when it has none), l
    the sum of exp(logit - m) and out = (sum exp(logit - m) v) / max(l,
    1e-30), so an empty row gives m = -inf, l = 0 and zeros.
    """
    b, h, dh = q.shape
    logits, vf, valid = _swa_logits(q, k, v, length)
    m = logits.amax(-1, keepdim=True)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(logits - m_safe).masked_fill(~valid, 0.0)
    l_sum = p.sum(-1, keepdim=True)
    out = (p @ vf) / torch.clamp_min(l_sum, 1e-30)
    return out.reshape(b, h, dh), m.reshape(b, h), l_sum.reshape(b, h)


def merge_decode_partials(outs: torch.Tensor, ms: torch.Tensor,
                          ls: torch.Tensor, dtype: torch.dtype | None = None
                          ) -> torch.Tensor:
    """Merge P partial decode-attention states, stacked in rank order, as
    the ``swa_decode`` kernel merges its splits.

    outs (P, B, H, Dh), ms and ls (P, B, H), f32, each rank's
    :func:`swa_decode_partial_ref` over its shard of the slots.  Returns
    sum_r w_r l_r out_r / max(sum_r w_r l_r, 1e-30) with w_r = exp(m_r -
    max_r m_r), a rank without valid slots (m_r = -inf) weighing 0, summed
    in rank order in f32 and cast to ``dtype`` (default f32) once.  One
    state (P = 1) is returned as it is, cast: the merge is then the
    identity on the bits.
    """
    dtype = dtype or torch.float32
    if outs.shape[0] == 1:
        return outs[0].to(dtype)
    big_m = ms.amax(0)
    empty = torch.isneginf(ms)
    w = torch.where(empty, torch.zeros_like(ms),
                    torch.exp(ms - torch.where(torch.isneginf(big_m),
                                               torch.zeros_like(big_m),
                                               big_m)))
    wl = w * ls
    num = wl[0, ..., None] * outs[0]
    den = wl[0]
    for r in range(1, outs.shape[0]):
        num = num + wl[r, ..., None] * outs[r]
        den = den + wl[r]
    return (num / torch.clamp_min(den, 1e-30)[..., None]).to(dtype)


def _swa_logits(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                length: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """f32 logits (B, Kv, rep, W), -inf at slots >= length; v in f32 with
    those slots zeroed (so they never reach the product, whatever they
    hold); the (B, 1, 1, W) mask of valid slots."""
    b, h, dh = q.shape
    kv, w = k.shape[1], k.shape[2]
    qf = q.to(torch.float32).reshape(b, kv, h // kv, dh)
    scale = 1.0 / torch.sqrt(torch.tensor(float(dh), dtype=torch.float32,
                                          device=q.device))
    logits = (qf @ k.to(torch.float32).transpose(-1, -2)) * scale
    valid = (torch.arange(w, device=q.device)[None, :]
             < length.to(q.device)[:, None])[:, None, None, :]
    vf = v.to(torch.float32).masked_fill(~valid[:, :, 0, :, None], 0.0)
    return logits.masked_fill(~valid, float("-inf")), vf, valid


def swa_split_len(w: int, splits: int) -> int:
    """Slots per split of a W-slot window cut into ``splits`` runs of whole
    tiles (the last one shorter or empty), as the swa_decode kernel cuts it."""
    tiles = -(-w // SWA_TILE)
    return SWA_TILE * -(-tiles // splits)


def swa_decode_split_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         length: torch.Tensor, splits: int) -> torch.Tensor:
    """``swa_decode_ref`` computed as the kernel partitions it, for tests.

    Split s holds slots ``[s L, (s + 1) L)`` of the window, with L =
    ``swa_split_len(W, splits)``.  Each split keeps its own f32 state: m_s,
    the max of its valid logits (-inf when it has none), l_s = sum exp(logit
    - m_s) and acc_s = sum exp(logit - m_s) v.  The states merge in split
    order: M = max_s m_s, l = sum_s l_s exp(m_s - M), acc = sum_s acc_s
    exp(m_s - M), an empty split weighing 0; out = acc / max(l, 1e-30) in
    q's dtype.
    """
    b, h, dh = q.shape
    w = k.shape[2]
    logits, vf, _ = _swa_logits(q, k, v, length)
    sl = swa_split_len(w, splits)
    states = []
    for s in range(splits):
        lo, hi = min(s * sl, w), min((s + 1) * sl, w)
        lg = logits[..., lo:hi]
        m = lg.amax(-1, keepdim=True) if hi > lo else torch.full_like(
            logits[..., :1], float("-inf"))
        m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
        p = torch.exp(lg - m_safe).masked_fill(~torch.isfinite(lg), 0.0)
        states.append((m, p.sum(-1, keepdim=True), p @ vf[:, :, lo:hi]))
    big_m = torch.stack([m for m, _, _ in states]).amax(0)
    big_m = torch.where(torch.isfinite(big_m), big_m, torch.zeros_like(big_m))
    l_sum = torch.zeros_like(big_m)
    acc = torch.zeros_like(states[0][2])
    for m, l_s, acc_s in states:
        wt = torch.where(torch.isfinite(m), torch.exp(m - big_m),
                         torch.zeros_like(m))
        l_sum = l_sum + l_s * wt
        acc = acc + acc_s * wt
    out = acc / torch.clamp_min(l_sum, 1e-30)
    return out.reshape(b, h, dh).to(q.dtype)


def threefry_normal_ref(key: torch.Tensor, shape, std: float,
                        dtype: torch.dtype, device) -> torch.Tensor:
    """``(jax.random.normal(key, shape) * std).astype(dtype)``: the plain
    version of the threefry_normal kernel, the port's bitwise draw
    (:func:`repro_torch.core.prng.normal`) scaled in f32 and cast."""
    from repro_torch.core import prng       # prng imports this module
    return (prng.normal(key, tuple(shape), device) * std).to(dtype)
