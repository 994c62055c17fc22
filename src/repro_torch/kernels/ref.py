"""Plain torch versions of the histogram-LGC kernels.

Port of ``repro/kernels/ref.py:28-90`` (the ``hist_*`` oracles).  Each is the
plain version of a CUDA kernel in this package: the wrappers call it for CPU
tensors, and ``chip_smoke.py`` holds each kernel bitwise against it on the
card.  The same IEEE f32 operations in the same order as the reference, so
results are bit-identical to the JAX oracles (tests/test_torch_kernels.py).
Everything stays on the tensor's device: no ``.item()``, no host sync.

``swa_decode_ref`` waits for its kernel (ROADMAP B4).
"""
from __future__ import annotations

import torch

N_BINS = 256


def hist_maxabs(x: torch.Tensor) -> torch.Tensor:
    """max |x| as a 0-dim f32 tensor."""
    return x.abs().max().to(torch.float32)


def hist_counts(x: torch.Tensor, maxabs: torch.Tensor) -> torch.Tensor:
    """256-bin histogram of |x| over [0, maxabs]; bin 255 holds the largest.

    bin = clip(int32(|x| * (256 / maxabs)), 0, 255), with 256 / maxabs an
    IEEE-rounded f32 division (0 when maxabs == 0).  Returns (256,) int32.
    """
    a = x.abs().to(torch.float32).reshape(-1)
    m = maxabs.reshape(()).to(torch.float32)
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
    bin_w = maxabs.reshape(()).to(torch.float32) / N_BINS
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
    at +0.0 and adds u or +0.0 once per layer, as the reference does.
    """
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
    """The whole histogram-LGC pipeline on flat vectors: u = e + delta,
    thresholds from the histogram of |u|, g = the received layers,
    e_new = u - g."""
    u = (e + delta).to(torch.float32)
    m = hist_maxabs(u)
    counts = hist_counts(u, m)
    thr = hist_thresholds(counts, m, cum_ks)
    return hist_layered_sparsify(u, thr, received)
