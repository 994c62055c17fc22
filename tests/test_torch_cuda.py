"""The port's CUDA kernels on the card, bitwise against their plain versions.

These tests need an NVIDIA card and ``nvcc``; without a card they skip with
a reason.  The file imports neither ``jax`` nor the reference package, so it
runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The plain versions are held bitwise to the JAX reference on the CPU by
tests/test_torch_kernels.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels as pk  # noqa: E402
from repro_torch.kernels import ref as pref  # noqa: E402

pytestmark = pytest.mark.cuda

SIZES = (63, 1000, 40_000, 1_000_003)
SPARSITY = (0.01, 0.02, 0.02, 0.05)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _vec(n: int, seed: int, scale: float, device) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.standard_t(3, n) * scale).astype(np.float32)
                            ).to(device)


def _cum_ks(n: int, c: int, device) -> torch.Tensor:
    ks = [max(1, int(n * f)) for f in SPARSITY[:c]]
    cum = np.minimum(np.cumsum(ks), n)
    return torch.tensor(cum, dtype=torch.int32, device=device)


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and torch.equal(a, b)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("offset", [0, 1])
def test_statistics_kernels_match_plain_versions(card, n, offset):
    """maxabs and histogram, on aligned and unaligned (offset) vectors."""
    x = _vec(n + offset, n, 1e-3, card)[offset:]
    m = pk.maxabs(x)
    assert _bits_equal(m, pref.hist_maxabs(x).reshape(1, 1))
    counts = pk.histogram(x, m)
    assert _bits_equal(counts, pref.hist_counts(x, m))
    assert int(counts.sum()) == n
    torch.cuda.synchronize()


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("c", [1, 2, 3, 4])
def test_sparsify_and_pipeline_match_plain_versions(card, n, c):
    e, d = _vec(n, 7, 1e-4, card), _vec(n, 8, 1e-3, card)
    u = e + d
    cum = _cum_ks(n, c, card)
    thr = pref.hist_thresholds(pref.hist_counts(u, pref.hist_maxabs(u)),
                               pref.hist_maxabs(u), cum)
    for dropped in (None, c - 1):
        recv = torch.ones(c, dtype=torch.int32, device=card)
        if dropped is not None:
            recv[dropped] = 0
        g, e_new = pk.sparsify_ef(e, d, thr, recv)
        g_r, e_r = pref.hist_layered_sparsify(u, thr, recv)
        assert _bits_equal(g, g_r) and _bits_equal(e_new, e_r)
        assert _bits_equal(g + e_new, u)            # u == g + e' exactly
        g2, e2 = pk.lgc_compress_hist(e, d, cum, recv)
        g2_r, e2_r = pref.hist_lgc_compress(e, d, cum, recv)
        assert _bits_equal(g2, g2_r) and _bits_equal(e2, e2_r)
    torch.cuda.synchronize()


def test_degenerate_inputs_match_plain_versions(card):
    """All zeros (maxabs 0, scale 0) and a vector of equal magnitudes."""
    for x in (torch.zeros(1000, device=card),
              torch.full((1000,), -0.5, device=card)):
        m = pk.maxabs(x)
        assert _bits_equal(m, pref.hist_maxabs(x).reshape(1, 1))
        assert _bits_equal(pk.histogram(x, m), pref.hist_counts(x, m))
        cum = _cum_ks(1000, 3, card)
        recv = torch.ones(3, dtype=torch.int32, device=card)
        for got, want in zip(pk.lgc_compress_hist(x, x, cum, recv),
                             pref.hist_lgc_compress(x, x, cum, recv)):
            assert _bits_equal(got, want)
    torch.cuda.synchronize()


def test_each_wrapper_counts_its_launches(card):
    x = _vec(5000, 3, 1e-3, card)
    cum = _cum_ks(5000, 3, card)
    recv = torch.ones(3, dtype=torch.int32, device=card)
    pk.reset_launch_counts()
    pk.lgc_compress_hist(x, x, cum, recv)
    pk.maxabs(x)
    assert pk.LAUNCHES == {"maxabs": 2, "histogram": 1, "sparsify_ef": 1}
    torch.cuda.synchronize()


def test_wrapper_rejects_mixed_devices(card):
    x = torch.zeros(16, device=card)
    with pytest.raises(ValueError):
        pk.histogram(x, torch.zeros((1, 1)))
    with pytest.raises(ValueError):
        pk.sparsify_ef(x, x, torch.zeros(3), torch.ones(3, dtype=torch.int32))
