"""The port's CUDA kernels on the card against their plain versions: the
LGC kernels bitwise (flat, rows and the segmented forms), ``swa_decode`` to
the tolerance of its f32 sums; and the simulator's threefry PRNG on the
card bitwise equal to the CPU's, a short LR run through the LGC kernels
against the CPU's plain versions, every sync of short LR and CNN runs
bitwise equal to the plain pipeline, the per-layer path's launches, the
diloco / semi_sync servers against the CPU, and the DDPG fleet on the card
(fleet == list bitwise, and one act and train step against the same fleet
on the CPU); QSGD card against CPU bitwise; the population's EF stores
card against CPU bitwise, and 100,000-device population runs (lgc with
its launches, lgc_q8 over the int8 store) card against CPU; the 100M
step's sparse uplinks card against CPU bitwise and a checkpoint round trip
of card tensors; the sharded engine on the card (one rank over NCCL, two
over gloo on the one card) bitwise the unsharded batched engine; the moe,
ssm, hybrid, vlm and audio families' smoke serve (olmoe, mamba2, zamba2,
phi-3-vision, whisper) card against CPU; one LGC training round of each
of these families' smoke configs card against CPU; the model axis on two
gloo ranks sharing the card: the split LGC pipeline at a full-width 100M
leaf and at mamba2-370m's SSD leaves bitwise the unsharded one, and the
dense, ssm and hybrid smoke configs served at P = 2 against P = 1.

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
from repro_torch.kernels import topk_threshold as tt  # noqa: E402

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


def _maxabs_pass(card) -> int:
    """Floats that one pass of maxabs's full grid reads."""
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    return sms * 8 * 256 * 4 * 4


@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("passes,extra", [
    (0, 1), (0, 2), (0, 3), (0, 63), (0, 4095), (0, 4096), (0, 4097),
    (0, 1_000_003), (1, -1), (1, 0), (1, 1), (1, 5), (2, 3)])
def test_maxabs_bitwise_at_the_chunk_edges(card, passes, extra, offset):
    """n = passes x (the floats one pass of the full grid reads) + extra:
    sizes around one block's pass (4,096 floats) and the full grid's, at
    every pointer offset from a 16-byte boundary."""
    n = passes * _maxabs_pass(card) + extra
    x = _vec(n + offset, n + 5, 1e-3, card)[offset:]
    assert _bits_equal(pk.maxabs(x), pref.hist_maxabs(x).reshape(1, 1))
    torch.cuda.synchronize()


def test_maxabs_special_values_and_repeated_launches(card):
    """All zeros, -0.0, a NaN, +inf; then ten launches in a row with no
    re-zeroing of anything (the last block resets the counter)."""
    x = torch.zeros(100_003, device=card)
    cases = [x, torch.full_like(x, -0.0), x.clone().index_fill_(
        0, torch.tensor([77_777], device=card), float("nan")),
        x.clone().index_fill_(0, torch.tensor([3], device=card),
                              float("-inf"))]
    for c in cases:
        assert _bits_equal(pk.maxabs(c), pref.hist_maxabs(c).reshape(1, 1))
    big = _vec(3 * _maxabs_pass(card) + 7, 11, 1e-3, card)
    want = pref.hist_maxabs(big).reshape(1, 1)
    outs = [pk.maxabs(big) for _ in range(10)]
    small = _vec(63, 12, 1.0, card)
    outs_small = [pk.maxabs(small) for _ in range(10)]
    assert all(_bits_equal(o, want) for o in outs)
    assert all(_bits_equal(o, pref.hist_maxabs(small).reshape(1, 1))
               for o in outs_small)
    torch.cuda.synchronize()


def _histogram_pass(card) -> int:
    """Floats that one pass of histogram's full grid reads."""
    from repro_torch.kernels.topk_threshold import histogram_grid
    return histogram_grid(1 << 40, card) * 256 * 4 * 4


def _assert_histogram(x: torch.Tensor, m: torch.Tensor, msg="") -> None:
    counts = pk.histogram(x, m)
    assert counts.dtype == torch.int32 and counts.shape == (256,), msg
    assert _bits_equal(counts, pref.hist_counts(x, m)), msg
    assert int(counts.sum()) == x.numel(), msg


@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("passes,extra", [
    (0, 1), (0, 2), (0, 3), (0, 63), (0, 4095), (0, 4096), (0, 4097),
    (0, 1_000_003), (1, -1), (1, 0), (1, 1), (1, 5), (2, 3)])
def test_histogram_bitwise_at_the_chunk_edges(card, passes, extra, offset):
    """n = passes x (the floats one pass of histogram's full grid reads) +
    extra: sizes around one block's pass (4,096 floats) and the full grid's,
    at every pointer offset from a 16-byte boundary."""
    n = passes * _histogram_pass(card) + extra
    x = _vec(n + offset, n + 6, 1e-3, card)[offset:]
    _assert_histogram(x, pk.maxabs(x), f"n={n} offset={offset}")
    torch.cuda.synchronize()


def _histogram_specials(card) -> dict:
    """(x, m) for the edge inputs: m is max |x| over the finite values."""
    z = torch.zeros(100_003, device=card)
    g = _vec(100_003, 13, 1.0, card)
    m_g = g.abs().max().reshape(1, 1)
    one = torch.ones((1, 1), device=card)
    k = torch.arange(257, device=card, dtype=torch.float32) / 256
    idx = torch.tensor([77_777], device=card)
    return {
        "zeros": (z, pk.maxabs(z)),
        "-0.0": (torch.full_like(z, -0.0), pk.maxabs(z)),
        "NaN": (g.clone().index_fill_(0, idx, float("nan")), m_g),
        "+inf": (g.clone().index_fill_(0, idx, float("inf")), m_g),
        "-inf": (g.clone().index_fill_(0, idx, float("-inf")), m_g),
        "constant": (torch.full((1_000_003,), -0.5, device=card), one / 2),
        "bin edges": (torch.cat([k, -k]).repeat(1000), one),
        "m NaN": (g, torch.full((1, 1), float("nan"), device=card)),
        "m 0": (g, one * 0),
    }


def test_histogram_special_values_and_repeated_launches(card):
    """Zeros, -0.0, a NaN, +-inf, a constant vector (every element in bin
    255), exact bin edges k/256; then ten launches in a row and a launch
    right after one with a larger grid, with no re-zeroing of anything (the
    last block empties the accumulator and resets the counter)."""
    for tag, (x, m) in _histogram_specials(card).items():
        _assert_histogram(x, m, tag)
    big = _vec(3 * _histogram_pass(card) + 7, 14, 1e-3, card)
    small = _vec(5000, 15, 1.0, card)
    m_big, m_small = pk.maxabs(big), pk.maxabs(small)
    want_big = pref.hist_counts(big, m_big)
    want_small = pref.hist_counts(small, m_small)
    outs = [pk.histogram(big, m_big) for _ in range(10)]
    after_big = pk.histogram(small, m_small)
    outs_small = [pk.histogram(small, m_small) for _ in range(10)]
    assert all(_bits_equal(o, want_big) for o in outs)
    assert _bits_equal(after_big, want_small)
    assert all(_bits_equal(o, want_small) for o in outs_small)
    torch.cuda.synchronize()


@pytest.mark.parametrize("scale", [1e-39, 1e-37, 1e-36, 1e-30])
def test_kernels_flush_subnormals_as_the_plain_versions(card, scale):
    """Inputs that are all, partly or not subnormal: each LGC kernel flushes
    as its plain version does (the reference's FTZ/DAZ)."""
    rng = np.random.default_rng(0)
    e, d = (torch.from_numpy((rng.standard_normal(4096) * scale).astype(
        np.float32)).to(card) for _ in range(2))
    m = pk.maxabs(e)
    assert _bits_equal(m, pref.hist_maxabs(e).reshape(1, 1))
    assert _bits_equal(pk.histogram(e, m), pref.hist_counts(e, m))
    u, m_u = pk.sum_maxabs(e, d)
    u_r = pref.ftz_add(e, d)
    assert _bits_equal(u, u_r)
    assert _bits_equal(m_u, pref.hist_maxabs(u_r).reshape(1, 1))
    cum = torch.tensor([40, 120], dtype=torch.int32, device=card)
    thr = pref.hist_thresholds(pref.hist_counts(u_r, m_u), m_u, cum)
    for recv in ([1, 1], [1, 0]):
        recv = torch.tensor(recv, dtype=torch.int32, device=card)
        for got, want in zip(pk.sparsify_ef(e, d, thr, recv),
                             pref.hist_layered_sparsify(u_r, thr, recv)):
            assert _bits_equal(got, want)
        for got, want in zip(pk.lgc_compress_hist(e, d, cum, recv),
                             pref.hist_lgc_compress(e, d, cum, recv)):
            assert _bits_equal(got, want)
    torch.cuda.synchronize()


@pytest.mark.parametrize("off_e,off_d", [(0, 0), (1, 1), (3, 3), (0, 1),
                                         (2, 1)])
@pytest.mark.parametrize("n", [1, 5, 4097, 1_000_003])
def test_sum_maxabs_matches_plain_version(card, n, off_e, off_d):
    """u = e + delta and max |u| in one launch, with e and delta at equal
    offsets from a 16-byte boundary (float4 body) and at unequal ones."""
    e = _vec(n + 3, n, 1e-4, card)[off_e:off_e + n]
    d = _vec(n + 3, n + 1, 1e-3, card)[off_d:off_d + n]
    u, m = pk.sum_maxabs(e, d)
    u_r = pref.ftz_add(e, d)
    assert _bits_equal(u, u_r)
    assert _bits_equal(m, pref.hist_maxabs(u_r).reshape(1, 1))
    torch.cuda.synchronize()


def test_each_wrapper_counts_its_launches(card):
    x = _vec(5000, 3, 1e-3, card)
    cum = _cum_ks(5000, 3, card)
    recv = torch.ones(3, dtype=torch.int32, device=card)
    pk.reset_launch_counts()
    pk.lgc_compress_hist(x, x, cum, recv)
    pk.maxabs(x)
    pk.maxabs_rows(x.view(2, 2500))
    assert pk.LAUNCHES == {"maxabs": 2, "histogram": 1, "sparsify_ef": 1,
                           "swa_decode": 0, "swa_decode_partial": 0,
                           "maxabs_rows": 1,
                           "histogram_rows": 0, "sparsify_ef_rows": 0,
                           "maxabs_segments": 0, "histogram_segments": 0,
                           "threefry_normal": 0}
    pk.lgc_compress_hist_rows(x.view(2, 2500), x.view(2, 2500),
                              cum.expand(2, 3), recv.expand(2, 3))
    assert [pk.LAUNCHES[k] for k in ("maxabs_rows", "histogram_rows",
                                     "sparsify_ef_rows")] == [2, 1, 1]
    q = torch.zeros((1, 2, 32), device=card)
    kv = torch.zeros((1, 1, 4, 32), device=card)
    pk.swa_decode(q, kv, kv, torch.ones(1, dtype=torch.int32, device=card))
    assert pk.LAUNCHES["swa_decode"] == 1
    pk.swa_decode_partial(q, kv, kv,
                          torch.ones(1, dtype=torch.int32, device=card))
    assert pk.LAUNCHES["swa_decode"] == 1
    assert pk.LAUNCHES["swa_decode_partial"] == 1
    pk.per_layer_candidates_hist_rows(
        x.view(2, 2500), pk.SegmentTable([0, 10, 2500], card),
        torch.full((2, 2), 7, dtype=torch.int32, device=card))
    assert [pk.LAUNCHES[k] for k in ("maxabs_segments",
                                     "histogram_segments")] == [1, 1]
    pk.threefry_normal(torch.empty(10, device=card), torch.tensor([0, 7]), 1.0)
    assert pk.LAUNCHES["threefry_normal"] == 1
    torch.cuda.synchronize()


def test_wrapper_rejects_mixed_devices(card):
    x = torch.zeros(16, device=card)
    with pytest.raises(ValueError):
        pk.histogram(x, torch.zeros((1, 1)))
    with pytest.raises(ValueError):
        pk.sparsify_ef(x, x, torch.zeros(3), torch.ones(3, dtype=torch.int32))


# ---------------------------------------------------------------------------
# swa_decode: f32 sums in another order than the plain version, so the f32
# tolerance is 2e-5 and the bf16 one step of the bf16 output (1e-2)
# ---------------------------------------------------------------------------

SWA_TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}
SWA_SHAPES = [(2, 4, 4, 512, 64), (1, 8, 8, 1024, 128), (4, 2, 2, 256, 32),
              (8, 12, 2, 4096, 128), (2, 12, 2, 4160, 128),
              (2, 16, 1, 100, 64),                       # (B, H, Kv, W, Dh)
              # the olmoe-1b-7b and zamba2-1.2b decode shapes (REP 1)
              (8, 16, 16, 4096, 128), (8, 32, 32, 4096, 64),
              # phi-3-vision-4.2b's decode (Dh 96), whisper-small's
              # cross-attention over its 1,500 encoder slots, and Dh 96
              # under GQA (REP 8)
              (8, 32, 32, 4096, 96), (8, 12, 12, 1500, 64),
              (2, 16, 2, 300, 96),
              # the decode shapes of glm4-9b (REP 16), starcoder2-7b (REP 9:
              # a group of 8 query heads and one of 1), yi-34b (REP 7, batch
              # 4) and grok-1-314b (REP 6)
              (8, 32, 2, 4096, 128), (8, 36, 4, 4096, 128),
              (4, 56, 8, 4096, 128), (8, 48, 8, 4096, 128)]


def _swa_inputs(b, h, kv, w, dh, dtype, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn((b, h, dh), generator=g, device=device).to(dtype)
    k = torch.randn((b, kv, w, dh), generator=g, device=device).to(dtype)
    v = torch.randn((b, kv, w, dh), generator=g, device=device).to(dtype)
    return q, k, v


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SWA_SHAPES)
def test_swa_decode_matches_plain_version(card, shape, dtype):
    b, h, kv, w, dh = shape
    q, k, v = _swa_inputs(b, h, kv, w, dh, dtype, card)
    for n in (1, w // 2 + 3, w):
        ln = torch.full((b,), n, dtype=torch.int32, device=card)
        ln[0] = max(1, n - 1)                        # rows of other lengths
        got = pk.swa_decode(q, k, v, ln)
        want = pref.swa_decode_ref(q, k, v, ln)
        assert got.dtype == dtype and got.shape == q.shape
        tol = SWA_TOL[dtype]
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)
    torch.cuda.synchronize()


def _edge_lengths(shape, card) -> list[int]:
    """Lengths at the tile and split edges of this shape's launch."""
    from repro_torch.kernels.swa_attention import _MAX_REP, _num_splits
    b, h, kv, w, _ = shape
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    groups = b * kv * -(-(h // kv) // _MAX_REP)
    sl = pref.swa_split_len(w, _num_splits(groups, w, sms))
    t = pref.SWA_TILE
    return sorted({n for n in (1, t - 1, t, t + 1, sl - 1, sl, sl + 1,
                               2 * sl + 1, w - 1, w) if 1 <= n <= w})


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 12, 2, 4096, 128), (2, 4, 2, 16, 64),
                                   (1, 16, 1, 4160, 32),
                                   (8, 12, 2, 4096, 128),
                                   (1, 12, 12, 1500, 64),
                                   (1, 16, 1, 1500, 96)])
def test_swa_decode_at_tile_and_split_edges(card, shape, dtype):
    """B=1 (many splits of one tile), W=16 (one partial tile), REP=16 (two
    query-head groups), the serve shape and W=1,500 (a partial last tile;
    at Dh 64 and 96), at lengths on either side of every tile and split
    edge; each row of the batch its own length."""
    b, h, kv, w, dh = shape
    q, k, v = _swa_inputs(b, h, kv, w, dh, dtype, card, seed=w + b)
    tol = SWA_TOL[dtype]
    for n in _edge_lengths(shape, card):
        ln = torch.tensor([max(1, n - i) for i in range(b)],
                          dtype=torch.int32, device=card)
        got = pk.swa_decode(q, k, v, ln)
        torch.testing.assert_close(got.float(),
                                   pref.swa_decode_ref(q, k, v, ln).float(),
                                   rtol=tol, atol=tol,
                                   msg=lambda m: f"length {n}: {m}")
    torch.cuda.synchronize()


def test_swa_decode_is_deterministic_across_group_counts(card):
    """Two launches give the same bits; a launch right after one with more
    groups (and one that grows the counters) is still right, so the last
    block of every group left its counter at zero."""
    shapes = [(8, 12, 2, 4096, 128), (64, 16, 8, 256, 64),
              (1, 12, 2, 4096, 128), (160, 8, 8, 128, 64),
              (8, 12, 2, 4096, 128)]
    first = {}
    for i, shape in enumerate(shapes):
        b, h, kv, w, dh = shape
        q, k, v = _swa_inputs(b, h, kv, w, dh, torch.bfloat16, card, seed=5)
        ln = torch.full((b,), w - 3, dtype=torch.int32, device=card)
        out1 = pk.swa_decode(q, k, v, ln)
        out2 = pk.swa_decode(q, k, v, ln)
        assert torch.equal(out1, out2), shape
        torch.testing.assert_close(out1.float(),
                                   pref.swa_decode_ref(q, k, v, ln).float(),
                                   rtol=1e-2, atol=1e-2)
        if shape in first:
            assert torch.equal(first[shape], out1), shape
        first.setdefault(shape, out1)
    torch.cuda.synchronize()


def test_swa_decode_ignores_the_tail_and_zero_length(card):
    q, k, v = _swa_inputs(2, 4, 2, 256, 64, torch.float32, card, seed=1)
    ln = torch.tensor([100, 0], dtype=torch.int32, device=card)
    out1 = pk.swa_decode(q, k, v, ln)
    k2, v2 = k.clone(), v.clone()
    k2[:, :, 100:] = 1e9
    v2[:, :, 100:] = -1e9
    out2 = pk.swa_decode(q, k2, v2, ln)
    assert torch.equal(out1, out2)
    assert torch.equal(out1[1], torch.zeros_like(out1[1]))
    torch.cuda.synchronize()


def test_swa_decode_rejects_mixed_devices(card):
    q = torch.zeros((1, 2, 32), device=card)
    kv = torch.zeros((1, 1, 4, 32), device=card)
    with pytest.raises(ValueError):
        pk.swa_decode(q, kv, kv, torch.ones(1, dtype=torch.int32))


# swa_decode's partial form, the decode attention of a rank's shard of the
# cache's slots under the model axis: the serve shard shape of qwen2-1.5b
# (a 4,096-slot cache over two ranks), the shards of chip_smoke.py's
# serving job (a 1,040-slot cache and a 1,024-slot ring over two ranks),
# Dh 64 and Dh 96 under GQA, zamba2-1.2b's shard of its 1,040-slot
# K/V sites over two ranks (REP 1, Dh 64), and olmoe-1b-7b's and
# phi-3-vision-4.2b's shards of a 1,040-slot cache (REP 1, Dh 128 and 96)
PARTIAL_SHAPES = [(8, 12, 2, 2048, 128), (8, 12, 2, 520, 128),
                  (8, 12, 2, 512, 128), (2, 8, 2, 520, 64),
                  (2, 16, 2, 300, 96), (8, 32, 32, 520, 64),
                  (8, 16, 16, 520, 128), (8, 32, 32, 520, 96)]


def _partial_lengths(b, w, card):
    """Rows of W, W/2 + 3, 1 and 0 valid slots (an empty shard), cycled."""
    ns = [w, w // 2 + 3, 1, 0]
    return torch.tensor([ns[i % 4] for i in range(b)], dtype=torch.int32,
                        device=card)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", PARTIAL_SHAPES)
def test_swa_decode_partial_is_swa_decode_bitwise(card, shape, dtype):
    """The partial form's f32 output cast to q's dtype is swa_decode's
    output bit for bit (the same launch); its (out, m, l) agree with the
    plain partial version (out at SWA_TOL, m and l at 1e-5 in f32 and
    1e-2 in bf16: the logits' f32 sums run in another order); an empty row
    gives m = -inf, l = 0 and zeros."""
    b, h, kv, w, dh = shape
    q, k, v = _swa_inputs(b, h, kv, w, dh, dtype, card, seed=w)
    ln = _partial_lengths(b, w, card)
    out, m, l_sum = pk.swa_decode_partial(q, k, v, ln)
    assert out.dtype == m.dtype == l_sum.dtype == torch.float32
    want = pk.swa_decode(q, k, v, ln)
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(out.to(dtype).view(bits), want.view(bits))
    ref_out, ref_m, ref_l = pref.swa_decode_partial_ref(q, k, v, ln)
    tol = SWA_TOL[dtype]
    torch.testing.assert_close(out, ref_out, rtol=tol, atol=tol)
    stol = 1e-5 if dtype == torch.float32 else 1e-2
    empty = ln == 0
    torch.testing.assert_close(m[~empty], ref_m[~empty], rtol=stol,
                               atol=stol)
    torch.testing.assert_close(l_sum, ref_l, rtol=stol, atol=stol)
    assert torch.isneginf(m[empty]).all() and (l_sum[empty] == 0).all()
    assert (out[empty] == 0).all()
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_two_shards_merge_to_swa_decode_over_the_window(card, dtype):
    """qwen2-1.5b's serve shape split over two ranks as attention_decode
    splits it: the kernel's partial state of each half (the second empty
    on rows that end in the first), merged, within SWA_TOL of swa_decode
    over the whole window."""
    b, h, kv, w, dh = 8, 12, 2, 4096, 128
    q, k, v = _swa_inputs(b, h, kv, w, dh, dtype, card, seed=3)
    ln = torch.tensor([w, w - 5, w // 2 + 1, w // 2, 700, 1, 0, 2049],
                      dtype=torch.int32, device=card)
    half = w // 2
    states = [pk.swa_decode_partial(
        q, k[:, :, r * half:(r + 1) * half].contiguous(),
        v[:, :, r * half:(r + 1) * half].contiguous(),
        torch.clamp(ln - r * half, 0, half).to(torch.int32))
        for r in range(2)]
    got = pref.merge_decode_partials(*(torch.stack(t) for t in
                                       zip(*states)), dtype)
    tol = SWA_TOL[dtype]
    torch.testing.assert_close(got.float(),
                               pk.swa_decode(q, k, v, ln).float(),
                               rtol=tol, atol=tol)
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# the simulator: the PRNG on the card, and a short run through the kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,std,shape", [
    (torch.float32, 0.02, (4097, 3)), (torch.bfloat16, 1536 ** -0.5,
                                       (2048, 1536)),
    (torch.float32, 2048 ** -0.5, (2048, 64)), (torch.bfloat16, 1.0, (1,))])
def test_threefry_normal_on_the_card_equals_the_plain_draw(card, dtype, std,
                                                           shape):
    """The weights' draw kernel bitwise the plain version on the CPU."""
    from repro_torch.core import prng
    key = prng.split(prng.PRNGKey(5), 3)[1]
    pk.reset_launch_counts()
    got = pk.threefry_normal(torch.empty(shape, dtype=dtype, device=card),
                             key, std)
    assert pk.LAUNCHES["threefry_normal"] == 1
    want = pref.threefry_normal_ref(key, shape, std, dtype, "cpu")
    assert _bits_equal(got.cpu().view(torch.int16 if dtype == torch.bfloat16
                                      else torch.int32),
                       want.view(torch.int16 if dtype == torch.bfloat16
                                 else torch.int32))


def test_prng_on_the_card_equals_the_cpu(card):
    from repro_torch.core import prng
    from repro_torch.core.scenario import stream_key
    for seed in (0, 7, 2 ** 31 - 1):
        kc, kg = prng.PRNGKey(seed), prng.PRNGKey(seed, device=card)
        pairs = [
            (prng.fold_in(kc, 2 ** 31 + 3), prng.fold_in(kg, 2 ** 31 + 3)),
            (prng.split(kc, 4), prng.split(kg, 4)),
            (stream_key(kc, 1, 119, 7), stream_key(kg, 1, 119, 7)),
            (prng.random_bits(kc, (3, 5)), prng.random_bits(kg, (3, 5))),
            (prng.randint(kc, (2048,), 0, 70_000),
             prng.randint(kg, (2048,), 0, 70_000)),
            (prng.uniform(kc, (4099,)), prng.uniform(kg, (4099,))),
            (prng.normal(kc, (7850,)), prng.normal(kg, (7850,))),
            (prng.truncated_normal(kc, -2.0, 2.0, (4099,)),
             prng.truncated_normal(kg, -2.0, 2.0, (4099,))),
            # CPU keys, bits drawn on the card (the QSGD dither's path)
            (prng.uniform(kc, (999,)), prng.uniform(kc, (999,), device=card)),
        ]
        for want, got in pairs:
            assert got.device.type == "cuda"
            assert _bits_equal(got.cpu(), want)


def test_short_lr_run_launches_the_kernels_once_per_sync(card):
    from repro_torch.core import FLConfig, run_baseline
    from repro_torch.models.paper_models import make_task
    task = make_task("lr_mnist", m_devices=3, n_train=300)
    cfg = FLConfig(rounds=12, eval_every=4, backend="cuda", engine="loop")
    runs = {}
    for dev in ("cpu", card):
        pk.reset_launch_counts()
        runs[str(dev)] = run_baseline(task, cfg, "lgc", h=4, device=dev)
        counts = dict(pk.LAUNCHES)
    torch.cuda.synchronize()
    assert counts == {"maxabs": 9, "histogram": 9, "sparsify_ef": 9,
                      "swa_decode": 0, "swa_decode_partial": 0,
                      "maxabs_rows": 0,
                      "histogram_rows": 0, "sparsify_ef_rows": 0,
                      "maxabs_segments": 0, "histogram_segments": 0,
                      "threefry_normal": 0}
    cpu, gpu = runs["cpu"], runs[str(card)]
    assert gpu.step == cpu.step and gpu.uplink_mb == cpu.uplink_mb
    np.testing.assert_allclose(gpu.loss, cpu.loss, atol=1e-3)
    np.testing.assert_allclose(gpu.accuracy, cpu.accuracy, atol=1e-3)
    pk.reset_launch_counts()
    run_baseline(task, cfg, "fedavg", h=4, device=card)
    torch.cuda.synchronize()
    assert all(v == 0 for v in pk.LAUNCHES.values())


@pytest.mark.parametrize("task_name,m,n_train,batch", [
    ("lr_mnist", 3, 300, 64), ("cnn_mnist", 2, 200, 16)])
def test_every_simulator_sync_matches_the_plain_pipeline_bitwise(
        card, monkeypatch, task_name, m, n_train, batch):
    from repro_torch.core import FLConfig, run_baseline
    from repro_torch.models.paper_models import make_task
    kern = pk.lgc_compress_hist
    received = []

    def checked(e, delta, cum_ks, recv):
        g, e_new = kern(e, delta, cum_ks, recv)
        g_ref, e_ref = pref.hist_lgc_compress(e, delta, cum_ks, recv)
        assert torch.equal(g.view(torch.int32), g_ref.view(torch.int32))
        assert torch.equal(e_new.view(torch.int32), e_ref.view(torch.int32))
        received.append(tuple(recv.tolist()))
        return g, e_new
    monkeypatch.setattr(pk, "lgc_compress_hist", checked)
    task = make_task(task_name, m_devices=m, n_train=n_train)
    pk.reset_launch_counts()
    cfg = FLConfig(rounds=8, eval_every=4, batch_size=batch, backend="cuda",
                   engine="loop")
    run_baseline(task, cfg, "lgc", h=4, device=card)
    torch.cuda.synchronize()
    assert len(received) == 2 * m
    assert pk.LAUNCHES["sparsify_ef"] == 2 * m


# ---------------------------------------------------------------------------
# the (M, D) row kernels and the batched engine
# ---------------------------------------------------------------------------

ROW_SHAPES = [(3, 7850), (8, 206_922), (8, 83_955), (1, 3), (4, 1), (5, 2),
              (3, 7), (2, 63), (1, 100_003)]


def _row_inputs(m: int, d: int, card, offset: int = 0):
    rng = np.random.default_rng(m * d)
    e = torch.from_numpy((rng.standard_t(3, m * d + offset) * 1e-4).astype(
        np.float32)).to(card)[offset:].view(m, d)
    x = torch.from_numpy((rng.standard_t(3, (m, d)) * 1e-3).astype(
        np.float32)).to(card)
    if m > 1:
        e[1] = 0.0
        x[1] = 0.0
    ks = [max(1, d // 40), max(1, d // 80), max(1, d // 80)]
    cum = torch.tensor(np.minimum(np.cumsum(ks), d), dtype=torch.int32,
                       device=card).expand(m, 3).contiguous()
    pats = [(1, 1, 1), (1, 0, 1), (0, 0, 0), (0, 1, 1), (1, 1, 0)]
    recv = torch.tensor([pats[i % len(pats)] for i in range(m)],
                        dtype=torch.int32, device=card)
    return e, x, cum, recv


@pytest.mark.parametrize("m,d", ROW_SHAPES)
@pytest.mark.parametrize("offset", [0, 1])
def test_row_kernels_match_flat_kernels_and_plain_rows(card, m, d, offset):
    """Each row kernel bitwise equal to its plain row version and to the
    flat kernel on every row (odd D, D < 4, M = 1, a zero row, rows that
    start off a 16-byte boundary), in one launch each."""
    e, x, cum, recv = _row_inputs(m, d, card, offset)
    pk.reset_launch_counts()
    u, mx = pk.sum_maxabs_rows(e, x)
    counts = pk.histogram_rows(u, mx)
    thr = pk.thresholds_from_counts(counts, mx, cum)
    g, en = pk.sparsify_ef_rows(e, x, thr, recv)
    assert {k: pk.LAUNCHES[k] for k in ("maxabs_rows", "histogram_rows",
                                        "sparsify_ef_rows")} == {
        "maxabs_rows": 1, "histogram_rows": 1, "sparsify_ef_rows": 1}
    u_ref = pref.ftz_add(e, x)
    assert _bits_equal(u, u_ref)
    assert _bits_equal(mx, pref.hist_maxabs_rows(u_ref))
    assert _bits_equal(counts, pref.hist_counts_rows(u_ref, mx))
    g_ref, en_ref = pref.hist_layered_sparsify_rows(u_ref, thr, recv)
    assert _bits_equal(g, g_ref) and _bits_equal(en, en_ref)
    gp, enp = pk.lgc_compress_hist_rows(e, x, cum, recv)
    for r in range(m):
        g1, e1 = pk.lgc_compress_hist(e[r].contiguous(), x[r], cum[r],
                                      recv[r])
        assert _bits_equal(gp[r], g1) and _bits_equal(enp[r], e1), r
        assert _bits_equal(counts[r], pk.histogram(u[r].contiguous(),
                                                   mx[r].reshape(1, 1)))
    torch.cuda.synchronize()


def test_row_kernels_repeat_and_follow_a_larger_grid(card):
    """Counters and accumulators are left at zero: ten launches in a row,
    and a launch after one with more rows and blocks, give the same bits."""
    big = _row_inputs(8, 206_922, card)
    small = _row_inputs(3, 7850, card)
    want = pk.lgc_compress_hist_rows(*small)
    for _ in range(10):
        pk.lgc_compress_hist_rows(*big)
    got = pk.lgc_compress_hist_rows(*small)
    assert all(_bits_equal(a, b) for a, b in zip(got, want))
    torch.cuda.synchronize()


# the short-row form of maxabs and histogram (a warp a row): many short
# rows, rows off a 16-byte boundary (odd n), n = 1, more than 65,535 rows,
# and n on each side of each kernel's longest row that row_form gives the
# short form
SHORT_SHAPES = [(2_000, 768), (70_000, 5), (1_500, 1_537), (4_096, 1)] + [
    (1_100, n + k) for n in sorted(set(tt.SHORT_ROW_MAX_N.values()))
    for k in (0, 1)]


def _short_inputs(r: int, n: int, card, offset: int = 0):
    """e (offset floats past a 16-byte boundary) and x, (r, n) f32, with
    special rows: 1 all zero, 2 a NaN, 3 +inf, 4 -inf, 5 some subnormals,
    6 all subnormal (its max counts as 0)."""
    rng = np.random.default_rng(r + 7 * n + offset)
    e = torch.from_numpy((rng.standard_t(3, r * n + offset) * 1e-4).astype(
        np.float32)).to(card)[offset:].view(r, n)
    x = torch.from_numpy((rng.standard_t(3, (r, n)) * 1e-3).astype(
        np.float32)).to(card)
    e[1], x[1] = 0.0, 0.0
    x[2, n // 2] = float("nan")
    x[3, n - 1] = float("inf")
    x[4, 0] = float("-inf")
    e[5] *= 1e-35
    x[5, ::2] *= 1e-35
    e[6] = 0.0
    x[6] *= 1e-37
    return e, x


def _u_like(e: torch.Tensor) -> torch.Tensor:
    """An empty (r, n) f32 tensor at e's offset from a 16-byte boundary."""
    r, n = e.shape
    off = e.data_ptr() % 16 // 4
    return torch.empty(r * n + 3, device=e.device)[off:off + r * n].view(r, n)


@pytest.mark.parametrize("r,n", SHORT_SHAPES)
@pytest.mark.parametrize("offset", [0, 1])
def test_short_row_form_matches_plain_rows_and_flat_kernels(card, r, n,
                                                            offset):
    """``sum_maxabs_rows``, ``maxabs_rows`` and ``histogram_rows`` in one
    launch each, and the short form forced at every shape, bitwise the
    plain row versions (NaN, +-inf, subnormals, a zero row, a row whose
    max is subnormal); rows 0, 1 and the last also the flat kernels'."""
    e, x = _short_inputs(r, n, card, offset)
    u_ref = pref.ftz_add(e, x)
    mx_ref = pref.hist_maxabs_rows(u_ref)
    c_ref = pref.hist_counts_rows(u_ref, mx_ref)
    pk.reset_launch_counts()
    u, mx = pk.sum_maxabs_rows(e, x)
    counts = pk.histogram_rows(u, mx)
    alone = pk.maxabs_rows(u)
    assert (pk.LAUNCHES["maxabs_rows"], pk.LAUNCHES["histogram_rows"]) == (
        2, 1)
    assert _bits_equal(u, u_ref) and _bits_equal(mx, mx_ref)
    assert _bits_equal(alone, mx_ref) and _bits_equal(counts, c_ref)
    u_short = _u_like(e)
    assert _bits_equal(tt._maxabs_rows_launch(e, x, u_short, "short"),
                       mx_ref)
    assert _bits_equal(u_short, u_ref)
    assert _bits_equal(tt._maxabs_rows_launch(u_ref, None, None, "short"),
                       mx_ref)
    assert _bits_equal(tt._histogram_rows_launch(u_ref, mx_ref, "short"),
                       c_ref)
    for row in (0, 1, r - 1):
        v = u_ref[row].contiguous()
        assert _bits_equal(pk.maxabs(v).reshape(()), mx_ref[row])
        assert _bits_equal(pk.histogram(v, mx_ref[row].reshape(1, 1)),
                           c_ref[row])
    torch.cuda.synchronize()


def test_short_row_form_repeats_and_follows_a_taller_launch(card):
    """Ten launches in a row, and a launch after a taller one (96,000
    rows of 768, more than a block of the grid strides over), give the
    same bits; ``steps._row_stats`` at (96,000, 768) launches each row
    kernel once, bitwise the plain row versions."""
    from repro_torch.launch import steps
    small = _short_inputs(2_000, 768, card, 1)
    tall = _short_inputs(96_000, 768, card)
    u, mx = pk.sum_maxabs_rows(*small)
    counts = pk.histogram_rows(u, mx)
    for _ in range(10):
        u2, mx2 = pk.sum_maxabs_rows(*small)
        assert _bits_equal(u2, u) and _bits_equal(mx2, mx)
        assert _bits_equal(pk.histogram_rows(u2, mx2), counts)
        assert _bits_equal(pk.maxabs_rows(u2), mx)
    pk.reset_launch_counts()
    u_t, mx_t, c_t = steps._row_stats(*tall)
    assert (pk.LAUNCHES["maxabs_rows"], pk.LAUNCHES["histogram_rows"]) == (
        1, 1)
    u_ref = pref.ftz_add(*tall)
    assert _bits_equal(u_t, u_ref)
    assert _bits_equal(mx_t, pref.hist_maxabs_rows(u_ref))
    assert _bits_equal(c_t, pref.hist_counts_rows(u_ref, mx_t))
    u2, mx2 = pk.sum_maxabs_rows(*small)
    assert _bits_equal(u2, u) and _bits_equal(mx2, mx)
    assert _bits_equal(pk.histogram_rows(u2, mx2), counts)
    torch.cuda.synchronize()


@pytest.mark.parametrize("mode,want", [("lgc", 3), ("fedavg", 0),
                                       ("lgc_q8", 3)])
def test_batched_engine_launches_once_per_boundary_without_a_sync(
        card, monkeypatch, mode, want):
    """12 rounds at H=4 on the card: each row kernel launched once per sync
    boundary (the flat kernels never), every sync's (g, e') bitwise the
    plain row pipeline on the same card tensors, no host sync inside a
    window (torch's sync debug mode raises), and History within the CPU
    run's at the card's summation order."""
    from repro_torch.core import FLConfig, run_baseline
    from repro_torch.core import fl_batched
    from repro_torch.models.paper_models import make_task
    kern = pk.lgc_compress_hist_rows
    seen = []

    def checked(e, delta, cum_ks, recv):
        g, e_new = kern(e, delta, cum_ks, recv)
        mode = torch.cuda.get_sync_debug_mode()   # the check's reads wait
        torch.cuda.set_sync_debug_mode("default")
        g_ref, e_ref = pref.hist_lgc_compress_rows(e, delta, cum_ks, recv)
        seen.append(_bits_equal(g, g_ref) and _bits_equal(e_new, e_ref))
        torch.cuda.set_sync_debug_mode(mode)
        return g, e_new
    monkeypatch.setattr(pk, "lgc_compress_hist_rows", checked)

    def no_sync(fn):
        def guarded(*a, **k):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(*a, **k)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return guarded
    for name in ("_channels", "_draw_batches", "_local_steps", "_sync"):
        monkeypatch.setattr(fl_batched.BatchedEngine, name,
                            no_sync(getattr(fl_batched.BatchedEngine, name)))
    task = make_task("lr_mnist", m_devices=3, n_train=300)
    cfg = FLConfig(rounds=12, eval_every=4, backend="cuda")
    pk.reset_launch_counts()
    gpu = run_baseline(task, cfg, mode, h=4, device=card)
    torch.cuda.synchronize()
    counts = dict(pk.LAUNCHES)
    assert counts == {"maxabs": 0, "histogram": 0, "sparsify_ef": 0,
                      "swa_decode": 0, "swa_decode_partial": 0,
                      "maxabs_rows": want,
                      "histogram_rows": want, "sparsify_ef_rows": want,
                      "maxabs_segments": 0, "histogram_segments": 0,
                      "threefry_normal": 0}
    assert len(seen) == want and all(seen)
    cpu = run_baseline(task, cfg, mode, h=4, device="cpu")
    assert gpu.step == cpu.step and gpu.uplink_mb == cpu.uplink_mb
    np.testing.assert_allclose(gpu.loss, cpu.loss, atol=1e-3)
    np.testing.assert_allclose(gpu.energy_j, cpu.energy_j, rtol=1e-5)


# ---------------------------------------------------------------------------
# the segmented kernels and the per-layer path
# ---------------------------------------------------------------------------

def _model_edges(task_name: str) -> list[int]:
    from repro_torch.core import prng
    from repro_torch.core.compressor import tree_layer_slices
    from repro_torch.models.paper_models import make_task
    task = make_task(task_name, m_devices=1, n_train=100)
    return [0] + [hi for _, _, hi in
                  tree_layer_slices(task.init(prng.PRNGKey(0)))]


# one-float slices, slices starting at every offset mod 4 floats, a slice
# around one block's pass (4,096 floats) and a long one
EDGE_SIZES = [1, 1, 1, 2, 3, 4095, 4097, 63, 1, 8192, 5, 200_003]


def _edge_battery(card):
    """Rows over EDGE_SIZES: row 0 Gaussian; row 1 with an all-zero slice,
    a NaN, a +inf and an all-subnormal slice; row 2 at 1e-38 (partly
    subnormal); row 3 all zeros."""
    edges = np.concatenate([[0], np.cumsum(EDGE_SIZES)]).tolist()
    d = edges[-1]
    rng = np.random.default_rng(9)
    u = (rng.standard_t(3, (4, d)) * 1e-3).astype(np.float32)
    u[1, edges[3]:edges[4]] = 0.0
    u[1, edges[6] + 5] = np.nan
    u[1, edges[7] + 2] = np.inf
    u[1, edges[8]:edges[9]] = np.float32(1e-40)
    u[2] *= np.float32(1e-35)
    u[3] = 0.0
    return torch.from_numpy(u).to(card), edges


def _segment_cases(card):
    for name, m in (("cnn_mnist", 8), ("lr_mnist", 3), ("rnn_shakespeare", 8)):
        edges = _model_edges(name)
        rng = np.random.default_rng(m)
        u = torch.from_numpy((rng.standard_t(3, (m, edges[-1])) * 1e-3)
                             .astype(np.float32)).to(card)
        u[1 % m, edges[1]:edges[2]] = 0.0     # a zero bias, as at round 0
        yield name, u, edges
    u, edges = _edge_battery(card)
    yield "battery", u, edges


def test_segment_kernels_match_plain_versions(card):
    """maxabs_segments and histogram_segments at the CNN's slices (M=8),
    the LR's (M=3), the RNN's (M=8) and the edge battery: one launch each,
    bitwise the plain segmented versions, each (row, slice) bitwise a flat
    launch on that slice; the candidate mask bitwise its plain version."""
    for name, u, edges in _segment_cases(card):
        table = pk.SegmentTable(edges, card)
        pk.reset_launch_counts()
        mx = pk.maxabs_segments(u, table)
        counts = pk.histogram_segments(u, mx, table)
        assert (pk.LAUNCHES["maxabs_segments"],
                pk.LAUNCHES["histogram_segments"]) == (1, 1), name
        assert _bits_equal(mx, pref.hist_maxabs_segments(u, edges)), name
        assert _bits_equal(counts, pref.hist_counts_segments(u, mx, edges))
        assert (counts.sum(2) == torch.tensor(np.diff(edges), device=card)
                ).all(), name
        for r in range(u.shape[0]):
            for i, (lo, hi) in enumerate(zip(edges[:-1], edges[1:])):
                seg = u[r, lo:hi].contiguous()
                assert _bits_equal(mx[r, i].reshape(1, 1), pk.maxabs(seg))
                assert _bits_equal(counts[r, i],
                                   pk.histogram(seg, mx[r, i].reshape(1, 1)))
        budgets = torch.tensor(
            np.random.default_rng(1).integers(0, 40, (u.shape[0],
                                                      len(edges) - 1)),
            dtype=torch.int32, device=card)
        mask = pk.per_layer_candidates_hist_rows(u, table, budgets)
        assert _bits_equal(mask, pref.hist_candidates_segments(
            u, edges, budgets)), name
    torch.cuda.synchronize()


def test_segment_kernels_repeat_and_follow_a_larger_grid(card):
    """Counters and accumulators are left at zero: ten launches in a row
    and a launch after a larger one give the same bits."""
    cases = list(_segment_cases(card))
    _, small_u, small_edges = cases[1]
    small = pk.SegmentTable(small_edges, card)
    want_m = pk.maxabs_segments(small_u, small)
    want_c = pk.histogram_segments(small_u, want_m, small)
    _, big_u, big_edges = cases[0]
    big = pk.SegmentTable(big_edges, card)
    for _ in range(10):
        pk.histogram_segments(big_u, pk.maxabs_segments(big_u, big), big)
    got_m = pk.maxabs_segments(small_u, small)
    assert _bits_equal(got_m, want_m)
    assert _bits_equal(pk.histogram_segments(small_u, got_m, small), want_c)
    torch.cuda.synchronize()


@pytest.mark.parametrize("engine,want", [("loop", (6, 0, 6)),
                                         ("batched", (2, 0, 2))])
@pytest.mark.parametrize("policy", ["size_prop", "divergence"])
def test_per_layer_runs_launch_the_segment_kernels(card, engine, want,
                                                   policy):
    """8 rounds of lr_mnist (M=3, H=4) under a layer policy on the card:
    one launch of each segmented kernel per sync (per syncing device on the
    loop engine), then the LGC row kernels on the masked update; History
    within the CPU run's."""
    from repro_torch.core import FLConfig, run_baseline
    from repro_torch.models.paper_models import make_task
    task = make_task("lr_mnist", m_devices=3, n_train=300)
    cfg = FLConfig(rounds=8, eval_every=4, backend="cuda", engine=engine,
                   layer_policy=policy)
    pk.reset_launch_counts()
    gpu = run_baseline(task, cfg, "lgc", h=4, device=card)
    torch.cuda.synchronize()
    seg, flat, rows = want
    assert (pk.LAUNCHES["maxabs_segments"], pk.LAUNCHES["histogram"],
            pk.LAUNCHES["histogram_rows"]) == (seg, flat, rows)
    assert pk.LAUNCHES["histogram_segments"] == seg
    cpu = run_baseline(task, cfg, "lgc", h=4, device="cpu")
    assert gpu.step == cpu.step and gpu.uplink_mb == cpu.uplink_mb
    np.testing.assert_allclose(gpu.loss, cpu.loss, atol=1e-3)


@pytest.mark.parametrize("agg", ["diloco", "semi_sync"])
@pytest.mark.parametrize("engine", ["loop", "batched"])
def test_server_runs_match_the_cpu(card, engine, agg):
    """lr_mnist M=8 under diloco / semi_sync (cap 2, every 4th device 3x
    slower) on the card against the CPU: History allclose and the simulated
    server wall-clock equal."""
    from repro_torch.core import FLConfig, run_baseline
    from repro_torch.core.scenario import Scenario, StragglerSpec
    from repro_torch.models.paper_models import make_task
    scn = Scenario(name="stragglers",
                   straggler=StragglerSpec(slow_every=4, slowdown=3.0))
    task = make_task("lr_mnist", m_devices=8, n_train=1500, scenario=scn)
    cfg = FLConfig(rounds=20, eval_every=10, backend="cuda", engine=engine,
                   aggregator=agg, staleness_cap=2, scenario=scn)
    gpu = run_baseline(task, cfg, "lgc", device=card)
    cpu = run_baseline(task, cfg, "lgc", device="cpu")
    assert gpu.step == cpu.step and gpu.uplink_mb == cpu.uplink_mb
    assert gpu.server_wall_s == cpu.server_wall_s
    np.testing.assert_allclose(gpu.loss, cpu.loss, atol=1e-3)


@pytest.mark.parametrize("engine", ["loop", "batched"])
def test_ddpg_fleet_matches_agent_list_on_the_card(card, engine):
    """A FleetDDPG(3) and the list of its three agents, both on the card,
    drive lr_mnist (40 rounds, backend "cuda") to bitwise equal decisions
    and History, training engaged on every device."""
    from repro_torch.core import FLConfig, LGCSimulator
    from repro_torch.core.controller import (DDPGConfig, DDPGController,
                                             FleetDDPG)
    from repro_torch.models.paper_models import make_task
    task = make_task("lr_mnist", m_devices=3, n_train=1200)
    cfg = dict(k_total_max=392, batch_size=4)
    runs = {}
    for kind in ("fleet", "list"):
        ctrls = (FleetDDPG(3, DDPGConfig(seed=5, **cfg), device=card)
                 if kind == "fleet" else
                 [DDPGController(DDPGConfig(seed=5 + 17 * m, **cfg),
                                 device=card) for m in range(3)])
        sim = LGCSimulator(task, FLConfig(rounds=40, eval_every=10,
                                          backend="cuda", engine=engine),
                           ctrls, device=card)
        hist = sim.run()
        trains = (sim.fleet._n_train if kind == "fleet" else np.array(
            [c._fleet._n_train[0] for c in sim.fleet.controllers]))
        runs[kind] = (sim.decision_log, hist.asdict(), trains.copy())
    assert (runs["fleet"][2] > 0).all()
    assert runs["fleet"][0] == runs["list"][0]
    assert runs["fleet"][1] == runs["list"][1]
    np.testing.assert_array_equal(runs["fleet"][2], runs["list"][2])


def test_card_fleet_against_the_cpu_fleet(card):
    """From the same state, the card's fleet acts as the CPU's and takes
    the same train step, both to rtol 1e-4 (the matmuls sum in cuBLAS's
    order; the policy's forward in training, XLA:CPU's order emulated, is
    the same on both); the card's fleet is re-loaded from the CPU's after
    each of 12 boundaries."""
    from repro_torch.core.controller import DDPGConfig, FleetDDPG
    from repro_torch.weights import ddpg_from_jax, ddpg_to_jax
    cfg = DDPGConfig(k_total_max=10346, batch_size=4, seed=3,
                     state_dim=9, action_space="per_device", h_max=4)
    cpu, gpu = (FleetDDPG(8, cfg, device=d) for d in ("cpu", card))
    rng = np.random.default_rng(0)
    for _ in range(12):
        states = np.abs(rng.normal(size=(8, 9)) * 10 ** rng.uniform(
            -2, 3, size=(8, 9))).astype(np.float32)
        states[:, 4] = rng.uniform(size=8)
        mask = rng.random(8) < 0.9
        cpu.act(states, mask)
        gpu.act(states, mask)
        np.testing.assert_allclose(gpu._last_a, cpu._last_a, rtol=1e-4,
                                   atol=1e-6)
        new = states + np.abs(rng.normal(size=(8, 9))).astype(np.float32)
        drops = rng.normal(size=8) * 0.1
        for f in (cpu, gpu):
            f.observe(drops, new, mask)
        got, want = ddpg_to_jax(gpu), ddpg_to_jax(cpu)
        for k in ("actor", "critic", "actor_t", "critic_t"):
            for lg, lw in zip(got[k], want[k]):
                for leaf in ("w", "b"):
                    np.testing.assert_allclose(lg[leaf], lw[leaf],
                                               rtol=1e-4, atol=1e-6)
        ddpg_from_jax(want, gpu)
    assert (cpu._n_train > 0).all()


# ---------------------------------------------------------------------------
# the population layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["dense", "int8", "server"])
def test_ef_stores_on_the_card_match_the_cpu(card, kind):
    """One sequence of cohort gathers and scatters through a store on the
    card and one on the CPU, at scales down into the subnormals (never
    flushed): every gather and the final state bitwise equal."""
    from repro_torch.core.error_feedback import make_ef_store
    n, d, m = 500, 7850, 64
    gpu, cpu = make_ef_store(kind, n, d, card), make_ef_store(kind, n, d)
    assert gpu.nbytes == cpu.nbytes
    rng = np.random.default_rng(2)
    for step, scale in enumerate((1.0, 1e-3, 1e-37, 1e-39, 1e-44, 0.0)):
        ids = rng.choice(n, m, replace=False)
        assert _bits_equal(gpu.gather(ids).cpu(), cpu.gather(ids))
        ef = (rng.standard_normal((m, d)) * scale).astype(np.float32)
        ef[0, :5] = -0.0
        gpu.scatter(ids, torch.from_numpy(ef).to(card))
        cpu.scatter(ids, torch.from_numpy(ef))
    every = np.arange(n)
    assert _bits_equal(gpu.gather(every).cpu(), cpu.gather(every))


@pytest.mark.parametrize("engine,per_window", [("batched", 1),
                                               ("loop", 64)])
def test_population_run_on_the_card_matches_the_cpu(card, monkeypatch,
                                                    engine, per_window):
    """The population task at N = 100,000, M = 64, 8 rounds with the dense
    store on the card: each LGC row kernel launched once per window
    (batched) or once per cohort row (loop), every sync bitwise the plain
    row pipeline on the same card tensors, no host sync inside a window,
    and the cohorts, participation and History against the CPU run."""
    from repro_torch.core import FLConfig, population
    from repro_torch.core.population import (make_population,
                                             make_population_task,
                                             run_population)
    kern = pk.lgc_compress_hist_rows
    seen = []

    def checked(e, delta, cum_ks, recv):
        g, e_new = kern(e, delta, cum_ks, recv)
        if not e.is_cuda:                         # the CPU run's
            return g, e_new
        mode = torch.cuda.get_sync_debug_mode()   # the check's reads wait
        torch.cuda.set_sync_debug_mode("default")
        g_ref, e_ref = pref.hist_lgc_compress_rows(e, delta, cum_ks, recv)
        seen.append(_bits_equal(g, g_ref) and _bits_equal(e_new, e_ref))
        torch.cuda.set_sync_debug_mode(mode)
        return g, e_new
    monkeypatch.setattr(pk, "lgc_compress_hist_rows", checked)
    window = population._window

    def no_sync(*a, **k):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return window(*a, **k)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    monkeypatch.setattr(population, "_window", no_sync)
    task = make_population_task(n_shards=8, n_train=1024, seed=0)
    cfg = FLConfig(rounds=8, eval_every=4, backend="cuda")
    pops, hists = {}, {}
    for dev in (card, "cpu"):
        pk.reset_launch_counts()
        pops[dev] = make_population(task, 100_000, device=dev)
        hists[dev] = run_population(pops[dev], cfg, "lgc", h=4,
                                    m_cohort=64, engine=engine)
        if dev is card:
            torch.cuda.synchronize()
            counts = dict(pk.LAUNCHES)
    want = 2 * per_window
    for name in ("maxabs_rows", "histogram_rows", "sparsify_ef_rows"):
        assert counts[name] == want, (name, counts)
    assert counts["maxabs"] == counts["sparsify_ef"] == 0
    assert len(seen) == want and all(seen)
    gpu, cpu = hists[card], hists["cpu"]
    np.testing.assert_array_equal(pops[card].participation,
                                  pops["cpu"].participation)
    assert gpu.step == cpu.step and gpu.uplink_mb == cpu.uplink_mb
    np.testing.assert_allclose(gpu.loss, cpu.loss, atol=1e-3)
    np.testing.assert_allclose(gpu.energy_j, cpu.energy_j, rtol=1e-5)


def test_qsgd_on_the_card_matches_the_cpu(card):
    """QSGD's quantize and dequantize (flat and rows) on the card bitwise
    the CPU's on the same inputs: the dequantize's scale / 127 is a true
    division on both."""
    from repro_torch.core import prng
    from repro_torch.core.compressor import (qsgd_dequantize, qsgd_quantize,
                                             qsgd_quantize_rows)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((64, 7850)).astype(np.float32)
    x *= np.float32(10.0) ** rng.integers(-30, 3, (64, 1))
    keys = prng.split(prng.PRNGKey(9), 64)
    out = {}
    for dev in (card, "cpu"):
        xd = torch.from_numpy(x).to(dev)
        q, s = qsgd_quantize_rows(xd, keys.to(dev))
        q1, s1 = qsgd_quantize(xd[0], prng.PRNGKey(2))
        out[dev] = (q, s, qsgd_dequantize(q, s), q1, s1,
                    qsgd_dequantize(q1, s1))
    for a, b in zip(out[card], out["cpu"]):
        assert _bits_equal(a.cpu(), b)


def test_population_lgc_q8_on_the_card_matches_the_cpu(card, monkeypatch):
    """``lgc_q8`` over the int8 store at N = 100,000, M = 64, 8 rounds:
    every dequantized g on the card bitwise the CPU's dequantize of the
    same codes and scales, and the cohorts, participation, uplink and
    History against the CPU run."""
    from repro_torch.core import FLConfig, fl_batched
    from repro_torch.core.population import (make_population,
                                             make_population_task,
                                             run_population)
    deq = fl_batched.qsgd_dequantize
    seen = []

    def checked(q, scale):
        g = deq(q, scale)
        if q.is_cuda:
            seen.append(_bits_equal(g.cpu(), deq(q.cpu(), scale.cpu())))
        return g
    monkeypatch.setattr(fl_batched, "qsgd_dequantize", checked)
    task = make_population_task(n_shards=8, n_train=1024, seed=0)
    cfg = FLConfig(rounds=8, eval_every=4, backend="cuda")
    pops, hists = {}, {}
    for dev in (card, "cpu"):
        pops[dev] = make_population(task, 100_000, ef_store="int8",
                                    device=dev)
        hists[dev] = run_population(pops[dev], cfg, "lgc_q8", h=4,
                                    m_cohort=64)
    assert len(seen) == 2 and all(seen)
    gpu, cpu = hists[card], hists["cpu"]
    np.testing.assert_array_equal(pops[card].participation,
                                  pops["cpu"].participation)
    assert gpu.step == cpu.step and gpu.uplink_mb == cpu.uplink_mb
    np.testing.assert_allclose(gpu.loss, cpu.loss, atol=1e-3)
    np.testing.assert_allclose(gpu.energy_j, cpu.energy_j, rtol=1e-5)


@pytest.mark.parametrize("mode", ["sparse_gather", "bucket_sparse"])
def test_sparse_uplinks_on_the_card_match_the_cpu(card, mode):
    """M = 3 devices of 4 rows of 2,000 (a leaf's model-dim view), a
    different delivery mask per device: g_mean and e_new on the card (the
    maxabs and histogram row kernels for sparse_gather, in one launch
    each) bitwise the CPU's."""
    from repro_torch.kernels import LAUNCHES, reset_launch_counts
    from repro_torch.launch import steps
    e = _vec(3 * 4 * 2000, 40, 1e-4, "cpu").reshape(3, 4, 2000)
    d = _vec(3 * 4 * 2000, 41, 1e-3, "cpu").reshape(3, 4, 2000)
    recv = torch.tensor([[1, 1, 1], [1, 0, 1], [0, 1, 1]], dtype=torch.int32)
    sp = (0.01, 0.02, 0.02)
    if mode == "sparse_gather":
        def fn(*a):
            return steps._compress_leaf_sparse(*a, kernels=True)
    else:
        fn = steps._compress_leaf_bucket
    want = fn(e, d, sp, recv)
    reset_launch_counts()
    got = fn(e.to(card), d.to(card), sp, recv.to(card))
    if mode == "sparse_gather":
        assert (LAUNCHES["maxabs_rows"], LAUNCHES["histogram_rows"]) == (1, 1)
    else:
        assert not any(LAUNCHES.values())
    for g, w in zip(got, want):
        assert g.device.type == "cuda" and _bits_equal(g.cpu(), w)


def test_checkpoint_round_trip_of_card_tensors(card, tmp_path):
    """bf16 params, a stacked f32 error memory and a round counter on the
    card come back on the card bitwise."""
    from repro_torch.checkpoint import restore, save_checkpoint
    params = {"blocks/attn/wq": _vec(4 * 6, 50, 1.0, card).reshape(
        1, 4, 6).to(torch.bfloat16), "embed": _vec(12, 51, 1.0, card)}
    state = {"params": params,
             "ef": {k: torch.stack([v.float(), -v.float()])
                    for k, v in params.items()}, "round": 3}
    save_checkpoint(str(tmp_path), 3, state)
    like = {"params": {k: torch.zeros_like(v) for k, v in params.items()},
            "ef": {k: torch.zeros_like(v) for k, v in state["ef"].items()},
            "round": 0}
    back, step = restore(str(tmp_path), like)
    assert step == 3 and back["round"] == 3
    for part in ("params", "ef"):
        for k, v in state[part].items():
            w = back[part][k]
            assert w.device == v.device and w.dtype == v.dtype
            assert torch.equal(w.view(torch.int16) if w.dtype ==
                               torch.bfloat16 else w.view(torch.int32),
                               v.view(torch.int16) if v.dtype ==
                               torch.bfloat16 else v.view(torch.int32))


def test_sharded_world1_over_nccl_is_bitwise_the_batched_engine(card):
    """cnn_mnist M = 8, 8 rounds: the one-rank NCCL mesh's sharded engine
    gives the batched engine's History and launches, every row kernel call
    bitwise its plain version."""
    from repro_torch.launch import sharded_runs as runs
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(device="cuda")
    assert mesh.transport == "nccl"
    case = runs.sim_case("cnn", task="cnn_mnist", m=8, n_train=2000,
                         rounds=8)
    want = runs.run_case(case, "batched", "cuda", check_rows=True)
    got = runs.run_case(case, "sharded", "cuda", mesh, check_rows=True)
    assert runs.compare(case, got, want) == []
    assert got["launches"] == want["launches"]
    assert got["launches"]["maxabs_rows"] == 2
    assert got["rows_checked"]["differ"] == 0


def test_sharded_world2_over_gloo_on_one_card(card):
    """lr_mnist M = 8 in gather mode on two gloo ranks sharing the card:
    both ranks' History bitwise the unsharded engine's, each rank one
    launch of each row kernel per boundary on its own block."""
    from repro_torch.launch import sharded_runs as runs
    from repro_torch.launch.mesh import spawn
    case = runs.sim_case("lr", m=8, n_train=2000)
    ranks = spawn(runs.rank_main, 2, "gloo", args=([case], "cuda", True),
                  timeout=300.0)
    want = runs.run_case(case, "batched", "cuda")
    for r in ranks:
        got = r["results"]["lr"]
        assert r["transport"] == "gloo"
        assert runs.compare(case, got, want) == []
        assert got["rows_checked"] == {"calls": 3, "rows": 12, "differ": 0}
        for name in ("maxabs_rows", "histogram_rows", "sparsify_ef_rows"):
            assert got["launches"][name] == 3


def test_model_axis_split_pipeline_on_one_card(card):
    """Two gloo ranks on the card, each with its half of the full-width
    100M task's ``blocks/mlp/w_gate`` (12 x 768 x 3,072) for M = 2: the
    row kernels on the shard with MAX / SUM over the model group are
    bitwise the rank's block of ``lgc_compress_hist_rows`` of the whole
    leaf and of the plain split pipeline, and so is the train step's
    whole compression under dense_masked and sparse_gather."""
    import _torch_tp_jobs as tp_jobs
    from repro_torch.launch.mesh import spawn
    jobs = [dict(name=agg, kind="compress", aggregate=agg,
                 leaves=["blocks/mlp/w_gate"]) for agg in ("dense_masked",
                                                           "sparse_gather")]
    ranks = spawn(tp_jobs.rank_main, 2, "gloo", args=(jobs, "cuda"),
                  timeout=300.0)
    for r in ranks:
        assert r["transport"] == "gloo"
        dense = r["results"]["dense_masked"]["blocks/mlp/w_gate"]
        assert dense["split"] and dense["local"] == [12, 768, 1536]
        assert dense["pipeline_bitwise"] and dense["plain_bitwise"]
        assert dense["step_bitwise"]
        assert r["results"]["sparse_gather"]["blocks/mlp/w_gate"][
            "step_bitwise"]


def test_model_axis_ssd_split_pipeline_on_one_card(card):
    """The SSD leaves' shards (ROADMAP A12c): two gloo ranks on the card,
    each with its column block of mamba2-370m's ``in_proj`` and its row
    block of ``out_proj`` at full width (4 of its 48 layers) for M = 2:
    the row kernels on the shard with MAX / SUM over the model group are
    bitwise the rank's block of ``lgc_compress_hist_rows`` of the whole
    leaf and of the plain split pipeline, and so is the train step's
    whole compression; ``norm_scale``, held whole, is compressed whole."""
    import _torch_tp_jobs as tp_jobs
    from repro_torch.launch.mesh import spawn
    leaves = ["blocks/ssm/in_proj", "blocks/ssm/out_proj",
              "blocks/ssm/norm_scale"]
    job = dict(name="ssd", kind="compress", aggregate="dense_masked",
               arch="mamba2-370m", replace=dict(n_layers=4), leaves=leaves)
    ranks = spawn(tp_jobs.rank_main, 2, "gloo", args=([job], "cuda"),
                  timeout=300.0)
    for r in ranks:
        got = r["results"]["ssd"]
        assert got["blocks/ssm/in_proj"]["local"] == [4, 1024, 2192]
        assert got["blocks/ssm/out_proj"]["local"] == [4, 1024, 1024]
        for leaf in leaves[:2]:
            row = got[leaf]
            assert row["split"] and row["pipeline_bitwise"], leaf
            assert row["plain_bitwise"] and row["step_bitwise"], leaf
        whole = got["blocks/ssm/norm_scale"]
        assert not whole["split"] and whole["step_bitwise"]


def test_model_axis_expert_split_pipeline_on_one_card(card):
    """The expert shards (ROADMAP A12c): two gloo ranks on the card, each
    with its 32 of olmoe-1b-7b's 64 experts at full width (1 of its 16
    layers) for M = 2, a block of the whole leaf's flat order that is not
    contiguous: the row kernels on the shard with MAX / SUM over the model
    group are bitwise the rank's block of ``lgc_compress_hist_rows`` of
    the whole leaf and of the plain split pipeline, and so is the train
    step's whole compression; the router, held whole, is compressed
    whole."""
    import _torch_tp_jobs as tp_jobs
    from repro_torch.launch.mesh import spawn
    leaves = ["blocks/moe/experts/w_gate", "blocks/moe/experts/w_down",
              "blocks/moe/router"]
    job = dict(name="experts", kind="compress", aggregate="dense_masked",
               arch="olmoe-1b-7b", replace=dict(n_layers=1), leaves=leaves)
    ranks = spawn(tp_jobs.rank_main, 2, "gloo", args=([job], "cuda"),
                  timeout=300.0)
    for r in ranks:
        got = r["results"]["experts"]
        assert got["blocks/moe/experts/w_gate"]["local"] == [1, 32, 2048,
                                                             1024]
        assert got["blocks/moe/experts/w_down"]["local"] == [1, 32, 1024,
                                                             2048]
        for leaf in leaves[:2]:
            row = got[leaf]
            assert row["split"] and row["pipeline_bitwise"], leaf
            assert row["plain_bitwise"] and row["step_bitwise"], leaf
        whole = got["blocks/moe/router"]
        assert not whole["split"] and whole["step_bitwise"]


@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-1.2b",
                                  "olmoe-1b-7b"])
def test_model_axis_family_smoke_serve_on_one_card(card, arch):
    """The ssm, hybrid and moe families served under the model axis on
    the card: the smoke config in f32 on two gloo ranks sharing it, a
    16-token prefill into a 24-slot ring and 12 greedy steps past its wrap
    (the SSD blocks on 4 of 8 heads a rank, olmoe's 2 of 4 experts a rank,
    zamba2's and olmoe's ``swa_decode_partial`` on each rank's 12 slots),
    against P = 1 on the card: logits within 1e-5, tokens equal, both
    ranks bit-equal."""
    import dataclasses
    import _torch_tp_jobs as tp_jobs
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import spawn
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import transformer as ptf
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=torch.float32)
    params = ptf.init_params(cfg, seed=0, device="cpu")
    prompts = torch.randint(0, cfg.vocab_size, (2, 16),
                            generator=torch.Generator().manual_seed(3))
    case = dict(name="ring", prompts=prompts.numpy(), cache_len=24,
                window=24, steps=12)
    job = dict(name="serve", kind="serve", arch=arch, smoke=True, f32=True,
               params={k: v.numpy() for k, v in params.items()},
               cases=[case])
    ranks = spawn(tp_jobs.rank_main, 2, "gloo", args=([job], "cuda"),
                  timeout=300.0)
    p = {k: v.to(card) for k, v in params.items()}
    logits, cache = make_prefill_step(cfg, 24, device=card)(
        p, {"tokens": prompts})
    step = make_serve_step(cfg, 24, device=card, return_logits=True)
    tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
    toks, want = [tok], []
    for _ in range(12):
        tok, cache, logits = step(p, tok, cache)
        toks.append(tok)
        want.append(logits.cpu())
    r0, r1 = (r["results"]["serve"]["ring"] for r in ranks)
    np.testing.assert_array_equal(r0["tokens"], torch.cat(toks, 1).cpu())
    np.testing.assert_allclose(r0["logits"], torch.stack(want).numpy(),
                               rtol=1e-5, atol=1e-5)
    assert np.array_equal(r0["logits"], r1["logits"])
    assert np.array_equal(r0["tokens"], r1["tokens"])
    if cfg.arch_type == "moe":
        assert r0["cache"]["k"].shape[3] == 12
    else:
        assert r0["cache"]["state"].shape[2] == cfg.ssm_heads // 2


def test_model_axis_smoke_serve_on_one_card(card):
    """Serving under the model axis on the card: qwen2-smoke in f32 on two
    gloo ranks sharing it, a 12-token prefill into a 16-slot ring and 24
    greedy steps past its wrap (``swa_decode_partial`` on each rank's 8
    slots, 2 a step), against P = 1 on the card: logits within 1e-5,
    tokens equal, both ranks bit-equal."""
    import dataclasses
    import _torch_tp_jobs as tp_jobs
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import spawn
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import transformer as ptf
    cfg = dataclasses.replace(get_smoke_config("qwen2-1.5b"),
                              dtype=torch.float32)
    params = ptf.init_params(cfg, seed=0, device="cpu")
    prompts = torch.randint(0, cfg.vocab_size, (2, 12),
                            generator=torch.Generator().manual_seed(2))
    case = dict(name="ring", prompts=prompts.numpy(), cache_len=16,
                window=16, steps=24)
    job = dict(name="serve", kind="serve", arch="qwen2-1.5b", smoke=True,
               f32=True, params={k: v.numpy() for k, v in params.items()},
               cases=[case])
    ranks = spawn(tp_jobs.rank_main, 2, "gloo", args=([job], "cuda"),
                  timeout=300.0)
    p = {k: v.to(card) for k, v in params.items()}
    logits, cache = make_prefill_step(cfg, 16, device=card)(
        p, {"tokens": prompts})
    step = make_serve_step(cfg, 16, device=card, return_logits=True)
    tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
    toks, want = [tok], []
    for _ in range(24):
        tok, cache, logits = step(p, tok, cache)
        toks.append(tok)
        want.append(logits.cpu())
    r0, r1 = (r["results"]["serve"]["ring"] for r in ranks)
    assert all(r["transport"] == "gloo" for r in ranks)
    np.testing.assert_array_equal(r0["tokens"], torch.cat(toks, 1).cpu())
    np.testing.assert_allclose(r0["logits"], torch.stack(want).numpy(),
                               rtol=1e-5, atol=1e-5)
    assert np.array_equal(r0["logits"], r1["logits"])
    assert np.array_equal(r0["tokens"], r1["tokens"])


# ---------------------------------------------------------------------------
# the moe, ssm and hybrid serving paths
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,sites", [("olmoe-1b-7b", 2),
                                        ("mamba2-370m", 0),
                                        ("zamba2-1.2b", 2),
                                        ("glm4-9b", 2), ("starcoder2-7b", 2),
                                        ("yi-34b", 2), ("grok-1-314b", 2)])
def test_family_smoke_serve_on_the_card_matches_the_cpu(card, arch, sites):
    """The smoke config in f32 with the same weights on both: a 16-token
    prefill into a 24-slot ring, 16 greedy steps past the wrap; logits
    within 1e-5, tokens equal, swa_decode launched 16 x sites times."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import transformer as ptf
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=torch.float32)
    params = ptf.init_params(cfg, seed=0, device="cpu")
    prompts = torch.randint(0, cfg.vocab_size, (2, 16),
                            generator=torch.Generator().manual_seed(1))
    runs = {}
    for dev in ("cpu", card):
        p = {k: v.to(dev) for k, v in params.items()}
        pk.reset_launch_counts()
        logits, cache = make_prefill_step(cfg, 24, device=dev)(
            p, {"tokens": prompts})
        step = make_serve_step(cfg, 24, device=dev, return_logits=True)
        tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
        out = [(logits.cpu(), tok.cpu())]
        for _ in range(16):
            tok, cache, logits = step(p, tok, cache)
            out.append((logits.cpu(), tok.cpu()))
        runs[str(dev)] = (out, dict(pk.LAUNCHES), cache)
    for (lc, tc), (lg, tg) in zip(runs["cpu"][0], runs["cuda"][0]):
        torch.testing.assert_close(lg, lc, rtol=1e-5, atol=1e-5)
        assert torch.equal(tg, tc)
    assert runs["cuda"][1]["swa_decode"] == 16 * sites
    assert sum(runs["cuda"][1].values()) == 16 * sites
    for group in ("kv", "ssm"):
        for name, t in runs["cpu"][2].get(group, {}).items():
            torch.testing.assert_close(runs["cuda"][2][group][name].cpu(), t,
                                       rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch,sites", [("phi-3-vision-4.2b", 2),
                                        ("whisper-small", 4)])
def test_modality_smoke_serve_on_the_card_matches_the_cpu(card, arch, sites):
    """The vlm and audio smoke configs in f32 with the same weights and
    modality stub on both: a prefill (the vlm's 16 patches and 8 tokens,
    whisper's 16 tokens) into a 24-slot ring, 16 greedy steps
    past the wrap; logits within 1e-5, tokens equal, the caches (whisper's
    cross K/V too) within 1e-5, swa_decode launched 16 x sites times
    (whisper: self- and cross-attention in each of its 2 blocks)."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.serve_decode import stub_prefix
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import transformer as ptf
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=torch.float32)
    params = ptf.init_params(cfg, seed=0, device="cpu")
    gen = torch.Generator().manual_seed(1)
    n = 8 if cfg.arch_type == "vlm" else 16      # P + n fills the 24 slots
    prompts = torch.randint(0, cfg.vocab_size, (2, n), generator=gen)
    prefix = stub_prefix(cfg, 2, gen, torch.device("cpu"))
    runs = {}
    for dev in ("cpu", card):
        p = {k: v.to(dev) for k, v in params.items()}
        pk.reset_launch_counts()
        logits, cache = make_prefill_step(cfg, 24, device=dev)(
            p, {"tokens": prompts, "prefix": prefix})
        step = make_serve_step(cfg, 24, device=dev, return_logits=True)
        tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
        out = [(logits.cpu(), tok.cpu())]
        for _ in range(16):
            tok, cache, logits = step(p, tok, cache)
            out.append((logits.cpu(), tok.cpu()))
        runs[str(dev)] = (out, dict(pk.LAUNCHES), cache)
    for (lc, tc), (lg, tg) in zip(runs["cpu"][0], runs["cuda"][0]):
        torch.testing.assert_close(lg, lc, rtol=1e-5, atol=1e-5)
        assert torch.equal(tg, tc)
    assert runs["cuda"][1]["swa_decode"] == 16 * sites
    assert sum(runs["cuda"][1].values()) == 16 * sites
    assert runs["cuda"][2]["pos"] > 24
    cpu, gpu = runs["cpu"][2], runs["cuda"][2]
    pairs = [(gpu["kv"][n], cpu["kv"][n]) for n in ("k", "v")] + \
        [(gpu[n], cpu[n]) for n in ("cross_k", "cross_v") if n in cpu]
    for got, want in pairs:
        torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)


# the families' training path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "mamba2-370m", "zamba2-1.2b",
                                  "phi-3-vision-4.2b", "whisper-small",
                                  "glm4-9b", "starcoder2-7b", "yi-34b",
                                  "grok-1-314b"])
def test_family_lgc_round_on_the_card_matches_the_cpu(card, arch):
    """One ``dense_masked`` round of the smoke config in f32 (M = 2, H = 2,
    every leaf through the row kernels, channel 1 dropped on device 1, a
    random modality prefix) with the same weights, error memory and batch
    on both: the loss within rtol 1e-5, params and error memory within
    rtol 1e-5 / atol 1e-6 (1e-5 for the SSD families, as the CPU tests
    against the reference), at most 0.1% of a leaf off (a coordinate next
    to a bin edge); each row kernel launched once a leaf."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import steps, train
    from repro_torch.models import transformer as ptf
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=torch.float32)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (4, 32))
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(np.roll(toks, -1, 1))}
    stub = train.modality_prefix(cfg, 4, "cpu")
    if stub is not None:
        batch["prefix"] = torch.from_numpy(rng.standard_normal(
            tuple(stub.shape)).astype(np.float32))
    params = ptf.init_params(cfg, seed=0, device="cpu")
    ef = {k: torch.from_numpy((rng.standard_normal((2,) + tuple(v.shape))
                               * 1e-5).astype(np.float32))
          for k, v in params.items()}
    received = torch.tensor([[1, 1, 1], [1, 0, 1]], dtype=torch.int32)
    step = steps.make_lgc_train_step(cfg, 2, steps.LGCStepConfig(
        local_steps=2, local_lr=3e-3, sparsity=(0.05, 0.1, 0.1),
        backend="cuda", pallas_min_elems=1))
    torch.backends.cuda.matmul.allow_tf32 = False
    want = step(params, ef, batch, received)
    pk.reset_launch_counts()
    got = step(*[{k: v.to(card) for k, v in t.items()}
                 for t in (params, ef, batch)], received.to(card))
    np.testing.assert_allclose(float(got[2]), float(want[2]), rtol=1e-5)
    atol = 1e-5 if cfg.arch_type in ("ssm", "hybrid") else 1e-6
    for part in (0, 1):
        for k, w in want[part].items():
            off = ~torch.isclose(got[part][k].cpu(), w, rtol=1e-5, atol=atol)
            assert float(off.float().mean()) <= 1e-3, (part, k)
    for name in ("maxabs_rows", "histogram_rows", "sparsify_ef_rows"):
        assert pk.LAUNCHES[name] == len(params)
    assert pk.LAUNCHES["maxabs"] == pk.LAUNCHES["sparsify_ef"] == 0


# ---------------------------------------------------------------------------
# the gated and plain MoE experts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["geglu", "gelu", "swiglu"])
def test_expert_mlps_on_the_card_match_the_cpu(card, kind):
    """``moe.expert_mlps`` (grok-1's geglu, the biased gelu, swiglu) and its
    gradients in f32 on an (E, C, D) buffer with capacity rows: the card
    within rtol 1e-5 / atol 1e-5 of the CPU (cuBLAS sums in another
    order), TF32 off."""
    from repro_torch.models import moe as pmoe
    e, c, d, f = 8, 10, 64, 96
    g = torch.Generator().manual_seed(3)
    names = ("w_gate", "w_up", "w_down") if kind != "gelu" else \
        ("w_up", "b_up", "w_down", "b_down")
    shapes = {"w_gate": (e, d, f), "w_up": (e, d, f), "w_down": (e, f, d),
              "b_up": (e, f), "b_down": (e, d)}
    experts = {k: torch.randn(shapes[k], generator=g) * 0.1 for k in names}
    buf = torch.randn((e, c, d), generator=g)
    w_out = torch.randn((e, c, d), generator=g)
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for dev in ("cpu", card):
        p = {k: v.detach().to(dev).requires_grad_(True)
             for k, v in experts.items()}
        x = buf.detach().to(dev).requires_grad_(True)
        y = pmoe.expert_mlps(x, p, kind)
        (y * w_out.to(dev)).sum().backward()
        out[str(dev)] = [y.detach().cpu(), x.grad.cpu()] + [
            p[k].grad.cpu() for k in names]
    for got, want in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
