"""The port's histogram-LGC kernel modules held against the JAX reference.

The same f32 inputs, made with numpy from a seed, go through the Pallas
kernels (interpret mode, as tests/test_kernels.py runs them) and through the
port's wrappers.  On the CPU a wrapper runs its plain torch version, so these
tests pin the plain versions -- the oracles the CUDA kernels are held to on
the card -- bitwise to the reference: every output is a selection, an
integer count or a bin edge computed with the same IEEE f32 operations.
The CUDA kernels themselves are compared with their plain versions on the
card by tests/test_torch_cuda.py and chip_smoke.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import kernels as jk  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.launch.steps import _leaf_ks  # noqa: E402
from repro_torch import kernels as pk  # noqa: E402
from repro_torch.kernels import ref as pref  # noqa: E402

SIZES = (63, 1000, 40_000)
CHANNELS = (1, 3, 4)
SPARSITY = (0.01, 0.02, 0.02, 0.05)


def _vec(n: int, seed: int, scale: float = 1e-3) -> np.ndarray:
    rng = np.random.default_rng(seed)
    # heavy-ish tails, like a gradient: most mass in the low bins
    return (rng.standard_t(3, n) * scale).astype(np.float32)


def _masks(c: int) -> list[np.ndarray]:
    """All delivered, and one channel dropped."""
    drop = np.ones(c, np.int32)
    drop[1 % c] = 0
    return [np.ones(c, np.int32), drop]


def _cum_ks(n: int, c: int) -> np.ndarray:
    return np.cumsum(_leaf_ks(n, SPARSITY[:c])).astype(np.int32)


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_bitwise(got, want, msg=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, msg
    assert got.dtype == want.dtype, msg
    np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=msg)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


@pytest.mark.parametrize("n", SIZES)
def test_maxabs_matches_reference(n):
    x = _vec(n, n)
    want = jk.maxabs(jnp.asarray(x))
    _assert_bitwise(pk.maxabs(_t(x)).numpy(), want)
    _assert_bitwise(pref.hist_maxabs(_t(x)).numpy(), jref.hist_maxabs(x))


@pytest.mark.parametrize("case", ["zeros", "minus_zero", "nan", "minus_nan",
                                  "inf"])
def test_maxabs_special_values_match_reference(case):
    """All zeros, -0.0, a NaN of either sign, -inf: the plain version gives
    the Pallas kernel's bits (a NaN's bits with the sign cleared)."""
    x = np.zeros(1000, np.float32)
    if case == "minus_zero":
        x[:] = -0.0
    elif case in ("nan", "minus_nan"):
        x[5] = -2.5
        x[777] = np.float32(np.nan) if case == "nan" else -np.float32(np.nan)
    elif case == "inf":
        x[3] = -np.inf
    want = jk.maxabs(jnp.asarray(x))
    _assert_bitwise(pk.maxabs(_t(x)).numpy(), want)
    _assert_bitwise(pref.hist_maxabs(_t(x)).numpy(), jref.hist_maxabs(x))


@pytest.mark.parametrize("n", SIZES)
def test_histogram_matches_reference(n):
    x = _vec(n, n + 1)
    m = jk.maxabs(jnp.asarray(x))
    want = jk.histogram(jnp.asarray(x), m)
    got = pk.histogram(_t(x), _t(np.asarray(m)))
    _assert_bitwise(got.numpy(), want)
    assert int(got.sum()) == n
    _assert_bitwise(pref.hist_counts(_t(x), _t(np.asarray(m))).numpy(),
                    jref.hist_counts(x, np.asarray(m).reshape(())))


@pytest.mark.parametrize("c", CHANNELS)
@pytest.mark.parametrize("n", SIZES)
def test_thresholds_match_reference(n, c):
    x = _vec(n, n + 2)
    m = jk.maxabs(jnp.asarray(x))
    counts = jk.histogram(jnp.asarray(x), m)
    cum = _cum_ks(n, c)
    want = jk.thresholds_from_counts(counts, m, jnp.asarray(cum))
    got = pk.thresholds_from_counts(_t(np.asarray(counts)),
                                    _t(np.asarray(m)), _t(cum))
    _assert_bitwise(got.numpy(), want)


@pytest.mark.parametrize("c", CHANNELS)
@pytest.mark.parametrize("n", SIZES)
def test_sparsify_ef_matches_reference(n, c):
    e, d = _vec(n, n + 3, 1e-4), _vec(n, n + 4)
    u = jnp.asarray(e) + jnp.asarray(d)
    m = jk.maxabs(u)
    thr = jk.thresholds_from_counts(jk.histogram(u, m), m,
                                    jnp.asarray(_cum_ks(n, c)))
    for recv in _masks(c):
        g_j, e_j = jk.sparsify_ef(jnp.asarray(e), jnp.asarray(d), thr,
                                  jnp.asarray(recv))
        g_p, e_p = pk.sparsify_ef(_t(e), _t(d), _t(np.asarray(thr)),
                                  _t(recv))
        _assert_bitwise(g_p.numpy(), g_j, f"g recv={recv}")
        _assert_bitwise(e_p.numpy(), e_j, f"e_new recv={recv}")
        # error feedback conserves mass exactly: u == g + e'
        _assert_bitwise((g_p + e_p).numpy(), np.asarray(u))


@pytest.mark.parametrize("c", CHANNELS)
@pytest.mark.parametrize("n", SIZES)
def test_lgc_compress_hist_matches_reference(n, c):
    e, d = _vec(n, n + 5, 1e-4), _vec(n, n + 6)
    cum = _cum_ks(n, c)
    for recv in _masks(c):
        args_j = (jnp.asarray(e), jnp.asarray(d), jnp.asarray(cum),
                  jnp.asarray(recv))
        args_p = (_t(e), _t(d), _t(cum), _t(recv))
        g_j, e_j = jk.lgc_compress_hist(*args_j)
        g_r, e_r = jref.hist_lgc_compress(*args_j)
        for name, (g, en) in {
                "kernel": pk.lgc_compress_hist(*args_p),
                "plain": pref.hist_lgc_compress(*args_p)}.items():
            _assert_bitwise(g.numpy(), g_j, f"{name} g recv={recv}")
            _assert_bitwise(en.numpy(), e_j, f"{name} e_new recv={recv}")
            _assert_bitwise(g.numpy(), g_r, f"{name} g vs oracle")
            _assert_bitwise(en.numpy(), e_r, f"{name} e_new vs oracle")
        assert int(pk.selected_counts(g)) == int(jk.selected_counts(g_j))


def _special_case(case: str) -> tuple[np.ndarray, np.float32]:
    """(x, m) with m the scale's maximum, for the histogram's edge inputs."""
    x = _vec(1000, 9, 1.0)
    m = np.float32(np.abs(x).max())
    if case == "zeros":
        x, m = np.zeros(1000, np.float32), np.float32(0)
    elif case == "minus_zero":
        x, m = np.full(1000, -0.0, np.float32), np.float32(0)
    elif case == "nan":
        x[777] = np.nan
    elif case == "inf":
        x[3] = np.inf
    elif case == "minus_inf":
        x[3] = -np.inf
    elif case == "constant":
        x, m = np.full(1000, -0.5, np.float32), np.float32(0.5)
    elif case == "bin_edges":          # k/256 for k = 0..256, both signs
        k = np.arange(257, dtype=np.float32) / 256
        x, m = np.concatenate([k, -k]).astype(np.float32), np.float32(1)
    elif case == "m_nan":
        m = np.float32(np.nan)
    elif case == "m_zero":
        m = np.float32(0)
    elif case == "m_subnormal":
        m = np.float32(1e-39)
    return x, m


@pytest.mark.parametrize("case", [
    "zeros", "minus_zero", "nan", "inf", "minus_inf", "constant",
    "bin_edges", "m_nan", "m_zero", "m_subnormal"])
def test_histogram_special_values_match_reference(case):
    """Zeros, -0.0, a NaN, +-inf, a constant vector, exact bin edges, and a
    maximum that is NaN, 0 or subnormal: the plain version and the CPU path
    of the wrapper give the Pallas kernel's counts."""
    x, m = _special_case(case)
    want = jk.histogram(jnp.asarray(x), jnp.asarray(m).reshape(1, 1))
    m_t = _t(np.asarray(m).reshape(1, 1))
    got = pk.histogram(_t(x), m_t)
    _assert_bitwise(got.numpy(), want)
    _assert_bitwise(pref.hist_counts(_t(x), m_t).numpy(), want)
    assert int(got.sum()) == x.size


SUBNORMAL_SCALES = (1e-39, 1e-37, 1e-36, 1e-30)


def _scaled_normal(scale: float) -> tuple[np.ndarray, np.ndarray]:
    """e and delta, standard normal x scale from numpy seed 0: at 1e-39 all
    subnormal, at 1e-37 and 1e-36 partly, at 1e-30 none."""
    rng = np.random.default_rng(0)
    e = (rng.standard_normal(4096) * scale).astype(np.float32)
    d = (rng.standard_normal(4096) * scale).astype(np.float32)
    return e, d


@pytest.mark.parametrize("scale", SUBNORMAL_SCALES)
def test_lgc_compress_hist_flushes_subnormals_as_the_reference(scale):
    """The pipeline at scales where u is subnormal, where 256/m overflows and
    m/256 is subnormal: the reference flushes f32 subnormals (XLA:CPU runs
    with FTZ/DAZ, the TPU has none), and the port's plain path must give its
    bits."""
    e, d = _scaled_normal(scale)
    cum, recv = np.array([40, 120], np.int32), np.ones(2, np.int32)
    args_j = (jnp.asarray(e), jnp.asarray(d), jnp.asarray(cum),
              jnp.asarray(recv))
    args_p = (_t(e), _t(d), _t(cum), _t(recv))
    g_j, e_j = jk.lgc_compress_hist(*args_j)
    for name, (g, en) in {"kernel": pk.lgc_compress_hist(*args_p),
                          "plain": pref.hist_lgc_compress(*args_p)}.items():
        _assert_bitwise(g.numpy(), g_j, f"{name} g at {scale}")
        _assert_bitwise(en.numpy(), e_j, f"{name} e_new at {scale}")


@pytest.mark.parametrize("scale", SUBNORMAL_SCALES)
def test_kernels_flush_subnormals_as_the_reference(scale):
    """Each kernel module on its own, fed unflushed subnormal inputs:
    maxabs and histogram of e, thresholds, and sparsify_ef of (e, delta)."""
    e, d = _scaled_normal(scale)
    m_j = jk.maxabs(jnp.asarray(e))
    _assert_bitwise(pk.maxabs(_t(e)).numpy(), m_j, "maxabs")
    m = _t(np.asarray(m_j))
    counts_j = jk.histogram(jnp.asarray(e), m_j)
    _assert_bitwise(pk.histogram(_t(e), m).numpy(), counts_j, "histogram")
    cum = np.array([40, 120], np.int32)
    thr_j = jk.thresholds_from_counts(counts_j, m_j, jnp.asarray(cum))
    thr = pk.thresholds_from_counts(_t(np.asarray(counts_j)), m, _t(cum))
    _assert_bitwise(thr.numpy(), thr_j, "thresholds")
    recv = np.array([1, 0], np.int32)
    g_j, e_j = jk.sparsify_ef(jnp.asarray(e), jnp.asarray(d), thr_j,
                              jnp.asarray(recv))
    g_p, e_p = pk.sparsify_ef(_t(e), _t(d), thr, _t(recv))
    _assert_bitwise(g_p.numpy(), g_j, "sparsify_ef g")
    _assert_bitwise(e_p.numpy(), e_j, "sparsify_ef e_new")


def test_thresholds_flush_a_subnormal_bin_width():
    """m / 256 below 2**-126 is flushed, also at the one m whose IEEE
    quotient rounds up to 2**-126."""
    counts = np.zeros(256, np.int32)
    counts[255] = 10
    cum = np.array([5], np.int32)
    for m in (np.float32(2.0 ** -118) - np.float32(2.0 ** -142),
              np.float32(2.0 ** -118), np.float32(1e-37)):
        m = np.asarray(m, np.float32).reshape(1, 1)
        want = jk.thresholds_from_counts(jnp.asarray(counts), jnp.asarray(m),
                                         jnp.asarray(cum))
        got = pk.thresholds_from_counts(_t(counts), _t(m), _t(cum))
        _assert_bitwise(got.numpy(), want, f"m={m}")


class TestWrapperChecks:
    def test_rejects_wrong_dtype_shape_and_layout(self):
        x = torch.zeros(8, dtype=torch.float64)
        with pytest.raises(TypeError):
            pk.maxabs(x)
        with pytest.raises(ValueError):
            pk.maxabs(torch.zeros(2, 4))
        with pytest.raises(ValueError):
            pk.maxabs(torch.zeros(8)[::2])
        with pytest.raises(ValueError):
            pk.maxabs(torch.zeros(0))

    def test_sparsify_rejects_more_than_four_channels(self):
        z = torch.zeros(8)
        with pytest.raises(ValueError):
            pk.sparsify_ef(z, z, torch.zeros(5), torch.ones(5, dtype=torch.int32))

    def test_cpu_tensors_take_the_plain_path_without_launches(self):
        pk.reset_launch_counts()
        x = torch.from_numpy(_vec(100, 0))
        pk.lgc_compress_hist(x, x, torch.tensor([5], dtype=torch.int32),
                             torch.ones(1, dtype=torch.int32))
        pk.lgc_compress_hist_rows(x.view(4, 25), x.view(4, 25),
                                  torch.full((4, 1), 5, dtype=torch.int32),
                                  torch.ones((4, 1), dtype=torch.int32))
        pk.maxabs_rows(x.view(4, 25))
        q, kv = torch.zeros((1, 2, 32)), torch.zeros((1, 1, 4, 32))
        pk.swa_decode(q, kv, kv, torch.ones(1, dtype=torch.int32))
        pk.per_layer_candidates_hist_rows(
            x.view(4, 25), pk.SegmentTable([0, 10, 25], "cpu"),
            torch.full((4, 2), 3, dtype=torch.int32))
        pk.threefry_normal(torch.empty((3, 5)), torch.tensor([0, 7]), 0.5)
        pk.swa_decode_partial(q, kv, kv, torch.ones(1, dtype=torch.int32))
        assert pk.LAUNCHES == {"maxabs": 0, "histogram": 0, "sparsify_ef": 0,
                               "swa_decode": 0, "swa_decode_partial": 0,
                               "maxabs_rows": 0,
                               "histogram_rows": 0, "sparsify_ef_rows": 0,
                               "maxabs_segments": 0,
                               "histogram_segments": 0,
                               "threefry_normal": 0}

