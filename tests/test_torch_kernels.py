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
        q, kv = torch.zeros((1, 2, 32)), torch.zeros((1, 1, 4, 32))
        pk.swa_decode(q, kv, kv, torch.ones(1, dtype=torch.int32))
        assert pk.LAUNCHES == {"maxabs": 0, "histogram": 0, "sparsify_ef": 0,
                               "swa_decode": 0}

