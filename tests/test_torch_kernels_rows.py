"""The (M, D) row forms of the port's LGC kernels held against the JAX
reference's ``jax.vmap`` of its Pallas kernels.

The batched engine reaches the Pallas kernels through ``jax.vmap`` over the
device axis (``repro/core/fl_batched.py:201-209``); the port has row forms
(``sum_maxabs_rows``, ``maxabs_rows``, ``histogram_rows``,
``thresholds_from_counts`` on (M, 256) counts, ``sparsify_ef_rows``,
``lgc_compress_hist_rows``) whose
plain versions (``kernels.ref.*_rows``) run on the CPU.  The same f32
inputs, made with numpy from a seed, go through the vmapped Pallas kernels
(interpret mode) and through the port: bitwise, at odd D, D < 4, M = 1 and
with all-zero rows.  Each plain row form is also bitwise the flat plain
version on every row.  ``row_form`` (the wide or the short form of the
maxabs and histogram row kernels) is held at the paths' shapes.  The CUDA
row kernels are held against these on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import kernels as jk  # noqa: E402
from repro_torch import kernels as pk  # noqa: E402
from repro_torch.kernels import ref as pref  # noqa: E402

# (M, D): the simulator's LR width, M = 1, D < 4, odd D, a row of one
SHAPES = [(3, 7850), (1, 1000), (4, 3), (2, 1), (5, 63), (3, 2049)]
BUDGET = (0.025, 0.0125, 0.0125)        # the simulator's 5% split 1/2, 1/4, 1/4


def _rows(m: int, d: int, seed: int, scale: float = 1e-3,
          zero_row: bool = True) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = (rng.standard_t(3, (m, d)) * scale).astype(np.float32)
    if zero_row and m > 1:
        x[1] = 0.0
    return x


def _cum(m: int, d: int, c: int = 3) -> np.ndarray:
    ks = [max(1, int(d * f)) for f in BUDGET[:c]]
    cum = np.minimum(np.cumsum(ks), d)
    return np.tile(cum, (m, 1)).astype(np.int32)


def _recv(m: int, c: int = 3) -> np.ndarray:
    """A different delivery pattern on every row, all 2**c cycling."""
    pats = list(itertools.product((1, 0), repeat=c))
    return np.array([pats[i % len(pats)] for i in range(m)], np.int32)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def _bitwise(got: torch.Tensor, want, msg=""):
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape, msg
    assert got.dtype == want.dtype, msg
    if want.dtype == np.float32:
        got, want = got.view(np.int32), want.view(np.int32)
    np.testing.assert_array_equal(got, want, err_msg=msg)


@pytest.mark.parametrize("m,d", SHAPES)
def test_rows_match_vmapped_pallas_kernels(m, d):
    e, x = _rows(m, d, d, 1e-4), _rows(m, d, d + 1)
    cum, recv = _cum(m, d), _recv(m)
    je, jx = jnp.asarray(e), jnp.asarray(x)
    u_j = je + jx
    m_j = jax.vmap(jk.maxabs)(u_j)                          # (M, 1, 1)
    counts_j = jax.vmap(jk.histogram)(u_j, m_j)             # (M, 256)
    thr_j = jax.vmap(jk.thresholds_from_counts)(counts_j, m_j,
                                                jnp.asarray(cum))
    g_j, en_j = jax.vmap(jk.sparsify_ef)(je, jx, thr_j, jnp.asarray(recv))
    gh_j, enh_j = jax.vmap(jk.lgc_compress_hist)(je, jx, jnp.asarray(cum),
                                                  jnp.asarray(recv))

    u_p, m_p = pk.sum_maxabs_rows(_t(e), _t(x))
    _bitwise(u_p, u_j, "u")
    _bitwise(m_p, np.asarray(m_j).reshape(m), "maxabs")
    _bitwise(pref.hist_maxabs_rows(u_p), np.asarray(m_j).reshape(m))
    counts_p = pk.histogram_rows(u_p, m_p)
    _bitwise(counts_p, counts_j, "counts")
    assert (counts_p.sum(1) == d).all()
    thr_p = pk.thresholds_from_counts(counts_p, m_p, _t(cum))
    _bitwise(thr_p, thr_j, "thresholds")
    g_p, en_p = pk.sparsify_ef_rows(_t(e), _t(x), thr_p, _t(recv))
    _bitwise(g_p, g_j, "g")
    _bitwise(en_p, en_j, "e_new")
    _bitwise(g_p + en_p, u_j, "u == g + e'")
    gh_p, enh_p = pk.lgc_compress_hist_rows(_t(e), _t(x), _t(cum), _t(recv))
    _bitwise(gh_p, gh_j, "pipeline g")
    _bitwise(enh_p, enh_j, "pipeline e_new")
    assert all(v == 0 for v in pk.LAUNCHES.values())    # the CPU: plain


@pytest.mark.parametrize("m,d", SHAPES)
@pytest.mark.parametrize("scale", [1e-39, 1e-37, 1e-3])
def test_rows_are_the_flat_plain_versions_row_by_row(m, d, scale):
    e, x = _t(_rows(m, d, 7 * d, scale)), _t(_rows(m, d, 7 * d + 1, scale))
    cum, recv = _t(_cum(m, d)), _t(_recv(m))
    u = pref.ftz_add(e, x)
    mx = pref.hist_maxabs_rows(u)
    counts = pref.hist_counts_rows(u, mx)
    thr = pref.hist_thresholds_rows(counts, mx, cum)
    g, en = pref.hist_layered_sparsify_rows(u, thr, recv)
    gh, enh = pref.hist_lgc_compress_rows(e, x, cum, recv)
    for r in range(m):
        m_r = pref.hist_maxabs(u[r])
        _bitwise(mx[r], m_r.numpy(), f"row {r} maxabs")
        c_r = pref.hist_counts(u[r], m_r)
        _bitwise(counts[r], c_r.numpy(), f"row {r} counts")
        t_r = pref.hist_thresholds(c_r, m_r, cum[r])
        _bitwise(thr[r], t_r.numpy(), f"row {r} thresholds")
        g_r, e_r = pref.hist_layered_sparsify(u[r], t_r, recv[r])
        _bitwise(g[r], g_r.numpy(), f"row {r} g")
        _bitwise(en[r], e_r.numpy(), f"row {r} e_new")
        gh_r, eh_r = pref.hist_lgc_compress(e[r], x[r], cum[r], recv[r])
        _bitwise(gh[r], gh_r.numpy(), f"row {r} pipeline g")
        _bitwise(enh[r], eh_r.numpy(), f"row {r} pipeline e_new")


@pytest.mark.parametrize("c", [1, 2, 4])
def test_thresholds_rows_with_per_row_budgets(c):
    """Each row its own budgets and maximum, zero and saturating budgets
    included: (M, C) equal to per-row ``hist_thresholds``."""
    m, d = 6, 3001
    x = _t(_rows(m, d, 99))
    mx = pref.hist_maxabs_rows(x)
    counts = pref.hist_counts_rows(x, mx)
    rng = np.random.default_rng(c)
    cum = np.sort(rng.integers(0, d + 2, (m, c)), 1).astype(np.int32)
    cum[0] = 0
    got = pk.thresholds_from_counts(counts, mx, _t(cum))
    assert got.shape == (m, c)
    for r in range(m):
        want = jk.thresholds_from_counts(jnp.asarray(counts[r].numpy()),
                                         jnp.asarray(mx[r].numpy()),
                                         jnp.asarray(cum[r]))
        _bitwise(got[r], want, f"row {r}")


@pytest.mark.parametrize("m,d", [(40, 768), (5, 7)])
def test_maxabs_rows_matches_vmapped_pallas_maxabs(m, d):
    """``maxabs_rows`` is ``jax.vmap(maxabs)`` (interpret mode), with a
    zero row, a NaN and subnormals."""
    x = _rows(m, d, 3 * d)
    x[0, d // 2] = np.nan
    x[2] *= np.float32(1e-36)
    got = pk.maxabs_rows(_t(x))
    want = jax.vmap(jk.maxabs)(jnp.asarray(x))              # (M, 1, 1)
    _bitwise(got, np.asarray(want).reshape(m))


def test_row_statistics_take_more_than_65535_rows():
    """``sum_maxabs_rows``, ``maxabs_rows`` and ``histogram_rows`` take
    70,000 rows of 3 (one launch each on the card, no row limit) and give
    the plain versions' bits, equal to the flat plain versions on sampled
    rows; ``sparsify_ef_rows`` (a row on each blockIdx.y) still refuses
    them."""
    m, d = 70_000, 3
    e, x = _t(_rows(m, d, 1, 1e-4)), _t(_rows(m, d, 2))
    u, mx = pk.sum_maxabs_rows(e, x)
    _bitwise(u, pref.ftz_add(e, x).numpy())
    _bitwise(mx, pref.hist_maxabs_rows(u).numpy())
    _bitwise(pk.maxabs_rows(u), mx.numpy())
    counts = pk.histogram_rows(u, mx)
    _bitwise(counts, pref.hist_counts_rows(u, mx).numpy())
    assert (counts.sum(1) == d).all()
    for r in (0, 1, 65_535, m - 1):
        _bitwise(mx[r], pref.hist_maxabs(u[r]).numpy(), f"row {r}")
        _bitwise(counts[r], pref.hist_counts(u[r], mx[r]).numpy(), f"row {r}")
    with pytest.raises(ValueError, match="65535"):
        pk.sparsify_ef_rows(e, x, torch.zeros(m, 1),
                            torch.ones(m, 1, dtype=torch.int32))
    assert all(v == 0 for v in pk.LAUNCHES.values())    # the CPU: plain


# (rows, n) of the paths on a 132-SM card, with the form row_form must
# give maxabs and histogram: the simulator's and the dense 100M step's few
# long rows, the population's 64 rows, and the sparse path's model-dim
# views, many rows: the largest leaf's at M = 2 (there the two forms of
# maxabs tie and it stays wide, histogram's short form is faster), embed
# at M = 2 and 3 and qwen2-1.5b's embed on one device, the last two above
# 65,535 rows
PATH_FORMS = [((3, 7850), "wide", "wide"), ((8, 206_922), "wide", "wide"),
              ((8, 83_955), "wide", "wide"),
              ((2, 28_311_552), "wide", "wide"), ((64, 68), "wide", "wide"),
              ((64, 7850), "wide", "wide"),
              ((6_144, 9_216), "wide", "short"),
              ((64_000, 768), "short", "short"),
              ((96_000, 768), "short", "short"),
              ((151_936, 1_536), "short", "short")]


@pytest.mark.parametrize("shape,maxabs_form,histogram_form", PATH_FORMS)
def test_row_form_at_the_paths_shapes(shape, maxabs_form, histogram_form):
    from repro_torch.kernels import topk_threshold as tt
    rows, n = shape
    for kernel, form in (("maxabs", maxabs_form),
                         ("histogram", histogram_form)):
        got, grid = tt.row_form(rows, n, 132, kernel)
        assert got == form, kernel
        if form == "short":   # a persistent grid of the resident blocks
            assert grid == min(-(-rows // 8),
                               tt._SHORT_BLOCKS_PER_SM[kernel] * 132)
        else:                 # blocks a row, within the flat kernel's grid
            assert 1 <= grid * rows <= max(rows, 8 * 132)


@pytest.mark.parametrize("kernel", ["maxabs", "histogram"])
@pytest.mark.parametrize("n", [1, 7, 768, 7850, 28_311_552, 1 << 30])
def test_row_form_never_gives_a_flat_call_the_short_form(kernel, n):
    from repro_torch.kernels import topk_threshold as tt
    for sms in (1, 78, 132):
        assert tt.row_form(1, n, sms, kernel)[0] == "wide"
    # the short form only beyond 8 rows a SM, or beyond 65,535 rows
    assert tt.row_form(8 * 132 - 1, 5, 132, kernel)[0] == "wide"
    assert tt.row_form(65_536, 1 << 20, 132, kernel)[0] == "short"


def test_row_wrappers_check_their_inputs():
    x = torch.zeros(3, 10)
    with pytest.raises(ValueError):
        pk.sum_maxabs_rows(torch.zeros(10), torch.zeros(10))      # flat
    with pytest.raises(TypeError):
        pk.sum_maxabs_rows(x.double(), x.double())
    with pytest.raises(ValueError):
        pk.sum_maxabs_rows(x, torch.zeros(3, 11))
    with pytest.raises(ValueError):
        pk.sum_maxabs_rows(torch.zeros(0, 10), torch.zeros(0, 10))
    with pytest.raises(ValueError):
        pk.sum_maxabs_rows(torch.zeros(3, 20)[:, ::2], x)         # strided
    with pytest.raises(ValueError):
        pk.histogram_rows(x, torch.zeros(2))
    with pytest.raises(ValueError):
        pk.maxabs_rows(torch.zeros(10))                           # flat
    with pytest.raises(TypeError):
        pk.maxabs_rows(x.double())
    with pytest.raises(ValueError):
        pk.maxabs_rows(torch.zeros(0, 10))
    with pytest.raises(ValueError):
        pk.maxabs_rows(torch.zeros(3, 20)[:, ::2])                # strided
    thr5 = torch.zeros(3, 5)
    with pytest.raises(ValueError):
        pk.sparsify_ef_rows(x, x, thr5, torch.ones(3, 5, dtype=torch.int32))
    with pytest.raises(ValueError):
        pk.sparsify_ef_rows(x, x, torch.zeros(3, 2),
                            torch.ones(3, 3, dtype=torch.int32))
