"""The port's per-layer budgets (ROADMAP A8) held against the JAX reference.

The reference's per-layer section (``repro/core/compressor.py:198-411``)
and the port's get the same f32 inputs, made with numpy from a seed:

* ``tree_layer_slices`` equal (names and edges), also on the CNN, whose
  ``w1`` starts at float 4,938, and with ``skip_leading_axes``;
* ``_topb_mask`` equal under heavy ties (integer magnitudes), flat and by
  rows;
* ``layer_budgets`` equal under ``uniform`` and ``size_prop``, and under
  ``divergence`` on seeds where every quota and every remainder the
  rounding compares sits further from its neighbour than f32 rounding can
  move it (the reference and ATen sum ||u_l||^2 in different orders, so a
  budget may move by one coordinate where two remainders are within
  rounding; the test asserts the margin before it compares);
* ``per_layer_compress`` bitwise for every policy; ``per_layer_wire_bytes``
  equal;
* the histogram path's statistics: the plain segmented maxabs and counts
  (``ref.hist_maxabs_segments`` / ``hist_counts_segments``) bitwise the
  reference's per-slice oracles, and the candidate mask of
  ``kernels.per_layer_candidates_hist_rows`` (its plain versions on the
  CPU) bitwise ``per_layer_candidates_hist``, both with the oracles
  (``pallas_min_elems=10**9``) and with a slice routed through the Pallas
  kernels in interpret mode, with a zero slice and at a subnormal scale.

Within the port ``uniform`` equals ``global`` bitwise on the exact backend
(History and params, both engines).  Both engines run ``size_prop`` and
``divergence`` on the tests/test_fl.py:20 fixture (lr, M=3, n_train 1200)
against the reference's engine of the same kind on each backend: ``step``
equal, loss and accuracy at rtol 1e-5; uplink and the cost fields (energy,
money, time, server wall-clock) equal to the reference's loop engine,
which prices on the host as both of the port's engines do.  The CUDA
segmented kernels are held against these plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core.fl as jfl  # noqa: E402
from repro.core import compressor as jcomp  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models.paper_models import make_task as j_make_task  # noqa: E402
import repro_torch.core.fl as pfl  # noqa: E402
from repro_torch import kernels as pk  # noqa: E402
from repro_torch.core import compressor as pcomp  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.kernels import ref as pref  # noqa: E402
from repro_torch.models.paper_models import make_task  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402

POLICIES = ("uniform", "size_prop", "divergence")
J_TREE = {"a": jnp.zeros((40, 5)), "b": jnp.zeros((64,)),
          "c": {"w": jnp.zeros((12, 8))}}
P_TREE = {"a": torch.zeros(40, 5), "b": torch.zeros(64),
          "c/w": torch.zeros(12, 8)}
SLICES = jcomp.tree_layer_slices(J_TREE)
TABLE = pcomp.layer_table(SLICES, "cpu")            # the port's form of them
D = SLICES[-1][2]
K_TOTALS = (1, 37, 150, D)
# divergence: seeds whose quotas and remainders clear f32 rounding (asserted)
DIVERGENCE_SEEDS = (0, 1, 2, 4)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: its runs are thousands of small
    torch ops, which several threads slow down many times over when other
    test processes share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _vec(n: int, seed: int, ties: bool = False) -> np.ndarray:
    x = np.random.default_rng(seed).standard_normal(n).astype(np.float32)
    return np.round(x * 2.0).astype(np.float32) if ties else x


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def _bitwise(got: torch.Tensor, want, msg=""):
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape and got.dtype == want.dtype, msg
    if got.dtype == np.float32:
        got, want = got.view(np.int32), want.view(np.int32)
    np.testing.assert_array_equal(got, want, err_msg=msg)


# ---------------------------------------------------------------------------
# slices, masks, budgets, compression
# ---------------------------------------------------------------------------

def test_tree_layer_slices_match_the_reference():
    assert pcomp.tree_layer_slices(P_TREE) == SLICES
    stacked = {k: torch.zeros((7,) + tuple(v.shape))
               for k, v in P_TREE.items()}
    assert pcomp.tree_layer_slices(stacked, skip_leading_axes=1) == SLICES
    tj = j_make_task("cnn_mnist", m_devices=2, n_train=100)
    tp = make_task("cnn_mnist", m_devices=2, n_train=100)
    want = jcomp.tree_layer_slices(tj.init(jax.random.PRNGKey(0)))
    got = pcomp.tree_layer_slices(tp.init(prng.PRNGKey(0)))
    assert got == want
    assert [n for n, _, _ in got] == [f"['{k}']" for k in (
        "b1", "b2", "bw1", "bw2", "c1", "c2", "w1", "w2")]
    assert got[6][1:] == (4938, 4938 + 200_704) and got[-1][2] == 206_922


@pytest.mark.parametrize("b", [0, 1, 5, 17, 40, 100, 359, 360, 400])
def test_topb_mask_matches_the_reference_under_ties(b):
    a = np.abs(_vec(D, 11, ties=True))          # integer magnitudes: ties
    want = np.asarray(jcomp._topb_mask(jnp.asarray(a), jnp.int32(b), D))
    _bitwise(pcomp._topb_mask(_t(a), b, D), want)
    # by rows, each row its own budget, and a cap below D
    rows = np.stack([a, a[::-1].copy(), np.abs(_vec(D, 12, ties=True))])
    bs = [b, max(b - 3, 0), min(b + 7, D)]
    got = pcomp._topb_mask(_t(rows), _t(np.array(bs)), 400)
    for r in range(3):
        want = jcomp._topb_mask(jnp.asarray(rows[r]), jnp.int32(bs[r]), 400)
        _bitwise(got[r], np.asarray(want), f"row {r}")


@pytest.mark.parametrize("policy", ["uniform", "size_prop"])
@pytest.mark.parametrize("seed", [0, 3])
def test_budgets_match_the_reference_exactly(policy, seed):
    u = _vec(D, seed, ties=seed == 3)
    rows = []
    for k_total in K_TOTALS:
        want = np.asarray(jcomp.layer_budgets(policy, jnp.asarray(u), SLICES,
                                              jnp.int32(k_total), D))
        got = pcomp.layer_budgets(policy, _t(u), TABLE, k_total, D)
        _bitwise(got, want, f"k_total {k_total}")
        assert int(got.sum()) == k_total
        rows.append(want)
    # all the budgets at once, as (M, L) rows
    got = pcomp.layer_budgets(policy, _t(np.tile(u, (len(K_TOTALS), 1))),
                              TABLE, _t(np.array(K_TOTALS)), D)
    _bitwise(got, np.stack(rows))


def _divergence_margin(u: np.ndarray, k_total: int) -> float:
    """The smallest gap, in quota units, that f32 rounding must not close:
    each quota's distance to an integer, and the gap between the remainders
    on either side of the cut that hands out the extra coordinates."""
    norms = np.array([np.sqrt(np.sum(u[lo:hi].astype(np.float64) ** 2))
                      for _, lo, hi in SLICES])
    quota = k_total * norms / norms.sum()
    frac = quota - np.floor(quota)
    gaps = [np.min(np.minimum(frac, 1 - frac))]
    rem = k_total - int(np.floor(quota).sum())
    order = np.sort(frac)[::-1]
    if 0 < rem < len(order):
        gaps.append(order[rem - 1] - order[rem])
    return float(min(gaps))


@pytest.mark.parametrize("seed", DIVERGENCE_SEEDS)
def test_divergence_budgets_match_the_reference_exactly(seed):
    u = _vec(D, seed)
    rows = []
    for k_total in K_TOTALS:
        # f32 quotas are off by at most a few ulps of k_total
        assert _divergence_margin(u, k_total) > 1e-4, (seed, k_total)
        want = np.asarray(jcomp.layer_budgets(
            "divergence", jnp.asarray(u), SLICES, jnp.int32(k_total), D))
        _bitwise(pcomp.layer_budgets("divergence", _t(u), TABLE, k_total,
                                     D), want, f"k_total {k_total}")
        rows.append(want)
    got = pcomp.layer_budgets("divergence",
                              _t(np.tile(u, (len(K_TOTALS), 1))), TABLE,
                              _t(np.array(K_TOTALS)), D)
    _bitwise(got, np.stack(rows))


def test_divergence_follows_the_mass_and_unknown_policies_raise():
    u = np.zeros(D, np.float32)
    u[SLICES[1][1]:SLICES[1][2]] = 5.0
    got = pcomp.layer_budgets("divergence", _t(u), TABLE, 30, D)
    assert got.tolist() == [0, 30, 0]
    assert set(pcomp.LAYER_POLICIES) == set(jcomp.LAYER_POLICIES)
    with pytest.raises(ValueError, match="unknown layer policy"):
        pcomp.layer_budgets("nope", _t(u), TABLE, 30, D)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("seed", [0, 1, 7])
def test_per_layer_compress_matches_the_reference_bitwise(policy, seed):
    u = _vec(D, seed, ties=seed == 7)
    ks, recv = [20, 30, 40], [True, False, True]
    want = jcomp.per_layer_compress(jnp.asarray(u), jnp.asarray(ks, jnp.int32),
                                    jnp.asarray(recv), SLICES, policy, D)
    got = pcomp.per_layer_compress(_t(u), torch.tensor(ks),
                                   torch.tensor(recv), TABLE, policy, D)
    _bitwise(got, np.asarray(want))
    # as one of several rows, with the batched engine's smaller cap
    rows = np.stack([_vec(D, seed + 100), u])
    got = pcomp.per_layer_compress(_t(rows), torch.tensor([ks, ks]),
                                   torch.tensor([recv, recv]), TABLE,
                                   policy, 128)
    _bitwise(got[1], np.asarray(want))
    if policy == "uniform":      # bitwise the global path
        _bitwise(got, pcomp.lgc_compress_topk(
            _t(rows), torch.tensor([ks, ks]), torch.tensor([recv, recv]),
            128).numpy())


def test_per_layer_wire_bytes_match_the_reference():
    for budgets in ([20, 30, 40], [0, 1, 359], [7, 0, 0]):
        assert (pcomp.per_layer_wire_bytes(budgets, SLICES)
                == jcomp.per_layer_wire_bytes(budgets, SLICES))
    cnn = pcomp.tree_layer_slices(make_task("cnn_mnist", m_devices=1,
                                            n_train=50).init(prng.PRNGKey(0)))
    budgets = list(range(1, len(cnn) + 1))
    assert (pcomp.per_layer_wire_bytes(budgets, cnn, value_bytes=1)
            == jcomp.per_layer_wire_bytes(budgets, cnn, value_bytes=1))


# ---------------------------------------------------------------------------
# the histogram path: segmented statistics and the candidate mask
# ---------------------------------------------------------------------------

def _hist_rows(scale: float) -> np.ndarray:
    rows = np.stack([_vec(D, 20 + r) for r in range(3)]) * np.float32(scale)
    rows[1, SLICES[1][1]:SLICES[1][2]] = 0.0          # an all-zero slice
    return rows.astype(np.float32)


@pytest.mark.parametrize("scale", [1e-3, 1e-37])
def test_segmented_statistics_match_the_reference_oracles(scale):
    rows = _hist_rows(scale)
    offsets = [0] + [hi for _, _, hi in SLICES]
    mx = pref.hist_maxabs_segments(_t(rows), offsets)
    counts = pref.hist_counts_segments(_t(rows), mx, offsets)
    assert mx.shape == (3, 3) and counts.shape == (3, 3, 256)
    for r in range(3):
        for i, (_, lo, hi) in enumerate(SLICES):
            seg = jnp.asarray(rows[r, lo:hi])
            m = jref.hist_maxabs(seg)
            _bitwise(mx[r, i], np.asarray(m), f"maxabs {r} {i}")
            _bitwise(counts[r, i], np.asarray(jref.hist_counts(seg, m)),
                     f"counts {r} {i}")
    # the wrappers on CPU tensors are the plain versions
    _bitwise(pk.maxabs_segments(_t(rows), TABLE), mx.numpy())
    _bitwise(pk.histogram_segments(_t(rows), mx, TABLE), counts.numpy())
    assert pk.LAUNCHES["maxabs_segments"] == 0


@pytest.mark.parametrize("scale", [1e-3, 1e-37])
@pytest.mark.parametrize("policy", POLICIES)
def test_candidate_mask_matches_per_layer_candidates_hist(policy, scale):
    rows = _hist_rows(scale)
    k_totals = [90, 30, 150]
    budgets = pcomp.layer_budgets(policy, _t(rows), TABLE, _t(k_totals), D)
    got = pk.per_layer_candidates_hist_rows(_t(rows), TABLE, budgets)
    _bitwise(got, pref.hist_candidates_segments(_t(rows), TABLE.offsets,
                                                budgets).numpy())
    for r in range(3):
        b = jnp.asarray(budgets[r].numpy())
        want = jcomp.per_layer_candidates_hist(jnp.asarray(rows[r]), SLICES,
                                               b, pallas_min_elems=10 ** 9)
        _bitwise(got[r], np.asarray(want), f"row {r}")
    # one row with its largest slice through the Pallas kernels
    # (interpret mode): the reference's routing changes nothing
    want = jcomp.per_layer_candidates_hist(
        jnp.asarray(rows[0]), SLICES, jnp.asarray(budgets[0].numpy()),
        pallas_min_elems=150)
    _bitwise(got[0], np.asarray(want), "routed")


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------

def _ks(d: int) -> list[int]:
    k_total = max(1, d // 20)
    return [k_total // 2, k_total // 4, k_total - k_total // 2 - k_total // 4]


@pytest.fixture(scope="module")
def lr_tasks():
    """(reference task, port task): the tests/test_fl.py:20 fixture with
    the reference's initial params on both sides."""
    tj = j_make_task("lr_mnist", m_devices=3, n_train=1200)
    tp = make_task("lr_mnist", m_devices=3, n_train=1200)
    p0 = jax.tree_util.tree_map(np.asarray, tj.init(jax.random.PRNGKey(0)))
    tj.init = lambda key: jax.tree_util.tree_map(jnp.asarray, p0)
    pp = params_from_jax(p0)
    tp.init = lambda key: {k: v.clone() for k, v in pp.items()}
    return tj, tp


def _run(mod, task, engine, backend, policy, rounds=12):
    cfg = mod.FLConfig(rounds=rounds, eval_every=4, layer_policy=policy,
                       engine=engine)
    extra = {} if mod is jfl else {"device": "cpu"}
    sim = mod.LGCSimulator(task, cfg, [mod.FixedController(4, _ks(7850))
                                       for _ in range(3)],
                           backend=backend, **extra)
    return sim.run(), sim


@pytest.mark.parametrize("engine", ["loop", "batched"])
def test_uniform_equals_global_bitwise_on_the_exact_backend(lr_tasks,
                                                            engine):
    _, tp = lr_tasks
    hu, su = _run(pfl, tp, engine, "exact", "uniform")
    hg, sg = _run(pfl, tp, engine, "exact", "global")
    assert hu.asdict() == hg.asdict()
    for k in sg.params:
        _bitwise(su.params[k], sg.params[k].numpy(), k)


@pytest.mark.parametrize("backend", ["exact", "pallas"])
@pytest.mark.parametrize("policy", ["size_prop", "divergence"])
def test_engines_match_the_reference_engines(lr_tasks, policy, backend):
    tj, tp = lr_tasks
    h_ref = {e: _run(jfl, tj, e, backend, policy)[0]
             for e in ("loop", "batched")}
    for engine in ("loop", "batched"):
        hp, _ = _run(pfl, tp, engine, backend, policy)
        hj = h_ref[engine]
        assert hp.step == hj.step
        np.testing.assert_allclose(hp.loss, hj.loss, rtol=1e-5)
        np.testing.assert_allclose(hp.accuracy, hj.accuracy, rtol=1e-5)
        for field in ("uplink_mb", "energy_j", "money", "time_s",
                      "server_wall_s"):
            assert getattr(hp, field) == getattr(h_ref["loop"], field), \
                (engine, field)
