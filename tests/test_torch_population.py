"""The port's population layer held against ``repro.core.population``.

* Cohort sampling: ``prng.permutation`` / ``gumbel`` / ``xla_sum`` /
  ``choice`` and ``sample_cohort`` (uniform, and weighted with zero
  weights) bitwise jax's at N in {100, 4,096, 100,000} over several
  (seed, t); the stable sort of the shuffle on keys that tie, and the
  lower-index-first order of ``lax.top_k`` among equal values.
* The EF stores bitwise the reference's numpy stores over one sequence of
  gathers and scatters, subnormal residuals left unflushed, ``nbytes``
  equal; ``init_carry_rows`` bitwise the reference's vmapped
  ``init_carry``; the partition helpers and the population task's data.
* ``run_population`` at the reference test's size (population task,
  N = 100,000, M = 64, 8 rounds, tests/test_population.py:44-51) from the
  reference's initial params: cohort ids, participation and uplink exact,
  History at rtol 1e-5 / atol 1e-6, under the dense store (static and
  gilbert_flaky), int8 and server, ``backend="cuda"`` (the row kernels'
  plain versions; the reference's Pallas kernels in interpret mode), the
  other modes, a per-layer policy, diloco and semi_sync; the loop engine
  bitwise the batched one; a run from a mid-run state carried across by
  ``weights.population_from_jax``, so the stores are read back;
* the refusals: the sharded engine (A12), the seed, scenario, channel and
  sampler checks, and no CPU fallback without ``device``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402

from repro.core import FLConfig as JFLConfig  # noqa: E402
from repro.core import error_feedback as jef  # noqa: E402
from repro.core import population as jpop  # noqa: E402
from repro.core import scenario as jscn  # noqa: E402
from repro.data import partition as jpart  # noqa: E402
from repro_torch.core import FLConfig  # noqa: E402
from repro_torch.core import error_feedback as pef  # noqa: E402
from repro_torch.core import population as ppop  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core import scenario as pscn  # noqa: E402
from repro_torch.data import partition as ppart  # noqa: E402
from repro_torch.weights import params_from_jax, population_from_jax  # noqa: E402

N_POP = 100_000
M_COHORT = 64
TINY = np.float32(2.0 ** -149)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: a 100,000-element threefry draw
    is a few hundred small parallel regions, and with the suite's workers
    sharing the cores OpenMP's barriers wait on descheduled threads
    (seconds a draw instead of tens of ms).  Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


# ---------------------------------------------------------------------------
# cohort sampling
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [7, 1625, 1626, 4096, N_POP])
def test_permutation_and_gumbel_match_jax(n):
    """Both shuffle round counts (1 up to n = 1,625, 2 above) and the
    Gumbel draw, bitwise."""
    for seed in ((0, 3) if n < N_POP else (3,)):
        kj, kp = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
        np.testing.assert_array_equal(prng.permutation(kp, n).numpy(),
                                      np.asarray(jax.random.permutation(kj,
                                                                        n)))
        np.testing.assert_array_equal(
            _bits(prng.gumbel(kp, (n,)).numpy()),
            _bits(jax.random.gumbel(kj, (n,))))


def test_shuffle_rounds_and_ties_at_the_population_size():
    """jax's round count, and the 100k draws really hold tied 32-bit keys
    (about n^2 / 2^33 a round) that the stable sort must order as
    ``lax.sort_key_val`` does: the permutations above are bitwise jax's."""
    assert [prng.shuffle_rounds(n) for n in (1, 1625, 1626, N_POP)] == [
        0, 1, 2, 2]
    ties = 0
    for seed in range(4):
        key = prng.PRNGKey(seed)
        for _ in range(prng.shuffle_rounds(N_POP)):
            key, sub = prng.split(key)
            bits = prng.random_bits(sub, (N_POP,))
            ties += N_POP - int(torch.unique(bits).numel())
    assert ties > 0


def test_stable_sort_and_top_k_order_ties_as_lax():
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 5, 2000).astype(np.uint32)       # many ties
    vals = np.arange(2000, dtype=np.int32)
    _, want = lax.sort_key_val(jnp.asarray(keys), jnp.asarray(vals))
    got = torch.sort(torch.from_numpy(keys.astype(np.int64)),
                     stable=True).indices
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    x = rng.integers(-3, 3, 3000).astype(np.float32)
    x[::7] = -np.inf
    got = prng.top_k_indices(torch.from_numpy(x), 500)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(lax.top_k(jnp.asarray(x),
                                                       500)[1]))


@pytest.mark.parametrize("n", [2, 31, 33, 100, 1025, 33_333, N_POP])
def test_xla_sum_matches_jnp_sum(n):
    rng = np.random.default_rng(n)
    for w in (rng.random(n), rng.lognormal(0, 3, n) * (rng.random(n) < .7)):
        w = w.astype(np.float32)
        assert (_bits(prng.xla_sum(torch.from_numpy(w)).numpy())
                == _bits(np.float32(jnp.sum(jnp.asarray(w)))))


@pytest.mark.parametrize("n", [100, 4096, N_POP])
@pytest.mark.parametrize("sampler", ["uniform", "weighted"])
def test_sample_cohort_matches_reference(n, sampler):
    rng = np.random.default_rng(n)
    w = None
    if sampler == "weighted":
        w = rng.random(n) * rng.lognormal(0, 2, n)
        w[rng.random(n) < 0.3] = 0.0
    m = min(M_COHORT, n // 2)
    for seed, t in ((0, 0), (0, 4), (1, 8), (7, 1000), (3, 12), (11, 96),
                    (2 ** 31 - 1, 4), (5, 20)):
        want = jpop.sample_cohort(jax.random.PRNGKey(seed), sampler, n, m,
                                  t, w)
        got = ppop.sample_cohort(prng.PRNGKey(seed), sampler, n, m, t, w)
        assert got.dtype == np.int64
        np.testing.assert_array_equal(got, want)
        if w is not None:
            assert (w[got] > 0).all()


# ---------------------------------------------------------------------------
# stores, carries, partition helpers, the task
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", sorted(jef.EF_STORES))
def test_stores_match_reference_bitwise(kind):
    """One sequence of cohort gathers and scatters through both stores, at
    scales down into the subnormals (left unflushed, as numpy leaves
    them), with -0.0 entries, all-zero rows and an int8 row whose maximum
    is 150 * 2^-149, whose codes leave int8's range and wrap as numpy's
    cast wraps."""
    n, d, m = 40, 37, 8
    a, b = jef.make_ef_store(kind, n, d), pef.make_ef_store(kind, n, d)
    assert a.nbytes == b.nbytes
    assert b.name == kind and pef.EF_STORES[kind] is type(b)
    rng = np.random.default_rng(1)
    scales = [1.0, 1e-37, 1e-39, 1e-44, 0.0, 1e30]
    for step in range(24):
        ids = rng.choice(n, m, replace=False)
        got = b.gather(torch.from_numpy(ids) if step % 2 else ids)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(_bits(got.numpy()),
                                      _bits(a.gather(ids)))
        ef = (rng.standard_normal((m, d)) * scales[step % 6]).astype(
            np.float32)
        ef[0, :3] = -0.0
        if step % 5 == 0:
            ef[1] = 0.0
        if step % 4 == 0:
            ef[2] = rng.integers(-150, 151, d).astype(np.float32) * TINY
            ef[2, 0] = 150 * TINY
        a.scatter(ids, ef)
        b.scatter(ids, torch.from_numpy(ef))
    np.testing.assert_array_equal(_bits(b.gather(np.arange(n)).numpy()),
                                  _bits(a.gather(np.arange(n))))


def test_make_ef_store_rejects_unknown():
    with pytest.raises(ValueError, match="unknown EF store"):
        pef.make_ef_store("fp16", 4, 4)


@pytest.mark.parametrize("name", ["gilbert_flaky", "markov_urban"])
def test_init_carry_rows_matches_vmapped_init_carry(name):
    sj, sp = jscn.get_scenario(name), pscn.get_scenario(name)
    want = jax.vmap(lambda i: jscn.init_carry(sj, jax.random.PRNGKey(1), i,
                                              3))(
        jnp.arange(N_POP, dtype=jnp.int32))
    got = pscn.init_carry_rows(sp, prng.PRNGKey(1), torch.arange(N_POP), 3)
    np.testing.assert_array_equal(_bits(got.bw_log.numpy()),
                                  _bits(want.bw_log))
    np.testing.assert_array_equal(got.good.numpy(), np.asarray(want.good))
    one = pscn.init_carry(sp, prng.PRNGKey(1), 99_999, 3)
    assert torch.equal(one.bw_log, got.bw_log[-1])
    assert torch.equal(one.good, got.good[-1])


def test_partition_helpers_and_population_task_match_reference():
    tj = jpop.make_population_task(n_shards=8, n_train=1024, seed=0,
                                   partition="dirichlet", alpha=0.3)
    tp = ppop.make_population_task(n_shards=8, n_train=1024, seed=0,
                                   partition="dirichlet", alpha=0.3)
    for (xa, ya), (xb, yb) in zip(tj.device_data, tp.device_data):
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ya, yb)
    np.testing.assert_array_equal(tj.eval_data[0], tp.eval_data[0])
    assert tj.name == tp.name
    np.testing.assert_array_equal(
        ppart.label_marginals(tp.device_data),
        jpart.label_marginals(tj.device_data))
    assert ppart.skew_score(tp.device_data) == jpart.skew_score(
        tj.device_data)
    ids = np.arange(1000) * 37
    np.testing.assert_array_equal(ppart.shard_for_device(ids, 8),
                                  jpart.shard_for_device(ids, 8))
    with pytest.raises(ValueError, match="at least one shard"):
        ppart.shard_for_device(ids, 0)


# ---------------------------------------------------------------------------
# run_population against the reference
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tasks():
    """(reference task, port task) of the reference test's fixture, with
    the reference's initial params on both sides."""
    tj = jpop.make_population_task(n_shards=8, n_train=1024, seed=0)
    tp = ppop.make_population_task(n_shards=8, n_train=1024, seed=0)
    p0 = jax.tree_util.tree_map(np.asarray, tj.init(jax.random.PRNGKey(0)))
    tj.init = lambda key: jax.tree_util.tree_map(jnp.asarray, p0)
    pp = params_from_jax(p0)
    tp.init = lambda key: {k: v.clone() for k, v in pp.items()}
    return tj, tp


def _record_ids(monkeypatch, mod) -> list:
    seen = []
    draw = mod.sample_cohort

    def recorded(*a, **k):
        ids = draw(*a, **k)
        seen.append(np.asarray(ids).copy())
        return ids
    monkeypatch.setattr(mod, "sample_cohort", recorded)
    return seen


def _assert_history(hp, hj):
    assert hp.step == hj.step
    assert hp.uplink_mb == hj.uplink_mb
    for k in ("loss", "accuracy", "energy_j", "money", "time_s",
              "server_wall_s"):
        np.testing.assert_allclose(getattr(hp, k), getattr(hj, k),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def _pair(monkeypatch, tasks, *, store="dense", scenario=None, mode="lgc",
          backend=None, **cfg_kw):
    """Both packages' 8-round runs from fresh populations: (port pop,
    reference pop), cohort ids, participation and History already held.  ``backend="cuda"`` runs the row kernels' plain
    versions here and the reference's Pallas kernels in interpret mode."""
    tj, tp = tasks
    ids_j = _record_ids(monkeypatch, jpop)
    ids_p = _record_ids(monkeypatch, ppop)
    kw = dict(rounds=8, eval_every=4, scenario=scenario or "static",
              **cfg_kw)
    pj = jpop.make_population(tj, N_POP, ef_store=store, scenario=scenario)
    hj = jpop.run_population(pj, JFLConfig(**kw), mode, h=4,
                             m_cohort=M_COHORT,
                             backend="pallas" if backend == "cuda" else backend)
    pp = ppop.make_population(tp, N_POP, ef_store=store, scenario=scenario,
                              device="cpu")
    hp = ppop.run_population(pp, FLConfig(**kw), mode, h=4,
                             m_cohort=M_COHORT, backend=backend)
    assert len(ids_p) == len(ids_j) == 2
    for a, b in zip(ids_p, ids_j):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(pp.participation, pj.participation)
    _assert_history(hp, hj)
    return pp, pj


@pytest.mark.parametrize("store,scenario", [("dense", None),
                                            ("dense", "gilbert_flaky"),
                                            ("int8", None),
                                            ("server", None)])
def test_run_population_matches_reference(monkeypatch, tasks, store,
                                          scenario):
    pp, pj = _pair(monkeypatch, tasks, store=store, scenario=scenario)
    assert pp.ef_nbytes == pj.ef_nbytes
    np.testing.assert_array_equal(_bits(pp.carry_bw), _bits(pj.carry_bw))
    np.testing.assert_array_equal(pp.carry_good, pj.carry_good)
    np.testing.assert_allclose(pp.spend, pj.spend, rtol=1e-5, atol=1e-9)
    ef_p = pp.ef_store.gather(np.arange(pp.n)).numpy()
    ef_j = np.asarray(pj.ef_store.gather(np.arange(pj.n)))
    assert (ef_j != 0).any()
    np.testing.assert_allclose(ef_p, ef_j, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mode,cfg_kw", [
    ("lgc", {"backend": "cuda"}),
    ("lgc", {"backend": "cuda", "layer_policy": "size_prop"}),
    ("topk", {}), ("fedavg", {}), ("lgc_q8", {}),
    ("lgc", {"aggregator": "diloco"}),
    ("lgc", {"aggregator": "semi_sync", "staleness_cap": 2}),
])
def test_run_population_modes_backends_and_servers(monkeypatch, tasks, mode,
                                                   cfg_kw):
    _pair(monkeypatch, tasks, mode=mode, **cfg_kw)


def test_loop_engine_is_bitwise_the_batched_engine(tasks):
    """M single-row blocks against one (M, .) block, on a population small
    enough that devices sit in both cohorts (the int8 store is read back):
    History, store and spend bitwise."""
    _, tp = tasks
    out = {}
    for engine in ("batched", "loop"):
        pop = ppop.make_population(tp, 40, ef_store="int8",
                                   scenario="gilbert_flaky", device="cpu")
        cfg = FLConfig(rounds=8, eval_every=4, scenario="gilbert_flaky")
        hist = ppop.run_population(pop, cfg, "lgc", h=4, m_cohort=16,
                                   engine=engine, backend="cuda")
        out[engine] = (hist.asdict(), pop)
    (hb, pb), (hl, pl) = out["batched"], out["loop"]
    assert hb == hl
    assert (pb.participation > 1).any()
    assert torch.equal(pb.ef_store._codes, pl.ef_store._codes)
    np.testing.assert_array_equal(_bits(pb.ef_store._scale.numpy()),
                                  _bits(pl.ef_store._scale.numpy()))
    np.testing.assert_array_equal(pb.spend, pl.spend)


@pytest.mark.parametrize("store", ["int8", "server"])
def test_run_on_from_a_state_carried_across(monkeypatch, tasks, store):
    """A mid-run state (every store row written through the reference
    store's own scatter, down to subnormal scales; chain carries, spend and
    participation drawn) goes into a port population
    (``population_from_jax``), and both run the same 8 rounds from it, so
    the cohorts read the rows written before the run."""
    tj, tp = tasks
    kw = dict(rounds=8, eval_every=4, scenario="gilbert_flaky")
    pj = jpop.make_population(tj, N_POP, ef_store=store,
                              scenario="gilbert_flaky")
    rng = np.random.default_rng(5)
    ef = rng.standard_normal((N_POP, pj.d)).astype(np.float32)
    ef *= np.float32(1e-3) ** rng.integers(0, 14, (N_POP, 1))
    pj.ef_store.scatter(np.arange(N_POP), ef)
    pj.carry_bw = (rng.standard_normal(pj.carry_bw.shape)
                   * 0.3).astype(np.float32)
    pj.carry_good = rng.random(pj.carry_good.shape) < 0.8
    pj.spend = rng.random(pj.spend.shape)
    pj.participation = rng.integers(0, 3, N_POP)
    start = pj.participation.copy()
    pp = ppop.make_population(tp, N_POP, ef_store=store,
                              scenario="gilbert_flaky", device="cpu")
    population_from_jax(pj, pp)
    every = np.arange(N_POP)
    np.testing.assert_array_equal(
        _bits(pp.ef_store.gather(every).numpy()),
        _bits(pj.ef_store.gather(every)))
    assert pp.spend.dtype == np.float64 and pp.carry_bw.dtype == np.float32
    hj = jpop.run_population(pj, JFLConfig(**kw), "lgc", h=4,
                             m_cohort=M_COHORT)
    hp = ppop.run_population(pp, FLConfig(**kw), "lgc", h=4,
                             m_cohort=M_COHORT)
    _assert_history(hp, hj)
    np.testing.assert_array_equal(pp.participation, pj.participation)
    ids = np.flatnonzero(pp.participation != start)
    assert 0 < ids.size <= 2 * M_COHORT
    np.testing.assert_allclose(pp.ef_store.gather(ids).numpy(),
                               np.asarray(pj.ef_store.gather(ids)),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(pp.spend, pj.spend, rtol=1e-5, atol=1e-9)


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def test_run_population_refusals(tasks):
    _, tp = tasks
    pop = ppop.make_population(tp, 1000, device="cpu")
    with pytest.raises(ValueError, match="unknown population engine"):
        ppop.run_population(pop, FLConfig(rounds=4), engine="warp")
    sharded = ppop.run_population(pop, FLConfig(rounds=4), engine="sharded")
    assert sharded.step == [0, 3]
    with pytest.raises(ValueError, match="seed"):
        ppop.run_population(pop, FLConfig(rounds=4, seed=3))
    with pytest.raises(ValueError, match="conflicts"):
        ppop.run_population(pop, FLConfig(rounds=4,
                                          scenario="gilbert_flaky"))
    with pytest.raises(ValueError, match="channels"):
        ppop.run_population(pop, FLConfig(rounds=4,
                                          channels=FLConfig().channels[:2]))
    with pytest.raises(ValueError, match="unknown mode"):
        ppop.run_population(pop, FLConfig(rounds=4), "sgd")
    with pytest.raises(ValueError, match="layer_policy"):
        ppop.run_population(pop, FLConfig(rounds=4, layer_policy="bogus"))


def test_make_population_and_sample_cohort_refusals(tasks, monkeypatch):
    _, tp = tasks
    with pytest.raises(ValueError, match="smaller than"):
        ppop.make_population(tp, 4, device="cpu")
    with pytest.raises(ValueError, match="unknown EF store"):
        ppop.make_population(tp, 100, ef_store="fp16", device="cpu")
    with pytest.raises(ValueError, match="unknown cohort sampler"):
        ppop.make_population(tp, 100, sampler="greedy", device="cpu")
    with pytest.raises(ValueError, match="weights shape"):
        ppop.make_population(tp, 100, weights=np.ones(99), device="cpu")
    base = prng.PRNGKey(0)
    with pytest.raises(ValueError, match="not in"):
        ppop.sample_cohort(base, "uniform", 10, 11, 0)
    with pytest.raises(ValueError, match="unknown cohort sampler"):
        ppop.sample_cohort(base, "greedy", 10, 2, 0)
    with pytest.raises(ValueError, match="needs per-device weights"):
        ppop.sample_cohort(base, "weighted", 10, 2, 0)
    with pytest.raises(ValueError, match="non-negative"):
        ppop.sample_cohort(base, "weighted", 3, 1, 0, np.array([1., -1, 1]))
    with pytest.raises(ValueError, match="exceeds"):
        ppop.sample_cohort(base, "weighted", 3, 2, 0, np.array([1., 0, 0]))
    assert sorted(ppop.COHORT_SAMPLERS) == sorted(jpop.COHORT_SAMPLERS)
    # the card by default, and no CPU fallback without it
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ppop.make_population(tp, 100)
