"""The port's sharded engine (``engine="sharded"``) over torch.distributed.

The oracle is the port's batched engine, which tests/test_torch_fl_batched.py
holds against the reference's.  Under ``server_reduce="gather"`` the
sharded History is bitwise the batched one; under "psum" loss and
``uplink_mb`` stay within the reference's 1e-4 (tests/test_sharded.py:82-91).

* World 1, in this process (a one-rank gloo group of the mesh's own): the
  four modes bitwise the batched engine, and ``lgc`` against the
  reference's ``ShardedEngine`` on a one-device host mesh at the tolerance
  tests/test_torch_fl_batched.py holds the batched engines to.
* World 2: one module fixture spawns two gloo ranks
  (``repro_torch.launch.mesh.spawn``), which run every case of ``CASES``
  (``launch.sharded_runs``) while this process runs the same cases on the
  unsharded batched engine: the four modes, heterogeneous gaps (ragged
  sync sets, boundaries where a rank holds no syncing row), a per_device
  DDPG fleet, diloco and semi_sync under both reduces, psum, and the
  population with a dense and an int8 store (N = 4,096, M = 8, 3
  windows; the touched devices' EF rows, carries and spend bitwise).
* The refusals, the mesh helpers, and ``core.convergence`` against the
  reference's.
"""
import concurrent.futures
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core.fl as jfl  # noqa: E402
from repro.core import convergence as jconv  # noqa: E402
from repro.launch.mesh import make_host_mesh as j_make_host_mesh  # noqa: E402
from repro.models.paper_models import make_task as j_make_task  # noqa: E402
import repro_torch.core.fl as pfl  # noqa: E402
from repro_torch.core import convergence as pconv  # noqa: E402
from repro_torch.core import population as ppop  # noqa: E402
from repro_torch.core.fl_batched import ShardedEngine  # noqa: E402
from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.launch import mesh as pmesh  # noqa: E402
from repro_torch.launch import sharded_runs as runs  # noqa: E402
from repro_torch.models.paper_models import make_task  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402

MODES = ["lgc", "fedavg", "topk", "lgc_q8"]
M = 4                    # the tests/test_fl.py:20 fixture, two rows a rank


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cases() -> list:
    c, p = runs.sim_case, runs.population_case
    cases = [c(mode, mode=mode) for mode in MODES]
    cases.append(c("hetero gaps", hs=[2 + m % 5 for m in range(M)],
                   ks=[200, 300, 400], rounds=25, eval_every=8,
                   cfg={"max_gap": 6}))
    cases.append(c("ddpg per_device", fleet="ddpg", rounds=24, eval_every=8,
                   cfg={"max_gap": 4, "scenario": "hetero_fleet",
                        "action_space": "per_device",
                        "pipeline_decisions": True}))
    for agg in ("diloco", "semi_sync"):
        for reduce in ("gather", "psum"):
            cases.append(c(f"{agg} {reduce}", server_reduce=reduce,
                           cfg={"aggregator": agg}))
    cases.append(c("lgc psum", server_reduce="psum", rounds=20,
                   eval_every=10))
    cases += [p("population dense"), p("population int8", store="int8")]
    return cases


CASES = _cases()
BY_NAME = {case["name"]: case for case in CASES}


@pytest.fixture(scope="module")
def world2():
    """Each case on two spawned gloo ranks and, meanwhile, unsharded here."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(pmesh.spawn, runs.rank_main, 2, "gloo",
                            (CASES, "cpu"), 300.0)
        unsharded = {case["name"]: runs.run_case(case, "batched")
                     for case in CASES}
        return ranks.result(), unsharded


# ---------------------------------------------------------------------------
# world 1, in this process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
def test_world1_is_bitwise_the_batched_engine(mode):
    case = runs.sim_case(mode, mode=mode)
    want = runs.run_case(case, "batched")
    got = runs.run_case(case, "sharded")
    assert got["hist"] == want["hist"]
    assert got["decision_log"] == want["decision_log"]
    assert all(v == 0 for v in got["launches"].values())  # plain versions


def test_world1_lgc_matches_the_reference_sharded_engine():
    tj = j_make_task("lr_mnist", m_devices=M, n_train=1200)
    tp = make_task("lr_mnist", m_devices=M, n_train=1200)
    p0 = jax.tree_util.tree_map(np.asarray, tj.init(jax.random.PRNGKey(0)))
    tj.init = lambda key: jax.tree_util.tree_map(jnp.asarray, p0)
    pp = params_from_jax(p0)
    tp.init = lambda key: {k: v.clone() for k, v in pp.items()}
    kw = dict(rounds=12, eval_every=4)
    hj = jfl.run_baseline(tj, jfl.FLConfig(**kw), "lgc", engine="sharded",
                          mesh=j_make_host_mesh(1))
    sim = pfl.baseline_simulator(tp, pfl.FLConfig(**kw), "lgc",
                                 engine="sharded", device="cpu")
    hp = sim.run()
    assert isinstance(sim.batched_engine, ShardedEngine)
    assert sim.batched_engine.mesh.size == 1
    assert hp.step == hj.step and hp.uplink_mb == hj.uplink_mb
    np.testing.assert_allclose(hp.loss, hj.loss, atol=1e-4)
    np.testing.assert_allclose(hp.accuracy, hj.accuracy, atol=1e-4)
    for field in ("energy_j", "money", "time_s", "server_wall_s"):
        np.testing.assert_allclose(getattr(hp, field), getattr(hj, field),
                                   rtol=1e-5)


def test_world1_collectives_and_mesh():
    mesh = pmesh.make_host_mesh(device="cpu")
    assert (mesh.size, mesh.rank, mesh.transport) == (1, 0, "gloo")
    assert mesh.shape == {"data": 1, "model": 1}
    assert pmesh.fl_axis_name(mesh) == "data"
    assert not torch.distributed.is_initialized()     # its own group
    x = torch.arange(12, dtype=torch.float32).reshape(3, 4) - 5.5
    assert torch.equal(pmesh.all_gather_rows(mesh, x), x)
    assert torch.equal(pmesh.psum(mesh, x), x)
    pod = pmesh.Mesh(None, {"pod": 2, "data": 1, "model": 1}, 0,
                     torch.device("cpu"), "gloo")
    assert pmesh.fl_axis_name(pod) == "pod"


# ---------------------------------------------------------------------------
# world 2, two spawned gloo ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(BY_NAME))
def test_world2_matches_the_unsharded_engine(world2, name):
    ranks, unsharded = world2
    case = BY_NAME[name]
    assert [r["rank"] for r in ranks] == [0, 1]
    assert {r["transport"] for r in ranks} == {"gloo"}
    r0, r1 = (r["results"][name] for r in ranks)
    assert r0["hist"] == r1["hist"]                 # every rank alike
    for got in (r0, r1):
        assert runs.compare(case, got, unsharded[name]) == []
        assert all(v == 0 for v in got["launches"].values())
    if case["server_reduce"] == "gather":
        assert r0["hist"] == unsharded[name]["hist"]
    if case["kind"] == "population":
        assert r0["ef"].tobytes() == unsharded[name]["ef"].tobytes()
        assert (r0["participation"] > 0).sum() > 0
    else:
        assert r0["decision_log"] == unsharded[name]["decision_log"]


def test_world2_gaps_leave_a_rank_without_syncing_rows(world2):
    """The gaps 2, 3, 4, 5 sync devices {0, 1} of rank 0 alone at some
    boundaries: rank 1 then enters the gather with no row of its own."""
    _, unsharded = world2
    log = unsharded["hetero gaps"]["decision_log"]
    by_t: dict = {}
    for t, m, _, _ in log:
        if t > 0:
            by_t.setdefault(t, set()).add(m)
    assert any(ms <= {0, 1} for ms in by_t.values())
    assert any(ms & {0, 1} and ms & {2, 3} for ms in by_t.values())


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def _fake_mesh(**shape) -> pmesh.Mesh:
    """A mesh of more ranks than are present: enough for the checks that
    run before any collective."""
    return pmesh.Mesh(None, shape, 0, torch.device("cpu"), "gloo")


def test_refusals():
    tp = make_task("lr_mnist", m_devices=3, n_train=600)
    cfg = pfl.FLConfig(rounds=4)
    with pytest.raises(ValueError, match="do not divide"):
        pfl.run_baseline(tp, cfg, "lgc", engine="sharded", device="cpu",
                         mesh=_fake_mesh(data=2, model=1))
    with pytest.raises(ValueError, match="server_reduce"):
        pfl.run_baseline(tp, cfg, "lgc", engine="sharded", device="cpu",
                         server_reduce="allgather")
    with pytest.raises(NotImplementedError, match="A12"):
        pfl.run_baseline(tp, cfg, "lgc", engine="sharded", device="cpu",
                         mesh=_fake_mesh(data=1, model=3))
    pop = ppop.make_population(ppop.make_population_task(), 64,
                               device="cpu")
    with pytest.raises(ValueError, match="does not divide"):
        ppop.run_population(pop, dataclasses.replace(cfg), m_cohort=3,
                            engine="sharded", mesh=_fake_mesh(data=2,
                                                              model=1))
    with pytest.raises(ValueError) as exc:
        pmesh.make_host_mesh(1, model=3, device="cpu")
    assert "mesh" in str(exc.value) and "1" in str(exc.value)
    with pytest.raises(ValueError, match="ranks present"):
        pmesh.make_host_mesh(2, device="cpu")


# ---------------------------------------------------------------------------
# core.convergence
# ---------------------------------------------------------------------------

CONSTS = dict(mu=0.5, l_smooth=4.0, g2=25.0, sigma2=4.0, b=64, m=3,
              gamma=0.05, h=4, w0_dist2=10.0)


def test_theorem_bounds():
    """tests/test_fl.py::TestTheoremBounds on the port."""
    c = pconv.ProblemConstants(**CONSTS)
    assert pconv.theorem1_bound(c, 500) > pconv.theorem1_bound(c, 5000) > 0
    loose = dataclasses.replace(c, h=16)
    assert pconv.theorem1_bound(loose, 1000) > pconv.theorem1_bound(c, 1000)
    r1, r2 = pconv.corollary1_rate(c, 1000), pconv.corollary1_rate(c, 10_000)
    assert r1 > r2 > 0 and r1 / r2 > 5


@pytest.mark.parametrize("fields,t", [
    ({}, 500), ({"h": 16, "gamma": 0.2}, 1000),
    ({"mu": 2.0, "m": 64, "b": 8, "gamma": 1e-7}, 3000)])
def test_convergence_equals_the_reference(fields, t):
    kw = CONSTS | fields
    c_p, c_j = pconv.ProblemConstants(**kw), jconv.ProblemConstants(**kw)
    assert pconv.theorem1_bound(c_p, t) == jconv.theorem1_bound(c_j, t)
    assert pconv.corollary1_rate(c_p, t) == jconv.corollary1_rate(c_j, t)
