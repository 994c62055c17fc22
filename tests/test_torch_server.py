"""The port's server aggregation (ROADMAP A10) held against the JAX
reference.

The server math of ``repro/core/server.py`` and the port's
:mod:`repro_torch.core.server` get the same f32 inputs, made with numpy
from a seed: ``staleness_schedule`` exactly (its weights ``1 / (1 + s) **
alpha`` to f32 rounding of the power), ``window_deadline`` and
``nominal_uplink_s`` exactly (host f64), ``semi_sync_sums``,
``semi_sync_update`` and ``diloco_update`` at rtol 1e-6 (the reference
runs them under ``jax.jit``, where XLA:CPU may fuse a multiply-add).

Both engines run ``diloco`` and ``semi_sync`` (``staleness_cap=2``) on the
shape of the reference's ``task8_strag`` fixture (tests/test_server.py:
36-37: lr, M=8, n_train 1500, every 4th device 3x slower), with the
reference's initial params on both sides, against the reference's engine
of the same kind: ``step`` and ``uplink_mb`` equal, loss and accuracy at
rtol 1e-5, and ``server_wall_s`` exactly the reference's loop engine's
(host f64 from the same decisions and host-priced window times; the
reference's batched engine prices in its jitted window, within rtol 1e-6).
Also: an explicit ``aggregator="mean"`` bitwise the default, and the
reference's degeneracy cases (tests/test_server.py:254-309) on the port.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core.fl as jfl  # noqa: E402
from repro.core import server as jsrv  # noqa: E402
from repro.core.channels import DeviceProfile as JProfile  # noqa: E402
from repro.core.scenario import Scenario as JScenario  # noqa: E402
from repro.core.scenario import StragglerSpec as JStraggler  # noqa: E402
from repro.models.paper_models import make_task as j_make_task  # noqa: E402
import repro_torch.core.fl as pfl  # noqa: E402
from repro_torch.core import server as psrv  # noqa: E402
from repro_torch.core.channels import DeviceProfile as PProfile  # noqa: E402
from repro_torch.core.scenario import Scenario as PScenario  # noqa: E402
from repro_torch.core.scenario import StragglerSpec as PStraggler  # noqa: E402
from repro_torch.models.paper_models import make_task  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402

RTOL = 1e-6
J_STRAG = JScenario(name="stragglers",
                    straggler=JStraggler(slow_every=4, slowdown=3.0))
P_STRAG = PScenario(name="stragglers",
                    straggler=PStraggler(slow_every=4, slowdown=3.0))
AGGS = ("diloco", "semi_sync")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: its runs are thousands of small
    torch ops, which several threads slow down many times over when other
    test processes share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


# ---------------------------------------------------------------------------
# the server math
# ---------------------------------------------------------------------------

def _schedule_inputs(seed: int, n: int = 12):
    rng = np.random.default_rng(seed)
    T = (rng.uniform(0.0, 4.0, n)).astype(np.float32)
    T[:4] = [0.5, 1.0, 1.5, 2.5]             # on time, at, 1 and 2 late
    mask = rng.uniform(size=n) < 0.8
    mask[:4] = True
    return T, mask


@pytest.mark.parametrize("cap", [0, 1, 2, 5])
@pytest.mark.parametrize("alpha", [0.5, 1.0])
def test_staleness_schedule_matches_the_reference(cap, alpha):
    T, mask = _schedule_inputs(cap)
    want = jsrv.staleness_schedule(jnp.asarray(T), jnp.float32(1.0),
                                   jnp.asarray(mask), alpha, cap)
    got = psrv.staleness_schedule(_t(T), 1.0, _t(mask), alpha, cap)
    s, w, on, und = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(got[0].numpy(), s)
    np.testing.assert_array_equal(got[2].numpy(), on)
    np.testing.assert_allclose(got[1].numpy(), w, rtol=RTOL)
    np.testing.assert_allclose(got[3].numpy(), und, rtol=RTOL, atol=1e-7)
    assert got[0][:4].tolist() == [0.0, 0.0, 1.0, 2.0]


@pytest.mark.parametrize("cap", [0, 2])
def test_semi_sync_sums_and_update_match_the_reference(cap):
    T, mask = _schedule_inputs(7 + cap, n=6)
    rng = np.random.default_rng(3)
    g = rng.standard_normal((6, 50)).astype(np.float32)
    flat = rng.standard_normal(50).astype(np.float32)
    stale = rng.standard_normal((cap, 50)).astype(np.float32)
    want = jsrv.semi_sync_sums(jnp.asarray(g), jnp.asarray(T),
                               jnp.asarray(mask), jnp.float32(1.0), 0.5, cap)
    got = psrv.semi_sync_sums(_t(g), _t(T), _t(mask), 1.0, 0.5, cap)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=RTOL, atol=1e-6)
    assert got[2] == int(want[2])
    j_state = jsrv.ServerState(jnp.zeros(50), jnp.asarray(stale))
    p_state = psrv.ServerState(torch.zeros(50), _t(stale))
    for fold in (True, False):
        wf, ws = jsrv.semi_sync_update(jnp.asarray(flat), j_state, want[0],
                                       want[1], jnp.bool_(fold), 8)
        gf, gs = psrv.semi_sync_update(_t(flat), p_state, got[0], got[1],
                                       fold, 8)
        np.testing.assert_allclose(gf.numpy(), np.asarray(wf), rtol=RTOL,
                                   atol=1e-6)
        np.testing.assert_allclose(gs.stale.numpy(), np.asarray(ws.stale),
                                   rtol=RTOL, atol=1e-6)
        if not fold:
            assert torch.equal(gf, _t(flat)) and torch.equal(gs.stale,
                                                             _t(stale))


@pytest.mark.parametrize("lr, mu", [(0.7, 0.9), (0.5, 0.9), (1.0, 0.0)])
def test_diloco_update_matches_the_reference(lr, mu):
    rng = np.random.default_rng(5)
    flat, mom, delta = (rng.standard_normal(64).astype(np.float32)
                        for _ in range(3))
    j_state = jsrv.ServerState(jnp.asarray(mom), jnp.zeros((0, 64)))
    p_state = psrv.ServerState(_t(mom), torch.zeros(0, 64))
    for fold in (True, False):
        wf, ws = jsrv.diloco_update(jnp.asarray(flat), j_state,
                                    jnp.asarray(delta), jnp.bool_(fold),
                                    lr, mu)
        gf, gs = psrv.diloco_update(_t(flat), p_state, _t(delta), fold, lr,
                                    mu)
        np.testing.assert_allclose(gf.numpy(), np.asarray(wf), rtol=RTOL,
                                   atol=1e-6)
        np.testing.assert_allclose(gs.momentum.numpy(),
                                   np.asarray(ws.momentum), rtol=RTOL)
    if (lr, mu) == (1.0, 0.0):       # the plain mean, exactly
        gf, _ = psrv.diloco_update(_t(flat), p_state, _t(delta), True, lr,
                                   mu)
        assert torch.equal(gf, _t(flat) - _t(delta))


@pytest.mark.parametrize("mode", ["lgc", "topk", "fedavg", "lgc_q8"])
def test_window_deadline_matches_the_reference_exactly(mode):
    jcfg, pcfg = jfl.FLConfig(deadline_factor=2.0), pfl.FLConfig(
        deadline_factor=2.0)
    slow = dict(comp_time_per_step_s=0.15)
    specs = [(4, [100, 50, 50], {}), (4, [100, 50, 47], slow),
             (8, [300, 10, 0], {}), (2, [1, 1, 1], slow)]
    for n in (1, 2, 3, 4):
        items_j = [(h, ks, JProfile(**p)) for h, ks, p in specs[:n]]
        items_p = [(h, ks, PProfile(**p)) for h, ks, p in specs[:n]]
        assert (psrv.window_deadline(pcfg, mode, 7850, items_p)
                == jsrv.window_deadline(jcfg, mode, 7850, items_j))
        for h, ks, p in specs[:n]:
            assert (psrv.nominal_uplink_s(pcfg, mode, ks, 7850)
                    == jsrv.nominal_uplink_s(jcfg, mode, ks, 7850))


def test_server_state_sizing_and_validation():
    s = psrv.init_server_state(pfl.FLConfig(aggregator="semi_sync",
                                            staleness_cap=3), 5)
    assert s.momentum.shape == (5,) and s.stale.shape == (3, 5)
    assert psrv.init_server_state(pfl.FLConfig(aggregator="diloco"),
                                  5).stale.shape == (0, 5)
    with pytest.raises(ValueError, match="staleness_cap"):
        psrv.init_server_state(pfl.FLConfig(aggregator="semi_sync",
                                            staleness_cap=-1), 8)
    with pytest.raises(ValueError, match="unknown aggregator"):
        psrv.get_aggregator("fedprox")


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------

def _tasks(j_scn, p_scn):
    kw_j = {} if j_scn is None else {"scenario": j_scn}
    kw_p = {} if p_scn is None else {"scenario": p_scn}
    tj = j_make_task("lr_mnist", m_devices=8, n_train=1500, **kw_j)
    tp = make_task("lr_mnist", m_devices=8, n_train=1500, **kw_p)
    p0 = jax.tree_util.tree_map(np.asarray, tj.init(jax.random.PRNGKey(0)))
    tj.init = lambda key: jax.tree_util.tree_map(jnp.asarray, p0)
    pp = params_from_jax(p0)
    tp.init = lambda key: {k: v.clone() for k, v in pp.items()}
    return tj, tp


@pytest.fixture(scope="module")
def task8():
    return _tasks(None, None)[1]


@pytest.fixture(scope="module")
def task8_strag():
    return _tasks(J_STRAG, P_STRAG)


def _cfg(mod, agg, **kw):
    extra = dict(rounds=20, eval_every=10)
    if agg == "semi_sync":
        extra["staleness_cap"] = 2
    extra.update(kw)
    return mod.FLConfig(aggregator=agg, **extra)


def _port(task, cfg, engine="batched"):
    return pfl.run_baseline(task, dataclasses.replace(cfg, engine=engine),
                            "lgc", device="cpu")


@pytest.mark.parametrize("agg", AGGS)
def test_engines_match_the_reference_engines(task8_strag, agg):
    tj, tp = task8_strag
    h_ref = {e: jfl.run_baseline(tj, _cfg(jfl, agg, scenario=J_STRAG),
                                 "lgc", engine=e)
             for e in ("loop", "batched")}
    for engine in ("loop", "batched"):
        hp = _port(tp, _cfg(pfl, agg, scenario=P_STRAG), engine)
        hj = h_ref[engine]
        assert hp.step == hj.step and hp.uplink_mb == hj.uplink_mb
        np.testing.assert_allclose(hp.loss, hj.loss, rtol=1e-5)
        np.testing.assert_allclose(hp.accuracy, hj.accuracy, rtol=1e-5)
        assert hp.server_wall_s == h_ref["loop"].server_wall_s, engine
        np.testing.assert_allclose(hp.server_wall_s, hj.server_wall_s,
                                   rtol=RTOL)
    if agg == "semi_sync":      # the stragglers miss the deadline
        assert hp.server_wall_s[-1] < _port(
            tp, _cfg(pfl, "mean", scenario=P_STRAG)).server_wall_s[-1]


@pytest.mark.parametrize("engine", ["loop", "batched"])
def test_explicit_mean_bitwise_equals_default(task8, engine):
    base = dict(rounds=16, eval_every=8, engine=engine)
    h_def = pfl.run_baseline(task8, pfl.FLConfig(**base), "lgc",
                             device="cpu")
    h_mean = pfl.run_baseline(
        task8, pfl.FLConfig(aggregator="mean", staleness_cap=0, **base),
        "lgc", device="cpu")
    assert h_mean.asdict() == h_def.asdict()


def test_diloco_identity_params_reduce_to_mean(task8):
    base = dict(rounds=20, eval_every=10)
    hm = _port(task8, pfl.FLConfig(**base))
    hd = _port(task8, pfl.FLConfig(aggregator="diloco", outer_lr=1.0,
                                   outer_momentum=0.0, **base))
    np.testing.assert_allclose(hd.loss, hm.loss, atol=1e-5)
    np.testing.assert_allclose(hd.accuracy, hm.accuracy, atol=1e-5)
    assert hd.server_wall_s == hm.server_wall_s


def test_semi_sync_generous_deadline_reduces_to_mean(task8_strag):
    _, tp = task8_strag
    base = dict(rounds=20, eval_every=10, scenario=P_STRAG)
    hm = _port(tp, pfl.FLConfig(**base))
    hs = _port(tp, pfl.FLConfig(aggregator="semi_sync", staleness_cap=2,
                                deadline_factor=1e6, **base))
    np.testing.assert_allclose(hs.loss, hm.loss, atol=1e-5)
    np.testing.assert_allclose(hs.accuracy, hm.accuracy, atol=1e-5)


@pytest.mark.parametrize("engine", ["loop", "batched"])
def test_semi_sync_vanishing_deadline_freezes_model(task8, engine):
    cfg = pfl.FLConfig(rounds=12, eval_every=4, aggregator="semi_sync",
                       staleness_cap=0, deadline_factor=1e-12, engine=engine)
    ctrls = [pfl.FixedController(4, [100, 50, 47]) for _ in range(8)]
    sim = pfl.LGCSimulator(task8, cfg, ctrls, mode="lgc", device="cpu")
    before = {k: v.clone() for k, v in sim.params.items()}
    sim.run()
    for k, v in before.items():
        assert torch.equal(sim.params[k], v), k


def test_semi_sync_static_scenario_is_on_time(task8):
    base = dict(rounds=16, eval_every=8)
    hm = _port(task8, pfl.FLConfig(**base))
    hs = _port(task8, pfl.FLConfig(aggregator="semi_sync", staleness_cap=2,
                                   **base))
    np.testing.assert_allclose(hs.loss, hm.loss, atol=1e-6)
