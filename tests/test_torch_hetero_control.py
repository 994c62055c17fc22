"""The port's per-device action space, pipelined decisions and spend audit
held against the reference (tests/test_hetero_control.py's ladder).

Every device gets a different ``(h_m, ks_m)`` from a scripted fleet (no
DDPG nondeterminism): the port's loop and batched engines match the
reference's History, with the committed decisions, the spend ledger and
the uplink bytes exactly the reference loop engine's; homogeneous actions
reproduce the shared space asdict-equal; pipelining re-times the
controller only; and :func:`repro_torch.core.audit.recompute_spend`
replays the live spend exactly, equal to the reference's replay.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.core.fl as jfl  # noqa: E402
import repro_torch.core.fl as pfl  # noqa: E402
from repro.core.audit import recompute_spend as j_recompute  # noqa: E402
from repro.models.paper_models import make_task as j_make_task  # noqa: E402
from repro_torch.core.audit import (audit_simulator,  # noqa: E402
                                    recompute_spend, sync_round_of)
from repro_torch.core.controller import make_fleet_ddpg  # noqa: E402
from repro_torch.models.paper_models import make_task  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402

M = 8
# every device a different (h_m, ks_m): step counts sweep [1, max_gap] and
# budgets skew across channels (tests/test_hetero_control.py:35-39)
HS = [1, 2, 3, 4, 5, 6, 7, 8]
KSS = [[60, 30, 10], [10, 60, 30], [30, 10, 60], [80, 10, 10],
       [10, 80, 10], [10, 10, 80], [34, 33, 33], [5, 5, 90]]
SPEND = ("energy_j", "money", "time_s", "mb")

_TASKS: dict = {}
_REF: dict = {}


class ScriptedFleet:
    """Fleet-protocol controller replaying fixed per-device decisions."""

    def __init__(self, hs, kss):
        self.m = len(hs)
        self.hs = list(hs)
        self.kss = [list(k) for k in kss]
        self.needs_reward = np.zeros(self.m, bool)

    def act(self, states, mask=None):
        return np.asarray(self.hs, np.int64), [list(k) for k in self.kss]

    def observe(self, *a, **k):
        pass


def _tasks(scn: str):
    """(reference, port) lr_mnist M=8 tasks, the port starting from the
    reference's initial params."""
    if scn not in _TASKS:
        tj = j_make_task("lr_mnist", m_devices=M, n_train=1600, scenario=scn)
        tp = make_task("lr_mnist", m_devices=M, n_train=1600, scenario=scn)
        p0 = params_from_jax(jax.tree_util.tree_map(
            np.asarray, tj.init(jax.random.PRNGKey(0))))
        tp.init = lambda key: {k: v.clone() for k, v in p0.items()}
        _TASKS[scn] = (tj, tp)
    return _TASKS[scn]


def _cfg(mod, scn: str, **kw):
    return mod.FLConfig(rounds=24, eval_every=8, max_gap=8, scenario=scn,
                        action_space="per_device", **kw)


_RUNS: dict = {}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The port's simulator issues many small ops: one intra-op thread
    each keeps the parallel test workers from oversubscribing the host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _run(scn: str, engine: str, pipeline: bool = False, mode: str = "lgc"):
    """A port run under the scripted fleet, cached (the tests only read
    it)."""
    key = (scn, engine, pipeline, mode)
    if key not in _RUNS:
        _, tp = _tasks(scn)
        sim = pfl.LGCSimulator(tp, _cfg(pfl, scn, engine=engine,
                                        pipeline_decisions=pipeline),
                               ScriptedFleet(HS, KSS), mode=mode,
                               device="cpu")
        _RUNS[key] = (sim, sim.run())
    return _RUNS[key]


def _ref(scn: str, engine: str):
    if (scn, engine) not in _REF:
        tj, _ = _tasks(scn)
        sim = jfl.LGCSimulator(tj, _cfg(jfl, scn, engine=engine),
                               ScriptedFleet(HS, KSS))
        _REF[scn, engine] = (sim, sim.run())
    return _REF[scn, engine]


@pytest.mark.parametrize("scn", ["static", "gilbert_flaky"])
def test_engines_match_the_reference(scn):
    ref_loop, _ = _ref(scn, "loop")
    for engine in ("loop", "batched"):
        sj, hj = _ref(scn, engine)
        sp, hp = _run(scn, engine)
        assert hp.step == hj.step
        np.testing.assert_allclose(hp.loss, hj.loss, rtol=1e-5)
        np.testing.assert_allclose(hp.accuracy, hj.accuracy, rtol=1e-5)
        assert sp.decision_log == sj.decision_log
        assert sp.spend == ref_loop.spend, engine
        assert hp.uplink_mb == ref_loop_hist(scn).uplink_mb, engine
        for field in ("energy_j", "money", "time_s", "server_wall_s"):
            assert getattr(hp, field) == getattr(ref_loop_hist(scn), field)
    # the masked steps: device 0 (h=1) idles 7 rounds in 8, and its model
    # moved less than device 7's (h=8) before the first sync
    assert {h for _, m, h, _ in sp.decision_log if m == 0} == {1}


def ref_loop_hist(scn: str):
    return _ref(scn, "loop")[1]


@pytest.mark.parametrize("pipeline", [False, True])
@pytest.mark.parametrize("engine", ["loop", "batched"])
def test_homogeneous_degeneracy_pin(engine, pipeline):
    """h_m = max_gap for every device makes the per_device window the
    shared window: the History equals the shared space's asdict-exactly."""
    scn = "gilbert_flaky"
    _, tp = _tasks(scn)
    ks = [60, 30, 30]
    if ("shared", engine) not in _RUNS:
        shared = pfl.FLConfig(rounds=24, eval_every=8, max_gap=8,
                              scenario=scn, engine=engine)
        _RUNS["shared", engine] = pfl.LGCSimulator(
            tp, shared, [pfl.FixedController(8, ks) for _ in range(M)],
            device="cpu").run()
    h_shared = _RUNS["shared", engine]
    pd = _cfg(pfl, scn, engine=engine, pipeline_decisions=pipeline)
    h_pd = pfl.LGCSimulator(
        tp, pd, [pfl.FixedController(8, ks) for _ in range(M)],
        device="cpu").run()
    assert h_pd.asdict() == h_shared.asdict()


@pytest.mark.parametrize("scn", ["static", "gilbert_flaky"])
def test_pipelined_equals_blocking_for_a_stateless_fleet(scn):
    for engine in ("loop", "batched"):
        s0, h0 = _run(scn, engine, pipeline=False)
        s1, h1 = _run(scn, engine, pipeline=True)
        assert h1.asdict() == h0.asdict(), engine
        assert s1.decision_log == s0.decision_log


@pytest.mark.parametrize("scn", ["static", "gilbert_flaky"])
def test_recomputed_spend_is_the_live_spend(scn):
    """The replay from (config, decision log) alone equals the live ledger
    of both engines and the reference's own replay, exactly."""
    sj, _ = _ref(scn, "loop")
    want = j_recompute(sj.cfg, sj.mode, sj.d, sj.decision_log, M,
                       profiles=sj.profiles)
    for engine in ("loop", "batched"):
        sim, _ = _run(scn, engine)
        rec, live = audit_simulator(sim)
        assert rec == live, engine
        assert rec == want, engine


@pytest.mark.parametrize("mode", ["topk", "lgc_q8", "fedavg"])
def test_other_modes_audit_clean(mode):
    sim, _ = _run("gilbert_flaky", "batched", mode=mode)
    rec, live = audit_simulator(sim)
    assert rec == live


def test_tampered_log_fails_audit():
    sim, _ = _run("gilbert_flaky", "batched")
    t, m, h, ks = sim.decision_log[0]
    bad = list(sim.decision_log)
    bad[0] = (t, m, h, tuple(k + 8 for k in ks))
    rec = recompute_spend(sim.cfg, sim.mode, sim.d, bad, M,
                          profiles=sim.profiles)
    assert any(rec[m][k] != sim.spend[m][k] for k in ("energy_j", "mb"))
    # a longer h bills more compute energy and the same bytes
    fat = [(t, m, 8 if m == 0 else h, ks)
           for (t, m, h, ks) in sim.decision_log]
    rec8 = recompute_spend(sim.cfg, sim.mode, sim.d, fat, M,
                           profiles=sim.profiles)
    gap = rec8[0]["energy_j"] - sim.spend[0]["energy_j"]
    assert gap == pytest.approx((8 - HS[0])
                                * sim.profiles[0].comp_j_per_step * 3)
    assert rec8[0]["mb"] == sim.spend[0]["mb"]
    assert sync_round_of(sim.cfg, 8, 1) == 15
    shared = dataclasses.replace(sim.cfg, action_space="shared")
    assert sync_round_of(shared, 8, 1) == 8


@pytest.mark.parametrize("engine", ["loop", "batched"])
def test_per_device_ddpg_on_hetero_fleet(engine):
    """A per_device DDPG fleet, pipelined, on hetero_fleet: the battery
    clamp binds, the budgets hold, the audit is exact and every device
    trains."""
    _, tp = _tasks("hetero_fleet")
    fleet = make_fleet_ddpg(M, 7850, action_space="per_device", seed=1,
                            h_max=4, device="cpu")
    fleet.cfg.batch_size = 2
    cfg = pfl.FLConfig(rounds=24, eval_every=8, max_gap=4,
                       scenario="hetero_fleet", action_space="per_device",
                       pipeline_decisions=True, engine=engine)
    sim = pfl.LGCSimulator(tp, cfg, fleet, device="cpu")
    hist = sim.run()
    assert hist.loss[-1] < hist.loss[0]
    assert (fleet._n_train > 0).all()
    for (t, m, h, ks) in sim.decision_log:
        cap = 1 + int(np.floor(sim.profiles[m].battery * 3))
        assert 1 <= h <= min(cap, cfg.max_gap), (m, h, cap)
        assert min(ks) >= 1 and sum(ks) <= fleet.cfg.k_total_max
    assert min(p.battery for p in sim.profiles) < 1.0
    rec, live = audit_simulator(sim)
    assert rec == live


def test_channel_draws_are_bitwise_the_reference():
    """Energy, bandwidth and the up mask of a sync's channel draw, one
    device or rows of devices: the reference's bits (so spend is exact)."""
    from repro.core import channels as jch
    from repro.core.scenario import stream_key as j_stream_key
    from repro_torch.core import channels as pch
    from repro_torch.core import prng
    from repro_torch.core.scenario import stream_key, stream_keys
    base_j, base_p = jax.random.PRNGKey(1), prng.PRNGKey(1)
    cj, cp = jch.stack_specs(), pch.stack_specs()
    rows = pch.sample_channels_rows(
        stream_keys(base_p, 1, torch.tensor([7]), torch.arange(8))[0], cp)
    for m in range(8):
        want = jch.sample_channels_from(j_stream_key(base_j, 1, 7, m), cj)
        got = pch.sample_channels_from(stream_key(base_p, 1, 7, m), cp)
        for field in ("energy_j_per_mb", "bandwidth_mb_s", "up"):
            w = np.asarray(getattr(want, field))
            for g in (getattr(got, field), getattr(rows, field)[m]):
                g = g.numpy()
                if g.dtype == np.float32:
                    g, w2 = g.view(np.int32), w.view(np.int32)
                else:
                    w2 = w
                np.testing.assert_array_equal(g, w2, err_msg=field)
