"""The port's loop engine held against the reference loop engine.

Both simulators run the same task with the reference's initial parameters
carried across (``weights.params_from_jax``) and draw every minibatch,
channel state, eval subset and QSGD dither from the same threefry streams.
History is compared on the reference's own loop~batched ladder
(tests/test_fl.py:73-83): ``step`` and ``uplink_mb`` equal, loss and
accuracy within 1e-4, energy and time within rtol 1e-5; the committed
decisions and the per-sync channel ``up`` masks equal.  On the CPU
``backend="pallas"`` runs the Pallas kernels in interpret mode on the
reference side and the kernels' plain versions on the port's.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core.fl as jfl  # noqa: E402
import repro_torch.core.fl as pfl  # noqa: E402
from repro.models.paper_models import make_task as j_make_task  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core.controller import make_fleet_ddpg  # noqa: E402
from repro_torch.core.scenario import SCENARIOS  # noqa: E402
from repro_torch.kernels import LAUNCHES, reset_launch_counts  # noqa: E402
from repro_torch.launch import quickstart  # noqa: E402
from repro_torch.models.paper_models import make_task  # noqa: E402
from repro_torch.weights import params_from_jax, vector_from_jax  # noqa: E402

LR_CASES = [("lgc", "exact"), ("topk", "exact"), ("fedavg", "exact"),
            ("lgc_q8", "exact"), ("lgc", "pallas")]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: with the suite's workers
    sharing the cores, OpenMP's barriers wait on descheduled threads.
    Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tasks(name: str, m: int, n_train: int):
    """(reference task, port task with the reference's initial params)."""
    tj = j_make_task(name, m_devices=m, n_train=n_train)
    tp = make_task(name, m_devices=m, n_train=n_train)
    p0 = params_from_jax(jax.tree_util.tree_map(
        np.asarray, tj.init(jax.random.PRNGKey(0))))
    tp.init = lambda key: {k: v.clone() for k, v in p0.items()}
    return tj, tp


def _default_ks(d: int) -> list[int]:
    k_total = max(1, d // 20)
    return [k_total // 2, k_total // 4, k_total - k_total // 2 - k_total // 4]


def _run(mod, task, cfg, mode, backend, monkeypatch, **kw):
    """Run one simulator of ``mod`` (reference or port), recording the up
    mask of every sync's channel draw."""
    ups = []
    orig = mod.sample_from_carry

    def recording(*a, **k):
        ch = orig(*a, **k)
        ups.append(np.asarray(ch.up).tolist())
        return ch
    monkeypatch.setattr(mod, "sample_from_carry", recording)
    key = jax.random.PRNGKey(0) if mod is jfl else prng.PRNGKey(0)
    d = mod.tree_size(task.init(key))
    ctrls = [mod.FixedController(4, _default_ks(d))
             for _ in task.device_data]
    sim = mod.LGCSimulator(task, cfg, ctrls, mode=mode, backend=backend,
                           **kw)
    hist = sim.run()
    monkeypatch.setattr(mod, "sample_from_carry", orig)
    return hist, sim, ups


def _assert_history(hp, hj):
    assert hp.step == hj.step
    np.testing.assert_allclose(hp.loss, hj.loss, atol=1e-4)
    np.testing.assert_allclose(hp.accuracy, hj.accuracy, atol=1e-4)
    assert hp.uplink_mb == hj.uplink_mb
    np.testing.assert_allclose(hp.energy_j, hj.energy_j, rtol=1e-5)
    np.testing.assert_allclose(hp.time_s, hj.time_s, rtol=1e-5)
    np.testing.assert_allclose(hp.money, hj.money, rtol=1e-5)
    np.testing.assert_allclose(hp.server_wall_s, hj.server_wall_s,
                               rtol=1e-5)


@pytest.fixture(scope="module")
def lr_tasks():
    return _tasks("lr_mnist", 3, 1200)


@pytest.mark.parametrize("mode,backend", LR_CASES)
def test_lr_history_matches_reference_loop_engine(lr_tasks, mode, backend,
                                                  monkeypatch):
    tj, tp = lr_tasks
    kw = dict(rounds=30, eval_every=10)
    hj, sj, up_j = _run(jfl, tj, jfl.FLConfig(engine="loop", **kw), mode,
                        backend, monkeypatch)
    reset_launch_counts()
    hp, sp, up_p = _run(pfl, tp, pfl.FLConfig(engine="loop", **kw), mode,
                        backend, monkeypatch, device="cpu")
    _assert_history(hp, hj)
    assert sp.decision_log == sj.decision_log
    assert len(up_p) == len(up_j) == 3 * (30 // 4)
    assert up_p == up_j
    assert any(not all(u) for u in up_p)       # a channel was down somewhere
    # on the CPU the plain versions run: no kernel launched
    assert all(v == 0 for v in LAUNCHES.values())


def test_cnn_history_matches_reference_loop_engine(monkeypatch):
    tj, tp = _tasks("cnn_mnist", 2, 200)
    kw = dict(rounds=8, eval_every=4, batch_size=16)
    hj, sj, up_j = _run(jfl, tj, jfl.FLConfig(engine="loop", **kw), "lgc",
                        "pallas", monkeypatch)
    hp, sp, up_p = _run(pfl, tp, pfl.FLConfig(engine="loop", **kw), "lgc",
                        "pallas", monkeypatch, device="cpu")
    _assert_history(hp, hj)
    assert sp.decision_log == sj.decision_log
    assert up_p == up_j and len(up_p) == 4


@pytest.mark.parametrize("backend", ["exact", "pallas"])
def test_single_sync_ef_step_is_bitwise(lr_tasks, backend):
    """Given the same e and delta, one sync's compression returns
    bitwise-equal g and e' on both sides (a dropped middle channel)."""
    tj, tp = lr_tasks
    ctrl = [[jfl.FixedController(4, [300, 100, 200])] * 3,
            [pfl.FixedController(4, [300, 100, 200])] * 3]
    sj = jfl.LGCSimulator(tj, jfl.FLConfig(engine="loop"), ctrl[0],
                          backend=backend)
    sp = pfl.LGCSimulator(tp, pfl.FLConfig(), ctrl[1], backend=backend,
                          device="cpu")
    rng = np.random.default_rng(0)
    e = (rng.standard_normal(sj.d) * 1e-3).astype(np.float32)
    delta = (rng.standard_normal(sj.d) * 1e-2).astype(np.float32)
    received = [True, False, True]
    sj.ef[1] = jfl.EFState(jnp.asarray(e))
    sp.ef[1] = pfl.EFState(vector_from_jax(e))
    g_j = sj._ef_step(1, 0, jnp.asarray(delta), [300, 100, 200], received)
    g_p = sp._ef_step(1, 0, vector_from_jax(delta), [300, 100, 200],
                      received)
    for got, want in ((g_p, g_j), (sp.ef[1].e, sj.ef[1].e)):
        np.testing.assert_array_equal(got.numpy().view(np.int32),
                                      np.asarray(want).view(np.int32))
    u = vector_from_jax(e) + vector_from_jax(delta)
    assert torch.equal((g_p + sp.ef[1].e).view(torch.int32),
                       u.view(torch.int32))
    sent = int((g_p != 0).sum())
    # rank-exact: layers 1 and 3 exactly; histogram: whole bins
    assert sent == 500 if backend == "exact" else 400 < sent < 700


def test_pallas_is_an_alias_of_cuda(lr_tasks):
    _, tp = lr_tasks
    cfg = pfl.FLConfig(rounds=9, eval_every=4, engine="loop")
    a = pfl.run_baseline(tp, cfg, "lgc", backend="pallas", device="cpu")
    b = pfl.run_baseline(tp, cfg, "lgc", backend="cuda", device="cpu")
    assert a.asdict() == b.asdict()


def test_unported_options_raise_naming_their_roadmap_item(lr_tasks):
    _, tp = lr_tasks
    ctrls = [pfl.FixedController(4, [1, 1, 1])] * 3
    # the sharded engine (ROADMAP A12's FL axis) builds and runs, and
    # refuses an unknown server reduce, as the reference's
    # (tests/test_sharded.py:94-112)
    cases = [({"engine": "sharded"}, "server_reduce")]
    for fields, item in cases:
        for engine in ("loop", "batched"):
            cfg = dataclasses.replace(pfl.FLConfig(engine=engine,
                                                   rounds=4), **fields)
            assert pfl.LGCSimulator(tp, cfg, ctrls,
                                    device="cpu").run().step == [0, 3]
            with pytest.raises(ValueError, match=item):
                pfl.LGCSimulator(tp, cfg, ctrls, device="cpu",
                                 server_reduce="allgather")
    # every scenario (ROADMAP A7), layer policy (A8), aggregator (A10),
    # the per-device action space and pipelined decisions (A9) run on both
    # engines, as do controllers that learn from rewards (A9)
    ported = ([{"scenario": name} for name in SCENARIOS]
              + [{"layer_policy": p}
                 for p in ("uniform", "size_prop", "divergence")]
              + [{"aggregator": a} for a in ("diloco", "semi_sync")]
              + [{"action_space": "per_device"},
                 {"pipeline_decisions": True}])
    for fields in ported:
        for engine in ("loop", "batched"):
            pfl.LGCSimulator(tp, pfl.FLConfig(engine=engine, **fields),
                             ctrls, device="cpu")
    learning = make_fleet_ddpg(3, 7850, device="cpu")
    for engine in ("loop", "batched"):
        pfl.LGCSimulator(tp, pfl.FLConfig(engine=engine), learning,
                         device="cpu")
    with pytest.raises(ValueError, match="action_space"):
        pfl.LGCSimulator(tp, pfl.FLConfig(action_space="layered"), ctrls,
                         device="cpu")
    with pytest.raises(ValueError, match="layer_policy"):
        pfl.LGCSimulator(tp, pfl.FLConfig(layer_policy="nope"), ctrls,
                         device="cpu")
    with pytest.raises(ValueError, match="aggregator"):
        pfl.LGCSimulator(tp, pfl.FLConfig(aggregator="nope"), ctrls,
                         device="cpu")
    with pytest.raises(ValueError):
        pfl.LGCSimulator(tp, pfl.FLConfig(), ctrls, mode="dense",
                         device="cpu")
    with pytest.raises(ValueError):
        pfl.LGCSimulator(tp, pfl.FLConfig(), ctrls, backend="tpu",
                         device="cpu")


def test_entry_points_run_on_the_card_or_raise(lr_tasks, monkeypatch):
    _, tp = lr_tasks
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ctrls = [pfl.FixedController(4, [1, 1, 1])] * 3
    with pytest.raises(RuntimeError, match="CUDA"):
        pfl.LGCSimulator(tp, pfl.FLConfig(), ctrls)
    with pytest.raises(RuntimeError, match="CUDA"):
        pfl.run_baseline(tp, pfl.FLConfig(rounds=2), "lgc")
    with pytest.raises(RuntimeError, match="CUDA"):
        quickstart.main(["--rounds", "2", "--n-train", "90"])


def test_quickstart_on_the_cpu(capsys):
    out = quickstart.main(["--device", "cpu", "--rounds", "8",
                           "--n-train", "300"])
    text = capsys.readouterr().out
    assert "resource comparison" in text and "ms per round" in text
    assert out["lgc"].uplink_mb[-1] < out["fedavg"].uplink_mb[-1]
    assert out["lgc"].step == [0, 1, 2, 3, 4, 5, 6, 7]
