"""The port's batched engine held against the reference's batched engine
and against the port's loop engine.

Both sides run the ``tests/test_fl.py:20`` fixture (``lr`` task, M=3,
n_train 1200) with the reference's initial params carried across
(``weights.params_from_jax``) and draw every minibatch, channel state and
QSGD dither from the same threefry streams.  History is compared on the
reference's own loop~batched ladder (tests/test_fl.py:73-83): ``step`` and
``uplink_mb`` equal, loss and accuracy within 1e-4, energy, money, time and
server wall-clock within rtol 1e-5; the committed decisions equal.  On the
CPU ``backend="pallas"`` runs the Pallas kernels in interpret mode on the
reference side and the row kernels' plain versions on the port's.

Also here: the batched exact compressors (``lgc_compress_topk``,
``lgc_compress_traced``) against the reference's and against the loop
engine's ``lgc_compress`` row by row, ``_stack_device_data``'s padding, and
an LR sync at about 1e-38, where the reference flushes f32 subnormals.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core.fl as jfl  # noqa: E402
from repro.core import compressor as jcomp  # noqa: E402
from repro.core import fl_batched as jfb  # noqa: E402
from repro.models.paper_models import make_task as j_make_task  # noqa: E402
import repro_torch.core.fl as pfl  # noqa: E402
from repro_torch.core import compressor as pcomp  # noqa: E402
from repro_torch.core import fl_batched as pfb  # noqa: E402
from repro_torch.kernels import LAUNCHES, reset_launch_counts  # noqa: E402
from repro_torch.models.paper_models import make_task  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402

MODES = ["lgc", "topk", "fedavg", "lgc_q8"]
MIN_NORMAL = np.float32(1.1754944e-38)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: with the suite's workers
    sharing the cores, OpenMP's barriers wait on descheduled threads.
    Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tasks(name: str, m: int, n_train: int, scale: float = 1.0):
    """(reference task, port task) with the reference's initial params,
    times ``scale``, on both sides."""
    tj = j_make_task(name, m_devices=m, n_train=n_train)
    tp = make_task(name, m_devices=m, n_train=n_train)
    p0 = jax.tree_util.tree_map(
        lambda a: np.asarray(a) * np.float32(scale),
        tj.init(jax.random.PRNGKey(0)))
    tj.init = lambda key: jax.tree_util.tree_map(jnp.asarray, p0)
    pp = params_from_jax(p0)
    tp.init = lambda key: {k: v.clone() for k, v in pp.items()}
    return tj, tp


@pytest.fixture(scope="module")
def lr_tasks():
    return _tasks("lr_mnist", 3, 1200)


def _default_ks(d: int) -> list[int]:
    k_total = max(1, d // 20)
    return [k_total // 2, k_total // 4, k_total - k_total // 2 - k_total // 4]


def _sim(mod, task, cfg, mode="lgc", backend="exact", hs=(4, 4, 4),
         ks=None, **kw):
    key = jax.random.PRNGKey(0) if mod is jfl else None
    if ks is None:
        d = (jfl.tree_size(task.init(key)) if mod is jfl
             else pfl.tree_size(task.init(None)))
        ks = _default_ks(d)
    ctrls = [mod.FixedController(h, ks) for h in hs]
    return mod.LGCSimulator(task, cfg, ctrls, mode=mode, backend=backend,
                            **kw)


def _assert_history(hp, hj, accuracy: bool = True):
    assert hp.step == hj.step
    np.testing.assert_allclose(hp.loss, hj.loss, atol=1e-4)
    if accuracy:
        np.testing.assert_allclose(hp.accuracy, hj.accuracy, atol=1e-4)
    assert hp.uplink_mb == hj.uplink_mb
    np.testing.assert_allclose(hp.energy_j, hj.energy_j, rtol=1e-5)
    np.testing.assert_allclose(hp.time_s, hj.time_s, rtol=1e-5)
    np.testing.assert_allclose(hp.money, hj.money, rtol=1e-5)
    np.testing.assert_allclose(hp.server_wall_s, hj.server_wall_s,
                               rtol=1e-5)


# ---------------------------------------------------------------------------
# History: port batched against reference batched and port loop
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["exact", "pallas"])
@pytest.mark.parametrize("mode", MODES)
def test_lr_history_matches_reference_batched_and_port_loop(
        lr_tasks, mode, backend):
    tj, tp = lr_tasks
    kw = dict(rounds=30, eval_every=10)
    sj = _sim(jfl, tj, jfl.FLConfig(engine="batched", **kw), mode, backend)
    hj = sj.run()
    reset_launch_counts()
    sb = _sim(pfl, tp, pfl.FLConfig(**kw), mode, backend, device="cpu")
    assert sb.engine == "batched"                  # the default
    hb = sb.run()
    assert all(v == 0 for v in LAUNCHES.values())  # the CPU: plain versions
    sl = _sim(pfl, tp, pfl.FLConfig(engine="loop", **kw), mode, backend,
              device="cpu")
    hl = sl.run()
    _assert_history(hb, hj)
    _assert_history(hb, hl)
    assert sb.decision_log == sj.decision_log == sl.decision_log
    assert len(sb.round_ms) == 30


def test_heterogeneous_gaps_hit_the_same_syncs_in_every_engine(lr_tasks):
    """h = 2, 3, 6 (tests/test_fl.py:85-98): the same sync set and decision
    log in the reference's loop and batched engines and the port's."""
    tj, tp = lr_tasks
    kw = dict(rounds=25, eval_every=8, max_gap=6)
    runs = {}
    for mod, eng in ((jfl, "loop"), (jfl, "batched"), (pfl, "loop"),
                     (pfl, "batched")):
        task = tj if mod is jfl else tp
        extra = {} if mod is jfl else {"device": "cpu"}
        sim = _sim(mod, task, mod.FLConfig(engine=eng, **kw), hs=(2, 3, 6),
                   ks=[200, 300, 400], **extra)
        runs[(mod.__name__, eng)] = (sim.run(), sim.decision_log)
        assert all(d.h <= kw["max_gap"] for d in sim.decisions)
    hj, log_j = runs[("repro.core.fl", "loop")]
    for key, (h, log) in runs.items():
        assert log == log_j, key
        _assert_history(h, hj)


def test_cnn_history_matches_reference_batched_engine():
    tj, tp = _tasks("cnn_mnist", 2, 200)
    kw = dict(rounds=8, eval_every=4, batch_size=16)
    hj = _sim(jfl, tj, jfl.FLConfig(**kw), backend="pallas",
              hs=(4, 4)).run()
    sp = _sim(pfl, tp, pfl.FLConfig(**kw), backend="pallas", hs=(4, 4),
              device="cpu")
    _assert_history(sp.run(), hj)


# ---------------------------------------------------------------------------
# pieces
# ---------------------------------------------------------------------------

def test_stack_device_data_pads_with_rows_never_sampled():
    tp = make_task("lr_mnist", m_devices=4, n_train=800)
    shards = [(x[: 20 + 30 * i], y[: 20 + 30 * i])
              for i, (x, y) in enumerate(tp.device_data)]
    (xs, ys), n = pfb._stack_device_data(shards, torch.device("cpu"))
    (xj, yj), nj = jfb._stack_device_data(shards)
    np.testing.assert_array_equal(xs.numpy(), np.asarray(xj))
    np.testing.assert_array_equal(ys.numpy(), np.asarray(yj))
    assert n.tolist() == np.asarray(nj).tolist() == [20, 50, 80, 110]
    for i, k in enumerate(n.tolist()):
        assert not xs[i, k:].any() and not ys[i, k:].any()
    tp.device_data = shards
    sim = pfl.LGCSimulator(tp, pfl.FLConfig(batch_size=64), [
        pfl.FixedController(4, [1, 1, 1])] * 4, device="cpu")
    eng = pfb.BatchedEngine(sim)
    idx = eng._draw_batches(0, 40)                  # (40, 4, 64)
    assert idx.shape == (40, 4, 64)
    assert bool((idx >= 0).all())
    assert bool((idx < n[None, :, None]).all())     # padding never drawn
    # the same indices as the loop engine draws device by device
    for t in (0, 17, 39):
        for m in range(4):
            want = pfl.prng.randint(
                pfl.stream_key(sim._base, pfl.TAG_BATCH, t, m), (64,), 0,
                int(n[m]))
            assert torch.equal(idx[t, m], want)


def _ties(m: int, d: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    u = np.round(rng.standard_normal((m, d)) * 4) / 4    # many ties
    u[0, :5] = 0.0
    u[0, 5] = -0.0
    return u.astype(np.float32)


@pytest.mark.parametrize("m,d", [(3, 7850), (4, 37), (1, 6)])
def test_batched_compressors_match_reference_and_loop_rows(m, d):
    u = _ties(m, d, d)
    rng = np.random.default_rng(d + 1)
    ks = rng.integers(0, d // 2 + 1, (m, 3)).astype(np.int32)
    ks[0] = [0, 0, 0]
    if m > 1:
        ks[1] = [d, 1, 0]                           # the whole row and past it
    recv = rng.integers(0, 2, (m, 3)).astype(bool)
    cap = pcomp.k_cap_for(int(ks.sum(1).max()), d)
    top = pcomp.lgc_compress_topk(torch.from_numpy(u), torch.from_numpy(ks),
                                  torch.from_numpy(recv), cap)
    traced = pcomp.lgc_compress_traced(torch.from_numpy(u),
                                       torch.from_numpy(ks),
                                       torch.from_numpy(recv))
    j_top = jax.vmap(lambda ui, ki, ri: jcomp.lgc_compress_topk(
        ui, ki, ri, cap))(jnp.asarray(u), jnp.asarray(ks), jnp.asarray(recv))
    j_traced = jax.vmap(jcomp.lgc_compress_traced)(
        jnp.asarray(u), jnp.asarray(ks), jnp.asarray(recv))
    for got, want in ((top, j_top), (traced, j_traced)):
        np.testing.assert_array_equal(got.numpy().view(np.int32),
                                      np.asarray(want).view(np.int32))
    for r in range(m):
        loop = pcomp.lgc_compress(torch.from_numpy(u[r]), ks[r].tolist(),
                                  recv[r].tolist())
        assert torch.equal(top[r].view(torch.int32), loop.view(torch.int32))
    # the selection does not depend on the cap above the largest budget
    wider = pcomp.lgc_compress_topk(torch.from_numpy(u), torch.from_numpy(ks),
                                    torch.from_numpy(recv), 4 * cap)
    assert torch.equal(wider.view(torch.int32), top.view(torch.int32))


def test_k_cap_is_a_monotone_power_of_two():
    assert [pcomp.k_cap_for(k, 7850) for k in (0, 1, 392, 512, 513, 7000,
                                                9000)] == [
        1, 1, 512, 512, 1024, 7850, 7850]


def test_engine_options(lr_tasks):
    _, tp = lr_tasks
    assert pfl.FLConfig().engine == "batched"
    ctrls = [pfl.FixedController(4, [1, 1, 1])] * 3
    sharded = pfl.LGCSimulator(tp, pfl.FLConfig(engine="sharded", rounds=4),
                               ctrls, device="cpu")
    assert sharded.run().step == [0, 3]
    with pytest.raises(ValueError, match="server_reduce"):
        pfl.run_baseline(tp, pfl.FLConfig(rounds=4), "lgc", engine="sharded",
                         server_reduce="allgather", device="cpu")
    with pytest.raises(ValueError):
        pfl.LGCSimulator(tp, pfl.FLConfig(engine="vmap"), ctrls,
                         device="cpu")
    a = pfl.run_baseline(tp, pfl.FLConfig(rounds=9, eval_every=4), "lgc",
                         backend="pallas", device="cpu")
    b = pfl.run_baseline(tp, pfl.FLConfig(rounds=9, eval_every=4), "lgc",
                         backend="cuda", device="cpu")
    assert a.asdict() == b.asdict()


# ---------------------------------------------------------------------------
# f32 subnormals (the reference's XLA:CPU flushes them)
# ---------------------------------------------------------------------------

def _subnormals(x) -> int:
    x = np.asarray(x, np.float32).ravel()
    return int(((x != 0) & (np.abs(x) < MIN_NORMAL)).sum())


@pytest.mark.parametrize("mode,backend", [("lgc", "exact"),
                                          ("fedavg", "exact"),
                                          ("lgc_q8", "pallas")])
def test_sync_at_1e_38_flushes_subnormals_as_the_reference(mode, backend):
    """Weights near 1e-38 and a step size of 1e-37 put the SGD update, the
    net progress, the EF adds and the server mean among f32 subnormals.
    The reference's engines keep none; neither may the port's.  Where a
    coordinate ends at zero must agree with the reference loop engine's
    but for at most 10% of D (the reference's own loop and batched
    engines differ on about 4%: its jitted update contracts p - eta * g
    into one fused multiply-add, the port rounds the product first).
    History holds the ladder but for accuracy: at this scale it is the
    argmax of logits near 1e-38, whose products the reference's matmul
    flushes and ATen's keeps (the forward pass is outside this check)."""
    tj, tp = _tasks("lr_mnist", 3, 1200, scale=1e-36)
    kw = dict(rounds=8, eval_every=4, lr=1e-37)
    ks = [196, 98, 98]
    sims = {}
    for mod, eng in ((jfl, "loop"), (jfl, "batched"), (pfl, "loop"),
                     (pfl, "batched")):
        task = tj if mod is jfl else tp
        extra = {} if mod is jfl else {"device": "cpu"}
        sim = _sim(mod, task, mod.FLConfig(engine=eng, **kw), mode, backend,
                   ks=ks, **extra)
        sims[(mod is jfl, eng)] = (sim, sim.run())
    sj, hj = sims[(True, "loop")]
    w_j = np.asarray(sj.params["w"])
    assert _subnormals(w_j) == 0
    for (is_ref, eng), (sim, hist) in sims.items():
        _assert_history(hist, hj, accuracy=False)
        if is_ref:
            continue
        w = sim.params["w"].numpy()
        assert _subnormals(w) == 0, eng
        assert ((w == 0) != (w_j == 0)).mean() <= 0.1, eng
        np.testing.assert_allclose(w, w_j, rtol=0, atol=MIN_NORMAL * 8)
    sl, _ = sims[(False, "loop")]
    assert all(_subnormals(e.e.numpy()) == 0 for e in sl.ef)
    assert all(_subnormals(w.numpy()) == 0 for w in sl.w_anchor)
    eng = sims[(False, "batched")][0].batched_engine
    for state in (eng.ef, eng.w_hat, eng.anchor):
        assert _subnormals(state.numpy()) == 0
