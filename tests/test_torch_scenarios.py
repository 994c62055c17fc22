"""Every scenario through the port's engines and its 100M step, held
against the JAX reference.

The simulator runs ``lr_mnist`` (M=4, n_train 800, 12 rounds, H=4) under
each ``SCENARIOS`` entry on the port's loop and batched engines and on the
reference's batched engine, with the reference's initial params carried
across.  History is held on the reference's own loop~batched ladder
(tests/test_fl.py:73-83): ``step`` and ``uplink_mb`` equal, loss and
accuracy within atol 1e-4, energy, money, time and server wall-clock
within rtol 1e-5 (as on the static scenario: the channel draws' ``normal``
and ``exp`` and the sums agree to f32 rounding; the Gauss-Markov
bandwidth itself is bitwise, since the carry is), the decisions equal and
the final (M, C) channel-chain carry bitwise the reference's.

The carry's row form is held bitwise against the per-device form and the
reference's jitted ``_scen_step_all``, where XLA:CPU folds the AR(1)
innovation's constants and fuses ``rho * bw_log + innov`` (the eager
reference differs from it in the last bit); the vectorised
``dropout_mask`` bitwise against one draw per device.

The 100M task: the per-round (M, C) delivery masks of every scenario
bitwise the reference's ``_round_mask``, and the smoke preset (in f32)
under ``gilbert_flaky`` with ``dense_masked``, 3 rounds from the
reference's weights: losses within rtol 1e-5, params and error memory
allclose at rtol 1e-5 / atol 1e-6, where a coordinate next to a histogram
bin edge may flip layer (at most 1e-3 of a leaf) at a sparsity that does
not send everything.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core.fl as jfl  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.core import fl_batched as jfb  # noqa: E402
from repro.core import scenario as jscn  # noqa: E402
from repro.models.lgc_transformer import make_qwen2_100m_task as j_make_100m  # noqa: E402
from repro.models.paper_models import make_task as j_make_task  # noqa: E402
import repro_torch.core.fl as pfl  # noqa: E402
from repro_torch.configs import get_smoke_config as p_smoke  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core import scenario as pscn  # noqa: E402
from repro_torch.models.paper_models import make_task  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402

M, N_TRAIN, ROUNDS, H = 4, 800, 12, 4
NAMES = sorted(jscn.SCENARIOS)
RTOL, ATOL = 1e-5, 1e-6
MAX_FLIP_SHARE = 1e-3
SATURATING = (1.0, 0.5, 0.5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: with the suite's workers
    sharing the cores, OpenMP's barriers wait on descheduled threads.
    Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tasks(scenario, m: int = M):
    """(reference task, port task) under ``scenario``, with the
    reference's initial params on both sides."""
    tj = j_make_task("lr_mnist", m_devices=m, n_train=N_TRAIN,
                     scenario=scenario)
    tp = make_task("lr_mnist", m_devices=m, n_train=N_TRAIN,
                   scenario=scenario)
    p0 = jax.tree_util.tree_map(np.asarray, tj.init(jax.random.PRNGKey(0)))
    tj.init = lambda key: jax.tree_util.tree_map(jnp.asarray, p0)
    pp = params_from_jax(p0)
    tp.init = lambda key: {k: v.clone() for k, v in pp.items()}
    return tj, tp


def _ks() -> list[int]:
    k_total = 7850 // 20
    return [k_total // 2, k_total // 4, k_total - k_total // 2 - k_total // 4]


def _runs(scenario, mode="lgc", m: int = M):
    """The reference's batched engine and the port's two engines on the
    same task: {name: (History, simulator)}, the reference's engine last."""
    tj, tp = _tasks(scenario, m)
    kw = dict(rounds=ROUNDS, eval_every=4, scenario=scenario)
    sj = jfl.LGCSimulator(tj, jfl.FLConfig(engine="batched", **kw),
                          [jfl.FixedController(H, _ks()) for _ in range(m)],
                          mode=mode)
    eng = jfb.BatchedEngine(sj)
    out = {"ref": (eng.run(), sj, eng)}
    for engine in ("loop", "batched"):
        sp = pfl.LGCSimulator(
            tp, pfl.FLConfig(engine=engine, **kw),
            [pfl.FixedController(H, _ks()) for _ in range(m)], mode=mode,
            device="cpu")
        out[engine] = (sp.run(), sp, None)
    return out


def _assert_history(hp, hj):
    assert hp.step == hj.step
    np.testing.assert_allclose(hp.loss, hj.loss, atol=1e-4)
    np.testing.assert_allclose(hp.accuracy, hj.accuracy, atol=1e-4)
    assert hp.uplink_mb == hj.uplink_mb
    for field in ("energy_j", "money", "time_s", "server_wall_s"):
        np.testing.assert_allclose(getattr(hp, field), getattr(hj, field),
                                   rtol=1e-5, err_msg=field)


def _bitwise(got: torch.Tensor, want, what: str = ""):
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape and got.dtype == want.dtype, what
    if got.dtype == np.float32:
        got, want = got.view(np.int32), want.view(np.int32)
    np.testing.assert_array_equal(got, want, err_msg=what)


# ---------------------------------------------------------------------------
# the engines under every scenario
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_every_scenario_matches_the_reference_batched_engine(name):
    runs = _runs(name)
    hj, sj, eng = runs["ref"]
    for engine in ("loop", "batched"):
        hp, sp, _ = runs[engine]
        _assert_history(hp, hj)
        assert sp.decision_log == sj.decision_log, engine
        _bitwise(sp.scen_carry.bw_log, eng.scen_carry.bw_log, engine)
        _bitwise(sp.scen_carry.good, eng.scen_carry.good, engine)
    assert runs["loop"][0].asdict()["uplink_mb"] == \
        runs["batched"][0].asdict()["uplink_mb"]


@pytest.mark.parametrize("mode", ["fedavg", "topk", "lgc_q8"])
def test_gilbert_flaky_in_every_mode(mode):
    runs = _runs("gilbert_flaky", mode)
    hj = runs["ref"][0]
    for engine in ("loop", "batched"):
        _assert_history(runs[engine][0], hj)


def test_a_total_outage_under_fedavg_uploads_nothing():
    """Every device drops every sync: nothing is sent, and FedAvg, which
    carries nothing over, leaves the global model where it started."""
    scn = pscn.Scenario(name="outage",
                        dropout=pscn.DropoutSpec(base_prob=1.0))
    scn_j = jscn.Scenario(name="outage",
                          dropout=jscn.DropoutSpec(base_prob=1.0))
    tj, tp = _tasks(None)
    kw = dict(rounds=8, eval_every=4)
    hj = jfl.LGCSimulator(
        tj, jfl.FLConfig(engine="batched", scenario=scn_j, **kw),
        [jfl.FixedController(H, _ks()) for _ in range(M)],
        mode="fedavg").run()
    p0 = {k: v.clone() for k, v in tp.init(None).items()}
    for engine in ("loop", "batched"):
        sp = pfl.LGCSimulator(
            tp, pfl.FLConfig(engine=engine, scenario=scn, **kw),
            [pfl.FixedController(H, _ks()) for _ in range(M)],
            mode="fedavg", device="cpu")
        hp = sp.run()
        assert hp.uplink_mb == [0.0] * len(hp.step) == hj.uplink_mb
        assert all(torch.equal(sp.params[k], p0[k]) for k in p0), engine
        _assert_history(hp, hj)


def test_dropout_lowers_the_uplink():
    """gilbert_flaky against the same chains without its dropout: fewer
    bytes in both engines, each equal to the reference's."""
    flaky = pscn.SCENARIOS["gilbert_flaky"]
    assert flaky.has_dropout
    no_drop = dataclasses.replace(flaky, name="no_drop", dropout=None)
    up = {}
    for scn in (flaky, no_drop):
        tj, tp = _tasks(scn.name if scn is flaky else None)
        scn_j = (jscn.SCENARIOS["gilbert_flaky"] if scn is flaky else
                 dataclasses.replace(jscn.SCENARIOS["gilbert_flaky"],
                                     name="no_drop", dropout=None))
        kw = dict(rounds=ROUNDS, eval_every=4)
        hj = jfl.LGCSimulator(
            tj, jfl.FLConfig(engine="batched", scenario=scn_j, **kw),
            [jfl.FixedController(H, _ks()) for _ in range(M)]).run()
        for engine in ("loop", "batched"):
            hp = pfl.LGCSimulator(
                tp, pfl.FLConfig(engine=engine, scenario=scn, **kw),
                [pfl.FixedController(H, _ks()) for _ in range(M)],
                device="cpu").run()
            assert hp.uplink_mb == hj.uplink_mb
            up[(scn.name, engine)] = hp.uplink_mb[-1]
    for engine in ("loop", "batched"):
        assert up[("gilbert_flaky", engine)] < up[("no_drop", engine)]


# ---------------------------------------------------------------------------
# the carry's row form and the vectorised dropout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_step_carry_rows_is_the_per_device_step_and_the_jitted_reference(
        name):
    """8 devices over 24 rounds in windows of 1, 3 and 5 rounds: the row
    form bitwise the per-device ``step_carry`` and the reference's
    jitted vmapped step (its ``_scen_step_all``)."""
    m, n_ch = 8, 3
    scn_p, scn_j = pscn.SCENARIOS[name], jscn.SCENARIOS[name]
    base_p, base_j = prng.PRNGKey(3), jax.random.PRNGKey(3)
    ids = jnp.arange(m, dtype=jnp.int32)
    carry_j = jax.vmap(lambda i: jscn.init_carry(scn_j, base_j, i, n_ch))(
        ids)
    step_j = jax.jit(lambda c, t: jax.vmap(
        lambda ci, i: jscn.step_carry(scn_j, base_j, ci, t, i,
                                      jnp.bool_(True)))(c, ids))
    singles = [pscn.init_carry(scn_p, base_p, i, n_ch) for i in range(m)]
    rows = pscn.stack_carries(singles)
    _bitwise(rows.bw_log, carry_j.bw_log, "init")
    _bitwise(rows.good, carry_j.good, "init")
    t = 0
    for width in (1, 3, 5, 1, 3, 5, 1, 5):
        window = range(t, t + width)
        for r in window:
            carry_j = step_j(carry_j, jnp.int32(r))
            singles = [pscn.step_carry(scn_p, base_p, c, r, i)
                       for i, c in enumerate(singles)]
        rows = pscn.step_carry_rows(scn_p, base_p, rows, window,
                                    torch.arange(m))
        for part in ("bw_log", "good"):
            got = getattr(rows, part)
            _bitwise(got, getattr(carry_j, part), f"{part} t<{t + width}")
            _bitwise(got, torch.stack([getattr(c, part) for c in singles]),
                     f"{part} per device t<{t + width}")
        t += width
    assert pscn.step_carry_rows(scn_p, base_p, rows, [], torch.arange(m)) \
        is rows


def test_dropout_mask_is_one_draw_per_device():
    """The vectorised mask bitwise the per-device uniform draws and the
    reference's, on global device ids that skip."""
    base_p, base_j = prng.PRNGKey(7), jax.random.PRNGKey(7)
    ids = np.array([0, 3, 4, 8, 11, 12, 17, 40], np.int64)
    dropped = 0
    for name in ("gilbert_flaky", "mobile_noniid"):
        scn_p, scn_j = pscn.SCENARIOS[name], jscn.SCENARIOS[name]
        for t in range(40):
            got = pscn.dropout_mask(scn_p, base_p, t, torch.from_numpy(ids))
            u = torch.stack([prng.uniform(pscn.stream_key(
                base_p, pscn.TAG_DROP, t, int(i))) for i in ids])
            assert torch.equal(got, u < scn_p.drop_probs(
                torch.from_numpy(ids)))
            _bitwise(got, jscn.dropout_mask(scn_j, base_j, jnp.int32(t),
                                            jnp.asarray(ids, jnp.int32)))
            dropped += int(got.sum())
    assert dropped > 0
    static = pscn.dropout_mask(pscn.SCENARIOS["static"], base_p, 0,
                               torch.from_numpy(ids))
    assert not static.any()


# ---------------------------------------------------------------------------
# the 100M task
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_qwen2_100m_masks_are_the_reference_round_masks(name):
    """M=8 devices, 6 rounds: every (M, C) int32 mask bitwise the
    reference's; the chains and dropout put a 0 among them wherever the
    scenario can drop a channel."""
    tj = j_make_100m(m_devices=8, preset="smoke", scenario=name,
                     aggregate="dense_masked", seed=2)
    tp = make_task("qwen2_100m", m_devices=8, preset="smoke", scenario=name,
                   aggregate="dense_masked", seed=2, device="cpu")
    state_j, state_p = tj._mask_state(), tp._mask_state()
    base_j, ids_j, carry_j = state_j
    base_p, ids_p, carry_p = state_p
    zeros = 0
    for t in range(6):
        carry_j, want = tj._round_mask(base_j, ids_j, carry_j, t)
        carry_p, got = tp._round_mask(base_p, ids_p, carry_p, t)
        _bitwise(got, want, f"round {t}")
        zeros += int((got == 0).sum())
    scn = pscn.SCENARIOS[name]
    assert (zeros > 0) == (scn.gilbert_elliott is not None
                           or scn.has_dropout)


@pytest.mark.parametrize("sparsity", [SATURATING, (0.01, 0.02, 0.02)])
def test_qwen2_100m_smoke_under_gilbert_flaky_matches_the_reference(
        sparsity):
    """One device, 3 rounds, the kernel route on every leaf
    (``pallas_min_elems=1``: the Pallas kernels in interpret mode against
    the port's plain row versions); the masks hold a 0."""
    arch_j = dataclasses.replace(j_smoke("qwen2-100m"), dtype=jnp.float32)
    arch_p = dataclasses.replace(p_smoke("qwen2-100m"), dtype=torch.float32)
    kw = dict(m_devices=1, scenario="gilbert_flaky", sparsity=sparsity,
              aggregate="dense_masked", pallas_min_elems=1)
    tj = j_make_100m(arch=arch_j, backend="pallas", **kw)
    p0 = jax.device_get(tj.build()["params"])   # before the step donates it
    out_j = tj.run(3)
    tp = make_task("qwen2_100m", arch=arch_p, backend="cuda", device="cpu",
                   **kw)
    tp.build(params=params_from_jax(p0))
    out_p = tp.run(3)
    masks = torch.stack(tp.masks)
    assert masks.dtype == torch.int32 and (masks == 0).any()
    assert (masks == 1).any()
    np.testing.assert_allclose(out_p["losses"], out_j["losses"], rtol=RTOL)
    flips = 0.0 if sparsity == SATURATING else MAX_FLIP_SHARE
    for what, got, want in (
            ("params", tp._built["params"], tj._built["params"]),
            ("ef", tp._built["ef"], tj._built["ef"])):
        want = {k: v.numpy() for k, v in params_from_jax(
            jax.device_get(want)).items()}
        assert list(got) == list(want)
        for k, b in want.items():
            a = got[k].numpy()
            assert a.shape == b.shape, k
            off = ~np.isclose(a, b, rtol=RTOL, atol=ATOL)
            assert off.mean() <= flips, (
                f"{what} {k}: {off.sum()} of {off.size} coordinates differ")
