"""The port's DDPG control plane held against the reference
(``repro.core.controller``, ``repro.optim.optimizers``).

The randomness is bitwise the reference's: the initial nets, the
exploration noise, the replay indices, the reward-eval subsets.  So is
the arithmetic the reference's XLA:CPU programs apply elementwise (its
``tanh`` and the fused multiply-adds of AdamW, the noise and the soft
update) and the order of the forward dots in training.  The rest (the
gradients' sums) agrees to float summation order, so the fleets are held
in lockstep: both take the same states, masks and loss drops at each
boundary, the port is compared and then re-loaded from the reference
(``weights.ddpg_from_jax``).  Within the port, a fleet and a list of
single agents are bitwise equal on both engines.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core.controller as jc  # noqa: E402
import repro.core.fl as jfl  # noqa: E402
import repro_torch.core.controller as pc  # noqa: E402
import repro_torch.core.fl as pfl  # noqa: E402
from repro.core.scenario import (TAG_CTRL_NOISE, TAG_CTRL_SAMPLE,  # noqa: E402
                                 TAG_REWARD)
from repro.core.scenario import stream_key as j_stream_key  # noqa: E402
from repro.models.paper_models import make_task as j_make_task  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.models.paper_models import make_task  # noqa: E402
from repro_torch.optim import optimizers as popt  # noqa: E402
from repro_torch.weights import (DDPG_HOST, ddpg_from_jax,  # noqa: E402
                                 ddpg_to_jax, params_from_jax)

from _hypothesis_compat import given, settings, st  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)
J_STATE = ("actor", "critic", "actor_t", "critic_t", "opt_a", "opt_c",
           *DDPG_HOST)


def _jstate(fleet) -> dict:
    """A reference fleet's state as numpy, by attribute name."""
    return {k: jax.tree_util.tree_map(np.asarray, getattr(fleet, k))
            for k in J_STATE}


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _equal_bits(a, b, what=""):
    np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=what)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The fleet and the simulator issue many small ops: one intra-op
    thread each keeps the parallel test workers from oversubscribing the
    host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _fleets(m=3, **kw):
    cfg = dict(k_total_max=392, batch_size=4, seed=0) | kw
    return (jc.FleetDDPG(m, jc.DDPGConfig(**cfg)),
            pc.FleetDDPG(m, pc.DDPGConfig(**cfg), device="cpu"))


# ---------------------------------------------------------------------------
# decode and widths
# ---------------------------------------------------------------------------

def _unit(i: int) -> float:
    return max(-1.0, min(1.0, i / 1000.0))


@st.composite
def action_batches(draw):
    """(a (M, 1+C), h_max, k_total_max, battery (M,) | None), the cases of
    tests/test_controller_actions.py."""
    m = draw(st.integers(min_value=1, max_value=16))
    n_ch = draw(st.integers(min_value=1, max_value=5))
    h_max = draw(st.integers(min_value=1, max_value=12))
    k_total = draw(st.integers(min_value=0, max_value=4000))
    flat = draw(st.lists(st.integers(min_value=-1500, max_value=1500),
                         min_size=m * (1 + n_ch), max_size=m * (1 + n_ch)))
    a = np.array([_unit(v) for v in flat], np.float64).reshape(m, 1 + n_ch)
    battery = None
    if draw(st.booleans()):
        bl = draw(st.lists(st.integers(min_value=0, max_value=1000),
                           min_size=m, max_size=m))
        battery = np.array(bl, np.float64) / 1000.0
    return a, h_max, k_total, battery


@given(action_batches())
@settings(max_examples=60, deadline=None)
def test_decode_actions_equals_the_reference(case):
    a, h_max, k_total, battery = case
    n_ch = a.shape[1] - 1
    got = pc.decode_actions(a, h_max, k_total, n_ch, battery=battery)
    want = jc.decode_actions(a, h_max, k_total, n_ch, battery=battery)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    # one row alone decodes as in the batch
    h1, ks1 = pc.decode_actions(a[0], h_max, k_total, n_ch, battery=(
        None if battery is None else battery[:1]))
    assert h1 == got[0][0] and (ks1 == got[1][0]).all()


def test_observation_widths_and_their_checks():
    for n_ch in (1, 3, 5):
        for space in ("shared", "per_device"):
            assert pc.obs_dim(n_ch, space) == jc.obs_dim(n_ch, space)
    assert (pc.SPEND_DIM, pc.PROFILE_DIM, pc.BATTERY_COL) == \
        (jc.SPEND_DIM, jc.PROFILE_DIM, jc.BATTERY_COL)
    with pytest.raises(ValueError, match="action_space"):
        pc.obs_dim(3, "layered")
    with pytest.raises(ValueError, match=r"state_dim=4.*width 9"):
        pc.DDPGConfig(state_dim=4, action_space="per_device")
    with pytest.raises(ValueError, match=r"state_dim=9.*width 4"):
        pc.DDPGConfig(state_dim=9, action_space="shared")
    fleet = pc.make_fleet_ddpg(2, 1000, action_space="per_device",
                               device="cpu")
    assert fleet.cfg.state_dim == 9
    with pytest.raises(ValueError, match=r"width 4.*state_dim=9"):
        fleet.act(np.zeros((2, 4), np.float32))
    with pytest.raises(ValueError, match=r"width 4.*state_dim=9"):
        fleet.observe(np.zeros(2), np.zeros((2, 4), np.float32))
    # a zero battery pins h to the one mandatory step, act and allocation
    states = np.ones((2, 9), np.float32)
    states[:, pc.BATTERY_COL] = 0.0
    assert (fleet.act(states)[0] == 1).all()
    assert (fleet.allocation(states[0])[0] == 1).all()


def test_fleet_runs_on_the_card_or_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = pc.DDPGConfig(k_total_max=100)
    for make in (lambda: pc.FleetDDPG(2, cfg),
                 lambda: pc.DDPGController(cfg),
                 lambda: pc.make_fleet_ddpg(2, 1000),
                 lambda: pc.make_ddpg_controllers(2, 1000)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    assert pc.FleetDDPG(2, cfg, device="cpu").device.type == "cpu"
    ctrls = pc.make_ddpg_controllers(2, 1000, device="cpu")
    assert [c._fleet.device.type for c in ctrls] == ["cpu", "cpu"]


# ---------------------------------------------------------------------------
# randomness and XLA:CPU's arithmetic, bitwise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("space", ["shared", "per_device"])
def test_initial_nets_are_bitwise_the_reference(space):
    state_dim = pc.obs_dim(3, space)
    jf, pf = _fleets(4, seed=11, state_dim=state_dim, action_space=space)
    got, want = ddpg_to_jax(pf), _jstate(jf)
    for k in ("actor", "critic", "actor_t", "critic_t"):
        for layer_got, layer_want in zip(got[k], want[k]):
            for leaf in ("w", "b"):
                _equal_bits(layer_got[leaf], layer_want[leaf], (k, leaf))
    for k in ("opt_a", "opt_c"):
        np.testing.assert_array_equal(got[k][0], want[k][0])


def test_exploration_noise_and_replay_indices_are_bitwise():
    bases = [prng.PRNGKey(7 + 17 * m) for m in range(3)]
    j_bases = [jax.random.PRNGKey(7 + 17 * m) for m in range(3)]
    counters = np.array([0, 5, 1234])
    got = pc._noise(bases, counters, 4).numpy()
    want = np.stack([np.asarray(jax.random.normal(
        j_stream_key(b, TAG_CTRL_NOISE, int(c)), (4,)))
        for b, c in zip(j_bases, counters)])
    _equal_bits(got, want)
    for n_train, n_filled in ((0, 4), (17, 4096), (3, 0), (99, 77)):
        got = pc._replay_indices(bases[1], n_train, n_filled, 16)
        want = np.asarray(jax.random.randint(
            j_stream_key(j_bases[1], TAG_CTRL_SAMPLE, n_train), (16,), 0,
            max(n_filled, 1)))
        np.testing.assert_array_equal(got, want)


def test_tanh_and_its_gradient_are_xla_cpus():
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.normal(size=20000).astype(np.float32) * s
        for s in (1e-3, 0.3, 1.0, 3.0, 10.0)] + [np.array(
            [0.0004, -0.0004, 3.9e-4, 7.9988117, 7.99881172180175781, 8.5,
             -9.0, 1e-38, 0.0], np.float32)])
    w = rng.normal(size=x.shape).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = pc._Tanh.apply(xt)
    (g,) = torch.autograd.grad((y * torch.from_numpy(w)).sum(), xt)
    _equal_bits(y.detach().numpy(), jax.jit(jnp.tanh)(x))
    _equal_bits(g.numpy(), jax.jit(jax.grad(
        lambda v: jnp.sum(jnp.tanh(v) * w)))(x))


@pytest.mark.parametrize("b,k,n,lanes", [
    (4, 4, 64, 1), (4, 9, 64, 1), (4, 13, 64, 1), (4, 64, 64, 1),
    (4, 64, 4, 4), (64, 8, 64, 1), (64, 64, 4, 4)])
def test_training_dots_sum_in_xla_cpus_order(b, k, n, lanes):
    """Inside the reference's lax.map body (its fleet programs), as the
    port's training forward runs them."""
    rng = np.random.default_rng(k * n + b)
    x = rng.normal(size=(3, b, k)).astype(np.float32)
    w = rng.normal(size=(3, k, n)).astype(np.float32)
    want = jax.jit(lambda x, w: jax.lax.map(lambda a: a[0] @ a[1],
                                            (x, w)))(x, w)
    got = pc.xla_dot(torch.from_numpy(x), torch.from_numpy(w), lanes)
    _equal_bits(got.numpy(), want)


def test_adamw_step_is_bitwise_the_reference():
    """One step from the same gradients (their global norm below the clip,
    and above it: then the norm, summed in XLA:CPU's order, scales them)
    gives bitwise the reference's moments and parameters; the bias
    corrections over steps 1-200 are XLA:CPU's."""
    steps = np.arange(1, 201, dtype=np.int32)
    for beta in (0.9, 0.95):
        want = jax.jit(lambda s: 1 - beta ** s)(jnp.asarray(steps))
        _equal_bits(popt._bias(beta, steps), want)
    rng = np.random.default_rng(1)
    shapes = [(4, 64), (64,), (64, 4), (4,)]
    tree = [{"w": rng.normal(size=shapes[0]), "b": rng.normal(size=shapes[1])},
            {"w": rng.normal(size=shapes[2]), "b": rng.normal(size=shapes[3])}]
    tree = jax.tree_util.tree_map(lambda a: (a * 0.1).astype(np.float32),
                                  tree)
    m = jax.tree_util.tree_map(lambda a: a * np.float32(0.01), tree)
    v = jax.tree_util.tree_map(lambda a: a * a * np.float32(1e-3), tree)
    cfg = dict(lr=1e-3, warmup_steps=1, weight_decay=0.0)
    for scale in (1e-3, 10.0):
        grads = jax.tree_util.tree_map(lambda a: a * np.float32(scale), tree)
        j_step = jax.jit(lambda g, s, p: (lambda u: (jopt.apply_updates(
            p, u[0]), u[1]))(jopt.adamw_update(jopt.OptimizerConfig(**cfg),
                                               g, s, p)))
        jp, js = j_step(grads, jopt.AdamWState(jnp.int32(6), m, v), tree)
        T = lambda t: jax.tree_util.tree_map(torch.from_numpy, t)  # noqa: E731
        pp, ps = popt.adamw_apply(popt.OptimizerConfig(**cfg), T(grads),
                                  popt.AdamWState(6, T(m), T(v)), T(tree))
        assert ps.step == int(js.step) == 7
        for got, want in ((pp, jp), (ps.m, js.m), (ps.v, js.v)):
            for g_leaf, w_leaf in zip(jax.tree_util.tree_leaves(got),
                                      jax.tree_util.tree_leaves(want)):
                _equal_bits(g_leaf.numpy(), w_leaf)
        # the unfused pair: updates, then p + u
        up, _ = popt.adamw_update(popt.OptimizerConfig(**cfg), T(grads),
                                  popt.AdamWState(6, T(m), T(v)), T(tree))
        for g_leaf, w_leaf in zip(
                jax.tree_util.tree_leaves(popt.apply_updates(T(tree), up)),
                jax.tree_util.tree_leaves(jp)):
            np.testing.assert_allclose(g_leaf.numpy(), w_leaf, **TOL)


# ---------------------------------------------------------------------------
# the reward eval
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lr_tasks():
    """(reference, port) lr_mnist at the tests/test_fl.py:20 fixture size,
    the port starting from the reference's initial params."""
    tj = j_make_task("lr_mnist", m_devices=3, n_train=1200)
    tp = make_task("lr_mnist", m_devices=3, n_train=1200)
    p0 = params_from_jax(jax.tree_util.tree_map(
        np.asarray, tj.init(jax.random.PRNGKey(0))))
    tp.init = lambda key: {k: v.clone() for k, v in p0.items()}
    return tj, tp


def test_reward_subsets_are_bitwise_and_losses_close(lr_tasks):
    tj, tp = lr_tasks
    fixed = [[jfl.FixedController(4, [200, 100, 100])] * 3,
             [pfl.FixedController(4, [200, 100, 100])] * 3]
    sj = jfl.LGCSimulator(tj, jfl.FLConfig(rounds=4), fixed[0])
    sp = pfl.LGCSimulator(tp, pfl.FLConfig(rounds=4), fixed[1],
                          device="cpu")
    n = tj.eval_data[0].shape[0]
    for ms, t in (([0, 1, 2], 3), ([1], 118), ([2, 0], 7)):
        rows = sp._reward_rows(ms, t).numpy()
        for j, m in enumerate(ms):
            want = jax.random.randint(j_stream_key(
                sj._base, TAG_REWARD, t, m), (min(512, n),), 0, n)
            np.testing.assert_array_equal(rows[j], np.asarray(want))
        np.testing.assert_allclose(sp._reward_losses(ms, t),
                                   sj._reward_losses(ms, t), rtol=1e-6)


# ---------------------------------------------------------------------------
# lockstep with the reference fleet
# ---------------------------------------------------------------------------

def test_lockstep_with_the_reference_fleet():
    """30 boundaries of seeded states (spends from 1e-2 to 1e3, where the
    policies' tanh saturates), act masks and loss drops into a reference
    FleetDDPG(3, batch_size=4) and the port's; the port is re-loaded from
    the reference after each."""
    jf, pf = _fleets(3)
    rng = np.random.default_rng(0)
    decided = 0
    for _ in range(30):
        states = np.abs(rng.normal(size=(3, 4)) * 10 ** rng.uniform(
            -2, 3, size=(3, 4))).astype(np.float32)
        mask = rng.random(3) < 0.8
        hj, kj = jf.act(states, mask)
        hp, kp = pf.act(states, mask)
        np.testing.assert_allclose(pf._last_a[mask], jf._last_a[mask], **TOL)
        # decisions equal wherever the raw gap cannot cross a decode edge
        gap = float(np.abs(pf._last_a - jf._last_a).max())
        for i in np.nonzero(mask)[0]:
            if _decode_margin(jf._last_a[i], jf.cfg) > 4 * gap:
                assert hp[i] == hj[i] and (kp[i] == kj[i]).all()
                decided += 1
        new = states + np.abs(rng.normal(size=(3, 4))).astype(np.float32)
        drops = rng.normal(size=3) * 0.1
        omask = rng.random(3) < 0.9
        jf.observe(drops, new, omask)
        pf.observe(drops, new, omask)
        assert [list(r) for r in pf.rewards] == [list(r) for r in jf.rewards]
        for k in ("_n", "_idx", "_n_train"):
            np.testing.assert_array_equal(getattr(pf, k), getattr(jf, k))
        got, want = ddpg_to_jax(pf), _jstate(jf)
        for k in ("actor", "critic", "actor_t", "critic_t"):
            for lg, lw in zip(got[k], want[k]):
                for leaf in ("w", "b"):
                    np.testing.assert_allclose(lg[leaf], lw[leaf], **TOL,
                                               err_msg=f"{k} {leaf}")
        for k in ("opt_a", "opt_c"):
            np.testing.assert_array_equal(got[k][0], want[k][0])
            for part in (1, 2):
                for lg, lw in zip(got[k][part], want[k][part]):
                    for leaf in ("w", "b"):
                        np.testing.assert_allclose(lg[leaf], lw[leaf], **TOL)
        for i in range(3):
            np.testing.assert_allclose(pf.critic_losses[i],
                                       jf.critic_losses[i], rtol=1e-5)
        ddpg_from_jax(want, pf)
    assert (jf._n_train >= 10).all()      # training engaged on every device
    assert decided >= 30


def _decode_margin(a: np.ndarray, cfg) -> float:
    """How far (in raw action units) ``a`` lies from the nearest edge of
    its decode: the rounding of h, the floor of each budget."""
    h_scale = (cfg.h_max - 1) / 2
    x = (a[0] + 1) * h_scale
    margin = abs(x - np.floor(x) - 0.5) / max(h_scale, 1e-9)
    w = np.exp(2.0 * a[1:])
    w = w / w.sum()
    k = w * max(cfg.n_channels, cfg.k_total_max)
    # d w_c / d a_j <= 2 w_c in every direction; the budget's floor edges
    frac = np.minimum(k - np.floor(k), np.ceil(k) - k)
    return float(min(margin, (frac / (4 * k + 1e-9)).min()))


# ---------------------------------------------------------------------------
# fleet == list, and the policy's public view
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ["loop", "batched"])
def test_fleet_matches_agent_list_bitwise(lr_tasks, engine):
    _, tp = lr_tasks
    d = 7850
    k_total = max(3, d // 20)

    def controllers(kind):
        if kind == "list":
            return [pc.DDPGController(pc.DDPGConfig(
                k_total_max=k_total, batch_size=4, seed=5 + 17 * m),
                device="cpu") for m in range(3)]
        return pc.FleetDDPG(3, pc.DDPGConfig(
            k_total_max=k_total, batch_size=4, seed=5), device="cpu")

    runs = {}
    for kind in ("list", "fleet"):
        sim = pfl.LGCSimulator(tp, pfl.FLConfig(rounds=40, eval_every=10,
                                                engine=engine),
                               controllers(kind), device="cpu")
        hist = sim.run()
        trains = (sim.fleet._n_train.copy() if kind == "fleet" else
                  np.array([c._fleet._n_train[0] for c in
                            sim.fleet.controllers]))
        runs[kind] = (sim.decision_log, hist.asdict(), trains)
    assert (runs["fleet"][2] > 0).all()          # DDPG trained everywhere
    assert runs["fleet"][0] == runs["list"][0]
    assert runs["fleet"][1] == runs["list"][1]
    np.testing.assert_array_equal(runs["fleet"][2], runs["list"][2])


def test_allocation_is_greedy_and_stream_free():
    """allocation() exposes the learned policy without consuming the
    exploration stream: interleaving it does not change act()."""
    def mk():
        return pc.DDPGController(pc.DDPGConfig(k_total_max=500, seed=9),
                                 device="cpu")
    probe = np.array([10.0, 0.1, 5.0, 1.0], np.float32)
    c1, c2 = mk(), mk()
    seq1 = [c1.act(probe) for _ in range(4)]
    seq2 = []
    for _ in range(4):
        c2.allocation(probe)
        seq2.append(c2.act(probe))
    assert [(d.h, tuple(d.ks)) for d in seq1] == \
        [(d.h, tuple(d.ks)) for d in seq2]
    d1, d2 = c1.allocation(probe), c1.allocation(probe)
    assert (d1.h, tuple(d1.ks)) == (d2.h, tuple(d2.ks))
    # a fleet broadcasts one probe to every device's policy
    fleet = pc.make_fleet_ddpg(5, 7850, device="cpu")
    hs, kss = fleet.allocation(probe)
    assert hs.shape == (5,) and kss.shape == (5, 3)
    assert (fleet._n_act == 0).all()
