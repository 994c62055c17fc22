"""The char-RNN task ``rnn_shakespeare`` of the port held against the JAX
reference.

* Data: the token stream, the train / test split, the windows, the
  federated shards and the eval arrays bitwise the reference's
  (``repro_torch.data.shakespeare`` is its numpy copy), under each
  partition; the eval tail disjoint from every shard.
* Model: ``rnn_init`` bitwise (``split(key, 5)``, the embedding's
  ``normal`` and four ``glorot_normal`` leaves), ``rnn_logits`` and the
  loss gradient allclose at rtol 1e-5 (XLA:CPU's and ATen's ``sigmoid``,
  ``tanh`` and matmul sums differ in ulps), also under
  ``torch.func.vmap(torch.func.grad(...))`` as the batched engine calls it.
* Engines: History of the port's loop and batched engines against the
  reference's batched engine at seq 16, n_train 300, 8 rounds, batch 16
  (``step`` and ``uplink_mb`` equal, loss and accuracy within atol 1e-4,
  the cost fields within rtol 1e-5), static and under ``mobile_noniid``;
  the batched engine never samples a padding row of the ragged shards.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core.fl as jfl  # noqa: E402
from repro.data import shakespeare as jsh  # noqa: E402
from repro.models import paper_models as jpm  # noqa: E402
import repro_torch.core.fl as pfl  # noqa: E402
from repro_torch.core import fl_batched as pfb  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.data import partition_iid  # noqa: E402
from repro_torch.data import shakespeare as psh  # noqa: E402
from repro_torch.models import paper_models as ppm  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
PARAMS = 83_955          # V = 51, embedding 64, GRU hidden 128


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: with the suite's workers
    sharing the cores, OpenMP's barriers wait on descheduled threads.
    Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("seed", [0, 3])
def test_stream_split_and_windows_match_the_reference(seed):
    assert psh.CHAR_VOCAB == jsh.CHAR_VOCAB and psh.VOCAB_SIZE == 51
    for n_chars in (5_000, 200_000):
        s_p = psh.load_shakespeare(n_chars, seed=seed)
        s_j = jsh.load_shakespeare(n_chars, seed=seed)
        assert s_p.dtype == s_j.dtype == np.int32
        np.testing.assert_array_equal(s_p, s_j)
    for frac in (0.15, 0.5):
        for a, b in zip(psh.split_stream(s_p, frac),
                        jsh.split_stream(s_j, frac)):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(psh.char_windows(s_p, 64, 48,
                                     np.random.default_rng(seed)),
                    jsh.char_windows(s_j, 64, 48,
                                     np.random.default_rng(seed))):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        psh.split_stream(s_p, 1.0)


@pytest.mark.parametrize("partition", ["dirichlet", "iid", "noniid",
                                       "quantity"])
def test_shards_and_eval_arrays_match_the_reference(partition):
    kw = dict(m_devices=5, seq=24, n_train=500, n_eval=64, seed=4,
              partition=partition)
    tp = ppm.make_shakespeare_task(**kw)
    tj = jpm.make_shakespeare_task(**kw)
    assert tp.name == tj.name == "rnn-shakespeare"
    assert len(tp.device_data) == len(tj.device_data) == 5
    for (xp, yp), (xj, yj) in zip(tp.device_data, tj.device_data):
        assert xp.dtype == np.int32
        np.testing.assert_array_equal(xp, xj)
        np.testing.assert_array_equal(yp, yj)
        np.testing.assert_array_equal(xp[:, 1:], yp[:, :-1])
    for a, b in zip(tp.eval_data, tj.eval_data):
        np.testing.assert_array_equal(a, b)
    if partition != "noniid":            # the exact partitions
        assert sum(y.shape[0] for _, y in tp.device_data) == 500


def test_registry_defaults_and_scenario_partition_match_the_reference():
    """``make_task("rnn_shakespeare")`` at the factory's defaults (2,000
    windows of 48 per device) and with a scenario's partition."""
    tp = ppm.make_task("rnn_shakespeare", m_devices=8)
    tj = jpm.make_task("rnn_shakespeare", m_devices=8)
    assert sum(x.shape[0] for x, _ in tp.device_data) == 16_000
    assert tp.eval_data[0].shape == (1024, 48)
    for (xp, _), (xj, _) in zip(tp.device_data, tj.device_data):
        np.testing.assert_array_equal(xp, xj)
    sp = ppm.make_task("rnn_shakespeare", m_devices=4, n_train=400, seq=16,
                       scenario="mobile_noniid")
    sj = jpm.make_task("rnn_shakespeare", m_devices=4, n_train=400, seq=16,
                       scenario="mobile_noniid")
    for (xp, _), (xj, _) in zip(sp.device_data, sj.device_data):
        np.testing.assert_array_equal(xp, xj)


def test_eval_split_is_disjoint():
    """An arange stream: token values are stream positions, so no shard
    window may reach the test tail and no eval window the train split."""
    stream = np.arange(5000, dtype=np.int32)
    train, test = psh.split_stream(stream, test_frac=0.2)
    assert train.size + test.size == stream.size
    shards, (xte, yte) = psh.char_shards(
        stream, 4, seq=16, n_train=200, n_eval=64, seed=3,
        partition_fn=lambda x, y, m, seed: partition_iid(x, y, m, seed),
        test_frac=0.2)
    for x, y in shards:
        assert x.max() < train.size and y.max() < train.size
    assert xte.min() >= train.size and yte.min() >= train.size


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 5, 2 ** 31 - 1])
def test_rnn_init_is_the_reference_bitwise(seed):
    pj = jpm.rnn_init(jax.random.PRNGKey(seed))
    pp = ppm.rnn_init(prng.PRNGKey(seed))
    assert sorted(pp) == sorted(pj)
    for k, v in pj.items():
        a = np.asarray(v)
        b = pp[k].numpy()
        assert b.shape == a.shape and b.dtype == a.dtype, k
        np.testing.assert_array_equal(b.view(np.int32), a.view(np.int32),
                                      err_msg=k)
    assert sum(v.numel() for v in pp.values()) == PARAMS


def _model_inputs(seed: int, b: int = 8, s: int = 48):
    pj = jpm.rnn_init(jax.random.PRNGKey(seed))
    stream = psh.load_shakespeare(20_000, seed=seed)
    x, y, _ = psh.char_windows(stream, b, s, np.random.default_rng(seed))
    return pj, x, y


@pytest.mark.parametrize("seed", [0, 1])
def test_rnn_logits_and_gradient_match(seed):
    pj, x, y = _model_inputs(seed)
    pt = params_from_jax(jax.tree_util.tree_map(np.asarray, pj))
    want = np.asarray(jpm.rnn_logits(pj, jnp.asarray(x)))
    got = ppm.rnn_logits(pt, torch.from_numpy(x))
    assert got.shape == (8, 48, psh.VOCAB_SIZE)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)

    def j_loss(p):
        return jpm._xent(jpm.rnn_logits(p, jnp.asarray(x)), jnp.asarray(y))
    loss_j, g_j = jax.value_and_grad(j_loss)(pj)
    leaves = {k: v.clone().requires_grad_(True) for k, v in pt.items()}
    loss_p = ppm._xent(ppm.rnn_logits(leaves, torch.from_numpy(x)),
                       torch.from_numpy(y))
    g_p = torch.autograd.grad(loss_p, list(leaves.values()))
    np.testing.assert_allclose(loss_p.detach().item(), float(loss_j),
                               rtol=RTOL)
    for k, g in zip(leaves, g_p):
        np.testing.assert_allclose(g.numpy(), np.asarray(g_j[k]), rtol=RTOL,
                                   atol=ATOL, err_msg=k)


def test_rnn_gradient_under_vmap_is_the_per_row_gradient():
    """The batched engine's ``vmap(grad(loss))`` over stacked flat rows of
    two devices against ``autograd.grad`` row by row, int32 tokens."""
    pj, x, y = _model_inputs(2, b=6, s=12)
    pt = params_from_jax(jax.tree_util.tree_map(np.asarray, pj))
    names = sorted(pt)
    sizes = [pt[k].numel() for k in names]
    flat = torch.cat([pt[k].reshape(-1) for k in names])
    rows = torch.stack([flat, flat * 0.5])
    xs = torch.from_numpy(np.stack([x[:3], x[3:]]))
    ys = torch.from_numpy(np.stack([y[:3], y[3:]]))

    def loss_of_flat(w, xb, yb):
        parts = torch.split(w, sizes)
        p = {k: v.view(pt[k].shape) for k, v in zip(names, parts)}
        return ppm._xent(ppm.rnn_logits(p, xb), yb)
    got = torch.func.vmap(torch.func.grad(loss_of_flat))(rows, xs, ys)
    for r in range(2):
        w = rows[r].clone().requires_grad_(True)
        want, = torch.autograd.grad(loss_of_flat(w, xs[r], ys[r]), [w])
        np.testing.assert_allclose(got[r].numpy(), want.numpy(), rtol=RTOL,
                                   atol=1e-7)


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------

def _ks(d: int = PARAMS) -> list[int]:
    k_total = d // 20
    return [k_total // 2, k_total // 4, k_total - k_total // 2 - k_total // 4]


@pytest.mark.parametrize("scenario,backend", [(None, "exact"),
                                              ("mobile_noniid", "pallas")])
def test_history_matches_the_reference_batched_engine(scenario, backend):
    m = 3
    kw = dict(m_devices=m, n_train=300, seq=16, scenario=scenario)
    tj = jpm.make_task("rnn_shakespeare", **kw)
    tp = ppm.make_task("rnn_shakespeare", **kw)
    p0 = jax.tree_util.tree_map(np.asarray, tj.init(jax.random.PRNGKey(0)))
    tj.init = lambda key: jax.tree_util.tree_map(jnp.asarray, p0)
    pp = params_from_jax(p0)
    tp.init = lambda key: {k: v.clone() for k, v in pp.items()}
    cfg = dict(rounds=8, eval_every=4, batch_size=16,
               scenario=scenario or "static")
    hj = jfl.LGCSimulator(
        tj, jfl.FLConfig(engine="batched", **cfg),
        [jfl.FixedController(4, _ks()) for _ in range(m)],
        backend=backend).run()
    for engine in ("loop", "batched"):
        hp = pfl.LGCSimulator(
            tp, pfl.FLConfig(engine=engine, **cfg),
            [pfl.FixedController(4, _ks()) for _ in range(m)],
            backend=backend, device="cpu").run()
        assert hp.step == hj.step
        assert hp.uplink_mb == hj.uplink_mb
        np.testing.assert_allclose(hp.loss, hj.loss, atol=1e-4)
        np.testing.assert_allclose(hp.accuracy, hj.accuracy, atol=1e-4)
        for field in ("energy_j", "money", "time_s", "server_wall_s"):
            np.testing.assert_allclose(getattr(hp, field),
                                       getattr(hj, field), rtol=1e-5)
    assert hp.loss[-1] < hp.loss[0]


def test_batched_engine_never_samples_a_padding_row():
    """Ragged token shards (Dirichlet over regions): the stacked data is
    zero past each device's rows, and every minibatch index of a window
    stays below that device's row count."""
    tp = ppm.make_task("rnn_shakespeare", m_devices=4, n_train=200, seq=8,
                       partition="dirichlet", alpha=0.3)
    ns = [x.shape[0] for x, _ in tp.device_data]
    assert len(set(ns)) > 1
    sim = pfl.LGCSimulator(tp, pfl.FLConfig(rounds=4, batch_size=32),
                           [pfl.FixedController(4, _ks()) for _ in ns],
                           device="cpu")
    eng = pfb.BatchedEngine(sim)
    (x, y), n_dev = eng.data, eng.n_dev
    assert x.dtype == torch.int32 and n_dev.tolist() == ns
    for m, n in enumerate(ns):
        np.testing.assert_array_equal(x[m, :n].numpy(), tp.device_data[m][0])
        assert not x[m, n:].any()
    idx = eng._draw_batches(0, 40)
    assert idx.shape == (40, 4, 32)
    assert bool((idx < n_dev[None, :, None]).all()) and bool((idx >= 0).all())
