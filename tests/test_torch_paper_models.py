"""The port's paper models (LR and CNN on synthetic MNIST) held against the
JAX reference: logits, loss and gradient with the reference's weights
carried across (rtol 1e-5 / atol 1e-6: XLA:CPU and ATen sum in other
orders), the initialisers against jax's (the CNN's ``he_normal`` bitwise,
the LR's ``normal`` bitwise below |n| = 2.9 and within 2 ulp above, see
tests/test_torch_prng.py), and the task factory's data.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import paper_models as jpm  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.models import paper_models as ppm  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
MODELS = {"lr": (jpm.lr_init, jpm.lr_logits, ppm.lr_init, ppm.lr_logits),
          "cnn": (jpm.cnn_init, jpm.cnn_logits, ppm.cnn_init,
                  ppm.cnn_logits)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: with the suite's workers
    sharing the cores, OpenMP's barriers wait on descheduled threads.
    Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(n: int, seed: int):
    (x, y), _ = jpm.load_synthetic_mnist(n_train=n, n_test=1, seed=seed)
    return x, y


def _ulp(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    def ordered(v):
        i = np.asarray(v, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(ordered(a) - ordered(b))


@pytest.mark.parametrize("model", ["lr", "cnn"])
@pytest.mark.parametrize("seed", [0, 3])
def test_logits_loss_and_gradient_match(model, seed):
    j_init, j_logits, _, p_logits = MODELS[model]
    params_j = j_init(jax.random.PRNGKey(seed))
    x, y = _batch(16, seed)
    params_p = params_from_jax(jax.tree_util.tree_map(np.asarray, params_j))
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    logits_j = jax.jit(j_logits)(params_j, jnp.asarray(x))
    np.testing.assert_allclose(p_logits(params_p, xt).numpy(),
                               np.asarray(logits_j), rtol=RTOL, atol=ATOL)

    def j_loss(p):
        return jpm._xent(j_logits(p, jnp.asarray(x)), jnp.asarray(y))
    loss_j, grad_j = jax.jit(jax.value_and_grad(j_loss))(params_j)
    leaves = {k: v.clone().requires_grad_(True) for k, v in params_p.items()}
    loss_p = ppm._xent(p_logits(leaves, xt), yt)
    grads = torch.autograd.grad(loss_p, list(leaves.values()))
    np.testing.assert_allclose(float(loss_p.detach()), float(loss_j),
                               rtol=RTOL)
    grad_j = params_from_jax(jax.tree_util.tree_map(np.asarray, grad_j))
    for k, g in zip(leaves, grads):
        np.testing.assert_allclose(g.numpy(), grad_j[k].numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    acc_j = jpm._acc(logits_j, jnp.asarray(y))
    assert float(ppm._acc(p_logits(params_p, xt), yt)) == float(acc_j)


@pytest.mark.parametrize("seed", [0, 1, 2, 2 ** 31 - 1])
def test_initialisers_match_jax(seed):
    cnn_j = params_from_jax(jax.tree_util.tree_map(
        np.asarray, jpm.cnn_init(jax.random.PRNGKey(seed))))
    cnn_p = ppm.cnn_init(prng.PRNGKey(seed))
    assert list(cnn_p) != sorted(cnn_p)        # flatten_tree sorts, not dict order
    assert sorted(cnn_p) == list(cnn_j)
    for k in cnn_j:
        assert cnn_p[k].dtype == torch.float32
        np.testing.assert_array_equal(cnn_p[k].numpy().view(np.int32),
                                      cnn_j[k].numpy().view(np.int32),
                                      err_msg=k)
    lr_j = params_from_jax(jax.tree_util.tree_map(
        np.asarray, jpm.lr_init(jax.random.PRNGKey(seed))))
    lr_p = ppm.lr_init(prng.PRNGKey(seed))
    np.testing.assert_array_equal(lr_p["b"].numpy(), lr_j["b"].numpy())
    w_p, w_j = lr_p["w"].numpy(), lr_j["w"].numpy()
    body = np.abs(w_j) < 2.9 * 0.01
    np.testing.assert_array_equal(w_p[body].view(np.int32),
                                  w_j[body].view(np.int32))
    assert _ulp(w_p, w_j).max() <= 2


@pytest.mark.parametrize("name,partition", [("lr_mnist", None),
                                            ("cnn_mnist", "dirichlet")])
def test_make_task_data_match(name, partition):
    kw = {"n_train": 300} | ({"partition": partition} if partition else {})
    tj = jpm.make_task(name, m_devices=3, seed=2, **kw)
    tp = ppm.make_task(name, m_devices=3, seed=2, **kw)
    assert tp.name == tj.name
    for (xp, yp), (xj, yj) in zip(tp.device_data, tj.device_data):
        np.testing.assert_array_equal(xp, xj)
        np.testing.assert_array_equal(yp, yj)
    for a, b in zip(tp.eval_data, tj.eval_data):
        np.testing.assert_array_equal(a, b)
    tp_s = ppm.make_task(name, m_devices=3, seed=2, n_train=300,
                         scenario="dirichlet0.3")
    tj_s = jpm.make_task(name, m_devices=3, seed=2, n_train=300,
                         scenario="dirichlet0.3")
    for (_, yp), (_, yj) in zip(tp_s.device_data, tj_s.device_data):
        np.testing.assert_array_equal(yp, yj)


def test_registry():
    assert sorted(ppm.TASKS) == sorted(jpm.TASKS)
    for name, spec in ppm.TASKS.items():
        ref = jpm.TASKS[name]
        assert (spec.model, spec.dataset, spec.partition) == \
            (ref.model, ref.dataset, ref.partition)
    rnn = ppm.make_task("rnn_shakespeare", n_train=30, seq=8, n_eval=4)
    assert rnn.name == "rnn-shakespeare" and len(rnn.device_data) == 3
    with pytest.raises(ValueError):
        ppm.make_task("nope")
    with pytest.raises(ValueError):
        ppm.make_mnist_task("gru")
