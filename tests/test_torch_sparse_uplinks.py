"""The port's sparse uplinks (``sparse_gather``, ``bucket_sparse``) held
against the JAX reference.

Per leaf the port's row functions are bitwise the reference's
``_compress_leaf_sparse`` / ``_compress_leaf_bucket`` run in a 1-device
``shard_map`` (as tests/test_lgc_step.py runs them): a 2-d leaf, a stacked
3-d leaf, the clamped budgets of a 64-element bias and a 2-element leaf,
a tie at the k_eff cutoff and a dropped channel.  At M = 3 the server's
sum is composed from the reference's own pieces: each device's
contribution on each channel (a one-hot delivery mask), added channel
outer, device inner.  Trajectories run the TINY config of
tests/test_torch_lgc_step.py against the reference task at its tolerance.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.launch import compat  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.launch.mesh import fl_axis_name, make_host_mesh  # noqa: E402
from repro.models.lgc_transformer import make_qwen2_100m_task as j_make  # noqa: E402
from repro_torch.launch import steps as psteps  # noqa: E402
from repro_torch.models.lgc_transformer import make_qwen2_100m_task as p_make  # noqa: E402
from repro_torch.models.paper_models import make_task  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402
from test_torch_lgc_step import (MAX_FLIP_SHARE, P_TINY, RTOL, SATURATING,  # noqa: E402
                                 SPARSE, TINY, _assert_trees_close)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: its reductions in XLA:CPU's
    order and its small trainers are thousands of tiny ops, and with the
    suite's workers sharing the cores OpenMP's barriers wait on descheduled
    threads.  Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


DEFAULT = (0.01, 0.02, 0.02)
MODES = {"sparse_gather": (jsteps._compress_leaf_sparse,
                           lambda e, d, sp, r: psteps._compress_leaf_sparse(
                               e, d, sp, r, kernels=True)),
         "bucket_sparse": (jsteps._compress_leaf_bucket,
                           psteps._compress_leaf_bucket)}
_JITTED: dict = {}


def _ref_leaf(mode, e, d, sparsity, recv, spec=None):
    """The reference's leaf compressor in a 1-device shard_map, jitted once
    per (mode, shape, sparsity, spec); returns numpy (g, e_new)."""
    key = (mode, e.shape, sparsity, spec)
    if key not in _JITTED:
        mesh = make_host_mesh(1)
        fl_ax = fl_axis_name(mesh)
        fn = MODES[mode][0]
        _JITTED[key] = jax.jit(compat.shard_map(
            lambda e_, d_, r_: fn(e_, d_, sparsity, r_, fl_ax, 1, spec),
            mesh=mesh, in_specs=(P(), P(), P()), out_specs=(P(), P()),
            axis_names={fl_ax}))
    g, e_new = _JITTED[key](jnp.asarray(e), jnp.asarray(d),
                            jnp.asarray(recv, jnp.int32))
    return np.asarray(g), np.asarray(e_new)


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


def _leaf(case):
    """(e, delta, sparsity, recv) of a named case."""
    rng = np.random.default_rng(sum(map(ord, case)))
    shape, sp, recv = {
        "2d": ((24, 40), SPARSE, (1, 1, 1)),
        "stacked": ((2, 16, 20), DEFAULT, (1, 1, 1)),
        "model_dim": ((2, 16, 20), SPARSE, (1, 1, 1)),
        "bias64": ((64,), DEFAULT, (1, 1, 1)),
        "two": ((2,), DEFAULT, (1, 1, 1)),
        "tie": ((1024,), DEFAULT, (1, 1, 1)),
        "dropped": ((24, 40), SPARSE, (1, 0, 1)),
    }[case]
    e = (rng.standard_t(3, shape) * 1e-4).astype(np.float32)
    d = (rng.standard_t(3, shape) * 1e-3).astype(np.float32)
    if case == "tie":
        # 40 entries of magnitude 1 fill the top bin: channel 0's band
        # holds all 40 and its k_eff (14) cuts through the tie
        e = np.zeros(shape, np.float32)
        d = rng.uniform(0, 0.5, shape).astype(np.float32)
        d[rng.choice(shape[0], 40, replace=False)] = 1.0
        d *= rng.choice([-1.0, 1.0], shape).astype(np.float32)
    return e, d, sp, np.asarray(recv, np.int32)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("case", ["2d", "stacked", "model_dim", "bias64",
                                  "two", "tie", "dropped"])
def test_leaf_matches_reference_bitwise(mode, case):
    """"model_dim" is a stacked wq leaf under its spec, as the reference
    task passes it: rows along the model dim (``leaf_model_axis``)."""
    e, d, sp, recv = _leaf(case)
    spec = P(None, None, "model") if case == "model_dim" else None
    g_want, e_want = _ref_leaf(mode, e, d, sp, recv, spec)
    ax = psteps.leaf_model_axis("blocks/attn/wq", 3) if spec else None
    assert ax in (None, 2)
    rows = (lambda a: np.moveaxis(a, ax, 0).reshape(1, a.shape[ax], -1)
            if ax else a.reshape(1, 1, -1))
    g, e_new = MODES[mode][1](torch.from_numpy(rows(e)),
                              torch.from_numpy(rows(d)), sp,
                              torch.from_numpy(recv[None]))
    np.testing.assert_array_equal(_bits(g.numpy()), _bits(rows(g_want)[0]))
    np.testing.assert_array_equal(_bits(e_new.numpy()), _bits(rows(e_want)))
    if case == "tie" and mode == "sparse_gather":
        # channel 0 sends k_eff = 14 of the 40 tied entries
        assert int((g.abs() == 1).sum()) == 14
    if case == "dropped":
        # channel 1's mass stayed in the error memory
        g_all, _ = MODES[mode][1](torch.from_numpy(rows(e)),
                                  torch.from_numpy(rows(d)), sp,
                                  torch.ones((1, 3), dtype=torch.int32))
        assert int((g_all != 0).sum()) > int((g != 0).sum()) > 0


@pytest.mark.parametrize("mode", list(MODES))
def test_three_devices_match_the_reference_composition_bitwise(mode):
    """M = 3 with a different delivery mask per device: the server's sum is
    the reference's order of adds, channel outer and device inner, of each
    device's per-channel contribution (a one-hot mask on the reference's
    own leaf function); each device's error memory is the reference's."""
    rng = np.random.default_rng(4)
    shape, n_ch = (40, 48), 3
    e = (rng.standard_t(3, (3,) + shape) * 1e-4).astype(np.float32)
    d = (rng.standard_t(3, (3,) + shape) * 1e-3).astype(np.float32)
    received = np.array([[1, 1, 1], [1, 0, 1], [0, 1, 1]], np.int32)
    g_sum, e_want = np.zeros(shape, np.float32), []
    parts = [[_ref_leaf(mode, e[m], d[m], SPARSE,
                        np.eye(n_ch, dtype=np.int32)[c] * received[m, c])[0]
              for c in range(n_ch)] for m in range(3)]
    for c in range(n_ch):
        for m in range(3):
            g_sum = (g_sum + parts[m][c]).astype(np.float32)
    for m in range(3):
        e_want.append(_ref_leaf(mode, e[m], d[m], SPARSE, received[m])[1])
    g, e_new = MODES[mode][1](torch.from_numpy(e.reshape(3, 1, -1)),
                              torch.from_numpy(d.reshape(3, 1, -1)), SPARSE,
                              torch.from_numpy(received))
    np.testing.assert_array_equal(_bits(g.numpy().ravel()),
                                  _bits((g_sum / np.float32(3)).ravel()))
    np.testing.assert_array_equal(_bits(e_new.numpy().ravel()),
                                  _bits(np.stack(e_want).ravel()))
    # the order matters here: some coordinate gets three non-zero adds
    hits = sum((p != 0).astype(int) for row in parts for p in row)
    assert hits.max() >= 3


_RUNS: dict = {}


def _j_traj(aggregate, sparsity, rounds=3):
    key = (aggregate, sparsity, rounds)
    if key not in _RUNS:
        t = j_make(m_devices=1, arch=TINY, aggregate=aggregate,
                   sparsity=sparsity, local_steps=2, seq=16, backend="exact")
        p0 = jax.device_get(t.build()["params"])
        out = t.run(rounds)
        _RUNS[key] = (p0, out["losses"], jax.device_get(t._built["params"]),
                      jax.device_get(t._built["ef"]))
    return _RUNS[key]


_P_RUNS: dict = {}


def _p_traj(aggregate, sparsity, rounds=3):
    """The port's task from the reference run's initial weights, after
    ``rounds`` rounds, and its losses (cached)."""
    key = (aggregate, sparsity, rounds)
    if key not in _P_RUNS:
        t = p_make(m_devices=1, arch=P_TINY, aggregate=aggregate,
                   sparsity=sparsity, local_steps=2, seq=16, backend="cuda",
                   pallas_min_elems=1, device="cpu")
        t.build(params=params_from_jax(_j_traj("sparse_gather", sparsity)[0]))
        _P_RUNS[key] = (t, t.run(rounds)["losses"])
    return _P_RUNS[key]


@pytest.mark.parametrize("aggregate", ["sparse_gather", "bucket_sparse"])
@pytest.mark.parametrize("sparsity", [SATURATING, SPARSE])
def test_trajectory_matches_reference_task(aggregate, sparsity):
    _, losses_j, params_j, ef_j = _j_traj(aggregate, sparsity)
    t, losses = _p_traj(aggregate, sparsity)
    np.testing.assert_allclose(losses, losses_j, rtol=RTOL)
    _assert_trees_close(t._built["params"], params_j, MAX_FLIP_SHARE,
                        "params ")
    _assert_trees_close(t._built["ef"], ef_j, MAX_FLIP_SHARE, "ef ")


def test_saturating_sparse_gather_tracks_dense_masked():
    """At saturating sparsity every band fits its k_eff, so the sparse
    uplink sends what dense_masked sends, but from per-row histograms of
    the leaf's model-dim view, whose bin edges differ from the whole
    leaf's: held at the trajectory tolerance and its bin-edge flip share,
    not bitwise (the reference's own bitwise equality of the two does not
    hold under the installed jax)."""
    (sparse, l_sparse), (dense, l_dense) = (
        _p_traj(agg, SATURATING) for agg in ("sparse_gather", "dense_masked"))
    np.testing.assert_allclose(l_sparse, l_dense, rtol=RTOL)
    for part in ("params", "ef"):
        _assert_trees_close(sparse._built[part], dense._built[part],
                            MAX_FLIP_SHARE, f"{part} ")


def test_default_task_runs_the_sparse_uplink():
    """make_task("qwen2_100m") with its defaults (sparse_gather) runs, and
    its wire bytes are the reference task's."""
    t = make_task("qwen2_100m", m_devices=2, arch=P_TINY, seq=16,
                  device="cpu")
    assert t.step_cfg.aggregate == "sparse_gather"
    out = t.run(1)
    assert np.isfinite(out["losses"]).all()
    want = j_make(m_devices=2, arch=TINY, seq=16).wire_bytes_per_round()
    assert out["wire_bytes_per_round_per_device"] == want
