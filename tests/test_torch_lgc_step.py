"""The port's LGC train step and qwen2_100m task held against the JAX
reference.

Budgets, wire accounting, the per-leaf compression and the token pipeline
are compared exactly.  Trajectories run the TINY qwen2 config of
tests/test_lgc_step.py in float32 on both sides from the same initial
weights (carried across by ``repro_torch.weights.params_from_jax``); the
forward and backward passes sum f32 products in different orders on XLA:CPU
and ATen, so losses, params and error memory agree to rtol 1e-5 / atol 1e-6,
and under non-saturating sparsity a coordinate next to a histogram bin edge
may flip layer (at most 0.1% of a leaf).

The guards pin that the port and chip_smoke.py import neither ``jax`` nor
the reference package, and that an entry point never falls back to the CPU
silently.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import get_smoke_config  # noqa: E402
from repro.data.tokens import TokenPipeline as JTokenPipeline  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.models.lgc_transformer import make_qwen2_100m_task as j_make  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ArchConfig as PArch  # noqa: E402
from repro_torch.data.tokens import TokenPipeline  # noqa: E402
from repro_torch.launch import steps as psteps  # noqa: E402
from repro_torch.models import transformer as ptf  # noqa: E402
from repro_torch.models.lgc_transformer import make_qwen2_100m_task as p_make  # noqa: E402
from repro_torch.models.paper_models import make_task  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
RTOL, ATOL = 1e-5, 1e-6
SATURATING = (1.0, 0.5, 0.5)
SPARSE = (0.05, 0.1, 0.1)
MAX_FLIP_SHARE = 1e-3

TINY = dataclasses.replace(
    get_smoke_config("qwen2-100m"), name="qwen2-tiny", n_layers=1,
    d_model=32, n_heads=2, n_kv_heads=1, d_ff=64, vocab_size=64,
    attn_q_chunk=16, loss_chunk=16, dtype=jnp.float32)
P_TINY = PArch(**{f.name: getattr(TINY, f.name)
                  for f in dataclasses.fields(TINY) if f.name != "dtype"},
               dtype=torch.float32)


def _rand(shape, seed, scale=1e-3):
    return (np.random.default_rng(seed).standard_t(3, shape) * scale
            ).astype(np.float32)


def _np(tree) -> dict:
    """Flat {path: np.ndarray} of a port state dict or a reference tree."""
    if isinstance(tree, dict) and all(isinstance(v, torch.Tensor)
                                      for v in tree.values()):
        return {k: v.detach().cpu().numpy() for k, v in tree.items()}
    return {k: v.numpy() for k, v in params_from_jax(tree).items()}


def _assert_trees_close(got: dict, want: dict, max_flip_share=0.0, msg=""):
    """Allclose leaf by leaf; ``max_flip_share`` of a leaf's coordinates
    may differ (a coordinate on a bin edge flipping layer)."""
    got, want = _np(got), _np(want)
    assert list(got) == list(want)
    for k in want:
        a, b = got[k], want[k]
        assert a.shape == b.shape, k
        off = ~np.isclose(a, b, rtol=RTOL, atol=ATOL)
        share = off.mean()
        assert share <= max_flip_share, (
            f"{msg}{k}: {off.sum()} of {off.size} coordinates differ, "
            f"max |diff| {np.abs(a - b).max():.3g}")


# ---------------------------------------------------------------------------
# budgets, accounting, per-leaf compression, data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size", [1, 2, 64, 1000, 100_003, 28_311_552])
@pytest.mark.parametrize("sparsity", [(0.01, 0.02, 0.02), SATURATING,
                                      (0.3,), (0.1, 0.1, 0.1, 0.1)])
def test_leaf_ks_matches_reference(size, sparsity):
    assert psteps._leaf_ks(size, sparsity) == jsteps._leaf_ks(size, sparsity)
    np.testing.assert_array_equal(
        psteps._leaf_cum_ks(size, sparsity).numpy(),
        np.asarray(jsteps._leaf_cum_ks(size, sparsity)))


@pytest.mark.parametrize("sparsity", [(0.01, 0.02, 0.02), SPARSE])
def test_wire_bytes_match_reference_at_full_width(sparsity):
    j_shapes = jax.eval_shape(
        lambda k: jtf.init_params(j_get_config("qwen2-100m"), k),
        jax.ShapeDtypeStruct((2,), jnp.uint32))
    p_shapes = ptf.init_params(get_config("qwen2-100m"), device="meta")
    want = jsteps.lgc_wire_bytes_per_round(
        j_shapes, jsteps.LGCStepConfig(sparsity=sparsity))
    got = psteps.lgc_wire_bytes_per_round(
        p_shapes, psteps.LGCStepConfig(sparsity=sparsity))
    assert got == want


@pytest.mark.parametrize("shape", [(64,), (1000,), (3, 40, 50)])
@pytest.mark.parametrize("recv", [(1, 1, 1), (1, 0, 1), (0, 0, 0)])
def test_compress_leaf_dense_matches_reference_bitwise(shape, recv):
    """The kernel route (``pallas_min_elems=1``) on both sides; on the CPU
    the port's wrappers run their plain versions."""
    e, d = _rand(shape, 1, 1e-4), _rand(shape, 2)
    g_j, e_j = jsteps._compress_leaf_dense(
        jnp.asarray(e), jnp.asarray(d), SPARSE,
        jnp.asarray(recv, jnp.int32), backend="pallas", pallas_min_elems=1)
    g_p, e_p = psteps._compress_leaf_dense(
        torch.from_numpy(e), torch.from_numpy(d), SPARSE,
        torch.tensor(recv, dtype=torch.int32), backend="cuda",
        pallas_min_elems=1)
    for got, want in ((g_p, g_j), (e_p, e_j)):
        want = np.asarray(want)
        assert got.shape == want.shape
        np.testing.assert_array_equal(got.numpy().view(np.int32),
                                      want.view(np.int32))


def test_token_pipeline_matches_reference():
    ours, theirs = TokenPipeline(97, 24, 6, seed=3), JTokenPipeline(97, 24, 6,
                                                                    seed=3)
    for _ in range(3):
        for a, b in zip(ours.next_batch(), theirs.next_batch()):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_step_config_rejects_unported_modes():
    """Every aggregate of the reference is accepted; an unknown aggregate
    and an unknown backend still raise."""
    for agg in ("dense_masked", "sparse_gather", "bucket_sparse", "none"):
        assert psteps.LGCStepConfig(aggregate=agg).aggregate == agg
    with pytest.raises(ValueError, match="aggregate"):
        psteps.LGCStepConfig(aggregate="top_k")
    with pytest.raises(ValueError):
        psteps.LGCStepConfig(backend="triton")


# ---------------------------------------------------------------------------
# trajectories against the reference task
# ---------------------------------------------------------------------------

_RUNS: dict = {}


def _j_traj(aggregate, sparsity, rounds=3):
    key = (aggregate, sparsity, rounds)
    if key not in _RUNS:
        t = j_make(m_devices=1, arch=TINY, aggregate=aggregate,
                   sparsity=sparsity, local_steps=2, seq=16, backend="exact")
        p0 = jax.device_get(t.build()["params"])   # before the step donates it
        out = t.run(rounds)
        _RUNS[key] = (p0, out["losses"], jax.device_get(t._built["params"]),
                      jax.device_get(t._built["ef"]))
    return _RUNS[key]


@pytest.mark.parametrize("aggregate", ["dense_masked", "none"])
@pytest.mark.parametrize("sparsity", [SATURATING, SPARSE])
def test_trajectory_matches_reference_task(aggregate, sparsity):
    p0, losses_j, params_j, ef_j = _j_traj(aggregate, sparsity)
    t = p_make(m_devices=1, arch=P_TINY, aggregate=aggregate,
               sparsity=sparsity, local_steps=2, seq=16, backend="cuda",
               pallas_min_elems=1, device="cpu")
    t.build(params=params_from_jax(p0))
    out = t.run(3)
    np.testing.assert_allclose(out["losses"], losses_j, rtol=RTOL)
    flips = 0.0 if sparsity == SATURATING else MAX_FLIP_SHARE
    _assert_trees_close(t._built["params"], params_j, flips, "params ")
    _assert_trees_close(t._built["ef"], ef_j, flips, "ef ")
    assert out["param_count"] == sum(v.size for v in _np(p0).values())


def test_two_devices_one_round_matches_reference_composition():
    """M=2, one round, one dropped channel on device 1: against the
    reference's pieces composed by hand -- ``jax.value_and_grad(lm_loss)``
    for H local SGD steps per device, ``steps._compress_leaf_dense``, the
    mean over devices and the server subtract."""
    m_dev, h, lr = 2, 2, 3e-3
    received = np.array([[1, 1, 1], [1, 0, 1]], np.int32)
    p0 = jax.device_get(jtf.init_params(TINY, jax.random.PRNGKey(1)))
    ef0 = {k: _rand((m_dev,) + v.shape, 10 + i, 1e-5)
           for i, (k, v) in enumerate(_np(p0).items())}
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, TINY.vocab_size, (m_dev * h, 16), dtype=np.int32)
    labels = rng.integers(0, TINY.vocab_size, tokens.shape, dtype=np.int32)

    # reference composition
    b_local = tokens.shape[0] // m_dev
    mb = b_local // h
    vg = jax.jit(jax.value_and_grad(lambda p, x, y: jtf.lm_loss(
        p, TINY, {"tokens": x, "labels": y})))
    g_sum, ef_want, loss_sum = None, {k: [] for k in ef0}, 0.0
    for m in range(m_dev):
        p = p0
        for i in range(h):
            rows = slice(m * b_local + i * mb, m * b_local + (i + 1) * mb)
            loss, g = vg(p, tokens[rows], labels[rows])
            loss_sum += float(loss) / h
            p = jax.tree_util.tree_map(
                lambda w, gi: (w.astype(jnp.float32)
                               - lr * gi.astype(jnp.float32)).astype(w.dtype),
                p, g)
        delta = _np(jax.device_get(jax.tree_util.tree_map(
            lambda w0, w1: w0.astype(jnp.float32) - w1.astype(jnp.float32),
            p0, p)))
        g_m = {}
        for k, dl in delta.items():
            g, e_new = jsteps._compress_leaf_dense(
                jnp.asarray(ef0[k][m]), jnp.asarray(dl), SPARSE,
                jnp.asarray(received[m]), backend="exact")
            g_m[k] = np.asarray(g)
            ef_want[k].append(np.asarray(e_new))
        g_sum = g_m if g_sum is None else {k: g_sum[k] + g_m[k] for k in g_m}
    params_want = {k: (v - g_sum[k] / m_dev).astype(v.dtype)
                   for k, v in _np(p0).items()}
    ef_want = {k: np.stack(v) for k, v in ef_want.items()}

    step = psteps.make_lgc_train_step(
        P_TINY, m_dev, psteps.LGCStepConfig(
            local_steps=h, local_lr=lr, sparsity=SPARSE, backend="cuda",
            pallas_min_elems=1))
    params, ef, loss = step(
        params_from_jax(p0), {k: torch.from_numpy(v) for k, v in ef0.items()},
        {"tokens": torch.from_numpy(tokens).long(),
         "labels": torch.from_numpy(labels).long()},
        torch.from_numpy(received))
    np.testing.assert_allclose(float(loss), loss_sum / m_dev, rtol=RTOL)
    _assert_trees_close(params, params_want, MAX_FLIP_SHARE, "params ")
    _assert_trees_close(ef, ef_want, MAX_FLIP_SHARE, "ef ")
    # the dropped channel's mass stayed in device 1's error memory
    assert any(np.abs(ef_want[k][1]).sum() > np.abs(ef_want[k][0]).sum()
               for k in ef_want)


def test_row_compression_equals_device_by_device_compression():
    """M=3, every leaf through the kernel route (on the CPU: the plain
    versions), a different delivery mask per device: compressing each leaf
    once over the M rows gives bitwise the params and error memory of the
    device-by-device path (``rows=False``)."""
    m_dev, h = 3, 2
    p0 = params_from_jax(jax.device_get(jtf.init_params(
        TINY, jax.random.PRNGKey(2))))
    ef0 = {k: torch.from_numpy(_rand((m_dev,) + tuple(v.shape), 20 + i,
                                     1e-5))
           for i, (k, v) in enumerate(p0.items())}
    rng = np.random.default_rng(8)
    tokens = torch.from_numpy(rng.integers(0, TINY.vocab_size,
                                           (m_dev * h, 16))).long()
    batch = {"tokens": tokens, "labels": torch.roll(tokens, 1, 1)}
    received = torch.tensor([[1, 1, 1], [1, 0, 1], [0, 0, 1]],
                            dtype=torch.int32)
    cfg = psteps.LGCStepConfig(local_steps=h, local_lr=3e-3, sparsity=SPARSE,
                               backend="cuda", pallas_min_elems=1)
    outs = [psteps.make_lgc_train_step(P_TINY, m_dev, cfg, rows=rows)(
        p0, ef0, batch, received) for rows in (True, False)]
    for tree_a, tree_b in ((outs[0][0], outs[1][0]), (outs[0][1], outs[1][1])):
        for k in tree_a:
            assert torch.equal(tree_a[k].view(torch.int32),
                               tree_b[k].view(torch.int32)), k
    assert float(outs[0][2]) == float(outs[1][2])


def test_step_at_tiny_learning_rate_flushes_subnormals_as_the_reference():
    """A step size of 1e-34 puts the updates of the zero biases and the
    error memory among f32 subnormals, which the reference's XLA:CPU
    flushes: after each of 3 rounds the port's params and EF hold none,
    and are zero where the reference's are."""
    t = j_make(m_devices=1, arch=TINY, aggregate="dense_masked",
               sparsity=SPARSE, local_steps=2, seq=16, backend="exact",
               local_lr=1e-34)
    p0 = jax.device_get(t.build()["params"])
    tp = p_make(m_devices=1, arch=P_TINY, aggregate="dense_masked",
                sparsity=SPARSE, local_steps=2, seq=16, backend="cuda",
                pallas_min_elems=1, local_lr=1e-34, device="cpu")
    tp.build(params=params_from_jax(p0))
    tiny = np.float32(1.1754944e-38)
    for _ in range(3):
        t.run(1)
        tp.run(1)
        for got, want in ((tp._built["params"], t._built["params"]),
                          (tp._built["ef"], t._built["ef"])):
            got, want = _np(got), _np(want)
            for k in want:
                a, b = got[k], want[k]
                assert not ((a != 0) & (np.abs(a) < tiny)).any(), k
                assert not ((b != 0) & (np.abs(b) < tiny)).any(), k
                np.testing.assert_array_equal(a == 0, b == 0, err_msg=k)
            _assert_trees_close(got, want)
    assert sum(int((v != 0).sum()) for v in _np(t._built["ef"]).values())


# ---------------------------------------------------------------------------
# guards
# ---------------------------------------------------------------------------

def test_port_and_chip_smoke_import_no_reference_module():
    src = ROOT / "src" / "repro_torch"
    mods = sorted(
        "repro_torch." + ".".join(p.relative_to(src).with_suffix("").parts)
        for p in src.rglob("*.py"))
    mods = [m.removesuffix(".__init__") for m in mods] + ["chip_smoke"]
    simulator = ["core.prng", "core.scenario", "core.channels",
                 "core.compressor", "core.error_feedback", "core.server",
                 "core.fl", "core.fl_batched", "core.controller",
                 "core.audit", "core.population", "optim.optimizers",
                 "checkpoint.io", "checkpoint.msgpack", "launch.steps",
                 "launch.train", "data.mnist",
                 "data.partition", "data.shakespeare", "models.paper_models",
                 "models.lgc_transformer", "launch.quickstart",
                 "launch.profile_sim", "kernels.ops",
                 "kernels.topk_threshold", "models.moe", "models.ssd",
                 "configs.olmoe_1b_7b", "configs.mamba2_370m",
                 "configs.zamba2_1_2b", "configs.phi3_vision_4b",
                 "configs.whisper_small", "configs.glm4_9b",
                 "configs.starcoder2_7b", "configs.yi_34b",
                 "configs.grok1_314b", "kernels.threefry_normal",
                 "launch.mesh", "launch.sharding_rules", "parallel",
                 "kernels.swa_attention", "models.layers",
                 "models.transformer", "launch.serve_decode"]
    assert {f"repro_torch.{m}" for m in simulator} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro',\n"
        "                                    'msgpack'))\n"
        "print('LOADED', len(sys.modules))\n"
        "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=120,
                         env={k: v for k, v in os.environ.items()
                              if k != "PYTHONPATH"})
    assert res.returncode == 0, res.stderr
    assert "LOADED" in res.stdout


def test_entry_points_never_fall_back_to_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_task("qwen2_100m")
    with pytest.raises(RuntimeError, match="CUDA"):
        p_make(aggregate="dense_masked")
    with pytest.raises(RuntimeError, match="CUDA"):
        ptf.init_params(P_TINY)
    # asked for explicitly, the CPU runs
    t = make_task("qwen2_100m", m_devices=1, arch=P_TINY,
                  aggregate="dense_masked", device="cpu")
    assert t.device.type == "cpu"

