"""The port's training surface against the JAX reference: the global norm
and gradient clip (C8), the three optimizers' steps, AdamW's f32 moments
(C9), ``make_sync_train_step`` and the ``train`` driver.

The norm is bitwise the reference's jitted ``global_norm`` for leaves of
rank 1 to 3; one step of ``sgd``, ``sgdm`` and ``adamw`` from the same
gradients is bitwise the reference's jitted step, with the clip active
for the two that clip.  The sync step is held at the trajectory tolerance
of tests/test_torch_lgc_step.py (its gradients are summed in another
order), and the driver runs each mode at smoke size on the CPU.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import io as jio  # noqa: E402
from repro.configs import get_smoke_config  # noqa: E402
from repro.launch import compat  # noqa: E402
from repro.launch import sharding_rules as rules  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro_torch.checkpoint import io as pio  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.launch import steps as psteps  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import transformer as ptf  # noqa: E402
from repro_torch.optim import optimizers as popt  # noqa: E402
from repro_torch.weights import params_from_jax, params_to_jax  # noqa: E402
from test_torch_lgc_step import (ATOL, MAX_FLIP_SHARE, P_TINY,  # noqa: E402
                                  RTOL, TINY, PArch)


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


NORM_SHAPES = [(1000,), (4, 64), (64, 64), (64, 4), (96, 64), (2, 64, 64),
               (63, 6), (1, 32, 16), (256, 32), (12, 96, 40), (7, 100, 3),
               (16, 8), (4, 31, 2)]


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        return x.numpy().reshape(-1).view(np.uint8)
    a = np.asarray(x).reshape(-1)
    return (a.view(np.uint16) if a.dtype == jnp.bfloat16 else a).view(np.uint8)


@pytest.mark.parametrize("shape", NORM_SHAPES + [None])
def test_global_norm_is_the_references_jitted_norm(shape):
    """Single leaves of rank 1-3 (the reference's jitted ``jnp.sum`` takes
    XLA:CPU's tiled reduce-window order), and all of them as one tree
    (``None``)."""
    rng = np.random.default_rng(sum(shape or ()))
    f = jax.jit(jopt.global_norm)
    if shape is None:
        tree = {f"l{i}": rng.standard_normal(s).astype(np.float32)
                for i, s in enumerate(NORM_SHAPES)}
        np.testing.assert_array_equal(
            _bits(popt.global_norm({k: torch.from_numpy(v)
                                    for k, v in tree.items()})),
            _bits(f(tree)))
        return
    for _ in range(4):
        x = rng.standard_normal(shape).astype(np.float32)
        np.testing.assert_array_equal(
            _bits(popt.global_norm(torch.from_numpy(x))), _bits(f(x)))
        np.testing.assert_array_equal(
            _bits(prng.xla_sum_squares(torch.from_numpy(x))),
            _bits(jax.jit(lambda v: jnp.sum(jnp.square(v)))(x)))


# a few of TINY's leaves: stacked 3-d, 2-d and 1-d, in and out of the
# reduce-window passes
TREE_SHAPES = {"blocks/attn/bq": (1, 32), "blocks/attn/wq": (1, 32, 32),
               "blocks/mlp/w_down": (1, 64, 32), "embed": (256, 32),
               "final_norm/scale": (32,)}


def _tiny_tree(dtype, scale, seed):
    """(reference nested tree, port flat tree) of ``TREE_SHAPES``."""
    rng = np.random.default_rng(seed)
    flat = {k: torch.from_numpy((rng.standard_normal(s) * scale).astype(
        np.float32)).to(getattr(torch, jnp.dtype(dtype).name))
        for k, s in TREE_SHAPES.items()}
    return params_to_jax(flat), flat


@pytest.mark.parametrize("name", ["sgd", "sgdm", "adamw"])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_optimizer_steps_are_bitwise_the_references(name, dtype):
    """One step from the same gradients, at step 3 of the warm-up, with
    gradients whose global norm is above the clip (it scales them for
    sgdm and adamw; sgd does not clip): updates and state bitwise the
    reference's jitted ones, and for adamw the applied step too."""
    j_p, p_p = _tiny_tree(dtype, 0.1, 1)
    j_g, p_g = _tiny_tree(dtype, 1.0, 2)
    cfg = dict(lr=1e-2, warmup_steps=10)
    j_init, j_upd = jopt.get_optimizer(name, jopt.OptimizerConfig(**cfg))
    p_init, p_upd = popt.get_optimizer(name, popt.OptimizerConfig(**cfg))
    j_state = j_init(j_p)._replace(step=jnp.int32(3))
    p_state = p_init(p_p)._replace(step=3)
    if name == "sgdm":
        j_m, p_m = _tiny_tree(dtype, 0.05, 3)
        j_state, p_state = (j_state._replace(momentum=j_m),
                            p_state._replace(momentum=p_m))
    if name == "adamw":
        j_m, p_m = _tiny_tree(jnp.float32, 0.01, 4)
        j_v, p_v = _tiny_tree(jnp.float32, 0.001, 5)
        j_v = jax.tree_util.tree_map(jnp.abs, j_v)
        p_v = {k: v.abs() for k, v in p_v.items()}
        j_state = j_state._replace(m=j_m, v=j_v)
        p_state = p_state._replace(m=p_m, v=p_v)
    assert float(jax.jit(jopt.global_norm)(j_g)) > 1.0
    j_u, j_s = jax.jit(j_upd)(j_g, j_state, j_p)
    p_u, p_s = p_upd(p_g, p_state, p_p)
    assert p_s.step == int(j_s.step) == 4
    pairs = [(p_u, j_u)]
    if name == "sgdm":
        pairs.append((p_s.momentum, j_s.momentum))
    if name == "adamw":
        pairs += [(p_s.m, j_s.m), (p_s.v, j_s.v)]
        applied = jax.jit(lambda g, s, p: jopt.apply_updates(
            p, j_upd(g, s, p)[0]))(j_g, j_state, j_p)
        p_applied, _ = popt.adamw_apply(popt.OptimizerConfig(**cfg), p_g,
                                        p_state, p_p)
        pairs.append((p_applied, applied))
    for got, want in pairs:
        want = params_from_jax(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]),
                                          err_msg=k)


def test_adamw_moments_are_f32_for_bf16_params():
    params = {"w": torch.ones(3, 4, dtype=torch.bfloat16),
              "b": torch.ones(4, dtype=torch.bfloat16)}
    state = popt.adamw_init(params)
    ref = jopt.adamw_init({"w": jnp.ones((3, 4), jnp.bfloat16),
                           "b": jnp.ones(4, jnp.bfloat16)})
    for tree, want in ((state.m, ref.m), (state.v, ref.v)):
        for k, v in tree.items():
            assert v.dtype == torch.float32 and str(want[k].dtype) == "float32"
            assert tuple(v.shape) == want[k].shape and not v.any()
    assert popt.sgdm_init(params).momentum["w"].dtype == torch.bfloat16


@pytest.mark.parametrize("accum", [1, 2])
def test_sync_step_matches_the_references(accum):
    """Two steps of TINY from the same weights and batches, with 1 and 2
    microbatches, under SGD-momentum with the clip active: its step is
    proportional to the gradient, so the gradients' other summation order
    stays within the tolerance.  (AdamW's first steps divide each
    gradient by its own size: the key bias, whose gradient is zero up to
    rounding, would move by a full step either way; AdamW's step is held
    bitwise given the same gradients above.)"""
    opt = dict(lr=1e-2, warmup_steps=2)
    j_cfg = dataclasses.replace(TINY, optimizer="sgdm")
    p_cfg = dataclasses.replace(P_TINY, optimizer="sgdm")
    p0 = jtf.init_params(TINY, jax.random.PRNGKey(3))
    j_step = jax.jit(jsteps.make_sync_train_step(
        j_cfg, accum_steps=accum, opt_cfg=jopt.OptimizerConfig(**opt)))
    p_step = psteps.make_sync_train_step(
        p_cfg, accum_steps=accum, opt_cfg=popt.OptimizerConfig(**opt))
    j_p, j_s = p0, jopt.sgdm_init(p0)
    p_p = params_from_jax(p0)
    p_s = popt.sgdm_init(p_p)
    clipped = []
    orig = popt.clip_scale
    popt.clip_scale = lambda n, c: clipped.append(float(n) > c) or orig(n, c)
    rng = np.random.default_rng(accum)
    for _ in range(2):
        x = rng.integers(0, TINY.vocab_size, (4, 16), dtype=np.int32)
        y = np.roll(x, 1, 1)
        j_p, j_s, j_loss = j_step(j_p, j_s, {"tokens": jnp.asarray(x),
                                             "labels": jnp.asarray(y)})
        p_p, p_s, p_loss = p_step(p_p, p_s, {
            "tokens": torch.from_numpy(x).long(),
            "labels": torch.from_numpy(y).long()})
        np.testing.assert_allclose(float(p_loss), float(j_loss), rtol=RTOL)
    popt.clip_scale = orig
    assert all(clipped) and len(clipped) == 2
    want = params_from_jax(j_p)
    for k in want:
        np.testing.assert_allclose(p_p[k].numpy(), want[k].numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    assert p_s.step == int(j_s.step) == 2


@pytest.mark.parametrize("mode", ["sync", "lgc", "lgc_sparse", "fedavg"])
def test_driver_trains_at_smoke_size_and_checkpoints(mode, tmp_path):
    """Each mode's loss falls (the driver returns instead of exiting 1),
    and the checkpoint it writes reads back in the reference."""
    losses = train.main([
        "--arch", "qwen2-100m", "--smoke", "--steps", "6", "--batch", "8",
        "--seq", "16", "--mode", mode, "--devices", "2", "--lr", "3e-2",
        "--local-steps", "2",
        "--ckpt-dir", str(tmp_path), "--ckpt-every", "1", "--device", "cpu"])
    assert len(losses) == 6 and losses[-1] < losses[0]
    cfg = get_smoke_config("qwen2-100m")
    like = jax.tree_util.tree_map(jnp.zeros_like, jax.eval_shape(
        lambda k: jtf.init_params(cfg, k), jax.random.PRNGKey(0)))
    back = jio.load_checkpoint(str(tmp_path), 6, like)
    ours, step = pio.restore(str(tmp_path), {
        k: torch.zeros(v.shape, dtype=v.dtype) for k, v in
        ptf.init_params(train.get_smoke_config("qwen2-100m"),
                        device="meta").items()})
    assert step == 6
    for k, v in params_from_jax(back).items():
        np.testing.assert_array_equal(_bits(v), _bits(ours[k]), err_msg=k)


def _support_flips(a: np.ndarray, b: np.ndarray) -> float:
    """Share of a leaf's coordinates that are zero in one and not the
    other."""
    return float(((a != 0) != (b != 0)).mean())


def test_driver_step_selects_over_whole_leaves_as_the_references():
    """C10: one ``lgc_sparse`` round of the port's step as the driver
    builds it (no ``model_axis``) against the reference's
    ``make_lgc_train_step`` as its driver builds it (no
    ``param_spec_tree``), qwen2-100m smoke in f32, M = 1, H = 2: both
    select over each leaf as one row, so the error memory's support agrees
    but for coordinates next to a bin edge (at most 0.1% of a leaf) and
    the params agree at the trajectory tolerance.  The 100M task's rule
    (``model_axis=leaf_model_axis``: rows of the model-dim view) selects
    other coordinates, as the reference's task does with its specs."""
    sparsity, lr = (0.01, 0.02, 0.02), 3e-2
    j_cfg = dataclasses.replace(get_smoke_config("qwen2-100m"),
                                dtype=jnp.float32)
    p_cfg = PArch(**{f.name: getattr(j_cfg, f.name)
                     for f in dataclasses.fields(j_cfg) if f.name != "dtype"},
                  dtype=torch.float32)
    mesh = make_host_mesh(1)
    compat.set_mesh(mesh)
    p0 = jax.device_get(jtf.init_params(j_cfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(10)
    x = rng.integers(0, j_cfg.vocab_size, (4, 16), dtype=np.int32)
    batch = {"tokens": x, "labels": np.roll(x, -1, 1)}
    j_step = jax.jit(jsteps.make_lgc_train_step(
        j_cfg, mesh, jsteps.LGCStepConfig(
            local_steps=2, sparsity=sparsity, local_lr=lr,
            aggregate="sparse_gather"),
        rules.batch_specs(j_cfg, batch, mesh)))
    j_params, j_ef, j_loss = j_step(p0, jsteps.init_ef_tree(p0, 1), batch)
    want_p = params_from_jax(jax.device_get(j_params))
    want_e = {k: v.numpy() for k, v in
              params_from_jax(jax.device_get(j_ef)).items()}

    cfg = psteps.LGCStepConfig(local_steps=2, sparsity=sparsity,
                               local_lr=lr, aggregate="sparse_gather")
    pb = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    p_start = params_from_jax(p0)
    outs = {rule: psteps.make_lgc_train_step(
        p_cfg, 1, cfg, model_axis=rule)(
            p_start, psteps.init_ef_tree(p_start, 1), pb)
        for rule in (None, psteps.leaf_model_axis)}
    params, ef, loss = outs[None]
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=RTOL)
    for k, w in want_p.items():
        off = ~np.isclose(params[k].numpy(), w.numpy(), rtol=RTOL, atol=ATOL)
        assert off.mean() <= MAX_FLIP_SHARE, (k, int(off.sum()))
        assert _support_flips(ef[k].numpy(), want_e[k]) <= MAX_FLIP_SHARE, k
    task_ef = outs[psteps.leaf_model_axis][1]
    wq = "blocks/attn/wq"
    assert _support_flips(task_ef[wq].numpy(), want_e[wq]) > MAX_FLIP_SHARE


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "whisper-small"])
def test_driver_trains_the_families_at_smoke_size(arch):
    """``--mode lgc`` on a moe and an audio arch (its zero frame stub in
    every batch): the loss falls (the driver returns instead of exiting
    1)."""
    losses = train.main([
        "--arch", arch, "--smoke", "--steps", "4", "--batch", "4",
        "--seq", "16", "--mode", "lgc", "--devices", "2", "--lr", "3e-2",
        "--local-steps", "2", "--device", "cpu"])
    assert len(losses) == 4 and losses[-1] < losses[0]
    assert all(np.isfinite(losses))


def test_driver_builds_the_modality_stub():
    """The reference's shapes in ``cfg.dtype``: the audio frames zeros as
    there, the vlm patches standard normal draws from the seed (the
    reference's zeros overflow the gradient at depth:
    tests/test_torch_family_training.py)."""
    cfg = get_smoke_config("phi-3-vision-4.2b")
    p_cfg = train.get_smoke_config("phi-3-vision-4.2b")
    stub = train.modality_prefix(p_cfg, 3, "cpu")
    assert tuple(stub.shape) == (3, cfg.n_prefix_tokens, 1024)
    assert stub.dtype == p_cfg.dtype and bool(stub.all())
    assert torch.equal(stub, train.modality_prefix(p_cfg, 3, "cpu"))
    p_cfg = train.get_smoke_config("whisper-small")
    frames = train.modality_prefix(p_cfg, 2, "cpu")
    assert tuple(frames.shape) == (2, p_cfg.encoder_seq, p_cfg.d_model)
    assert frames.dtype == p_cfg.dtype and not frames.any()
    assert train.modality_prefix(train.get_smoke_config("mamba2-370m"), 2,
                                 "cpu") is None


def test_driver_refuses_what_is_not_ported():
    """Nothing is left unported: every arch id trains (A15's four
    configs: tests/test_torch_configs.py), every family also under
    ``--model-parallel`` (tests/test_torch_tensor_parallel.py,
    tests/test_torch_ssm_model_axis.py,
    tests/test_torch_moe_vlm_model_axis.py,
    tests/test_torch_audio_model_axis.py), where ``--devices`` must be
    a multiple of it, as the reference's mesh asks, and P must divide the
    heads and the padded vocab (checked before a rank is spawned)."""
    with pytest.raises(ValueError, match="do not factor"):
        train.main(["--arch", "qwen2-100m", "--model-parallel", "2",
                    "--device", "cpu"])
    with pytest.raises(ValueError, match="padded vocab 51968"):
        train.main(["--arch", "whisper-small", "--model-parallel", "3",
                    "--devices", "3", "--device", "cpu"])
    assert train.get_config("glm4-9b").name == "glm4-9b"
