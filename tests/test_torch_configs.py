"""The port's last four configs held against the JAX reference: glm4-9b
(dense, QKV bias, GQA 32 over 2), starcoder2-7b (dense, layernorm, the
biased GELU MLP, QKV bias), yi-34b (dense, GQA 56 over 8) and grok-1-314b
(moe: gated-GELU experts, top-2, SGD-momentum).

The configs and the reference's analytic counts are compared field for
field for every id, full and smoke.  Then both sides run each smoke config
in float32, with the reference's weights carried across by
``repro_torch.weights.params_from_jax`` and tokens made with numpy from a
seed: ``init_params`` bitwise; prefill logits and caches and 16 greedy
steps past a 24-slot ring's wrap at rtol 1e-5 / atol 1e-5 (the serving
tests' tolerance: XLA:CPU and ATen sum the same f32 products in other
orders), the tokens equal; ``lm_loss`` and every gradient leaf against
``jax.value_and_grad`` at rtol 1e-5 / atol 1e-6; one sync step of
``cfg.optimizer`` and one LGC round (``dense_masked``, M = 2, H = 2, a
dropped channel) against the reference's pieces, as
tests/test_torch_family_training.py does for the other families.  The MoE
layer runs ``geglu`` and biased ``gelu`` experts against the reference's
``moe_forward``, capacity drops included, and grok-smoke's SGD-momentum
step is bitwise the reference's from the same gradients, in f32 and with
its bf16 moment in bf16.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCH_IDS as J_ARCH_IDS  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import get_smoke_config as j_get_smoke  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config  # noqa: E402
from repro_torch.configs.base import ArchConfig as PArch  # noqa: E402
from repro_torch.launch import serve_decode, steps as psteps, train  # noqa: E402
from repro_torch.models import moe as pmoe  # noqa: E402
from repro_torch.models import transformer as ptf  # noqa: E402
from repro_torch.optim import optimizers as popt  # noqa: E402
from repro_torch.weights import params_from_jax, params_to_jax  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
SERVE_ATOL = 1e-5
MAX_FLIP_SHARE = 1e-3            # LGC: a coordinate next to a bin edge
ARCHS = ("glm4-9b", "starcoder2-7b", "yi-34b", "grok-1-314b")
# parameters by shape (the reference's init_params under eval_shape)
PARAMS = {"glm4-9b": 9_399_951_360, "starcoder2-7b": 7_400_268_800,
          "yi-34b": 34_388_917_248, "grok-1-314b": 316_489_340_928}
# serving: a 16-token prompt into a 24-slot ring, 16 steps past its wrap
PROMPT, WINDOW, STEPS, BATCH = 16, 24, 16, 2
# training: M = 2 FL devices, H = 2 local steps, one row a local step
M_DEV, H, SEQ = 2, 2, 16
TRAIN_BATCH = M_DEV * H
LR, SPARSITY = 3e-3, (0.05, 0.1, 0.1)
RECEIVED = np.array([[1, 1, 1], [1, 0, 1]], np.int32)


def port_arch(cfg, dtype=torch.float32) -> PArch:
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
          if f.name != "dtype"}
    return PArch(**kw, dtype=dtype)


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().to(torch.float32).numpy()
    return np.asarray(t, np.float32)


def _close(got, want, msg="", atol=ATOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL, atol=atol,
                               err_msg=msg)


def _to_torch(batch: dict) -> dict:
    return {k: torch.from_numpy(v).long() for k, v in batch.items()}


class Config:
    """One arch's reference run, computed once: f32 weights on both sides,
    the reference's prefill and jitted decode step, a training batch and
    the reference's loss and gradients on it."""

    def __init__(self, arch: str):
        cfg = self.j_cfg = dataclasses.replace(j_get_smoke(arch),
                                               dtype=jnp.float32)
        self.p_cfg = port_arch(cfg)
        self.jp = jax.device_get(jtf.init_params(cfg, jax.random.PRNGKey(0)))
        rng = np.random.default_rng(len(arch))
        self.prompt = rng.integers(0, cfg.vocab_size, (BATCH, PROMPT),
                                   dtype=np.int32)
        self.batch = {k: rng.integers(0, cfg.vocab_size, (TRAIN_BATCH, SEQ),
                                      dtype=np.int32)
                      for k in ("tokens", "labels")}

        @jax.jit
        def prefill(params, tokens):
            return jtf.prefill(params, cfg, {"tokens": tokens}, WINDOW)
        self.j_logits, self.j_cache = prefill(self.jp,
                                              jnp.asarray(self.prompt))

        @jax.jit
        def step(params, token, cache):
            logits, cache = jtf.decode_step(params, cfg, token, cache,
                                            window=WINDOW)
            return logits, jnp.argmax(logits, -1).astype(jnp.int32)[:, None], \
                cache
        self.j_step = step
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p, b: jtf.lm_loss(p, cfg, b)))(self.jp, self.batch)
        self.j_loss = float(loss)
        self.j_grads = params_from_jax(jax.device_get(grads))

    def params(self) -> dict:
        return params_from_jax(self.jp)


_CONFIGS: dict = {}


def _config(arch: str) -> Config:
    if arch not in _CONFIGS:
        _CONFIGS[arch] = Config(arch)
    return _CONFIGS[arch]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: its decode steps and small
    backward passes are thousands of tiny ops, and with the suite's workers
    sharing the cores OpenMP's barriers wait on descheduled threads.
    Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=ARCHS)
def run(request) -> Config:
    return _config(request.param)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def test_every_id_resolves_with_the_references_analytic_counts():
    """All 11 ids, full and smoke: every field but the dtype (a torch
    bf16 against jnp's), ``param_count``, ``active_param_count``,
    ``is_attention_free`` and ``supports_long_decode`` equal the
    reference's."""
    assert ARCH_IDS == J_ARCH_IDS and len(ARCH_IDS) == 11
    for arch in ARCH_IDS:
        for ours, theirs in ((get_config(arch), j_get_config(arch)),
                             (get_smoke_config(arch), j_get_smoke(arch))):
            for f in dataclasses.fields(theirs):
                if f.name != "dtype":
                    assert getattr(ours, f.name) == getattr(theirs, f.name), \
                        (arch, f.name)
            assert ours.dtype == torch.bfloat16
            assert ours.param_count() == theirs.param_count(), arch
            assert ours.active_param_count() == \
                theirs.active_param_count(), arch
            assert ours.is_attention_free == theirs.is_attention_free
            assert ours.supports_long_decode == theirs.supports_long_decode


@pytest.mark.parametrize("arch", ARCHS)
def test_leaf_shapes_and_param_counts(arch):
    """The leaves' shapes in the reference's order, on the meta device,
    and their count (yi-34b's MLP leaves hold 8,808,038,400 elements,
    past 2**31; grok-1's experts (64, 8, ...))."""
    cfg = get_config(arch)
    assert ptf.param_count(cfg) == PARAMS[arch]
    shapes = jax.eval_shape(lambda: jtf.init_params(j_get_config(arch),
                                                    jax.random.PRNGKey(0)))
    leaves = jax.tree_util.tree_leaves(shapes)
    assert sum(int(np.prod(x.shape)) for x in leaves) == PARAMS[arch]
    meta = ptf.init_params(cfg, device="meta")
    assert [tuple(p.shape) for p in meta.values()] == \
        [tuple(x.shape) for x in leaves]
    assert all(p.dtype == torch.bfloat16 or name.endswith("router")
               for name, p in meta.items())


# ---------------------------------------------------------------------------
# init and serving
# ---------------------------------------------------------------------------

def test_init_params_bitwise_the_reference(run):
    """Every leaf (the QKV biases, starcoder2's layernorm and MLP biases,
    grok-1's (L, E, ...) experts and f32 router) in the reference's order,
    bit for bit."""
    want = run.params()
    ours = ptf.init_params(run.p_cfg, seed=0, device="cpu")
    assert list(ours) == list(want)
    for name, w in want.items():
        assert ours[name].dtype == w.dtype, name
        assert torch.equal(ours[name], w), name


def test_serve_f32_past_the_wrap(run):
    """Prefill into the 24-slot ring, then 16 greedy steps (positions
    16-31): logits and caches at 1e-5, tokens equal."""
    pp = run.params()
    p_logits, p_cache = psteps.make_prefill_step(run.p_cfg, WINDOW,
                                                 device="cpu")(
        pp, {"tokens": torch.from_numpy(run.prompt)})
    _close(p_logits, run.j_logits, "prefill logits", SERVE_ATOL)
    p_step = psteps.make_serve_step(run.p_cfg, WINDOW, device="cpu",
                                    return_logits=True)
    j_tok = jnp.argmax(run.j_logits, -1).astype(jnp.int32)[:, None]
    p_tok = torch.argmax(p_logits, -1).to(torch.int32)[:, None]
    np.testing.assert_array_equal(p_tok.numpy(), np.asarray(j_tok))
    j_cache = run.j_cache
    for i in range(STEPS):
        j_l, j_tok, j_cache = run.j_step(run.jp, j_tok, j_cache)
        p_tok, p_cache, p_l = p_step(pp, p_tok, p_cache)
        _close(p_l, j_l, f"step {i} logits", SERVE_ATOL)
        np.testing.assert_array_equal(p_tok.numpy(), np.asarray(j_tok),
                                      err_msg=f"step {i} tokens")
    assert p_cache["pos"] == int(j_cache["pos"]) == PROMPT + STEPS > WINDOW
    for name in ("k", "v"):
        _close(p_cache["kv"][name], j_cache["kv"][name], name, SERVE_ATOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_driver_runs_each_config_on_the_cpu(arch):
    out = serve_decode.main(["--arch", arch, "--smoke", "--batch", "2",
                             "--prompt", "8", "--gen", "3", "--window", "8",
                             "--device", "cpu"])
    assert out["params"] == ptf.param_count(get_smoke_config(arch))
    assert out["ring"]["wrapped"] and out["ring"]["pos"] == 11
    assert out["full"]["logits_finite"] and out["ring"]["logits_finite"]


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def test_loss_and_every_gradient_leaf_match_the_reference(run):
    names = list(run.j_grads)
    leaves = [v.requires_grad_(True) for v in run.params().values()]
    loss = ptf.lm_loss(dict(zip(names, leaves)), run.p_cfg,
                       _to_torch(run.batch))
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), run.j_loss, rtol=RTOL)
    for k, g in zip(names, grads):
        assert bool(torch.isfinite(g).all()), k
        _close(g, run.j_grads[k], k)


def test_sync_step_of_the_configs_optimizer(run):
    """One step of ``cfg.optimizer`` (AdamW for the dense three, SGD
    momentum for grok-1) over two microbatches from the same weights.
    SGD momentum's step is proportional to the gradient: every leaf at the
    tolerance.  AdamW's first step divides each gradient by its own size
    (about sign(g) * lr), so a coordinate whose gradient is zero up to
    rounding moves a whole step either way: the key bias, whose gradient
    is exactly zero (a constant added to all of a query's logits), and
    single coordinates of other leaves (at most 0.1% of a leaf) may differ,
    each by at most two steps."""
    opt = dict(lr=1e-2, warmup_steps=2)
    j_step = jax.jit(jsteps.make_sync_train_step(
        run.j_cfg, accum_steps=2, opt_cfg=jopt.OptimizerConfig(**opt)))
    p_step = psteps.make_sync_train_step(
        run.p_cfg, accum_steps=2, opt_cfg=popt.OptimizerConfig(**opt))
    j_init, _ = jopt.get_optimizer(run.j_cfg.optimizer)
    p_init, _ = popt.get_optimizer(run.p_cfg.optimizer)
    j_p, _, j_loss = j_step(run.jp, j_init(run.jp), run.batch)
    p0 = run.params()
    p_p, p_s, p_loss = p_step(p0, p_init(p0), _to_torch(run.batch))
    np.testing.assert_allclose(float(p_loss), float(j_loss), rtol=RTOL)
    assert p_s.step == 1
    lr0 = float(popt._schedule(popt.OptimizerConfig(**opt), 0))
    for k, v in params_from_jax(jax.device_get(j_p)).items():
        if run.p_cfg.optimizer != "adamw":
            _close(p_p[k], v, k)
            continue
        off = ~torch.isclose(p_p[k], v, rtol=RTOL, atol=ATOL)
        assert k == "blocks/attn/bk" or off.float().mean() <= MAX_FLIP_SHARE, k
        assert float((p_p[k] - v).abs().max()) <= 2 * lr0 * 1.001, k


def _device_round(cfg):
    """The reference's pieces for one FL device, jitted as one program:
    H local SGD steps of ``jax.value_and_grad(lm_loss)`` on the device's
    microbatches, the f32 net progress and ``steps._compress_leaf_dense``
    on each leaf."""
    vg = jax.value_and_grad(lambda p, b: jtf.lm_loss(p, cfg, b))

    @jax.jit
    def device_round(p0, ef, batch, recv):
        p, loss_sum = p0, 0.0
        mb = TRAIN_BATCH // M_DEV // H
        for i in range(H):
            loss, g = vg(p, {k: v[i * mb:(i + 1) * mb]
                             for k, v in batch.items()})
            loss_sum = loss_sum + loss / H
            p = jax.tree_util.tree_map(
                lambda w, gi: (w.astype(jnp.float32)
                               - LR * gi.astype(jnp.float32)).astype(w.dtype),
                p, g)
        pairs = jax.tree_util.tree_map(
            lambda e, w0, w1: jsteps._compress_leaf_dense(
                e, w0.astype(jnp.float32) - w1.astype(jnp.float32), SPARSITY,
                recv, backend="exact"), ef, p0, p)
        is_pair = lambda t: isinstance(t, tuple)  # noqa: E731
        return (loss_sum, jax.tree_util.tree_map(lambda t: t[0], pairs,
                                                 is_leaf=is_pair),
                jax.tree_util.tree_map(lambda t: t[1], pairs,
                                       is_leaf=is_pair))
    return device_round


def test_lgc_round_matches_the_reference_composition(run):
    """M = 2, H = 2, ``dense_masked`` with every leaf through the kernel
    route (the plain versions on the CPU), channel 1 dropped on device 1:
    against the reference's pieces (:func:`_device_round`), the mean over
    devices and the server subtract."""
    p0 = run.params()
    rng = np.random.default_rng(11)
    ef0 = {k: (rng.standard_t(3, (M_DEV,) + tuple(v.shape)) * 1e-5).astype(
        np.float32) for k, v in p0.items()}
    b_local = TRAIN_BATCH // M_DEV
    device_round = _device_round(run.j_cfg)
    g_sum, ef_want, loss_sum = None, {k: [] for k in ef0}, 0.0
    for m in range(M_DEV):
        loss, g_m, e_m = device_round(
            run.jp, params_to_jax({k: torch.from_numpy(v[m])
                                   for k, v in ef0.items()}),
            {k: v[m * b_local:(m + 1) * b_local]
             for k, v in run.batch.items()}, jnp.asarray(RECEIVED[m]))
        loss_sum += float(loss)
        g_m = {k: v.numpy() for k, v in params_from_jax(
            jax.device_get(g_m)).items()}
        for k, v in params_from_jax(jax.device_get(e_m)).items():
            ef_want[k].append(v.numpy())
        g_sum = g_m if g_sum is None else {k: g_sum[k] + g_m[k] for k in g_m}
    params_want = {k: v.numpy() - g_sum[k] / M_DEV for k, v in p0.items()}
    step = psteps.make_lgc_train_step(
        run.p_cfg, M_DEV, psteps.LGCStepConfig(
            local_steps=H, local_lr=LR, sparsity=SPARSITY, backend="cuda",
            pallas_min_elems=1))
    params, ef, loss = step(p0, {k: torch.from_numpy(v)
                                 for k, v in ef0.items()},
                            _to_torch(run.batch), torch.from_numpy(RECEIVED))
    np.testing.assert_allclose(float(loss), loss_sum / M_DEV, rtol=RTOL)
    for got, want, what in ((params, params_want, "params"),
                            (ef, {k: np.stack(v) for k, v in
                                  ef_want.items()}, "ef")):
        for k, w in want.items():
            a = _np(got[k])
            assert a.shape == w.shape, k
            off = ~np.isclose(a, w, rtol=RTOL, atol=ATOL)
            assert off.mean() <= MAX_FLIP_SHARE, (
                f"{what} {k}: {off.sum()} of {off.size} coordinates differ, "
                f"max |diff| {np.abs(a - w).max():.3g}")


def test_grok_sgdm_moment_bitwise_the_references():
    """grok-smoke's SGD-momentum (``cfg.optimizer``), one step from the
    reference's own gradients of its loss, clip active: updates and moment
    bitwise the reference's jitted step in f32, and in bf16 (weights,
    gradients and moment in bf16: the moment keeps the parameters'
    dtype)."""
    assert get_smoke_config("grok-1-314b").optimizer == "sgdm"
    cfg = dict(lr=1e-2, warmup_steps=2, grad_clip=0.5)
    j_init, j_upd = jopt.get_optimizer("sgdm", jopt.OptimizerConfig(**cfg))
    p_init, p_upd = popt.get_optimizer("sgdm", popt.OptimizerConfig(**cfg))
    batch = _config("grok-1-314b").batch
    for dtype in (jnp.float32, jnp.bfloat16):
        j_cfg = dataclasses.replace(j_get_smoke("grok-1-314b"), dtype=dtype)
        jp = jtf.init_params(j_cfg, jax.random.PRNGKey(0))
        j_grads = jax.jit(jax.grad(lambda p, b: jtf.lm_loss(p, j_cfg, b)))(
            jp, batch)
        assert float(jax.jit(jopt.global_norm)(j_grads)) > cfg["grad_clip"]
        j_u, j_s = jax.jit(j_upd)(j_grads, j_init(jp), jp)
        pp = params_from_jax(jax.device_get(jp))
        p_u, p_s = p_upd(params_from_jax(jax.device_get(j_grads)),
                         p_init(pp), pp)
        for got, want in ((p_u, j_u), (p_s.momentum, j_s.momentum)):
            for k, w in params_from_jax(jax.device_get(want)).items():
                assert got[k].dtype == w.dtype, k
                assert got[k].dtype == pp[k].dtype, k
                assert torch.equal(got[k], w), (dtype, k)


@pytest.mark.parametrize("arch", ARCHS)
def test_driver_trains_each_config_at_smoke_size(arch):
    """``--mode sync`` (the config's optimizer: SGD momentum for grok-1,
    whose step is 1/100 of the rate in the warm-up and takes 5 steps to
    bring the loss down at this size) and ``--mode lgc``: the loss falls
    (the driver returns instead of exiting 1)."""
    sgdm = get_smoke_config(arch).optimizer == "sgdm"
    for mode, steps, lr in (("sync", 5 if sgdm else 3,
                             "1.0" if sgdm else "1e-2"), ("lgc", 3, "3e-2")):
        losses = train.main([
            "--arch", arch, "--smoke", "--steps", str(steps), "--batch", "4",
            "--seq", "16", "--mode", mode, "--devices", "2", "--lr", lr,
            "--local-steps", "2", "--log-every", "10", "--device", "cpu"])
        assert len(losses) == steps and losses[-1] < losses[0], (mode, losses)


# ---------------------------------------------------------------------------
# the gated and plain MoE experts
# ---------------------------------------------------------------------------

def _nested(flat: dict) -> dict:
    out: dict = {}
    for name, t in flat.items():
        node = out
        parts = name.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = t
    return out


@pytest.mark.parametrize("kind", ["geglu", "gelu", "swiglu"])
def test_moe_forward_each_expert_kind_with_drops(kind):
    """8 tokens, top-2 of 8 experts (grok-1's decode shape at batch 8):
    capacity int(16 / 8 * 1.25) = 2, so rows drop; the gelu experts'
    biases drawn (init leaves them zero).  ``moe_forward`` and the aux
    loss against the reference's, the dense oracles against each other,
    and a dropped row visible as a gap to the oracle."""
    e, k, d, f = 8, 2, 32, 48
    jp = jax.device_get(jmoe.moe_init(jax.random.PRNGKey(3), d, e, f, kind,
                                      jnp.float32))
    rng = np.random.default_rng(5)
    if kind == "gelu":
        for b in ("b_up", "b_down"):
            jp["experts"][b] = rng.standard_normal(
                jp["experts"][b].shape).astype(np.float32) * 0.1
    pp = _nested(params_from_jax(jp))
    assert set(pp["experts"]) == set(jp["experts"])
    x = rng.standard_normal((8, 1, d)).astype(np.float32)

    @jax.jit
    def ref(x, p):
        y, aux = jmoe.moe_forward(x, p, n_experts=e, top_k=k, mlp_kind=kind)
        dense, _ = jmoe.moe_dense_ref(x, p, n_experts=e, top_k=k,
                                      mlp_kind=kind)
        return y, aux, jmoe._router(x.reshape(8, d), p["router"], k)[1], \
            dense
    want, want_aux, j_ids, dense = ref(jnp.asarray(x), jp)
    got, got_aux = pmoe.moe_forward(torch.from_numpy(x), pp, n_experts=e,
                                    top_k=k, mlp_kind=kind)
    p_dense, _ = pmoe.moe_dense_ref(torch.from_numpy(x), pp, n_experts=e,
                                    top_k=k, mlp_kind=kind)
    counts = np.bincount(np.asarray(j_ids).reshape(-1), minlength=e)
    assert (counts > int(8 * k / e * 1.25)).any()          # rows drop
    _close(got, want, f"{kind} moe_forward", SERVE_ATOL)
    _close(got_aux, want_aux, "aux")
    _close(p_dense, dense, f"{kind} dense oracle", SERVE_ATOL)
    assert np.abs(_np(p_dense) - _np(got)).max() > 1e-3


@pytest.mark.parametrize("kind", ["geglu", "gelu"])
def test_expert_mlps_gradients_match_the_references_vmap(kind):
    """The batched experts' backward (autograd through ``torch.bmm``)
    against ``jax.grad`` of the reference's vmapped ``mlp_forward``."""
    from repro.models.layers import mlp_forward as j_mlp
    e, c, d, f = 4, 6, 16, 24
    jp = jax.device_get(jmoe.moe_init(jax.random.PRNGKey(7), d, e, f, kind,
                                      jnp.float32))["experts"]
    rng = np.random.default_rng(8)
    if kind == "gelu":
        jp = {k: (rng.standard_normal(v.shape).astype(np.float32) * 0.1
                  if k.startswith("b_") else v) for k, v in jp.items()}
    buf = rng.standard_normal((e, c, d)).astype(np.float32)
    w_out = rng.standard_normal((e, c, d)).astype(np.float32)

    def j_loss(p, x):
        y = jax.vmap(lambda xe, pe: j_mlp(xe, pe, kind))(x, p)
        return jnp.sum(y * w_out)
    want = jax.jit(jax.grad(j_loss, argnums=(0, 1)))(jp, buf)
    pp = {k: torch.from_numpy(np.array(v)).requires_grad_(True)
          for k, v in jp.items()}
    xb = torch.from_numpy(buf).requires_grad_(True)
    y = pmoe.expert_mlps(xb, pp, kind)
    (y * torch.from_numpy(w_out)).sum().backward()
    _close(xb.grad, want[1], "d buf")
    for k in pp:
        _close(pp[k].grad, want[0][k], k)
