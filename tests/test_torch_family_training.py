"""The port's training path for the moe, ssm, hybrid, vlm and audio
families held against the JAX reference.

Both sides run the smoke configs of ``olmoe-1b-7b`` (moe: 4 experts, top-2,
capacity drops at this batch), ``mamba2-370m`` (ssm: two 16-step SSD
chunks), ``zamba2-1.2b`` (hybrid: the shared block before every 2 of 4
SSD blocks), ``phi-3-vision-4.2b`` (vlm: 16 patch embeddings prepended) and
``whisper-small`` (audio: a 2-block encoder over 64 frames, cross-attention
in every decoder block; once more with ``max_position`` 16 below the 32
tokens, so that ``dec_pos`` clamps), in float32, with the reference's
weights carried across by ``repro_torch.weights.params_from_jax`` and
tokens, labels and modality prefix made with numpy from a seed.

``forward_hidden``, ``lm_loss`` and every gradient leaf are held against
the reference's ``forward_hidden`` and ``jax.value_and_grad(lm_loss)``;
then one ``make_sync_train_step`` step (two microbatches, the prefix split
with them) and one ``make_lgc_train_step`` round (``dense_masked``, M = 2
FL devices, H = 2, the prefix sliced per device and per local step, a
dropped channel) against the reference's pieces composed by hand, as
tests/test_torch_lgc_step.py does for the dense family (one process has
one jax device).  The tolerance is the dense one, rtol 1e-5 / atol 1e-6,
except where the SSD's summation order needs more: the chunked scan's
einsums and the hybrid's shared block, whose gradient sums over its
application sites, add f32 products in other orders on XLA:CPU and ATen,
so the ssm and hybrid families' gradients take atol 1e-5; the hidden
states, of order 1 after the final norm, take the serving tests' 1e-5.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as j_get_smoke  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro_torch.configs.base import ArchConfig as PArch  # noqa: E402
from repro_torch.launch import steps as psteps  # noqa: E402
from repro_torch.models import moe as pmoe  # noqa: E402
from repro_torch.models import transformer as ptf  # noqa: E402
from repro_torch.optim import optimizers as popt  # noqa: E402
from repro_torch.weights import params_from_jax, params_to_jax  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
SSD_ATOL = 1e-5                 # the ssm and hybrid families' gradients
HIDDEN_ATOL = 1e-5              # activations of order 1 (the serving tests')
MAX_FLIP_SHARE = 1e-3           # LGC: a coordinate next to a bin edge
M_DEV, H, SEQ = 2, 2, 32
BATCH = M_DEV * H               # one row a local step
LR, SPARSITY = 3e-3, (0.05, 0.1, 0.1)
RECEIVED = np.array([[1, 1, 1], [1, 0, 1]], np.int32)
ARCHS = ("olmoe-1b-7b", "mamba2-370m", "zamba2-1.2b", "phi-3-vision-4.2b",
         "whisper-small")
# case -> (arch, config overrides)
CASES = {arch: (arch, {}) for arch in ARCHS} | {
    "whisper-small-clamped": ("whisper-small", {"max_position": 16})}


def port_arch(cfg) -> PArch:
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
          if f.name != "dtype"}
    return PArch(**kw, dtype=torch.float32)


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().numpy()
    return np.asarray(t, np.float32)


def _close(got, want, msg="", atol=ATOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL, atol=atol,
                               err_msg=msg)


def _to_torch(batch: dict) -> dict:
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32
            else torch.from_numpy(v) for k, v in batch.items()}


def _rows(batch: dict, rows: slice) -> dict:
    return {k: v[rows] for k, v in batch.items()}


class Run:
    """One case's reference run, computed once: f32 weights on both sides,
    a numpy batch, the reference's forward, loss and gradients."""

    def __init__(self, case: str):
        arch, over = CASES[case]
        self.j_cfg = dataclasses.replace(j_get_smoke(arch), dtype=jnp.float32,
                                         **over)
        self.p_cfg = port_arch(self.j_cfg)
        self.jp = jax.device_get(jtf.init_params(self.j_cfg,
                                                 jax.random.PRNGKey(0)))
        rng = np.random.default_rng(len(case))
        cfg = self.j_cfg
        self.batch = {
            "tokens": rng.integers(0, cfg.vocab_size, (BATCH, SEQ),
                                   dtype=np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (BATCH, SEQ),
                                   dtype=np.int32)}
        if cfg.arch_type == "vlm":
            self.batch["prefix"] = rng.standard_normal(
                (BATCH, cfg.n_prefix_tokens, 1024)).astype(np.float32)
        if cfg.arch_type == "audio":
            self.batch["prefix"] = rng.standard_normal(
                (BATCH, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
        self.vg = jax.jit(jax.value_and_grad(
            lambda p, b: jtf.lm_loss(p, cfg, b)))
        self.j_fwd = jax.device_get(jax.jit(
            lambda p, t, x: jtf.forward_hidden(p, cfg, t, x)[:2])(
                self.jp, self.batch["tokens"], self.batch.get("prefix")))
        loss, grads = self.vg(self.jp, self.batch)
        self.j_loss, self.j_grads = float(loss), params_from_jax(
            jax.device_get(grads))
        self.atol = SSD_ATOL if cfg.arch_type in ("ssm", "hybrid") else ATOL

    def params(self) -> dict:
        return params_from_jax(self.jp)


_RUNS: dict = {}


def _run(case: str) -> Run:
    if case not in _RUNS:
        _RUNS[case] = Run(case)
    return _RUNS[case]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: its forward and backward passes
    are many small ops, and with the suite's workers sharing the cores
    OpenMP's barriers wait on descheduled threads.  Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=list(CASES))
def run(request) -> Run:
    return _run(request.param)


def test_forward_hidden_matches_the_reference(run):
    b = _to_torch(run.batch)
    hidden, aux, n_prefix = ptf.forward_hidden(run.params(), run.p_cfg,
                                               b["tokens"], b.get("prefix"))
    want_n = run.j_cfg.n_prefix_tokens if run.j_cfg.arch_type == "vlm" else 0
    assert n_prefix == want_n
    assert tuple(hidden.shape) == (BATCH, SEQ + want_n, run.j_cfg.d_model)
    _close(hidden, run.j_fwd[0], "hidden", HIDDEN_ATOL)
    _close(aux, run.j_fwd[1], "aux")
    assert aux.dtype == torch.float32


def test_loss_and_every_gradient_leaf_match_the_reference(run):
    names = list(run.j_grads)
    leaves = [v.requires_grad_(True) for v in run.params().values()]
    loss = ptf.lm_loss(dict(zip(names, leaves)), run.p_cfg,
                       _to_torch(run.batch))
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), run.j_loss, rtol=RTOL)
    for k, g in zip(names, grads):
        assert bool(torch.isfinite(g).all()), k
        _close(g, run.j_grads[k], k, run.atol)
        assert bool(g.any()) == bool(run.j_grads[k].any()), k


def test_moe_aux_loss_on_its_own(monkeypatch):
    """olmoe: the summed load-balance loss equals the reference's and
    enters the loss as ``router_aux_weight * aux / n_layers``; and the
    forward drops rows at capacity (C = int(N K / E * 1.25) = 80 rows an
    expert for the 128 tokens' 256 rows over 4 experts), so the forward
    and gradients above hold the reference's drops: some block's output
    differs from the dense oracle's, which drops nothing."""
    run = _run("olmoe-1b-7b")
    b = _to_torch(run.batch)
    dropped = []
    orig = pmoe.moe_forward

    def checked(x, p, **kw):
        y, aux = orig(x, p, **kw)
        kw.pop("capacity_factor")
        assert kw.pop("mesh") is None           # no model axis here
        y_all, aux_all = pmoe.moe_dense_ref(x, p, **kw)
        assert torch.equal(aux, aux_all)
        dropped.append(not torch.allclose(y, y_all, rtol=RTOL, atol=ATOL))
        return y, aux
    monkeypatch.setattr(pmoe, "moe_forward", checked)
    _, aux, _ = ptf.forward_hidden(run.params(), run.p_cfg, b["tokens"])
    assert len(dropped) == run.j_cfg.n_layers and any(dropped)
    assert float(aux) > 0
    _close(aux, run.j_fwd[1], "aux")
    cfg0 = dataclasses.replace(run.p_cfg, router_aux_weight=0.0)
    with_aux = ptf.lm_loss(run.params(), run.p_cfg, b)
    without = ptf.lm_loss(run.params(), cfg0, b)
    np.testing.assert_allclose(
        float(with_aux - without),
        run.j_cfg.router_aux_weight * float(aux) / run.j_cfg.n_layers,
        rtol=1e-4)
    j0 = dataclasses.replace(run.j_cfg, router_aux_weight=0.0)
    np.testing.assert_allclose(
        float(without), float(jtf.lm_loss(run.jp, j0, run.batch)), rtol=RTOL)


@pytest.mark.parametrize("case", ARCHS)
def test_sync_step_matches_the_reference(case):
    """One SGD-momentum step (clip active) over two microbatches, the
    prefix split with the tokens, from the same weights."""
    run = _run(case)
    opt = dict(lr=1e-2, warmup_steps=2)
    j_cfg = dataclasses.replace(run.j_cfg, optimizer="sgdm")
    p_cfg = dataclasses.replace(run.p_cfg, optimizer="sgdm")
    j_step = jax.jit(jsteps.make_sync_train_step(
        j_cfg, accum_steps=2, opt_cfg=jopt.OptimizerConfig(**opt)))
    p_step = psteps.make_sync_train_step(
        p_cfg, accum_steps=2, opt_cfg=popt.OptimizerConfig(**opt))
    j_p, _, j_loss = j_step(run.jp, jopt.sgdm_init(run.jp), run.batch)
    p0 = run.params()
    p_p, p_s, p_loss = p_step(p0, popt.sgdm_init(p0), _to_torch(run.batch))
    np.testing.assert_allclose(float(p_loss), float(j_loss), rtol=RTOL)
    assert p_s.step == 1
    for k, v in params_from_jax(jax.device_get(j_p)).items():
        _close(p_p[k], v, k, run.atol)


def _rand(shape, seed, scale=1e-5):
    return (np.random.default_rng(seed).standard_t(3, shape) * scale
            ).astype(np.float32)


def _device_round(cfg):
    """The reference's pieces for one FL device, jitted as one program:
    H local SGD steps of ``jax.value_and_grad(lm_loss)`` on the device's
    microbatches (every batch leaf sliced), the f32 net progress and
    ``steps._compress_leaf_dense`` on each leaf."""
    vg = jax.value_and_grad(lambda p, b: jtf.lm_loss(p, cfg, b))

    @jax.jit
    def device_round(p0, ef, batch, recv):
        p, loss_sum = p0, 0.0
        mb = BATCH // M_DEV // H
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


@pytest.mark.parametrize("case", ARCHS)
def test_lgc_round_matches_the_reference_composition(case):
    """M = 2, H = 2, ``dense_masked`` with every leaf through the kernel
    route (the plain versions on the CPU), channel 1 dropped on device 1:
    against the reference's pieces (:func:`_device_round`), the mean over
    devices and the server subtract."""
    run = _run(case)
    p0 = run.params()
    ef0 = {k: _rand((M_DEV,) + tuple(v.shape), 10 + i)
           for i, (k, v) in enumerate(p0.items())}
    b_local = BATCH // M_DEV
    device_round = _device_round(run.j_cfg)
    g_sum, ef_want, loss_sum = None, {k: [] for k in ef0}, 0.0
    for m in range(M_DEV):
        loss, g_m, e_m = device_round(
            run.jp, params_to_jax({k: torch.from_numpy(v[m])
                                   for k, v in ef0.items()}),
            _rows(run.batch, slice(m * b_local,
                                                 (m + 1) * b_local)),
            jnp.asarray(RECEIVED[m]))
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
            off = ~np.isclose(a, w, rtol=RTOL, atol=run.atol)
            assert off.mean() <= MAX_FLIP_SHARE, (
                f"{what} {k}: {off.sum()} of {off.size} coordinates differ, "
                f"max |diff| {np.abs(a - w).max():.3g}")


def test_reference_zero_patch_stub_overflows_at_depth():
    """The reference's driver feeds the vlm zero patch embeddings
    (``repro/launch/train.py:71-73``).  Zero patch rows stay zero through
    every block, and RMSNorm's Jacobian at a zero row is 1 / sqrt(eps) =
    1000, so the gradient sent back into those rows overflows with depth:
    at phi3v-smoke's width with 16 blocks, in f32, the reference's
    gradients and the port's are non-finite alike (phi-3-vision has 32).
    The port's driver draws the patches from a seed
    (``train.modality_prefix``), and its gradients are finite."""
    from repro_torch.launch import train
    j_cfg = dataclasses.replace(j_get_smoke("phi-3-vision-4.2b"),
                                dtype=jnp.float32, n_layers=16)
    p_cfg = port_arch(j_cfg)
    jp = jax.device_get(jtf.init_params(j_cfg, jax.random.PRNGKey(0)))
    toks = np.random.default_rng(0).integers(0, j_cfg.vocab_size, (2, 16),
                                             dtype=np.int32)
    zeros = np.zeros((2, j_cfg.n_prefix_tokens, 1024), np.float32)
    _, j_g = jax.jit(jax.value_and_grad(lambda p, b: jtf.lm_loss(
        p, j_cfg, b)))(jp, {"tokens": toks, "labels": toks, "prefix": zeros})
    assert not np.isfinite(np.asarray(j_g["embed"])).all()

    def port_grads(prefix):
        pp = params_from_jax(jp)
        names = list(pp)
        leaves = [v.requires_grad_(True) for v in pp.values()]
        t = torch.from_numpy(toks).long()
        loss = ptf.lm_loss(dict(zip(names, leaves)), p_cfg,
                           {"tokens": t, "labels": t, "prefix": prefix})
        return dict(zip(names, torch.autograd.grad(loss, leaves)))
    assert not bool(torch.isfinite(
        port_grads(torch.from_numpy(zeros))["embed"]).all())
    stub = train.modality_prefix(p_cfg, 2, "cpu")
    assert all(bool(torch.isfinite(g).all())
               for g in port_grads(stub).values())
