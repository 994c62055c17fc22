"""The port's serving path for the moe, ssm and hybrid families held against
the JAX reference.

Both sides run the smoke configs of ``olmoe-1b-7b`` (moe: 4 experts,
top-2), ``mamba2-370m`` (ssm: 2 SSD blocks) and ``zamba2-1.2b`` (hybrid: 4
SSD blocks, the shared attention block before every 2), in float32, with
the reference's initial weights carried into the port by
``repro_torch.weights.params_from_jax`` and prompts made with numpy from a
seed.  Prefill logits and caches, then greedy steps past a 24-slot ring's
wrap, agree at rtol 1e-5 / atol 1e-5 (XLA:CPU and ATen sum the same f32
products in other orders; olmoe and zamba2 decode through ``swa_decode``'s
plain version), and the greedy tokens are equal.

The prefill's logits are held against the reference's full forward
(``logits_fn(forward_hidden(...))[:, -1]``), not its ``prefill``: for ssm
and hybrid the reference's ``prefill`` takes the last position's logits
from the embedding, because ``_prefill_ssm`` returns only the cache
(``repro/models/transformer.py:553-558``); its cache is right, and the
port's cache is held against it.  ``test_reference_ssm_prefill_logits``
pins that behaviour of the reference.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import get_smoke_config as j_get_smoke  # noqa: E402
from repro.models.layers import apply_norm  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import ssd as jssd  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config  # noqa: E402
from repro_torch.configs.base import ArchConfig as PArch  # noqa: E402
from repro_torch.launch import serve_decode, train  # noqa: E402
from repro_torch.launch.steps import (make_prefill_step,  # noqa: E402
                                      make_serve_step)
from repro_torch.models import moe as pmoe  # noqa: E402
from repro_torch.models import ssd as pssd  # noqa: E402
from repro_torch.models import transformer as ptf  # noqa: E402
from repro_torch.weights import cache_from_jax, params_from_jax  # noqa: E402

RTOL = ATOL = 1e-5
ARCHS = ("olmoe-1b-7b", "mamba2-370m", "zamba2-1.2b")
# parameters by shape (the reference's init_params under eval_shape)
PARAMS = {"olmoe-1b-7b": 6_919_620_608, "mamba2-370m": 420_136_448,
          "zamba2-1.2b": 1_170_473_856}
# a 16-token prompt (a multiple of the smoke SSD chunk, 16) into a 24-slot
# ring, then 16 steps: positions 16-31, wrapping at 24
PROMPT, WINDOW, STEPS, BATCH = 16, 24, 16, 2


def port_arch(cfg, dtype) -> PArch:
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
          if f.name != "dtype"}
    return PArch(**kw, dtype=dtype)


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().to(torch.float32).numpy()
    return np.asarray(t, np.float32)


def _close(got, want, msg=""):
    np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL, atol=ATOL,
                               err_msg=msg)


def _assert_caches_close(p_cache, j_cache):
    assert p_cache["pos"] == int(j_cache["pos"])
    assert set(p_cache) == set(j_cache)
    for group in ("kv", "ssm"):
        for name, want in j_cache.get(group, {}).items():
            got = p_cache[group][name]
            assert tuple(got.shape) == want.shape, (group, name)
            _close(got, want, f"{group}/{name}")


class Family:
    """One arch's reference run, computed once: f32 weights on both sides,
    the reference's prefill, full-forward logits and jitted decode step."""

    def __init__(self, arch: str):
        self.j_cfg = dataclasses.replace(j_get_smoke(arch), dtype=jnp.float32)
        self.p_cfg = port_arch(self.j_cfg, torch.float32)
        self.jp = jtf.init_params(self.j_cfg, jax.random.PRNGKey(0))
        self.pp = params_from_jax(jax.device_get(self.jp))
        self.toks = np.random.default_rng(0).integers(
            0, self.j_cfg.vocab_size, (BATCH, PROMPT), dtype=np.int32)
        cfg = self.j_cfg

        @jax.jit
        def prefill(params, tokens):
            logits, cache = jtf.prefill(params, cfg, {"tokens": tokens},
                                        WINDOW)
            hidden, _, _ = jtf.forward_hidden(params, cfg, tokens)
            emb = apply_norm(params["embed"][tokens[:, -1:]],
                             params["final_norm"], cfg.norm)
            return logits, cache, \
                jtf.logits_fn(params, cfg, hidden)[:, -1], \
                jtf.logits_fn(params, cfg, emb)[:, 0]
        (self.j_logits, self.j_cache, self.j_forward_last,
         self.j_embedding_last) = prefill(self.jp, jnp.asarray(self.toks))

        @jax.jit
        def step(params, token, cache):
            logits, cache = jtf.decode_step(params, cfg, token, cache,
                                            window=WINDOW)
            return logits, jnp.argmax(logits, -1).astype(jnp.int32)[:, None], \
                cache
        self.j_step = step


_FAMILIES: dict = {}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: its draws and decode steps are
    thousands of tiny ops, and with the suite's workers sharing the cores
    OpenMP's barriers wait on descheduled threads.  Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=ARCHS)
def fam(request) -> Family:
    if request.param not in _FAMILIES:
        _FAMILIES[request.param] = Family(request.param)
    return _FAMILIES[request.param]


# ---------------------------------------------------------------------------
# init and configs
# ---------------------------------------------------------------------------

def test_init_params_bitwise_the_reference(fam):
    """Every leaf (router f32, experts (L, E, ...), a_log, the hybrid's
    unstacked shared block) in the reference's order, bit for bit."""
    ours = ptf.init_params(fam.p_cfg, seed=0, device="cpu")
    assert list(ours) == list(fam.pp)
    for name, want in fam.pp.items():
        got = ours[name]
        assert got.dtype == want.dtype and got.shape == want.shape, name
        assert torch.equal(got, want), name


@pytest.mark.parametrize("nh", [1, 2, 8, 16, 32, 48, 64, 100, 128])
def test_a_log_bitwise_at_every_head_count(nh):
    """``log(linspace(1, 16, nh))`` as XLA computes it; 32 and 64 are the
    full configs' head counts (mamba2-370m, zamba2-1.2b)."""
    want = np.asarray(jnp.log(jnp.linspace(1.0, 16.0, nh)).astype(
        jnp.float32))
    got = pssd.a_log_init(nh, torch.device("cpu")).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_param_counts(arch):
    for ours, theirs in ((get_config(arch), j_get_config(arch)),
                         (get_smoke_config(arch), j_get_smoke(arch))):
        for f in dataclasses.fields(theirs):
            if f.name != "dtype":
                assert getattr(ours, f.name) == getattr(theirs, f.name), \
                    f.name
        assert ours.dtype == torch.bfloat16
    cfg = get_config(arch)
    assert ptf.param_count(cfg) == PARAMS[arch]
    shapes = jax.eval_shape(lambda: jtf.init_params(j_get_config(arch),
                                                    jax.random.PRNGKey(0)))
    leaves = jax.tree_util.tree_leaves(shapes)
    assert sum(int(np.prod(x.shape)) for x in leaves) == PARAMS[arch]
    meta = ptf.init_params(cfg, device="meta")
    assert [tuple(p.shape) for p in meta.values()] == \
        [tuple(x.shape) for x in leaves]


def test_other_archs_and_training_still_refuse():
    """Nothing refuses any more: the last four configs (A15) resolve, full
    and smoke, with the reference's fields (tests/test_torch_configs.py
    holds them further), and every family trains."""
    last = ("glm4-9b", "yi-34b", "grok-1-314b", "starcoder2-7b")
    modalities = ("phi-3-vision-4.2b", "whisper-small")
    assert set(last) | set(PARAMS) | set(modalities) | \
        {"qwen2-100m", "qwen2-1.5b"} == set(ARCH_IDS)
    for arch in ARCH_IDS:
        for get, j_get in ((get_config, j_get_config),
                           (get_smoke_config, j_get_smoke)):
            assert get(arch).name == j_get(arch).name
    # the families' training path (A16) is ported: lm_loss runs on each,
    # the vlm and audio families with the driver's zero modality stub
    for arch in ARCHS + modalities:
        cfg = dataclasses.replace(get_smoke_config(arch), dtype=torch.float32)
        toks = torch.zeros((1, 16), dtype=torch.int64)
        batch = {"tokens": toks, "labels": toks}
        prefix = train.modality_prefix(cfg, 1, "cpu")
        if prefix is not None:
            batch["prefix"] = prefix
            with pytest.raises(ValueError, match="prefix"):
                ptf.lm_loss(ptf.init_params(cfg, device="cpu"), cfg,
                            {"tokens": toks, "labels": toks})
        loss = ptf.lm_loss(ptf.init_params(cfg, device="cpu"), cfg, batch)
        assert loss.shape == () and bool(torch.isfinite(loss))


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def test_serve_f32_past_the_wrap(fam):
    """Prefill, then 16 greedy steps (positions 16-31 of a 24-slot ring):
    logits and caches at 1e-5, tokens equal."""
    p_logits, p_cache = make_prefill_step(fam.p_cfg, WINDOW, device="cpu")(
        fam.pp, {"tokens": torch.from_numpy(fam.toks)})
    _close(p_logits, fam.j_forward_last, "prefill logits")
    _assert_caches_close(p_cache, fam.j_cache)
    p_step = make_serve_step(fam.p_cfg, WINDOW, device="cpu",
                             return_logits=True)
    j_tok = jnp.argmax(fam.j_forward_last, -1).astype(jnp.int32)[:, None]
    p_tok = torch.argmax(p_logits, -1).to(torch.int32)[:, None]
    np.testing.assert_array_equal(p_tok.numpy(), np.asarray(j_tok))
    j_cache = fam.j_cache
    for i in range(STEPS):
        j_l, j_tok, j_cache = fam.j_step(fam.jp, j_tok, j_cache)
        p_tok, p_cache, p_l = p_step(fam.pp, p_tok, p_cache)
        _close(p_l, j_l, f"step {i} logits")
        np.testing.assert_array_equal(p_tok.numpy(), np.asarray(j_tok),
                                      err_msg=f"step {i} tokens")
    _assert_caches_close(p_cache, j_cache)
    assert p_cache["pos"] == PROMPT + STEPS > WINDOW


def test_decode_from_the_reference_cache(fam):
    """``cache_from_jax`` carries the reference's prefill cache (K/V sites,
    conv tails, states) across; decoding from it matches the reference."""
    p_cache = cache_from_jax(jax.device_get(fam.j_cache))
    _assert_caches_close(p_cache, fam.j_cache)
    p_step = make_serve_step(fam.p_cfg, WINDOW, device="cpu",
                             return_logits=True)
    tok = np.array(jnp.argmax(fam.j_forward_last, -1).astype(
        jnp.int32))[:, None]
    j_l, _, j_cache = fam.j_step(fam.jp, jnp.asarray(tok), fam.j_cache)
    _, p_cache, p_l = p_step(fam.pp, torch.from_numpy(tok), p_cache)
    _close(p_l, j_l, "step logits")
    _assert_caches_close(p_cache, j_cache)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_from_jax_round_trip_keeps_layout_and_bits(arch):
    """A bf16 reference cache of each family: ``conv`` in the config's
    dtype, ``state`` in f32, K/V sites, and no ``kv`` for mamba2."""
    cfg = j_get_smoke(arch)
    cache = jax.device_get(jtf.init_cache(cfg, 2, 6))
    rng = np.random.default_rng(7)
    for group in ("kv", "ssm"):
        for name, a in cache.get(group, {}).items():
            cache[group][name] = rng.standard_normal(a.shape).astype(a.dtype)
    cache["pos"] = np.int32(5)
    got = cache_from_jax(cache)
    assert got["pos"] == 5 and isinstance(got["pos"], int)
    assert set(got) == set(cache)
    want_dtypes = {"k": torch.bfloat16, "v": torch.bfloat16,
                   "conv": torch.bfloat16, "state": torch.float32}
    for group in ("kv", "ssm"):
        for name, a in cache.get(group, {}).items():
            t = got[group][name]
            assert t.dtype == want_dtypes[name] and t.shape == a.shape
            width = np.int16 if t.dtype == torch.bfloat16 else np.int32
            np.testing.assert_array_equal(
                t.view(torch.int16 if width == np.int16
                       else torch.int32).numpy(),
                np.asarray(a).view(width))
    port = ptf.init_cache(port_arch(cfg, torch.bfloat16), 2, 6,
                          device="cpu")
    assert {g: {n: (tuple(t.shape), t.dtype) for n, t in port[g].items()}
            for g in port if g != "pos"} == \
        {g: {n: (tuple(t.shape), t.dtype) for n, t in got[g].items()}
         for g in got if g != "pos"}


@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-1.2b"])
def test_reference_ssm_prefill_logits(arch):
    """The reference's ssm / hybrid ``prefill`` returns the logits of the
    LAST PROMPT TOKEN'S EMBEDDING (``_prefill_ssm`` returns only the cache,
    and ``prefill`` normalises its own ``x``); the port returns the blocks'
    output, as the reference's full forward and dense prefill do."""
    fam = _FAMILIES.get(arch) or _FAMILIES.setdefault(arch, Family(arch))
    np.testing.assert_allclose(np.asarray(fam.j_logits),
                               np.asarray(fam.j_embedding_last), rtol=1e-6,
                               atol=1e-6)
    assert np.abs(np.asarray(fam.j_logits)
                  - np.asarray(fam.j_forward_last)).max() > 0.1


def test_entry_points_refuse_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for arch in ARCHS:
        cfg = get_smoke_config(arch)
        with pytest.raises(RuntimeError, match="CUDA"):
            ptf.init_params(cfg)
        with pytest.raises(RuntimeError, match="CUDA"):
            ptf.init_cache(cfg, 1, 8)
        with pytest.raises(RuntimeError, match="CUDA"):
            make_prefill_step(cfg, 8)
        with pytest.raises(RuntimeError, match="CUDA"):
            make_serve_step(cfg, 8)
        with pytest.raises(RuntimeError, match="CUDA"):
            serve_decode.main(["--arch", arch, "--smoke", "--batch", "1",
                               "--prompt", "16", "--gen", "2"])
    # asked for explicitly, the CPU runs
    out = serve_decode.main(["--arch", "mamba2-370m", "--smoke", "--batch",
                             "2", "--prompt", "16", "--gen", "3", "--window",
                             "8", "--device", "cpu"])
    assert out["device"] == "cpu" and out["params"] == ptf.param_count(
        get_smoke_config("mamba2-370m"))
    for run in ("full", "ring"):
        assert out[run]["cache_slots"] is None and not out[run]["wrapped"]
        assert out[run]["pos"] == 19 and out[run]["logits_finite"]
    out = serve_decode.main(["--arch", "zamba2-1.2b", "--smoke", "--batch",
                             "2", "--prompt", "16", "--gen", "3", "--window",
                             "8", "--device", "cpu"])
    assert out["ring"]["cache_slots"] == 16 and out["ring"]["wrapped"]
    assert out["full"]["cache_slots"] == 19 and not out["full"]["wrapped"]
    with pytest.raises(SystemExit):
        serve_decode.main(["--arch", "mamba2-370m", "--smoke", "--prompt",
                           "20", "--device", "cpu"])


# ---------------------------------------------------------------------------
# the MoE layer
# ---------------------------------------------------------------------------

def _moe_pair(d=32, e=8, f=48, seed=3):
    """Reference MoE weights (f32) and the port's copy."""
    jp = jmoe.moe_init(jax.random.PRNGKey(seed), d, e, f, "swiglu",
                       jnp.float32)
    return jp, params_from_jax(jax.device_get(jp))


def _nested(flat: dict) -> dict:
    out: dict = {}
    for name, t in flat.items():
        node = out
        parts = name.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = t
    return out


def _drops(ids: np.ndarray, e: int, cap: int) -> int:
    counts = np.bincount(ids.reshape(-1), minlength=e)
    return int(np.clip(counts - cap, 0, None).sum())


def test_moe_forward_drops_rows_as_the_reference():
    """A decode shape (8 tokens, top-2 of 8 experts): capacity
    int(16 / 8 * 1.25) = 2, so an expert keeps its first 2 rows in the
    stable expert order; both sides route and drop the same rows."""
    e, k = 8, 2
    jp, pp = _moe_pair(e=e)
    pp = _nested(pp)
    x = np.random.default_rng(5).standard_normal((8, 1, 32)).astype(
        np.float32)

    @jax.jit
    def ref(x, p):
        y, aux = jmoe.moe_forward(x, p, n_experts=e, top_k=k)
        dense, _ = jmoe.moe_dense_ref(x, p, n_experts=e, top_k=k)
        return y, aux, jmoe._router(x.reshape(8, 32), p["router"], k)[1], \
            dense
    want, want_aux, j_ids, dense = ref(jnp.asarray(x), jp)
    got, got_aux = pmoe.moe_forward(torch.from_numpy(x), pp, n_experts=e,
                                    top_k=k)
    _, p_ids, _ = pmoe._router(torch.from_numpy(x.reshape(8, 32)),
                               pp["router"], k)
    np.testing.assert_array_equal(p_ids.numpy(), np.asarray(j_ids))
    cap = max(1, int(8 * k / e * 1.25))
    assert _drops(np.asarray(j_ids), e, cap) > 0
    assert _drops(p_ids.numpy(), e, cap) > 0
    _close(got, want, "moe_forward with drops")
    _close(got_aux, want_aux, "aux")
    # a dropped row changes the output: the dense oracle disagrees
    assert np.abs(np.asarray(dense) - _np(got)).max() > 1e-3


def test_moe_forward_matches_the_dense_oracle_without_drops():
    e, k = 8, 2
    jp, pp = _moe_pair(e=e, seed=4)
    pp = _nested(pp)
    x = np.random.default_rng(6).standard_normal((2, 16, 32)).astype(
        np.float32)
    got, aux1 = pmoe.moe_forward(torch.from_numpy(x), pp, n_experts=e,
                                 top_k=k, capacity_factor=8.0)
    dense, aux2 = pmoe.moe_dense_ref(torch.from_numpy(x), pp, n_experts=e,
                                     top_k=k)
    want, _ = jax.jit(lambda x, p: jmoe.moe_dense_ref(
        x, p, n_experts=e, top_k=k))(jnp.asarray(x), jp)
    _close(got, dense, "moe_forward against the port's oracle")
    _close(dense, want, "the port's oracle against the reference's")
    assert float(aux1) == pytest.approx(float(aux2), rel=1e-6)


def test_router_ties_go_to_the_lower_index():
    """``lax.top_k``'s tie order: equal probabilities pick the lower
    expert first."""
    x = torch.ones((3, 4))
    w = torch.zeros((4, 6))
    w[:, 4] = 1.0                      # expert 4 wins, 0-3 and 5 tie
    gates, ids, _ = pmoe._router(x, w, 3)
    _, j_ids, _ = jmoe._router(jnp.ones((3, 4)), jnp.asarray(w.numpy()), 3)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(j_ids))
    assert ids[0].tolist() == [4, 0, 1]


# ---------------------------------------------------------------------------
# the SSD block
# ---------------------------------------------------------------------------

def _ssd_inputs(b=2, s=32, h=4, p=8, n=16, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    a_log = pssd.a_log_init(h, torch.device("cpu")).numpy()
    bm = rng.standard_normal((b, s, n)).astype(np.float32)
    cm = rng.standard_normal((b, s, n)).astype(np.float32)
    return x, dt, a_log, bm, cm


def test_ssd_chunked_matches_the_reference_and_the_step_recurrence():
    args = _ssd_inputs()
    y, h = pssd.ssd_chunked(*map(torch.from_numpy, args), 16)
    jy, jh = jax.jit(jssd.ssd_chunked, static_argnums=5)(
        *map(jnp.asarray, args), 16)
    _close(y, jy, "y")
    _close(h, jh, "final state")
    x, dt, a_log, bm, cm = map(torch.from_numpy, args)
    state = torch.zeros((2, 4, 8, 16))
    ys = []
    for t in range(x.shape[1]):
        yt, state = pssd.ssd_step(x[:, t], dt[:, t], a_log, bm[:, t],
                                  cm[:, t], state)
        ys.append(yt)
    np.testing.assert_allclose(_np(torch.stack(ys, 1)), _np(y), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(_np(state), _np(h), rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="multiple"):
        pssd.ssd_chunked(x[:, :24], dt[:, :24], a_log, bm[:, :24],
                         cm[:, :24], 16)
