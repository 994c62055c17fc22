"""The port's serving path for the vlm and audio families held against the
JAX reference.

Both sides run the smoke configs of ``phi-3-vision-4.2b`` (vlm: 16 patch
embeddings of width 1024 through ``vis_proj``, prepended to the prompt)
and ``whisper-small`` (audio: a 2-block non-causal encoder over 64 frames,
2 decoder blocks with cross-attention, layernorm with bias, a GELU MLP with
biases, learned positions, no RoPE), in float32, with the reference's
initial weights carried into the port by
``repro_torch.weights.params_from_jax`` and prompts and modality stubs made
with numpy from a seed.  Prefill logits and caches (``cross_k`` /
``cross_v`` included), then greedy steps past a 24-slot ring's wrap, agree
at rtol 1e-5 / atol 1e-5 (XLA:CPU and ATen sum the same f32 products in
other orders; both decode through ``swa_decode``'s plain version, whisper
also over its cross-attention cache), and the greedy tokens are equal.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import get_smoke_config as j_get_smoke  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.configs.base import ArchConfig as PArch  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.launch import serve_decode  # noqa: E402
from repro_torch.launch.steps import (make_prefill_step,  # noqa: E402
                                      make_serve_step)
from repro_torch.models import layers as pl_  # noqa: E402
from repro_torch.models import transformer as ptf  # noqa: E402
from repro_torch.weights import cache_from_jax, params_from_jax  # noqa: E402

RTOL = ATOL = 1e-5
ARCHS = ("phi-3-vision-4.2b", "whisper-small")
# parameters by shape (the reference's init_params under eval_shape)
PARAMS = {"phi-3-vision-4.2b": 3_825_404_928, "whisper-small": 304_508_928}
WINDOW, STEPS, BATCH = 24, 16, 2
# prompt tokens: the vlm's 16 patch positions + 8 tokens fill the 24-slot
# ring, whisper's 16 tokens fill 16 of them; 16 steps then wrap both
PROMPT = {"phi-3-vision-4.2b": 8, "whisper-small": 16}


def port_arch(cfg, dtype) -> PArch:
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
          if f.name != "dtype"}
    return PArch(**kw, dtype=dtype)


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().to(torch.float32).numpy()
    return np.asarray(t, np.float32)


def _close(got, want, msg="", tol=RTOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol,
                               err_msg=msg)


def _assert_caches_close(p_cache, j_cache):
    assert p_cache["pos"] == int(j_cache["pos"])
    assert set(p_cache) == set(j_cache)
    for name in ("k", "v"):
        got, want = p_cache["kv"][name], j_cache["kv"][name]
        assert tuple(got.shape) == want.shape, name
        _close(got, want, f"kv/{name}")
    for name in ("cross_k", "cross_v"):
        if name in j_cache:
            assert tuple(p_cache[name].shape) == j_cache[name].shape, name
            _close(p_cache[name], j_cache[name], name)


def stub(cfg, seed=1) -> np.ndarray:
    """The modality stub at the reference's shapes (launch/shapes.py)."""
    shape = ((BATCH, cfg.n_prefix_tokens, 1024) if cfg.arch_type == "vlm"
             else (BATCH, cfg.encoder_seq, cfg.d_model))
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


class Modality:
    """One arch's reference run, computed once: f32 weights on both sides,
    the reference's prefill and jitted decode step."""

    def __init__(self, arch: str):
        self.arch = arch
        self.j_cfg = dataclasses.replace(j_get_smoke(arch), dtype=jnp.float32)
        self.p_cfg = port_arch(self.j_cfg, torch.float32)
        self.jp = jtf.init_params(self.j_cfg, jax.random.PRNGKey(0))
        self.pp = params_from_jax(jax.device_get(self.jp))
        self.prompt = PROMPT[arch]
        self.toks = np.random.default_rng(0).integers(
            0, self.j_cfg.vocab_size, (BATCH, self.prompt), dtype=np.int32)
        self.prefix = stub(self.j_cfg)
        cfg = self.j_cfg

        @jax.jit
        def prefill(params, tokens, prefix):
            return jtf.prefill(params, cfg, {"tokens": tokens,
                                             "prefix": prefix}, WINDOW)
        self.j_logits, self.j_cache = prefill(
            self.jp, jnp.asarray(self.toks), jnp.asarray(self.prefix))

        @jax.jit
        def step(params, token, cache):
            logits, cache = jtf.decode_step(params, cfg, token, cache,
                                            window=WINDOW)
            return logits, jnp.argmax(logits, -1).astype(jnp.int32)[:, None], \
                cache
        self.j_step = step

    def batch(self) -> dict:
        return {"tokens": torch.from_numpy(self.toks),
                "prefix": torch.from_numpy(self.prefix)}


_RUNS: dict = {}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: its decode steps are thousands
    of tiny ops, and with the suite's workers sharing the cores OpenMP's
    barriers wait on descheduled threads.  Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=ARCHS)
def mod(request) -> Modality:
    if request.param not in _RUNS:
        _RUNS[request.param] = Modality(request.param)
    return _RUNS[request.param]


# ---------------------------------------------------------------------------
# init and configs
# ---------------------------------------------------------------------------

def test_init_params_bitwise_the_reference(mod):
    """Every leaf (vis_proj; the encoder and decoder stacks, the cross
    blocks from each layer's subkey 2, the norms' biases, enc_pos and
    dec_pos) in the reference's order, bit for bit."""
    ours = ptf.init_params(mod.p_cfg, seed=0, device="cpu")
    assert list(ours) == list(mod.pp)
    for name, want in mod.pp.items():
        got = ours[name]
        assert got.dtype == want.dtype and got.shape == want.shape, name
        assert torch.equal(got, want), name


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


# ---------------------------------------------------------------------------
# the layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,tol", [("float32", RTOL), ("bfloat16", 1e-2)])
def test_layernorm_matches_the_reference(dtype, tol):
    """Statistics in f32, the cast to x's dtype before ``* scale + bias``;
    bf16 to one step of its rounding."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((3, 5, 48)) * 4 + 1).astype(np.float32)
    scale = rng.standard_normal(48).astype(np.float32)
    bias = rng.standard_normal(48).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jax.jit(jl.layernorm)(*(jnp.asarray(a).astype(jdt)
                                   for a in (x, scale, bias)))
    p = {"scale": torch.from_numpy(scale).to(tdt),
         "bias": torch.from_numpy(bias).to(tdt)}
    got = pl_.apply_norm(torch.from_numpy(x).to(tdt), p, "layernorm")
    assert got.dtype == tdt
    _close(got, want, "layernorm", tol)


@pytest.mark.parametrize("kind", ["gelu", "geglu", "swiglu"])
def test_mlp_init_and_forward_match_the_reference(kind):
    """``mlp_init`` bitwise (gelu: up from subkey 1, down from subkey 3,
    zero biases) and ``mlp_forward`` at 1e-5 with jax's tanh GELU; torch's
    default erf GELU is another function."""
    d, dff = 24, 40
    key = jax.random.PRNGKey(5)
    jp = jl.mlp_init(key, d, dff, kind, jnp.float32)
    if kind == "gelu":    # non-zero biases, so that both are added
        jp = dict(jp, b_up=jnp.linspace(-1.0, 1.0, dff),
                  b_down=jnp.linspace(0.5, -0.5, d))
    ours = pl_.mlp_init([prng.PRNGKey(5)], (), d, dff, kind, torch.float32,
                        torch.device("cpu"))
    theirs = params_from_jax(jax.device_get(jl.mlp_init(key, d, dff, kind,
                                                        jnp.float32)))
    assert list(sorted(ours)) == list(theirs)
    for name, want in theirs.items():
        assert torch.equal(ours[name], want), name
    x = np.random.default_rng(4).standard_normal((2, 3, d)).astype(
        np.float32) * 2
    want = jax.jit(lambda x, p: jl.mlp_forward(x, p, kind))(jnp.asarray(x),
                                                            jp)
    p = params_from_jax(jax.device_get(jp))
    got = pl_.mlp_forward(torch.from_numpy(x), p, kind)
    _close(got, want, kind)
    if kind != "swiglu":
        h = torch.from_numpy(x) @ p["w_up"]
        assert (torch.nn.functional.gelu(h) - pl_.gelu(h)).abs().max() > 1e-4


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def test_prefill_logits_and_cache(mod):
    """The vlm's patch positions ahead of the prompt (positions and ``pos``
    over P + S), whisper's encoder, ``dec_pos`` and cross-attention K/V:
    logits and the whole cache at 1e-5."""
    p_logits, p_cache = make_prefill_step(mod.p_cfg, WINDOW, device="cpu")(
        mod.pp, mod.batch())
    _close(p_logits, mod.j_logits, "prefill logits")
    _assert_caches_close(p_cache, mod.j_cache)
    n_prefix = mod.j_cfg.n_prefix_tokens if mod.arch == "phi-3-vision-4.2b" \
        else 0
    assert p_cache["pos"] == n_prefix + mod.prompt
    if mod.arch == "whisper-small":
        assert tuple(p_cache["cross_k"].shape) == (
            2, BATCH, 4, mod.j_cfg.encoder_seq, 32)


def test_serve_f32_past_the_wrap(mod):
    """Prefill, then 16 greedy steps past the 24-slot ring's wrap: logits
    and caches at 1e-5, tokens equal."""
    p_logits, p_cache = make_prefill_step(mod.p_cfg, WINDOW, device="cpu")(
        mod.pp, mod.batch())
    p_step = make_serve_step(mod.p_cfg, WINDOW, device="cpu",
                             return_logits=True)
    j_tok = jnp.argmax(mod.j_logits, -1).astype(jnp.int32)[:, None]
    p_tok = torch.argmax(p_logits, -1).to(torch.int32)[:, None]
    np.testing.assert_array_equal(p_tok.numpy(), np.asarray(j_tok))
    j_cache = mod.j_cache
    for i in range(STEPS):
        j_l, j_tok, j_cache = mod.j_step(mod.jp, j_tok, j_cache)
        p_tok, p_cache, p_l = p_step(mod.pp, p_tok, p_cache)
        _close(p_l, j_l, f"step {i} logits")
        np.testing.assert_array_equal(p_tok.numpy(), np.asarray(j_tok),
                                      err_msg=f"step {i} tokens")
    _assert_caches_close(p_cache, j_cache)
    assert p_cache["pos"] == int(mod.j_cache["pos"]) + STEPS > WINDOW


def test_decode_from_the_reference_cache(mod):
    """``cache_from_jax`` carries the reference's prefill cache (self K/V,
    and whisper's cross K/V) across; decoding from it matches the
    reference."""
    p_cache = cache_from_jax(jax.device_get(mod.j_cache))
    _assert_caches_close(p_cache, mod.j_cache)
    p_step = make_serve_step(mod.p_cfg, WINDOW, device="cpu",
                             return_logits=True)
    tok = np.array(jnp.argmax(mod.j_logits, -1).astype(jnp.int32))[:, None]
    j_l, _, j_cache = mod.j_step(mod.jp, jnp.asarray(tok), mod.j_cache)
    _, p_cache, p_l = p_step(mod.pp, torch.from_numpy(tok), p_cache)
    _close(p_l, j_l, "step logits")
    _assert_caches_close(p_cache, j_cache)


def test_cache_from_jax_keeps_whisper_cross_cache_bits():
    """A bf16 reference audio cache: ``kv`` and ``cross_k`` / ``cross_v``
    (L, B, H, S_enc, hd) carried bit for bit, the port's own
    ``init_cache`` of the same shapes and dtypes."""
    cfg = j_get_smoke("whisper-small")
    cache = jax.device_get(jtf.init_cache(cfg, 2, 6))
    rng = np.random.default_rng(7)
    for name in ("k", "v"):
        a = cache["kv"][name]
        cache["kv"][name] = rng.standard_normal(a.shape).astype(a.dtype)
    for name in ("cross_k", "cross_v"):
        a = cache[name]
        cache[name] = rng.standard_normal(a.shape).astype(a.dtype)
    cache["pos"] = np.int32(5)
    got = cache_from_jax(cache)
    assert got["pos"] == 5 and set(got) == set(cache)
    pairs = [(got["kv"][n], cache["kv"][n]) for n in ("k", "v")] + \
        [(got[n], cache[n]) for n in ("cross_k", "cross_v")]
    for t, a in pairs:
        assert t.dtype == torch.bfloat16 and t.shape == a.shape
        np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                      np.asarray(a).view(np.int16))
    port = ptf.init_cache(port_arch(cfg, torch.bfloat16), 2, 6,
                          device="cpu")
    assert set(port) == set(got)
    for name in ("cross_k", "cross_v"):
        assert port[name].shape == got[name].shape
        assert port[name].dtype == got[name].dtype


def test_serve_decode_on_the_cpu_counts_prefix_positions():
    """``serve_decode`` draws each family's stub; the vlm's report counts
    the prompt's tokens and, apart, the positions with the patches."""
    out = serve_decode.main(["--arch", "phi-3-vision-4.2b", "--smoke",
                             "--batch", "2", "--prompt", "8", "--gen", "3",
                             "--window", "24", "--device", "cpu"])
    n = get_smoke_config("phi-3-vision-4.2b").n_prefix_tokens
    for run in ("full", "ring"):
        r = out[run]
        assert r["prefix_positions"] == n and r["pos"] == n + 8 + 3
        assert r["prefill_positions_per_s"] == pytest.approx(
            r["prompt_tokens_per_s"] * (n + 8) / 8)
        assert r["logits_finite"]
    assert out["full"]["cache_slots"] == n + 8 + 3
    assert out["ring"]["cache_slots"] == 24 and out["ring"]["wrapped"]
    out = serve_decode.main(["--arch", "whisper-small", "--smoke", "--batch",
                             "2", "--prompt", "16", "--gen", "9", "--window",
                             "24", "--device", "cpu"])
    assert out["params"] == ptf.param_count(get_smoke_config("whisper-small"))
    assert out["ring"]["prefix_positions"] == 0
    assert out["ring"]["wrapped"] and out["ring"]["pos"] == 25


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
