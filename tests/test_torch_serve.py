"""The port's serving path held against the JAX reference.

Both sides run ``qwen2-smoke`` (2 layers, d_model 256, 4 heads, 2 KV heads)
with the reference's initial weights carried into the port by
``repro_torch.weights.params_from_jax``; prompts are made with numpy from a
seed.  In float32 the port's prefill, cache and serve steps agree with the
reference's at rtol 1e-5 / atol 1e-5 (XLA:CPU and ATen sum the same f32
products in other orders) and the greedy tokens are equal.

In bf16 the two differ by design in one place: the reference's jnp
``attention_decode`` rounds the softmax weights to bf16 before the value
product, and the port's decode attention -- the ``swa_decode`` kernel, like
the Pallas kernel -- keeps them in f32.  There the bound is
TestDecodeConsistency's (0.15) and greedy tokens must agree on >= 90% of
the steps.
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
from repro_torch.launch import serve_decode  # noqa: E402
from repro_torch.launch.steps import (make_prefill_step,  # noqa: E402
                                      make_serve_step)
from repro_torch.models import layers as pl_  # noqa: E402
from repro_torch.models import transformer as ptf  # noqa: E402
from repro_torch.weights import cache_from_jax, params_from_jax  # noqa: E402

RTOL = ATOL = 1e-5
BF16_TOL = 0.15
PROMPT, WINDOW, STEPS = 8, 16, 24


def port_arch(cfg, dtype) -> PArch:
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
          if f.name != "dtype"}
    return PArch(**kw, dtype=dtype)


J_F32 = dataclasses.replace(j_get_smoke("qwen2-1.5b"), dtype=jnp.float32)
P_F32 = port_arch(J_F32, torch.float32)
J_BF16 = j_get_smoke("qwen2-1.5b")
P_BF16 = port_arch(J_BF16, torch.bfloat16)


def _prompts(b, s, seed=0):
    return np.random.default_rng(seed).integers(
        0, J_F32.vocab_size, (b, s), dtype=np.int32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: its decode steps are thousands
    of tiny ops, and with the suite's workers sharing the cores OpenMP's
    barriers wait on descheduled threads.  Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def f32_params():
    jp = jtf.init_params(J_F32, jax.random.PRNGKey(0))
    return jp, params_from_jax(jax.device_get(jp))


@pytest.fixture(scope="module")
def bf16_params():
    jp = jtf.init_params(J_BF16, jax.random.PRNGKey(0))
    return jp, params_from_jax(jax.device_get(jp))


def _j_decode(cfg, window):
    @jax.jit
    def step(params, token, cache):
        logits, cache = jtf.decode_step(params, cfg, token, cache,
                                        window=window)
        return logits, jnp.argmax(logits, -1).astype(jnp.int32)[:, None], \
            cache
    return step


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to(torch.float32).numpy()


def _close(got, want, msg="", tol=RTOL):
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               rtol=tol, atol=tol, err_msg=msg)


def _assert_cache_close(p_cache, j_cache, tol=RTOL):
    assert p_cache["pos"] == int(j_cache["pos"])
    for name in ("k", "v"):
        _close(p_cache["kv"][name], j_cache["kv"][name], name, tol)


def _run_both(jp, pp, cache_len, window, steps, *, start_from_jax=False,
              prompt=PROMPT, b=2):
    """Prefill on both sides, then ``steps`` greedy steps on each; returns
    per-step logits and tokens of both and the final caches."""
    toks = _prompts(b, prompt)
    j_logits, j_cache = jtf.prefill(jp, J_F32, {"tokens": jnp.asarray(toks)},
                                    cache_len)
    p_logits, p_cache = make_prefill_step(P_F32, cache_len, device="cpu")(
        pp, {"tokens": torch.from_numpy(toks)})
    _close(p_logits, j_logits, "prefill logits")
    _assert_cache_close(p_cache, j_cache)
    if start_from_jax:
        p_cache = cache_from_jax(jax.device_get(j_cache))
    j_step = _j_decode(J_F32, window)
    p_step = make_serve_step(P_F32, window, device="cpu", return_logits=True)
    j_tok = jnp.argmax(j_logits, -1).astype(jnp.int32)[:, None]
    p_tok = torch.argmax(p_logits, -1).to(torch.int32)[:, None]
    for i in range(steps):
        j_l, j_tok, j_cache = j_step(jp, j_tok, j_cache)
        p_tok, p_cache, p_l = p_step(pp, p_tok, p_cache)
        _close(p_l, j_l, f"step {i} logits")
        np.testing.assert_array_equal(p_tok.numpy(), np.asarray(j_tok),
                                      err_msg=f"step {i} tokens")
    return p_cache, j_cache


class TestServeF32:
    def test_prefill_logits_and_cache(self, f32_params):
        jp, pp = f32_params
        toks = _prompts(2, 12, seed=4)
        for cache_len in (None, 8, 20):     # keeps 12 slots, keeps 12, pads
            j_logits, j_cache = jtf.prefill(
                jp, J_F32, {"tokens": jnp.asarray(toks)}, cache_len)
            p_logits, p_cache = make_prefill_step(
                P_F32, cache_len, device="cpu")(
                    pp, {"tokens": torch.from_numpy(toks)})
            _close(p_logits, j_logits, f"cache_len={cache_len}")
            _assert_cache_close(p_cache, j_cache)
            assert p_cache["kv"]["k"].shape == j_cache["kv"]["k"].shape

    def test_window_serve_steps_past_the_wrap(self, f32_params):
        """8-token prefill into a 16-slot ring, then 24 steps: positions
        8-31, wrapping at 16."""
        p_cache, j_cache = _run_both(*f32_params, cache_len=WINDOW,
                                     window=WINDOW, steps=STEPS)
        _assert_cache_close(p_cache, j_cache)
        assert p_cache["pos"] == PROMPT + STEPS

    def test_full_cache_without_window(self, f32_params):
        p_cache, j_cache = _run_both(*f32_params, cache_len=PROMPT + 12,
                                     window=0, steps=12)
        _assert_cache_close(p_cache, j_cache)

    def test_steps_past_the_cache_end_drop_the_write(self, f32_params):
        """window=0 and pos >= S: the reference's out-of-bounds ``.at[].set``
        writes nothing, and attention keeps reading the S slots."""
        p_cache, j_cache = _run_both(*f32_params, cache_len=PROMPT + 2,
                                     window=0, steps=6)
        _assert_cache_close(p_cache, j_cache)
        assert p_cache["pos"] == PROMPT + 6

    def test_decode_from_the_reference_prefill_cache(self, f32_params):
        p_cache, j_cache = _run_both(*f32_params, cache_len=WINDOW,
                                     window=WINDOW, steps=10,
                                     start_from_jax=True)
        _assert_cache_close(p_cache, j_cache)


class TestLayers:
    @pytest.mark.parametrize("window,pos", [(0, 3), (0, 7), (0, 8), (0, 11),
                                            (8, 3), (8, 8), (8, 19)])
    def test_cache_update(self, window, pos):
        rng = np.random.default_rng(pos)
        k0 = rng.standard_normal((2, 2, 8, 4)).astype(np.float32)
        v0 = rng.standard_normal((2, 2, 8, 4)).astype(np.float32)
        kn = rng.standard_normal((2, 1, 2, 4)).astype(np.float32)
        vn = rng.standard_normal((2, 1, 2, 4)).astype(np.float32)
        want = jl.cache_update(
            jl.KVCache(jnp.asarray(k0), jnp.asarray(v0), jnp.zeros(2, int)),
            jnp.asarray(kn), jnp.asarray(vn), jnp.full((2,), pos, jnp.int32),
            window)
        got = pl_.cache_update(
            pl_.KVCache(torch.from_numpy(k0.copy()),
                        torch.from_numpy(v0.copy()), None),
            torch.from_numpy(kn), torch.from_numpy(vn), pos, window)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert got.length.dtype == torch.int32

    def test_attention_decode_gqa(self):
        rng = np.random.default_rng(1)
        q = rng.standard_normal((3, 1, 4, 32)).astype(np.float32)
        k = rng.standard_normal((3, 2, 10, 32)).astype(np.float32)
        v = rng.standard_normal((3, 2, 10, 32)).astype(np.float32)
        ln = np.array([1, 6, 10], np.int32)
        want = jl.attention_decode(
            jnp.asarray(q), jl.KVCache(jnp.asarray(k), jnp.asarray(v),
                                       jnp.asarray(ln)), 4)
        got = pl_.attention_decode(
            torch.from_numpy(q), pl_.KVCache(torch.from_numpy(k),
                                             torch.from_numpy(v),
                                             torch.from_numpy(ln)), 4)
        _close(got, want)

    def test_cache_from_jax_keeps_layout_and_bf16_bits(self):
        cache = jtf.init_cache(J_BF16, 2, 6)
        cache["kv"]["k"] = jax.random.normal(
            jax.random.PRNGKey(2), cache["kv"]["k"].shape).astype(jnp.bfloat16)
        cache["pos"] = jnp.int32(5)
        got = cache_from_jax(jax.device_get(cache))
        assert got["pos"] == 5 and isinstance(got["pos"], int)
        k = got["kv"]["k"]
        assert k.dtype == torch.bfloat16 and k.shape == (2, 2, 2, 6, 64)
        np.testing.assert_array_equal(
            k.view(torch.int16).numpy(),
            np.asarray(cache["kv"]["k"]).view(np.int16))


def test_bf16_serve_within_decode_consistency_bound(bf16_params):
    """bf16 on both sides: the same token fed to both each step (the
    reference's greedy choice), so one differing argmax does not change
    the later inputs."""
    jp, pp = bf16_params
    toks = _prompts(2, PROMPT, seed=9)
    j_logits, j_cache = jtf.prefill(jp, J_BF16, {"tokens": jnp.asarray(toks)},
                                    WINDOW)
    p_logits, p_cache = make_prefill_step(P_BF16, WINDOW, device="cpu")(
        pp, {"tokens": torch.from_numpy(toks)})
    _close(p_logits, j_logits, "prefill", BF16_TOL)
    j_step = _j_decode(J_BF16, WINDOW)
    p_step = make_serve_step(P_BF16, WINDOW, device="cpu", return_logits=True)
    tok = jnp.argmax(j_logits, -1).astype(jnp.int32)[:, None]
    agree = []
    for i in range(STEPS):
        j_l, j_tok, j_cache = j_step(jp, tok, j_cache)
        p_tok, p_cache, p_l = p_step(pp, torch.from_numpy(np.array(tok)),
                                     p_cache)
        _close(p_l, j_l, f"step {i}", BF16_TOL)
        agree.append(np.asarray(j_tok) == p_tok.numpy())
        tok = j_tok
    assert np.mean(agree) >= 0.9
    assert p_cache["pos"] == PROMPT + STEPS


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, BF16_TOL),
                                       (torch.float32, 1e-4)])
def test_decode_matches_forward(dtype, tol):
    """Within the port: sequential decode from an empty cache matches the
    parallel forward position by position (the analogue of
    tests/test_models.py::TestDecodeConsistency for qwen2-smoke)."""
    cfg = dataclasses.replace(get_smoke_config("qwen2-1.5b"), dtype=dtype)
    params = ptf.init_params(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(_prompts(1, 12, seed=3)).long()
    with torch.inference_mode():
        hidden, _, _ = ptf.forward_hidden(params, cfg, toks)
        full = ptf.logits_fn(params, cfg, hidden)            # (1,S,V)
    cache = ptf.init_cache(cfg, 1, 12 + 4, device="cpu")
    step = make_serve_step(cfg, device="cpu", return_logits=True)
    outs = []
    for t in range(12):
        _, cache, logits = step(params, toks[:, t:t + 1], cache)
        outs.append(logits)
    dec = torch.stack(outs, 1)
    np.testing.assert_allclose(_np(dec), _np(full), rtol=tol, atol=tol)
    agree = np.mean(np.argmax(_np(dec), -1) == np.argmax(_np(full), -1))
    assert agree >= 0.9


def test_smoke_config_matches_reference():
    ours, theirs = get_smoke_config("qwen2-1.5b"), j_get_smoke("qwen2-1.5b")
    for f in dataclasses.fields(theirs):
        if f.name != "dtype":
            assert getattr(ours, f.name) == getattr(theirs, f.name), f.name
    assert ours.dtype == torch.bfloat16


def test_full_config_param_count_on_meta():
    cfg = get_config("qwen2-1.5b")
    params = ptf.init_params(cfg, device="meta")
    assert all(p.device.type == "meta" for p in params.values())
    assert ptf.param_count(cfg) == 1_543_910_912
    shapes = jax.eval_shape(lambda: jtf.init_params(
        j_get_config("qwen2-1.5b"), jax.random.PRNGKey(0)))
    assert sum(int(np.prod(x.shape))
               for x in jax.tree_util.tree_leaves(shapes)) == 1_543_910_912
    assert [tuple(p.shape) for p in params.values()] == \
        [tuple(x.shape) for x in jax.tree_util.tree_leaves(shapes)]


def test_serving_entry_points_never_fall_back_to_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ptf.init_cache(P_F32, 1, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_prefill_step(P_F32, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_serve_step(P_F32, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_decode.main(["--smoke", "--batch", "1", "--prompt", "4",
                           "--gen", "2"])
    # asked for explicitly, the CPU runs
    assert ptf.init_cache(P_F32, 1, 8, device="cpu")["kv"]["k"].device.type \
        == "cpu"
    out = serve_decode.main(["--smoke", "--batch", "2", "--prompt", "6",
                             "--gen", "5", "--window", "4", "--device",
                             "cpu"])
    assert out["device"] == "cpu" and out["card"] is None
    assert out["full"]["pos"] == 11 and not out["full"]["wrapped"]
    assert out["ring"]["pos"] == 11 and out["ring"]["wrapped"]
    assert out["full"]["logits_finite"] and out["ring"]["logits_finite"]
