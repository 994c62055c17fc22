"""The port's ``swa_decode`` module held against the JAX reference.

The same inputs, made with numpy from a seed, go through the Pallas kernel
(interpret mode, as tests/test_kernels.py::TestSWADecode runs it), the JAX
oracle ``repro.kernels.ref.swa_decode_ref`` and the port's wrapper.  On the
CPU the wrapper runs its plain version, ``repro_torch.kernels.ref.
swa_decode_ref``, which computes the Pallas kernel's function; the CUDA
kernel is held to that plain version on the card (tests/test_torch_cuda.py,
chip_smoke.py).

Tolerances: against the Pallas kernel 2e-5 in f32 (the two sum the same f32
products in another order) and 1e-2 in bf16 (one bf16 step of the output);
against the JAX oracle TestSWADecode's own, 2e-5 and 3e-2 (in bf16 the
oracle takes its logits in bf16 and rounds the softmax weights to bf16).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.swa_attention import swa_decode as j_swa_decode  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro_torch import kernels as pk  # noqa: E402
from repro_torch.kernels import ref as pref  # noqa: E402

SHAPES = [(2, 4, 512, 64), (1, 8, 1024, 128), (4, 2, 256, 32),   # (B,H,W,Dh)
          (2, 4, 384, 96)]                                        # Dh 96
# the Pallas kernel takes W in whole chunks; the oracle also whisper's
# cross-attention window of 1,500 encoder slots
ORACLE_SHAPES = SHAPES + [(2, 2, 1500, 64)]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL_PALLAS = {"float32": 2e-5, "bfloat16": 1e-2}
TOL_ORACLE = {"float32": 2e-5, "bfloat16": 3e-2}


def _inputs(b, h, kv, w, dh, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, dh)).astype(np.float32)
    k = rng.standard_normal((b, kv, w, dh)).astype(np.float32)
    v = rng.standard_normal((b, kv, w, dh)).astype(np.float32)
    ln = rng.integers(1, w + 1, b).astype(np.int32)
    return q, k, v, ln


def _both(arrays, dtype):
    """The same values on both sides: f32 numpy rounded to ``dtype`` by
    each framework (both round to nearest even)."""
    jdt, tdt = DTYPES[dtype]
    j = [jnp.asarray(a).astype(jdt) for a in arrays]
    t = [torch.from_numpy(a).to(tdt) for a in arrays]
    return j, t


def _port(q, k, v, ln) -> np.ndarray:
    out = pk.swa_decode(q, k, v, torch.from_numpy(ln))
    assert out.dtype == q.dtype and out.shape == q.shape
    return out.to(torch.float32).numpy()


def _jax_np(x) -> np.ndarray:
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES)
def test_matches_pallas_kernel(shape, dtype):
    b, h, w, dh = shape
    q, k, v, ln = _inputs(b, h, h, w, dh, seed=b * h)
    (jq, jk, jv), (tq, tk, tv) = _both((q, k, v), dtype)
    want = _jax_np(j_swa_decode(jq, jk, jv, jnp.asarray(ln), chunk=128))
    tol = TOL_PALLAS[dtype]
    np.testing.assert_allclose(_port(tq, tk, tv, ln), want, rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_gqa_matches_pallas_kernel_on_expanded_kv(dtype):
    """Kv < H: the port reads KV head h // (H // Kv) of the un-expanded
    cache; the Pallas kernel takes the cache expanded by ``_expand_kv``.
    W = 129 is not a multiple of any power-of-two chunk."""
    b, h, kv, w, dh = 3, 6, 2, 129, 64
    q, k, v, ln = _inputs(b, h, kv, w, dh, seed=11)
    (jq, jk, jv), (tq, tk, tv) = _both((q, k, v), dtype)

    def expand(x):   # (B,Kv,W,Dh) -> (B,H,W,Dh) through (B,W,Kv,Dh)
        return jnp.swapaxes(jl._expand_kv(jnp.swapaxes(x, 1, 2), h), 1, 2)
    want = _jax_np(j_swa_decode(jq, expand(jk), expand(jv), jnp.asarray(ln)))
    tol = TOL_PALLAS[dtype]
    np.testing.assert_allclose(_port(tq, tk, tv, ln), want, rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", ORACLE_SHAPES)
def test_matches_jax_oracle(shape, dtype):
    b, h, w, dh = shape
    q, k, v, ln = _inputs(b, h, h, w, dh, seed=100 + b * h)
    (jq, jk, jv), (tq, tk, tv) = _both((q, k, v), dtype)
    want = _jax_np(jref.swa_decode_ref(jq, jk, jv, jnp.asarray(ln)))
    tol = TOL_ORACLE[dtype]
    np.testing.assert_allclose(_port(tq, tk, tv, ln), want, rtol=tol,
                               atol=tol)


def test_short_length_ignores_tail():
    """Garbage beyond ``length`` must not influence the output (the case of
    tests/test_kernels.py::TestSWADecode::test_short_length_ignores_tail)."""
    b, h, w, dh = 1, 2, 256, 64
    q, k, v, _ = _inputs(b, h, h, w, dh, seed=7)
    ln = np.array([100], np.int32)
    out1 = _port(*map(torch.from_numpy, (q, k, v)), ln)
    k2, v2 = k.copy(), v.copy()
    k2[:, :, 100:] = 1e9
    v2[:, :, 100:] = -1e9
    out2 = _port(*map(torch.from_numpy, (q, k2, v2)), ln)
    np.testing.assert_allclose(out1, out2, rtol=1e-6)
    want = np.asarray(j_swa_decode(*map(jnp.asarray, (q, k2, v2)),
                                   jnp.asarray(ln), chunk=64))
    np.testing.assert_allclose(out2, want, rtol=2e-5, atol=2e-5)


def test_zero_length_gives_zeros():
    q, k, v, _ = _inputs(2, 4, 2, 32, 32, seed=3)
    ln = np.array([0, 5], np.int32)
    out = _port(*map(torch.from_numpy, (q, k, v)), ln)
    assert np.all(out[0] == 0.0) and np.all(np.isfinite(out))
    want = np.asarray(pref.swa_decode_ref(
        *map(torch.from_numpy, (q[1:], k[1:], v[1:])),
        torch.tensor([5], dtype=torch.int32)))
    np.testing.assert_array_equal(out[1:], want)


@pytest.mark.parametrize("case", ["dtype_mix", "length_dtype", "heads",
                                  "head_dim", "strided", "shape"])
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    q, k, v, ln = (torch.from_numpy(a) for a in _inputs(2, 4, 2, 16, 32, 5))
    if case == "dtype_mix":
        args, err = (q, k.to(torch.bfloat16), v, ln), TypeError
    elif case == "length_dtype":
        args, err = (q, k, v, ln.long()), TypeError
    elif case == "heads":
        args, err = (q[:, :3].contiguous(), k, v, ln), ValueError
    elif case == "head_dim":
        args, err = (q[..., :16].contiguous(), k[..., :16].contiguous(),
                     v[..., :16].contiguous(), ln), ValueError
    elif case == "strided":
        args, err = (q, k.transpose(2, 3).contiguous().transpose(2, 3), v,
                     ln), ValueError
    else:
        args, err = (q, k, v[:, :, :8].contiguous(), ln), ValueError
    with pytest.raises(err):
        pk.swa_decode(*args)
