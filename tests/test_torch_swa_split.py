"""The split-W partition of the port's ``swa_decode`` kernel, on the CPU.

The CUDA kernel cuts the window into S splits of whole 64-slot tiles, keeps
an f32 (max, denominator, accumulator) state per split and merges the states
in split order.  ``ref.swa_decode_split_ref`` computes the same partition
and merge in plain torch; here it is held to the unsplit plain version
``ref.swa_decode_ref`` and to the JAX Pallas kernel (interpret mode, on a
GQA-expanded cache), with inputs made by numpy from a seed.  The kernel is
held to the plain version on the card (tests/test_torch_cuda.py).

Tolerances: f32 rtol = atol = 2e-5 (the same f32 products summed in another
order), bf16 1e-2 (one bf16 step of the output).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.swa_attention import swa_decode as j_swa_decode  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro_torch.kernels import ref as pref  # noqa: E402
from repro_torch.kernels.swa_attention import (  # noqa: E402
    _MAX_SPLITS, _num_splits)

T = pref.SWA_TILE
TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}
SPLITS = (1, 2, 7, 16, 80)      # 80 > ceil(W / T) for both windows
WINDOWS = {100: 64, 4160: 32}   # W -> Dh
REPS = (1, 2, 6, 7, 8, 9, 16)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: with the suite's workers
    sharing the cores, OpenMP's barriers wait on descheduled threads.
    Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lengths(w: int) -> list[int]:
    return [0, 1, T - 1, T + 1, w]


def _inputs(w: int, rep: int, dtype, seed: int):
    """One batch row per length of ``_lengths(w)``; Kv = 2."""
    dh, kv = WINDOWS[w], 2
    b = len(_lengths(w))
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in ((b, kv * rep, dh), (b, kv, w, dh), (b, kv, w, dh))]
    ln = np.array(_lengths(w), np.int32)
    return [torch.from_numpy(a).to(dtype) for a in arrays], ln


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rep", REPS)
@pytest.mark.parametrize("w", list(WINDOWS))
def test_split_merge_matches_unsplit_plain_version(w, rep, dtype):
    (q, k, v), ln = _inputs(w, rep, dtype, seed=w + rep)
    length = torch.from_numpy(ln)
    want = pref.swa_decode_ref(q, k, v, length).float()
    tol = TOL[dtype]
    for s in SPLITS:
        got = pref.swa_decode_split_ref(q, k, v, length, s)
        assert got.dtype == dtype and got.shape == q.shape
        torch.testing.assert_close(got.float(), want, rtol=tol, atol=tol,
                                   msg=lambda m: f"S={s}: {m}")
        assert torch.equal(got[0], torch.zeros_like(got[0]))   # length 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rep", (1, 6, 7, 9, 16))
@pytest.mark.parametrize("w", list(WINDOWS))
def test_split_merge_matches_pallas_kernel(w, rep, dtype):
    (q, k, v), ln = _inputs(w, rep, dtype, seed=7 * w + rep)
    h = q.shape[1]
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jq, jk, jv = (jnp.asarray(t.float().numpy()).astype(jdt)
                  for t in (q, k, v))

    def expand(x):   # (B,Kv,W,Dh) -> (B,H,W,Dh) through (B,W,Kv,Dh)
        return jnp.swapaxes(jl._expand_kv(jnp.swapaxes(x, 1, 2), h), 1, 2)
    want = np.asarray(j_swa_decode(jq, expand(jk), expand(jv),
                                   jnp.asarray(ln), chunk=w
                                   ).astype(jnp.float32))
    tol = TOL[dtype]
    for s in SPLITS:
        got = pref.swa_decode_split_ref(q, k, v, torch.from_numpy(ln), s)
        np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                                   atol=tol, err_msg=f"S={s}")


@pytest.mark.parametrize("w", [1, 16, 63, 64, 65, 100, 4096, 4160, 500_000])
@pytest.mark.parametrize("groups", [1, 2, 16, 24, 131, 132, 1000])
def test_num_splits_fills_the_card_in_whole_tiles(groups, w):
    sms = 132
    s = _num_splits(groups, w, sms)
    tiles = -(-w // T)
    length = pref.swa_split_len(w, s)
    assert 1 <= s <= min(tiles, _MAX_SPLITS)
    assert length % T == 0 and s * length >= w      # whole tiles cover W
    assert (s - 1) * length < w                     # no split past W
    # about a block per SM, unless W or the cap on splits stops it
    assert 2 * groups * s >= sms or s == tiles or 2 * s > _MAX_SPLITS
    assert groups * s <= 2 * sms or s == 1          # and not many times over


def test_serve_shape_gets_128_blocks():
    """B=8, Kv=2 at W=4096: 16 groups of 6 query heads, 8 splits of 512
    slots; B=1: 2 groups, 64 splits of one tile."""
    assert _num_splits(8 * 2, 4096) == 8
    assert _num_splits(1 * 2, 4096) == 64
