"""The port's threefry PRNG held against live jax, in the same process.

``repro_torch.core.prng`` must give jax 0.9.0's bits (threefry
partitionable, 64-bit mode off): keys, ``fold_in``, ``split``, raw bits,
``stream_key``, ``uniform``, ``randint`` and ``truncated_normal`` bitwise.
``normal`` is bitwise except where XLA:CPU's ``erf_inv`` takes its f32
``sqrt`` (w >= 5, |normal| above about 2.93): XLA's sqrt is not correctly
rounded and the port's is, so there the two may differ by up to 2 ulp.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import scenario as jscn  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core import scenario as pscn  # noqa: E402

from _hypothesis_compat import given, settings, st  # noqa: E402

SEEDS = (0, 1, 42, 2 ** 31 - 1, 2 ** 32 + 5)
NORMAL_ULP = 2
# |normal| below this never reaches erf_inv's sqrt branch (w < 5)
NORMAL_BITWISE_BELOW = 2.9


def _kd(key) -> np.ndarray:
    return np.asarray(key).astype(np.int64)


def _ulp(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Distance in units in the last place of two f32 arrays."""
    def ordered(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(ordered(a) - ordered(b))


def _bitwise(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape
    if want.dtype == np.float32:
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    else:
        np.testing.assert_array_equal(got.astype(np.int64),
                                      want.astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key(seed):
    _bitwise(prng.PRNGKey(seed), _kd(jax.random.PRNGKey(seed)))


@settings(max_examples=25, deadline=None)
@given(st.integers(0, 2 ** 32 + 10), st.integers(0, 2 ** 32 - 1))
def test_fold_in(seed, data):
    _bitwise(prng.fold_in(prng.PRNGKey(seed), data),
             _kd(jax.random.fold_in(jax.random.PRNGKey(seed), data)))


@pytest.mark.parametrize("data", [0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 31 + 7,
                                  2 ** 32 - 1])
def test_fold_in_ids_at_and_above_2_31(data):
    for seed in SEEDS:
        _bitwise(prng.fold_in(prng.PRNGKey(seed), data),
                 _kd(jax.random.fold_in(jax.random.PRNGKey(seed), data)))


def test_fold_in_rejects_ids_outside_uint32():
    with pytest.raises(ValueError):
        prng.fold_in(prng.PRNGKey(0), -1)
    with pytest.raises(ValueError):
        prng.fold_in(prng.PRNGKey(0), 2 ** 32)


@pytest.mark.parametrize("num", [2, 3, 4])
def test_split(num):
    for seed in SEEDS:
        _bitwise(prng.split(prng.PRNGKey(seed), num),
                 _kd(jax.random.split(jax.random.PRNGKey(seed), num)))


@pytest.mark.parametrize("tag", range(11))
def test_stream_key_for_every_tag(tag):
    jb, pb = jax.random.PRNGKey(7), prng.PRNGKey(7)
    for ids in [(), (0,), (3, 2), (119, 7), (2 ** 31 + 1, 5)]:
        _bitwise(pscn.stream_key(pb, tag, *ids),
                 _kd(jscn.stream_key(jb, tag, *ids)))
    assert pscn.TAG_BATCH == jscn.TAG_BATCH == 0
    assert pscn.TAG_COHORT == jscn.TAG_COHORT == 10


@pytest.mark.parametrize("shape", [(1,), (7,), (3, 5)])
def test_random_bits(shape):
    for seed in SEEDS:
        _bitwise(prng.random_bits(prng.PRNGKey(seed), shape),
                 jax.random.bits(jax.random.PRNGKey(seed), shape))


@pytest.mark.parametrize("bounds", [(0.0, 1.0), (-0.99999994, 1.0),
                                    (-0.9544997, 0.9544997), (0.3, 7.1)])
def test_uniform(bounds):
    lo, hi = bounds
    for seed in SEEDS:
        want = jax.random.uniform(jax.random.PRNGKey(seed), (4099,),
                                  minval=lo, maxval=hi)
        _bitwise(prng.uniform(prng.PRNGKey(seed), (4099,), lo, hi), want)
    _bitwise(prng.uniform(prng.PRNGKey(3)),
             jax.random.uniform(jax.random.PRNGKey(3)))


@pytest.mark.parametrize("maxval", [1, 600, 3000, 70_000, 2 ** 24,
                                    2 ** 31 - 1])
def test_randint(maxval):
    """Spans above 2**16 make the multiplier's square and the offset wrap
    in uint32."""
    for seed in SEEDS:
        want = jax.random.randint(jax.random.PRNGKey(seed), (2048,), 0,
                                  maxval)
        _bitwise(prng.randint(prng.PRNGKey(seed), (2048,), 0, maxval), want)
    _bitwise(prng.randint(prng.PRNGKey(1), (9,), -5, 11),
             jax.random.randint(jax.random.PRNGKey(1), (9,), -5, 11))


@settings(max_examples=10, deadline=None)
@given(st.integers(0, 2 ** 31 - 1))
def test_normal_bitwise_below_the_tail_and_within_2_ulp(seed):
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (7840,)))
    got = prng.normal(prng.PRNGKey(seed), (7840,)).numpy()
    assert got.dtype == np.float32
    body = np.abs(want) < NORMAL_BITWISE_BELOW
    np.testing.assert_array_equal(got[body].view(np.int32),
                                  want[body].view(np.int32))
    assert _ulp(got, want).max() <= NORMAL_ULP


@pytest.mark.parametrize("dtype,std,shape", [
    (torch.float32, 0.02, (64, 96)), (torch.bfloat16, 768 ** -0.5, (3, 4097)),
    (torch.float32, 1.0, (1,))])
def test_threefry_normal_is_the_references_weight_draw(dtype, std, shape):
    """The weights' draw (``kernels.threefry_normal``; on the CPU its plain
    version) is the reference's ``(jax.random.normal(key, shape) * std)
    .astype(dtype)``: bitwise where |normal| < 2.9, within 2 ulp of the f32
    draw beyond."""
    from repro_torch.kernels import threefry_normal
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jkey = jax.random.split(jax.random.PRNGKey(3), 4)[2]
    z = np.asarray(jax.random.normal(jkey, shape))
    want = np.asarray((jax.random.normal(jkey, shape) * std).astype(jdt))
    out = torch.empty(shape, dtype=dtype)
    got = threefry_normal(out, prng.split(prng.PRNGKey(3), 4)[2], std)
    assert got is out
    bits = np.int32 if dtype == torch.float32 else np.int16
    got_b = got.view(torch.int32 if bits is np.int32 else torch.int16).numpy()
    body = np.abs(z) < NORMAL_BITWISE_BELOW
    np.testing.assert_array_equal(got_b[body], want.view(bits)[body])
    tail = got.float().numpy()[~body]
    np.testing.assert_allclose(tail, want.astype(np.float32)[~body],
                               rtol=2 ** -22 if bits is np.int32 else 2 ** -7)


def test_threefry_normal_rejects_what_it_cannot_fill():
    from repro_torch.kernels import threefry_normal
    key = prng.PRNGKey(0)
    with pytest.raises(TypeError):
        threefry_normal(torch.empty(4, dtype=torch.float16), key, 1.0)
    with pytest.raises(ValueError):
        threefry_normal(torch.empty((4, 4)).t(), key, 1.0)
    with pytest.raises(ValueError):
        threefry_normal(torch.empty(4), torch.zeros(3, dtype=torch.int64),
                        1.0)


@settings(max_examples=10, deadline=None)
@given(st.integers(0, 2 ** 31 - 1))
def test_truncated_normal_bitwise(seed):
    want = jax.random.truncated_normal(jax.random.PRNGKey(seed), -2.0, 2.0,
                                       (4099,))
    _bitwise(prng.truncated_normal(prng.PRNGKey(seed), -2.0, 2.0, (4099,)),
             want)


def test_erf_inv_and_fma_against_xla():
    """XLA's f32 erf_inv on a grid of u (bitwise below w = 5), and the
    exactly rounded fused multiply-add against float64 references."""
    u = np.linspace(-0.996, 0.996, 20001, dtype=np.float32)
    want = np.asarray(jax.jit(jax.lax.erf_inv)(jnp.asarray(u)))
    got = prng.erf_inv(torch.from_numpy(u)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    rng = np.random.default_rng(0)
    a, b, c = (rng.standard_normal(10000).astype(np.float32)
               for _ in range(3))
    exact = a.astype(np.float64) * b + c            # one f64 rounding
    got = prng.fma32(*(torch.from_numpy(v) for v in (a, b, c))).numpy()
    assert _ulp(got, exact.astype(np.float32)).max() <= 1
    # a*b + c just below an f32 midpoint, whose f64 sum rounds onto the
    # midpoint: a double rounding would go up, one rounding stays
    a = np.array([2 ** -12 * (1 + 2 ** -18)], np.float32)
    b = np.array([2 ** -12 * (1 - 2 ** -18)], np.float32)
    c = np.array([1 + 2 ** -23], np.float32)       # exact: c + 2**-24 - 2**-60
    got = prng.fma32(*(torch.from_numpy(v) for v in (a, b, c))).numpy()
    assert got[0] == np.float32(1 + 2 ** -23)
    naive = (a.astype(np.float64) * b + c).astype(np.float32)
    assert naive[0] == np.float32(1 + 2 ** -22)


# ---------------------------------------------------------------------------
# rows: the batched engine's keys and draws, one tensor pass for all devices
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tag", [0, 1, 4])
def test_stream_keys_of_rounds_and_devices_match_jax(tag):
    """(L, M, 2) keys in two tensor passes equal L x M calls of the scalar
    ``stream_key`` and jax's, device ids at and above 2**31 included."""
    jb, pb = jax.random.PRNGKey(11), prng.PRNGKey(11)
    ts = [0, 5, 119, 2 ** 31 + 3]
    ids = [0, 1, 7, 2 ** 31 + 1]
    got = pscn.stream_keys(pb, tag, torch.tensor(ts), torch.tensor(ids))
    assert got.shape == (len(ts), len(ids), 2)
    want = jax.vmap(lambda t: jax.vmap(
        lambda m: jscn.stream_key(jb, tag, t, m))(jnp.asarray(ids, jnp.uint32))
    )(jnp.asarray(ts, jnp.uint32))
    _bitwise(got, _kd(want))
    for i, t in enumerate(ts):
        for j, m in enumerate(ids):
            assert torch.equal(got[i, j], pscn.stream_key(pb, tag, t, m))


def test_randint_rows_match_jax_per_row():
    """Per-row bounds (the devices' shard sizes), spans above 2**16
    included: row r equals ``randint(keys[r], (n,), 0, maxval[r])``."""
    base = prng.PRNGKey(5)
    keys = pscn.stream_keys(base, 0, torch.tensor([3]),
                            torch.arange(6))[0]
    maxval = [1, 400, 3000, 70_000, 2 ** 24 + 1, 2 ** 31 - 1]
    got = prng.randint_rows(keys, 257, torch.tensor(maxval))
    jkeys = jax.vmap(lambda m: jscn.stream_key(jax.random.PRNGKey(5), 0, 3,
                                               m))(jnp.arange(6))
    for r, mx in enumerate(maxval):
        want = jax.random.randint(jkeys[r], (257,), 0, mx)
        _bitwise(got[r], want)
        assert torch.equal(got[r], prng.randint(keys[r], (257,), 0, mx))


def test_row_samplers_and_a_draw_in_pieces_are_bitwise():
    """uniform / normal rows equal one call per key, and ``normal`` drawn
    ``NORMAL_PIECE`` elements at a time gives the bits of one piece."""
    keys = prng.split(prng.PRNGKey(9), 4)
    u = prng.uniform_rows(keys, 1000, -0.99999994, 1.0)
    n = prng.normal_rows(keys, 1000)
    for r in range(4):
        want_u = jax.random.uniform(jax.random.wrap_key_data(
            jnp.asarray(keys[r].numpy(), jnp.uint32)), (1000,),
            minval=-0.99999994, maxval=1.0)
        _bitwise(u[r], want_u)
        assert torch.equal(n[r].view(torch.int32),
                           prng.normal(keys[r], (1000,)).view(torch.int32))
    whole = prng.normal(keys[0], (3, 1001))
    old = prng.NORMAL_PIECE
    try:
        prng.NORMAL_PIECE = 1000
        pieces = prng.normal(keys[0], (3, 1001))
    finally:
        prng.NORMAL_PIECE = old
    assert torch.equal(whole.view(torch.int32), pieces.view(torch.int32))


@pytest.mark.parametrize("scale", [0.3, 3.0, 30.0])
def test_xla_exp_is_bitwise_xla_cpus(scale):
    """XLA:CPU's f32 exp is not correctly rounded; ``prng.xla_exp`` is it,
    bit for bit where the result is a normal float (|x| <= 87; the
    channels' lognormal bandwidth, the carry's)."""
    x = np.clip(np.random.default_rng(int(scale * 10)).normal(size=100_000)
                * scale, -87, 87).astype(np.float32)
    x = np.concatenate([x, np.array([0.0, -0.0, 87.0, -87.0, 1e-30],
                                    np.float32)])
    got = prng.xla_exp(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.jit(jnp.exp)(x))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
