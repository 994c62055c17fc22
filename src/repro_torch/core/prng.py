"""Counter-based randomness: ``jax.random``'s threefry2x32, bit for bit.

Port of the parts of ``jax.random`` the simulator calls, as jax 0.9.0
computes them with ``jax_threefry_partitionable=True`` and 64-bit mode off
(``jax/_src/prng.py``, ``jax/_src/random.py``):

* a key is two uint32 words, held here as an int64 tensor of shape (2,);
  ``PRNGKey(seed)`` is ``(0, seed mod 2**32)`` -- without 64-bit mode jax
  converts the seed to int32 first, so the high word is always 0;
* ``fold_in(key, d)`` hashes the counter pair ``(0, d)``; ``split(key, n)``
  hashes ``(hi(i), lo(i))`` of a 64-bit iota, key i being the pair of
  output words; raw 32-bit bits are ``bits1 ^ bits2`` of the same iota;
* ``uniform``, ``randint``, ``normal`` and ``truncated_normal`` follow
  ``random.py`` step by step, in uint32 arithmetic that wraps where jax's
  does.

torch has no full uint32 arithmetic, so every word lives in an int64 and is
masked with ``& 0xFFFFFFFF`` after each add, shift and multiply; the hash
is written once over Python ints and tensors alike.  Keys are derived with
Python ints when they lie on the CPU (about 10 us a hash) and with tensor
ops on the card; bits are tensor ops on the device asked for.  Integer
arithmetic is exact on both, so the CPU and the card give the same bits.

``normal`` goes through XLA:CPU's f32 ``erf_inv`` (Giles' polynomial over
``log1p``), reproduced here with the same operations in the same order:
XLA contracts each multiply-add of its polynomials into a fused
multiply-add, which :func:`fma32` computes exactly, and evaluates ``log``
by the Cephes polynomial of its CPU backend.  ``erf_inv`` takes a f32
``sqrt`` where w >= 5 (|normal| above about 2.93); the port's
(:func:`sqrt_f32`, the same on the CPU and the card, where the f32
``torch.sqrt`` is not correctly rounded) is correctly rounded.  So is
XLA:CPU's on the hosts this was checked on, where ``normal`` is bitwise
equal to jax's on millions of draws; a host whose XLA:CPU ``sqrt`` is not
correctly rounded leaves ``normal`` within 2 ulp of jax's there, which is
the tolerance tests/test_torch_prng.py allows above 2.9.  Raw bits, keys,
``uniform``, ``randint`` and ``truncated_normal`` (|u| <= erf(sqrt 2),
w < 2.5) are bitwise equal to jax's on every host.

The ``*_rows`` forms draw one row per key of a (K, 2) key tensor in a few
tensor passes (the batched engine's keys of all devices at once); row r is
bitwise the single-key draw with ``keys[r]``.

Sampling without replacement (the population's cohorts): ``permutation``
is jax's ``_shuffle`` (rounds of a stable sort of the arange by fresh
32-bit keys), ``choice`` its uniform and Gumbel-top-k forms, ``gumbel``
the "low" mode under XLA:CPU's ``log``, and ``xla_sum`` XLA:CPU's f32
``jnp.sum`` order (windows of 32 summed in turn, tree-reduction style), so
the cohort ids are jax's bit for bit (tests/test_torch_population.py).
``xla_sum_squares`` extends that order to the sum of squares of an array
of any rank (the optimizers' global norm, tests/test_torch_train.py).
"""
from __future__ import annotations

import math
from typing import Sequence

import torch

from repro_torch.kernels.ref import ftz

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_F32 = torch.float32


# ---------------------------------------------------------------------------
# the block function and key derivation
# ---------------------------------------------------------------------------

def _rotl(v, r: int):
    return ((v << r) | (v >> (32 - r))) & MASK


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds (``prng.py:_threefry2x32_lowering``).

    Works on Python ints and on int64 tensors holding uint32 values alike
    (tensors broadcast).  Returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def PRNGKey(seed: int, device: str | torch.device = "cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` (64-bit mode off): ``(0, seed mod 2**32)``."""
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64,
                        device=device)


def _hash_counters(key: torch.Tensor, x0: Sequence[int], x1: Sequence[int]
                   ) -> torch.Tensor:
    """Keys ``threefry2x32(key, (x0[i], x1[i]))`` as an (n, 2) tensor on the
    key's device."""
    if key.device.type == "cpu":
        k0, k1 = key.tolist()
        return torch.tensor([threefry2x32(k0, k1, a, b)
                             for a, b in zip(x0, x1)], dtype=torch.int64)
    c0 = torch.tensor(list(x0), dtype=torch.int64, device=key.device)
    c1 = torch.tensor(list(x1), dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(key[0], key[1], c0, c1)
    return torch.stack([y0, y1], -1)


def _uint32(d) -> int:
    d = int(d)
    if not 0 <= d <= MASK:
        raise ValueError(f"fold_in data must be a uint32, got {d}")
    return d


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: the hash of the counter pair ``(0, data)``."""
    return _hash_counters(key, [0], [_uint32(data)])[0]


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` (foldlike): (num, 2) keys over a 64-bit iota."""
    return _hash_counters(key, [i >> 32 for i in range(num)],
                          [i & MASK for i in range(num)])


def _bits_range(key: torch.Tensor, lo: int, hi: int, device) -> torch.Tensor:
    """Bits of elements [lo, hi) of a draw: each element hashes its own
    index, so a draw can be made in pieces with the same bits."""
    i = torch.arange(lo, hi, dtype=torch.int64, device=device)
    k = key.to(device)
    y0, y1 = threefry2x32(k[0], k[1], i >> 32, i & MASK)
    return y0 ^ y1


def random_bits(key: torch.Tensor, shape: Sequence[int] = (),
                device: str | torch.device | None = None) -> torch.Tensor:
    """32 random bits per element (``bits1 ^ bits2`` over a 64-bit iota), as
    an int64 tensor of uint32 values on ``device`` (default: the key's)."""
    dev = key.device if device is None else torch.device(device)
    return _bits_range(key, 0, math.prod(shape), dev).reshape(tuple(shape))


# ---------------------------------------------------------------------------
# rows: one draw per key of a (K, 2) key tensor, in one tensor pass
# ---------------------------------------------------------------------------

def fold_in_rows(keys: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """``fold_in`` of every key of ``keys`` (..., 2) with every counter of
    ``data`` (a tensor of uint32 values on the keys' device), broadcast:
    keys (..., 2) and data (...) give (..., 2)."""
    d = data.to(torch.int64)
    y0, y1 = threefry2x32(keys[..., 0], keys[..., 1], torch.zeros_like(d), d)
    return torch.stack([y0, y1], -1)


def split_rows(keys: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``split`` of each key of ``keys`` (K, 2): (K, num, 2)."""
    i = torch.arange(num, dtype=torch.int64, device=keys.device)
    y0, y1 = threefry2x32(keys[:, None, 0], keys[:, None, 1], i >> 32,
                          i & MASK)
    return torch.stack([y0, y1], -1)


def random_bits_rows(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``random_bits(keys[r], (n,))`` for every row r of ``keys`` (K, 2):
    (K, n) on the keys' device."""
    i = torch.arange(n, dtype=torch.int64, device=keys.device)
    y0, y1 = threefry2x32(keys[:, None, 0], keys[:, None, 1], i >> 32,
                          i & MASK)
    return y0 ^ y1


# ---------------------------------------------------------------------------
# samplers
# ---------------------------------------------------------------------------

def _f32(v, device) -> torch.Tensor:
    """An f32 scalar made on ``device`` by a fill, not a copy: no host sync."""
    return torch.full((), v, dtype=_F32, device=device)


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """f32 ``a * b + c`` rounded once, as a fused multiply-add.

    The f64 product of two f32 values is exact; :func:`add_f32` then rounds
    its sum with ``c`` once to f32."""
    return add_f32(a.double() * b.double(), c)


def add_f32(p: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """f32 ``p + c`` rounded once, for an f64 ``p`` with at most 48
    significant bits (an exact product of two f32 values) and an f32 ``c``.

    The f64 sum is made round-to-odd (an inexact sum with an even last bit
    moves one ulp toward the exact value), after which rounding to f32 is
    the single rounding of the exact result."""
    cd = c.double()
    s = p + cd
    t = s - p
    err = (p - (s - t)) + (cd - t)                  # s + err == p + cd exactly
    even = (s.view(torch.int64) & 1) == 0
    away = torch.copysign(torch.full_like(s, math.inf), err)
    s = torch.where((err != 0) & even, torch.nextafter(s, away), s)
    return s.to(_F32)


def sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root on every device: taken in f64
    and rounded once more (exact, 53 >= 2 * 24 + 2 bits).  The card's f32
    ``torch.sqrt`` is not correctly rounded: it made the card's ``normal``
    differ from the CPU's (chip_smoke.py's PRNG phase) before this."""
    return torch.sqrt(x.double()).to(_F32)


def _uniform_from_bits(bits: torch.Tensor, minval, maxval) -> torch.Tensor:
    """``jax.random.uniform`` in f32 from its bits: 23 random mantissa bits
    under the exponent of 1 give floats in [0, 1), then ``max(min, floats *
    (max - min) + min)`` with the multiply-add fused, as XLA:CPU fuses it
    (``random.py:_uniform``)."""
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(_F32) - 1.0
    lo = _f32(minval, floats.device)
    hi = _f32(maxval, floats.device)
    span = (hi - lo).expand_as(floats)
    out = fma32(floats, span, lo.expand_as(floats))
    return torch.maximum(lo, out)


def uniform(key: torch.Tensor, shape: Sequence[int] = (), minval=0.0,
            maxval=1.0, device: str | torch.device | None = None
            ) -> torch.Tensor:
    """``jax.random.uniform`` in f32 (``random.py:_uniform``)."""
    return _uniform_from_bits(random_bits(key, shape, device), minval, maxval)


def uniform_rows(keys: torch.Tensor, n: int, minval=0.0, maxval=1.0
                 ) -> torch.Tensor:
    """``uniform(keys[r], (n,))`` for every row of ``keys`` (K, 2): (K, n)."""
    return _uniform_from_bits(random_bits_rows(keys, n), minval, maxval)


def randint(key: torch.Tensor, shape: Sequence[int], minval: int, maxval: int,
            device: str | torch.device | None = None) -> torch.Tensor:
    """``jax.random.randint`` for int32 bounds, as an int64 tensor.

    Two keys give the higher and lower 32 bits; the offset
    ``(hi % span) * multiplier + lo % span`` is taken in uint32 and wraps
    there, where ``multiplier = (2**16 % span)**2 % span`` (its square
    wraps too, for spans above 2**16)."""
    lo_i, hi_i = (max(-2 ** 31, min(int(v), 2 ** 31 - 1))
                  for v in (minval, maxval))
    span = (hi_i - lo_i) & MASK if hi_i > lo_i else 1
    mult = (2 ** 16) % span
    mult = ((mult * mult) & MASK) % span
    k1, k2 = split(key, 2)
    higher = random_bits(k1, shape, device)
    lower = random_bits(k2, shape, device)
    off = ((higher % span) * mult) & MASK
    off = ((off + lower % span) & MASK) % span
    return off + lo_i


def randint_rows(keys: torch.Tensor, n: int, maxval: torch.Tensor
                 ) -> torch.Tensor:
    """``randint(keys[r], (n,), 0, maxval[r])`` for every row of ``keys``
    (K, 2), with a per-row bound ``maxval`` (K,) of positive int32 values
    on the keys' device: (K, n) int64, bitwise equal to K calls of
    :func:`randint`, in a few tensor passes and no host sync."""
    span = maxval.to(torch.int64)[:, None]
    mult = (2 ** 16) % span
    mult = ((mult * mult) & MASK) % span
    ks = split_rows(keys, 2)                                   # (K, 2, 2)
    i = torch.arange(n, dtype=torch.int64, device=keys.device)
    y0, y1 = threefry2x32(ks[:, :, None, 0], ks[:, :, None, 1], i >> 32,
                          i & MASK)
    bits = y0 ^ y1                                             # (K, 2, n)
    off = ((bits[:, 0] % span) * mult) & MASK
    return ((off + bits[:, 1] % span) & MASK) % span


# XLA:CPU's f32 log1p: a Cephes rational function below sqrt(2) - 1, the
# Cephes log of 1 + x above (xla/service/elemental_ir_emitter.cc EmitLog1p,
# xla/service/cpu polynomial log), every multiply-add fused
_LOG1P_DEN = (1., 1.5062909083469192043167E1, 8.3047565967967209469434E1,
              2.2176239823732856465394E2, 3.0909872225312059774938E2,
              2.1642788614495947685003E2, 6.0118660497603843919306E1)
_LOG1P_NUM = (4.5270000862445199635215E-5, 4.9854102823193375972212E-1,
              6.5787325942061044846969E0, 2.9911919328553073277375E1,
              6.0949667980987787057556E1, 5.7112963590585538103336E1,
              2.0039553499201281259648E1)
_LOG_P = (7.0376836292E-2, -1.1514610310E-1, 1.1676998740E-1,
          -1.2420140846E-1, 1.4249322787E-1, -1.6668057665E-1,
          2.0000714765E-1, -2.4999993993E-1, 3.3333331174E-1)
_LOG_Q1, _LOG_Q2 = -2.12194440e-4, 0.693359375
_MIN_NORMAL = 1.1754943508222875e-38


def _horner(x: torch.Tensor, coeffs) -> torch.Tensor:
    r = torch.full_like(x, coeffs[0])
    for c in coeffs[1:]:
        r = fma32(r, x, torch.full_like(x, c))
    return r


def _xla_log(x: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's f32 log (the Cephes polynomial on the mantissa)."""
    def k(v):
        return torch.full_like(x, v)
    t = torch.maximum(x, k(_MIN_NORMAL))
    bits = t.view(torch.int32)
    e = (bits >> 23) - 0x7F
    frac = ((bits & ~0x7F800000) | 0x3F000000).view(_F32)
    e = 1.0 + e.to(_F32)
    small = frac < 0.707106781186547524
    t = frac - 1.0
    e = e - torch.where(small, k(1.0), k(0.0))
    t = t + torch.where(small, frac, k(0.0))
    x2 = t * t
    x3 = x2 * t
    y = fma32(t, k(_LOG_P[0]), k(_LOG_P[1]))
    y1 = fma32(t, k(_LOG_P[3]), k(_LOG_P[4]))
    y2 = fma32(t, k(_LOG_P[6]), k(_LOG_P[7]))
    y = fma32(y, t, k(_LOG_P[2]))
    y1 = fma32(y1, t, k(_LOG_P[5]))
    y2 = fma32(y2, t, k(_LOG_P[8]))
    y = fma32(y, x3, y1)
    y = fma32(y, x3, y2)
    y = fma32(y, x3, _LOG_Q1 * e)
    t = fma32(k(-0.5), x2, t)
    t = t + y
    t = t + _LOG_Q2 * e
    t = torch.where(x == 0, k(-math.inf), t)
    t = torch.where(x == math.inf, k(math.inf), t)
    return torch.where(x < 0, k(math.nan), t)


# XLA:CPU's f32 exp: Cephes' expf with every multiply-add fused (x = n ln 2
# + r in two fused steps, a degree-5 polynomial in r, times 2^n)
_EXP_P = (1.9875691500E-4, 1.3981999507E-3, 8.3334519073E-3,
          4.1665795894E-2, 1.6666665459E-1, 5.0000001201E-1)
_EXP_CLAMP = 88.3762626647950


def xla_exp(x: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's f32 ``exp``, which is not correctly rounded (about one
    value in ten differs from ATen's by an ulp); bitwise XLA's where the
    result is a normal float (|x| <= 87), as every input here is."""
    def k(v):
        return torch.full_like(x, v)
    xc = torch.clamp(x, -_EXP_CLAMP, _EXP_CLAMP)
    fx = torch.floor(fma32(xc, k(1.44269504088896341), k(0.5)))
    r = fma32(fx, k(-0.693359375), xc)
    r = fma32(fx, k(2.12194440e-4), r)
    y = _horner(r, _EXP_P)
    y = fma32(y, r * r, r) + 1.0
    return y * ((fx.to(torch.int32) + 127) << 23).view(_F32)


def _xla_log1p(x: torch.Tensor) -> torch.Tensor:
    x2 = x * x
    small = x * x2 * (_horner(x, _LOG1P_NUM) / _horner(x, _LOG1P_DEN))
    small = x + fma32(torch.full_like(x, -0.5), x2, small)
    return torch.where(x.abs() < 0.41421356237309504880, small,
                       _xla_log(x + 1.0))


_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ``erf_inv`` (Giles): w = -log1p(-x*x); a degree-8
    polynomial in w - 2.5 (w < 5) or sqrt(w) - 3; times x; +-inf at +-1."""
    w = -_xla_log1p(x * -x)
    lt = w < 5.0
    ww = torch.where(lt, w - 2.5, sqrt_f32(w) - 3.0)

    def coeff(i):
        return torch.where(lt, torch.full_like(x, _ERFINV_LT5[i]),
                           torch.full_like(x, _ERFINV_GE5[i]))
    p = coeff(0)
    for i in range(1, 9):
        p = fma32(p, ww, coeff(i))
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


_SQRT2 = 1.4142135381698608        # f32(sqrt(2))
_NORMAL_LO = -0.99999994039535522  # nextafter(f32(-1), 0)


#: elements a ``normal`` draw computes at a time: its float64 temporaries
#: for a full-width weight would otherwise take tens of GB
NORMAL_PIECE = 1 << 22


def normal(key: torch.Tensor, shape: Sequence[int] = (),
           device: str | torch.device | None = None) -> torch.Tensor:
    """``jax.random.normal`` in f32: ``sqrt(2) * erf_inv(u)``, u uniform on
    [nextafter(-1, 0), 1).  Drawn ``NORMAL_PIECE`` elements at a time (the
    same bits: each element hashes its own index)."""
    dev = key.device if device is None else torch.device(device)
    n = math.prod(shape)
    out = torch.empty(n, dtype=_F32, device=dev)
    for lo in range(0, n, NORMAL_PIECE):
        hi = min(n, lo + NORMAL_PIECE)
        u = _uniform_from_bits(_bits_range(key, lo, hi, dev), _NORMAL_LO,
                               1.0)
        out[lo:hi] = _SQRT2 * erf_inv(u)
    return out.reshape(tuple(shape))


def normal_rows(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``normal(keys[r], (n,))`` for every row of ``keys`` (K, 2): (K, n)."""
    return _SQRT2 * erf_inv(uniform_rows(keys, n, _NORMAL_LO, 1.0))


def _f32_round(v: float) -> float:
    return float(torch.tensor(v, dtype=_F32))


def truncated_normal(key: torch.Tensor, lower: float, upper: float,
                     shape: Sequence[int] = (),
                     device: str | torch.device | None = None
                     ) -> torch.Tensor:
    """``jax.random.truncated_normal`` in f32 (``random.py:_truncated_normal``):
    u uniform on [erf(lower / sqrt 2), erf(upper / sqrt 2)), sqrt(2) *
    erf_inv(u), clipped into the open interval.  The two erf values are
    constants, taken in f64 from the f32 quotients and rounded to f32 (equal
    to XLA's f32 erf at the bounds the models use; tests/test_torch_prng.py)."""
    lo32, hi32 = _f32_round(lower), _f32_round(upper)
    a = _f32_round(math.erf(_f32_round(lo32 / _SQRT2)))
    b = _f32_round(math.erf(_f32_round(hi32 / _SQRT2)))
    u = uniform(key, shape, a, b, device)
    out = _SQRT2 * erf_inv(u)
    lo_t = torch.nextafter(_f32(lo32, out.device), _f32(math.inf, out.device))
    hi_t = torch.nextafter(_f32(hi32, out.device), _f32(-math.inf, out.device))
    return torch.clamp(out, lo_t, hi_t)


# ---------------------------------------------------------------------------
# sampling without replacement
# ---------------------------------------------------------------------------

_F32_TINY = 1.1754943508222875e-38      # finfo(float32).tiny
_UINT32_MAX = 2 ** 32 - 1
_XLA_WINDOW = 32                        # XLA:CPU's tree-reduction window


def shuffle_rounds(n: int) -> int:
    """jax's static round count of ``_shuffle``: ceil(3 ln n / ln(2**32 - 1))
    (1 round up to n = 1,625, 2 at n = 100,000)."""
    return int(math.ceil(3 * math.log(max(1, n)) / math.log(_UINT32_MAX)))


def permutation(key: torch.Tensor, n: int,
                device: str | torch.device | None = None) -> torch.Tensor:
    """``jax.random.permutation(key, n)``: the arange of n (int64) sorted
    :func:`shuffle_rounds` times, each time by 32 fresh random bits of a
    split key, stably (``lax.sort_key_val``): tied bits keep the order of
    the round before."""
    dev = key.device if device is None else torch.device(device)
    x = torch.arange(n, dtype=torch.int64, device=dev)
    for _ in range(shuffle_rounds(n)):
        key, sub = split(key)
        bits = random_bits(sub, (n,), dev)
        x = x[torch.sort(bits, stable=True).indices]
    return x


def gumbel(key: torch.Tensor, shape: Sequence[int] = (),
           device: str | torch.device | None = None) -> torch.Tensor:
    """``jax.random.gumbel`` in f32, mode "low" (jax's default):
    ``-log(-log(u))``, u uniform on [tiny, 1), XLA:CPU's ``log``."""
    u = uniform(key, shape, _F32_TINY, 1.0, device)
    return -_xla_log(-_xla_log(u))


def xla_sum(x: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's f32 ``jnp.sum`` of a vector: while more than 32 elements
    remain, zero-pad them evenly (the extra one after) to whole windows of
    32 and sum each window in turn; then sum the last <= 32 in turn.  Every
    add flushed, as XLA:CPU adds."""
    x = ftz(x.to(_F32).reshape(-1))
    while x.numel() > _XLA_WINDOW:
        out = -(-x.numel() // _XLA_WINDOW)
        pad = out * _XLA_WINDOW - x.numel()
        x = torch.nn.functional.pad(x, (pad // 2, pad - pad // 2))
        x = x.reshape(out, _XLA_WINDOW)
        acc = torch.zeros(out, dtype=_F32, device=x.device)
        for j in range(_XLA_WINDOW):
            acc = ftz(acc + x[:, j])
        x = acc
    acc = torch.zeros((), dtype=_F32, device=x.device)
    for j in range(x.numel()):
        acc = ftz(acc + x[j])
    return acc


# XLA:CPU's order for a full f32 reduce of an N-d array (jax 0.9.0, x86-64,
# read off the optimized LLVM IR of jitted ``jnp.sum``).  The tree-reduction
# rewriter turns the reduce into ``reduce-window`` passes while a dim
# exceeds 32: each such dim gets windows of 32, zero-padded evenly (the
# extra one after), the others one window of their whole size; the last
# pass reduces the <= 32-wide rest.  Each window is a loop nest, outer dim
# first.  LLVM unrolls the innermost loop and, for 2 <= g <= 8 elements a
# row, vectorizes the loop over the n rows of the next dim: lane l takes
# rows l, l+v, ... (lane 0 starting from the running sum), the lanes are
# added by halves, then the rows left over are added in turn
# (:func:`_xla_lanes`).  A window dim padded on both sides guards each row,
# which stops that vectorization; a dim padded by one after (lo 0, hi 1)
# has its last index peeled off and added after the rest of the nest.  A
# reduce with no window pass takes its producer into the loop: for
# ``jnp.sum(jnp.square(x))`` each add is then a fused multiply-add.


def _xla_lanes(n: int, g: int, fused: bool) -> int:
    """The vector width LLVM gives a loop of n rows of g unrolled adds
    (``fused``: of squares taken in the loop)."""
    if not 2 <= g <= 8 or n < 2:
        return 0
    if n < 16:
        return n if n in (2, 4, 8) else 0
    if g >= 7 and not fused:
        return 4
    if n == 32 or n % 8 < 4 or (g == 2 and n > 24):
        return 8
    return 4


def _fma_sq(acc: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return ftz(fma32(x, x, acc))


def _add_sq(acc: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return ftz(acc + ftz(x * x))


def _xla_block(t: torch.Tensor, fused: bool = False,
               vectorize: bool = True) -> torch.Tensor:
    """(N, *w) -> (N,): each block of t reduced in XLA:CPU's loop order.
    ``fused``: t holds the values whose squares are summed, in a loop that
    squares them itself (an FMA each, except in vector lanes over rows of
    more than 4, where the squares are rounded before the add)."""
    add = _fma_sq if fused else torch.add
    n_blk, w = t.shape[0], t.shape[1:]
    acc = torch.zeros(n_blk, dtype=_F32, device=t.device)
    if len(w) < 2:
        for v in t.reshape(n_blk, -1).unbind(1):
            acc = add(acc, v)
        return acc
    n, g = w[-2], w[-1]
    lanes = _xla_lanes(n, g, fused) if vectorize else 0
    n_vec = n - n % lanes if lanes else 0
    vec_add = _add_sq if fused and g > 4 else add
    for blk in t.reshape(n_blk, -1, n, g).unbind(1):
        if n_vec:
            vec = torch.zeros(n_blk, lanes, dtype=_F32, device=t.device)
            vec[:, 0] = acc
            for base in range(0, n_vec, lanes):
                for j in range(g):
                    vec = vec_add(vec, blk[:, base:base + lanes, j])
            while vec.shape[1] > 1:
                half = vec.shape[1] // 2
                vec = vec[:, :half] + vec[:, half:]
            acc = vec[:, 0]
        for v in blk[:, n_vec:].reshape(n_blk, -1).unbind(1):
            acc = add(acc, v)
    return acc


def _xla_window_pass(x: torch.Tensor) -> torch.Tensor:
    """One ``reduce-window`` pass over every dim of x (no dim is 1), of
    rounded squares: no add needs a flush."""
    dims = list(x.shape)
    k = len(dims)
    win = [min(d, _XLA_WINDOW) for d in dims]
    out = [-(-d // w) for d, w in zip(dims, win)]
    pads = [o * w - d for o, w, d in zip(out, win, dims)]
    pad_arg = []
    for p in reversed(pads):
        pad_arg += [p // 2, p - p // 2]
    x = torch.nn.functional.pad(x, pad_arg)
    x = x.reshape([v for o, w in zip(out, win) for v in (o, w)])
    x = x.permute(*range(0, 2 * k, 2), *range(1, 2 * k, 2)).reshape(-1, *win)
    peel = [d for d in range(k) if pads[d] == 1]
    main = x
    for d in peel:
        main = main.narrow(d + 1, 0, win[d] - 1)
    guarded = k >= 2 and pads[k - 2] > 1
    acc = _xla_block(main, vectorize=not guarded)
    # the peeled last indices, outer peeled dim first, their corner last
    for d in peel:
        idx = [slice(None)] + [slice(0, w - 1) if e in peel else slice(None)
                               for e, w in enumerate(win)]
        idx[d + 1] = slice(win[d] - 1, win[d])
        for v in x[tuple(idx)].reshape(x.shape[0], -1).unbind(1):
            acc = acc + v
    if len(peel) > 1:
        idx = [slice(None)] + [slice(w - 1, w) if e in peel else slice(None)
                               for e, w in enumerate(win)]
        for v in x[tuple(idx)].reshape(x.shape[0], -1).unbind(1):
            acc = acc + v
    return acc.reshape(out)


def xla_sum_squares(x: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's f32 ``jnp.sum(jnp.square(x))`` of an array of any rank.

    With a window pass the squares are rounded and flushed first (their
    own kernel), and partial sums of flushed squares are never subnormal;
    without one each add is a fused multiply-add of the square
    (:func:`fma32`) but in vector lanes over rows of 5 to 8.  Not
    reproduced, so possibly a last bit off: a 3-d window with two dims
    padded by one, such as (63, 63, 4)'s."""
    x = ftz(x.to(_F32))
    x = x.reshape([d for d in x.shape if d != 1])
    if not x.dim() or max(x.shape) <= _XLA_WINDOW:
        return _xla_block(x.reshape(1, *x.shape), fused=True)[0]
    x = ftz(x * x)
    while max(x.shape) > _XLA_WINDOW:
        x = _xla_window_pass(x)
        x = x.reshape([d for d in x.shape if d != 1])
    return _xla_block(x.reshape(1, *x.shape))[0]


def top_k_indices(x: torch.Tensor, k: int) -> torch.Tensor:
    """``lax.top_k(x, k)[1]``: the indices of the k largest values in
    descending order, the lower index first among equal values (a stable
    descending sort; ``torch.topk`` promises no order among ties)."""
    return torch.sort(x, descending=True, stable=True).indices[:k]


def choice(key: torch.Tensor, n: int, m: int, p: torch.Tensor | None = None,
           device: str | torch.device | None = None) -> torch.Tensor:
    """``jax.random.choice(key, n, (m,), replace=False, p=p)`` as int64:
    without ``p`` the first m of :func:`permutation`; with f32
    probabilities ``p`` (n,) the Gumbel top-k, ``top_k(gumbel(key, (n,)) +
    log(p), m)``."""
    if not 0 < m <= n:
        raise ValueError(f"cannot take {m} of {n} without replacement")
    if p is None:
        return permutation(key, n, device)[:m]
    g = gumbel(key, (n,), p.device if device is None else device)
    return top_k_indices(ftz(g + _xla_log(ftz(p.to(g.device)))), m)
