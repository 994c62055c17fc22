// threefry_normal: the weights' draw, `(jax.random.normal(key, (n,)) * std)
// .astype(dtype)`, in one launch, bit for bit the port's plain version
// (repro_torch.core.prng.normal, then `* std` and the cast).
//
// Not a port of a TPU kernel: the reference draws with XLA's threefry and
// erf_inv (src/repro/models/layers.py:257-277).  The plain version takes a
// few hundred elementwise torch passes over int64 and f64 temporaries, about
// 0.18 G elements/s on the H100, and so took most of a full-width model's
// start-up (yi-34b's 34.4 G parameters: over three minutes).  Here each
// element is formed in registers and written once.
//
// Per element i (a 64-bit index, hashed as the counter pair (hi(i), lo(i))):
//   bits  = y0 ^ y1 of threefry2x32(key, (hi(i), lo(i)))  (20 rounds)
//   f     = float((bits >> 9) | 0x3f800000) - 1             in [0, 1)
//   u     = max(lo, fma(f, hi - lo, lo)), lo = nextafter(-1, 0), hi = 1
//   z     = f32(sqrt 2) * erf_inv(u)                        XLA:CPU's erf_inv
//   out   = dtype(z * f32(std))
// erf_inv is Giles' polynomial over XLA:CPU's log1p (a Cephes rational below
// sqrt(2) - 1, the Cephes log of 1 + x above), every multiply-add of the
// polynomials fused as XLA contracts them (`__fmaf_rn`), every other
// multiply, add and divide rounded on its own (`__fmul_rn`, `__fadd_rn`,
// `__fdiv_rn`: nvcc never contracts these) and the square root correctly
// rounded (`__fsqrt_rn`).  Subnormals are kept (no `.ftz`), as torch keeps
// them in the plain version.  Constants are the plain version's Python
// floats rounded to f32 (`F(x)`: through a double, as torch rounds them).
//
// Bound on the H100: operations.  About 120 integer and f32 operations an
// element (threefry's 20 rounds of add, rotate and xor, then erf_inv) against
// 2 or 4 bytes written.  A thread takes elements i, i + stride, ... of a
// grid of the resident block count.
#include <cuda_bf16.h>
#include <math.h>

#include "common.cuh"

namespace {

#define F(x) (static_cast<float>(x))

__device__ __forceinline__ uint32_t rotl(uint32_t v, int r) {
  return (v << r) | (v >> (32 - r));
}

// 32 random bits of element i: `bits1 ^ bits2` of the 64-bit iota
__device__ __forceinline__ uint32_t threefry_bits(uint32_t k0, uint32_t k1, uint64_t i) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  uint32_t x0 = static_cast<uint32_t>(i >> 32) + ks[0];
  uint32_t x1 = static_cast<uint32_t>(i) + ks[1];
  constexpr int kRot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
#pragma unroll
  for (int g = 0; g < 5; ++g) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, kRot[g % 2][j]) ^ x0;
    }
    x0 += ks[(g + 1) % 3];
    x1 += ks[(g + 2) % 3] + static_cast<uint32_t>(g + 1);
  }
  return x0 ^ x1;
}

// XLA:CPU's f32 log (the Cephes polynomial on the mantissa), prng._xla_log
__device__ __forceinline__ float xla_log(float x) {
  const float t0 = fmaxf(x, F(1.1754943508222875e-38));
  const int bits = __float_as_int(t0);
  const float frac = __int_as_float((bits & ~0x7F800000) | 0x3F000000);
  float e = __fadd_rn(1.0f, static_cast<float>((bits >> 23) - 0x7F));
  const bool small = frac < F(0.707106781186547524);
  float t = __fsub_rn(frac, 1.0f);
  e = __fsub_rn(e, small ? 1.0f : 0.0f);
  t = __fadd_rn(t, small ? frac : 0.0f);
  const float x2 = __fmul_rn(t, t);
  const float x3 = __fmul_rn(x2, t);
  float y = __fmaf_rn(t, F(7.0376836292E-2), F(-1.1514610310E-1));
  float y1 = __fmaf_rn(t, F(-1.2420140846E-1), F(1.4249322787E-1));
  float y2 = __fmaf_rn(t, F(2.0000714765E-1), F(-2.4999993993E-1));
  y = __fmaf_rn(y, t, F(1.1676998740E-1));
  y1 = __fmaf_rn(y1, t, F(-1.6668057665E-1));
  y2 = __fmaf_rn(y2, t, F(3.3333331174E-1));
  y = __fmaf_rn(y, x3, y1);
  y = __fmaf_rn(y, x3, y2);
  y = __fmaf_rn(y, x3, __fmul_rn(F(-2.12194440e-4), e));
  t = __fmaf_rn(-0.5f, x2, t);
  t = __fadd_rn(t, y);
  t = __fadd_rn(t, __fmul_rn(F(0.693359375), e));
  if (x == 0.0f) return -INFINITY;
  if (x == INFINITY) return INFINITY;
  return x < 0.0f ? NAN : t;
}

template <int N>
__device__ __forceinline__ float horner(float x, const double (&c)[N]) {
  float r = F(c[0]);
#pragma unroll
  for (int i = 1; i < N; ++i) r = __fmaf_rn(r, x, F(c[i]));
  return r;
}

// XLA:CPU's f32 log1p, prng._xla_log1p
__device__ __forceinline__ float xla_log1p(float x) {
  constexpr double kNum[7] = {4.5270000862445199635215E-5, 4.9854102823193375972212E-1,
                              6.5787325942061044846969E0,  2.9911919328553073277375E1,
                              6.0949667980987787057556E1,  5.7112963590585538103336E1,
                              2.0039553499201281259648E1};
  constexpr double kDen[7] = {1., 1.5062909083469192043167E1, 8.3047565967967209469434E1,
                              2.2176239823732856465394E2, 3.0909872225312059774938E2,
                              2.1642788614495947685003E2, 6.0118660497603843919306E1};
  if (!(fabsf(x) < F(0.41421356237309504880))) return xla_log(__fadd_rn(x, 1.0f));
  const float x2 = __fmul_rn(x, x);
  float s = __fmul_rn(__fmul_rn(x, x2), __fdiv_rn(horner(x, kNum), horner(x, kDen)));
  return __fadd_rn(x, __fmaf_rn(-0.5f, x2, s));
}

// XLA's f32 erf_inv (Giles), prng.erf_inv
__device__ __forceinline__ float erf_inv(float x) {
  constexpr double kLt5[9] = {2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                              -4.39150654e-06, 0.00021858087, -0.00125372503,
                              -0.00417768164, 0.246640727,    1.50140941};
  constexpr double kGe5[9] = {-0.000200214257, 0.000100950558, 0.00134934322,
                              -0.00367342844,  0.00573950773,  -0.0076224613,
                              0.00943887047,   1.00167406,     2.83297682};
  const float w = -xla_log1p(__fmul_rn(x, -x));
  const bool lt = w < 5.0f;
  const float ww = lt ? __fsub_rn(w, 2.5f) : __fsub_rn(__fsqrt_rn(w), 3.0f);
  float p = lt ? F(kLt5[0]) : F(kGe5[0]);
#pragma unroll
  for (int i = 1; i < 9; ++i) p = __fmaf_rn(p, ww, lt ? F(kLt5[i]) : F(kGe5[i]));
  return fabsf(x) == 1.0f ? __fmul_rn(x, INFINITY) : __fmul_rn(p, x);
}

__device__ __forceinline__ float normal_at(uint32_t k0, uint32_t k1, uint64_t i, float std) {
  const float lo = F(-0.99999994039535522);
  const float f = __fsub_rn(__uint_as_float((threefry_bits(k0, k1, i) >> 9) | 0x3F800000u), 1.0f);
  const float u = fmaxf(lo, __fmaf_rn(f, __fsub_rn(1.0f, lo), lo));
  return __fmul_rn(__fmul_rn(F(1.4142135381698608), erf_inv(u)), std);
}

template <typename T>
__device__ __forceinline__ T cast_out(float v);
template <>
__device__ __forceinline__ float cast_out<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 cast_out<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(lgc::kThreads)
    threefry_normal_kernel(uint32_t k0, uint32_t k1, float std, T* __restrict__ out, int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride)
    out[i] = cast_out<T>(normal_at(k0, k1, static_cast<uint64_t>(i), std));
}

}  // namespace

// out (n,) of dtype 0 (f32) or 1 (bf16) <- (normal(key, (n,)) * std).astype(dtype)
extern "C" int lgc_threefry_normal(uint32_t k0, uint32_t k1, float std, void* out, int64_t n,
                                   int dtype, int blocks, cudaStream_t stream) {
  if (dtype == 0)
    threefry_normal_kernel<float><<<blocks, lgc::kThreads, 0, stream>>>(
        k0, k1, std, static_cast<float*>(out), n);
  else
    threefry_normal_kernel<__nv_bfloat16><<<blocks, lgc::kThreads, 0, stream>>>(
        k0, k1, std, static_cast<__nv_bfloat16*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
