// Shared helpers of the histogram-LGC kernels (plain C interface, bound
// with ctypes by repro_torch/kernels/_build.py).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace lgc {

constexpr int kThreads = 256;          // threads per block, 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 256;             // histogram bins (N_BINS)

// Elements before the first 16-byte boundary of `p` (0..3 floats), capped
// at n: the float4 body starts after them.
__device__ __forceinline__ int64_t head_elems(const float* p, int64_t n) {
  const int64_t h =
      static_cast<int64_t>(((16u - (reinterpret_cast<uintptr_t>(p) & 15u)) & 15u) / 4u);
  return h < n ? h : n;
}

// 16-byte load that bypasses L1: each byte of the input is read once
__device__ __forceinline__ float4 load_stream(const float4* p) {
  float4 v;
  asm("ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];\n"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
      : "l"(p));
  return v;
}

// Subnormals.  The reference's platforms flush f32 subnormals (XLA:CPU runs
// with FTZ/DAZ, the TPU has none): its arithmetic reads a subnormal input as
// a zero of the same sign and writes a subnormal result as one.  The `.ftz`
// forms of PTX arithmetic do the same; abs and moves keep the bits.
constexpr unsigned kMinNormalBits = 0x00800000u;    // 2**-126

__device__ __forceinline__ float ftz(float v) {
  const unsigned b = __float_as_uint(v);
  return (b & 0x7fffffffu) < kMinNormalBits ? __uint_as_float(b & 0x80000000u) : v;
}

__device__ __forceinline__ float add_ftz(float a, float b) {
  float r;
  asm("add.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float mul_ftz(float a, float b) {
  float r;
  asm("mul.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

}  // namespace lgc
