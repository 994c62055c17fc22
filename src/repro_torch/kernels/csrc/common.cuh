// Shared helpers of the histogram-LGC kernels (plain C interface, bound
// with ctypes by repro_torch/kernels/_build.py).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace lgc {

constexpr int kThreads = 256;          // threads per block, 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 256;             // histogram bins (N_BINS)

// Blocks for a grid-stride pass over `items` work items (one per thread per
// iteration): no more than `blocks_per_sm` resident blocks on every SM.
inline int grid_for(int64_t items, int blocks_per_sm) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  const int64_t need = (items + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(sms) * blocks_per_sm;
  return static_cast<int>(need < 1 ? 1 : (need < cap ? need : cap));
}

// Elements before the first 16-byte boundary of `p` (0..3 floats), capped
// at n: the float4 body starts after them.
__device__ __forceinline__ int64_t head_elems(const float* p, int64_t n) {
  const int64_t h =
      static_cast<int64_t>(((16u - (reinterpret_cast<uintptr_t>(p) & 15u)) & 15u) / 4u);
  return h < n ? h : n;
}

}  // namespace lgc
