// sparsify_ef: fused layered sparsification with error feedback.
//
//   u  = e + delta
//   layer c keeps thr[c-1] >= |u| > thr[c]   (thr[-1] = +inf)
//   g  = sum of the received layers,  e' = u - g
//
// Replaces the TPU kernel `_sparsify_ef_kernel`
// (src/repro/kernels/layered_sparsify.py:32, launched by `sparsify_ef` at :67).
// The TPU kernel works on (block_rows, 128) VMEM tiles of a zero-padded copy;
// here each thread takes float4 groups of the unpadded vectors, with the C <= 4
// thresholds and delivery flags in registers (read on the device: no host
// sync).  g starts at +0.0 and adds u or +0.0 once per layer, exactly as the
// reference does, so g and e' are bitwise equal to the plain version and
// u == g + e' holds exactly.
//
// Bound on the H100: bytes.  It reads e and delta once and writes g and e'
// once: 16 B per element, 453 MB at the largest leaf (28,311,552 elements),
// 0.135 ms at 3.35 TB/s; a handful of compares per element is far below the
// compute rate.  The design is one streaming pass with 16-byte loads and
// stores and eight resident blocks per SM; u never goes to device memory.
#include "common.cuh"

namespace {

template <int C>
struct Layers {
  float lo[C];
  bool on[C];

  __device__ __forceinline__ void apply(float ev, float dv, float& gv, float& env) const {
    const float u = __fadd_rn(ev, dv);
    const float a = fabsf(u);
    float acc = 0.0f;
    float hi = __int_as_float(0x7f800000);   // +inf
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const bool take = (a <= hi) && (a > lo[c]) && on[c];
      acc = __fadd_rn(acc, take ? u : 0.0f);
      hi = lo[c];
    }
    gv = acc;
    env = __fsub_rn(u, acc);
  }
};

template <int C, bool kVec>
__global__ void __launch_bounds__(lgc::kThreads)
sparsify_ef_kernel(const float* __restrict__ e, const float* __restrict__ d,
                   const float* __restrict__ thr, const int* __restrict__ recv,
                   float* __restrict__ g, float* __restrict__ e_new, int64_t n) {
  Layers<C> L;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    L.lo[c] = __ldg(thr + c);
    L.on[c] = __ldg(recv + c) > 0;
  }
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  int64_t done = 0;
  if (kVec) {   // every pointer 16-byte aligned (checked by the launcher)
    const int64_t n4 = n / 4;
    const float4* e4 = reinterpret_cast<const float4*>(e);
    const float4* d4 = reinterpret_cast<const float4*>(d);
    float4* g4 = reinterpret_cast<float4*>(g);
    float4* n4p = reinterpret_cast<float4*>(e_new);
    for (int64_t i = tid; i < n4; i += stride) {
      const float4 ev = __ldg(e4 + i);
      const float4 dv = __ldg(d4 + i);
      float4 gv, nv;
      L.apply(ev.x, dv.x, gv.x, nv.x);
      L.apply(ev.y, dv.y, gv.y, nv.y);
      L.apply(ev.z, dv.z, gv.z, nv.z);
      L.apply(ev.w, dv.w, gv.w, nv.w);
      g4[i] = gv;
      n4p[i] = nv;
    }
    done = 4 * n4;
  }
  for (int64_t i = done + tid; i < n; i += stride) L.apply(e[i], d[i], g[i], e_new[i]);
}

template <int C>
void launch(const float* e, const float* d, const float* thr, const int* recv, float* g,
            float* e_new, int64_t n, cudaStream_t stream) {
  const bool vec = ((reinterpret_cast<uintptr_t>(e) | reinterpret_cast<uintptr_t>(d) |
                     reinterpret_cast<uintptr_t>(g) | reinterpret_cast<uintptr_t>(e_new)) &
                    15u) == 0;
  if (vec) {
    const int grid = lgc::grid_for((n + 3) / 4, 8);
    sparsify_ef_kernel<C, true><<<grid, lgc::kThreads, 0, stream>>>(e, d, thr, recv, g, e_new, n);
  } else {
    const int grid = lgc::grid_for(n, 8);
    sparsify_ef_kernel<C, false><<<grid, lgc::kThreads, 0, stream>>>(e, d, thr, recv, g, e_new, n);
  }
}

}  // namespace

extern "C" int lgc_sparsify_ef(const float* e, const float* d, const float* thr, const int* recv,
                               int n_layers, float* g, float* e_new, int64_t n,
                               cudaStream_t stream) {
  switch (n_layers) {
    case 1: launch<1>(e, d, thr, recv, g, e_new, n, stream); break;
    case 2: launch<2>(e, d, thr, recv, g, e_new, n, stream); break;
    case 3: launch<3>(e, d, thr, recv, g, e_new, n, stream); break;
    case 4: launch<4>(e, d, thr, recv, g, e_new, n, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
