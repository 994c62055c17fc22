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
// u == g + e' holds exactly.  u is added with `add.rn.ftz` and the thresholds
// are flushed, as the reference's platforms flush f32 subnormals.
//
// Bound on the H100: bytes.  It reads e and delta once and writes g and e'
// once: 16 B per element, 453 MB at the largest leaf (28,311,552 elements),
// 0.135 ms at 3.35 TB/s; a handful of compares per element is far below the
// compute rate.  The design is one streaming pass with 16-byte loads and
// stores and eight resident blocks per SM; u never goes to device memory.
//
// One kernel serves the flat vector and the (M, D) rows (the simulator's
// batched engine and the 100M step: one row per FL device): row blockIdx.y
// of a 2-D grid with that row's thresholds and delivery flags, a flat vector
// being one row.  A row starts anywhere modulo 16 bytes (an odd D, a view),
// so each takes a scalar head of 0-3 floats, a float4 body and a scalar tail;
// every element's arithmetic is the same, so a row's bits do not depend on
// how the rows are grouped.
#include "common.cuh"

namespace {

template <int C>
struct Layers {
  float lo[C];
  bool on[C];

  __device__ __forceinline__ void apply(float ev, float dv, float& gv, float& env) const {
    const float u = lgc::add_ftz(ev, dv);
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

// Row blockIdx.y of e and d with its own C thresholds and delivery flags
// (thr and recv are (rows, C)), gridDim.x blocks per row.  kVec: e, d, g and
// e_new share their offset from a 16-byte boundary, so each row moves as
// float4s after its own head of 0-3 floats.
template <int C, bool kVec>
__global__ void __launch_bounds__(lgc::kThreads)
sparsify_ef_kernel(const float* __restrict__ e, const float* __restrict__ d,
                        const float* __restrict__ thr, const int* __restrict__ recv,
                        float* __restrict__ g, float* __restrict__ e_new, int64_t n) {
  const int64_t row = blockIdx.y;
  Layers<C> L;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    L.lo[c] = lgc::ftz(__ldg(thr + row * C + c));
    L.on[c] = __ldg(recv + row * C + c) > 0;
  }
  e += row * n;
  d += row * n;
  g += row * n;
  e_new += row * n;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  int64_t done = 0;
  if (kVec) {
    const int64_t head = lgc::head_elems(e, n);
    if (tid < head) L.apply(e[tid], d[tid], g[tid], e_new[tid]);
    const int64_t n4 = (n - head) / 4;
    const float4* e4 = reinterpret_cast<const float4*>(e + head);
    const float4* d4 = reinterpret_cast<const float4*>(d + head);
    float4* g4 = reinterpret_cast<float4*>(g + head);
    float4* n4p = reinterpret_cast<float4*>(e_new + head);
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
    done = head + 4 * n4;
  }
  for (int64_t i = done + tid; i < n; i += stride) L.apply(e[i], d[i], g[i], e_new[i]);
}

template <int C>
void launch(const float* e, const float* d, const float* thr, const int* recv, float* g,
                 float* e_new, int64_t rows, int64_t n, int grid, cudaStream_t stream) {
  const uintptr_t pe = reinterpret_cast<uintptr_t>(e);
  const bool vec = (((pe ^ reinterpret_cast<uintptr_t>(d)) | (pe ^ reinterpret_cast<uintptr_t>(g)) |
                     (pe ^ reinterpret_cast<uintptr_t>(e_new))) & 15u) == 0;
  const dim3 blocks(grid, static_cast<unsigned>(rows));
  if (vec) {
    sparsify_ef_kernel<C, true><<<blocks, lgc::kThreads, 0, stream>>>(e, d, thr, recv, g,
                                                                           e_new, n);
  } else {
    sparsify_ef_kernel<C, false><<<blocks, lgc::kThreads, 0, stream>>>(e, d, thr, recv, g,
                                                                            e_new, n);
  }
}

}  // namespace

// e, d, g, e_new (rows, n); thr (rows, C) f32 and recv (rows, C) int32; a
// flat vector is one row.  grid: blocks per row.
extern "C" int lgc_sparsify_ef(const float* e, const float* d, const float* thr,
                               const int* recv, int n_layers, float* g, float* e_new,
                               int64_t rows, int64_t n, int grid, cudaStream_t stream) {
  if (rows < 1 || rows > 65535 || n < 1 || grid < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (n_layers) {
    case 1: launch<1>(e, d, thr, recv, g, e_new, rows, n, grid, stream); break;
    case 2: launch<2>(e, d, thr, recv, g, e_new, rows, n, grid, stream); break;
    case 3: launch<3>(e, d, thr, recv, g, e_new, rows, n, grid, stream); break;
    case 4: launch<4>(e, d, thr, recv, g, e_new, rows, n, grid, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
