// maxabs: max |x| over a flat f32 vector, written to an f32 scalar in one launch.
//
// Replaces the TPU kernel `_maxabs_kernel` (src/repro/kernels/topk_threshold.py:32,
// launched by `maxabs` at :73).  On the TPU the grid runs in order and carries
// the running max in its revisited output block; here blocks run in parallel.
// Each block reduces its share (warp `redux.sync` max, then a shared-memory
// step) and stores its max in a per-block partial; the last block to finish (a
// fence and a counter, which that block resets to 0) reduces the partials in
// block order and stores the result.  So the output needs no zero-fill and no
// launch besides this one.  The max runs on the bits of |x| as unsigned
// integers: for non-negative floats the bit order is the value order, so the
// result is exact (and a NaN, whose bits sit above +inf, propagates as jnp.max
// does).
//
// Bound on the H100: bytes.  The kernel reads each input element once (4 B)
// and does one compare per element; at the largest leaf of the 100M stack
// (28,311,552 elements) that is 113 MB, 0.034 ms at 3.35 TB/s.  To keep that
// rate each thread issues kLoads independent 16-byte streaming loads
// (`ld.global.nc.L1::no_allocate`) before it reduces them, over whole chunks of
// the grid with no bounds check; the 0-3 floats before the first 16-byte
// boundary, the float4s past the last whole chunk and the 0-3 floats at the end
// are handled apart.  The grid is the resident block count (the wrapper passes
// SMs x 8 blocks of 256 threads, fewer for a short vector).
#include "common.cuh"

namespace {

constexpr int kLoads = 4;              // independent 16-byte loads per thread

__device__ __forceinline__ unsigned abs_bits(float v) {
  return __float_as_uint(v) & 0x7fffffffu;
}

__device__ __forceinline__ unsigned abs_bits(float4 v) {
  return max(max(abs_bits(v.x), abs_bits(v.y)), max(abs_bits(v.z), abs_bits(v.w)));
}

__device__ __forceinline__ float4 load_stream(const float4* p) {
  float4 v;
  asm("ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];\n"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
      : "l"(p));
  return v;
}

// the block's max of m, in every thread
__device__ __forceinline__ unsigned block_max(unsigned m) {
  __shared__ unsigned warp_max[lgc::kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  m = __reduce_max_sync(0xffffffffu, m);
  if (lane == 0) warp_max[warp] = m;
  __syncthreads();
  m = lane < lgc::kWarps ? warp_max[lane] : 0u;
  return __reduce_max_sync(0xffffffffu, m);
}

__global__ void __launch_bounds__(lgc::kThreads)
maxabs_kernel(const float* __restrict__ x, int64_t n, unsigned* __restrict__ partials,
              int* __restrict__ counter, unsigned* __restrict__ out) {
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t head = lgc::head_elems(x, n);
  const int64_t n4 = (n - head) / 4;
  const float4* body = reinterpret_cast<const float4*>(x + head);
  const int64_t chunk = stride * kLoads;           // float4s per pass of the grid
  const int64_t whole = n4 / chunk * chunk;

  unsigned m = tid < head ? abs_bits(x[tid]) : 0u;
  for (int64_t i = tid; i < whole; i += chunk) {
    float4 v[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) v[u] = load_stream(body + i + u * stride);
#pragma unroll
    for (int u = 0; u < kLoads; ++u) m = max(m, abs_bits(v[u]));
  }
#pragma unroll
  for (int u = 0; u < kLoads; ++u) {               // the float4s past the whole chunks
    const int64_t i = whole + tid + u * stride;
    if (i < n4) m = max(m, abs_bits(load_stream(body + i)));
  }
  const int64_t t = head + 4 * n4 + tid;           // the 0-3 floats at the end
  if (t < n) m = max(m, abs_bits(x[t]));

  __shared__ bool last;
  m = block_max(m);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = m;
    __threadfence();                               // the partial is visible before it counts
    last = atomicAdd(counter, 1) == static_cast<int>(gridDim.x) - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  m = 0u;
  for (int i = threadIdx.x; i < static_cast<int>(gridDim.x); i += blockDim.x) {
    m = max(m, __ldcg(partials + i));
  }
  m = block_max(m);
  if (threadIdx.x == 0) {
    *out = m;
    *counter = 0;                                  // ready for the next launch
  }
}

}  // namespace

// partials: `grid` unsigned ints of scratch; counter: one int, zero, left zero.
extern "C" int lgc_maxabs(const float* x, int64_t n, float* out, unsigned* partials,
                          int* counter, int grid, cudaStream_t stream) {
  if (n < 1 || grid < 1) return static_cast<int>(cudaErrorInvalidValue);
  maxabs_kernel<<<grid, lgc::kThreads, 0, stream>>>(x, n, partials, counter,
                                                   reinterpret_cast<unsigned*>(out));
  return static_cast<int>(cudaGetLastError());
}
