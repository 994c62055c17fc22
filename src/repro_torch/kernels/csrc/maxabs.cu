// maxabs: max |x| over a flat f32 vector, written to a zeroed f32 scalar.
//
// Replaces the TPU kernel `_maxabs_kernel` (src/repro/kernels/topk_threshold.py:32,
// launched by `maxabs` at :73).  On the TPU the grid runs in order and carries
// the running max in its revisited output block; here blocks run in parallel,
// so each block reduces its grid-stride share (warp `redux.sync` max, then a
// shared-memory step) and issues ONE atomicMax on the result's bits.  The max
// runs on the bits of |x| as unsigned integers: for non-negative floats the
// bit order is the value order, so the result is exact (and a NaN, whose bits
// sit above +inf, propagates as jnp.max does).
//
// Bound on the H100: bytes.  The kernel reads each input element once (4 B)
// and does one compare per element; at the largest leaf of the 100M stack
// (28,311,552 elements) that is 113 MB, 0.034 ms at 3.35 TB/s.  The design
// meets that bound with 16-byte loads (float4, read-only path), eight
// resident blocks per SM and an unrolled loop to keep enough loads in flight;
// the cross-block reduction costs one atomic per block.
#include "common.cuh"

namespace {

__device__ __forceinline__ unsigned abs_bits(float v) {
  return __float_as_uint(v) & 0x7fffffffu;
}

__global__ void __launch_bounds__(lgc::kThreads)
maxabs_kernel(const float* __restrict__ x, int64_t n, unsigned* __restrict__ out) {
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t head = lgc::head_elems(x, n);
  const int64_t n4 = (n - head) / 4;
  const float4* body = reinterpret_cast<const float4*>(x + head);

  unsigned m = 0u;
  if (tid < head) m = abs_bits(x[tid]);
#pragma unroll 4
  for (int64_t i = tid; i < n4; i += stride) {
    const float4 v = __ldg(body + i);
    m = max(m, max(max(abs_bits(v.x), abs_bits(v.y)), max(abs_bits(v.z), abs_bits(v.w))));
  }
  for (int64_t i = head + 4 * n4 + tid; i < n; i += stride) m = max(m, abs_bits(x[i]));

  __shared__ unsigned warp_max[lgc::kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  m = __reduce_max_sync(0xffffffffu, m);
  if (lane == 0) warp_max[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < lgc::kWarps ? warp_max[lane] : 0u;
    m = __reduce_max_sync(0xffffffffu, m);
    if (lane == 0) atomicMax(out, m);
  }
}

}  // namespace

extern "C" int lgc_maxabs(const float* x, int64_t n, float* out, cudaStream_t stream) {
  const int grid = lgc::grid_for((n + 3) / 4, 8);
  maxabs_kernel<<<grid, lgc::kThreads, 0, stream>>>(x, n, reinterpret_cast<unsigned*>(out));
  return static_cast<int>(cudaGetLastError());
}
