// histogram: 256-bin histogram of |x| over [0, m], m read from the device, in
// one launch.
//
// Replaces the TPU kernel `_hist_kernel` (src/repro/kernels/topk_threshold.py:42,
// launched by `histogram` at :88).  The TPU kernel scatters through a one-hot
// (bins x lanes) contraction into its revisited output block and subtracts its
// zero padding from bin 0; here nothing is padded and blocks run in no order.
//
// The bin is clip(int(|x| * (256 / m)), 0, 255) with an IEEE-rounded division
// (__fdiv_rn; the build never passes --use_fast_math) and an uncontracted
// product, so every element lands in the same bin as in the plain version.
// The product is `mul.rn.ftz`, and m is flushed, as the reference's platforms
// flush subnormals: a subnormal |x| reads as 0 (times an infinite scale: NaN,
// bin 0).  NaN goes to bin 0 and +inf to bin 255.  No host sync.
//
// Bound on the H100: bytes.  One 4-byte read per element and a few integer
// ops; at the largest leaf (28,311,552 elements) 113 MB, 0.034 ms at 3.35 TB/s.
//
// Design:
// * Loads in flight.  The grid is 4 blocks of 256 threads per SM (fewer for a
//   short vector; the wrapper passes it), and each
//   thread issues kLoads independent 16-byte streaming loads before it counts
//   any of them, over whole chunks of the grid with no bounds check (the 0-3
//   floats before the first 16-byte boundary, the float4s past the last whole
//   chunk and the 0-3 floats at the end are handled apart).
// * Contention.  Each warp counts into its own int[256] in shared memory
//   (8 KB a block), and each thread keeps bin 0 -- most of a gradient's mass
//   -- in a register.  A constant vector, every lane of every warp on bin 255,
//   ran no slower than a Gaussian (the card resolves a warp's shared atomics
//   on one address well), and a register run of equal bins, tried against
//   it, was slower on the Gaussian and on the main path's u
//   (python -m repro_torch.launch.bench_histogram).
// * One launch, no zero-fill.  Each block adds its non-zero bins to a
//   256-int accumulator in device memory that stays zero between launches,
//   fences, and counts itself on a counter; the last block moves the
//   accumulator into `counts` with atomicExch(.., 0) and resets the counter.
//   The integer counts make every atomic order give the same result.
// * Rows.  The same kernel takes (M, D) rows (the simulator's batched engine
//   and the 100M step), row blockIdx.y of a 2-D grid, each row with its own
//   maximum, accumulator, counter and counts; a flat vector is one row.
#include "common.cuh"

namespace {

constexpr int kLoads = 4;              // independent 16-byte loads per thread
static_assert(lgc::kThreads == lgc::kBins, "one thread per bin in the combine");

// Counts one value: bin 0 in the thread's register `zeros`, any other bin by a
// shared atomic on its warp's int[256].
__device__ __forceinline__ void count(float v, float scale, int* bins, int& zeros) {
  int b = __float2int_rz(lgc::mul_ftz(fabsf(v), scale));   // NaN -> 0, +inf -> INT_MAX
  b = min(max(b, 0), lgc::kBins - 1);
  if (b == 0) {
    ++zeros;
  } else {
    atomicAdd(bins + b, 1);
  }
}

__device__ __forceinline__ void count(float4 v, float scale, int* bins, int& zeros) {
  count(v.x, scale, bins, zeros);
  count(v.y, scale, bins, zeros);
  count(v.z, scale, bins, zeros);
  count(v.w, scale, bins, zeros);
}

// One vector's histogram over the blocks blockIdx.x of the grid's x axis.
__device__ __forceinline__ void histogram_block(const float* __restrict__ x, int64_t n,
                                                const float* __restrict__ maxabs,
                                                int* __restrict__ acc, int* __restrict__ counter,
                                                int* __restrict__ counts) {
  __shared__ int sub[lgc::kWarps][lgc::kBins];
  __shared__ bool last;
  for (int i = threadIdx.x; i < lgc::kWarps * lgc::kBins; i += blockDim.x) (&sub[0][0])[i] = 0;
  __syncthreads();

  const float m = lgc::ftz(__ldg(maxabs));
  const float scale = m > 0.0f ? __fdiv_rn(256.0f, m) : 0.0f;
  int* bins = sub[threadIdx.x >> 5];
  int zeros = 0;

  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t head = lgc::head_elems(x, n);
  const int64_t n4 = (n - head) / 4;
  const float4* body = reinterpret_cast<const float4*>(x + head);
  const int64_t chunk = stride * kLoads;           // float4s per pass of the grid
  const int64_t whole = n4 / chunk * chunk;

  if (tid < head) count(x[tid], scale, bins, zeros);
  for (int64_t i = tid; i < whole; i += chunk) {
    float4 v[kLoads];
#pragma unroll
    for (int k = 0; k < kLoads; ++k) v[k] = lgc::load_stream(body + i + k * stride);
#pragma unroll
    for (int k = 0; k < kLoads; ++k) count(v[k], scale, bins, zeros);
  }
#pragma unroll
  for (int k = 0; k < kLoads; ++k) {               // the float4s past the whole chunks
    const int64_t i = whole + tid + k * stride;
    if (i < n4) count(lgc::load_stream(body + i), scale, bins, zeros);
  }
  const int64_t t = head + 4 * n4 + tid;           // the 0-3 floats at the end
  if (t < n) count(x[t], scale, bins, zeros);

  zeros = __reduce_add_sync(0xffffffffu, zeros);
  if ((threadIdx.x & 31) == 0 && zeros) atomicAdd(bins, zeros);
  __syncthreads();

  const int b = threadIdx.x;                       // this thread's bin
  int s = 0;
#pragma unroll
  for (int w = 0; w < lgc::kWarps; ++w) s += sub[w][b];
  if (s) atomicAdd(acc + b, s);
  __threadfence();                                 // the adds are visible before they count
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(counter, 1) == static_cast<int>(gridDim.x) - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  counts[b] = atomicExch(acc + b, 0);              // the accumulator is zero again
  if (b == 0) *counter = 0;                        // ready for the next launch
}

// Row blockIdx.y of x with its own maximum, its own 257-int accumulator (256
// bins and a counter) and its own 256 counts; a flat vector is one row.
__global__ void __launch_bounds__(lgc::kThreads)
histogram_kernel(const float* __restrict__ x, int64_t n, const float* __restrict__ maxabs,
                 int* __restrict__ acc, int* __restrict__ counts) {
  const int64_t row = blockIdx.y;
  int* acc_row = acc + row * (lgc::kBins + 1);
  histogram_block(x + row * n, n, maxabs + row, acc_row, acc_row + lgc::kBins,
                  counts + row * lgc::kBins);
}

}  // namespace

// x (rows, n), maxabs (rows,), counts (rows, 256).  acc: rows x 257 ints
// (256 bins and a counter each), zero, left zero.  grid: blocks per row.
extern "C" int lgc_histogram(const float* x, int64_t rows, int64_t n, const float* maxabs,
                             int* counts, int* acc, int grid, cudaStream_t stream) {
  if (rows < 1 || rows > 65535 || n < 1 || grid < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 blocks(grid, static_cast<unsigned>(rows));
  histogram_kernel<<<blocks, lgc::kThreads, 0, stream>>>(x, n, maxabs, acc, counts);
  return static_cast<int>(cudaGetLastError());
}
