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
// * Short rows (`lgc_histogram_short`).  Where the rows are many and short
//   (the sparse path's model-dim views: embed's 64,000 rows of 768 at
//   M = 2), one block a row zeroes 8 KB of shared memory for 3 KB of input
//   and pays up to 512 global atomics and two fences in the handshake
//   above, with rows x 257 ints of scratch.  There a warp owns a row, on a
//   persistent grid (the resident block count, fewer for few rows) that
//   strides over the rows with an int64 index, so there is no limit of
//   65,535 rows.  Each warp counts into its own int[256] in shared memory
//   (zeroed once), each lane keeps bin 0 in a register; after the row the
//   warp adds the lanes' bin-0 counts (`redux.sync`) into bin 0 and writes
//   its 256 counts straight to the row's counts as 16-byte stores, zeroing
//   its table in the same pass.  No global atomic, fence or scratch.
// * Segments (`lgc_histogram_segments`).  The simulator's per-layer budgets
//   (the reference's `per_layer_candidates_hist`,
//   src/repro/core/compressor.py:341-375, which calls `histogram` once per
//   model-layer slice at :364) bin every slice of every row against that
//   slice's own maximum.  One launch does all (row, slice) pairs: grid.y runs
//   over the rows, grid.x over the blocks of all slices (ceil(length / 4096)
//   a slice, at least one, at most the flat grid), found through a block ->
//   slice table that the wrapper builds once per slicing.  A slice is a
//   vector of its own to `histogram_block` (its blocks, accumulator, counter
//   and counts) and keeps the head / float4 body / tail scheme, since it
//   starts anywhere modulo 16 bytes; a slice whose maximum is 0 bins all in
//   bin 0, as the flat kernel bins a vector.  Every slice goes through the
//   kernel, also those under the reference's PALLAS_MIN_ELEMS: the
//   reference's routing never changes the counts (its
//   tests/test_kernels.py::TestPerLayerHistParity).  At the CNN's slices (10
//   to 200,704 floats) the launch is bound by its latency.
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

// One vector's histogram over the `nblocks` blocks given to it, this block
// being block `rank` of them (a row's blocks: blockIdx.x of gridDim.x; a
// slice's: its run of the grid's x axis).
__device__ __forceinline__ void histogram_block(const float* __restrict__ x, int64_t n,
                                                int64_t rank, int64_t nblocks,
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

  const int64_t tid = rank * blockDim.x + threadIdx.x;
  const int64_t stride = nblocks * blockDim.x;
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
  if (threadIdx.x == 0) last = atomicAdd(counter, 1) == static_cast<int>(nblocks) - 1;
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
  histogram_block(x + row * n, n, blockIdx.x, gridDim.x, maxabs + row, acc_row,
                  acc_row + lgc::kBins, counts + row * lgc::kBins);
}

// Segments: slice s of row blockIdx.y is x[row, offsets[s]:offsets[s + 1]],
// binned against its own maximum maxabs[row, s], with its own 257-int
// accumulator and its own 256 counts.  The grid's x axis runs over all
// slices' blocks: `first` (n_slices + 1 ints) gives slice s the blocks
// first[s] .. first[s + 1] - 1, and `block_slice` (gridDim.x ints) names
// each block's slice.
__global__ void __launch_bounds__(lgc::kThreads)
histogram_segments_kernel(const float* __restrict__ x, int64_t n,
                          const int64_t* __restrict__ offsets, const int* __restrict__ first,
                          const int* __restrict__ block_slice, int n_slices,
                          const float* __restrict__ maxabs, int* __restrict__ acc,
                          int* __restrict__ counts) {
  const int64_t row = blockIdx.y;
  const int s = block_slice[blockIdx.x];
  const int f = first[s];
  const int64_t lo = offsets[s];
  const int64_t rs = row * n_slices + s;
  int* acc_rs = acc + rs * (lgc::kBins + 1);
  histogram_block(x + row * n + lo, offsets[s + 1] - lo, static_cast<int64_t>(blockIdx.x) - f,
                  first[s + 1] - f, maxabs + rs, acc_rs, acc_rs + lgc::kBins,
                  counts + rs * lgc::kBins);
}

constexpr int kShortLoads = 8;         // float4s per lane and pass
constexpr int kShortBlocksPerSM = 4;   // resident blocks of the short form a SM

// Short rows: warp w of the grid owns rows w, w + (warps of the grid), ...
// and counts each into its own table.  The row index is the same across a
// warp, so the whole warp runs each row's loop, its sums and its stores.
__global__ void __launch_bounds__(lgc::kThreads, kShortBlocksPerSM)
histogram_short_kernel(const float* __restrict__ x, int64_t rows, int64_t n,
                       const float* __restrict__ maxabs, int* __restrict__ counts) {
  __shared__ __align__(16) int sub[lgc::kWarps][lgc::kBins];
  const int lane = threadIdx.x & 31;
  int* bins = sub[threadIdx.x >> 5];
  int4* mine = reinterpret_cast<int4*>(bins) + 2 * lane;    // bins 8 lane .. 8 lane + 7
  mine[0] = make_int4(0, 0, 0, 0);
  mine[1] = make_int4(0, 0, 0, 0);
  __syncwarp();

  const int64_t warps = static_cast<int64_t>(gridDim.x) * lgc::kWarps;
  for (int64_t row = static_cast<int64_t>(blockIdx.x) * lgc::kWarps + (threadIdx.x >> 5);
       row < rows; row += warps) {
    const float* xr = x + row * n;
    const float m = lgc::ftz(__ldg(maxabs + row));
    const float scale = m > 0.0f ? __fdiv_rn(256.0f, m) : 0.0f;
    int zeros = 0;
    const int64_t head = lgc::head_elems(xr, n);
    const int64_t n4 = (n - head) / 4;
    const float4* body = reinterpret_cast<const float4*>(xr + head);
    if (lane < head) count(xr[lane], scale, bins, zeros);
    for (int64_t i0 = lane; i0 < n4; i0 += 32 * kShortLoads) {
      float4 v[kShortLoads];
#pragma unroll
      for (int k = 0; k < kShortLoads; ++k) {
        const int64_t i = i0 + 32 * k;
        if (i < n4) v[k] = lgc::load_stream(body + i);
      }
#pragma unroll
      for (int k = 0; k < kShortLoads; ++k) {
        if (i0 + 32 * k < n4) count(v[k], scale, bins, zeros);
      }
    }
    const int64_t t = head + 4 * n4 + lane;         // the 0-3 floats at the end
    if (t < n) count(xr[t], scale, bins, zeros);

    zeros = __reduce_add_sync(0xffffffffu, zeros);
    __syncwarp();                                   // the warp's shared adds are done
    int4 c0 = mine[0], c1 = mine[1];
    if (lane == 0) c0.x += zeros;
    mine[0] = make_int4(0, 0, 0, 0);                // zero for the next row
    mine[1] = make_int4(0, 0, 0, 0);
    int4* out = reinterpret_cast<int4*>(counts + row * lgc::kBins) + 2 * lane;
    out[0] = c0;
    out[1] = c1;
    __syncwarp();                                   // zeroed before the next row counts
  }
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

// x (rows, n), maxabs (rows, n_slices), counts (rows, n_slices, 256).
// offsets: n_slices + 1 int64, increasing from 0 to n.  table: first
// (n_slices + 1 ints, from 0 to n_blocks), then block_slice (n_blocks ints).
// acc: rows x n_slices x 257 ints (256 bins and a counter each), zero, left
// zero.
extern "C" int lgc_histogram_segments(const float* x, int64_t rows, int64_t n,
                                      const int64_t* offsets, const int* table, int n_slices,
                                      int n_blocks, const float* maxabs, int* counts, int* acc,
                                      cudaStream_t stream) {
  if (rows < 1 || rows > 65535 || n < 1 || n_slices < 1 || n_blocks < n_slices) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 blocks(n_blocks, static_cast<unsigned>(rows));
  histogram_segments_kernel<<<blocks, lgc::kThreads, 0, stream>>>(
      x, n, offsets, table, table + n_slices + 1, n_slices, maxabs, acc, counts);
  return static_cast<int>(cudaGetLastError());
}


// The short-row form: x (rows, n), maxabs (rows,), counts (rows, 256), as
// `lgc_histogram` computes them, one warp a row.  counts: 16-byte aligned.
// grid: blocks of the persistent grid (at most kShortBlocksPerSM a SM are
// resident at once).  Any number of rows.
extern "C" int lgc_histogram_short(const float* x, int64_t rows, int64_t n,
                                   const float* maxabs, int* counts, int grid,
                                   cudaStream_t stream) {
  if (rows < 1 || n < 1 || grid < 1 || (reinterpret_cast<uintptr_t>(counts) & 15u)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  histogram_short_kernel<<<grid, lgc::kThreads, 0, stream>>>(x, rows, n, maxabs, counts);
  return static_cast<int>(cudaGetLastError());
}
