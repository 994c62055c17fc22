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
// does).  A subnormal |x| counts as 0, as the reference's flushed max reads it.
//
// With a second input d (`lgc_compress_hist`'s statistics pass) the values are
// u = e + d, added with `add.rn.ftz` as the reference adds, and stored to u as
// they are formed: one pass in place of a separate add.
//
// Bound on the H100: bytes.  The kernel reads each input element once (4 B)
// and does one compare per element; at the largest leaf of the 100M stack
// (28,311,552 elements) that is 113 MB, 0.034 ms at 3.35 TB/s (12 B an element
// with d and u).  To keep that rate each thread issues kLoads independent
// 16-byte streaming loads (`ld.global.nc.L1::no_allocate`) before it reduces
// them, over whole chunks of the grid with no bounds check; the 0-3 floats
// before the first 16-byte boundary, the float4s past the last whole chunk and
// the 0-3 floats at the end are handled apart.  The grid is the resident block
// count (the wrapper passes SMs x 8 blocks of 256 threads, fewer for a short
// vector).
//
// The same kernel takes (M, D) rows (the simulator's batched engine and the
// 100M step: one row per device), row blockIdx.y of a 2-D grid; a flat vector
// is one row.  A row of an odd D starts anywhere modulo 16 bytes, so each row
// takes its own head of 0-3 floats before its float4 body.
//
// Short rows (`lgc_maxabs_short`): where the rows are many and short (the
// sparse path's model-dim views: embed's 64,000 rows of 768 at M = 2, the
// 1.5B's 151,936 rows of 1,536), one block a row leaves most of a block idle
// and every row pays the handshake above.  There a warp owns a row: the
// block holds 8 rows at a time, and a persistent grid (the resident block
// count, fewer for few rows) strides over the rows with an int64 index, so
// there is no limit of 65,535 rows.  Each lane issues all its 16-byte
// streaming loads of a pass (kShortLoads float4s of x, and of d) before it
// reduces them, keeping the per-row head / float4 body / tail scheme; the
// warp reduces with `redux.sync` and one lane stores the row's max.  No
// partials, counter, fence or atomic, and no scratch.
//
// Segments (`lgc_maxabs_segments`): the per-layer budgets of the simulator
// (the reference's `per_layer_candidates_hist`, src/repro/core/compressor.py:
// 341-375) take max |u| of every model-layer slice of every row, where the
// reference calls `maxabs` once per slice (:363).  Here one launch does all
// (row, slice) pairs: grid.y runs over the rows and grid.x over the blocks of
// all slices, each slice getting ceil(length / 4096) of them (at least one,
// at most the flat grid) from a block -> slice table that the wrapper builds
// once per slicing.  A slice is a vector of its own to `maxabs_block` (its
// blocks, partials, counter and output), with the head / float4 body / tail
// scheme above, since a slice starts anywhere modulo 16 bytes.  The reference
// routes only slices of at least PALLAS_MIN_ELEMS floats through its kernel
// and gives the rest to a bit-identical oracle, so routing every slice
// through this one launch computes what it computes (its
// tests/test_kernels.py::TestPerLayerHistParity).  The CNN's slices run from
// 10 to 200,704 floats, so most blocks are a slice's only block and the
// launch is bound by its latency, not by bytes.
#include "common.cuh"

namespace {

constexpr int kLoads = 4;              // independent 16-byte loads per thread

__device__ __forceinline__ unsigned abs_bits(float v) {
  const unsigned b = __float_as_uint(v) & 0x7fffffffu;
  return b < lgc::kMinNormalBits ? 0u : b;
}

__device__ __forceinline__ unsigned abs_bits(float4 v) {
  return max(max(abs_bits(v.x), abs_bits(v.y)), max(abs_bits(v.z), abs_bits(v.w)));
}

__device__ __forceinline__ float4 add_ftz(float4 a, float4 b) {
  return make_float4(lgc::add_ftz(a.x, b.x), lgc::add_ftz(a.y, b.y), lgc::add_ftz(a.z, b.z),
                     lgc::add_ftz(a.w, b.w));
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

// One vector's max over the `nblocks` blocks given to it, this block being
// block `rank` of them (a row's blocks: blockIdx.x of gridDim.x; a slice's:
// its run of the grid's x axis).  partials: the vector's `nblocks` partials.
// kSum: the values are u = x + d, stored to u.  kVec: x, d and u share their
// offset from a 16-byte boundary, so the body moves as float4s.
template <bool kSum, bool kVec>
__device__ __forceinline__ void maxabs_block(const float* __restrict__ x,
                                             const float* __restrict__ d, float* __restrict__ u,
                                             int64_t n, int64_t rank, int64_t nblocks,
                                             unsigned* __restrict__ partials,
                                             int* __restrict__ counter,
                                             unsigned* __restrict__ out) {
  const int64_t tid = rank * blockDim.x + threadIdx.x;
  const int64_t stride = nblocks * blockDim.x;
  auto value = [&](int64_t i) {
    if constexpr (kSum) {
      const float v = lgc::add_ftz(x[i], d[i]);
      u[i] = v;
      return v;
    } else {
      return x[i];
    }
  };

  unsigned m = 0u;
  if constexpr (!kVec) {
    for (int64_t i = tid; i < n; i += stride) m = max(m, abs_bits(value(i)));
  } else {
    const int64_t head = lgc::head_elems(x, n);
    const int64_t n4 = (n - head) / 4;
    const float4* body = reinterpret_cast<const float4*>(x + head);
    const float4* body_d = kSum ? reinterpret_cast<const float4*>(d + head) : nullptr;
    float4* body_u = kSum ? reinterpret_cast<float4*>(u + head) : nullptr;
    const int64_t chunk = stride * kLoads;         // float4s per pass of the grid
    const int64_t whole = n4 / chunk * chunk;

    if (tid < head) m = abs_bits(value(tid));
    for (int64_t i = tid; i < whole; i += chunk) {
      float4 v[kLoads];
#pragma unroll
      for (int k = 0; k < kLoads; ++k) v[k] = lgc::load_stream(body + i + k * stride);
      if constexpr (kSum) {
        float4 w[kLoads];
#pragma unroll
        for (int k = 0; k < kLoads; ++k) w[k] = lgc::load_stream(body_d + i + k * stride);
#pragma unroll
        for (int k = 0; k < kLoads; ++k) {
          v[k] = add_ftz(v[k], w[k]);
          body_u[i + k * stride] = v[k];
        }
      }
#pragma unroll
      for (int k = 0; k < kLoads; ++k) m = max(m, abs_bits(v[k]));
    }
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {             // the float4s past the whole chunks
      const int64_t i = whole + tid + k * stride;
      if (i < n4) {
        float4 v = lgc::load_stream(body + i);
        if constexpr (kSum) {
          v = add_ftz(v, lgc::load_stream(body_d + i));
          body_u[i] = v;
        }
        m = max(m, abs_bits(v));
      }
    }
    const int64_t t = head + 4 * n4 + tid;         // the 0-3 floats at the end
    if (t < n) m = max(m, abs_bits(value(t)));
  }

  __shared__ bool last;
  m = block_max(m);
  if (threadIdx.x == 0) {
    partials[rank] = m;
    __threadfence();                               // the partial is visible before it counts
    last = atomicAdd(counter, 1) == static_cast<int>(nblocks) - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  m = 0u;
  for (int i = threadIdx.x; i < static_cast<int>(nblocks); i += blockDim.x) {
    m = max(m, __ldcg(partials + i));
  }
  m = block_max(m);
  if (threadIdx.x == 0) {
    *out = m;
    *counter = 0;                                  // ready for the next launch
  }
}

// Row blockIdx.y of x (and of d and u), gridDim.x blocks per row, each row
// with its own partials, counter and output; a flat vector is one row.  A
// row's result is an integer max: the same in any grouping of the rows.
template <bool kSum, bool kVec>
__global__ void __launch_bounds__(lgc::kThreads)
maxabs_kernel(const float* __restrict__ x, const float* __restrict__ d, float* __restrict__ u,
              int64_t n, unsigned* __restrict__ partials, int* __restrict__ counters,
              unsigned* __restrict__ out) {
  const int64_t row = blockIdx.y;
  maxabs_block<kSum, kVec>(x + row * n, kSum ? d + row * n : d, kSum ? u + row * n : u, n,
                           blockIdx.x, gridDim.x, partials + row * gridDim.x, counters + row,
                           out + row);
}

// Segments: slice s of row blockIdx.y is x[row, offsets[s]:offsets[s + 1]].
// The grid's x axis runs over all slices' blocks: `first` (n_slices + 1
// ints) gives slice s the blocks first[s] .. first[s + 1] - 1, and
// `block_slice` (gridDim.x ints) names each block's slice.  Each (row,
// slice) has its own run of partials, counter and output.
__global__ void __launch_bounds__(lgc::kThreads)
maxabs_segments_kernel(const float* __restrict__ x, int64_t n,
                       const int64_t* __restrict__ offsets, const int* __restrict__ first,
                       const int* __restrict__ block_slice, int n_slices,
                       unsigned* __restrict__ partials, int* __restrict__ counters,
                       unsigned* __restrict__ out) {
  const int64_t row = blockIdx.y;
  const int s = block_slice[blockIdx.x];
  const int f = first[s];
  const int64_t lo = offsets[s];
  const int64_t rs = row * n_slices + s;
  maxabs_block<false, true>(x + row * n + lo, nullptr, nullptr, offsets[s + 1] - lo,
                            static_cast<int64_t>(blockIdx.x) - f, first[s + 1] - f,
                            partials + row * gridDim.x + f, counters + rs, out + rs);
}

constexpr int kShortLoads = 6;         // float4s of x (and of d) per lane and pass
constexpr int kShortBlocksPerSM = 3;   // resident blocks of the short form a SM

// One row's max of |x| (or of u = x + d, stored to u) in lane `lane` of
// the warp that owns it: each lane's share, not yet reduced over the warp.
template <bool kSum, bool kVec>
__device__ __forceinline__ unsigned row_max_lane(const float* __restrict__ x,
                                                 const float* __restrict__ d,
                                                 float* __restrict__ u, int64_t n,
                                                 int lane) {
  auto value = [&](int64_t i) {
    if constexpr (kSum) {
      const float v = lgc::add_ftz(x[i], d[i]);
      u[i] = v;
      return v;
    } else {
      return x[i];
    }
  };
  unsigned m = 0u;
  if constexpr (!kVec) {
    for (int64_t i = lane; i < n; i += 32) m = max(m, abs_bits(value(i)));
  } else {
    const int64_t head = lgc::head_elems(x, n);
    const int64_t n4 = (n - head) / 4;
    const float4* body = reinterpret_cast<const float4*>(x + head);
    const float4* body_d = kSum ? reinterpret_cast<const float4*>(d + head) : nullptr;
    float4* body_u = kSum ? reinterpret_cast<float4*>(u + head) : nullptr;
    if (lane < head) m = abs_bits(value(lane));
    for (int64_t i0 = lane; i0 < n4; i0 += 32 * kShortLoads) {
      float4 v[kShortLoads];
#pragma unroll
      for (int k = 0; k < kShortLoads; ++k) {
        const int64_t i = i0 + 32 * k;
        v[k] = i < n4 ? lgc::load_stream(body + i) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      if constexpr (kSum) {
        float4 w[kShortLoads];
#pragma unroll
        for (int k = 0; k < kShortLoads; ++k) {
          const int64_t i = i0 + 32 * k;
          w[k] = i < n4 ? lgc::load_stream(body_d + i) : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int k = 0; k < kShortLoads; ++k) {
          const int64_t i = i0 + 32 * k;
          v[k] = add_ftz(v[k], w[k]);
          if (i < n4) body_u[i] = v[k];
        }
      }
#pragma unroll
      for (int k = 0; k < kShortLoads; ++k) m = max(m, abs_bits(v[k]));   // zeros: no-ops
    }
    const int64_t t = head + 4 * n4 + lane;        // the 0-3 floats at the end
    if (t < n) m = max(m, abs_bits(value(t)));
  }
  return m;
}

// Short rows: warp w of the grid owns rows w, w + (warps of the grid), ...
// The row index is the same across a warp, so the whole warp runs each
// row's loop and its reduction.
template <bool kSum, bool kVec>
__global__ void __launch_bounds__(lgc::kThreads, kShortBlocksPerSM)
maxabs_short_kernel(const float* __restrict__ x, const float* __restrict__ d,
                    float* __restrict__ u, int64_t rows, int64_t n,
                    unsigned* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * lgc::kWarps;
  for (int64_t row = static_cast<int64_t>(blockIdx.x) * lgc::kWarps + (threadIdx.x >> 5);
       row < rows; row += warps) {
    const int64_t o = row * n;
    unsigned m = row_max_lane<kSum, kVec>(x + o, kSum ? d + o : d, kSum ? u + o : u, n, lane);
    m = __reduce_max_sync(0xffffffffu, m);
    if (lane == 0) out[row] = m;
  }
}

}  // namespace

// x (rows, n); out (rows,).  partials: rows x grid unsigned ints of scratch;
// counters: `rows` ints, zero, left zero.  grid: blocks per row.  d ==
// nullptr: max |x| of each row.  Otherwise max |u| with u = x + d (flushed)
// written to u (rows, n).
extern "C" int lgc_maxabs(const float* x, const float* d, float* u, int64_t rows, int64_t n,
                          float* out, unsigned* partials, int* counters, int grid,
                          cudaStream_t stream) {
  if (rows < 1 || rows > 65535 || n < 1 || grid < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 blocks(grid, static_cast<unsigned>(rows));
  unsigned* o = reinterpret_cast<unsigned*>(out);
  if (d == nullptr) {
    maxabs_kernel<false, true><<<blocks, lgc::kThreads, 0, stream>>>(x, d, u, n, partials,
                                                                     counters, o);
  } else if (((reinterpret_cast<uintptr_t>(x) ^ reinterpret_cast<uintptr_t>(d)) |
              (reinterpret_cast<uintptr_t>(x) ^ reinterpret_cast<uintptr_t>(u))) & 15u) {
    maxabs_kernel<true, false><<<blocks, lgc::kThreads, 0, stream>>>(x, d, u, n, partials,
                                                                     counters, o);
  } else {
    maxabs_kernel<true, true><<<blocks, lgc::kThreads, 0, stream>>>(x, d, u, n, partials,
                                                                    counters, o);
  }
  return static_cast<int>(cudaGetLastError());
}

// x (rows, n); out (rows, n_slices): max |x| of each (row, slice).  offsets:
// n_slices + 1 int64, increasing from 0 to n.  table: first (n_slices + 1
// ints, from 0 to n_blocks), then block_slice (n_blocks ints).  partials:
// rows x n_blocks unsigned ints of scratch; counters: rows x n_slices ints,
// zero, left zero.
extern "C" int lgc_maxabs_segments(const float* x, int64_t rows, int64_t n,
                                   const int64_t* offsets, const int* table, int n_slices,
                                   int n_blocks, float* out, unsigned* partials, int* counters,
                                   cudaStream_t stream) {
  if (rows < 1 || rows > 65535 || n < 1 || n_slices < 1 || n_blocks < n_slices) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 blocks(n_blocks, static_cast<unsigned>(rows));
  maxabs_segments_kernel<<<blocks, lgc::kThreads, 0, stream>>>(
      x, n, offsets, table, table + n_slices + 1, n_slices, partials, counters,
      reinterpret_cast<unsigned*>(out));
  return static_cast<int>(cudaGetLastError());
}


// The short-row form: x (rows, n), out (rows,), as `lgc_maxabs` computes
// them, one warp a row.  grid: blocks of the persistent grid (at most
// kShortBlocksPerSM a SM are resident at once).  Any number of rows.
extern "C" int lgc_maxabs_short(const float* x, const float* d, float* u, int64_t rows,
                                int64_t n, float* out, int grid, cudaStream_t stream) {
  if (rows < 1 || n < 1 || grid < 1) return static_cast<int>(cudaErrorInvalidValue);
  unsigned* o = reinterpret_cast<unsigned*>(out);
  if (d == nullptr) {
    maxabs_short_kernel<false, true><<<grid, lgc::kThreads, 0, stream>>>(x, d, u, rows, n, o);
  } else if (((reinterpret_cast<uintptr_t>(x) ^ reinterpret_cast<uintptr_t>(d)) |
              (reinterpret_cast<uintptr_t>(x) ^ reinterpret_cast<uintptr_t>(u))) & 15u) {
    maxabs_short_kernel<true, false><<<grid, lgc::kThreads, 0, stream>>>(x, d, u, rows, n, o);
  } else {
    maxabs_short_kernel<true, true><<<grid, lgc::kThreads, 0, stream>>>(x, d, u, rows, n, o);
  }
  return static_cast<int>(cudaGetLastError());
}
