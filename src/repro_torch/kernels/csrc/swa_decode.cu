// swa_decode: one new query token per (batch row, query head) attends to a
// window KV cache of W slots, of which the first length[b] are valid.
//
//   q (B, H, Dh), k and v (B, Kv, W, Dh) with H % Kv == 0, length (B,) int32
//   out[b, h] = softmax(q[b, h] . k[b, h / rep, :len] / sqrt(Dh)) @ v[b, h / rep, :len]
//   with rep = H / Kv; a row with length 0 gives zeros.
//
// Replaces the TPU kernel `_swa_decode_kernel` (src/repro/kernels/swa_attention.py:23,
// launched by `swa_decode` at :73).  It computes the Pallas kernel's function: q, k and
// v taken in f32, the logits scaled by 1/sqrt(f32(Dh)), an online softmax with f32
// weights and an f32 accumulator, acc / max(l, 1e-30), and the output in q's type.  The
// TPU kernel runs one grid step per (b, h) over a GQA-expanded cache, with the whole
// W x Dh tile in VMEM and its chunks in order.
//
// Split-W flash decoding, one launch.  The grid is (B * Kv) x S x ceil(rep / 8): a
// group is one (b, KV head) and up to REP = 8 of the query heads that share it, so each
// K/V row is read from device memory once however many heads read it; S splits of the
// window (whole tiles of 64 slots each, S from `_num_splits` in swa_attention.py, about
// one block per SM) give the card enough blocks: 16 groups x 8 splits of 512 slots =
// 128 blocks at the serve shape.  A block streams its split through a 3-stage ring of K
// and V tiles in shared memory, filled by 16-byte `cp.async` copies, so the next tiles'
// loads are in flight while the current one is reduced.  Rows at or past length are
// zero-filled and never read, so whatever those slots hold cannot reach the output.
// Per tile, in three steps between barriers (no reduction per slot):
//   scores  bf16: warp (16-slot row tile, half of Dh) runs mma.sync m16n8k16 on the
//           tensor cores, K rows by ldmatrix against q held in registers (exact bf16
//           products, f32 sums); f32: thread (slot, quarter of Dh) dots its quarter row
//           with all REP queries on the CUDA cores.  The partial sums meet in shared
//           memory and are added in a fixed order;
//   softmax warp r updates head r's running max and denominator (one max and one sum
//           over the tile's 64 slots) and writes the f32 weights p;
//   P.V     bf16: p = hi + lo, two bf16 terms, each times v on the tensor cores (V by
//           ldmatrix.trans), so the f32 weights are never rounded to bf16 alone; f32:
//           thread (dims 2d, 2d+1, slot group) adds p * v on the CUDA cores.
// Each block then writes its (m, l, acc) in f32 to a scratch, and the last block of the
// group to finish (a fence and a per-group counter, which that block resets to 0)
// merges the S states in split order: the result is the same bits on every launch.
// An empty split (m = -inf) merges with weight 0.
//
// The partial form (`lgc_swa_decode_partial`, PARTIAL = true) is the same launch with
// the same grid and splits.  It writes the output in f32, acc / max(l, 1e-30) before
// the cast to q's type, and the row's softmax state beside it: m, the max of its scaled
// logits (-inf for an empty row), and l, the sum of exp(logit - m) (0 for an empty
// row), as the last block of each group holds them after its merge.  A rank that owns
// a shard of the window's slots computes its partial attention this way, and the
// ranks' states merge as the splits do here (kernels.ref.merge_decode_partials).
// out_f32 cast to q's type is the plain form's output, bit for bit.
//
// Bound on the H100: bytes.  It reads each valid K and V row once.  At the serving shape
// of qwen2-1.5b (B=8, H=12, Kv=2, W=4096, Dh=128, bf16, every slot valid) that is
// 33,554,432 B of K and V plus 49,184 B of q, out and length: 0.01003 ms at 3.35 TB/s.
// The work is 4*B*H*W*Dh = 201 MFLOP, 0.003 ms at the 67 TFLOP/s f32 rate, so the dot
// products must overlap the loads rather than follow them: the tensor cores take them
// off the issue slots, and each block keeps two 32 KB tiles in flight.
#include "common.cuh"

#include <cuda_bf16.h>
#include <math.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;                  // 8 warps
constexpr int kTile = 64;                      // slots per tile (ref.SWA_TILE)
constexpr int kStages = 3;                     // depth of the K/V ring
constexpr int kMaxRep = 8;                     // query heads per block
constexpr int kMaxSplits = 128;                // splits of the window (the merge's weights
                                               // fit in the smallest ring)
constexpr int kQuarters = kThreads / kTile;    // f32 scores: threads per slot
constexpr int kPS = kTile + 8;                 // bf16 row of p hi / lo (144 B: no conflicts)

// bf16 runs both products on the tensor cores; f32 runs them on the CUDA cores.
template <typename T>
constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;

// A K or V tile in shared memory: kTile rows of DH elements, 16-byte chunks swizzled
// so that the 8 rows read by 8 neighbouring lanes fall on 8 different bank groups.  The
// swizzle stays inside an aligned group of 8 chunks (XOR with row & 7), or of 4 chunks
// (XOR with (row >> 1) & 3) for a row's last 4 when they do not fill a group of 8: Dh 96
// has 12 chunks a row in bf16 (8 + 4) and 24 in f32 (3 x 8), and XOR-ing chunks 8-11 with
// up to 7 would land past the row's end.  At Dh 32 / 64 / 128 this is the plain swizzle
// (4 chunks: (row >> 1) & 3; 8, 16 or 32: row & 7).
template <typename T, int DH>
struct Tile {
  static constexpr int kRowBytes = DH * static_cast<int>(sizeof(T));
  static constexpr int kChunks = kRowBytes / 16;          // 4 .. 32
  static constexpr int kFull = kChunks / 8 * 8;           // chunks in whole groups of 8
  static constexpr int kBytes = kTile * kRowBytes;
  static_assert(kChunks - kFull == 0 || kChunks - kFull == 4, "a row's chunks: 8 n or 8 n + 4");
  static __device__ __forceinline__ int offset(int row, int chunk) {
    const int swz = chunk < kFull ? (row & 7) : ((row >> 1) & 3);
    return row * kRowBytes + ((chunk ^ swz) << 4);
  }
};

template <typename T, int DH, int REP>
struct Smem {   // byte offsets in the dynamic shared memory
  static constexpr int kParts = kMma<T> ? 2 : kQuarters;   // partial scores per slot
  static constexpr int kRP = (REP + 3) / 4 * 4;            // f32: row of the weights p
  static constexpr int kRing = kStages * 2 * Tile<T, DH>::kBytes;
  static constexpr int kQ = kRing;                         // f32: q, REP x DH f32
  static constexpr int kPart = kQ + (kMma<T> ? 0 : REP * DH * 4);   // parts x REP x kTile f32
  static constexpr int kP = kPart + kParts * REP * kTile * 4;
  // bf16: p hi and lo, 2 x 16 x kPS bf16; f32: p, kTile x kRP f32
  static constexpr int kStats = kP + (kMma<T> ? 2 * 16 * kPS * 2 : kTile * kRP * 4);
  static constexpr int kBytes = kStats + 3 * kMaxRep * 4;  // corr, m, l
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int src_bytes = valid ? 16 : 0;         // 0: zero-fill, nothing is read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&a)[4], const void* smem) {
  const unsigned p = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(p));
}

__device__ __forceinline__ void ldmatrix_x2_trans(unsigned& b0, unsigned& b1, const void* smem) {
  const unsigned p = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(b0), "=r"(b1)
               : "r"(p));
}

// c += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 out
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// out[0..3] = a / l in out's type
__device__ __forceinline__ void store4(float* p, float4 a, float l) {
  *reinterpret_cast<float4*>(p) = make_float4(a.x / l, a.y / l, a.z / l, a.w / l);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 a, float l) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(a.x / l, a.y / l);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(a.z / l, a.w / l);
  uint2 t;
  t.x = *reinterpret_cast<const unsigned*>(&lo);
  t.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = t;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// part: the splits' states, acc (B*H*S, DH) then m (B*H*S) then l (B*H*S), f32;
// counters: one int per group, zero between launches.
// out: (B, H, DH) in T, or in f32 with PARTIAL, which also writes out_m and out_l (B, H).
template <typename T, int DH, int REP, bool PARTIAL>
__global__ void __launch_bounds__(kThreads, 2)
swa_decode_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const int* __restrict__ length,
                  std::conditional_t<PARTIAL, float, T>* __restrict__ out,
                  float* __restrict__ out_m, float* __restrict__ out_l, float* part,
                  int* counters, int n_heads, int n_kv, int window, int split_len,
                  float scale) {
  using TL = Tile<T, DH>;
  using SM = Smem<T, DH, REP>;
  constexpr bool MMA = kMma<T>;
  // bf16, tensor cores: the scores' k-steps of 16 dims (a warp takes half of them for a
  // 16-slot row tile); P.V's n-tiles of 8 dims, NTW per warp, KW warps (k-parts of the
  // tile's 4 k-steps of 16 slots) per n-tile: NT / NTW x KW = 8 warps (Dh 32: 1 x 2;
  // 64: 1 x 1; 96: 3 x 2; 128: 2 x 1)
  constexpr int KS = DH / 16;
  constexpr int NT = DH / 8;
  constexpr int GCD8 = NT % 8 == 0 ? 8 : NT % 4 == 0 ? 4 : NT % 2 == 0 ? 2 : 1;
  constexpr int NTW = NT / GCD8;
  constexpr int KW = 8 / GCD8;
  // f32, CUDA cores: the scores' elements per thread (a quarter row); P.V's dim pairs
  // and slot groups (Dh 96: 5 groups of 48 threads, the last 16 threads idle)
  constexpr int DQ = DH / kQuarters;
  constexpr int NDP = DH / 2;
  constexpr int G = kThreads / NDP;
  constexpr int NPARTS = MMA ? KW : G;                   // P.V's partial sums per output
  constexpr int RP = SM::kRP;
  constexpr int COPIES = kTile * TL::kChunks / kThreads; // 16-byte copies per thread
  static_assert(kTile * TL::kChunks % kThreads == 0 && DQ % 4 == 0 && REP <= kMaxRep, "");
  static_assert(KS % 2 == 0 && 4 % KW == 0 && NT / NTW * KW == 8, "the warps' shares");
  static_assert(NPARTS * REP * DH * 4 <= SM::kRing && 2 * REP * kMaxSplits * 4 <= SM::kRing,
                "the partial sums and the merge's weights reuse the ring");

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;
  float* sQ = reinterpret_cast<float*>(smem + SM::kQ);
  float* sPart = reinterpret_cast<float*>(smem + SM::kPart);
  float* sP = reinterpret_cast<float*>(smem + SM::kP);
  __nv_bfloat16* sPh = reinterpret_cast<__nv_bfloat16*>(smem + SM::kP);
  __nv_bfloat16* sPl = sPh + 16 * kPS;
  float* sCorr = reinterpret_cast<float*>(smem + SM::kStats);
  float* sM = sCorr + kMaxRep;
  float* sL = sM + kMaxRep;
  __shared__ int s_last;

  const int bk = blockIdx.x;                    // b * n_kv + KV head
  const int split = blockIdx.y;
  const int n_split = gridDim.y;
  const int b = bk / n_kv;
  const int rep = n_heads / n_kv;
  const int r0 = blockIdx.z * REP;              // first query head of the group served
  const int nr = min(REP, rep - r0);
  const int head0 = (bk % n_kv) * rep + r0;     // its index among the H query heads
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int len = min(max(__ldg(length + b), 0), window);
  const int lo = split * split_len;
  const int hi = min(lo + split_len, len);
  const int n_tiles = hi > lo ? (hi - lo + kTile - 1) / kTile : 0;

  const unsigned char* kb =
      reinterpret_cast<const unsigned char*>(k + static_cast<size_t>(bk) * window * DH);
  const unsigned char* vb =
      reinterpret_cast<const unsigned char*>(v + static_cast<size_t>(bk) * window * DH);

  // tile i of the split into ring stage i % kStages; rows at or past hi are zero-filled
  auto issue = [&](int i) {
    if (i < n_tiles) {
      unsigned char* dk = ring + (i % kStages) * 2 * TL::kBytes;
      unsigned char* dv = dk + TL::kBytes;
      const int base = lo + i * kTile;
#pragma unroll
      for (int u = 0; u < COPIES; ++u) {
        const int c = u * kThreads + tid;
        const int row = c / TL::kChunks, chunk = c % TL::kChunks;
        const bool ok = base + row < hi;
        const size_t src = static_cast<size_t>(ok ? base + row : lo) * TL::kRowBytes + chunk * 16;
        const int dst = TL::offset(row, chunk);
        cp_async16(dk + dst, kb + src, ok);
        cp_async16(dv + dst, vb + src, ok);
      }
    }
    cp_async_commit();                          // an empty group keeps the count uniform
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue(i);

  const int mt = warp & 3, kh = warp >> 2;      // bf16 scores: row tile, half of DH
  const int nt0 = warp % (NT / NTW) * NTW;      // bf16 P.V: first n-tile,
  const int kp = warp / (NT / NTW);             // and k-part
  const int sj = tid % kTile, quarter = tid / kTile;   // f32 scores: slot, quarter row
  const int dp = tid % NDP, sg = tid / NDP;            // f32 P.V: dim pair, slot group
  const bool pv = sg < G;                              // f32 P.V: a thread of a slot group
  unsigned bq[KS / 2][2];                       // bf16: B = q^T, pairs of bf16
  float cacc[NTW][4];                           // bf16: the accumulator fragments
  float acc[REP][2];                            // f32: the accumulator
  if constexpr (MMA) {
    const int r = lane >> 2;
    const unsigned* qr = reinterpret_cast<const unsigned*>(
        q + (static_cast<size_t>(b) * n_heads + head0 + min(r, nr - 1)) * DH);
#pragma unroll
    for (int kk = 0; kk < KS / 2; ++kk) {
      const int d = (kh * KS / 2 + kk) * 16 + 2 * (lane & 3);
      bq[kk][0] = r < nr ? __ldg(qr + d / 2) : 0u;
      bq[kk][1] = r < nr ? __ldg(qr + d / 2 + 4) : 0u;
    }
#pragma unroll
    for (int n = 0; n < NTW; ++n) cacc[n][0] = cacc[n][1] = cacc[n][2] = cacc[n][3] = 0.0f;
    // rows of p past nr stay zero
    for (int i = tid; i < 2 * 16 * kPS; i += kThreads) sPh[i] = __float2bfloat16_rn(0.0f);
  } else {
    for (int i = tid; i < REP * DH; i += kThreads) {
      const int r = i / DH;
      sQ[i] = r < nr ? q[(static_cast<size_t>(b) * n_heads + head0 + r) * DH + i % DH] : 0.0f;
    }
#pragma unroll
    for (int r = 0; r < REP; ++r) acc[r][0] = acc[r][1] = 0.0f;
    for (int i = tid; i < kTile * RP; i += kThreads) sP[i] = 0.0f;
  }
  if (tid < kMaxRep) sCorr[tid] = 0.0f;         // heads past nr keep a zero accumulator
  float m_run = -INFINITY, l_run = 0.0f;        // head `warp`'s, in warp `warp`

  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<kStages - 2>();               // tile i has landed
    __syncthreads();                            // and every thread is done with tile i-1
    issue(i + kStages - 1);                     // into the stage tile i-1 used
    const unsigned char* tk = ring + (i % kStages) * 2 * TL::kBytes;
    const unsigned char* tv = tk + TL::kBytes;
    const int n_valid = min(kTile, hi - (lo + i * kTile));

    if constexpr (MMA) {   // scores: the k-steps of half kh, slots mt*16 .. mt*16 + 15
      float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int kk = 0; kk < KS / 2; ++kk) {
        unsigned a[4];
        const int chunk = (kh * KS / 2 + kk) * 2 + (lane >> 4);
        ldmatrix_x4(a, tk + TL::offset(mt * 16 + (lane & 15), chunk));
        mma_bf16(c, a, bq[kk][0], bq[kk][1]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {   // c: slots mt*16 + g (+8), heads 2t, 2t + 1
        const int r = 2 * (lane & 3) + (e & 1);
        if (r < REP) sPart[(kh * REP + r) * kTile + mt * 16 + (lane >> 2) + (e >> 1) * 8] = c[e];
      }
    } else {   // scores: a quarter of slot sj's row against every query head
      float d[REP];
#pragma unroll
      for (int r = 0; r < REP; ++r) d[r] = 0.0f;
#pragma unroll
      for (int c = 0; c < DQ / 4; ++c) {
        const float4 x = *reinterpret_cast<const float4*>(
            tk + TL::offset(sj, quarter * (DQ / 4) + c));
#pragma unroll
        for (int r = 0; r < REP; ++r) {
          const float4 qq = *reinterpret_cast<const float4*>(sQ + r * DH + quarter * DQ + 4 * c);
          d[r] = fmaf(qq.x, x.x, d[r]);
          d[r] = fmaf(qq.y, x.y, d[r]);
          d[r] = fmaf(qq.z, x.z, d[r]);
          d[r] = fmaf(qq.w, x.w, d[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < REP; ++r) sPart[(quarter * REP + r) * kTile + sj] = d[r];
    }
    __syncthreads();

    if (warp < nr) {   // softmax: head `warp` over the tile's slots lane and lane + 32
      const int r = warp;
      float s[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = lane + 32 * h;
        float t = sPart[r * kTile + j];
#pragma unroll
        for (int c = 1; c < SM::kParts; ++c) t += sPart[(c * REP + r) * kTile + j];
        s[h] = j < n_valid ? t * scale : -INFINITY;
      }
      const float m_new = fmaxf(m_run, warp_max(fmaxf(s[0], s[1])));   // finite: slot 0 is valid
      const float corr = expf(m_run - m_new);                           // 0 at the first tile
      float ps = 0.0f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = lane + 32 * h;
        const float p = j < n_valid ? expf(s[h] - m_new) : 0.0f;
        if constexpr (MMA) {    // p = hi + lo, two bf16 terms
          const __nv_bfloat16 p_hi = __float2bfloat16_rn(p);
          sPh[r * kPS + j] = p_hi;
          sPl[r * kPS + j] = __float2bfloat16_rn(p - __bfloat162float(p_hi));
        } else {
          sP[j * RP + r] = p;
        }
        ps += p;
      }
      l_run = l_run * corr + warp_sum(ps);
      m_run = m_new;
      if (lane == 0) sCorr[r] = corr;
    }
    __syncthreads();

    if constexpr (MMA) {   // P.V: (p hi + p lo) x v for n-tiles nt0 .., k-part kp
      const float c = sCorr[lane >> 2];
#pragma unroll
      for (int n = 0; n < NTW; ++n) {
        cacc[n][0] *= c;
        cacc[n][1] *= c;
      }
#pragma unroll
      for (int kk = 0; kk < 4 / KW; ++kk) {
        const int ks = kp * (4 / KW) + kk;      // slots ks*16 .. ks*16 + 15
        unsigned ah[4], al[4];
        const int at = (lane & 15) * kPS + ks * 16 + (lane >> 4) * 8;
        ldmatrix_x4(ah, sPh + at);
        ldmatrix_x4(al, sPl + at);
#pragma unroll
        for (int n = 0; n < NTW; ++n) {
          unsigned b0, b1;
          ldmatrix_x2_trans(b0, b1, tv + TL::offset(ks * 16 + (lane & 15), nt0 + n));
          mma_bf16(cacc[n], ah, b0, b1);
          mma_bf16(cacc[n], al, b0, b1);
        }
      }
    } else {   // P.V: dims 2 dp, 2 dp + 1 of every head over the slots sg, sg + G, ...
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        const float c = sCorr[r];
        acc[r][0] *= c;
        acc[r][1] *= c;
      }
#pragma unroll
      for (int j = pv ? sg : kTile; j < kTile; j += G) {   // rows past n_valid: p = 0, v = 0
        const float2 vv = *reinterpret_cast<const float2*>(
            tv + TL::offset(j, dp / 2) + (dp % 2) * 8);
        float p[RP];
#pragma unroll
        for (int r = 0; r < RP; r += 4) {
          const float4 t = *reinterpret_cast<const float4*>(sP + j * RP + r);
          p[r] = t.x; p[r + 1] = t.y; p[r + 2] = t.z; p[r + 3] = t.w;
        }
#pragma unroll
        for (int r = 0; r < REP; ++r) {
          acc[r][0] = fmaf(p[r], vv.x, acc[r][0]);
          acc[r][1] = fmaf(p[r], vv.y, acc[r][1]);
        }
      }
    }
  }

  cp_async_wait<0>();
  __syncthreads();                              // the ring is free: it holds the sums now
  if (warp < REP && lane == 0) {
    sM[warp] = m_run;
    sL[warp] = l_run;
  }
  float* red = reinterpret_cast<float*>(ring);  // NPARTS x REP x DH
  if constexpr (MMA) {
    const int g = lane >> 2;                    // the fragment's head
    if (g < REP) {
#pragma unroll
      for (int n = 0; n < NTW; ++n) {
        *reinterpret_cast<float2*>(red + (kp * REP + g) * DH + (nt0 + n) * 8 + 2 * (lane & 3)) =
            make_float2(cacc[n][0], cacc[n][1]);
      }
    }
  } else if (pv) {
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      *reinterpret_cast<float2*>(red + (sg * REP + r) * DH + 2 * dp) =
          make_float2(acc[r][0], acc[r][1]);
    }
  }
  __syncthreads();

  // thread tid < nr * DH / 4 owns 4 dims of one head: r = tid / D4, dims 4 d4 .. 4 d4 + 3
  constexpr int D4 = DH / 4;
  const bool owner = tid < nr * D4;
  const int r = tid / D4, d4 = tid % D4;
  const size_t h = static_cast<size_t>(b) * n_heads + head0 + min(r, nr - 1);
  if (owner) {   // the block's sum over its partial sums, in order
    float4 a = *reinterpret_cast<const float4*>(red + r * DH + 4 * d4);
#pragma unroll
    for (int g = 1; g < NPARTS; ++g) {
      const float4 x = *reinterpret_cast<const float4*>(red + (g * REP + r) * DH + 4 * d4);
      a.x += x.x; a.y += x.y; a.z += x.z; a.w += x.w;
    }
    if (n_split == 1) {
      store4(out + h * DH + 4 * d4, a, fmaxf(sL[r], 1e-30f));
    } else {
      reinterpret_cast<float4*>(part + (h * n_split + split) * DH)[d4] = a;
    }
  }
  if (n_split == 1) {
    if constexpr (PARTIAL) {   // the block's own state is the row's
      if (tid < nr) {
        const size_t hh = static_cast<size_t>(b) * n_heads + head0 + tid;
        out_m[hh] = sM[tid];
        out_l[hh] = sL[tid];
      }
    }
    return;
  }
  const size_t nhs = static_cast<size_t>(gridDim.x / n_kv) * n_heads * n_split;
  float* part_m = part + nhs * DH;
  float* part_l = part_m + nhs;
  if (tid < nr) {
    const size_t hh = static_cast<size_t>(b) * n_heads + head0 + tid;
    part_m[hh * n_split + split] = sM[tid];
    part_l[hh * n_split + split] = sL[tid];
  }
  __threadfence();                              // this block's state is visible ...
  __syncthreads();
  const int group = blockIdx.z * gridDim.x + bk;
  if (tid == 0) s_last = atomicAdd(counters + group, 1) == n_split - 1;   // ... before it counts
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  // The last block of the group merges the S states in split order.  The loads of the
  // splits' accumulators (kBatch at a time) go out together with those of their m and l.
  constexpr int kBatch = 16;
  const float4* pa = reinterpret_cast<const float4*>(part + h * n_split * DH) + d4;
  float4 x[kBatch];
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
    x[u] = owner && u < n_split ? __ldcg(pa + u * D4) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float* sW = reinterpret_cast<float*>(ring);   // REP x n_split weights exp(m_s - M)
  float* sLs = sW + REP * kMaxSplits;           // REP x n_split denominators l_s
  for (int i = tid; i < nr * n_split; i += kThreads) {
    const size_t at = (static_cast<size_t>(b) * n_heads + head0 + i / n_split) * n_split +
                      i % n_split;
    sW[i] = __ldcg(part_m + at);
    sLs[i] = __ldcg(part_l + at);
  }
  __syncthreads();
  if (tid < nr) {
    float mx = -INFINITY;
    for (int s = 0; s < n_split; ++s) mx = fmaxf(mx, sW[tid * n_split + s]);
    sM[tid] = mx;
  }
  __syncthreads();
  for (int i = tid; i < nr * n_split; i += kThreads) {
    const float ms = sW[i];
    sW[i] = ms == -INFINITY ? 0.0f : expf(ms - sM[i / n_split]);   // an empty split: 0
  }
  __syncthreads();
  if (tid < nr) {
    float l = 0.0f;
    for (int s = 0; s < n_split; ++s) l += sLs[tid * n_split + s] * sW[tid * n_split + s];
    sL[tid] = l;
    if constexpr (PARTIAL) {   // the merged state: M and l
      const size_t hh = static_cast<size_t>(b) * n_heads + head0 + tid;
      out_m[hh] = sM[tid];
      out_l[hh] = l;
    }
  }
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
  if (owner) {
    const float* w = sW + r * n_split;
    for (int s0 = 0; s0 < n_split; s0 += kBatch) {
      if (s0 > 0) {
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          x[u] = s0 + u < n_split ? __ldcg(pa + (s0 + u) * D4) : make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (s0 + u < n_split) {
          const float wu = w[s0 + u];
          a.x += x[u].x * wu; a.y += x[u].y * wu; a.z += x[u].z * wu; a.w += x[u].w * wu;
        }
      }
    }
  }
  __syncthreads();
  if (owner) store4(out + h * DH + 4 * d4, a, fmaxf(sL[r], 1e-30f));
  if (tid == 0) counters[group] = 0;            // ready for the next launch
}

template <typename T, int DH, int REP, bool PARTIAL>
int launch(const void* q, const void* k, const void* v, const int* length, void* out,
           float* out_m, float* out_l, float* part, int* counters, int batch, int n_heads,
           int n_kv, int window, int splits, cudaStream_t stream) {
  using OutT = std::conditional_t<PARTIAL, float, T>;
  constexpr int smem = Smem<T, DH, REP>::kBytes;
  static unsigned long long attr_set = 0;       // a bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 64 && !(attr_set >> dev & 1ull)) {
    err = cudaFuncSetAttribute(swa_decode_kernel<T, DH, REP, PARTIAL>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set |= 1ull << dev;
  }
  const int rep = n_heads / n_kv;
  const int tiles = (window + kTile - 1) / kTile;
  const int split_len = kTile * ((tiles + splits - 1) / splits);
  const dim3 grid(batch * n_kv, splits, (rep + REP - 1) / REP);
  const float scale = 1.0f / sqrtf(static_cast<float>(DH));
  swa_decode_kernel<T, DH, REP, PARTIAL><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), length,
      static_cast<OutT*>(out), out_m, out_l, part, counters, n_heads, n_kv, window,
      split_len, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DH, bool PARTIAL>
int launch_rep(const void* q, const void* k, const void* v, const int* length, void* out,
               float* out_m, float* out_l, float* part, int* counters, int batch,
               int n_heads, int n_kv, int window, int splits, cudaStream_t stream) {
  const int rep = n_heads / n_kv;
#define SWA_LAUNCH(R)                                                                    \
  launch<T, DH, R, PARTIAL>(q, k, v, length, out, out_m, out_l, part, counters, batch,  \
                            n_heads, n_kv, window, splits, stream)
  if (rep == 1) return SWA_LAUNCH(1);
  if (rep == 2) return SWA_LAUNCH(2);
  if (rep <= 4) return SWA_LAUNCH(4);
  if (rep <= 6) return SWA_LAUNCH(6);
  return SWA_LAUNCH(8);                         // groups of 8 query heads, grid.z of them
#undef SWA_LAUNCH
}

template <typename T, bool PARTIAL>
int launch_dh(const void* q, const void* k, const void* v, const int* length, void* out,
              float* out_m, float* out_l, float* part, int* counters, int batch, int n_heads,
              int n_kv, int window, int head_dim, int splits, cudaStream_t stream) {
#define SWA_DH(D)                                                                         \
  launch_rep<T, D, PARTIAL>(q, k, v, length, out, out_m, out_l, part, counters, batch,   \
                            n_heads, n_kv, window, splits, stream)
  switch (head_dim) {
    case 32: return SWA_DH(32);
    case 64: return SWA_DH(64);
    case 96: return SWA_DH(96);
    case 128: return SWA_DH(128);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SWA_DH
}

}  // namespace

// This file is compiled once a unit (the build passes -DSWA_UNIT=0..3): each unit
// instantiates the kernels of one (dtype, form) pair, 20 of the 80, so four nvcc
// processes share them.  Unit 0 also holds the entry points, which dispatch to the four.
#ifndef SWA_UNIT
#define SWA_UNIT 0
#endif

#define SWA_UNIT_PARAMS                                                                   \
  const void *q, const void *k, const void *v, const int *length, void *out, float *out_m, \
      float *out_l, float *part, int *counters, int batch, int n_heads, int n_kv,         \
      int window, int head_dim, int splits, cudaStream_t stream
#define SWA_UNIT_ARGS                                                                      \
  q, k, v, length, out, out_m, out_l, part, counters, batch, n_heads, n_kv, window,       \
      head_dim, splits, stream

int swa_unit_f32(SWA_UNIT_PARAMS);
int swa_unit_bf16(SWA_UNIT_PARAMS);
int swa_unit_f32_partial(SWA_UNIT_PARAMS);
int swa_unit_bf16_partial(SWA_UNIT_PARAMS);

#if SWA_UNIT == 0
int swa_unit_f32(SWA_UNIT_PARAMS) { return launch_dh<float, false>(SWA_UNIT_ARGS); }
#elif SWA_UNIT == 1
int swa_unit_bf16(SWA_UNIT_PARAMS) { return launch_dh<__nv_bfloat16, false>(SWA_UNIT_ARGS); }
#elif SWA_UNIT == 2
int swa_unit_f32_partial(SWA_UNIT_PARAMS) { return launch_dh<float, true>(SWA_UNIT_ARGS); }
#elif SWA_UNIT == 3
int swa_unit_bf16_partial(SWA_UNIT_PARAMS) {
  return launch_dh<__nv_bfloat16, true>(SWA_UNIT_ARGS);
}
#else
#error "SWA_UNIT must be 0, 1, 2 or 3"
#endif

#if SWA_UNIT == 0
namespace {

template <bool PARTIAL>
int launch_dtype(const void* q, const void* k, const void* v, const int* length, void* out,
                 float* out_m, float* out_l, float* part, int* counters, int batch,
                 int n_heads, int n_kv, int window, int head_dim, int dtype, int splits,
                 cudaStream_t stream) {
  if (batch < 1 || n_kv < 1 || n_heads % n_kv != 0 || n_heads < n_kv || window < 1 ||
      splits < 1 || splits > kMaxSplits || splits > (window + kTile - 1) / kTile ||
      static_cast<int64_t>(batch) * n_kv > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 0) {
    return PARTIAL ? swa_unit_f32_partial(SWA_UNIT_ARGS) : swa_unit_f32(SWA_UNIT_ARGS);
  }
  if (dtype == 1) {
    return PARTIAL ? swa_unit_bf16_partial(SWA_UNIT_ARGS) : swa_unit_bf16(SWA_UNIT_ARGS);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out alike).  part: B*H*splits*(Dh+2)
// floats of scratch; counters: B*Kv*ceil(rep/8) ints, zero, left zero by the launch.
extern "C" int lgc_swa_decode(const void* q, const void* k, const void* v, const int* length,
                              void* out, float* part, int* counters, int batch, int n_heads,
                              int n_kv, int window, int head_dim, int dtype, int splits,
                              cudaStream_t stream) {
  return launch_dtype<false>(q, k, v, length, out, nullptr, nullptr, part, counters, batch,
                             n_heads, n_kv, window, head_dim, dtype, splits, stream);
}

// The partial form: out (B, H, Dh) f32 whatever q's type, out_m and out_l (B, H) f32;
// the rest as lgc_swa_decode.
extern "C" int lgc_swa_decode_partial(const void* q, const void* k, const void* v,
                                      const int* length, float* out, float* out_m,
                                      float* out_l, float* part, int* counters, int batch,
                                      int n_heads, int n_kv, int window, int head_dim,
                                      int dtype, int splits, cudaStream_t stream) {
  return launch_dtype<true>(q, k, v, length, out, out_m, out_l, part, counters, batch,
                            n_heads, n_kv, window, head_dim, dtype, splits, stream);
}
#endif  // SWA_UNIT == 0
