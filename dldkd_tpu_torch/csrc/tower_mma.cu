// The encoder towers on Hopper's tensor cores, in bf16 and in f32: the
// input normalization, every matrix product with the LayerNorms and the
// query tower's pooling in their epilogues, and the attention of the chain
// described in csrc/tower.cu, whose int8 epilogue both dtypes keep.
//
// Replaces, with those, dldkd_tpu/ops/pallas/query_tower.py:
//   _dual_query_tower_kernel (:211), _query_tower_kernel (:196)
//   _dual_context_tower_kernel (:246), _context_tower_kernel (:229)
// whose trunk (_trunk_from_xn, :70-118) runs every product and the
// attention on the MXU with f32 accumulation.
//
// Arithmetic, one template per kernel, two policies:
// - Bf16: bf16 operands, f32 accumulation (wgmma m64n128k16 for the
//   products, mma.sync m16n8k16 for the attention). A bf16 product is exact
//   in f32, so only the order of the f32 sums differs from the plain version
//   (ops/kernels/query_tower.py:tower_plain).
// - Tf32: f32 operands in 3xTF32 (wgmma m64n128k8 tf32 for the products,
//   mma.sync m16n8k8 tf32 for the attention). The Pallas trunk's
//   dot_generals carry no precision of their own, so in f32 they run at the
//   process's "highest", not as IEEE f32 FMAs; 3xTF32 is the f32-grade
//   counterpart here, as in csrc/sim_max_mma.cu: each operand x splits into
//   big = tf32_big(x) and small = x - big (wgmma.cuh), and a product is
//   small.big + big.small + big.big (small.small, below 2^-22 of it,
//   dropped). The chain's buffers hold plain f32; a product splits each
//   ring stage in shared memory once it lands, the attention its register
//   fragments.
//
// What bounds it on an H100: operations. One video-tower launch at the
// serving shapes (200 videos x 128 frames, 1024 -> 384, both branches) is
// about 126 GFLOP against 105 MB of f32 input: bf16 0.127 ms at 989
// TFLOP/s; f32 three TF32 products, 3 x 126 GFLOP at 495 TFLOP/s = 0.76
// ms, against 0.031 ms of bytes. A query-tower launch (50 queries x 32
// tokens) is 5.8 GFLOP: 0.006 ms in bf16, 0.035 ms in f32; there the
// chain's launches set the floor.
//
// What the design does about it (the chain is csrc/tower.cu's, steps
// numbered as there):
//   1. normalize      the input LayerNorm (f32 statistics; bf16: of the
//                     input rounded to bf16) written out once in the tower
//                     dtype at the padded width (zeros past D). One warp
//                     per row; bytes-bound.
//   2/3/5/6. products C = epilogue(A (M x K) W^T (N x K)^T), both operands
//                     K-major (the packer stores W transposed once per
//                     eval), batched over branches (blockIdx.z). A ring of
//                     stages of 128 bytes per row (64 bf16 or 32 f32 values)
//                     filled by 16-byte cp.async copies in the 128-byte
//                     swizzle streams the depth (mma_tile); each warpgroup
//                     runs wgmma m64n128 from shared memory into 64 f32
//                     accumulators per thread. bf16: 3 stages. f32: 2
//                     stages, each split once it lands (big in place, small
//                     into a scratch tile of the same layout) and then taken
//                     by three wgmma per 8 values of depth. Split planes
//                     stored by the chain would double what each stage
//                     copies, and the copies from L2 bound these products.
//                     Depth past K and rows past M or N are zero-filled, not
//                     read. Epilogue in registers and through shared memory
//                     at the Pallas kernel's rounding points (identity in
//                     f32): + bias, ReLU, round; + pos[m % period] (rows
//                     below pos_rows), round; + residual, round.
//     3, 6 gemm_mma   a block of 64 or 128 rows (one warpgroup per 64) x
//                     128 columns; bf16 128-row blocks when they still give
//                     two blocks per SM; f32 128-row blocks, 97 KB, two
//                     blocks per SM, so one block's split overlaps the
//                     other's products; written in 16-byte rows.
//     2, 5 gemm_rows  the same blocks, as a thread block cluster over all
//                     128-column tiles of one branch: the epilogue goes on
//                     to the LayerNorm of the cluster's rows, read across
//                     the cluster's row tiles in shared memory (in L2 above
//                     8 x 128 columns), and writes each value once; in the
//                     query tower step 5 also pools the cluster's whole
//                     sequences (two or four queries of 32 tokens in 64 or
//                     128 rows; a longer sequence's row tiles in turn) and
//                     writes only the pooled vectors.
//   4. attention_mma  one block per (head, query tile, sequence, branch),
//                     one warp per 16 query rows of the tile (32 rows up to
//                     L = 32, else 128, or 64 above 128 dims per head). The
//                     tile's Q stays in shared memory; K and V stream
//                     through it in key tiles, so any L fits (the
//                     positional table's). Per key tile: S = Q K^T by
//                     mma.sync, scale and key mask in f32. bf16: one key
//                     tile of the query tile's size while L fits, the rows'
//                     max and sum from S in registers, p = round_bf16(e /
//                     sum) (the Pallas kernel casts the softmax before
//                     P V, :107), then P V with P's accumulators reused as
//                     A fragments; above that a first pass over the key
//                     tiles takes each row's max and sum, a second
//                     recomputes S and accumulates P V with p formed as
//                     above, so the rounding point holds. f32: key tiles
//                     of 32 and an online softmax (P V of e, rescaled as
//                     the row's max grows, divided by the sum at the end),
//                     which keeps S and P in few registers. An all-masked
//                     row stays finite. Head dims up to 256.
// Shapes: every width the chain sees is a multiple of 8 (the wrappers pad
// input width, hidden size and head dims with zeros inside the packed
// operands and the chain's buffers), so every row copy is whole 16-byte
// units.
// What it leaves unused: TMA, warp specialisation, a wgmma kept in flight
// across stages, and one kernel for the whole chain; the intermediates
// between launches go through device memory (L2 for the query tower).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include "wgmma.cuh"

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

constexpr float NEG_BIG = -10000.0f;  // additive attention key mask
constexpr float NEG_INF = -1e10f;     // pooling mask (mask_logits)
constexpr float LN_EPS = 1e-5f;

__device__ __forceinline__ float rt(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T narrow(float x);
template <> __device__ __forceinline__ float narrow<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ bf16 narrow<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The two arithmetics. SPLIT: f32 operands split into TF32 big and small
// parts for 3xTF32 products. STAGES: the GEMM's ring; f32 takes two, so
// that its 128-row blocks (with the split's scratch tile, 97 KB) fit twice
// per SM and one block's split and barriers overlap the other's products.
struct Bf16 {
  using T = bf16;
  static constexpr bool SPLIT = false;
  static constexpr int STAGES = 3;
  static __device__ __forceinline__ float round(float x) { return rt(x); }
};

struct Tf32 {
  using T = float;
  static constexpr bool SPLIT = true;
  static constexpr int STAGES = 2;
  static __device__ __forceinline__ float round(float x) { return x; }
};

// ---------------------------------------------------------------------------
// 1. xn = round((round(x) - mu) * rstd), mu and rstd the f32 statistics
// (E[x^2] - mu^2, eps 1e-5) of round(x) over the D values of a row; y rows of
// ldy (ldy % 8 == 0), zeros past D. One warp per row.
// ---------------------------------------------------------------------------
template <typename P>
__global__ void normalize_kernel(const float* __restrict__ x,
                                 typename P::T* __restrict__ y, int M, int D,
                                 int ldy) {
  using T = typename P::T;
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= M) return;
  const float* xr = x + (size_t)row * D;
  const bool vec = (D & 3) == 0;  // rows of whole float4s (x 16-byte aligned)
  float s = 0.f, ss = 0.f;
  if (vec) {
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    for (int k = lane; k < D / 4; k += 32) {
      const float4 v = x4[k];
      const float a[4] = {P::round(v.x), P::round(v.y), P::round(v.z),
                          P::round(v.w)};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s += a[j];
        ss = fmaf(a[j], a[j], ss);
      }
    }
  } else {
    for (int k = lane; k < D; k += 32) {
      const float a = P::round(xr[k]);
      s += a;
      ss = fmaf(a, a, ss);
    }
  }
  s = warp_sum(s);
  ss = warp_sum(ss);
  const float mu = s / D;
  const float rstd = 1.0f / sqrtf(ss / D - mu * mu + LN_EPS);
  for (int k = lane; k < ldy / 4; k += 32) {
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (vec && 4 * k < D) {
      const float4 a = reinterpret_cast<const float4*>(xr)[k];
      v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (4 * k + j < D) v[j] = xr[4 * k + j];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[j] = 4 * k + j < D ? (P::round(v[j]) - mu) * rstd : 0.f;
    const size_t o = (size_t)row * ldy + 4 * k;
    if constexpr (P::SPLIT) {
      *reinterpret_cast<float4*>(y + o) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
      __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
      __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
      uint2 out;
      out.x = *reinterpret_cast<uint32_t*>(&lo);
      out.y = *reinterpret_cast<uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(y + o) = out;
    }
  }
}

// ---------------------------------------------------------------------------
// 2/3/5/6. C[b] = epilogue(A[b] (M x K) @ W[b]^T), W[b] stored (N x K), all
// in the tower dtype. Epilogue, in order: + bias[n] (f32); ReLU; round;
// + pos[m % pos_period][n] (f32 holding tower-dtype values) where
// m % pos_period < pos_rows, round; + res[m][n], round. Strides in
// elements; per-batch strides sa .. sr.
//
// Whole-row mode (gemm_rows_kernel, steps 2 and 5): the columns fall in
// groups of gs (one branch's padded hidden width; the projection's N holds
// every branch's group, the output product's one per batch), and after that
// epilogue each row of each group is layer-normalized over its first H
// columns: y = round((x - mu) * rstd * gamma[n] + beta[n]), gamma and beta
// f32 at gamma + b sg + n (zeros past H). With L > 0 (the query tower's
// step 5) the rows are Nseq = M / L sequences of L rows, and the LayerNorm's
// rows are pooled instead of stored: logits = y . wm (wm f32 at wm + b sg),
// -1e10 where mask[seq][l] == 0, softmax over the sequence, pooled[b][seq]
// = sum over l of y * p, f32 (batch, Nseq, H).
// ---------------------------------------------------------------------------
struct MmaArgs {
  const void* a; const void* w; const float* bias; void* c;
  const float* pos; const void* res;
  const float* gamma; const float* beta;           // whole-row mode
  const float* wm; const float* mask; float* pooled;  // ... with pooling
  int M, N, K;
  int lda, ldw, ldc, ldp, ldr;
  int sa, sw, sb, sc, sr, sg;
  int relu, pos_period, pos_rows;
  int gs, H, L;
};

constexpr int BN = 128;  // columns per block: wgmma's N
constexpr int KSTEPS = ROW_BYTES / 32;  // one wgmma takes 32 bytes of depth
constexpr int TLD = BN + 8;  // epilogue tile row: a row's 8 lanes (bf16x2)
                             // or a half-warp's 16 (f32x2) hit distinct banks

// the ring's stages of 64 WG rows of A and 128 rows of W, and for Tf32 the
// scratch tile of one stage's small parts
template <typename P, int WG>
__host__ __device__ constexpr int ring_bytes() {
  return (P::STAGES + (P::SPLIT ? 1 : 0)) * (64 * WG + BN) * ROW_BYTES;
}

template <typename P, int WG>
constexpr int gemm_smem() {
  return 1024 + ring_bytes<P, WG>();
}

// acc (the calling warpgroup's 64 x 128 accumulators) = A rows [m0, m0 +
// 64 WG) times W rows [n0, n0 + 128) over depth K, through the ring at
// shared address `ring` (ring_p: its generic address); warpgroup wg takes
// rows 64 wg. A rows at or past m_end, W rows at or past n_end and depth
// past K are zero-filled, not read. Returns with every copy landed and
// every wgmma done; the ring is free once the block has passed a barrier.
template <typename P, int WG>
__device__ __forceinline__ void mma_tile(float (&acc)[64],
                                         const typename P::T* A, int lda,
                                         int m0, int m_end,
                                         const typename P::T* W, int ldw,
                                         int n0, int n_end, int K,
                                         uint32_t ring,
                                         unsigned char* ring_p) {
  using T = typename P::T;
  constexpr int BM = 64 * WG, STAGES = P::STAGES, THREADS = WG * 128;
  constexpr int BK = ROW_BYTES / (int)sizeof(T);  // depth per stage
  constexpr int UV = 16 / (int)sizeof(T);         // values per 16 bytes
  constexpr int A_BYTES = BM * ROW_BYTES, STAGE = (BM + BN) * ROW_BYTES;
  const uint32_t scratch = ring + STAGES * STAGE;  // Tf32: small parts
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int nk = (K + BK - 1) / BK;

  // rows [0, BM) of a stage are A's, rows [BM, BM + BN) W's; each row is
  // 8 units of 16 bytes, K % 8 == 0 so a unit is whole or absent
  auto load = [&](int kc) {
    const uint32_t st = ring + (kc % STAGES) * STAGE;
    const int k0 = kc * BK;
    for (int e = tid; e < (BM + BN) * 8; e += THREADS) {
      const int r = e >> 3, u = e & 7, k = k0 + u * UV;
      const bool is_a = r < BM;
      const int rr = is_a ? r : r - BM;
      const int row = (is_a ? m0 : n0) + rr;
      const bool ok = k < K && row < (is_a ? m_end : n_end);
      const T* src = is_a ? A + (size_t)row * lda + k
                          : W + (size_t)row * ldw + k;
      cp16(st + (is_a ? 0 : A_BYTES) + swz(rr, u), ok ? src : A,
           ok ? 16 : 0);
    }
  };

  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(s);
    cp_commit();
  }

#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int kc = 0; kc < nk; ++kc) {
    cp_wait<STAGES - 2>();
    proxy_fence();
    // stage kc landed; stage kc - 1's slot and the scratch tile are free
    __syncthreads();
    if (kc + STAGES - 1 < nk) load(kc + STAGES - 1);
    cp_commit();
    const uint32_t st = ring + (kc % STAGES) * STAGE;
    if constexpr (P::SPLIT) {
      // split the stage: big in place, small into the scratch tile at the
      // same offset (the swizzle is a byte layout)
      unsigned char* slot = ring_p + (kc % STAGES) * STAGE;
      unsigned char* small = ring_p + STAGES * STAGE;
      for (int o = tid * 16; o < STAGE; o += THREADS * 16) {
        const float4 x = *reinterpret_cast<const float4*>(slot + o);
        const float4 big = make_float4(tf32_big(x.x), tf32_big(x.y),
                                       tf32_big(x.z), tf32_big(x.w));
        *reinterpret_cast<float4*>(slot + o) = big;
        *reinterpret_cast<float4*>(small + o) = make_float4(
            x.x - big.x, x.y - big.y, x.z - big.z, x.w - big.w);
      }
      proxy_fence();
      __syncthreads();
    }
    const uint32_t a = st + wg * 64 * ROW_BYTES, b = st + A_BYTES;
    const uint32_t as = a - st + scratch, bs = b - st + scratch;
    acc_fence(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      const int first = kc == 0 && ks == 0;
      if constexpr (P::SPLIT) {  // small.big + big.small + big.big
        wgmma_tf32(acc, desc(as + ks * 32), desc(b + ks * 32), !first);
        wgmma_tf32(acc, desc(a + ks * 32), desc(bs + ks * 32), 1);
        wgmma_tf32(acc, desc(a + ks * 32), desc(b + ks * 32), 1);
      } else {
        wgmma_bf16(acc, desc(a + ks * 32), desc(b + ks * 32), !first);
      }
    }
    wgmma_commit();
    wgmma_wait();  // before the slot is refilled and the epilogue reads
    acc_fence(acc);
  }
  cp_wait<0>();
}

// The epilogue's first pass: a warpgroup's accumulators + bias[col0 +
// column] (f32), ReLU, rounded to T, into its 64 rows of the tile (rows of
// ld values). Columns at or past n_end get no bias (N % 8 == 0: a pair is
// whole or absent).
template <typename P>
__device__ __forceinline__ void acc_to_tile(const float (&acc)[64],
                                            typename P::T* tile, int ld,
                                            const float* bias, int col0,
                                            int n_end, int relu) {
  using T = typename P::T;
  const int tid = threadIdx.x, lane = tid & 31;
  const int wq = (tid >> 5) & 3;  // the warp's 16 rows of the 64
#pragma unroll
  for (int t = 0; t < BN / 8; ++t) {
    const int cl = t * 8 + (lane & 3) * 2;
    const bool in = col0 + cl < n_end;
    const float b0 = bias && in ? bias[col0 + cl] : 0.f;
    const float b1 = bias && in ? bias[col0 + cl + 1] : 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v0 = acc[4 * t + 2 * h], v1 = acc[4 * t + 2 * h + 1];
      if (bias) {
        v0 += b0;
        v1 += b1;
      }
      if (relu) {
        v0 = fmaxf(v0, 0.f);
        v1 = fmaxf(v1, 0.f);
      }
      const int rl = wq * 16 + (lane >> 2) + 8 * h;
      T* dst = tile + rl * ld + cl;
      if constexpr (P::SPLIT) {
        *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(dst) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

// The epilogue's second pass on 16 bytes (UV columns) of row `row`, column
// `col` (of the whole product): + pos where the row has a positional row,
// round; + res, round.
template <typename P>
__device__ __forceinline__ void add_pos_res(float* v, const MmaArgs& g,
                                            const typename P::T* R, int row,
                                            int col) {
  using T = typename P::T;
  constexpr int UV = 16 / (int)sizeof(T);
  if (g.pos) {
    const int prow = row % g.pos_period;
    if (prow < g.pos_rows) {
      const float4* p = reinterpret_cast<const float4*>(
          g.pos + (size_t)prow * g.ldp + col);
#pragma unroll
      for (int q = 0; q < UV / 4; ++q) {
        const float4 pq = p[q];
        const float pv[4] = {pq.x, pq.y, pq.z, pq.w};
#pragma unroll
        for (int j = 0; j < 4; ++j)
          v[4 * q + j] = P::round(v[4 * q + j] + pv[j]);
      }
    }
  }
  if (R) {
    const uint4 rr = *reinterpret_cast<const uint4*>(
        R + (size_t)row * g.ldr + col);
    const T* rv = reinterpret_cast<const T*>(&rr);
#pragma unroll
    for (int j = 0; j < UV; ++j) v[j] = P::round(v[j] + widen(rv[j]));
  }
}

template <typename T>
__device__ __forceinline__ void load16(float* v, const T* p) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const T* tv = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int j = 0; j < 16 / (int)sizeof(T); ++j) v[j] = widen(tv[j]);
}

template <typename T>
__device__ __forceinline__ void store16(T* p, const float* v) {
  uint4 out;
  T* ov = reinterpret_cast<T*>(&out);
#pragma unroll
  for (int j = 0; j < 16 / (int)sizeof(T); ++j) ov[j] = narrow<T>(v[j]);
  *reinterpret_cast<uint4*>(p) = out;
}

// N f32 values from 16-byte aligned p (N % 4 == 0)
template <int N>
__device__ __forceinline__ void load_f32(float (&v)[N], const float* p) {
#pragma unroll
  for (int q = 0; q < N / 4; ++q) {
    const float4 x = reinterpret_cast<const float4*>(p)[q];
    v[4 * q] = x.x, v[4 * q + 1] = x.y, v[4 * q + 2] = x.z,
    v[4 * q + 3] = x.w;
  }
}

template <typename P, int WG>
__global__ void __launch_bounds__(WG * 128)
gemm_mma_kernel(MmaArgs g) {
  using T = typename P::T;
  constexpr int BM = 64 * WG, THREADS = WG * 128;
  constexpr int UV = 16 / (int)sizeof(T);  // values per 16 bytes
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw_s = smem_u32(smem_raw);
  const uint32_t ring = (raw_s + 1023) & ~1023u;
  unsigned char* ring_p = smem_raw + (ring - raw_s);

  const int tid = threadIdx.x;
  const int bz = blockIdx.z;
  const T* A = (const T*)g.a + (size_t)bz * g.sa;
  const T* W = (const T*)g.w + (size_t)bz * g.sw;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  float acc[64];
  mma_tile<P, WG>(acc, A, g.lda, m0, g.M, W, g.ldw, n0, g.N, g.K, ring,
                  ring_p);

  // epilogue in two passes through the ring, now free: bias, ReLU and the
  // rounding from the accumulators into a tile (the warpgroup's 64 rows);
  // then positions and residual, 16 bytes (UV columns) per thread, from
  // the tile to C
  proxy_fence();
  __syncthreads();
  T* tile = reinterpret_cast<T*>(ring_p);
  const float* bias = g.bias ? g.bias + (size_t)bz * g.sb : nullptr;
  acc_to_tile<P>(acc, tile + (tid >> 7) * 64 * TLD, TLD, bias, n0, g.N,
                 g.relu);
  __syncthreads();

  const T* R = g.res ? (const T*)g.res + (size_t)bz * g.sr : nullptr;
  T* C = (T*)g.c + (size_t)bz * g.sc;
  for (int e = tid; e < BM * (BN / UV); e += THREADS) {
    const int rl = e / (BN / UV), cl = (e % (BN / UV)) * UV;
    const int row = m0 + rl, col = n0 + cl;
    if (row >= g.M || col >= g.N) continue;
    float v[UV];
    load16(v, tile + rl * TLD + cl);
    add_pos_res<P>(v, g, R, row, col);
    store16(C + (size_t)row * g.ldc + col, v);
  }
}

// ---------------------------------------------------------------------------
// 2 and 5. The whole-row mode. The LayerNorm needs all of a row's columns
// in one group (one branch), so a thread block cluster owns them: its CL
// blocks (one per 128-column tile of the group, at most 8) are the blocks
// of gemm_mma_kernel, the same 64 or 128 rows x 128 columns, the same ring
// and wgmma m64n128 sums in the same order, so the rows reaching the
// LayerNorm are bitwise those a column-tiled product writes, and as many
// blocks fit an SM (a ring of 97 KB, and a staging row a warp: two). Grid:
// (groups x CL, row
// blocks, batch), clusters (CL, 1, 1). Why clusters and not one block over
// the whole row: 64 rows x 384 columns of f32 accumulators are 96 KB of
// registers, so such a block runs alone on its SM and nothing hides its
// loads, barriers and epilogue (measured on the H100: the whole-row product
// took twice the column-tiled one's time).
//
// Per row tile: each block runs its product and the epilogue's two passes
// (acc_to_tile, add_pos_res) into its row tile at the ring's start; then
// the cluster syncs and each row's LayerNorm statistics are taken by one
// warp of one block (rows dealt round the cluster), reading the row across
// the cluster's tiles through distributed shared memory (copied into a
// staging row, 16 bytes a lane, then read in the sums' order): f32 sums of
// the
// rounded values over the first H columns, lane l taking columns l, l + 32,
// ... (s += v, ss = fma(v, v, ss)), a butterfly over the lanes (xor 16 ..
// 1), mu = s / H, rstd = 1 / sqrt(fma(-mu, mu, ss / H) + 1e-5), written
// into every block's statistics; after a second sync each block normalizes
// its own columns, y = round(fma((x - mu) rstd, gamma, beta)), 16 bytes a
// thread, to C. Every step is written with its rounding (__fmaf_rn, ...):
// the compiler contracts nothing, and these are the separate LayerNorm
// pass's own roundings, so its outputs come out bitwise.
// A group wider than 8 x 128 columns takes its tiles in passes, its rows
// through C (in L2) instead of the row tiles.
//
// Pooling (L > 0): a block owns floor(BM / L) whole sequences (two or four
// queries of 32 tokens), or, for L > BM, one sequence whose row tiles it
// walks. The LayerNorm's rows stay in the row tiles when the cluster has
// one pass and L <= 64 (so at any BM), else they go to C's rows (in L2) as
// scratch. After a sync, each row's logit is taken as its statistics were,
// across the cluster (lane d takes d, d + 32, ..., s = fma(y, wm, s), the
// butterfly), -1e10 where masked, and written into every block; after the
// last tile every block takes each sequence's softmax on its own copy (one
// warp a sequence: max and sum over lanes l, l + 32, ..., butterflies; p =
// e / sum) and its own columns' weighted sums (one thread a (sequence,
// column): sum over l in order of fma(y, p, acc), f32) to pooled. C is then
// needed only as that scratch. tests/test_torch_tower_fused.py emulates
// these sums in these orders. A block touches another's shared memory only
// between two cluster syncs, so none exits while another reads it.
// ---------------------------------------------------------------------------
constexpr int ROWS_MAX_CL = 8;  // blocks a cluster: the portable limit

__host__ __device__ constexpr int rows_tiles(int gs) {
  return (gs + BN - 1) / BN;
}

__host__ __device__ constexpr int rows_cluster(int gs) {
  return rows_tiles(gs) < ROWS_MAX_CL ? rows_tiles(gs) : ROWS_MAX_CL;
}

__host__ __device__ constexpr int rows_passes(int gs) {
  return (rows_tiles(gs) + ROWS_MAX_CL - 1) / ROWS_MAX_CL;
}

// pooling keeps the LayerNorm's rows in the row tiles: one pass, and
// sequences of at most 64 rows (whole in a block of 64 or 128 rows)
__host__ __device__ constexpr bool rows_pool_in_smem(int gs, int L) {
  return rows_passes(gs) == 1 && L <= 64;
}

// the logits a block holds (a whole number of 16 bytes): its rows, or its
// sequence's L rows
__host__ __device__ constexpr int rows_logits(int L, int bm) {
  return L > 0 ? ((L > bm ? L : bm) + 3) / 4 * 4 : 0;
}

// With one pass a warp stages rows of the group's gs values: in the ring
// after the row tile where they fit (the ring is idle once the product is
// done), else after the logits
template <typename P, int WG>
__host__ __device__ constexpr bool rows_stage_in_ring(int gs) {
  return 4 * WG * gs * (int)sizeof(typename P::T) <=
         ring_bytes<P, WG>() - 64 * WG * TLD * (int)sizeof(typename P::T);
}

// dynamic shared memory of gemm_rows_kernel<P, WG>: the ring (the row tile
// in it), the rows' statistics, the logits, the staging rows if not in the
// ring
template <typename P, int WG>
constexpr int rows_smem(int gs, int L) {
  return 1024 + ring_bytes<P, WG>() + 64 * WG * 8 +
         4 * rows_logits(L, 64 * WG) +
         (rows_passes(gs) == 1 && !rows_stage_in_ring<P, WG>(gs)
              ? 4 * WG * gs * (int)sizeof(typename P::T)
              : 0);
}

// as many blocks an SM as the column-tiled product: 128 registers a
// thread for 128-row blocks (one more would leave one block an SM), 170
// for 64-row blocks (three)
template <typename P, int WG>
__global__ void __launch_bounds__(WG * 128, WG == 1 ? 3 : 2)
gemm_rows_kernel(MmaArgs g) {
  using T = typename P::T;
  constexpr int BM = 64 * WG, THREADS = WG * 128, NWARPS = THREADS / 32;
  constexpr int UV = 16 / (int)sizeof(T);  // values per 16 bytes
  constexpr int UNITS = BN / UV;           // 16-byte units of a tile row
  constexpr int RING = ring_bytes<P, WG>();
  static_assert(BM * TLD * (int)sizeof(T) <= RING,
                "the row tile lives in the ring");
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw_s = smem_u32(smem_raw);
  const uint32_t ring = (raw_s + 1023) & ~1023u;
  unsigned char* ring_p = smem_raw + (ring - raw_s);
  T* tile = reinterpret_cast<T*>(ring_p);
  float2* stats = reinterpret_cast<float2*>(ring_p + RING);  // (mu, rstd)
  float* att = reinterpret_cast<float*>(stats + BM);  // the block's logits
  T* stage = (rows_stage_in_ring<P, WG>(g.gs)
                  ? reinterpret_cast<T*>(ring_p + BM * TLD * sizeof(T))
                  : reinterpret_cast<T*>(att + rows_logits(g.L, BM))) +
             (threadIdx.x >> 5) * g.gs;  // the warp's staging row

  cg::cluster_group cluster = cg::this_cluster();
  const int cl = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bz = blockIdx.z, n0 = (blockIdx.x / cl) * g.gs;  // the group
  const T* A = (const T*)g.a + (size_t)bz * g.sa;
  const T* W = (const T*)g.w + (size_t)bz * g.sw;
  const T* R = g.res ? (const T*)g.res + (size_t)bz * g.sr : nullptr;
  T* C = g.c ? (T*)g.c + (size_t)bz * g.sc + n0 : nullptr;
  const float* bias = g.bias ? g.bias + (size_t)bz * g.sb : nullptr;
  const float* gamma = g.gamma + (size_t)bz * g.sg + n0;
  const float* beta = g.beta + (size_t)bz * g.sg + n0;
  const bool pool = g.L > 0;
  const int seqs = pool ? (g.L <= BM ? BM / g.L : 1) : 0;
  const int r0 = blockIdx.y * (pool ? seqs * g.L : BM);
  const int r1 = min(g.M, r0 + (pool ? seqs * g.L : BM));
  const int passes = rows_passes(g.gs);
  const bool keep = pool && rows_pool_in_smem(g.gs, g.L);

  for (int m0 = r0; m0 < r1; m0 += BM) {
    const int rows = min(BM, r1 - m0);
    // the values of row rl, from the cluster's row tiles (tiles) or from
    // C: with one pass, copied into the warp's staging row 16 bytes a lane
    // (a few wide copies from the other blocks instead of a load a value),
    // then read from there (at); with several, read from C in place. Reads
    // of C that other blocks wrote go to L2 (__ldcg): a line this SM's L1
    // kept from before the cluster's sync would be stale.
    auto at = [&](const T* x, int k) -> float {
      return widen(passes > 1 ? __ldcg(x + k) : x[k]);
    };
    auto row_of = [&](int rl, bool tiles) -> const T* {
      if (passes > 1) return C + (size_t)(m0 + rl) * g.ldc;
      for (int k = lane * UV; k < g.gs; k += 32 * UV) {
        const uint4* src =
            tiles ? reinterpret_cast<const uint4*>(
                        cluster.map_shared_rank(tile, k / BN) + rl * TLD +
                        k % BN)
                  : reinterpret_cast<const uint4*>(
                        C + (size_t)(m0 + rl) * g.ldc + k);
        *reinterpret_cast<uint4*>(stage + k) = tiles ? *src : __ldcg(src);
      }
      __syncwarp();
      return stage;
    };
    for (int p = 0; p < passes; ++p) {
      const int c0 = (p * cl + rank) * BN;  // the block's columns this pass
      if (c0 >= g.gs) continue;
      __syncthreads();  // the ring, and the row tile in it, is free
      float acc[64];
      mma_tile<P, WG>(acc, A, g.lda, m0, m0 + rows, W, g.ldw, n0 + c0,
                      n0 + g.gs, g.K, ring, ring_p);
      proxy_fence();
      __syncthreads();
      acc_to_tile<P>(acc, tile + (tid >> 7) * 64 * TLD, TLD, bias, n0 + c0,
                     n0 + g.gs, g.relu);
      __syncthreads();
      T* pre = passes == 1 ? tile : C + (size_t)m0 * g.ldc + c0;
      const int ldpre = passes == 1 ? TLD : g.ldc;
      for (int e = tid; e < rows * UNITS; e += THREADS) {
        const int rl = e / UNITS, cu = (e % UNITS) * UV;
        if (c0 + cu >= g.gs) continue;
        float v[UV];
        load16(v, tile + rl * TLD + cu);
        add_pos_res<P>(v, g, R, m0 + rl, n0 + c0 + cu);
        store16(pre + (size_t)rl * ldpre + cu, v);
      }
    }
    cluster.sync();  // every block's rows before the LayerNorm are written
    // the statistics of the rows dealt to this block, into every block
    for (int rl = rank + cl * warp; rl < rows; rl += cl * NWARPS) {
      const T* x = row_of(rl, true);
      float s = 0.f, ss = 0.f;
      for (int k = lane; k < g.H; k += 32) {
        const float v = at(x, k);
        s = __fadd_rn(s, v);
        ss = __fmaf_rn(v, v, ss);
      }
      __syncwarp();  // the staging row is read
      s = warp_sum(s);
      ss = warp_sum(ss);
      const float mu = __fdiv_rn(s, (float)g.H);
      const float var = __fmaf_rn(-mu, mu, __fdiv_rn(ss, (float)g.H));
      const float rs = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, LN_EPS)));
      if (lane < cl)
        *cluster.map_shared_rank(stats + rl, lane) = make_float2(mu, rs);
    }
    cluster.sync();
    // the LayerNorm of the block's own columns
    for (int p = 0; p < passes; ++p) {
      const int c0 = (p * cl + rank) * BN;
      if (c0 >= g.gs) continue;
      const T* pre = passes == 1 ? tile : C + (size_t)m0 * g.ldc + c0;
      const int ldpre = passes == 1 ? TLD : g.ldc;
      T* out = keep ? tile : C + (size_t)m0 * g.ldc + c0;
      const int ldo = keep ? TLD : g.ldc;
      for (int e = tid; e < rows * UNITS; e += THREADS) {
        const int rl = e / UNITS, cu = (e % UNITS) * UV;
        if (c0 + cu >= g.gs) continue;
        const float2 st = stats[rl];
        float v[UV], ga[UV], be[UV];
        load16(v, pre + (size_t)rl * ldpre + cu);
        load_f32(ga, gamma + c0 + cu);
        load_f32(be, beta + c0 + cu);
#pragma unroll
        for (int j = 0; j < UV; ++j)
          v[j] = __fmaf_rn(__fmul_rn(__fsub_rn(v[j], st.x), st.y), ga[j],
                           be[j]);
        store16(out + (size_t)rl * ldo + cu, v);
      }
    }
    if (!pool) continue;
    cluster.sync();  // every block's LayerNorm rows are written
    // the pooling logits of the rows dealt to this block, into every block
    const float* wm = g.wm + (size_t)bz * g.sg + n0;
    for (int rl = rank + cl * warp; rl < rows; rl += cl * NWARPS) {
      const T* y = row_of(rl, keep);
      float s = 0.f;
      for (int d = lane; d < g.H; d += 32)
        s = __fmaf_rn(at(y, d), wm[d], s);
      __syncwarp();  // the staging row is read
      s = warp_sum(s);
      const float a = g.mask[m0 + rl] > 0.f ? s : NEG_INF;
      if (lane < cl) *cluster.map_shared_rank(att + (m0 + rl - r0), lane) = a;
    }
    cluster.sync();  // the logits are everywhere; no tile is read remotely
  }
  if (!pool) return;
  // softmax over each sequence's tokens, one warp per sequence
  const int nseq = (r1 - r0) / g.L;
  for (int sq = warp; sq < nseq; sq += NWARPS) {
    float* a = att + sq * g.L;
    float mx = -INFINITY;
    for (int l = lane; l < g.L; l += 32) mx = fmaxf(mx, a[l]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int l = lane; l < g.L; l += 32) {
      const float e = expf(a[l] - mx);
      a[l] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    __syncwarp();
    for (int l = lane; l < g.L; l += 32) a[l] = a[l] / sum;
  }
  __syncthreads();
  // pooled = sum over tokens of y * p, in token order, the block's columns
  float* pooled = g.pooled + ((size_t)bz * (g.M / g.L) + r0 / g.L) * g.H;
  for (int p = 0; p < passes; ++p) {
    const int c0 = (p * cl + rank) * BN;
    if (c0 >= g.H) continue;
    const int ncols = min(BN, g.H - c0);
    for (int e = tid; e < nseq * ncols; e += THREADS) {
      const int sq = e / ncols, d = e - sq * ncols;
      const float* pr = att + sq * g.L;
      float acc = 0.f;
      if (keep) {
        const T* y = tile + (size_t)sq * g.L * TLD + d;
        for (int l = 0; l < g.L; ++l)
          acc = fmaf(widen(y[(size_t)l * TLD]), pr[l], acc);
      } else {
        const T* y = C + (size_t)(r0 + sq * g.L) * g.ldc + c0 + d;
        for (int l = 0; l < g.L; ++l)
          acc = fmaf(widen(y[(size_t)l * g.ldc]), pr[l], acc);
      }
      pooled[(size_t)sq * g.H + c0 + d] = acc;
    }
  }
}

// ---------------------------------------------------------------------------
// 4. attention: one block per (head, query tile, sequence, branch), LQ / 16
// warps. qkv is (G, Nseq * L, 3H) with Q | K | V column blocks, head h at
// columns h * dh of each (dh % 8 == 0, zero-padded head dims); ctx (G, Nseq
// * L, H) in the same head layout.
// ---------------------------------------------------------------------------
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const uint32_t a = smem_u32(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, "
               "[%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  const uint32_t a = smem_u32(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, "
               "%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// d += a (16 x 16, row) b (16 x 8, col): f32 accumulators c0..c3 at rows
// lane / 4 (c0, c1) and lane / 4 + 8 (c2, c3), columns 2 (lane % 4) + {0, 1}
__device__ __forceinline__ void mma16816(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a (16 x 8, row) b (8 x 8, col) in tf32, g = lane / 4, t = lane % 4:
// a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); b0 (t, g),
// b1 (t + 4, g); accumulators as mma16816's
__device__ __forceinline__ void mma1688(float (&d)[4],
                                        const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// an A fragment's f32 values split into their TF32 big and small parts
__device__ __forceinline__ void split_a(const float (&a)[4], uint32_t (&ab)[4],
                                        uint32_t (&as)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float big = tf32_big(a[i]);
    ab[i] = __float_as_uint(big);
    as[i] = __float_as_uint(a[i] - big);
  }
}

// d += a b in 3xTF32: a as split by split_a (once per fragment, for every
// b it meets), b = (b0, b1) split here
__device__ __forceinline__ void mma1688_3x(float (&d)[4],
                                           const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4], float b0,
                                           float b1) {
  const float g0 = tf32_big(b0), g1 = tf32_big(b1);
  const uint32_t bb0 = __float_as_uint(g0), bb1 = __float_as_uint(g1);
  mma1688(d, as, bb0, bb1);
  mma1688(d, ab, __float_as_uint(b0 - g0), __float_as_uint(b1 - g1));
  mma1688(d, ab, bb0, bb1);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__host__ __device__ constexpr int round16(int x) { return (x + 15) & ~15; }

// The attention's products. Q: the warp's 16 rows, K, V: the key tile, all
// in shared memory with rows of ld values; DP: head dims held (zeros past
// dh); nkeys: the tile's keys that exist. s[t][x]: key 8 t + 2 (lane % 4) +
// x % 2 of row lane / 4 + 8 (x / 2); o[t][x] the same for dims.
struct AttnBf16 : Bf16 {
  // bf16 k-steps are 16 dims
  static __host__ __device__ constexpr int depth(int dh) {
    return round16(dh);
  }

  template <int KT, int DMAX>
  static __device__ __forceinline__ void scores(float (&s)[KT / 8][4],
                                                const bf16* Q, const bf16* K,
                                                int ld, int DP, int nkeys,
                                                int lane) {
#pragma unroll
    for (int ks = 0; ks < DMAX / 16; ++ks) {
      if (ks * 16 >= DP) continue;
      uint32_t a[4];
      ldsm_x4(a, Q + (lane & 15) * ld + ks * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < KT / 16; ++np) {
        if (np * 16 >= nkeys) continue;
        uint32_t b[4];
        ldsm_x4(b, K + (np * 16 + (lane & 7) + (lane >> 4) * 8) * ld +
                       ks * 16 + ((lane >> 3) & 1) * 8);
        mma16816(s[2 * np], a, b[0], b[1]);
        mma16816(s[2 * np + 1], a, b[2], b[3]);
      }
    }
  }

  // O += P V: P's accumulator tiles 2 kk, 2 kk + 1 are the A fragment of
  // keys [16 kk, 16 kk + 16)
  template <int KT, int DMAX>
  static __device__ __forceinline__ void pv(float (&o)[DMAX / 8][4],
                                            const float (&p)[KT / 8][4],
                                            const bf16* V, int ld, int DP,
                                            int nkeys, int lane) {
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      if (kk * 16 >= nkeys) continue;
      const uint32_t a[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                             pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                             pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                             pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < DMAX / 16; ++dp) {
        if (dp * 16 >= DP) continue;
        uint32_t b[4];
        ldsm_x4_t(b, V + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld +
                         dp * 16 + (lane >> 4) * 8);
        mma16816(o[2 * dp], a, b[0], b[1]);
        mma16816(o[2 * dp + 1], a, b[2], b[3]);
      }
    }
  }

  // the warp's rows out through its own rows of Q (read only by it, and
  // done with), then 16-byte rows to ctx
  template <int DMAX>
  static __device__ __forceinline__ void store(const float (&o)[DMAX / 8][4],
                                               bf16* stage, int ld, int DP,
                                               bf16* out, int H, int dh,
                                               int rows, int lane) {
#pragma unroll
    for (int t = 0; t < DMAX / 8; ++t) {
      if (t * 8 >= DP) continue;
      const int d = t * 8 + (lane & 3) * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<__nv_bfloat162*>(stage +
                                           ((lane >> 2) + 8 * h) * ld + d) =
            __floats2bfloat162_rn(o[t][2 * h], o[t][2 * h + 1]);
    }
    __syncwarp();
    const int units = dh / 8;
    for (int e = lane; e < rows * units; e += 32) {
      const int r = e / units, u = e - r * units;
      *reinterpret_cast<uint4*>(out + (size_t)r * H + u * 8) =
          *reinterpret_cast<const uint4*>(stage + r * ld + u * 8);
    }
  }
};

struct AttnTf32 : Tf32 {
  // tf32 k-steps are 8 dims; dh % 8 == 0
  static __host__ __device__ constexpr int depth(int dh) { return dh; }

  template <int KT, int DMAX>
  static __device__ __forceinline__ void scores(float (&s)[KT / 8][4],
                                                const float* Q,
                                                const float* K, int ld,
                                                int DP, int nkeys,
                                                int lane) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int ks = 0; ks < DMAX / 8; ++ks) {
      if (ks * 8 >= DP) continue;
      const float* q = Q + g * ld + ks * 8 + t;
      uint32_t ab[4], as[4];
      split_a({q[0], q[8 * ld], q[4], q[8 * ld + 4]}, ab, as);
#pragma unroll
      for (int nt = 0; nt < KT / 8; ++nt) {
        if (nt * 8 >= nkeys) continue;
        const float* k = K + (nt * 8 + g) * ld + ks * 8 + t;
        mma1688_3x(s[nt], ab, as, k[0], k[4]);
      }
    }
  }

  // O += P V: the k index of a product is free, so P's accumulators serve
  // as A fragments with k = t <-> key 2 t and k = t + 4 <-> key 2 t + 1
  // (a0 = p(g, 2t), a1 = p(g + 8, 2t), a2 = p(g, 2t + 1), a3 = p(g + 8,
  // 2t + 1)), and V's rows are read in the same order
  template <int KT, int DMAX>
  static __device__ __forceinline__ void pv(float (&o)[DMAX / 8][4],
                                            const float (&p)[KT / 8][4],
                                            const float* V, int ld, int DP,
                                            int nkeys, int lane) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int kk = 0; kk < KT / 8; ++kk) {
      if (kk * 8 >= nkeys) continue;
      uint32_t ab[4], as[4];
      split_a({p[kk][0], p[kk][2], p[kk][1], p[kk][3]}, ab, as);
#pragma unroll
      for (int dt = 0; dt < DMAX / 8; ++dt) {
        if (dt * 8 >= DP) continue;
        const float* v = V + (kk * 8 + 2 * t) * ld + dt * 8 + g;
        mma1688_3x(o[dt], ab, as, v[0], v[ld]);
      }
    }
  }

  // the warp's rows straight to ctx
  template <int DMAX>
  static __device__ __forceinline__ void store(const float (&o)[DMAX / 8][4],
                                               float*, int, int DP,
                                               float* out, int H, int,
                                               int rows, int lane) {
#pragma unroll
    for (int t = 0; t < DMAX / 8; ++t) {
      if (t * 8 >= DP) continue;
      const int d = t * 8 + (lane & 3) * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = (lane >> 2) + 8 * h;
        if (r >= rows) continue;
        *reinterpret_cast<float2*>(out + (size_t)r * H + d) =
            make_float2(o[t][2 * h], o[t][2 * h + 1]);
      }
    }
  }
};

// shared memory: the query tile, the K and V tiles (rows of depth(dh) + 16
// bytes: ldmatrix's 8 rows, and the tf32 fragments' 8 rows x 4 columns, hit
// distinct banks), the key tile's biases
template <typename A>
__host__ __device__ constexpr int attention_ld(int dh) {
  return A::depth(dh) + 16 / (int)sizeof(typename A::T);
}

template <typename A, int LQ, int KT>
__host__ __device__ constexpr size_t attention_smem(int L, int dh) {
  return (size_t)((LQ < round16(L) ? LQ : round16(L)) +
                  2 * (KT < round16(L) ? KT : round16(L))) *
             attention_ld<A>(dh) * sizeof(typename A::T) +
         KT * 4;
}

// MULTI: L > KT, the keys in several tiles; else one tile holds them all
template <typename A, int LQ, int KT, int DMAX, bool MULTI>
__global__ void __launch_bounds__(LQ * 2)
attention_mma_kernel(const typename A::T* __restrict__ qkv,
                     const float* __restrict__ mask,
                     typename A::T* __restrict__ ctx, int heads, int Nseq,
                     int L, int H, int dh, float scale) {
  using T = typename A::T;
  constexpr int NT = KT / 8, DT = DMAX / 8;
  constexpr int UV = 16 / (int)sizeof(T);  // values per 16 bytes
  // several bf16 tiles: pass 0 takes each row's max and sum over all keys,
  // pass 1 forms p = round(e / sum) and accumulates P V; f32 (no rounding
  // point) runs one pass with an online softmax
  constexpr bool TWO_PASS = MULTI && !A::SPLIT;
  extern __shared__ __align__(16) unsigned char smem[];
  const int DP = A::depth(dh), ld = attention_ld<A>(dh);
  const int qrows = min(LQ, round16(L)), krows = min(KT, round16(L));
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks = Qs + qrows * ld;
  T* Vs = Ks + krows * ld;
  float* mb = reinterpret_cast<float*>(Vs + krows * ld);  // the tile's keys

  const int head = blockIdx.x % heads, q0 = (blockIdx.x / heads) * LQ;
  const int seq = blockIdx.y, br = blockIdx.z;
  const size_t row0 = (size_t)br * Nseq * L + (size_t)seq * L;
  const T* base = qkv + row0 * 3 * H + head * dh;
  const int units = DP / UV;  // 16-byte units of a held row

  // rows [first, first + rows) of Q, K or V (which = 0, 1, 2) into dst;
  // zero-filled past L and dh
  auto load_rows = [&](T* dst, int which, int first, int rows) {
    for (int e = threadIdx.x; e < rows * units; e += blockDim.x) {
      const int j = e / units, u = e - j * units;
      const bool ok = first + j < L && u * UV < dh;
      cp16(smem_u32(dst + j * ld + u * UV),
           ok ? base + (size_t)(first + j) * 3 * H + which * H + u * UV
              : base,
           ok ? 16 : 0);
    }
  };
  load_rows(Qs, 0, q0, qrows);  // lands with the first key tile

  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * 16;  // the warp's 16 query rows
  const bool active = q0 + r0 < L;
  float o[DT][4];
#pragma unroll
  for (int t = 0; t < DT; ++t)
#pragma unroll
    for (int x = 0; x < 4; ++x) o[t][x] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  const int nkt = MULTI ? (L + KT - 1) / KT : 1;
  for (int pass = TWO_PASS ? 0 : 1; pass < 2; ++pass) {
    for (int kt = 0; kt < nkt; ++kt) {
      const int k0 = kt * KT, nkeys = MULTI ? min(KT, L - k0) : L;
      if (MULTI) __syncthreads();  // every warp is done with the last tile
      load_rows(Ks, 1, k0, krows);
      if (pass == 1) load_rows(Vs, 2, k0, krows);
      for (int j = threadIdx.x; j < KT; j += blockDim.x)
        mb[j] = j < nkeys ? (1.0f - mask[(size_t)seq * L + k0 + j]) * NEG_BIG
                          : 0.f;
      cp_commit();
      cp_wait<0>();
      __syncthreads();
      if (!active) continue;

      float s[NT][4];
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int x = 0; x < 4; ++x) s[t][x] = 0.f;
      A::template scores<KT, DMAX>(s, Qs + r0 * ld, Ks, ld, DP, nkeys, lane);

      // scale and key mask; keys past the tile's last do not exist
      float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int key = t * 8 + (lane & 3) * 2 + (x & 1);
          const float v = key < nkeys
                              ? __fadd_rn(__fmul_rn(s[t][x], scale), mb[key])
                              : -INFINITY;
          s[t][x] = v;
          mt[x >> 1] = fmaxf(mt[x >> 1], v);
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mt[h] = fmaxf(mt[h], __shfl_xor_sync(0xffffffffu, mt[h], 1));
        mt[h] = fmaxf(mt[h], __shfl_xor_sync(0xffffffffu, mt[h], 2));
      }
      if (!TWO_PASS || pass == 0) {
        // e = exp(s - max) in s; the rows' (running) max and sum
        float sum[2] = {0.f, 0.f};
        const float mn[2] = {fmaxf(m[0], mt[0]), fmaxf(m[1], mt[1])};
#pragma unroll
        for (int t = 0; t < NT; ++t)
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const float e = expf(s[t][x] - mn[x >> 1]);  // 0 past the keys
            s[t][x] = e;
            sum[x >> 1] += e;
          }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
          sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
          if (MULTI) {
            const float alpha = expf(m[h] - mn[h]);  // 0 on the first tile
            l[h] = l[h] * alpha + sum[h];
            if (!TWO_PASS) {  // f32: rescale what the earlier tiles gave
#pragma unroll
              for (int t = 0; t < DT; ++t) {
                o[t][2 * h] *= alpha;
                o[t][2 * h + 1] *= alpha;
              }
            }
          } else {
            l[h] = sum[h];
          }
          m[h] = mn[h];
        }
      }
      if (TWO_PASS && pass == 0) continue;
      // P: one tile or bf16, p = round(e / sum); several f32 tiles, e (the
      // rows are divided by their sum at the end)
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          if (TWO_PASS)
            s[t][x] = A::round(expf(s[t][x] - m[x >> 1]) / l[x >> 1]);
          else if (!MULTI)
            s[t][x] = A::round(s[t][x] / l[x >> 1]);
        }
      A::template pv<KT, DMAX>(o, s, Vs, ld, DP, nkeys, lane);
    }
  }
  if (!active) return;
  if (MULTI && !TWO_PASS) {
#pragma unroll
    for (int t = 0; t < DT; ++t)
#pragma unroll
      for (int x = 0; x < 4; ++x) o[t][x] /= l[x >> 1];
  }
  const size_t first = row0 + q0 + r0;
  A::template store<DMAX>(o, Qs + r0 * ld, ld, DP,
                          ctx + first * H + head * dh, H, dh,
                          min(16, L - q0 - r0), lane);
}

inline int launch_rc() { return (int)cudaGetLastError(); }

inline bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

int sm_count() {
  static int sms[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev < 64 && sms[dev]) return sms[dev];
  int n = 0;
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  if (dev < 64) sms[dev] = n;
  return n;
}

template <typename P>
int launch_normalize(const void* x, void* y, int M, int D, int ldy,
                     cudaStream_t s) {
  using T = typename P::T;
  const int rows_per_block = 256 / 32;
  normalize_kernel<P><<<(M + rows_per_block - 1) / rows_per_block, 256, 0,
                        s>>>((const float*)x, (T*)y, M, D, ldy);
  return launch_rc();
}

template <typename P, int WG>
int launch_gemm(const MmaArgs& g, int batch, cudaStream_t s) {
  constexpr int smem = gemm_smem<P, WG>();
  const cudaError_t e = smem_opt_in<gemm_mma_kernel<P, WG>>(smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((g.N + BN - 1) / BN, (g.M + 64 * WG - 1) / (64 * WG),
                  batch);
  gemm_mma_kernel<P, WG><<<grid, WG * 128, smem, s>>>(g);
  return launch_rc();
}

template <typename P>
int gemm_by_rows(const MmaArgs& g, int batch, cudaStream_t s) {
  // f32 (one block per SM either way): 128-row blocks, whose eight warps
  // hide more of each stage's wait; bf16: 128-row blocks when they still
  // fill every SM twice over
  if constexpr (P::SPLIT) {
    return launch_gemm<P, 2>(g, batch, s);
  } else {
    const long tiles = (long)((g.M + 127) / 128) * ((g.N + BN - 1) / BN) *
                       batch;
    if (tiles >= 2L * sm_count()) return launch_gemm<P, 2>(g, batch, s);
    return launch_gemm<P, 1>(g, batch, s);
  }
}

template <typename P, int WG>
int launch_rows(const MmaArgs& g, int batch, cudaStream_t s) {
  constexpr int BM = 64 * WG;
  const int smem = rows_smem<P, WG>(g.gs, g.L);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  const cudaError_t e = smem_opt_in<gemm_rows_kernel<P, WG>>(smem);
  if (e != cudaSuccess) return (int)e;
  int blocks = (g.M + BM - 1) / BM;
  if (g.L > 0) {
    const int seqs = g.L <= BM ? BM / g.L : 1;
    blocks = (g.M / g.L + seqs - 1) / seqs;
  }
  if (blocks > 65535) return (int)cudaErrorInvalidValue;
  const int cl = rows_cluster(g.gs);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(g.N / g.gs * cl, blocks, batch);
  cfg.blockDim = dim3(WG * 128);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, gemm_rows_kernel<P, WG>, g);
  return err != cudaSuccess ? (int)err : launch_rc();
}

// rows a block: as gemm_by_rows chooses for the column-tiled products, so
// the same products run
template <typename P>
int rows_by_rows(const MmaArgs& g, int batch, cudaStream_t s) {
  if constexpr (P::SPLIT) {
    return launch_rows<P, 2>(g, batch, s);
  } else {
    const long tiles = (long)((g.M + 127) / 128) * (g.N / g.gs) *
                       rows_tiles(g.gs) * batch;
    if (tiles >= 2L * sm_count()) return launch_rows<P, 2>(g, batch, s);
    return launch_rows<P, 1>(g, batch, s);
  }
}

template <typename A, int LQ, int KT, int DMAX, bool MULTI>
int launch_attention(const void* qkv, const void* mask, void* ctx, int G,
                     int Nseq, int L, int H, int heads, int dh, float scale,
                     cudaStream_t s) {
  using T = typename A::T;
  const cudaError_t e =
      smem_opt_in<attention_mma_kernel<A, LQ, KT, DMAX, MULTI>>(
          (int)attention_smem<A, LQ, KT>(LQ > KT ? LQ : KT, DMAX));
  if (e != cudaSuccess) return (int)e;
  const int q_tiles = (L + LQ - 1) / LQ;
  attention_mma_kernel<A, LQ, KT, DMAX, MULTI>
      <<<dim3(heads * q_tiles, Nseq, G), LQ * 2,
         attention_smem<A, LQ, KT>(L, dh), s>>>(
          (const T*)qkv, (const float*)mask, (T*)ctx, heads, Nseq, L, H, dh,
          scale);
  return launch_rc();
}

// query tiles of 32 rows up to L = 32 (the query towers), else 128 (64
// above 128 dims per head, for the registers and shared memory of a
// 256-dim head). Key tiles: bf16 as the query tiles, one tile while L fits
// (as the Pallas kernel, which holds every key); f32 32 keys, an online
// softmax over them, which keeps S and P in few registers
template <typename A, int DMAX>
int attention_by_length(const void* qkv, const void* mask, void* ctx, int G,
                        int Nseq, int L, int H, int heads, int dh,
                        float scale, cudaStream_t s) {
  constexpr int TILE = DMAX > 128 ? 64 : 128;
  constexpr int KT = A::SPLIT ? 32 : TILE;
  if (L <= 32)
    return launch_attention<A, 32, 32, DMAX, false>(
        qkv, mask, ctx, G, Nseq, L, H, heads, dh, scale, s);
  if constexpr (KT > 32) {
    if (L <= KT)
      return launch_attention<A, TILE, KT, DMAX, false>(
          qkv, mask, ctx, G, Nseq, L, H, heads, dh, scale, s);
  }
  return launch_attention<A, TILE, KT, DMAX, true>(
      qkv, mask, ctx, G, Nseq, L, H, heads, dh, scale, s);
}

template <typename A>
int attention_by_depth(const void* qkv, const void* mask, void* ctx, int G,
                       int Nseq, int L, int H, int heads, int dh, float scale,
                       cudaStream_t s) {
  const int dp = A::depth(dh);
  if (dp <= 32)
    return attention_by_length<A, 32>(qkv, mask, ctx, G, Nseq, L, H,
                                      heads, dh, scale, s);
  if (dp <= 64)
    return attention_by_length<A, 64>(qkv, mask, ctx, G, Nseq, L, H,
                                      heads, dh, scale, s);
  if (dp <= 96)
    return attention_by_length<A, 96>(qkv, mask, ctx, G, Nseq, L, H,
                                      heads, dh, scale, s);
  if (dp <= 128)
    return attention_by_length<A, 128>(qkv, mask, ctx, G, Nseq, L, H,
                                       heads, dh, scale, s);
  return attention_by_length<A, 256>(qkv, mask, ctx, G, Nseq, L, H,
                                     heads, dh, scale, s);
}

}  // namespace

// ---------------------------------------------------------------------------
// C interface. `f32` selects the Tf32 instances (f32 values, 3xTF32
// products), else bf16. Each returns cudaGetLastError() after its launch,
// or cudaErrorInvalidValue for a shape or alignment it does not take.
// ---------------------------------------------------------------------------

// x (M, D) f32 -> y (M, ldy) normalized, zeros past D; ldy % 8 == 0,
// ldy >= D, both pointers 16-byte aligned
extern "C" int tower_normalize(const void* x, void* y, int M, int D, int ldy,
                               int f32, void* s) {
  if (M <= 0) return launch_rc();
  if (D <= 0 || ldy < D || ldy % 8 || !aligned16(x) || !aligned16(y))
    return (int)cudaErrorInvalidValue;
  return f32 ? launch_normalize<Tf32>(x, y, M, D, ldy, (cudaStream_t)s)
             : launch_normalize<Bf16>(x, y, M, D, ldy, (cudaStream_t)s);
}

// a (M, K) rows of lda, w (N, K) rows of ldw, batch b at a + b sa, ...;
// bias, pos, res may be null. 16-byte rows everywhere (cp.async and the
// epilogue's 16-byte accesses): K, N and every stride of a tower-dtype
// array a multiple of 8, ldp of 4, every pointer 16-byte aligned.
static int check_mma(const void* a, const void* w, const void* c,
                     const void* pos, const void* res, int K, int N,
                     int lda, int ldw, int ldc, int ldp, int ldr, int sa,
                     int sw, int sc, int sr, int batch) {
  if (K <= 0 || K % 8 || lda % 8 || ldw % 8 || sa % 8 || sw % 8 ||
      !aligned16(a) || !aligned16(w) || N % 8 ||
      (c && (ldc % 8 || sc % 8 || !aligned16(c))) ||
      (res && (ldr % 8 || sr % 8 || !aligned16(res))) ||
      (pos && (ldp % 4 || !aligned16(pos))) || batch > 65535)
    return (int)cudaErrorInvalidValue;
  return 0;
}

static MmaArgs mma_args(const void* a, const void* w, const void* bias,
                        void* c, const void* pos, const void* res, int M,
                        int N, int K, int lda, int ldw, int ldc, int ldp,
                        int ldr, int sa, int sw, int sb, int sc, int sr,
                        int relu, int pos_period, int pos_rows) {
  MmaArgs g = {};
  g.a = a; g.w = w; g.bias = (const float*)bias; g.c = c;
  g.pos = (const float*)pos; g.res = res;
  g.M = M; g.N = N; g.K = K;
  g.lda = lda; g.ldw = ldw; g.ldc = ldc; g.ldp = ldp; g.ldr = ldr;
  g.sa = sa; g.sw = sw; g.sb = sb; g.sc = sc; g.sr = sr;
  g.relu = relu; g.pos_period = pos_period > 0 ? pos_period : 1;
  g.pos_rows = pos_rows;
  return g;
}

extern "C" int tower_gemm_mma(const void* a, const void* w, const void* bias,
                              void* c, const void* pos, const void* res,
                              int M, int N, int K, int lda, int ldw, int ldc,
                              int ldp, int ldr, int sa, int sw, int sb,
                              int sc, int sr, int relu, int pos_period,
                              int pos_rows, int batch, int f32, void* s) {
  if (M <= 0 || N <= 0 || batch <= 0) return launch_rc();
  if (!c || check_mma(a, w, c, pos, res, K, N, lda, ldw, ldc, ldp, ldr, sa,
                      sw, sc, sr, batch))
    return (int)cudaErrorInvalidValue;
  const MmaArgs g = mma_args(a, w, bias, c, pos, res, M, N, K, lda, ldw, ldc,
                             ldp, ldr, sa, sw, sb, sc, sr, relu, pos_period,
                             pos_rows);
  return f32 ? gemm_by_rows<Tf32>(g, batch, (cudaStream_t)s)
             : gemm_by_rows<Bf16>(g, batch, (cudaStream_t)s);
}

// The whole-row mode: tower_gemm_mma's product and epilogue, then the
// LayerNorm of each row of each group of gs columns (N % gs == 0, gs % 8
// == 0, statistics over the first H <= gs), gamma and beta f32 at gamma + b
// sg (+ the column; 16-byte aligned, sg % 4 == 0). L == 0: y to c (M, ldc). L > 0 (N == gs): the rows are
// M / L sequences of L rows, pooled with wm (f32 at wm + b sg) and mask
// (M / L, L) into pooled (batch, M / L, H) f32; c is then scratch for the
// LayerNorm's rows, needed (and written) only when they do not stay in
// shared memory: a group wider than 8 x 128 columns, or L > 64.
extern "C" int tower_gemm_ln(const void* a, const void* w, const void* bias,
                             void* c, const void* pos, const void* res,
                             const void* gamma, const void* beta,
                             const void* wm, const void* mask, void* pooled,
                             int M, int N, int K, int lda, int ldw, int ldc,
                             int ldp, int ldr, int sa, int sw, int sb, int sc,
                             int sr, int sg, int relu, int pos_period,
                             int pos_rows, int gs, int H, int L, int batch,
                             int f32, void* s) {
  if (M <= 0 || N <= 0 || batch <= 0) return launch_rc();
  const bool pool = L > 0;
  if (check_mma(a, w, c, pos, res, K, N, lda, ldw, ldc, ldp, ldr, sa, sw,
                sc, sr, batch) ||
      gs <= 0 || gs % 8 || N % gs || H <= 0 || H > gs || sg % 4 ||
      !aligned16(gamma) || !aligned16(beta) ||
      L < 0 || (!pool && !c) ||
      (pool && (N != gs || M % L || !wm || !mask || !pooled ||
                (!c && !rows_pool_in_smem(gs, L)))))
    return (int)cudaErrorInvalidValue;
  MmaArgs g = mma_args(a, w, bias, c, pos, res, M, N, K, lda, ldw, ldc, ldp,
                       ldr, sa, sw, sb, sc, sr, relu, pos_period, pos_rows);
  g.gamma = (const float*)gamma; g.beta = (const float*)beta;
  g.wm = (const float*)wm; g.mask = (const float*)mask;
  g.pooled = (float*)pooled;
  g.sg = sg; g.gs = gs; g.H = H; g.L = L;
  return f32 ? rows_by_rows<Tf32>(g, batch, (cudaStream_t)s)
             : rows_by_rows<Bf16>(g, batch, (cudaStream_t)s);
}

// qkv (G, Nseq * L, 3H), mask (Nseq, L) f32 -> ctx (G, Nseq * L, H); heads
// of dh values at columns h * dh (dh % 8 == 0, dh <= 256, heads * dh <= H,
// H % 8 == 0), scale 1 / sqrt(the true head width); any L
extern "C" int tower_attention_mma(const void* qkv, const void* mask,
                                   void* ctx, int G, int Nseq, int L, int H,
                                   int heads, int dh, int f32, float scale,
                                   void* s) {
  if (G <= 0 || Nseq <= 0 || L <= 0) return launch_rc();
  if (heads <= 0 || dh <= 0 || dh % 8 || dh > 256 || heads * dh > H ||
      H % 8 || Nseq > 65535 || G > 65535 || !aligned16(qkv) ||
      !aligned16(ctx))
    return (int)cudaErrorInvalidValue;
  return f32 ? attention_by_depth<AttnTf32>(qkv, mask, ctx, G, Nseq, L, H,
                                            heads, dh, scale, (cudaStream_t)s)
             : attention_by_depth<AttnBf16>(qkv, mask, ctx, G, Nseq, L, H,
                                            heads, dh, scale,
                                            (cudaStream_t)s);
}
