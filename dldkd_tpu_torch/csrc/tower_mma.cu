// The encoder towers on Hopper's tensor cores, in bf16 and in f32: the
// input normalization, every matrix product and the attention of the chain
// described in csrc/tower.cu, whose LayerNorm, pooling and int8 epilogue
// both dtypes keep.
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
//   2/4/6/8. gemm_mma C = epilogue(A (M x K) W^T (N x K)^T), both operands
//                     K-major (the packer stores W transposed once per
//                     eval), batched over branches (blockIdx.z). A block
//                     owns 64 or 128 rows (one warpgroup per 64) x 128
//                     columns; depth streams through a ring of stages of
//                     128 bytes per row (64 bf16 or 32 f32 values) filled
//                     by 16-byte cp.async copies in the 128-byte swizzle;
//                     each warpgroup runs wgmma from shared memory into 64
//                     f32 accumulators per thread. bf16: 3 stages, 128-row
//                     blocks when they still give two blocks per SM. f32:
//                     128-row blocks and 2 stages, each split once it lands
//                     (big in place, small into a scratch tile of the same
//                     layout) and then taken by three wgmma per 8 values of
//                     depth; 97 KB, two blocks per SM, so one block's split
//                     overlaps the other's products. Split planes stored
//                     by the chain would double what each stage copies,
//                     and the copies from L2 bound these products. Depth
//                     past K and rows past M or N
//                     are zero-filled, not read. Epilogue in registers and
//                     through shared memory at the rounding points of
//                     tower.cu (identity in f32): + bias, ReLU, round;
//                     + pos[m % period] (rows below pos_rows), round;
//                     + residual, round; written in 16-byte rows.
//   5. attention_mma  one block per (head, query tile, sequence, branch),
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
// across stages, and fusing the chain; intermediates go through device
// memory (L2 for the query tower).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr float NEG_BIG = -10000.0f;  // additive attention key mask
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
// 2/4/6/8. C[b] = epilogue(A[b] (M x K) @ W[b]^T), W[b] stored (N x K), all
// in the tower dtype. Epilogue, in order: + bias[n] (f32); ReLU; round;
// + pos[m % pos_period][n] (f32 holding tower-dtype values) where
// m % pos_period < pos_rows, round; + res[m][n], round. Strides in
// elements; per-batch strides sa .. sr.
// ---------------------------------------------------------------------------
struct MmaArgs {
  const void* a; const void* w; const float* bias; void* c;
  const float* pos; const void* res;
  int M, N, K;
  int lda, ldw, ldc, ldp, ldr;
  int sa, sw, sb, sc, sr;
  int relu, pos_period, pos_rows;
};

constexpr int BN = 128;  // columns per block: wgmma's N
constexpr int KSTEPS = ROW_BYTES / 32;  // one wgmma takes 32 bytes of depth
constexpr int TLD = BN + 8;  // epilogue tile row: a row's 8 lanes (bf16x2)
                             // or a half-warp's 16 (f32x2) hit distinct banks

// the ring's stages, and for Tf32 the scratch tile of one stage's small
// parts
template <typename P, int WG>
constexpr int gemm_smem() {
  return 1024 + (P::STAGES + (P::SPLIT ? 1 : 0)) * (64 * WG + BN) *
                    ROW_BYTES;
}

template <typename P, int WG>
__global__ void __launch_bounds__(WG * 128)
gemm_mma_kernel(MmaArgs g) {
  using T = typename P::T;
  constexpr int BM = 64 * WG, THREADS = WG * 128, STAGES = P::STAGES;
  constexpr int BK = ROW_BYTES / (int)sizeof(T);  // depth per stage
  constexpr int UV = 16 / (int)sizeof(T);         // values per 16 bytes
  constexpr int A_BYTES = BM * ROW_BYTES, STAGE = (BM + BN) * ROW_BYTES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw_s = smem_u32(smem_raw);
  const uint32_t ring = (raw_s + 1023) & ~1023u;
  unsigned char* ring_p = smem_raw + (ring - raw_s);
  const uint32_t scratch = ring + STAGES * STAGE;  // Tf32: small parts

  const int tid = threadIdx.x, lane = tid & 31;
  const int wg = tid >> 7;          // the warpgroup's 64 rows
  const int wq = (tid >> 5) & 3;    // the warp's 16 of them
  const int bz = blockIdx.z;
  const T* A = (const T*)g.a + (size_t)bz * g.sa;
  const T* W = (const T*)g.w + (size_t)bz * g.sw;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int nk = (g.K + BK - 1) / BK;

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
      const bool ok = k < g.K && row < (is_a ? g.M : g.N);
      const T* src = is_a ? A + (size_t)row * g.lda + k
                          : W + (size_t)row * g.ldw + k;
      cp16(st + (is_a ? 0 : A_BYTES) + swz(rr, u), ok ? src : g.a,
           ok ? 16 : 0);
    }
  };

  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(s);
    cp_commit();
  }

  float acc[64];
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

  // epilogue in two passes through the ring, now free: bias, ReLU and the
  // rounding from the accumulators into a tile; then positions and
  // residual, 16 bytes (CPT columns) per thread, from the tile to C
  proxy_fence();
  __syncthreads();
  T* tile = reinterpret_cast<T*>(ring_p);
  const float* bias = g.bias ? g.bias + (size_t)bz * g.sb : nullptr;
#pragma unroll
  for (int t = 0; t < BN / 8; ++t) {
    const int cl = t * 8 + (lane & 3) * 2;
    const bool in = n0 + cl < g.N;  // N % 8 == 0: both columns or neither
    const float b0 = bias && in ? bias[n0 + cl] : 0.f;
    const float b1 = bias && in ? bias[n0 + cl + 1] : 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v0 = acc[4 * t + 2 * h], v1 = acc[4 * t + 2 * h + 1];
      if (bias) {
        v0 += b0;
        v1 += b1;
      }
      if (g.relu) {
        v0 = fmaxf(v0, 0.f);
        v1 = fmaxf(v1, 0.f);
      }
      const int rl = wg * 64 + wq * 16 + (lane >> 2) + 8 * h;
      T* dst = tile + rl * TLD + cl;
      if constexpr (P::SPLIT) {
        *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(dst) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
  __syncthreads();

  constexpr int CPT = UV;  // columns per thread: 16 bytes of C
  const T* R = g.res ? (const T*)g.res + (size_t)bz * g.sr : nullptr;
  T* C = (T*)g.c + (size_t)bz * g.sc;
  for (int e = tid; e < BM * (BN / CPT); e += THREADS) {
    const int rl = e / (BN / CPT), cl = (e % (BN / CPT)) * CPT;
    const int row = m0 + rl, col = n0 + cl;
    if (row >= g.M || col >= g.N) continue;
    float v[CPT];
    {
      const uint4 raw = *reinterpret_cast<const uint4*>(tile + rl * TLD + cl);
      const T* tv = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < CPT; ++j) v[j] = widen(tv[j]);
    }
    if (g.pos) {
      const int prow = row % g.pos_period;
      if (prow < g.pos_rows) {
        const float4* p = reinterpret_cast<const float4*>(
            g.pos + (size_t)prow * g.ldp + col);
#pragma unroll
        for (int q = 0; q < CPT / 4; ++q) {
          const float4 pq = p[q];
          const float pv[4] = {pq.x, pq.y, pq.z, pq.w};
#pragma unroll
          for (int j = 0; j < 4; ++j)
            v[4 * q + j] = P::round(v[4 * q + j] + pv[j]);
        }
      }
    }
    if (R) {
      const size_t o = (size_t)row * g.ldr + col;
      const uint4 rr = *reinterpret_cast<const uint4*>(R + o);
      const T* rv = reinterpret_cast<const T*>(&rr);
      float r[CPT];
#pragma unroll
      for (int j = 0; j < CPT; ++j) r[j] = widen(rv[j]);
#pragma unroll
      for (int j = 0; j < CPT; ++j) v[j] = P::round(v[j] + r[j]);
    }
    uint4 out;
    T* ov = reinterpret_cast<T*>(&out);
#pragma unroll
    for (int j = 0; j < CPT; ++j) ov[j] = narrow<T>(v[j]);
    *reinterpret_cast<uint4*>(C + (size_t)row * g.ldc + col) = out;
  }
}

// ---------------------------------------------------------------------------
// 5. attention: one block per (head, query tile, sequence, branch), LQ / 16
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
extern "C" int tower_gemm_mma(const void* a, const void* w, const void* bias,
                              void* c, const void* pos, const void* res,
                              int M, int N, int K, int lda, int ldw, int ldc,
                              int ldp, int ldr, int sa, int sw, int sb,
                              int sc, int sr, int relu, int pos_period,
                              int pos_rows, int batch, int f32, void* s) {
  if (M <= 0 || N <= 0 || batch <= 0) return launch_rc();
  if (K <= 0 || K % 8 || lda % 8 || ldw % 8 || sa % 8 || sw % 8 ||
      !aligned16(a) || !aligned16(w) || N % 8 || ldc % 8 || sc % 8 ||
      !aligned16(c) || (res && (ldr % 8 || sr % 8 || !aligned16(res))) ||
      (pos && (ldp % 4 || !aligned16(pos))) || batch > 65535)
    return (int)cudaErrorInvalidValue;
  MmaArgs g;
  g.a = a; g.w = w; g.bias = (const float*)bias; g.c = c;
  g.pos = (const float*)pos; g.res = res;
  g.M = M; g.N = N; g.K = K;
  g.lda = lda; g.ldw = ldw; g.ldc = ldc; g.ldp = ldp; g.ldr = ldr;
  g.sa = sa; g.sw = sw; g.sb = sb; g.sc = sc; g.sr = sr;
  g.relu = relu; g.pos_period = pos_period > 0 ? pos_period : 1;
  g.pos_rows = pos_rows;
  return f32 ? gemm_by_rows<Tf32>(g, batch, (cudaStream_t)s)
             : gemm_by_rows<Bf16>(g, batch, (cudaStream_t)s);
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
