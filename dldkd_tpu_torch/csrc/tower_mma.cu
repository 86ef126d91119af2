// The bf16 encoder towers on Hopper's tensor cores: the input
// normalization, every matrix product and the attention of the chain in
// csrc/tower.cu, whose LayerNorm, pooling and int8 epilogue the bf16 towers
// keep. The f32 towers stay on tower.cu's SIMT kernels (IEEE f32 FMAs).
//
// Replaces, with those, dldkd_tpu/ops/pallas/query_tower.py in bf16:
//   _dual_query_tower_kernel (:211), _query_tower_kernel (:196)
//   _dual_context_tower_kernel (:246), _context_tower_kernel (:229)
// The Pallas kernels run every product and the attention on the MXU with
// f32 accumulation; here wgmma (products) and mma.sync (attention) do,
// and since a bf16 product is exact in f32, only the order of the f32 sums
// differs from the plain version (ops/kernels/query_tower.py:tower_plain).
//
// What bounds it on an H100: operations. One video-tower launch at the
// serving shapes (200 videos x 128 frames, 1024 -> 384, both branches) is
// about 126 GFLOP against 105 MB of f32 input: 0.127 ms at 989 TFLOP/s
// against 0.031 ms of bytes. A query-tower launch (50 queries x 32 tokens)
// is 5.8 GFLOP, 0.006 ms: there the chain's launches set the floor.
//
// What the design does about it (the chain is csrc/tower.cu's, steps
// numbered as there):
//   1. normalize      the input LayerNorm (f32 statistics of the input
//                     rounded to bf16) written out as bf16 once: the value
//                     the SIMT product normalizes on load. One warp per
//                     row; bytes-bound (read f32, write bf16).
//   2/4/6/8. gemm_mma C = epilogue(A (M x K) W^T (N x K)^T), both operands
//                     K-major bf16 (the packer stores W transposed once per
//                     eval), batched over branches (blockIdx.z). A block
//                     owns 64 or 128 rows (one warpgroup per 64) x 128
//                     columns; depth streams through a ring of 3 stages of
//                     128 bytes (64 values) filled by 16-byte cp.async
//                     copies in the 128-byte swizzle; each warpgroup runs
//                     wgmma m64n128k16 from shared memory into 64 f32
//                     accumulators per thread. Depth past K (a multiple of
//                     8) and rows past M or N are zero-filled, not read.
//                     128-row blocks only when they still give two blocks
//                     per SM: at 50 queries (M = 1,600) 64-row blocks keep
//                     the SMs busy. Epilogue in registers at the rounding
//                     points of tower.cu: + bias, ReLU, round; + pos[m %
//                     period] (rows below pos_rows), round; + residual,
//                     round.
//   5. attention_mma  one block per (head, sequence, branch), one warp per
//                     16 query rows: Q, K, V of the head in shared memory
//                     (rows and head dims zero-padded to 16), S = Q K^T by
//                     mma.sync m16n8k16 from ldmatrix fragments, scale and
//                     key mask in f32, softmax in registers (row max
//                     subtracted, p = round_bf16(e / sum), so an all-masked
//                     row stays finite), then P V with P's accumulators
//                     reused as the A fragments. L <= 128, d_head <= 128.
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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---------------------------------------------------------------------------
// 1. xn = round((round(x) - mu) * rstd), mu and rstd the f32 statistics
// (E[x^2] - mu^2, eps 1e-5) of round(x); D % 4 == 0. One warp per row.
// ---------------------------------------------------------------------------
__global__ void normalize_kernel(const float* __restrict__ x,
                                 bf16* __restrict__ y, int M, int D) {
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= M) return;
  const float4* xr = reinterpret_cast<const float4*>(x + (size_t)row * D);
  const int n4 = D / 4;
  float s = 0.f, ss = 0.f;
  for (int k = lane; k < n4; k += 32) {
    const float4 v = xr[k];
    const float a[4] = {rt(v.x), rt(v.y), rt(v.z), rt(v.w)};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s += a[j];
      ss = fmaf(a[j], a[j], ss);
    }
  }
  s = warp_sum(s);
  ss = warp_sum(ss);
  const float mu = s / D;
  const float rstd = 1.0f / sqrtf(ss / D - mu * mu + LN_EPS);
  uint2* yr = reinterpret_cast<uint2*>(y + (size_t)row * D);
  for (int k = lane; k < n4; k += 32) {
    const float4 v = xr[k];
    __nv_bfloat162 lo = __floats2bfloat162_rn((rt(v.x) - mu) * rstd,
                                              (rt(v.y) - mu) * rstd);
    __nv_bfloat162 hi = __floats2bfloat162_rn((rt(v.z) - mu) * rstd,
                                              (rt(v.w) - mu) * rstd);
    uint2 out;
    out.x = *reinterpret_cast<uint32_t*>(&lo);
    out.y = *reinterpret_cast<uint32_t*>(&hi);
    yr[k] = out;
  }
}

// ---------------------------------------------------------------------------
// 2/4/6/8. C[b] = epilogue(A[b] (M x K) @ W[b]^T), W[b] stored (N x K).
// Epilogue, in order: + bias[n] (f32); ReLU; round; + pos[m % pos_period]
// [n] (f32 holding bf16 values) where m % pos_period < pos_rows, round;
// + res[m][n], round. Strides in elements; per-batch strides sa .. sr.
// ---------------------------------------------------------------------------
struct MmaArgs {
  const bf16* a; const bf16* w; const float* bias; bf16* c;
  const float* pos; const bf16* res;
  int M, N, K;
  int lda, ldw, ldc, ldp, ldr;
  int sa, sw, sb, sc, sr;
  int relu, pos_period, pos_rows;
};

constexpr int BN = 128;                // columns per block: wgmma's N
constexpr int BK = ROW_BYTES / 2;      // depth per stage: 64 values
constexpr int STAGES = 3;
constexpr int KSTEPS = BK / 16;        // one wgmma takes 16 values of depth

template <int WG>
constexpr int gemm_smem() {
  return 1024 + STAGES * (64 * WG + BN) * ROW_BYTES;
}

template <int WG>
__global__ void __launch_bounds__(WG * 128)
gemm_mma_kernel(MmaArgs g) {
  constexpr int BM = 64 * WG, THREADS = WG * 128;
  constexpr int A_BYTES = BM * ROW_BYTES, STAGE = (BM + BN) * ROW_BYTES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw_s = smem_u32(smem_raw);
  const uint32_t ring = (raw_s + 1023) & ~1023u;

  const int tid = threadIdx.x, lane = tid & 31;
  const int wg = tid >> 7;          // the warpgroup's 64 rows
  const int wq = (tid >> 5) & 3;    // the warp's 16 of them
  const int bz = blockIdx.z;
  const bf16* A = g.a + (size_t)bz * g.sa;
  const bf16* W = g.w + (size_t)bz * g.sw;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int nk = (g.K + BK - 1) / BK;

  // rows [0, BM) of a stage are A's, rows [BM, BM + BN) W's; each row is
  // 8 units of 16 bytes (8 values), K % 8 == 0 so a unit is whole or absent
  auto load = [&](int kc) {
    const uint32_t st = ring + (kc % STAGES) * STAGE;
    const int k0 = kc * BK;
    for (int e = tid; e < (BM + BN) * 8; e += THREADS) {
      const int r = e >> 3, u = e & 7, k = k0 + u * 8;
      const bool is_a = r < BM;
      const int rr = is_a ? r : r - BM;
      const int row = (is_a ? m0 : n0) + rr;
      const bool ok = k < g.K && row < (is_a ? g.M : g.N);
      const bf16* src = is_a ? A + (size_t)row * g.lda + k
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
    __syncthreads();  // stage kc landed; stage kc - 1's slot is free
    if (kc + STAGES - 1 < nk) load(kc + STAGES - 1);
    cp_commit();
    const uint32_t st = ring + (kc % STAGES) * STAGE;
    const uint32_t a = st + wg * 64 * ROW_BYTES, b = st + A_BYTES;
    acc_fence(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks)
      wgmma_bf16(acc, desc(a + ks * 32), desc(b + ks * 32), kc > 0 || ks > 0);
    wgmma_commit();
    wgmma_wait();  // before the slot is refilled and the epilogue reads
    acc_fence(acc);
  }
  cp_wait<0>();

  // epilogue in two passes through the ring, now free: bias, ReLU and the
  // rounding from the accumulators into a bf16 tile; then positions and
  // residual, 8 columns (16 bytes) per thread, from the tile to C
  proxy_fence();
  __syncthreads();
  constexpr int TLD = BN + 8;  // +16 bytes: the 8 rows of a store hit 8
                               // bank groups
  bf16* tile = reinterpret_cast<bf16*>(smem_raw + (ring - raw_s));
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
      *reinterpret_cast<__nv_bfloat162*>(tile + rl * TLD + cl) =
          __floats2bfloat162_rn(v0, v1);
    }
  }
  __syncthreads();

  const bf16* R = g.res ? g.res + (size_t)bz * g.sr : nullptr;
  bf16* C = g.c + (size_t)bz * g.sc;
  for (int e = tid; e < BM * (BN / 8); e += THREADS) {
    const int rl = e / (BN / 8), cl = (e % (BN / 8)) * 8;
    const int row = m0 + rl, col = n0 + cl;
    if (row >= g.M || col >= g.N) continue;
    const uint4 raw = *reinterpret_cast<const uint4*>(tile + rl * TLD + cl);
    const __nv_bfloat162* t2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
    float v[8];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[2 * j] = __low2float(t2[j]);
      v[2 * j + 1] = __high2float(t2[j]);
    }
    if (g.pos) {
      const int prow = row % g.pos_period;
      if (prow < g.pos_rows) {
        const float4* p = reinterpret_cast<const float4*>(
            g.pos + (size_t)prow * g.ldp + col);
        const float4 p0 = p[0], p1 = p[1];
        const float pv[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = rt(v[j] + pv[j]);
      }
    }
    if (R) {
      const uint4 rr =
          *reinterpret_cast<const uint4*>(R + (size_t)row * g.ldr + col);
      const __nv_bfloat162* r2 = reinterpret_cast<const __nv_bfloat162*>(&rr);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[2 * j] = rt(v[2 * j] + __low2float(r2[j]));
        v[2 * j + 1] = rt(v[2 * j + 1] + __high2float(r2[j]));
      }
    }
    uint4 out;
    __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      o2[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
    *reinterpret_cast<uint4*>(C + (size_t)row * g.ldc + col) = out;
  }
}

// ---------------------------------------------------------------------------
// 5. attention: one block per (head, sequence, branch), LMAX / 16 warps.
// qkv is (G, Nseq * L, 3H) with Q | K | V column blocks, ctx (G, Nseq * L,
// H); L <= LMAX, d_head <= DMAX.
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__host__ __device__ constexpr int round16(int x) { return (x + 15) & ~15; }

template <int LMAX, int DMAX>
constexpr int attention_smem_max() {
  return 3 * LMAX * (DMAX + 8) * 2 + LMAX * 4;
}

template <int LMAX, int DMAX>
__global__ void __launch_bounds__(LMAX * 2)
attention_mma_kernel(const bf16* __restrict__ qkv,
                     const float* __restrict__ mask, bf16* __restrict__ ctx,
                     int Nseq, int L, int H, int dh, float scale) {
  constexpr int NT = LMAX / 8, DT = DMAX / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int LP = round16(L), DP = round16(dh);
  const int ld = DP + 8;  // +16 bytes: ldmatrix's 8 rows hit 8 bank groups
  bf16* Qs = reinterpret_cast<bf16*>(smem);  // Q, K, V: LP x ld each
  bf16* Ks = Qs + LP * ld;
  bf16* Vs = Ks + LP * ld;
  float* mb = reinterpret_cast<float*>(Vs + LP * ld);  // LMAX key biases

  const int head = blockIdx.x, seq = blockIdx.y, br = blockIdx.z;
  const size_t row0 = (size_t)br * Nseq * L + (size_t)seq * L;
  const bf16* base = qkv + row0 * 3 * H + head * dh;
  const bool vec = (dh & 7) == 0 && (H & 7) == 0;  // 16-byte rows
  const int units = DP / 8;
  if (vec) {  // every copy in flight at once; zero-filled past L and dh
    for (int which = 0; which < 3; ++which)
      for (int e = threadIdx.x; e < LP * units; e += blockDim.x) {
        const int j = e / units, u = e - j * units;
        const bool ok = j < L && u * 8 < dh;
        cp16(smem_u32(Qs + (which * LP + j) * ld + u * 8),
             ok ? base + (size_t)j * 3 * H + which * H + u * 8 : base,
             ok ? 16 : 0);
      }
    cp_commit();
  } else {
    const int per = LP * DP;
    for (int e = threadIdx.x; e < 3 * per; e += blockDim.x) {
      const int which = e / per, j = (e % per) / DP, d = e % DP;
      Qs[(which * LP + j) * ld + d] =
          (j < L && d < dh) ? base[(size_t)j * 3 * H + which * H + d]
                            : __float2bfloat16_rn(0.f);
    }
  }
  for (int j = threadIdx.x; j < LMAX; j += blockDim.x)
    mb[j] = j < L ? (1.0f - mask[(size_t)seq * L + j]) * NEG_BIG : 0.f;
  cp_wait<0>();
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * 16;  // the warp's 16 query rows
  if (r0 >= L) return;

  // S = Q K^T: 16 rows x LP keys in NT tiles of 8
  float s[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int x = 0; x < 4; ++x) s[t][x] = 0.f;
#pragma unroll
  for (int ks = 0; ks < DMAX / 16; ++ks) {
    if (ks * 16 >= DP) continue;
    uint32_t a[4];
    ldsm_x4(a, Qs + (r0 + (lane & 15)) * ld + ks * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < LMAX / 16; ++np) {
      if (np * 16 >= LP) continue;
      uint32_t b[4];
      ldsm_x4(b, Ks + (np * 16 + (lane & 7) + (lane >> 4) * 8) * ld +
                     ks * 16 + ((lane >> 3) & 1) * 8);
      mma16816(s[2 * np], a, b[0], b[1]);
      mma16816(s[2 * np + 1], a, b[2], b[3]);
    }
  }

  // scale, key mask, softmax over the L keys; keys past L do not exist
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int key = t * 8 + (lane & 3) * 2 + (x & 1);
      const float v = key < L ? __fadd_rn(__fmul_rn(s[t][x], scale), mb[key])
                              : -INFINITY;
      s[t][x] = v;
      mx[x >> 1] = fmaxf(mx[x >> 1], v);
    }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
  }
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const float e = expf(s[t][x] - mx[x >> 1]);  // 0 past L
      s[t][x] = e;
      sum[x >> 1] += e;
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
  }
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int x = 0; x < 4; ++x) s[t][x] = rt(s[t][x] / sum[x >> 1]);

  // O = P V: P's accumulator tiles 2 kk, 2 kk + 1 are the A fragment of
  // keys [16 kk, 16 kk + 16)
  float o[DT][4];
#pragma unroll
  for (int t = 0; t < DT; ++t)
#pragma unroll
    for (int x = 0; x < 4; ++x) o[t][x] = 0.f;
#pragma unroll
  for (int kk = 0; kk < LMAX / 16; ++kk) {
    if (kk * 16 >= LP) continue;
    const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                           pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                           pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                           pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
    for (int dp = 0; dp < DMAX / 16; ++dp) {
      if (dp * 16 >= DP) continue;
      uint32_t b[4];
      ldsm_x4_t(b, Vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld +
                       dp * 16 + (lane >> 4) * 8);
      mma16816(o[2 * dp], a, b[0], b[1]);
      mma16816(o[2 * dp + 1], a, b[2], b[3]);
    }
  }

  // the warp's 16 rows of ctx through its own rows of Qs (read only by
  // it, and done with), then out in 16-byte rows
  bf16* q = Qs + r0 * ld;
#pragma unroll
  for (int t = 0; t < DT; ++t) {
    if (t * 8 >= DP) continue;
    const int d = t * 8 + (lane & 3) * 2;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<__nv_bfloat162*>(q + ((lane >> 2) + 8 * h) * ld + d) =
          __floats2bfloat162_rn(o[t][2 * h], o[t][2 * h + 1]);
  }
  __syncwarp();
  bf16* out = ctx + row0 * H + head * dh;
  const int rows = min(16, L - r0);
  if (vec) {
    for (int e = lane; e < rows * units; e += 32) {
      const int r = e / units, u = e - r * units;
      if (u * 8 < dh)
        *reinterpret_cast<uint4*>(out + (size_t)(r0 + r) * H + u * 8) =
            *reinterpret_cast<const uint4*>(q + r * ld + u * 8);
    }
  } else {
    for (int e = lane; e < rows * dh; e += 32) {
      const int r = e / dh, d = e - r * dh;
      out[(size_t)(r0 + r) * H + d] = q[r * ld + d];
    }
  }
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

template <int WG>
int launch_gemm(const MmaArgs& g, int batch, cudaStream_t s) {
  constexpr int smem = gemm_smem<WG>();
  const cudaError_t e = smem_opt_in<gemm_mma_kernel<WG>>(smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((g.N + BN - 1) / BN, (g.M + 64 * WG - 1) / (64 * WG),
                  batch);
  gemm_mma_kernel<WG><<<grid, WG * 128, smem, s>>>(g);
  return launch_rc();
}

template <int LMAX, int DMAX>
int launch_attention(const void* qkv, const void* mask, void* ctx, int G,
                     int Nseq, int L, int H, int heads, float scale,
                     cudaStream_t s) {
  const cudaError_t e =
      smem_opt_in<attention_mma_kernel<LMAX, DMAX>>(
          attention_smem_max<LMAX, DMAX>());
  if (e != cudaSuccess) return (int)e;
  const int dh = H / heads;
  const size_t smem =
      (size_t)3 * round16(L) * (round16(dh) + 8) * 2 + LMAX * 4;
  attention_mma_kernel<LMAX, DMAX><<<dim3(heads, Nseq, G), LMAX * 2, smem,
                                     s>>>((const bf16*)qkv,
                                          (const float*)mask, (bf16*)ctx,
                                          Nseq, L, H, dh, scale);
  return launch_rc();
}

template <int LMAX>
int attention_by_depth(const void* qkv, const void* mask, void* ctx, int G,
                       int Nseq, int L, int H, int heads, float scale,
                       cudaStream_t s) {
  const int dh = H / heads;
  if (dh <= 32)
    return launch_attention<LMAX, 32>(qkv, mask, ctx, G, Nseq, L, H, heads,
                                      scale, s);
  if (dh <= 64)
    return launch_attention<LMAX, 64>(qkv, mask, ctx, G, Nseq, L, H, heads,
                                      scale, s);
  if (dh <= 96)
    return launch_attention<LMAX, 96>(qkv, mask, ctx, G, Nseq, L, H, heads,
                                      scale, s);
  return launch_attention<LMAX, 128>(qkv, mask, ctx, G, Nseq, L, H, heads,
                                     scale, s);
}

}  // namespace

// ---------------------------------------------------------------------------
// C interface (bf16 only). Each returns cudaGetLastError() after its launch,
// or cudaErrorInvalidValue for a shape or alignment it does not take.
// ---------------------------------------------------------------------------

// x (M, D) f32 -> y (M, D) bf16; D % 4 == 0, x 16-byte aligned
extern "C" int tower_normalize(const void* x, void* y, int M, int D,
                               void* s) {
  if (M <= 0) return launch_rc();
  if (D <= 0 || D % 4 || !aligned16(x) || ((uintptr_t)y & 7))
    return (int)cudaErrorInvalidValue;
  const int rows_per_block = 256 / 32;
  normalize_kernel<<<(M + rows_per_block - 1) / rows_per_block, 256, 0,
                     (cudaStream_t)s>>>((const float*)x, (bf16*)y, M, D);
  return launch_rc();
}

// a (M, K) rows of lda, w (N, K) rows of ldw, batch b at a + b sa, ...;
// bias, pos, res may be null. 16-byte rows everywhere (cp.async and the
// epilogue's 16-byte accesses): K, N and every bf16 stride a multiple of 8,
// ldp of 4, every pointer 16-byte aligned.
extern "C" int tower_gemm_mma(const void* a, const void* w, const void* bias,
                              void* c, const void* pos, const void* res,
                              int M, int N, int K, int lda, int ldw, int ldc,
                              int ldp, int ldr, int sa, int sw, int sb,
                              int sc, int sr, int relu, int pos_period,
                              int pos_rows, int batch, void* s) {
  if (M <= 0 || N <= 0 || batch <= 0) return launch_rc();
  if (K <= 0 || K % 8 || lda % 8 || ldw % 8 || sa % 8 || sw % 8 ||
      !aligned16(a) || !aligned16(w) || N % 8 || ldc % 8 || sc % 8 ||
      !aligned16(c) || (res && (ldr % 8 || sr % 8 || !aligned16(res))) ||
      (pos && (ldp % 4 || !aligned16(pos))) || batch > 65535)
    return (int)cudaErrorInvalidValue;
  MmaArgs g;
  g.a = (const bf16*)a; g.w = (const bf16*)w; g.bias = (const float*)bias;
  g.c = (bf16*)c; g.pos = (const float*)pos; g.res = (const bf16*)res;
  g.M = M; g.N = N; g.K = K;
  g.lda = lda; g.ldw = ldw; g.ldc = ldc; g.ldp = ldp; g.ldr = ldr;
  g.sa = sa; g.sw = sw; g.sb = sb; g.sc = sc; g.sr = sr;
  g.relu = relu; g.pos_period = pos_period > 0 ? pos_period : 1;
  g.pos_rows = pos_rows;
  // 128-row blocks when they still fill every SM twice over
  const long tiles = (long)((M + 127) / 128) * ((N + BN - 1) / BN) * batch;
  if (tiles >= 2L * sm_count())
    return launch_gemm<2>(g, batch, (cudaStream_t)s);
  return launch_gemm<1>(g, batch, (cudaStream_t)s);
}

// qkv (G, Nseq * L, 3H) bf16, mask (Nseq, L) f32 -> ctx (G, Nseq * L, H)
// bf16; L <= 128, H % heads == 0, H / heads <= 128
extern "C" int tower_attention_mma(const void* qkv, const void* mask,
                                   void* ctx, int G, int Nseq, int L, int H,
                                   int heads, float scale, void* s) {
  if (G <= 0 || Nseq <= 0 || L <= 0) return launch_rc();
  if (heads <= 0 || H % heads || H / heads > 128 || L > 128 ||
      Nseq > 65535 || G > 65535)
    return (int)cudaErrorInvalidValue;
  if (L <= 32)
    return attention_by_depth<32>(qkv, mask, ctx, G, Nseq, L, H, heads,
                                  scale, (cudaStream_t)s);
  return attention_by_depth<128>(qkv, mask, ctx, G, Nseq, L, H, heads, scale,
                                 (cudaStream_t)s);
}
