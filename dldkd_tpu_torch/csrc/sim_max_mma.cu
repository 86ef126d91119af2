// Max-over-frames scoring on Hopper's tensor cores: one kernel, templated
// on its arithmetic, in four instances.
//
//   bf16:  out[q, v] = max_l  s * m[v, l] + (1 - m[v, l]) * -1e10,
//          s = <qn[q], cn[v, l]> with f32 accumulation
//   f32:   the same on f32 inputs, s from split TF32 products
//   int8:  out[q, v] = float(max_l <q8[q], c8[v, l]> + bias[v, l]) / 127^2,
//          the dot, the bias and the max in int32
//   exact: out[q, v] = max_l  <qn[q], c[v, l]> * inv[v, l] + bias[v, l],
//          f32 queries against raw bf16 frames, split bf16 products
//
// Replaces, in dldkd_tpu/ops/pallas/sim_max.py:
// - _sim_max_kernel (:36; pallas_call :385, fused_clip_scores) on bf16 and
//   f32 inputs;
// - _sim_max_kernel_int8 (:195; pallas_call :319, fused_clip_scores_q8 and
//   fused_clip_scores(quantized=True));
// - _sim_max_kernel_exact (:66; pallas_call :159, fused_exact_scores).
//
// Arithmetic. Every Pallas kernel puts the product on the MXU with a wide
// accumulator; here wgmma does the same. bf16: a bf16 product is exact in
// f32 and only the order of the sums changes. int8: s8 x s8 into s32 is
// exact, so int8 scores on valid videos are bitwise those of the plain
// version (integers below 2^24, one multiply by the f32 constant).
// exact: the Pallas kernel's own split (sim_max.py:85-88, round to nearest
// even): q1 = bf16(q), r = q - q1, q2 = bf16(r), q3 = bf16(r - q2), so q ==
// q1 + q2 + q3 exactly and each bf16 x bf16 product is exact in f32; three
// wgmma m64n128k16 bf16 products into one f32 accumulator.
// f32: _sim_max_kernel runs f32 inputs at the process's matmul precision,
// which the JAX package sets to "highest" (dldkd_tpu/infer.py:27-29): XLA's
// multi-pass bf16 emulation of f32 on the MXU, not IEEE f32 products. The
// counterpart here is 3xTF32: each operand x is split into big = x rounded
// to TF32 (10 mantissa bits, to nearest with ties away from zero, as
// cvt.rna.tf32.f32 rounds) and small = x - big, exact in f32; s = big.big +
// big.small + small.big, three wgmma m64n128k8 tf32 products. big is
// written with its low 13 bits zero, so the tensor core, which reads the
// top 19 bits of an f32, reads exactly it (taking small against a value
// the hardware might round otherwise would leave 2^-11-grade errors). The
// dropped small.small term is below 2^-22 of |q||c| = 1 and the tensor
// core's reading of small to TF32 costs another 2^-22: scores stay within
// about 1e-7 of f32 products. ops/kernels/sim_max.py holds both splits
// (`split_tf32`, `split_bf16x3`) for the tests.
//
// What bounds it on an H100 (3.35 TB/s; 989 TFLOP/s bf16, 495 tf32, 1,979
// TOPS int8): a launch reads the whole corpus once. TVR's 2,179 x 128 x 384
// frames are 428 MB in f32, 214 MB in bf16 and 107 MB in int8. At the
// eval's 50 queries bytes bound every instance: 0.128 ms (f32, against 3 x
// 10.7 GFLOP of tf32, 0.065 ms), 0.064 ms (bf16), 0.032 ms (int8). At 256
// queries bf16 is 0.065 ms of bytes against 0.055 ms of operations and int8
// 0.033 against 0.028; the exact instance is 3 x 54.8 GFLOP of bf16,
// 0.166 ms, against 0.064 ms of bytes: operations.
//
// What the design does about it:
// - The grid is persistent: as many blocks as fit on the SMs, spread over
//   the query tiles; block (x, y) walks videos x, x + gridDim.x, ... So the
//   corpus streams once per query tile, and the blocks of other query tiles
//   that share a video run beside it and find its frames in L2.
// - One warpgroup (4 warps) per 64 queries: up to 64 queries (the eval's
//   50) a block has one, above (256 for serving) two, so the corpus
//   streams half as often, where their shared memory fits (launch()).
// - Frames stream through a ring of 3 stages of 128 frames x 128 bytes of
//   depth (64 bf16, 128 int8 or 32 f32 values), filled by 16-byte cp.async
//   copies in the 128-byte swizzle that wgmma reads; two stages are in
//   flight while the tensor cores work on the third. Frames past L and
//   depth past D are zero-filled, not read. Each block steps through its
//   (video, frame chunk, depth chunk) stages with counters: no division in
//   the loop.
// - Queries. bf16, int8: the block's rows stay in shared memory for the
//   whole launch (64 x 384 bf16 = 48 KB), read from device memory once per
//   block. exact: the block splits its f32 rows once, in its prologue,
//   into three resident bf16 tiles (3 x 48 KB at D = 384): two warpgroups
//   do not fit, so 256 queries run as four 64-query tiles, and D above 448
//   fits none (the wrapper refuses it). f32: the rows do not fit (64 x 384
//   f32 = 96 KB, twice that split), so each ring stage carries the
//   queries' 32-value depth slice beside the frames'; once a stage has
//   landed the block splits it in place (big) and into a scratch tile of
//   the same layout (small; the swizzle is a byte layout, so the split is
//   elementwise), then fences and waits at a barrier before its wgmmas. A
//   one-warpgroup block then takes 98.5 KB, so two blocks share an SM and
//   one splits while the other multiplies.
// - Each warpgroup multiplies its 64 queries by a chunk's 128 frames with
//   wgmma m64n128k16 bf16, m64n128k32 s8 or m64n128k8 tf32, both operands
//   K-major in shared memory (the port's (Nq, D) and (Nv, L, D) rows as they
//   are): no transpose, no fragment loads through registers. Every type
//   shares every byte of the data path: one wgmma takes 32 bytes of depth.
// - The epilogue folds the mask (bf16, f32: s * m + (1 - m) * -1e10), the
//   bias (int8: s + bias) or the frame scales (exact: s * inv + bias,
//   inv = 0 and bias = -1e10 on masked frames) and the max over frames into
//   the accumulator registers: within a thread, then across the four lanes
//   of a row (shfl_xor 1, 2); one warpgroup holds all 128 frames of its
//   rows, so one f32 store per (query, video) follows. The (Nq, Nv x L)
//   frame scores never exist. Columns past L are skipped, not scored (a
//   zero-filled frame would score 0); an all-masked video scores -1e10
//   (bf16, f32, exact) or -2^30 / 127^2 (int8). L above 128 walks frame
//   chunks of 128 with the running max kept in registers.
//
// What it leaves unused: the TMA engine, warp specialisation and thread
// block clusters. Every thread issues its share of the cp.async copies,
// and each stage waits for its products before a block barrier. Above 64
// queries the corpus streams once per query tile (exact: four times at
// 256 queries, 856 MB), and exact with one product instead of three moves
// it at about the device memory's rate (scripts/sim_max_variants.py,
// PERF.md): a cluster of the query tiles' blocks sharing each frame stage
// would stream it once. A deeper ring and products left in flight across
// stages did not move it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <mutex>

#include "wgmma.cuh"

namespace {

constexpr int BN = 128;             // frames per chunk: wgmma's N
constexpr int CHUNK = ROW_BYTES;    // bytes of depth per stage
constexpr int UNITS = CHUNK / 16;   // 16-byte units per row of a stage
constexpr int STAGES = 3;
constexpr int KSTEPS = CHUNK / 32;  // one wgmma takes 32 bytes of depth
constexpr int FRAME_TILE = BN * CHUNK;  // bytes of frames in a stage
constexpr float NEG_INF = -1e10f;
// float(1 / (127 * 127)): the f32 constant of sim_max.py:216-217
constexpr float INV_SCALE2 = (float)(1.0 / (127.0 * 127.0));
// shared memory a block may opt into on sm_90
// (cudaDevAttrMaxSharedMemoryPerBlockOptin)
constexpr size_t MAX_SMEM = 232448;

// How a block holds its queries.
enum class Query {
  kCopy,    // rows copied once into a resident tile (bf16, int8)
  kSplit3,  // f32 rows split once into three resident bf16 tiles (exact)
  kStaged,  // f32 depth slices ride each stage, split there (f32)
};

// accumulator d[4 t + x] of a thread: row lane / 4 + 8 (x / 2) of its
// warp's 16, column 8 t + 2 (lane % 4) + x % 2 of the 128
struct Bf16 {
  using Acc = float;
  using Frame = float;  // the (Nv, L) mask, 1 or 0
  static constexpr Query QUERY = Query::kCopy;
  static constexpr int ELEM = 2;    // bytes of a frame value
  static constexpr int FRAMES = 1;  // (Nv, L) arrays the epilogue reads
  static __device__ __forceinline__ Acc lowest() { return -INFINITY; }
  static __device__ __forceinline__ void mma(Acc (&d)[64], uint64_t a,
                                             uint64_t b, int accumulate) {
    wgmma_bf16(d, a, b, accumulate);
  }
  // f: the stage's [FRAMES][BN] per-frame values, n: the column
  static __device__ __forceinline__ Acc masked(Acc s, const Frame* f, int n) {
    const Frame m = f[n];
    return s * m + (1.f - m) * NEG_INF;
  }
  static __device__ __forceinline__ Acc top(Acc a, Acc b) {
    return fmaxf(a, b);
  }
  static __device__ __forceinline__ float finish(Acc best) { return best; }
};

struct Tf32 : Bf16 {
  static constexpr Query QUERY = Query::kStaged;
  static constexpr int ELEM = 4;
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t a,
                                             uint64_t b, int accumulate) {
    wgmma_tf32(d, a, b, accumulate);
  }
};

struct Exact : Bf16 {
  static constexpr Query QUERY = Query::kSplit3;
  static constexpr int FRAMES = 2;  // inv, then bias
  static __device__ __forceinline__ Acc masked(Acc s, const Frame* f, int n) {
    return __fadd_rn(__fmul_rn(s, f[n]), f[BN + n]);
  }
};

struct Int8 {
  using Acc = int;
  using Frame = int;    // the (Nv, L) bias, 0 or -2^30
  static constexpr Query QUERY = Query::kCopy;
  static constexpr int ELEM = 1;
  static constexpr int FRAMES = 1;
  static __device__ __forceinline__ Acc lowest() { return INT_MIN; }
  static __device__ __forceinline__ void mma(Acc (&d)[64], uint64_t a,
                                             uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
          "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
          "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
          "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
          "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
          "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
          "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "l"(a), "l"(b), "r"(accumulate));
  }
  static __device__ __forceinline__ Acc masked(Acc s, const Frame* f, int n) {
    return s + f[n];
  }
  static __device__ __forceinline__ Acc top(Acc a, Acc b) {
    return max(a, b);
  }
  static __device__ __forceinline__ float finish(Acc best) {
    return (float)best * INV_SCALE2;
  }
};

// two bf16 values as one 32-bit word, a at the lower address
__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 a,
                                              __nv_bfloat16 b) {
  return (uint32_t)__bfloat16_as_ushort(a) |
         ((uint32_t)__bfloat16_as_ushort(b) << 16);
}

// a stage of a block's walk: its j-th video, frame chunk c, depth chunk kc,
// and the ring slot it goes through
struct Stage {
  int j = 0, c = 0, kc = 0, slot = 0;
  __device__ __forceinline__ void next(int nk, int nc) {
    if (++slot == STAGES) slot = 0;
    if (++kc == nk) {
      kc = 0;
      if (++c == nc) {
        c = 0;
        ++j;
      }
    }
  }
};

// bytes of a ring stage: the frames' slice, and for kStaged the queries'
template <typename S, int WG>
__host__ __device__ constexpr int stage_bytes() {
  return FRAME_TILE + (S::QUERY == Query::kStaged ? WG * 64 * CHUNK : 0);
}

// bytes of the resident query tiles: [parts][nk][64 WG][CHUNK]
template <typename S, int WG>
__host__ __device__ constexpr size_t resident_bytes(int nk) {
  return (size_t)(S::QUERY == Query::kCopy     ? 1
                  : S::QUERY == Query::kSplit3 ? 3
                                               : 0) *
         nk * 64 * WG * CHUNK;
}

// bytes of the split's scratch tile (kStaged): one stage's small parts
template <typename S, int WG>
__host__ __device__ constexpr int scratch_bytes() {
  return S::QUERY == Query::kStaged ? stage_bytes<S, WG>() : 0;
}

// 1,024 bytes of slack to start the tiles on a 1,024-byte boundary, the
// resident query tiles, the ring [STAGES][stage], the scratch tile and
// the per-frame values of each stage [STAGES][FRAMES][BN]
template <typename S, int WG>
size_t smem_bytes(int dbytes) {
  const int nk = (dbytes + CHUNK - 1) / CHUNK;
  return 1024 + resident_bytes<S, WG>(nk) +
         (size_t)STAGES * stage_bytes<S, WG>() + scratch_bytes<S, WG>() +
         (size_t)STAGES * S::FRAMES * BN * 4;
}

// q (nq, D) and ctx (nv, L, D) as rows (ctx rows of dbytes bytes, a
// multiple of 16; q rows the same, or f32 rows of dbytes / 2 values for
// exact; 16-byte aligned); frame, frame2 = the (nv, L) mask or bias, or
// inv and bias; out (nq, nv) f32. WG warpgroups, each owning 64 queries of
// the block's tile.
template <typename S, int WG>
__global__ void __launch_bounds__(WG * 128, 1)
sim_max_mma_kernel(const unsigned char* __restrict__ q,
                   const unsigned char* __restrict__ ctx,
                   const typename S::Frame* __restrict__ frame,
                   const typename S::Frame* __restrict__ frame2,
                   float* __restrict__ out, int nq, int nv, int L,
                   int dbytes) {
  using Acc = typename S::Acc;
  constexpr int BQ = WG * 64, THREADS = WG * 128;
  constexpr int STAGE_BYTES = stage_bytes<S, WG>();
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw_s = (uint32_t)__cvta_generic_to_shared(smem_raw);
  unsigned char* smem = smem_raw + (((raw_s + 1023) & ~1023u) - raw_s);
  const int nk = (dbytes + CHUNK - 1) / CHUNK;  // depth chunks
  const int nc = (L + BN - 1) / BN;             // frame chunks per video
  const size_t part = (size_t)nk * BQ * CHUNK;  // a resident query tile
  unsigned char* ring = smem + resident_bytes<S, WG>(nk);
  unsigned char* scratch = ring + STAGES * STAGE_BYTES;
  const typename S::Frame* fs = reinterpret_cast<const typename S::Frame*>(
      scratch + scratch_bytes<S, WG>());
  const uint32_t qs_s = (uint32_t)__cvta_generic_to_shared(smem);
  const uint32_t ring_s = (uint32_t)__cvta_generic_to_shared(ring);
  const uint32_t scratch_s = (uint32_t)__cvta_generic_to_shared(scratch);
  const uint32_t fs_s = (uint32_t)__cvta_generic_to_shared(fs);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wg = tid >> 7;           // the warpgroup's 64 queries
  const int wq = (tid >> 5) & 3;     // the warp's 16 of them
  const int q0 = blockIdx.y * BQ;
  const int n_mine = (nv - 1 - (int)blockIdx.x) / (int)gridDim.x + 1;
  const int total = n_mine * nc * nk;
  const int q_units = nk * UNITS;  // 16-byte units of a resident row

  if constexpr (S::QUERY == Query::kCopy) {
    // the query tile, once per block; rows past nq and depth past D are 0
    for (int e = tid; e < BQ * q_units; e += THREADS) {
      const int r = e / q_units, u = e % q_units;
      const bool ok = q0 + r < nq && u * 16 < dbytes;
      cp16(qs_s + (u / UNITS) * (BQ * CHUNK) + swz(r, u % UNITS),
           ok ? q + (size_t)(q0 + r) * dbytes + u * 16 : q, ok ? 16 : 0);
    }
  } else if constexpr (S::QUERY == Query::kSplit3) {
    // the three bf16 parts of the f32 query tile, once per block: a unit
    // of 8 bf16 values of a part is 8 f32 values of the row
    const float* qf = reinterpret_cast<const float*>(q);
    const int d = dbytes / 2;
    for (int e = tid; e < BQ * q_units; e += THREADS) {
      const int r = e / q_units, u = e % q_units;
      float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (q0 + r < nq && u * 16 < dbytes) {
        const float4* src = reinterpret_cast<const float4*>(
            qf + (size_t)(q0 + r) * d + u * 8);
        const float4 lo = src[0], hi = src[1];
        v[0] = lo.x, v[1] = lo.y, v[2] = lo.z, v[3] = lo.w;
        v[4] = hi.x, v[5] = hi.y, v[6] = hi.z, v[7] = hi.w;
      }
      uint32_t w[3][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        __nv_bfloat16 p[3][2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float x = v[2 * i + h];
          p[0][h] = __float2bfloat16_rn(x);
          const float rem = x - __bfloat162float(p[0][h]);
          p[1][h] = __float2bfloat16_rn(rem);
          p[2][h] = __float2bfloat16_rn(rem - __bfloat162float(p[1][h]));
        }
#pragma unroll
        for (int k = 0; k < 3; ++k) w[k][i] = pack_bf16(p[k][0], p[k][1]);
      }
      const size_t off = (u / UNITS) * (BQ * CHUNK) + swz(r, u % UNITS);
#pragma unroll
      for (int k = 0; k < 3; ++k)
        *reinterpret_cast<uint4*>(smem + k * part + off) =
            make_uint4(w[k][0], w[k][1], w[k][2], w[k][3]);
    }
  }

  // this thread copies unit tid % 8 of rows tid / 8 + k * THREADS / 8
  static_assert(BN * UNITS % THREADS == 0, "copies per thread");
  static_assert(BQ * UNITS % THREADS == 0, "copies per thread");
  const int unit = tid & 7;
  Stage ld;  // the next stage to load
  auto load_next = [&]() {
    const size_t row0 =
        (size_t)((int)blockIdx.x + ld.j * (int)gridDim.x) * L + ld.c * BN;
    const int rows = L - ld.c * BN;  // frames of the chunk that exist
    const int byte = ld.kc * CHUNK + unit * 16;
    const uint32_t dst = ring_s + ld.slot * STAGE_BYTES;
#pragma unroll
    for (int k = 0; k < BN * UNITS / THREADS; ++k) {
      const int r = (tid >> 3) + k * (THREADS / 8);
      const bool ok = r < rows && byte < dbytes;
      cp16(dst + swz(r, unit), ok ? ctx + (row0 + r) * dbytes + byte : ctx,
           ok ? 16 : 0);
    }
    if constexpr (S::QUERY == Query::kStaged) {  // the queries' slice
#pragma unroll
      for (int k = 0; k < BQ * UNITS / THREADS; ++k) {
        const int r = (tid >> 3) + k * (THREADS / 8);
        const bool ok = q0 + r < nq && byte < dbytes;
        cp16(dst + FRAME_TILE + swz(r, unit),
             ok ? q + (size_t)(q0 + r) * dbytes + byte : q, ok ? 16 : 0);
      }
    }
    if (ld.kc == nk - 1) {  // the epilogue's per-frame values ride the last
      for (int e = tid; e < S::FRAMES * BN; e += THREADS) {
        const int f = e / BN, n = e % BN;
        const typename S::Frame* src = f ? frame2 : frame;
        cp4(fs_s + ((ld.slot * S::FRAMES + f) * BN + n) * 4,
            n < rows ? src + row0 + n : src, n < rows ? 4 : 0);
      }
    }
    ld.next(nk, nc);
  };

  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < total) load_next();
    cp_commit();  // with kCopy the first group also holds the query tile
  }

  Acc acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;
  Acc best[2];  // rows lane / 4 and lane / 4 + 8 of the warp
  Stage st;     // the stage computed
  for (int i = 0; i < total; ++i, st.next(nk, nc)) {
    cp_wait<STAGES - 2>();
    proxy_fence();
    // stage i landed; every warpgroup is done with stage i - 1's slot and
    // with the scratch tile
    __syncthreads();
    if (i + STAGES - 1 < total) load_next();
    cp_commit();

    const uint32_t b = ring_s + st.slot * STAGE_BYTES;
    if constexpr (S::QUERY == Query::kStaged) {
      // split the stage: big in place, small into the scratch tile
      unsigned char* slot = ring + st.slot * STAGE_BYTES;
      for (int o = tid * 16; o < STAGE_BYTES; o += THREADS * 16) {
        const float4 x = *reinterpret_cast<const float4*>(slot + o);
        const float4 big = make_float4(tf32_big(x.x), tf32_big(x.y),
                                       tf32_big(x.z), tf32_big(x.w));
        *reinterpret_cast<float4*>(slot + o) = big;
        *reinterpret_cast<float4*>(scratch + o) = make_float4(
            x.x - big.x, x.y - big.y, x.z - big.z, x.w - big.w);
      }
      proxy_fence();
      __syncthreads();
    }

    if (st.c == 0 && st.kc == 0) best[0] = best[1] = S::lowest();
    acc_fence(acc);
    wgmma_fence();
    // the first step of a frame chunk overwrites the accumulators
    if constexpr (S::QUERY == Query::kCopy) {
      const uint32_t a = qs_s + st.kc * (BQ * CHUNK) + wg * (64 * CHUNK);
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks)
        S::mma(acc, desc(a + ks * 32), desc(b + ks * 32),
               st.kc > 0 || ks > 0);
    } else if constexpr (S::QUERY == Query::kSplit3) {
      const uint32_t a = qs_s + st.kc * (BQ * CHUNK) + wg * (64 * CHUNK);
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks)
#pragma unroll
        for (int p = 0; p < 3; ++p)
          S::mma(acc, desc(a + p * (uint32_t)part + ks * 32),
                 desc(b + ks * 32), st.kc > 0 || ks > 0 || p > 0);
    } else {
      // A: the queries' big and small, B: the frames'; small.small dropped
      const uint32_t a = b + FRAME_TILE + wg * (64 * CHUNK);
      const uint32_t sb = scratch_s, sa = scratch_s + (a - b);
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        S::mma(acc, desc(sa + ks * 32), desc(b + ks * 32),
               st.kc > 0 || ks > 0);
        S::mma(acc, desc(a + ks * 32), desc(sb + ks * 32), 1);
        S::mma(acc, desc(a + ks * 32), desc(b + ks * 32), 1);
      }
    }
    wgmma_commit();
    wgmma_wait();  // before the slot is refilled and the epilogue reads
    acc_fence(acc);
    if (st.kc != nk - 1) continue;

    // epilogue of frame chunk c
    const typename S::Frame* f = fs + st.slot * S::FRAMES * BN;
#pragma unroll
    for (int t = 0; t < BN / 8; ++t)
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int n = t * 8 + (lane & 3) * 2 + x;
        if (st.c * BN + n < L) {
          best[0] = S::top(best[0], S::masked(acc[4 * t + x], f, n));
          best[1] = S::top(best[1], S::masked(acc[4 * t + 2 + x], f, n));
        }
      }
    if (st.c != nc - 1) continue;

    // last chunk of the video: max over the row's 4 lanes, one store
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      Acc v = best[h];
      v = S::top(v, __shfl_xor_sync(0xffffffffu, v, 1));
      v = S::top(v, __shfl_xor_sync(0xffffffffu, v, 2));
      const int row = q0 + wg * 64 + wq * 16 + h * 8 + (lane >> 2);
      if ((lane & 3) == 0 && row < nq)
        out[(size_t)row * nv + blockIdx.x + (size_t)st.j * gridDim.x] =
            S::finish(v);
    }
  }
  cp_wait<0>();
}

struct Resident {
  int dev = -1;
  size_t smem = 0;
  int blocks = 0;  // blocks resident on the whole card at this smem
};

// blocks of the kernel that fit on the card at once; sets the dynamic
// shared-memory limit once per device
template <typename S, int WG>
int resident_blocks(size_t smem, int* blocks) {
  static std::mutex mu;
  static Resident cache;
  static bool attr_set[64] = {};
  std::lock_guard<std::mutex> lock(mu);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (cache.dev == dev && cache.smem == smem) {
    *blocks = cache.blocks;
    return 0;
  }
  int optin = 0, sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  if (dev < 64 && !attr_set[dev]) {
    err = cudaFuncSetAttribute(sim_max_mma_kernel<S, WG>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin);
    if (err != cudaSuccess) return (int)err;
    attr_set[dev] = true;
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, sim_max_mma_kernel<S, WG>, WG * 128, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  cache = Resident{dev, smem, per_sm * sms};
  *blocks = cache.blocks;
  return 0;
}

template <typename S, int WG>
int launch_tile(const void* q, const void* ctx, const void* frame,
                const void* frame2, void* out, int nq, int nv, int L, int D,
                void* stream) {
  if (nq <= 0 || nv <= 0) return (int)cudaGetLastError();
  const int dbytes = D * S::ELEM;
  const int q_tiles = (nq + WG * 64 - 1) / (WG * 64);
  if (L <= 0 || D <= 0 || dbytes % 16 || (uintptr_t)q % 16 ||
      (uintptr_t)ctx % 16 || q_tiles > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes<S, WG>(dbytes);
  int blocks = 0;
  const int rc = resident_blocks<S, WG>(smem, &blocks);
  if (rc != 0) return rc;
  int gx = (blocks + q_tiles - 1) / q_tiles;
  gx = gx < nv ? gx : nv;
  sim_max_mma_kernel<S, WG>
      <<<dim3(gx, q_tiles), WG * 128, smem, (cudaStream_t)stream>>>(
          (const unsigned char*)q, (const unsigned char*)ctx,
          (const typename S::Frame*)frame, (const typename S::Frame*)frame2,
          (float*)out, nq, nv, L, dbytes);
  return (int)cudaGetLastError();
}

// 64 queries or fewer: one warpgroup per block. More: two, which read the
// corpus half as often, unless two warpgroups' shared memory does not fit
// (bf16 resident rows above D = 704, int8 above 1,408; exact always, at
// 144 KB of split query rows per warpgroup at D = 384). One warpgroup fits
// bf16 up to D = 1,408, int8 up to 2,816, exact up to 448 and f32 at any D
// (its queries ride the ring); beyond, the launch returns
// cudaErrorInvalidValue.
template <typename S>
int launch(const void* q, const void* ctx, const void* frame,
           const void* frame2, void* out, int nq, int nv, int L, int D,
           void* stream) {
  if (nq > 64 && smem_bytes<S, 2>(D * S::ELEM) <= MAX_SMEM)
    return launch_tile<S, 2>(q, ctx, frame, frame2, out, nq, nv, L, D,
                             stream);
  return launch_tile<S, 1>(q, ctx, frame, frame2, out, nq, nv, L, D, stream);
}

}  // namespace

// q (nq, D) bf16, ctx (nv, L, D) bf16, mask (nv, L) f32 -> out (nq, nv) f32.
// D % 8 == 0 and q, ctx 16-byte aligned (the wrapper pads and checks).
extern "C" int sim_max_bf16(const void* q, const void* ctx, const void* mask,
                            void* out, int nq, int nv, int L, int D,
                            void* stream) {
  return launch<Bf16>(q, ctx, mask, mask, out, nq, nv, L, D, stream);
}

// q (nq, D) f32, ctx (nv, L, D) f32, mask (nv, L) f32 -> out (nq, nv) f32.
// D % 4 == 0 and q, ctx 16-byte aligned (the wrapper pads and checks).
extern "C" int sim_max_f32(const void* q, const void* ctx, const void* mask,
                           void* out, int nq, int nv, int L, int D,
                           void* stream) {
  return launch<Tf32>(q, ctx, mask, mask, out, nq, nv, L, D, stream);
}

// q (nq, D) int8, ctx (nv, L, D) int8, bias (nv, L) int32 -> out (nq, nv)
// f32. D % 16 == 0 and q, ctx 16-byte aligned (the wrapper pads and checks).
extern "C" int sim_max_int8(const void* q, const void* ctx, const void* bias,
                            void* out, int nq, int nv, int L, int D,
                            void* stream) {
  return launch<Int8>(q, ctx, bias, bias, out, nq, nv, L, D, stream);
}

// q (nq, D) f32 L2-normalized, ctx (nv, L, D) raw bf16, inv and bias
// (nv, L) f32 -> out (nq, nv) f32. D % 8 == 0, D <= 448, and q, ctx
// 16-byte aligned (the wrapper pads and checks).
extern "C" int sim_max_exact(const void* q, const void* ctx, const void* inv,
                             const void* bias, void* out, int nq, int nv,
                             int L, int D, void* stream) {
  return launch<Exact>(q, ctx, inv, bias, out, nq, nv, L, D, stream);
}
