// Encoder towers for inference: the query tower (pooled vectors) and the
// video tower (frame features) of one branch or of two branches at once,
// as a short chain of kernels per launch. This file holds the chain's int8
// epilogue, a pass bound by device memory (step 7's note below); csrc/
// tower_mma.cu holds the rest: the input normalization, the matrix
// products on the tensor cores with the LayerNorms and the query tower's
// pooling in their epilogues, and the attention. Both dtypes run the same
// chain.
//
// Replaces dldkd_tpu/ops/pallas/query_tower.py:
//   _dual_query_tower_kernel   (two branches, query tower)
//   _dual_context_tower_kernel (two branches, video tower)
//   _query_tower_kernel, _context_tower_kernel (their one-branch forms)
//   _quantize_q8 (:144) / _map_context(emit_q8=True) (:168), the video
//   towers' int8 epilogue (step 7 below, this file), with its transposed
//   write (_map_context(transposed=True), fused_context_tower_dual's
//   q8_transposed)
//
// Per branch the tower is: affine-free input LayerNorm (f32 statistics,
// E[x^2] - mu^2, eps 1e-5; shared by the branches) -> folded input
// projection + ReLU -> + positions, LayerNorm -> multi-head self-attention
// with (1 - mask) * -10000 on the keys -> output projection + residual,
// LayerNorm -> modular softmax pooling (query) or out_mapping_linear
// (video). The chain (the TPU kernel keeps a whole tile and both branches'
// weights in ~100 MB of VMEM; a Hopper block has 227 KB of shared memory,
// so the intermediates between launches go through device memory, where at
// 200 videos they stay in the 50 MB L2):
//   1. normalize   (tower_mma.cu) input LayerNorm, once for all branches
//   2. gemm_rows   folded projection, one read of the input for all
//                  branches, a block per (64 rows, branch); epilogue bias,
//                  ReLU, + positions, then the LayerNorm of each row
//   3. gemm_mma    Q|K|V, batched over branches
//   4. attention_mma
//   5. gemm_rows   output projection; epilogue bias + residual, then the
//                  LayerNorm; in the query tower also the pooling, which
//                  writes only the (G, Nq, H) f32 vectors: the query
//                  tower's last step
//   6. gemm_mma    out_mapping_linear (video tower)
//   7. quantize_q8 (video tower with emit_q8, this file): per-frame L2 norm
//                  and int8; the T frames of step 6 then live only in a
//                  scratch buffer
// Query tower: 5 launches; video tower: 6, 7 with emit_q8. The TPU kernel
// fuses the LayerNorms and the pooling into its trunk (query_tower.py:86,
// 118, 208, 226); steps 2 and 5 do the same in their products' epilogues.
//
// Widths: a group of `gs` columns (the hidden size H padded to a multiple of
// 8, zeros past H) holds each branch; statistics and pooling run over the
// true H; gamma, beta and the pooling vector are zero past H, so the padded
// columns come out zero.
//
// Rounding: the kernels take the tower dtype T; with T = bf16 every value
// is rounded to bf16 where the Pallas kernel casts to the tower dtype
// (query_tower.py:82, 85-86, 93, 107, 111, 117), and the pooled query
// vectors stay f32. With T = f32 every rounding is the identity.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "wgmma.cuh"  // smem_u32, cp16, cp_commit, cp_wait, smem_opt_in

namespace {

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T narrow(float x);
template <> __device__ __forceinline__ float narrow<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(
    float x) {
  return __float2bfloat16_rn(x);
}

// round an f32 value to T and back (identity for T = f32)
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return widen(narrow<T>(x));
}

// round_T(x * x). In bf16 one bf16 product: the product of two bf16 values
// is exact in f32, so rounding it once to bf16 gives the f32 product
// rounded to bf16 (`tower_q8_reciprocal_check` also tries all 65,536)
__device__ __forceinline__ float square_to(float x) { return __fmul_rn(x, x); }
__device__ __forceinline__ float square_to(__nv_bfloat16 x) {
  return __bfloat162float(__hmul(x, x));
}

// round two f32 values to T and back: one packed convert for bf16
template <typename T>
__device__ __forceinline__ void round2_to(float& a, float& b) {
  if constexpr (sizeof(T) == 2) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    a = __low2float(h);
    b = __high2float(h);
  }
}

// ---------------------------------------------------------------------------
// 7 (video tower, emit_q8). The int8-index epilogue: per-frame L2
// normalization and symmetric int8 quantization of the out_mapping_linear
// rows (T values), at the rounding points of the TPU epilogue
// (query_tower.py:158-165): sq = round_T(x * x); s = f32 sum of sq,
// rounded to T; n = round_T(sqrt(s)); xn = round_T(x / max(n, 1e-12));
// q = clamp(rint(xn * 127), +-127), rint rounding half to even. The sum
// runs in one fixed order, which the plain version
// (ops/kernels/query_tower.py:_warp_order_sum) writes out: lane l adds
// sq[l], sq[l + 32], ... in turn, then a butterfly over the lanes (xor 16,
// 8, 4, 2, 1). Explicit _rn intrinsics keep the compiler from contracting
// a product into an FMA, so the kernel and its plain version agree bitwise
// in f32 and in bf16.
//
// Where a row goes. Input row r of the (M, ldx) rows (H values each) is
// written either in place, at r * H of an (M, H) output, or, in the
// transposed mode (nv_p > 0), into the TPU scoring layout: the rows are G
// branches of rows_per_branch rows, each branch's rows are sequences of
// seq_l frames, and frame l of the sub-launch's video v (the video v_off + v
// of the whole launch) goes to ((g * l_p + l) * nv_p + v_off + v) * H of a
// (G, l_p, nv_p, H) output. Only the address changes: the rounding is the
// same in both modes, and each frame's H bytes are contiguous in both, so
// the same stores serve both. Addresses are size_t: nv_p * l_p * H passes
// 2^31 from about 43k videos at H = 384.
//
// Replaces dldkd_tpu/ops/pallas/query_tower.py:144 _quantize_q8 and :168
// _map_context(emit_q8=True), with q8_transposed the transposed write of
// _map_context(transposed=True) and fused_context_tower_dual
// (query_tower.py:168-193, 447-511); the TPU fuses it into the tower
// kernel, here it is one more pass over the rows the out_mapping product
// just left behind (its 128-column tiles would need a cluster exchange per
// row to fold it in, which costs more than this pass).
//
// Bound: bytes. Each value is read once (2 bytes in bf16, 4 in f32) and its
// int8 written once: 3 or 5 bytes a value, at 3.35 TB/s about 1.1e12 bf16
// values/s. At that rate a value may take about 30 lane-instructions and
// 4 conversions (the conversion pipe gives 16 results a clock an SM),
// which a pass spending an IEEE divide, a rint and three converts on each
// value exceeds. The design (about 1.5 converts a bf16 value):
// - one read of each row from device memory: a warp stages whole rows in
//   shared memory with 16-byte cp.async copies (L2 only), the next row's
//   copies in flight while it quantizes one, and reads every value from
//   there: strided for the sum (its fixed order), 16 contiguous values a
//   lane for the int8 values;
// - a persistent grid of warps over rows, as many as the SMs hold at once
//   but balanced so that every warp takes the same number of rows;
// - in bf16 the squares as bf16 products (square_to) and one reciprocal a
//   row in place of a divide a value: round_bf16(x * RN(1/n)) is
//   round_bf16(RN(x / n)) for every bf16 x and every bf16 n >= 1e-12 (a
//   quotient of two bf16 values lies at least 2^-17 of its size from any
//   bf16 rounding boundary, while x * RN(1/n) is within about 2^-23 of
//   it; `tower_q8_reciprocal_check` below tries all 2^32 pairs on the
//   card); norms under 1e-12, where the divisor is the f32 value 1e-12,
//   keep the divide, as f32 does everywhere;
// - the quotients rounded to bf16 two at a time (one packed convert); rint
//   and the int8 convert as one add of 1.5 * 2^23 (q8_bits), the clamp
//   only on rows whose sum is not finite;
// - 16 int8 values a lane in one 16-byte store, and 16-byte copies in,
//   where H % 16 == 0 and every row starts 16-byte aligned in and out;
//   else one value at a time.
// A warp's two staged rows must fit in the block's shared memory (H up to
// about 29,000 in f32, 58,000 in bf16); a wider row is refused. What the
// design reaches on an H100, and what still bounds it, is in PERF.md.
// ---------------------------------------------------------------------------

// xn before its rounding to T: x / max(n, 1e-12), as a divide or (bf16,
// n >= 1e-12) a product with the row's reciprocal
struct ByDivide {
  float d;
  __device__ __forceinline__ float operator()(float v) const {
    return __fdiv_rn(v, d);
  }
};
struct ByReciprocal {
  float r;
  __device__ __forceinline__ float operator()(float v) const {
    return __fmul_rn(v, r);
  }
};

template <typename T>
__device__ __forceinline__ bool use_reciprocal(float n) {
  return sizeof(T) == 2 && n >= 1e-12f;  // false for a NaN norm
}

// The low byte of the result is clamp(rint(xn * 127), +-127) as an int8:
// adding 1.5 * 2^23 rounds half to even to an integer whose low byte it
// is. The clamp (CLAMP) is needed only where the row's sum is not finite:
// with a finite sum each rounding is monotone, so the norm is at least
// every |x| of the row and |xn| <= 1; an inf or NaN row takes the clamp
// (a NaN xn gives -127, as fmaxf(NaN, -127) does in the plain clamp). In
// bf16, xn * 127 is exact in f32, so one fma rounds it to the integer.
template <typename T, bool CLAMP>
__device__ __forceinline__ uint32_t q8_bits(float xn) {
  constexpr float kMagic = 12582912.f;  // 1.5 * 2^23
  if constexpr (CLAMP) {
    const float t = fminf(fmaxf(__fmul_rn(xn, 127.f), -127.f), 127.f);
    return __float_as_uint(__fadd_rn(t, kMagic));
  } else if constexpr (sizeof(T) == 2) {
    return __float_as_uint(__fmaf_rn(xn, 127.f, kMagic));
  } else {
    return __float_as_uint(__fadd_rn(__fmul_rn(xn, 127.f), kMagic));
  }
}

__device__ __forceinline__ uint32_t pack4(uint32_t b0, uint32_t b1,
                                          uint32_t b2, uint32_t b3) {
  return __byte_perm(__byte_perm(b0, b1, 0x0040), __byte_perm(b2, b3, 0x0040),
                     0x5410);
}

// the 16 values of a 16-byte aligned chunk in shared memory, as f32
__device__ __forceinline__ void load16(const float* p, float (&v)[16]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 w = reinterpret_cast<const float4*>(p)[i];
    v[4 * i] = w.x;
    v[4 * i + 1] = w.y;
    v[4 * i + 2] = w.z;
    v[4 * i + 3] = w.w;
  }
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p,
                                       float (&v)[16]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint4 w = reinterpret_cast<const uint4*>(p)[i];
    const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[8 * i + 2 * j] = __uint_as_float(u[j] << 16);
      v[8 * i + 2 * j + 1] = __uint_as_float(u[j] & 0xffff0000u);
    }
  }
}

// the int8 values of a staged row (16 a lane) from its quotient `quot`
template <typename T, bool VEC, bool CLAMP, class Quot>
__device__ __forceinline__ void store_row(const T* xs, signed char* yr,
                                          int H, int lane, Quot quot) {
  for (int c = lane * 16; c < H; c += 32 * 16) {
    float v[16];
    load16(xs + c, v);
    uint32_t w[4];
#pragma unroll
    for (int j = 0; j < 16; j += 4) {
      float a = quot(v[j]), b = quot(v[j + 1]), e = quot(v[j + 2]),
            f = quot(v[j + 3]);
      round2_to<T>(a, b);
      round2_to<T>(e, f);
      w[j / 4] = pack4(q8_bits<T, CLAMP>(a), q8_bits<T, CLAMP>(b),
                       q8_bits<T, CLAMP>(e), q8_bits<T, CLAMP>(f));
    }
    if constexpr (VEC) {
      *reinterpret_cast<uint4*>(yr + c) = make_uint4(w[0], w[1], w[2], w[3]);
    } else {
      for (int j = 0; j < 16 && c + j < H; ++j)
        yr[c + j] = (signed char)(w[j / 4] >> (8 * (j % 4)));
    }
  }
}

// copy row xr (H values) into the warp's buffer xs; with VEC as 16-byte
// cp.async copies (zero-filled past H), else value by value
template <typename T, bool VEC>
__device__ __forceinline__ void stage_row(T* xs, const T* xr, int H,
                                          int lane) {
  if constexpr (VEC) {
    const int bytes = H * (int)sizeof(T);
    for (int o = lane * 16; o < bytes; o += 32 * 16)
      cp16(smem_u32(reinterpret_cast<char*>(xs) + o),
           reinterpret_cast<const char*>(xr) + o, min(16, bytes - o));
  } else {
    for (int k = lane; k < H; k += 32) xs[k] = xr[k];
  }
}

// the norm and the int8 values of one staged row
template <typename T, bool VEC>
__device__ __forceinline__ void quantize_row(const T* xs, signed char* yr,
                                             int H, int lane) {
  float s = 0.f;
  for (int k = lane; k < H; k += 32) s = __fadd_rn(s, square_to(xs[k]));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
  const float n = round_to<T>(__fsqrt_rn(round_to<T>(s)));
  const bool finite = isfinite(s);
  if (use_reciprocal<T>(n)) {
    const ByReciprocal q{__frcp_rn(n)};
    finite ? store_row<T, VEC, false>(xs, yr, H, lane, q)
           : store_row<T, VEC, true>(xs, yr, H, lane, q);
  } else {
    const ByDivide q{fmaxf(n, 1e-12f)};
    finite ? store_row<T, VEC, false>(xs, yr, H, lane, q)
           : store_row<T, VEC, true>(xs, yr, H, lane, q);
  }
}

// Each warp takes rows warp, warp + nw, ... (nw warps in the grid) through
// two buffers of hs = round_up(H, 16) values in shared memory: the next
// row's copies are in flight while it quantizes one. (A deeper ring, tiles
// of videos in the transposed write's order and smaller blocks measured no
// faster.)
template <typename T, bool VEC>
__global__ void __launch_bounds__(256)
    quantize_q8_kernel(const T* __restrict__ x, signed char* __restrict__ y,
                       int M, int H, int ldx, int rows_per_branch, int seq_l,
                       int nv_p, int l_p, int v_off, int hs) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warps = blockDim.x / 32, lane = threadIdx.x % 32;
  T* const buf = reinterpret_cast<T*>(smem_raw) +
                 (size_t)(threadIdx.x / 32) * 2 * hs;
  const int nw = gridDim.x * warps;
  int row = blockIdx.x * warps + threadIdx.x / 32;
  if (row < M) stage_row<T, VEC>(buf, x + (size_t)row * ldx, H, lane);
  cp_commit();
  for (int i = 0; row < M; ++i, row += nw) {
    if (row + nw < M)
      stage_row<T, VEC>(buf + ((i + 1) & 1) * hs,
                        x + (size_t)(row + nw) * ldx, H, lane);
    cp_commit();
    cp_wait<1>();  // this row's copies (all but the newest group)
    __syncwarp();
    size_t out = (size_t)row * H;
    if (nv_p > 0) {
      const int g = row / rows_per_branch, r = row % rows_per_branch;
      const int v = r / seq_l, l = r % seq_l;
      out = (((size_t)g * l_p + l) * nv_p + (size_t)(v_off + v)) * H;
    }
    quantize_row<T, VEC>(buf + (i & 1) * hs, y + out, H, lane);
    __syncwarp();  // the buffer is free for the row after next
  }
}

inline int launch_rc() { return (int)cudaGetLastError(); }

template <typename T, bool VEC>
int quantize_q8(const T* x, signed char* y, int M, int H, int ldx,
                int rows_per_branch, int seq_l, int nv_p, int l_p, int v_off,
                cudaStream_t s) {
  auto kernel = quantize_q8_kernel<T, VEC>;
  int dev = 0, sms = 0, smem_max = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  const int hs = (H + 15) / 16 * 16;
  const size_t warp_bytes = 2 * (size_t)hs * sizeof(T);
  const int warps = (int)(smem_max / warp_bytes < 8 ? smem_max / warp_bytes
                                                    : 8);
  if (warps == 0) return (int)cudaErrorInvalidValue;  // row too wide
  const size_t smem = warps * warp_bytes;
  if (smem > 48 * 1024) {
    const cudaError_t rc =
        smem_opt_in<quantize_q8_kernel<T, VEC>>((int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, warps * 32,
                                                smem);
  // every warp takes `iters` rows (the last ones one fewer at most)
  const long long most = (long long)(per_sm > 0 ? per_sm : 1) * sms * warps;
  const long long iters = (M + most - 1) / most;
  const long long want = (M + iters - 1) / iters;
  const int grid = (int)((want + warps - 1) / warps);
  kernel<<<grid, warps * 32, smem, s>>>(x, y, M, H, ldx, rows_per_branch,
                                        seq_l, nv_p, l_p, v_off, hs);
  return launch_rc();
}

// 16-byte copies and stores where every row starts 16-byte aligned in
// and out and H % 16 == 0 (the towers' padded rows at the serving width),
// else value by value
template <typename T>
int quantize_q8_any(const void* x, void* y, int M, int H, int ldx,
                    int rows_per_branch, int seq_l, int nv_p, int l_p,
                    int v_off, void* s) {
  if (M <= 0 || H <= 0) return launch_rc();
  const bool vec = (uintptr_t)x % 16 == 0 &&
                   ((size_t)ldx * sizeof(T)) % 16 == 0 &&
                   (uintptr_t)y % 16 == 0 && H % 16 == 0;
  const T* xt = (const T*)x;
  signed char* yt = (signed char*)y;
  cudaStream_t st = (cudaStream_t)s;
  if (vec)
    return quantize_q8<T, true>(xt, yt, M, H, ldx, rows_per_branch, seq_l,
                                nv_p, l_p, v_off, st);
  return quantize_q8<T, false>(xt, yt, M, H, ldx, rows_per_branch, seq_l,
                               nv_p, l_p, v_off, st);
}

// The reciprocal's proof: for every bf16 norm n (the block) and every bf16
// value x (the block's threads, 256 each), the bf16 quotient the epilogue
// takes for that norm (`use_reciprocal`) against round_bf16(RN(x /
// max(n, 1e-12))), the parent's divide; counts the pairs whose bf16 bits
// differ (two NaNs agree).
__global__ void __launch_bounds__(256)
    q8_reciprocal_check_kernel(unsigned long long* mismatches) {
  const float n = __uint_as_float((uint32_t)blockIdx.x << 16);
  const float d = fmaxf(n, 1e-12f);
  const bool rcp = use_reciprocal<__nv_bfloat16>(n);
  const float r = __frcp_rn(n);
  unsigned long long bad = 0;
  for (int i = threadIdx.x; i < 65536; i += 256) {
    const float x = __uint_as_float((uint32_t)i << 16);
    const float want = round_to<__nv_bfloat16>(__fdiv_rn(x, d));
    float got = rcp ? ByReciprocal{r}(x) : ByDivide{d}(x), other = 0.f;
    round2_to<__nv_bfloat16>(got, other);
    bad += __float_as_uint(got) != __float_as_uint(want) &&
           !(isnan(got) && isnan(want));
  }
  if (threadIdx.x == 0) {  // the square of the block's value as a bf16
    const __nv_bfloat16 v = __float2bfloat16_rn(n);  // exact: n is bf16
    const float got_sq = square_to(v);
    const float want_sq = round_to<__nv_bfloat16>(__fmul_rn(n, n));
    bad += __float_as_uint(got_sq) != __float_as_uint(want_sq) &&
           !(isnan(got_sq) && isnan(want_sq));
  }
  if (bad) atomicAdd(mismatches, bad);
}

}  // namespace

// ---------------------------------------------------------------------------
// C interface. `bf16` selects T = bf16 (else f32).
// ---------------------------------------------------------------------------

// x (M, ldx) in T, H values a row -> y int8: (M, H) in place with
// nv_p = 0; with nv_p > 0 the transposed write into (G, l_p, nv_p, H), G =
// M / rows_per_branch branches of rows_per_branch / seq_l videos of seq_l
// frames, the sub-launch's first video at v_off (step 7's note)
extern "C" int tower_quantize_q8(const void* x, void* y, int M, int H,
                                 int ldx, int rows_per_branch, int seq_l,
                                 int nv_p, int l_p, int v_off, int bf16,
                                 void* s) {
  if (ldx < H) return (int)cudaErrorInvalidValue;
  if (nv_p > 0 && (seq_l <= 0 || seq_l > l_p || rows_per_branch <= 0 ||
                   rows_per_branch % seq_l != 0 ||
                   M % rows_per_branch != 0 || v_off < 0 ||
                   v_off + rows_per_branch / seq_l > nv_p))
    return (int)cudaErrorInvalidValue;
  return bf16 ? quantize_q8_any<__nv_bfloat16>(x, y, M, H, ldx,
                                               rows_per_branch, seq_l, nv_p,
                                               l_p, v_off, s)
              : quantize_q8_any<float>(x, y, M, H, ldx, rows_per_branch,
                                       seq_l, nv_p, l_p, v_off, s);
}

// mismatches: one zeroed uint64 on the card; adds the count of bf16
// (value, norm) pairs, of all 2^32, where the epilogue's quotient differs
// from the divide's (q8_reciprocal_check_kernel)
extern "C" int tower_q8_reciprocal_check(void* mismatches, void* s) {
  q8_reciprocal_check_kernel<<<65536, 256, 0, (cudaStream_t)s>>>(
      (unsigned long long*)mismatches);
  return launch_rc();
}
