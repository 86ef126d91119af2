// Encoder towers for inference: the query tower (pooled vectors) and the
// video tower (frame features) of one branch or of two branches at once,
// as a short chain of kernels per launch. This file holds the chain's
// LayerNorm, pooling and int8 epilogue; csrc/tower_mma.cu holds its input
// normalization, matrix products and attention on the tensor cores. Both
// dtypes run the same chain.
//
// Replaces dldkd_tpu/ops/pallas/query_tower.py:
//   _dual_query_tower_kernel   (two branches, query tower)
//   _dual_context_tower_kernel (two branches, video tower)
//   _query_tower_kernel, _context_tower_kernel (their one-branch forms)
//   _quantize_q8 / _map_context(emit_q8=True), the video towers' int8
//   epilogue (kernel 9 below), with its transposed write
//   (_map_context(transposed=True), fused_context_tower_dual's
//   q8_transposed)
//
// Per branch the tower is: affine-free input LayerNorm (f32 statistics,
// E[x^2] - mu^2, eps 1e-5; shared by the branches) -> folded input
// projection + ReLU -> + positions, LayerNorm -> multi-head self-attention
// with (1 - mask) * -10000 on the keys -> output projection + residual,
// LayerNorm -> modular softmax pooling (query) or out_mapping_linear
// (video). The chain (the TPU kernel keeps a whole tile and both branches'
// weights in ~100 MB of VMEM; a Hopper block has 227 KB of shared memory,
// so the intermediates go through device memory, where at 200 videos they
// stay in the 50 MB L2):
//   1. normalize   (tower_mma.cu) input LayerNorm, once for all branches
//   2. gemm_mma    folded projection over all branches' columns at once
//                  (one read of the input); epilogue bias, ReLU, + positions
//   3. layernorm   per branch (grouped columns)
//   4. gemm_mma    Q|K|V, batched over branches
//   5. attention_mma
//   6. gemm_mma    output projection, epilogue bias + residual
//   7. layernorm
//   8. pool (query tower) or gemm_mma out_mapping_linear (video tower)
//   9. quantize_q8 (video tower with emit_q8): per-frame L2 norm and int8;
//      the T frames of step 8 then live only in a scratch buffer
//
// What bounds this file's kernels on an H100: bytes, each a single pass
// over rows the previous kernel just left in L2, one warp per row (or per
// (row, branch)); f32 statistics from one read, the output from a second.
//   3/7 layernorm  reads the product's T rows, writes T rows: at 200 videos
//                  x 128 frames x 768 columns 157 MB in f32, 79 MB in bf16.
//   8 pool         reads the LayerNorm's rows twice (logits, then the
//                  weighted sum), one block per (sequence, branch).
//   9 quantize_q8  reads T, writes int8 (below).
// The TPU kernel fuses them into its products; fusing them here (into the
// products' epilogues) is later work.
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

namespace {

constexpr float NEG_INF = -1e10f;     // pooling mask (mask_logits)
constexpr float LN_EPS = 1e-5f;

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

// ---------------------------------------------------------------------------
// 3/7. LayerNorm over groups of gs columns: row m, group g reads
// x[m * ld + g * gs .. + gs) and gamma/beta[g * gs ..] (zero past H), and
// takes its statistics over the first H. One warp per (row, group); f32
// statistics (E[x^2] - mu^2); output rounded to T.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void layernorm_kernel(const T* __restrict__ x, T* __restrict__ y,
                                 const float* __restrict__ gamma,
                                 const float* __restrict__ beta, int M, int G,
                                 int H, int gs, int ld) {
  const int item = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (item >= M * G) return;
  const int m = item / G, grp = item % G;
  const size_t row = (size_t)m * ld + (size_t)grp * gs;
  const T* xr = x + row;
  const float* ga = gamma + (size_t)grp * gs;
  const float* be = beta + (size_t)grp * gs;
  float s = 0.f, ss = 0.f;
  for (int k = lane; k < H; k += 32) {
    const float v = widen(xr[k]);
    s += v;
    ss = fmaf(v, v, ss);
  }
  s = warp_sum(s);
  ss = warp_sum(ss);
  const float mu = s / H;
  const float rs = 1.0f / sqrtf(ss / H - mu * mu + LN_EPS);
  for (int k = lane; k < gs; k += 32)
    y[row + k] = narrow<T>((widen(xr[k]) - mu) * rs * ga[k] + be[k]);
}

// ---------------------------------------------------------------------------
// 8 (query tower). Modular pooling: logits = x . wm (f32 sum of T values),
// masked to -1e10 where mask == 0, softmax over tokens, pooled = sum of
// x * weights in f32. x row m, branch g at x[m * ld + g * gs], H values;
// wm is (G, gs) f32 holding T values; pooled is (G, Nseq, H) f32. One block
// per (sequence, branch).
// ---------------------------------------------------------------------------
constexpr int P_THREADS = 256, P_WARPS = P_THREADS / 32;

template <typename T>
__global__ void __launch_bounds__(P_THREADS)
pool_kernel(const T* __restrict__ x, const float* __restrict__ mask,
            const float* __restrict__ wm, float* __restrict__ pooled,
            int Nseq, int L, int H, int gs, int ld) {
  extern __shared__ float att[];  // L
  const int seq = blockIdx.x, br = blockIdx.y;
  const T* xs = x + (size_t)seq * L * ld + (size_t)br * gs;
  const float* w = wm + (size_t)br * gs;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int l = warp; l < L; l += P_WARPS) {
    float s = 0.f;
    for (int d = lane; d < H; d += 32)
      s = fmaf(widen(xs[(size_t)l * ld + d]), w[d], s);
    s = warp_sum(s);
    if (lane == 0) att[l] = mask[(size_t)seq * L + l] > 0.f ? s : NEG_INF;
  }
  __syncthreads();
  if (warp == 0) {
    float mx = -INFINITY;
    for (int l = lane; l < L; l += 32) mx = fmaxf(mx, att[l]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int l = lane; l < L; l += 32) {
      const float e = expf(att[l] - mx);
      att[l] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    __syncwarp();
    for (int l = lane; l < L; l += 32) att[l] = att[l] / sum;
  }
  __syncthreads();
  float* out = pooled + ((size_t)br * Nseq + seq) * H;
  for (int d = threadIdx.x; d < H; d += P_THREADS) {
    float acc = 0.f;
    for (int l = 0; l < L; ++l)
      acc = fmaf(widen(xs[(size_t)l * ld + d]), att[l], acc);
    out[d] = acc;
  }
}

// ---------------------------------------------------------------------------
// 9 (video tower, emit_q8). The int8-index epilogue: per-frame L2
// normalization and symmetric int8 quantization of the out_mapping_linear
// rows (T values), at the rounding points of the TPU epilogue
// (query_tower.py:158-165): sq = round_T(x * x); s = f32 sum of sq,
// rounded to T; n = round_T(sqrt(s)); xn = round_T(x / max(n, 1e-12));
// q = clamp(rint(xn * 127), +-127), rint rounding half to even. One warp
// per row. The sum runs in one fixed order, which the plain version
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
// same in both modes. Addresses are size_t: nv_p * l_p * H passes 2^31 from
// about 43k videos at H = 384.
//
// Replaces dldkd_tpu/ops/pallas/query_tower.py:_quantize_q8 and
// _map_context(emit_q8=True), with q8_transposed the transposed write of
// _map_context(transposed=True) and fused_context_tower_dual
// (query_tower.py:168-193, 447-511). Bound: bytes (read T, write int8);
// the TPU fuses it into the tower kernel, here it is one more pass over the
// rows the out_mapping product just left in L2. The transposed mode writes
// each frame's H-byte row (384 bytes at the serving width) to its own place,
// nv_p * H bytes from the next frame's: those scattered row writes are this
// design's cost against the in-place write.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void quantize_q8_kernel(const T* __restrict__ x,
                                   signed char* __restrict__ y, int M, int H,
                                   int ldx, int rows_per_branch, int seq_l,
                                   int nv_p, int l_p, int v_off) {
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= M) return;
  const T* xr = x + (size_t)row * ldx;
  size_t out = (size_t)row * H;
  if (nv_p > 0) {
    const int g = row / rows_per_branch, r = row % rows_per_branch;
    const int v = r / seq_l, l = r % seq_l;
    out = (((size_t)g * l_p + l) * nv_p + (size_t)(v_off + v)) * H;
  }
  signed char* yr = y + out;
  float s = 0.f;
  for (int k = lane; k < H; k += 32) {
    const float v = widen(xr[k]);
    s = __fadd_rn(s, round_to<T>(__fmul_rn(v, v)));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
  const float n = round_to<T>(__fsqrt_rn(round_to<T>(s)));
  const float d = fmaxf(n, 1e-12f);
  for (int k = lane; k < H; k += 32) {
    const float xn = round_to<T>(__fdiv_rn(widen(xr[k]), d));
    const float q = fminf(fmaxf(rintf(__fmul_rn(xn, 127.f)), -127.f), 127.f);
    yr[k] = (signed char)q;
  }
}

inline int launch_rc() { return (int)cudaGetLastError(); }

template <typename T>
int layernorm(const void* x, void* y, const void* gamma, const void* beta,
              int M, int G, int H, int gs, int ld, void* s) {
  if (M > 0 && G > 0) {
    const int per_block = 256 / 32;
    layernorm_kernel<T><<<(M * G + per_block - 1) / per_block, 256, 0,
                          (cudaStream_t)s>>>(
        (const T*)x, (T*)y, (const float*)gamma, (const float*)beta, M, G, H,
        gs, ld);
  }
  return launch_rc();
}

template <typename T>
int pool(const void* x, const void* mask, const void* wm, void* pooled,
         int G, int Nseq, int L, int H, int gs, int ld, void* s) {
  if (G > 0 && Nseq > 0) {
    pool_kernel<T><<<dim3(Nseq, G), P_THREADS, sizeof(float) * L,
                     (cudaStream_t)s>>>((const T*)x, (const float*)mask,
                                        (const float*)wm, (float*)pooled,
                                        Nseq, L, H, gs, ld);
  }
  return launch_rc();
}

template <typename T>
int quantize_q8(const void* x, void* y, int M, int H, int ldx,
                int rows_per_branch, int seq_l, int nv_p, int l_p, int v_off,
                void* s) {
  if (M > 0 && H > 0) {
    const int rows_per_block = 256 / 32;
    quantize_q8_kernel<T><<<(M + rows_per_block - 1) / rows_per_block, 256,
                            0, (cudaStream_t)s>>>(
        (const T*)x, (signed char*)y, M, H, ldx, rows_per_branch, seq_l, nv_p,
        l_p, v_off);
  }
  return launch_rc();
}

}  // namespace

// ---------------------------------------------------------------------------
// C interface. `bf16` selects T = bf16 (else f32).
// ---------------------------------------------------------------------------

// x (M, ld) -> y (M, ld), G groups of gs columns, statistics over H
extern "C" int tower_layernorm(const void* x, void* y, const void* gamma,
                               const void* beta, int M, int G, int H, int gs,
                               int ld, int bf16, void* s) {
  if (H <= 0 || gs < H) return (int)cudaErrorInvalidValue;
  return bf16 ? layernorm<__nv_bfloat16>(x, y, gamma, beta, M, G, H, gs, ld,
                                         s)
              : layernorm<float>(x, y, gamma, beta, M, G, H, gs, ld, s);
}

// x (Nseq * L, ld), G groups of gs columns -> pooled (G, Nseq, H) f32
extern "C" int tower_pool(const void* x, const void* mask, const void* wm,
                          void* pooled, int G, int Nseq, int L, int H, int gs,
                          int ld, int bf16, void* s) {
  if (H <= 0 || gs < H) return (int)cudaErrorInvalidValue;
  return bf16 ? pool<__nv_bfloat16>(x, mask, wm, pooled, G, Nseq, L, H, gs,
                                    ld, s)
              : pool<float>(x, mask, wm, pooled, G, Nseq, L, H, gs, ld, s);
}

// x (M, ldx) in T, H values a row -> y int8: (M, H) in place with
// nv_p = 0; with nv_p > 0 the transposed write into (G, l_p, nv_p, H), G =
// M / rows_per_branch branches of rows_per_branch / seq_l videos of seq_l
// frames, the sub-launch's first video at v_off (kernel 9's note)
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
  return bf16 ? quantize_q8<__nv_bfloat16>(x, y, M, H, ldx, rows_per_branch,
                                           seq_l, nv_p, l_p, v_off, s)
              : quantize_q8<float>(x, y, M, H, ldx, rows_per_branch, seq_l,
                                   nv_p, l_p, v_off, s);
}
