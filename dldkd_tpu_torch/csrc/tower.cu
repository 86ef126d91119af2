// Encoder towers for inference: the query tower (pooled vectors) and the
// video tower (frame features) of one branch or of two branches at once,
// as a short chain of kernels per launch. This file holds the chain's int8
// epilogue; csrc/tower_mma.cu holds the rest: the input normalization, the
// matrix products on the tensor cores with the LayerNorms and the query
// tower's pooling in their epilogues, and the attention. Both dtypes run
// the same chain.
//
// Replaces dldkd_tpu/ops/pallas/query_tower.py:
//   _dual_query_tower_kernel   (two branches, query tower)
//   _dual_context_tower_kernel (two branches, video tower)
//   _query_tower_kernel, _context_tower_kernel (their one-branch forms)
//   _quantize_q8 / _map_context(emit_q8=True), the video towers' int8
//   epilogue (step 7 below, this file), with its transposed write
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

// ---------------------------------------------------------------------------
// 7 (video tower, emit_q8). The int8-index epilogue: per-frame L2
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
  return bf16 ? quantize_q8<__nv_bfloat16>(x, y, M, H, ldx, rows_per_branch,
                                           seq_l, nv_p, l_p, v_off, s)
              : quantize_q8<float>(x, y, M, H, ldx, rows_per_branch, seq_l,
                                   nv_p, l_p, v_off, s);
}
