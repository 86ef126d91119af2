// Exact-grade cosine max-over-frames scoring against bf16-stored frames:
// the dense engine of serving's stage-2 rescore.
//
//   out[q, v] = max_l  <qn[q], c[v, l]> * inv[v, l] + bias[v, l]
//
// qn is the f32 L2-normalized query, c the RAW bf16 frames, inv the f32
// reciprocal frame norm (0 on masked frames) and bias 0 or -1e10; inv and
// bias are computed outside, as the JAX package computes them outside
// pallas_call.
//
// Replaces dldkd_tpu/ops/pallas/sim_max.py:_sim_max_kernel_exact, reached
// through fused_exact_scores from similarity.exact_clip_scores. The TPU
// kernel splits the f32 query into three bf16 parts so that its bf16 MXU
// gives exact products; here every product is an IEEE f32 FMA of the f32
// query and the frame value widened exactly to f32 (never TF32, never a
// reduced-precision sum), which is the same accuracy class: f32 grade
// against the stored bf16 frames. The sums run in another order than the
// plain version's (about 1e-6 apart).
//
// What bounds it on an H100: 2 x Nq x Nv x L x D f32 operations on the
// CUDA cores (55 GFLOP at 256 queries against TVR's corpus, 0.82 ms at
// 67 TFLOP/s) against one read of the bf16 corpus (214 MB, 0.064 ms):
// operations. Same tiling as csrc/sim_max.cu: each block owns 64 queries x
// 8 videos and walks all frames of its videos, folding the masked, scaled
// frame scores into a running max in registers, over the port's own
// (Nv, L, D) layout. A split-3 bf16 tensor-core version is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int TQ = 64;
constexpr int TV = 8;
constexpr int TF = 8;
constexpr int TN = TV * TF;
constexpr int BK = 32;
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
sim_max_exact_kernel(const float* __restrict__ q,
                     const __nv_bfloat16* __restrict__ ctx,
                     const float* __restrict__ inv,
                     const float* __restrict__ bias, float* __restrict__ out,
                     int nq, int nv, int L, int D) {
  __shared__ __align__(16) float qs[BK][TQ + 4];
  __shared__ __align__(16) float cs[BK][TN + 4];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int q0 = blockIdx.y * TQ;
  const int v0 = blockIdx.x * TV;
  const int vj = tx >> 1;
  const int fb = (tx & 1) * 4;

  float best[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) best[i] = -INFINITY;

  for (int l0 = 0; l0 < L; l0 += TF) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < D; k0 += BK) {
      for (int e = tid; e < TQ * BK; e += THREADS) {
        const int r = e / BK, k = e % BK;
        const int gq = q0 + r, gk = k0 + k;
        qs[k][r] = (gq < nq && gk < D) ? q[(size_t)gq * D + gk] : 0.f;
      }
      for (int e = tid; e < TN * BK; e += THREADS) {
        const int c = e / BK, k = e % BK;
        const int gv = v0 + c / TF, gl = l0 + c % TF, gk = k0 + k;
        cs[k][c] = (gv < nv && gl < L && gk < D)
                       ? __bfloat162float(ctx[((size_t)gv * L + gl) * D + gk])
                       : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < BK; ++k) {
        const float4 a = *reinterpret_cast<const float4*>(&qs[k][ty * 4]);
        const float4 b = *reinterpret_cast<const float4*>(&cs[k][tx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }

    const int gv = v0 + vj;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gl = l0 + fb + j;
      if (gv < nv && gl < L) {
        const float s = inv[(size_t)gv * L + gl];
        const float b = bias[(size_t)gv * L + gl];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          best[i] = fmaxf(best[i], __fadd_rn(__fmul_rn(acc[i][j], s), b));
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
    best[i] = fmaxf(best[i], __shfl_xor_sync(0xffffffffu, best[i], 1));
  const int gv = v0 + vj;
  if ((tx & 1) == 0 && gv < nv) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gq = q0 + ty * 4 + i;
      if (gq < nq) out[(size_t)gq * nv + gv] = best[i];
    }
  }
}

}  // namespace

// q (nq, D) f32, ctx (nv, L, D) bf16, inv and bias (nv, L) f32 ->
// out (nq, nv) f32.
extern "C" int sim_max_exact(const void* q, const void* ctx, const void* inv,
                             const void* bias, void* out, int nq, int nv,
                             int L, int D, void* stream) {
  if (nq > 0 && nv > 0) {
    const dim3 grid((nv + TV - 1) / TV, (nq + TQ - 1) / TQ);
    sim_max_exact_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)q, (const __nv_bfloat16*)ctx, (const float*)inv,
        (const float*)bias, (float*)out, nq, nv, L, D);
  }
  return (int)cudaGetLastError();
}
