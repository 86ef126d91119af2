// Masked cosine max-over-frames scoring in f32: the parity configuration.
//
//   out[q, v] = max_l  mask_logits(<qn[q], cn[v, l]>, mask[v, l])
//   mask_logits(s, m) = s * m + (1 - m) * -1e10
//
// Replaces dldkd_tpu/ops/pallas/sim_max.py:_sim_max_kernel (reached through
// fused_clip_scores(quantized=False)) on f32 inputs; bf16 inputs go to the
// tensor-core kernel of csrc/sim_max_mma.cu. Inputs are L2-normalized
// outside the kernel, as the JAX package normalizes outside pallas_call.
// Only the (Nq, Nv) f32 result is written: the (Nq, L, Nv) frame tensor
// never exists.
//
// What bounds it on an H100: one launch scores a query batch (50 in the
// eval) against the whole corpus, so it reads every frame once (Nv x L x D
// values) and does 2 x Nq x Nv x L x D operations; in f32 on the CUDA cores
// that is the FMA rate. The frame max replaces the TPU's sequential grid
// axis and output revisiting (sim_max.py:39, 57-63): here each block owns a
// tile of 64 queries x 8 videos and walks all frames of those videos in a
// loop, folding a running max kept in registers, so nothing is carried
// between blocks. The kernel reads the port's own (Nv, L, D) layout (no
// transpose pass) and masks ragged edges itself.
//
// Arithmetic: f32 accumulation of IEEE f32 FMAs, never TF32. It stays on
// the CUDA cores because f32 parity needs IEEE f32 products, which the
// tensor cores do not compute.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int TQ = 64;         // queries per block
constexpr int TV = 8;          // videos per block
constexpr int TF = 8;          // frames per chunk
constexpr int TN = TV * TF;    // (video, frame) columns per chunk
constexpr int BK = 32;         // depth per shared-memory stage
constexpr int THREADS = 256;   // 16 x 16 threads, 4 x 4 outputs each
constexpr float NEG_INF = -1e10f;

__device__ __forceinline__ float widen(float x) { return x; }

template <typename T>
__global__ void __launch_bounds__(THREADS)
sim_max_kernel(const T* __restrict__ q, const T* __restrict__ ctx,
               const float* __restrict__ mask, float* __restrict__ out,
               int nq, int nv, int L, int D) {
  __shared__ __align__(16) float qs[BK][TQ + 4];  // qs[k][query]
  __shared__ __align__(16) float cs[BK][TN + 4];  // cs[k][video*TF + frame]

  const int tid = threadIdx.x;
  const int tx = tid % 16;        // column group: 4 columns
  const int ty = tid / 16;        // row group: 4 queries
  const int q0 = blockIdx.y * TQ;
  const int v0 = blockIdx.x * TV;
  // this thread's 4 columns are frames fb..fb+3 of video vj; the thread
  // with tx ^ 1 (the neighbouring lane) holds the other 4 frames
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
        qs[k][r] = (gq < nq && gk < D) ? widen(q[(size_t)gq * D + gk]) : 0.f;
      }
      for (int e = tid; e < TN * BK; e += THREADS) {
        const int c = e / BK, k = e % BK;
        const int gv = v0 + c / TF, gl = l0 + c % TF, gk = k0 + k;
        cs[k][c] = (gv < nv && gl < L && gk < D)
                       ? widen(ctx[((size_t)gv * L + gl) * D + gk])
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
        const float m = mask[(size_t)gv * L + gl];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          best[i] = fmaxf(best[i], acc[i][j] * m + (1.f - m) * NEG_INF);
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

template <typename T>
int launch(const void* q, const void* ctx, const void* mask, void* out,
           int nq, int nv, int L, int D, void* stream) {
  if (nq > 0 && nv > 0) {
    const dim3 grid((nv + TV - 1) / TV, (nq + TQ - 1) / TQ);
    sim_max_kernel<T><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const T*)q, (const T*)ctx, (const float*)mask, (float*)out, nq, nv,
        L, D);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int sim_max_f32(const void* q, const void* ctx, const void* mask,
                           void* out, int nq, int nv, int L, int D,
                           void* stream) {
  return launch<float>(q, ctx, mask, out, nq, nv, L, D, stream);
}

