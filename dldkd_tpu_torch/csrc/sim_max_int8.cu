// int8 cosine max-over-frames scoring on a prebuilt int8 index.
//
//   out[q, v] = max_l (<q8[q], c8[v, l]> + bias[v, l]) * (1 / 127^2)
//
// q8 and c8 are symmetric int8 quantizations (scale 127) of L2-normalized
// query vectors and frames; bias is an int32 0 (valid frame) or -2^30
// (masked or padded frame). The dot is an exact int8 x int8 -> int32 sum,
// the bias is added and the frame max taken in int32, and only the max is
// turned into f32 by one multiply with the f32 constant float(1/127^2), as
// the TPU kernel does: valid-video scores are bitwise those of the plain
// version (integer sums below 2^24 are exact in f32 too).
//
// Replaces dldkd_tpu/ops/pallas/sim_max.py:_sim_max_kernel_int8, reached
// through fused_clip_scores_q8 (the prebuilt index of serving stage 1 and
// of the int8 eval) and fused_clip_scores(quantized=True). The index keeps
// the port's (Nv, L, D) layout and (Nv, L) bias: no transpose, no lane
// padding; ragged edges are masked here.
//
// What bounds it on an H100: one launch reads the whole index once
// (Nv x L x D bytes, 107 MB per branch at TVR scale) and does
// 2 x Nq x Nv x L x D integer operations; at 256 queries the two bounds are
// about equal (0.03 ms at 3.35 TB/s and at 1,979 int8 TOPS). This first
// version runs on the CUDA cores with __dp4a (four int8 products and the
// int32 sum in one instruction): each block owns 64 queries x 8 videos and
// walks all frames of its videos, keeping the running int32 max in
// registers; words of four int8 values are staged in shared memory. int8
// tensor cores (mma.sync / wgmma s8) are later work.

#include <cuda_runtime.h>
#include <limits.h>
#include <stddef.h>

namespace {

constexpr int TQ = 64;         // queries per block
constexpr int TV = 8;          // videos per block
constexpr int TF = 8;          // frames per chunk
constexpr int TN = TV * TF;    // (video, frame) columns per chunk
constexpr int BW = 16;         // 32-bit words (4 int8 each) per stage
constexpr int THREADS = 256;   // 16 x 16 threads, 4 x 4 outputs each
// float(1 / (127 * 127)): the f32 constant of sim_max.py:216-217
constexpr float INV_SCALE2 = (float)(1.0 / (127.0 * 127.0));

__global__ void __launch_bounds__(THREADS)
sim_max_int8_kernel(const int* __restrict__ q, const int* __restrict__ ctx,
                    const int* __restrict__ bias, float* __restrict__ out,
                    int nq, int nv, int L, int W) {
  // W = D / 4 words per row
  __shared__ __align__(16) int qs[BW][TQ + 4];  // qs[word][query]
  __shared__ __align__(16) int cs[BW][TN + 4];  // cs[word][video*TF + frame]

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int q0 = blockIdx.y * TQ;
  const int v0 = blockIdx.x * TV;
  const int vj = tx >> 1;          // this thread's video in the tile
  const int fb = (tx & 1) * 4;     // and its first frame of the chunk

  int best[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) best[i] = INT_MIN;

  for (int l0 = 0; l0 < L; l0 += TF) {
    int acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0;

    for (int w0 = 0; w0 < W; w0 += BW) {
      for (int e = tid; e < TQ * BW; e += THREADS) {
        const int r = e / BW, w = e % BW;
        const int gq = q0 + r, gw = w0 + w;
        qs[w][r] = (gq < nq && gw < W) ? q[(size_t)gq * W + gw] : 0;
      }
      for (int e = tid; e < TN * BW; e += THREADS) {
        const int c = e / BW, w = e % BW;
        const int gv = v0 + c / TF, gl = l0 + c % TF, gw = w0 + w;
        cs[w][c] = (gv < nv && gl < L && gw < W)
                       ? ctx[((size_t)gv * L + gl) * W + gw]
                       : 0;
      }
      __syncthreads();
#pragma unroll 8
      for (int w = 0; w < BW; ++w) {
        const int4 a = *reinterpret_cast<const int4*>(&qs[w][ty * 4]);
        const int4 b = *reinterpret_cast<const int4*>(&cs[w][tx * 4]);
        const int av[4] = {a.x, a.y, a.z, a.w};
        const int bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] = __dp4a(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }

    const int gv = v0 + vj;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gl = l0 + fb + j;
      if (gv < nv && gl < L) {
        const int b = bias[(size_t)gv * L + gl];
#pragma unroll
        for (int i = 0; i < 4; ++i) best[i] = max(best[i], acc[i][j] + b);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
    best[i] = max(best[i], __shfl_xor_sync(0xffffffffu, best[i], 1));
  const int gv = v0 + vj;
  if ((tx & 1) == 0 && gv < nv) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gq = q0 + ty * 4 + i;
      if (gq < nq) out[(size_t)gq * nv + gv] = (float)best[i] * INV_SCALE2;
    }
  }
}

}  // namespace

// q (nq, D) int8, ctx (nv, L, D) int8, bias (nv, L) int32 -> out (nq, nv)
// f32. D must be a multiple of 4 and the pointers 4-byte aligned (the
// wrapper checks both).
extern "C" int sim_max_int8(const void* q, const void* ctx, const void* bias,
                            void* out, int nq, int nv, int L, int D,
                            void* stream) {
  if (nq > 0 && nv > 0) {
    const dim3 grid((nv + TV - 1) / TV, (nq + TQ - 1) / TQ);
    sim_max_int8_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const int*)q, (const int*)ctx, (const int*)bias, (float*)out, nq,
        nv, L, D / 4);
  }
  return (int)cudaGetLastError();
}
