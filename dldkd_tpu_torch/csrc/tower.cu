// Encoder towers for inference: the query tower (pooled vectors) and the
// video tower (frame features) of one branch or of two branches at once.
// The f32 towers run this file's chain; the bf16 towers run the input
// normalization, the products and the attention of csrc/tower_mma.cu on
// the tensor cores, and this file's LayerNorm, pooling and int8 epilogue.
//
// Replaces dldkd_tpu/ops/pallas/query_tower.py:
//   _dual_query_tower_kernel   (two branches, query tower)
//   _dual_context_tower_kernel (two branches, video tower)
//   _query_tower_kernel, _context_tower_kernel (their one-branch forms)
//   _quantize_q8 / _map_context(emit_q8=True), the video towers' int8
//   epilogue (kernel 9 below)
//
// Per branch the tower is: affine-free input LayerNorm (f32 statistics,
// E[x^2] - mu^2, eps 1e-5; shared by the branches) -> folded input
// projection + ReLU -> + positions, LayerNorm -> 4-head self-attention with
// (1 - mask) * -10000 on the keys -> output projection + residual,
// LayerNorm -> modular softmax pooling (query) or out_mapping_linear
// (video).
//
// What bounds it on an H100: the matrix products. One video-tower launch at
// the serving shapes (200 videos x 128 frames, 1024 -> 384, both branches)
// is about 126 GFLOP against about 105 MB of f32 input. The TPU kernel keeps a
// whole tile and both branches' weights in ~100 MB of VMEM; a Hopper block
// has 227 KB of shared memory, less than one video's raw input (128 x 1024
// bf16 = 256 KB) and far less than one tower's weights (1.8-2.3 MB in bf16).
// So this first design is a short chain of kernels per launch, with the
// weights streaming from L2 and the intermediates (about 20 MB each at 200
// videos) going through device memory, where they stay in the 50 MB L2:
//   1. row_stats   input LayerNorm statistics, once for all branches
//   2. gemm        folded projection over all branches' columns at once
//                  (one read of the raw input), normalizing its A operand
//                  on load; epilogue bias, ReLU, + positions
//   3. layernorm   per branch (grouped columns)
//   4. gemm        Q|K|V, batched over branches
//   5. attention   one block per (sequence, head, branch), L <= 128
//   6. gemm        output projection, epilogue bias + residual
//   7. layernorm
//   8. pool (query tower) or gemm out_mapping_linear (video tower)
//   9. quantize_q8 (video tower with emit_q8): per-frame L2 norm and int8;
//      the T frames of step 8 then live only in a scratch buffer
// Every f32 product is hand-written here: a shared-memory tiled SIMT GEMM
// of IEEE f32 FMAs with f32 accumulation, which f32 parity needs (the
// tensor cores have no f32 product). Fusing the chain is later work.
//
// Rounding: the LayerNorm, pooling and int8 kernels, which the bf16 towers
// share, take the tower dtype T; with T = bf16 every value is rounded to
// bf16 where the Pallas kernel casts to the tower dtype (query_tower.py:82,
// 85-86, 93, 107, 111, 117), and the pooled query vectors stay f32. With
// T = f32 every rounding is the identity; steps 1, 2/4/6/8 and 5 here are
// f32 only.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr float NEG_BIG = -10000.0f;  // additive attention key mask
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
// 1. input LayerNorm statistics of x: one warp per row
// ---------------------------------------------------------------------------
__global__ void row_stats_kernel(const float* __restrict__ x,
                                 float* __restrict__ mu,
                                 float* __restrict__ rstd, int M, int D) {
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= M) return;
  const float* xr = x + (size_t)row * D;
  float s = 0.f, ss = 0.f;
  for (int k = lane; k < D; k += 32) {
    const float v = xr[k];
    s += v;
    ss = fmaf(v, v, ss);
  }
  s = warp_sum(s);
  ss = warp_sum(ss);
  if (lane == 0) {
    const float m = s / D;
    const float var = ss / D - m * m;
    mu[row] = m;
    rstd[row] = 1.0f / sqrtf(var + LN_EPS);
  }
}

// ---------------------------------------------------------------------------
// 2/4/6/8. C[b] = epilogue(A'[b] (M x K) @ W[b] (K x N)), batched over
// blockIdx.z (the branch). A' is A, or with row statistics (a - mu) * rstd
// (the input LayerNorm applied on load). Epilogue, in order: + bias[n];
// ReLU; + pos[m % pos_period][n] where m % pos_period < pos_rows;
// + res[m][n]. All strides are in elements.
// ---------------------------------------------------------------------------
struct GemmArgs {
  const void* a; const void* w; const float* bias; void* c;
  const float* mu; const float* rstd; const float* pos; const void* res;
  int M, N, K;
  int lda, ldw, ldc, ldp, ldr;
  int sa, sw, sb, sc, sr;   // per-batch strides
  int relu, pos_period, pos_rows;
};

constexpr int GB_M = 64, GB_N = 64, GB_K = 16, G_THREADS = 256;

__global__ void __launch_bounds__(G_THREADS) gemm_kernel(GemmArgs g) {
  __shared__ __align__(16) float As[GB_K][GB_M + 4];
  __shared__ __align__(16) float Ws[GB_K][GB_N + 4];
  const int b = blockIdx.z;
  const float* A = (const float*)g.a + (size_t)b * g.sa;
  const float* W = (const float*)g.w + (size_t)b * g.sw;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * GB_M, n0 = blockIdx.x * GB_N;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < g.K; k0 += GB_K) {
    for (int e = tid; e < GB_M * GB_K; e += G_THREADS) {
      const int r = e / GB_K, k = e % GB_K;
      const int gm = m0 + r, gk = k0 + k;
      float v = 0.f;
      if (gm < g.M && gk < g.K) {
        v = A[(size_t)gm * g.lda + gk];
        if (g.mu) v = (v - g.mu[gm]) * g.rstd[gm];
      }
      As[k][r] = v;
    }
    for (int e = tid; e < GB_K * GB_N; e += G_THREADS) {
      const int k = e / GB_N, n = e % GB_N;
      const int gk = k0 + k, gn = n0 + n;
      Ws[k][n] = (gk < g.K && gn < g.N) ? W[(size_t)gk * g.ldw + gn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < GB_K; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
      const float4 w = *reinterpret_cast<const float4*>(&Ws[k][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* C = (float*)g.c + (size_t)b * g.sc;
  const float* bias = g.bias ? g.bias + (size_t)b * g.sb : nullptr;
  const float* R = g.res ? (const float*)g.res + (size_t)b * g.sr : nullptr;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty * 4 + i;
    if (gm >= g.M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx * 4 + j;
      if (gn >= g.N) continue;
      float v = acc[i][j];
      if (bias) v += bias[gn];
      if (g.relu) v = fmaxf(v, 0.f);
      if (g.pos && gm % g.pos_period < g.pos_rows)
        v += g.pos[(size_t)(gm % g.pos_period) * g.ldp + gn];
      if (R) v += R[(size_t)gm * g.ldr + gn];
      C[(size_t)gm * g.ldc + gn] = v;
    }
  }
}

// ---------------------------------------------------------------------------
// 3/7. LayerNorm over groups of H columns: row m, group g reads
// x[m * ld + g * H .. + H) and gamma/beta[g * H ..]. One warp per (row,
// group); f32 statistics (E[x^2] - mu^2); output rounded to T.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void layernorm_kernel(const T* __restrict__ x, T* __restrict__ y,
                                 const float* __restrict__ gamma,
                                 const float* __restrict__ beta, int M, int G,
                                 int H, int ld) {
  const int item = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (item >= M * G) return;
  const int m = item / G, grp = item % G;
  const T* xr = x + (size_t)m * ld + (size_t)grp * H;
  T* yr = y + (size_t)m * ld + (size_t)grp * H;
  const float* ga = gamma + (size_t)grp * H;
  const float* be = beta + (size_t)grp * H;
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
  for (int k = lane; k < H; k += 32)
    yr[k] = narrow<T>((widen(xr[k]) - mu) * rs * ga[k] + be[k]);
}

// ---------------------------------------------------------------------------
// 5. attention: one block per (head, sequence, branch). qkv is
// (G, Nseq * L, 3H) with Q | K | V column blocks; ctx is (G, Nseq * L, H).
// K and V of the (sequence, head) sit in shared memory as f32; each warp
// takes query rows in turn: scores over keys (lane-strided), the key mask,
// a softmax with the row max subtracted (an all-masked row stays finite),
// then P @ V with lanes over the head dims. f32 only.
// ---------------------------------------------------------------------------
constexpr int A_THREADS = 256, A_WARPS = A_THREADS / 32;

__global__ void __launch_bounds__(A_THREADS)
attention_kernel(const float* __restrict__ qkv,
                 const float* __restrict__ mask, float* __restrict__ ctx,
                 int Nseq, int L, int H, int dh, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int ldk = dh + 1;  // odd stride: lanes on different keys hit
                           // different banks
  float* Ks = smem;                             // L x (dh + 1)
  float* Vs = Ks + (size_t)L * ldk;             // L x dh
  float* mb = Vs + (size_t)L * dh;              // L key biases
  float* qb = mb + L;                           // A_WARPS x dh
  float* pb = qb + A_WARPS * dh;                // A_WARPS x L

  const int head = blockIdx.x, seq = blockIdx.y, br = blockIdx.z;
  const size_t M = (size_t)Nseq * L;
  const float* base = qkv + (size_t)br * M * 3 * H + (size_t)seq * L * 3 * H;
  const int qoff = head * dh, koff = H + head * dh, voff = 2 * H + head * dh;

  for (int e = threadIdx.x; e < L * dh; e += A_THREADS) {
    const int j = e / dh, d = e % dh;
    const float* row = base + (size_t)j * 3 * H;
    Ks[j * ldk + d] = row[koff + d];
    Vs[j * dh + d] = row[voff + d];
  }
  for (int j = threadIdx.x; j < L; j += A_THREADS)
    mb[j] = (1.0f - mask[(size_t)seq * L + j]) * NEG_BIG;
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* q = qb + warp * dh;
  float* p = pb + warp * L;
  float* out = ctx + (size_t)br * M * H + (size_t)seq * L * H + head * dh;
  for (int i = warp; i < L; i += A_WARPS) {
    const float* qrow = base + (size_t)i * 3 * H + qoff;
    for (int d = lane; d < dh; d += 32) q[d] = qrow[d];
    __syncwarp();
    float mx = -INFINITY;
    for (int j = lane; j < L; j += 32) {
      const float* kr = Ks + j * ldk;
      float s = 0.f;
      for (int d = 0; d < dh; ++d) s = fmaf(q[d], kr[d], s);
      s = s * scale + mb[j];
      p[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < L; j += 32) {
      const float e = expf(p[j] - mx);
      p[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < L; j += 32) p[j] = p[j] / sum;
    __syncwarp();
    for (int d = lane; d < dh; d += 32) {
      float acc = 0.f;
      for (int j = 0; j < L; ++j) acc = fmaf(p[j], Vs[j * dh + d], acc);
      out[(size_t)i * H + d] = acc;
    }
    __syncwarp();
  }
}

// ---------------------------------------------------------------------------
// 8 (query tower). Modular pooling: logits = x . wm (f32 sum of T values),
// masked to -1e10 where mask == 0, softmax over tokens, pooled = sum of
// x * weights in f32. x row m, branch g at x[m * ld + g * H]; wm is (G, H)
// f32 holding T values; pooled is (G, Nseq, H) f32. One block per
// (sequence, branch).
// ---------------------------------------------------------------------------
constexpr int P_THREADS = 256, P_WARPS = P_THREADS / 32;

template <typename T>
__global__ void __launch_bounds__(P_THREADS)
pool_kernel(const T* __restrict__ x, const float* __restrict__ mask,
            const float* __restrict__ wm, float* __restrict__ pooled,
            int Nseq, int L, int H, int ld) {
  extern __shared__ float att[];  // L
  const int seq = blockIdx.x, br = blockIdx.y;
  const T* xs = x + (size_t)seq * L * ld + (size_t)br * H;
  const float* w = wm + (size_t)br * H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int l = warp; l < L; l += P_WARPS) {
    float s = 0.f;
    for (int d = lane; d < H; d += 32) s = fmaf(widen(xs[(size_t)l * ld + d]), w[d], s);
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
// Replaces dldkd_tpu/ops/pallas/query_tower.py:_quantize_q8 and
// _map_context(emit_q8=True). Bound: bytes (read T, write int8); the TPU
// fuses it into the tower kernel, here it is one more pass over the rows
// the out_mapping product just left in L2.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void quantize_q8_kernel(const T* __restrict__ x,
                                   signed char* __restrict__ y, int M,
                                   int H) {
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= M) return;
  const T* xr = x + (size_t)row * H;
  signed char* yr = y + (size_t)row * H;
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

int row_stats(const void* x, void* mu, void* rstd, int M, int D, void* s) {
  if (M > 0) {
    const int rows_per_block = 256 / 32;
    row_stats_kernel<<<(M + rows_per_block - 1) / rows_per_block, 256, 0,
                       (cudaStream_t)s>>>((const float*)x, (float*)mu,
                                          (float*)rstd, M, D);
  }
  return launch_rc();
}

int gemm(const GemmArgs& g, int batch, void* s) {
  if (g.M > 0 && g.N > 0 && batch > 0) {
    const dim3 grid((g.N + GB_N - 1) / GB_N, (g.M + GB_M - 1) / GB_M, batch);
    gemm_kernel<<<grid, G_THREADS, 0, (cudaStream_t)s>>>(g);
  }
  return launch_rc();
}

template <typename T>
int layernorm(const void* x, void* y, const void* gamma, const void* beta,
              int M, int G, int H, int ld, void* s) {
  if (M > 0 && G > 0) {
    const int per_block = 256 / 32;
    layernorm_kernel<T><<<(M * G + per_block - 1) / per_block, 256, 0,
                          (cudaStream_t)s>>>(
        (const T*)x, (T*)y, (const float*)gamma, (const float*)beta, M, G, H,
        ld);
  }
  return launch_rc();
}

size_t attention_smem(int L, int dh) {
  return sizeof(float) * ((size_t)L * (dh + 1) + (size_t)L * dh + L +
                          (size_t)A_WARPS * dh + (size_t)A_WARPS * L);
}

int attention(const void* qkv, const void* mask, void* ctx, int G, int Nseq,
              int L, int H, int heads, float scale, void* s) {
  if (G > 0 && Nseq > 0 && L > 0) {
    const int dh = H / heads;
    const size_t smem = attention_smem(L, dh);
    cudaError_t e = cudaFuncSetAttribute(
        attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    attention_kernel<<<dim3(heads, Nseq, G), A_THREADS, smem,
                       (cudaStream_t)s>>>(
        (const float*)qkv, (const float*)mask, (float*)ctx, Nseq, L, H, dh,
        scale);
  }
  return launch_rc();
}

template <typename T>
int pool(const void* x, const void* mask, const void* wm, void* pooled,
         int G, int Nseq, int L, int H, int ld, void* s) {
  if (G > 0 && Nseq > 0) {
    pool_kernel<T><<<dim3(Nseq, G), P_THREADS, sizeof(float) * L,
                     (cudaStream_t)s>>>((const T*)x, (const float*)mask,
                                        (const float*)wm, (float*)pooled,
                                        Nseq, L, H, ld);
  }
  return launch_rc();
}

template <typename T>
int quantize_q8(const void* x, void* y, int M, int H, void* s) {
  if (M > 0 && H > 0) {
    const int rows_per_block = 256 / 32;
    quantize_q8_kernel<T><<<(M + rows_per_block - 1) / rows_per_block, 256,
                            0, (cudaStream_t)s>>>((const T*)x,
                                                  (signed char*)y, M, H);
  }
  return launch_rc();
}

GemmArgs make_args(const void* a, const void* w, const void* bias, void* c,
                   const void* mu, const void* rstd, const void* pos,
                   const void* res, int M, int N, int K, int lda, int ldw,
                   int ldc, int ldp, int ldr, int sa, int sw, int sb, int sc,
                   int sr, int relu, int pos_period, int pos_rows) {
  GemmArgs g;
  g.a = a; g.w = w; g.bias = (const float*)bias; g.c = c;
  g.mu = (const float*)mu; g.rstd = (const float*)rstd;
  g.pos = (const float*)pos; g.res = res;
  g.M = M; g.N = N; g.K = K;
  g.lda = lda; g.ldw = ldw; g.ldc = ldc; g.ldp = ldp; g.ldr = ldr;
  g.sa = sa; g.sw = sw; g.sb = sb; g.sc = sc; g.sr = sr;
  g.relu = relu; g.pos_period = pos_period > 0 ? pos_period : 1;
  g.pos_rows = pos_rows;
  return g;
}

}  // namespace

// ---------------------------------------------------------------------------
// C interface. `bf16` selects T = bf16 (else f32); row statistics, the
// products and the attention are f32 only here (bf16: csrc/tower_mma.cu).
// Pointers may be null where the argument is unused (mu/rstd, pos, res,
// bias).
// ---------------------------------------------------------------------------
extern "C" int tower_row_stats(const void* x, void* mu, void* rstd, int M,
                               int D, void* s) {
  return row_stats(x, mu, rstd, M, D, s);
}

// W is (K, N) rows of ldw
extern "C" int tower_gemm(const void* a, const void* w, const void* bias,
                          void* c, const void* mu, const void* rstd,
                          const void* pos, const void* res, int M, int N,
                          int K, int lda, int ldw, int ldc, int ldp, int ldr,
                          int sa, int sw, int sb, int sc, int sr, int relu,
                          int pos_period, int pos_rows, int batch, void* s) {
  const GemmArgs g = make_args(a, w, bias, c, mu, rstd, pos, res, M, N, K,
                               lda, ldw, ldc, ldp, ldr, sa, sw, sb, sc, sr,
                               relu, pos_period, pos_rows);
  return gemm(g, batch, s);
}

extern "C" int tower_layernorm(const void* x, void* y, const void* gamma,
                               const void* beta, int M, int G, int H, int ld,
                               int bf16, void* s) {
  return bf16 ? layernorm<__nv_bfloat16>(x, y, gamma, beta, M, G, H, ld, s)
              : layernorm<float>(x, y, gamma, beta, M, G, H, ld, s);
}

extern "C" int tower_attention(const void* qkv, const void* mask, void* ctx,
                               int G, int Nseq, int L, int H, int heads,
                               float scale, void* s) {
  return attention(qkv, mask, ctx, G, Nseq, L, H, heads, scale, s);
}

extern "C" int tower_pool(const void* x, const void* mask, const void* wm,
                          void* pooled, int G, int Nseq, int L, int H, int ld,
                          int bf16, void* s) {
  return bf16 ? pool<__nv_bfloat16>(x, mask, wm, pooled, G, Nseq, L, H, ld, s)
              : pool<float>(x, mask, wm, pooled, G, Nseq, L, H, ld, s);
}

// x (M, H) in T -> y (M, H) int8
extern "C" int tower_quantize_q8(const void* x, void* y, int M, int H,
                                 int bf16, void* s) {
  return bf16 ? quantize_q8<__nv_bfloat16>(x, y, M, H, s)
              : quantize_q8<float>(x, y, M, H, s);
}
