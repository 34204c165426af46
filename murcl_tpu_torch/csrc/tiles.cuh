// FP32-FMA tile building blocks shared by the attention kernels (K2/K3 in
// fused_trunk.cu, K7 in attention_pool.cu): a 32-row x 128-column gemm tile
// over a shared-memory A, block reductions, the masked-softmax pooling pass
// and its backward over a bag, and the split-K weight-gradient contraction.
// Everything here sits in an anonymous namespace, so each source file that
// includes it gets its own copy.
#pragma once

#include "common.cuh"

namespace {

using murcl::ld;
using murcl::rnd;
using murcl::st;

constexpr int TM = 32;       // bag rows per block
constexpr int TN = 128;      // output columns per gemm pass
constexpr int KC = 32;       // depth of one staged slice of B
constexpr int THREADS = 256;
constexpr int RM = TM / 16;  // rows per thread: ty + 16 * i
constexpr int RN = TN / 16;  // cols per thread: tx + 16 * j
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(murcl::kFull, v, o);
  return v;
}

__device__ __forceinline__ float sigmoidf(float x) { return 1.f / (1.f + expf(-x)); }

// acc = As[TM x K] @ B[K x TN] at columns n0.. of the row-major B (ldb), for
// the thread's (ty + 16 i, n0 + tx + 16 j). As: floats in shared memory
// (row stride lda); Bs: KC x TN staging buffer in shared memory.
template <typename T>
__device__ void gemm_tile(const float* As, int lda, const T* __restrict__ B, int ldb, int K,
                          int n0, float* Bs, float (&acc)[RM][RN]) {
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < K; k0 += KC) {
    __syncthreads();
    for (int e = tid; e < KC * TN; e += THREADS) {
      const int kk = e / TN, c = e % TN;
      Bs[e] = ld<T>(B + (size_t)(k0 + kk) * ldb + n0 + c);
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < KC; ++kk) {
      float av[RM], bv[RN];
#pragma unroll
      for (int i = 0; i < RM; ++i) av[i] = As[(ty + 16 * i) * lda + k0 + kk];
#pragma unroll
      for (int j = 0; j < RN; ++j) bv[j] = Bs[kk * TN + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
}

// Block-wide reductions for blocks of `nwarps` warps; red holds >= 32 floats.
__device__ float block_max(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(murcl::kFull, v, o));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float m = red[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w) m = fmaxf(m, red[w]);
  return m;
}
__device__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) s += red[w];
  return s;
}

// Masked softmax over the bag and M = rnd<T>(p) @ X for 128 columns of the
// (B, N, L) tensor X: one block per (column tile, bag), N + 32 floats of
// dynamic shared memory.
template <typename T>
__global__ void __launch_bounds__(TN)
pool_kernel(const float* __restrict__ s, const uint8_t* __restrict__ mask,
            const T* __restrict__ xc, float* __restrict__ m_out, float* __restrict__ p_out,
            int N, int L1) {
  extern __shared__ float ps[];  // N floats, then 32 for reductions
  float* red = ps + N;
  const int bag = blockIdx.y, col = blockIdx.x * TN + threadIdx.x;
  float mx = -INFINITY;
  for (int r = threadIdx.x; r < N; r += TN) {
    const float v = mask[(size_t)bag * N + r] ? s[(size_t)bag * N + r] : kNegInf;
    ps[r] = v;
    mx = fmaxf(mx, v);
  }
  mx = block_max(mx, red);
  float sum = 0.f;
  for (int r = threadIdx.x; r < N; r += TN) {
    const float e = expf(ps[r] - mx);
    ps[r] = e;
    sum += e;
  }
  sum = block_sum(sum, red);
  for (int r = threadIdx.x; r < N; r += TN) {
    const float p = ps[r] / sum;
    ps[r] = p;
    if (blockIdx.x == 0) p_out[(size_t)bag * N + r] = p;
  }
  __syncthreads();
  const T* x = xc + (size_t)bag * N * L1 + col;
  float acc = 0.f;
  for (int r = 0; r < N; ++r) acc = fmaf(rnd<T>(ps[r]), ld<T>(x + (size_t)r * L1), acc);
  m_out[(size_t)bag * L1 + col] = acc;
}

constexpr int WT = 64;  // output tile edge of the weight-gradient contraction
constexpr int WR = 32;  // rows staged per step

// dW[K1 x K2] += X[rows]^T @ Y[rows] over this block's split of the rows;
// blocks of the first K1 tile also add the column sums of Y into db, unless
// db is null.
template <typename T>
__global__ void __launch_bounds__(THREADS)
wgrad_kernel(const T* __restrict__ X, int K1, const T* __restrict__ Y, int K2, long long R,
             long long rows_per_split, float* __restrict__ dW, float* __restrict__ db) {
  __shared__ float Xs[WR][WT + 1];
  __shared__ float Ys[WR][WT + 1];
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int c1 = blockIdx.y * WT, c2 = blockIdx.x * WT;
  const long long rbeg = blockIdx.z * rows_per_split;
  const long long rend = min(R, rbeg + rows_per_split);
  const bool sums = db != nullptr && blockIdx.y == 0 && tid < WT;
  float acc[4][4] = {};
  float colsum = 0.f;
  for (long long r0 = rbeg; r0 < rend; r0 += WR) {
    for (int e = tid; e < WR * WT; e += THREADS) {
      const int rr = e / WT, c = e % WT;
      const long long row = r0 + rr;
      Xs[rr][c] = row < rend ? ld<T>(X + row * K1 + c1 + c) : 0.f;
      Ys[rr][c] = row < rend ? ld<T>(Y + row * K2 + c2 + c) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int rr = 0; rr < WR; ++rr) {
      float xv[4], yv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) xv[i] = Xs[rr][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) yv[j] = Ys[rr][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xv[i], yv[j], acc[i][j]);
    }
    if (sums)
      for (int rr = 0; rr < WR; ++rr) colsum += Ys[rr][tid];
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      atomicAdd(&dW[(size_t)(c1 + ty + 16 * i) * K2 + c2 + tx + 16 * j], acc[i][j]);
  if (sums) atomicAdd(&db[c2 + tid], colsum);
}

// The softmax backward over one bag per block (K3, and K7 in bf16): dp_r =
// the sum of the `passes` partials dpp (in pass order) + gp_r,
// c = sum_r p_r dp_r, ds_r = p_r (dp_r - c) on live rows, plus gs_r;
// dbc += sum_r ds_r.
__global__ void __launch_bounds__(THREADS)
softmax_bwd_kernel(const float* __restrict__ dpp, int passes, const float* __restrict__ p,
                   const float* __restrict__ gp, const float* __restrict__ gs,
                   const uint8_t* __restrict__ mask, float* __restrict__ ds,
                   float* __restrict__ dbc, int B, int N) {
  __shared__ float red[32];
  const size_t base = (size_t)blockIdx.x * N;
  auto dp_at = [&](int r) {
    float v = 0.f;
    for (int c = 0; c < passes; ++c) v += dpp[(size_t)c * B * N + base + r];
    return v + gp[base + r];
  };
  float part = 0.f;
  for (int r = threadIdx.x; r < N; r += THREADS) part += p[base + r] * dp_at(r);
  const float csum = block_sum(part, red);
  float dsum = 0.f;
  for (int r = threadIdx.x; r < N; r += THREADS) {
    float d = mask[base + r] ? p[base + r] * (dp_at(r) - csum) : 0.f;
    d += gs[base + r];
    ds[base + r] = d;
    dsum += d;
  }
  dsum = block_sum(dsum, red);
  if (threadIdx.x == 0) atomicAdd(dbc, dsum);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

#define MURCL_TRY(expr)                      \
  do {                                       \
    cudaError_t e_ = (expr);                 \
    if (e_ != cudaSuccess) return (int)e_;   \
  } while (0)

// Launch pool_kernel over (B, N, L1) and check the launch.
template <typename T>
int pool(const float* s, const uint8_t* mask, const T* X, float* m, float* p, int B, int N,
         int L1, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (N + 32);
  MURCL_TRY(allow_smem(pool_kernel<T>, smem));
  pool_kernel<T><<<dim3(L1 / TN, B), TN, smem, stream>>>(s, mask, X, m, p, N, L1);
  return (int)cudaGetLastError();
}

// dW += X^T @ Y over all R rows as 64 row splits (db may be null).
template <typename T>
int wgrad(const void* X, int K1, const void* Y, int K2, long long R, float* dW, float* db,
          cudaStream_t stream) {
  const long long splits = 64;
  long long per = (R + splits - 1) / splits;
  per = ((per + WR - 1) / WR) * WR;
  const dim3 grid(K2 / WT, K1 / WT, (unsigned)((R + per - 1) / per));
  wgrad_kernel<T><<<grid, THREADS, 0, stream>>>((const T*)X, K1, (const T*)Y, K2, R, per, dW, db);
  return (int)cudaGetLastError();
}

}  // namespace
