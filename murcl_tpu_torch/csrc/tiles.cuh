// Tile building blocks shared by the attention kernels (K2/K3 in
// fused_trunk.cu, K7 in attention_pool.cu, K8 in attention_tiled.cu): block
// reductions, the masked-softmax pooling pass and its backward over a bag.
// Everything here sits in an anonymous namespace, so each source file that
// includes it gets its own copy.
#pragma once

#include "common.cuh"

namespace {

using murcl::ld;
using murcl::rnd;
using murcl::st;

constexpr int TN = 128;  // columns of M per pool_kernel block
constexpr int THREADS = 256;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(murcl::kFull, v, o);
  return v;
}

__device__ __forceinline__ float sigmoidf(float x) { return 1.f / (1.f + expf(-x)); }

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
// dynamic shared memory. With PLANES, X holds f32 values as two planes of
// (B, N, L), hi = rnd<T>(x) then lo = rnd<T>(x - hi) (K2's f32 route), and
// M = p @ (hi + lo), p unrounded.
template <typename T, bool PLANES = false>
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
  const size_t lo = PLANES ? (size_t)gridDim.y * N * L1 : 0;  // the lo plane, B N L1 on
  float acc = 0.f;
  for (int r = 0; r < N; ++r) {
    float v = ld<T>(x + (size_t)r * L1);
    if (PLANES) v += ld<T>(x + lo + (size_t)r * L1);
    acc = fmaf(PLANES ? ps[r] : rnd<T>(ps[r]), v, acc);
  }
  m_out[(size_t)bag * L1 + col] = acc;
}

__device__ double block_sum_d(double v, double* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(murcl::kFull, v, o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  double s = 0.0;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) s += red[w];
  return s;
}

// The softmax backward over one bag per block (K3 and K7): dp_r =
// the sum of the `passes` partials dpp (in pass order) + gp_r,
// c = sum_r p_r dp_r, ds_r = p_r (dp_r - c) on live rows, plus gs_r;
// dbc += sum_r ds_r. That sum is sum_r gs_r plus the softmax part
// sum_r p_r (dp_r - c) = c (1 - sum_r p_r), zero in exact arithmetic (a
// shift of every score moves no p) but in f32 about 1e-6 a bag, from p's
// own sum and from c's rounding, which at 48 bags reached 1e-4 of a small
// dbc. So the bag's dbc is summed in double, its softmax part against c
// taken in double over the bag's own sum of p: it cancels to double's
// rounding. ds keeps the f32 expression.
__global__ void __launch_bounds__(THREADS)
softmax_bwd_kernel(const float* __restrict__ dpp, int passes, const float* __restrict__ p,
                   const float* __restrict__ gp, const float* __restrict__ gs,
                   const uint8_t* __restrict__ mask, float* __restrict__ ds,
                   float* __restrict__ dbc, int B, int N) {
  __shared__ float red[32];
  __shared__ double redd[32];
  const size_t base = (size_t)blockIdx.x * N;
  auto dp_at = [&](int r) {
    float v = 0.f;
    for (int c = 0; c < passes; ++c) v += dpp[(size_t)c * B * N + base + r];
    return v + gp[base + r];
  };
  float part = 0.f;
  double part_d = 0.0, psum_d = 0.0;
  for (int r = threadIdx.x; r < N; r += THREADS) {
    const float pr = p[base + r], dpr = dp_at(r);
    part += pr * dpr;
    part_d += (double)pr * dpr;
    if (mask[base + r]) psum_d += pr;
  }
  const float csum = block_sum(part, red);
  part_d = block_sum_d(part_d, redd);
  const double c = part_d / block_sum_d(psum_d, redd);
  double dsum = 0.0;
  for (int r = threadIdx.x; r < N; r += THREADS) {
    const bool live = mask[base + r];
    const float pr = p[base + r], dpr = dp_at(r);
    float d = live ? pr * (dpr - csum) : 0.f;
    d += gs[base + r];
    ds[base + r] = d;
    dsum += (live ? (double)pr * ((double)dpr - c) : 0.0) + gs[base + r];
  }
  dsum = block_sum_d(dsum, redd);
  if (threadIdx.x == 0) atomicAdd(dbc, (float)dsum);
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
template <typename T, bool PLANES = false>
int pool(const float* s, const uint8_t* mask, const T* X, float* m, float* p, int B, int N,
         int L1, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (N + 32);
  MURCL_TRY(allow_smem(pool_kernel<T, PLANES>, smem));
  pool_kernel<T, PLANES><<<dim3(L1 / TN, B), TN, smem, stream>>>(s, mask, X, m, p, N, L1);
  return (int)cudaGetLastError();
}

}  // namespace
