// K8: streaming (online-softmax) attention pool over a bag of any length.
//
// Replaces murcl_tpu/ops/attention_pallas.py _make_tiled_fwd_kernel (via
// _fwd_tiled_pallas, reached by attention_pool_tiled): the full-slide
// heatmap's path for bags over 6 MiB. Per bag (N rows, F -> D), over the
// rows the mask keeps:
//   a = tanh(x @ Wa + ba),  u = a * sigmoid(x @ Wb + bb) (or u = a ungated)
//   s = u @ wc + bc,        M = sum_n e_n x_n / sum_n e_n,  e = exp(s - max s)
// Rounding follows the TPU kernel: Wa/Wb arrive in the bag dtype, a, g, s,
// the maxima and the sums stay f32, e is rounded to the bag dtype
// unnormalised before its product with x, and the division comes last.
// Masked rows (and rows past N) add nothing; -1e30 is the masked score.
//
// Bound on the H100: operations. At the heatmap's largest bag, (1, 60416,
// 512) f32 with D 256 gated, the gate products are 31.7 GFLOP against 124 MB
// of x: 0.064 ms at TF32's 495 TFLOP/s, 0.037 ms for the bytes. The TPU
// kernel takes the products with f32 operands; one bf16 product would round
// them to 2^-9, and TF32 beyond the f32 tolerance of 1e-4.
//
// The TPU walked a bag's tiles in order and carried the running max and sum
// across grid steps. Here the work is split in two by what bounds it:
//  1. The gate products and the scores s of the whole bag: K7f's gate kernel,
//     pool_gates_fwd_wg (attention_pool.cu, through murcl_attention_pool_fwd
//     without m): persistent wgmma over 128-row tiles fed by TMA; in f32
//     split_kernel first writes x's two bf16 planes and each product is
//     three bf16 products, hi hi + hi lo + lo hi (about 2^-16). At (1, 60416)
//     that is 472 tiles over 132 SMs. The wrapper counts the whole of K8 as
//     one launch; the gate pass is not a K7f launch.
//  2. chunk_kernel (here), bytes-bound: each bag is split into chunks of
//     `chunk` rows (ops/attention.py tiled_chunk: 64 per block until the
//     grid holds 8 blocks per SM), grid (chunks, B). One warp walks the
//     chunk's scores in 32-row halves with the running max, rescaling the
//     sum on a new max as the TPU kernel does, and rounds each e to the bag
//     dtype at the running max of its half (the twin's rounding points);
//     then every thread takes the F-wide sum of e x for two columns, x read
//     once from device memory (f32 x itself, so M's sum takes x exactly),
//     rescaling its sums at each half. The block writes the chunk's (max,
//     sum, F partial sums).
//  3. combine_kernel merges a bag's chunks (32 columns x 32 chunk lanes per
//     block):
//     M = sum_c exp(mx_c - mx) m_c / sum_c exp(mx_c - mx) l_c; an all-masked
//     chunk has mx_c = -1e30 and adds nothing.
// The softmax weights p are taken from s outside the kernels, as the JAX
// package takes them in XLA.
#include "tiles.cuh"

namespace {

__device__ __forceinline__ float2 ld2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}
__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// One block of THREADS per (chunk, bag); dynamic shared memory: each row's
// rounded e (chunk floats), then each half's rescale (chunk / 32 floats).
template <typename T>
__global__ void __launch_bounds__(THREADS)
chunk_kernel(const T* __restrict__ x, const float* __restrict__ s,
             const uint8_t* __restrict__ mask, float* __restrict__ m_part,
             float* __restrict__ mx_part, float* __restrict__ l_part, int N, int F, int chunk) {
  extern __shared__ float es[];
  float* corr = es + chunk;
  const int bag = blockIdx.y, r0 = blockIdx.x * chunk, rows = min(chunk, N - r0);
  const int halves = (rows + 31) / 32, tid = threadIdx.x;
  const size_t part = (size_t)bag * gridDim.x + blockIdx.x;
  if (tid < 32) {  // one lane per row of a half
    const float* sb = s + (size_t)bag * N;
    const uint8_t* mb = mask + (size_t)bag * N;
    float mx = kNegInf, l = 0.f;  // the running max and sum, equal in the lanes
    for (int h = 0; h < halves; ++h) {
      const int row = r0 + 32 * h + tid;
      const bool live = row < N && mb[row];
      const float v = live ? sb[row] : kNegInf;
      float tmax = v;
      for (int o = 16; o > 0; o >>= 1) tmax = fmaxf(tmax, __shfl_xor_sync(murcl::kFull, tmax, o));
      const float mx_new = fmaxf(mx, tmax);
      const float e = live ? expf(v - mx_new) : 0.f;
      const float c = expf(mx - mx_new);  // the sums so far, to the new max
      es[32 * h + tid] = rnd<T>(e);
      l = l * c + warp_sum(e);
      if (tid == 0) corr[h] = c;
      mx = mx_new;
    }
    if (tid == 0) {
      mx_part[part] = mx;
      l_part[part] = l;
    }
  }
  __syncthreads();
  const T* xb = x + ((size_t)bag * N + r0) * F;
  for (int c = 2 * tid; c < F; c += 2 * THREADS) {
    float a0 = 0.f, a1 = 0.f;
    for (int h = 0; h < halves; ++h) {
      a0 *= corr[h];
      a1 *= corr[h];
      const T* xr = xb + (size_t)(32 * h) * F + c;
      const float* eh = es + 32 * h;
      const int end = min(32, rows - 32 * h);
#pragma unroll 8
      for (int r = 0; r < end; ++r) {
        const float2 v = ld2(xr + (size_t)r * F);
        a0 = fmaf(eh[r], v.x, a0);
        a1 = fmaf(eh[r], v.y, a1);
      }
    }
    m_part[part * F + c] = a0;
    m_part[part * F + c + 1] = a1;
  }
}

// M[bag, col] from the bag's chunk partials: a block per 32 columns of a bag,
// 32 lanes of chunks per column (a bag of 60,416 rows has 944 chunks).
constexpr int CC = 32, CL = 32;
__global__ void __launch_bounds__(CC * CL)
combine_kernel(const float* __restrict__ m_part, const float* __restrict__ mx_part,
               const float* __restrict__ l_part, float* __restrict__ m_out, int F,
               int chunks) {
  __shared__ float red[32];
  __shared__ float nums[CL][CC + 1];
  __shared__ float dens[CL];
  const int bag = blockIdx.y, cx = threadIdx.x % CC, cl = threadIdx.x / CC;
  const int col = blockIdx.x * CC + cx;
  const float* mxb = mx_part + (size_t)bag * chunks;
  const float* lb = l_part + (size_t)bag * chunks;
  float mx = kNegInf;
  for (int c = threadIdx.x; c < chunks; c += CC * CL) mx = fmaxf(mx, mxb[c]);
  mx = block_max(mx, red);
  float num = 0.f, den = 0.f;
  for (int c = cl; c < chunks; c += CL) {
    const float w = expf(mxb[c] - mx);
    num = fmaf(w, m_part[((size_t)bag * chunks + c) * F + col], num);
    den = fmaf(w, lb[c], den);
  }
  nums[cl][cx] = num;
  if (cx == 0) dens[cl] = den;
  __syncthreads();
  if (threadIdx.x < CC) {
    float n = 0.f, d = 0.f;
    for (int k = 0; k < CL; ++k) {
      n += nums[k][threadIdx.x];
      d += dens[k];
    }
    m_out[(size_t)bag * F + blockIdx.x * CC + threadIdx.x] = n / d;
  }
}

template <typename T>
int tiled_impl(const void* x, const void* s, const void* mask, void* m_part, void* mx_part,
               void* l_part, void* m, int B, int N, int F, int chunk, cudaStream_t stream) {
  const int chunks = (N + chunk - 1) / chunk;
  const size_t smem = sizeof(float) * (chunk + chunk / 32);
  MURCL_TRY(allow_smem(chunk_kernel<T>, smem));
  chunk_kernel<T><<<dim3(chunks, B), THREADS, smem, stream>>>(
      (const T*)x, (const float*)s, (const uint8_t*)mask, (float*)m_part, (float*)mx_part,
      (float*)l_part, N, F, chunk);
  MURCL_TRY(cudaGetLastError());
  combine_kernel<<<dim3(F / CC, B), CC * CL, 0, stream>>>(
      (const float*)m_part, (const float*)mx_part, (const float*)l_part, (float*)m, F, chunks);
  return (int)cudaGetLastError();
}

}  // namespace

// Passes 2 and 3 of K8, after its scores s (B, N) f32. x (B, N, F) in the bag
// dtype, F a multiple of 32; chunk: rows per block, a multiple of 32;
// m_part (B, chunks, F), mx_part and l_part (B, chunks) f32 scratch.
MURCL_API int murcl_attention_pool_tiled(int is_bf16, const void* x, const void* s,
                                         const void* mask, void* m_part, void* mx_part,
                                         void* l_part, void* m, int B, int N, int F, int chunk,
                                         void* stream) {
  auto strm = (cudaStream_t)stream;
  if (is_bf16)
    return tiled_impl<__nv_bfloat16>(x, s, mask, m_part, mx_part, l_part, m, B, N, F, chunk,
                                     strm);
  return tiled_impl<float>(x, s, mask, m_part, mx_part, l_part, m, B, N, F, chunk, strm);
}
