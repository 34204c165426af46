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
// Bound on the H100: FLOPs. At the heatmap's largest bag, (1, 60416, 512)
// f32 with D 256 gated, the gate products are 31.7 GFLOP against 124 MB of
// x: 0.47 ms at 67 TFLOP/s (f32 outside the tensor cores), 0.037 ms of HBM.
// The TPU walked a bag's tiles in order and carried the running max and sum
// across grid steps; here a bag of B = 1 must fill 132 SMs, so each bag is
// split into chunks of `chunk` rows (a multiple of TM; ops/attention.py
// _CHUNK, 64), grid (chunks, B):
//  * tiled_pool_kernel streams its chunk through shared memory in 32-row
//    tiles, reading x from HBM once: the gate products on the FP32 FMA tiles
//    of tiles.cuh, then s (written out), then an online max, sum and F-wide
//    weighted sum, rescaled on a new max as the TPU kernel does. It writes
//    the chunk's (max, sum, F partial sums).
//  * combine_kernel merges a bag's chunks:
//    M = sum_c exp(mx_c - mx) m_c / sum_c exp(mx_c - mx) l_c; an all-masked
//    chunk has mx_c = -1e30 and adds nothing.
// No tensor cores yet (wgmma/TMA is later work). The softmax weights p are
// taken from s outside the kernel, as the JAX package takes them in XLA.
#include "tiles.cuh"

namespace {

template <typename T, bool GATED>
__global__ void __launch_bounds__(THREADS)
tiled_pool_kernel(const T* __restrict__ x, const T* __restrict__ wa,
                  const float* __restrict__ ba, const T* __restrict__ wb,
                  const float* __restrict__ bb, const float* __restrict__ wc,
                  const float* __restrict__ bc, const uint8_t* __restrict__ mask,
                  float* __restrict__ s_out, float* __restrict__ m_part,
                  float* __restrict__ mx_part, float* __restrict__ l_part, int N, int F,
                  int D, int chunk) {
  extern __shared__ float smem[];
  const int ldx = F + 1;
  float* Xs = smem;              // TM x (F + 1): the tile's rows
  float* Bs = Xs + TM * ldx;     // KC x TN: gemm_tile's staging
  float* Macc = Bs + KC * TN;    // F: the chunk's running weighted sum
  float* Ss = Macc + F;          // TM: the tile's scores
  float* Es = Ss + TM;           // TM: the tile's e, rounded to T
  float* stat = Es + TM;         // corr, new max, tile sum of e
  const int bag = blockIdx.y, chunks = gridDim.x;
  const int c0 = blockIdx.x * chunk;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const T* xb = x + (size_t)bag * N * F;
  for (int c = threadIdx.x; c < F; c += THREADS) Macc[c] = 0.f;
  float mx = kNegInf, l = 0.f;  // the same value in every thread

  for (int r0 = c0; r0 < c0 + chunk && r0 < N; r0 += TM) {
    for (int e = threadIdx.x; e < TM * F; e += THREADS) {
      const int r = e / F, c = e % F;
      Xs[r * ldx + c] = r0 + r < N ? ld<T>(xb + (size_t)(r0 + r) * F + c) : 0.f;
    }
    // gemm_tile synchronises before reading Xs
    float sacc[RM] = {};
    float ga[RM][RN], gb[RM][RN];
    for (int n0 = 0; n0 < D; n0 += TN) {
      gemm_tile<T>(Xs, ldx, wa, D, F, n0, Bs, ga);
      if (GATED) gemm_tile<T>(Xs, ldx, wb, D, F, n0, Bs, gb);
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) {
          const int col = n0 + tx + 16 * j;
          float u = tanhf(ga[i][j] + ba[col]);
          if (GATED) u *= sigmoidf(gb[i][j] + bb[col]);
          sacc[i] = fmaf(u, wc[col], sacc[i]);
        }
    }
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      float v = sacc[i];
      for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(murcl::kFull, v, o);  // over tx
      const int r = ty + 16 * i;
      if (tx == 0) {
        Ss[r] = v + bc[0];
        if (r0 + r < N) s_out[(size_t)bag * N + r0 + r] = v + bc[0];
      }
    }
    __syncthreads();

    if (threadIdx.x < 32) {  // one warp: one lane per row of the tile
      const int r = threadIdx.x, row = r0 + r;
      const bool live = row < N && mask[(size_t)bag * N + row];
      const float v = live ? Ss[r] : kNegInf;
      float tmax = v;
      for (int o = 16; o > 0; o >>= 1) tmax = fmaxf(tmax, __shfl_xor_sync(murcl::kFull, tmax, o));
      const float mx_new = fmaxf(mx, tmax);
      const float e = live ? expf(v - mx_new) : 0.f;
      Es[r] = rnd<T>(e);
      const float esum = warp_sum(e);
      if (r == 0) {
        stat[0] = expf(mx - mx_new);
        stat[1] = mx_new;
        stat[2] = esum;
      }
    }
    __syncthreads();
    const float corr = stat[0];
    mx = stat[1];
    l = l * corr + stat[2];
    for (int c = threadIdx.x; c < F; c += THREADS) {
      float dot = 0.f;
#pragma unroll 8
      for (int r = 0; r < TM; ++r) dot = fmaf(Es[r], Xs[r * ldx + c], dot);
      Macc[c] = Macc[c] * corr + dot;
    }
    __syncthreads();  // Xs, Es and stat are rewritten by the next tile
  }
  const size_t part = (size_t)bag * chunks + blockIdx.x;
  for (int c = threadIdx.x; c < F; c += THREADS) m_part[part * F + c] = Macc[c];
  if (threadIdx.x == 0) {
    mx_part[part] = mx;
    l_part[part] = l;
  }
}

// M[bag, col] from the bag's chunk partials; one thread per column.
__global__ void __launch_bounds__(TN)
combine_kernel(const float* __restrict__ m_part, const float* __restrict__ mx_part,
               const float* __restrict__ l_part, float* __restrict__ m_out, int F,
               int chunks) {
  const int bag = blockIdx.y, col = blockIdx.x * TN + threadIdx.x;
  if (col >= F) return;
  const float* mxb = mx_part + (size_t)bag * chunks;
  const float* lb = l_part + (size_t)bag * chunks;
  float mx = kNegInf;
  for (int c = 0; c < chunks; ++c) mx = fmaxf(mx, mxb[c]);
  float num = 0.f, den = 0.f;
  for (int c = 0; c < chunks; ++c) {
    const float w = expf(mxb[c] - mx);
    num = fmaf(w, m_part[((size_t)bag * chunks + c) * F + col], num);
    den = fmaf(w, lb[c], den);
  }
  m_out[(size_t)bag * F + col] = num / den;
}

size_t tiled_smem(int F) { return sizeof(float) * (TM * (F + 1) + KC * TN + F + 2 * TM + 4); }

template <typename T, bool GATED>
int tiled_impl(const void* x, const void* wa, const void* ba, const void* wb, const void* bb,
               const void* wc, const void* bc, const void* mask, void* s, void* m_part,
               void* mx_part, void* l_part, void* m, int B, int N, int F, int D, int chunk,
               cudaStream_t stream) {
  const int chunks = (N + chunk - 1) / chunk;
  const size_t smem = tiled_smem(F);
  MURCL_TRY(allow_smem(tiled_pool_kernel<T, GATED>, smem));
  tiled_pool_kernel<T, GATED><<<dim3(chunks, B), THREADS, smem, stream>>>(
      (const T*)x, (const T*)wa, (const float*)ba, (const T*)wb, (const float*)bb,
      (const float*)wc, (const float*)bc, (const uint8_t*)mask, (float*)s, (float*)m_part,
      (float*)mx_part, (float*)l_part, N, F, D, chunk);
  MURCL_TRY(cudaGetLastError());
  combine_kernel<<<dim3((F + TN - 1) / TN, B), TN, 0, stream>>>(
      (const float*)m_part, (const float*)mx_part, (const float*)l_part, (float*)m, F, chunks);
  return (int)cudaGetLastError();
}

}  // namespace

MURCL_API int murcl_attention_pool_tiled(int is_bf16, int gated, const void* x, const void* wa,
                                         const void* ba, const void* wb, const void* bb,
                                         const void* wc, const void* bc, const void* mask,
                                         void* s, void* m_part, void* mx_part, void* l_part,
                                         void* m, int B, int N, int F, int D, int chunk,
                                         void* stream) {
  auto strm = (cudaStream_t)stream;
#define MURCL_TILED(T, G) \
  tiled_impl<T, G>(x, wa, ba, wb, bb, wc, bc, mask, s, m_part, mx_part, l_part, m, B, N, F, D, \
                   chunk, strm)
  if (is_bf16 && gated) return MURCL_TILED(__nv_bfloat16, true);
  if (is_bf16) return MURCL_TILED(__nv_bfloat16, false);
  if (gated) return MURCL_TILED(float, true);
  return MURCL_TILED(float, false);
#undef MURCL_TILED
}
