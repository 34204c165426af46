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
// of x. The TPU kernel takes them with f32 operands; one bf16 product would
// round them to 2^-9, and TF32 beyond the f32 tolerance of 1e-4. So in f32
// each is three bf16 products on the tensor cores, hi Whi + hi Wlo + lo Whi
// with hi = rnd(v) and lo = rnd(v - hi) (about 2^-16, the scheme of K7b's
// dx): 95 GFLOP of bf16 products for the function's 31.7, whose bound is
// 0.064 ms at TF32's 495 TFLOP/s. In bf16 it is one product per gate, as
// in K7f.
//
// The TPU walked a bag's tiles in order and carried the running max and sum
// across grid steps; here a bag of B = 1 must fill 132 SMs, so each bag is
// split into chunks of `chunk` rows (whole 64-row tiles, ops/attention.py
// tiled_chunk: one tile per block up to 8 blocks per SM), grid (chunks, B):
//  * tiled_pool_tc walks its chunk's 64-row tiles on mma_tiles.cuh
//    (mma.sync m16n8k16 fed by ldmatrix, weights through the cp.async ring,
//    one pass over [Wa | Wb] per 64 columns, or Wa per 128 ungated):
//    - bf16: the tile sits in shared memory as it is, one pass per column
//      step (about 103 KB: two blocks per SM at F 512);
//    - f32: each tile is split as it is loaded into [lo | hi] bf16 planes,
//      a slab of fs <= 256 columns of F at a time (about 103 KB: two blocks
//      per SM, which measured faster than one block holding all of F 512 at
//      170 KB); per column step and slab, one pass of [lo | hi] over the
//      slab's [Whi; Wlo] rows (lo Whi + hi Wlo) and one of hi over Whi, into
//      one accumulator. The slabs are reloaded from L2 (and split again) for
//      each column step. The f32 tile itself is not kept: Sigma e x re-reads
//      the tile's rows from L2, so M's sum takes x exactly.
//    Then an f32 epilogue sums s per row (written out), and one warp takes
//    the online max, sum and rounded e over each 32-row half of the tile,
//    rescaling on a new max as the TPU kernel does, so the running maxima
//    are those of the twin's 32-row tiles. The chunk's F-wide weighted sum
//    (2 N F flops) stays on the FMA units. The block writes the chunk's
//    (max, sum, F partial sums).
//  * combine_kernel merges a bag's chunks (32 columns x 32 chunk lanes per
//    block):
//    M = sum_c exp(mx_c - mx) m_c / sum_c exp(mx_c - mx) l_c; an all-masked
//    chunk has mx_c = -1e30 and adds nothing.
// The softmax weights p are taken from s outside the kernel, as the JAX
// package takes them in XLA.
#include <type_traits>

#include "mma_tiles.cuh"
#include "tiles.cuh"

namespace {

using tc::BM;
using tc::bf16;
using tc::PAD;

// ops/attention.py tiled_tile_smem reckons the same sum: the x tile (planes
// x fs columns, padded), the ring, then BM x 4 row partials, BM scores, BM
// weights, 4 stats and the chunk's F running sums in f32.
size_t tiled_smem(int F, int fs, int planes) {
  return sizeof(bf16) * BM * (planes * fs + PAD) + tc::RING_BYTES +
         sizeof(float) * (6 * BM + 4 + F);
}

// Rows r0.. of an f32 bag, columns c0 .. c0 + fs, into the tile [lo | hi]
// (row stride 2 fs + PAD), zeros past N. Plain loads and stores: the next
// mma_pass synchronises before it reads the tile.
__device__ __forceinline__ void load_split(const float* __restrict__ xb, int F, int c0, int fs,
                                           int r0, int N, bf16* Xs) {
  const int ldx = 2 * fs + PAD, q4 = fs / 4;
#pragma unroll 4
  for (int e = threadIdx.x; e < BM * q4; e += tc::THREADS) {
    const int r = e / q4, c = (e % q4) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < N) v = __ldg(reinterpret_cast<const float4*>(xb + (size_t)(r0 + r) * F + c0 + c));
    const __nv_bfloat162 h0 = __floats2bfloat162_rn(v.x, v.y), h1 = __floats2bfloat162_rn(v.z, v.w);
    const __nv_bfloat162 l0 = __floats2bfloat162_rn(v.x - __low2float(h0), v.y - __high2float(h0));
    const __nv_bfloat162 l1 = __floats2bfloat162_rn(v.z - __low2float(h1), v.w - __high2float(h1));
    __nv_bfloat162* lo = reinterpret_cast<__nv_bfloat162*>(Xs + r * ldx + c);
    __nv_bfloat162* hi = reinterpret_cast<__nv_bfloat162*>(Xs + r * ldx + fs + c);
    lo[0] = l0;
    lo[1] = l1;
    hi[0] = h0;
    hi[1] = h1;
  }
}

// One block per (chunk, bag). wa/wb: bf16 (F, D) for bf16 bags; for f32
// bags, per slab of fs rows of F its hi rows then its lo rows, (2 F, D).
template <typename T>
__global__ void __launch_bounds__(tc::THREADS, 2)
tiled_pool_tc(const T* __restrict__ x, const bf16* __restrict__ wa, const float* __restrict__ ba,
              const bf16* __restrict__ wb, const float* __restrict__ bb,
              const float* __restrict__ wc, const float* __restrict__ bc,
              const uint8_t* __restrict__ mask, int gated, float* __restrict__ s_out,
              float* __restrict__ m_part, float* __restrict__ mx_part, float* __restrict__ l_part,
              int N, int F, int D, int fs, int chunk) {
  constexpr bool SPLIT = std::is_same<T, float>::value;
  constexpr int PLANES = SPLIT ? 2 : 1;
  extern __shared__ uint4 tc_smem[];
  bf16* Xs = reinterpret_cast<bf16*>(tc_smem);
  const int ldx = PLANES * fs + PAD;
  tc::Ring ring{Xs + BM * ldx, 0, false};
  float* red = reinterpret_cast<float*>(tc::ring_end(ring));  // BM x 4 row partials
  float* Ss = red + BM * 4;                                   // BM: the tile's scores
  float* Es = Ss + BM;                                        // BM: e, rounded, rescaled
  float* stat = Es + BM;                                      // the sums' rescale
  float* Macc = stat + 4;                                     // F: the chunk's weighted sum
  const int bag = blockIdx.y, c0 = blockIdx.x * chunk, c1 = min(N, c0 + chunk);
  const int tid = threadIdx.x, lane = tid & 31;
  const T* xb = x + (size_t)bag * N * F;
  const uint8_t* mb = mask + (size_t)bag * N;
  for (int c = 2 * tid; c < F; c += 2 * tc::THREADS) Macc[c] = Macc[c + 1] = 0.f;
  float mx = kNegInf, l = 0.f;  // warp 0's running max and sum, equal in its lanes

  const int step = gated ? tc::BN / 2 : tc::BN, slabs = F / fs;
  const size_t slab_w = (size_t)PLANES * fs * D;  // weight elements per slab
  // the B of slab q at columns n0; none past D
  auto bsrc = [&](int q, int n0) {
    return n0 < D ? tc::BSrc{wa + q * slab_w, gated ? wb + q * slab_w : nullptr, D, n0}
                  : tc::BSrc{nullptr, nullptr, D, 0};
  };
  auto load_tile = [&](int q, int r0) {
    if constexpr (SPLIT) {
      load_split(xb, F, q * fs, fs, r0, N, Xs);
    } else {
      tc::load_rows(xb, F, r0, N, Xs);
      tc::cp_commit();
    }
  };

  for (int r0 = c0; r0 < c1; r0 += BM) {
    if (slabs == 1) load_tile(0, r0);  // the previous tile's readers passed a barrier
    float rowp[2][2] = {};
    tc::Acc acc;
    for (int n0 = 0; n0 < D; n0 += step) {
      for (int q = 0; q < slabs; ++q) {
        if (slabs > 1) {
          __syncthreads();  // every warp is done with the previous slab
          load_tile(q, r0);
        }
        const tc::BSrc b = bsrc(q, n0);
        const tc::BSrc next = q + 1 < slabs ? bsrc(q + 1, n0) : bsrc(0, n0 + step);
        if constexpr (SPLIT) {  // lo Whi + hi Wlo, then + hi Whi
          if (q == 0)
            tc::mma_pass(Xs, nullptr, ldx, 2 * fs, b, b, ring, acc);
          else
            tc::mma_pass<false, true>(Xs, nullptr, ldx, 2 * fs, b, b, ring, acc);
          tc::mma_pass<false, true>(Xs + fs, nullptr, ldx, fs, b, next, ring, acc);
        } else {
          tc::mma_pass(Xs, nullptr, ldx, F, b, next, ring, acc);
        }
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (gated && j >= 2) continue;  // g: read beside a
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = tc::gate_col(gated, n0, j, e);
            float u = tanhf(acc[mi][j][e] + ba[col]);
            if (gated) u *= sigmoidf(acc[mi][(j + 2) & 3][e] + bb[col]);
            rowp[mi][e >> 1] = fmaf(u, wc[col], rowp[mi][e >> 1]);
          }
        }
    }
    tc::row_partials(rowp, red);
    __syncthreads();
    if (tid < BM) {
      const float s = red[tid * 4] + red[tid * 4 + 1] + red[tid * 4 + 2] + red[tid * 4 + 3] + bc[0];
      Ss[tid] = s;
      if (r0 + tid < N) s_out[(size_t)bag * N + r0 + tid] = s;
    }
    __syncthreads();

    if (tid < 32) {  // one warp: the tile's two 32-row halves, one lane per row
      float ew[2], corr[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + h * 32 + lane;
        const bool live = row < N && mb[row];
        const float v = live ? Ss[h * 32 + lane] : kNegInf;
        float tmax = v;
        for (int o = 16; o > 0; o >>= 1) tmax = fmaxf(tmax, __shfl_xor_sync(murcl::kFull, tmax, o));
        const float mx_new = fmaxf(mx, tmax);
        const float e = live ? expf(v - mx_new) : 0.f;
        ew[h] = rnd<T>(e);
        corr[h] = expf(mx - mx_new);
        l = l * corr[h] + warp_sum(e);
        mx = mx_new;
      }
      Es[lane] = ew[0] * corr[1];  // the first half's e, rescaled to the tile's max
      Es[32 + lane] = ew[1];
      if (lane == 0) stat[0] = corr[0] * corr[1];
    }
    __syncthreads();
    const float scale = stat[0];
    const int rows = min(BM, N - r0);
    for (int c = 2 * tid; c < F; c += 2 * tc::THREADS) {
      float d0 = 0.f, d1 = 0.f;
      if constexpr (SPLIT) {  // the tile's f32 rows again, from L2
        const float* xr = xb + (size_t)r0 * F + c;
#pragma unroll 8
        for (int r = 0; r < rows; ++r) {
          const float2 v = __ldg(reinterpret_cast<const float2*>(xr + (size_t)r * F));
          d0 = fmaf(Es[r], v.x, d0);
          d1 = fmaf(Es[r], v.y, d1);
        }
      } else {
#pragma unroll 8
        for (int r = 0; r < rows; ++r) {
          const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(Xs + r * ldx + c));
          d0 = fmaf(Es[r], v.x, d0);
          d1 = fmaf(Es[r], v.y, d1);
        }
      }
      Macc[c] = Macc[c] * scale + d0;
      Macc[c + 1] = Macc[c + 1] * scale + d1;
    }
    __syncthreads();  // Xs, Es and stat are rewritten by the next tile
  }
  const size_t part = (size_t)bag * gridDim.x + blockIdx.x;
  for (int c = 2 * tid; c < F; c += 2 * tc::THREADS) {
    m_part[part * F + c] = Macc[c];
    m_part[part * F + c + 1] = Macc[c + 1];
  }
  if (tid == 0) {
    mx_part[part] = mx;
    l_part[part] = l;
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

// W (F, D) f32 as K8's f32 B operand: per slab of fs rows of F, rnd(W)'s
// rows, then rnd(W - rnd(W))'s rows, (2 F, D) bf16 (ops/attention.py
// _slab_planes computes the same bits).
__global__ void split_planes_kernel(const float* __restrict__ w, bf16* __restrict__ out, int F,
                                    int D, int fs) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)F * D) return;
  const int r = (int)(i / D), c = (int)(i % D);
  const float v = w[i];
  const bf16 hi = __float2bfloat16_rn(v);
  const size_t at = ((size_t)(r / fs) * 2 * fs + r % fs) * D + c;
  out[at] = hi;
  out[at + (size_t)fs * D] = __float2bfloat16_rn(v - __bfloat162float(hi));
}

template <typename T>
int tiled_impl(const void* x, const void* wa, const void* ba, const void* wb, const void* bb,
               const void* wc, const void* bc, const void* mask, int gated, void* s,
               void* m_part, void* mx_part, void* l_part, void* m, int B, int N, int F, int D,
               int fs, int chunk, cudaStream_t stream) {
  const int chunks = (N + chunk - 1) / chunk;
  const size_t smem = tiled_smem(F, fs, std::is_same<T, float>::value ? 2 : 1);
  MURCL_TRY(allow_smem(tiled_pool_tc<T>, smem));
  tiled_pool_tc<T><<<dim3(chunks, B), tc::THREADS, smem, stream>>>(
      (const T*)x, (const bf16*)wa, (const float*)ba, (const bf16*)wb, (const float*)bb,
      (const float*)wc, (const float*)bc, (const uint8_t*)mask, gated, (float*)s,
      (float*)m_part, (float*)mx_part, (float*)l_part, N, F, D, fs, chunk);
  MURCL_TRY(cudaGetLastError());
  combine_kernel<<<dim3(F / CC, B), CC * CL, 0, stream>>>(
      (const float*)m_part, (const float*)mx_part, (const float*)l_part, (float*)m, F, chunks);
  return (int)cudaGetLastError();
}

}  // namespace

// W (F, D) f32 -> out (2 F, D) bf16, K8's f32 B operand (slab: as below).
MURCL_API int murcl_split_planes(const void* w, void* out, int F, int D, int slab, void* stream) {
  const size_t n = (size_t)F * D;
  split_planes_kernel<<<(unsigned)((n + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
      (const float*)w, (bf16*)out, F, D, slab);
  return (int)cudaGetLastError();
}

// wa, wb: bf16 (F, D) for bf16 bags; for f32 bags, per slab of `slab` rows
// of F (F % slab == 0, slab % 64 == 0), rnd(W) rows then rnd(W - rnd(W))
// rows: (2 F, D) bf16. chunk: rows per block, a multiple of 64.
MURCL_API int murcl_attention_pool_tiled(int is_bf16, int gated, const void* x, const void* wa,
                                         const void* ba, const void* wb, const void* bb,
                                         const void* wc, const void* bc, const void* mask,
                                         void* s, void* m_part, void* mx_part, void* l_part,
                                         void* m, int B, int N, int F, int D, int slab, int chunk,
                                         void* stream) {
  auto strm = (cudaStream_t)stream;
  if (is_bf16)
    return tiled_impl<bf16>(x, wa, ba, wb, bb, wc, bc, mask, gated, s, m_part, mx_part, l_part, m,
                            B, N, F, D, F, chunk, strm);
  return tiled_impl<float>(x, wa, ba, wb, bb, wc, bc, mask, gated, s, m_part, mx_part, l_part, m,
                           B, N, F, D, slab, chunk, strm);
}
