// K2 + K3: CLAM's fused mixup + trunk + gated attention pool, forward and
// backward (need_dh = false).
//
// Replaces murcl_tpu/ops/attention_pallas.py _make_fused_trunk_fwd_kernel
// and _make_fused_trunk_bwd_kernel (via _fused_trunk_fwd_pallas and
// _fused_trunk_bwd_pallas, reached by fused_trunk_attention_pool with mix=).
// Per bag i (N rows, Fin -> L1 -> D):
//   h   = lam_i * h_i + (1 - lam_i) * h_perm[i]             (1 - lam in f32)
//   xc  = drop(relu(h @ Wf + bf))
//   a   = drop(tanh(xc @ Wa + ba)),  g = drop(sigmoid(xc @ Wb + bb))
//   s   = (a * g) @ wc + bc,  p = masked softmax(s),  M = p @ xc
// xc, a, g and the backward's dx chain are rounded to the bag dtype right
// after they are evaluated, as the TPU kernels do; products accumulate in
// f32. Every product runs here, in FP32 FMA tiles (no tensor cores yet).
//
// Bound on the H100: FLOPs. The main path's call (1536 bags x 1024 rows,
// 512 -> 512 -> 256) is about 1.6 TFLOP forward and 4.1 TFLOP backward.
// A bag (1 MiB in bf16) does not fit a block's 227 KB of shared memory, so
// the TPU's whole-bag-in-VMEM design is replaced by tiles of 32 rows:
//  * forward:  trunk_fwd_kernel (one block per row tile) writes xc to a
//    device-memory scratch and the raw scores s; pool_kernel then takes the
//    softmax over the whole bag and pools M = bf16(p) @ xc. Writing xc is the
//    price of a simple exact softmax: it costs one extra round trip of
//    B x N x L1 elements.
//  * backward: trunk_bwd_kernel recomputes the mix and the trunk and writes
//    the mixed bag, xc and dp = xc @ gm + gp; gates_bwd_kernel first sums
//    p * dp over the bag (the cross-tile sum the softmax backward needs),
//    then recomputes the gates and writes dza, dzb and dz; wgrad_kernel
//    contracts the scratches into dWf, dWa, dWb (and the bias sums) as a
//    split-K sum over all B x N rows, adding the splits with f32 atomics.
// Dropout keep bits come from a counter hash keyed by (seed, bag, stream,
// row, col) (common.cuh), so the backward regenerates the forward's masks.
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

struct Dropout {
  int on;
  uint32_t seed, thresh;
  float scale;  // 1 / (1 - rate) in f32; rounded to T at each use
};

template <typename T>
__device__ __forceinline__ float keep_scale(const Dropout& dp, uint32_t key, uint32_t idx) {
  return murcl::dropout_bits(key, idx) >= dp.thresh ? rnd<T>(dp.scale) : 0.f;
}

// Hs[r][c] = mixed bag rows r0 + r (zeros past N).
template <typename T>
__device__ void load_mixed_tile(const T* __restrict__ h, const int64_t* __restrict__ perm,
                                const float* __restrict__ lam, int bag, int r0, int N,
                                int Fin, float* Hs, int ldh) {
  const T* self = h + (size_t)bag * N * Fin;
  const T* partner = perm ? h + (size_t)perm[bag] * N * Fin : nullptr;
  float lam_t = 0.f, oml_t = 0.f;
  if (perm) {
    lam_t = rnd<T>(lam[bag]);
    oml_t = rnd<T>(1.f - lam[bag]);
  }
  for (int e = threadIdx.x; e < TM * Fin; e += THREADS) {
    const int r = e / Fin, c = e % Fin, row = r0 + r;
    float v = 0.f;
    if (row < N) {
      v = ld<T>(self + (size_t)row * Fin + c);
      if (perm) {
        const float vp = ld<T>(partner + (size_t)row * Fin + c);
        v = rnd<T>(__fadd_rn(rnd<T>(__fmul_rn(lam_t, v)), rnd<T>(__fmul_rn(oml_t, vp))));
      }
    }
    Hs[r * ldh + c] = v;
  }
}

// Xs = drop(relu(Hs @ Wf + bf)) rounded to T.
template <typename T>
__device__ void trunk_tile(const float* Hs, int ldh, const T* __restrict__ wf,
                           const float* __restrict__ bf, int Fin, int L1, int bag, int r0,
                           const Dropout& dp, float* Bs, float* Xs, int ldx) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const uint32_t key = murcl::bag_key(dp.seed, bag, 0);
  float acc[RM][RN];
  for (int n0 = 0; n0 < L1; n0 += TN) {
    gemm_tile<T>(Hs, ldh, wf, L1, Fin, n0, Bs, acc);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const int col = n0 + tx + 16 * j;
        const float z = acc[i][j] + bf[col];
        float x;
        if (dp.on) {
          const float m = z > 0.f ? keep_scale<T>(dp, key, (uint32_t)(r0 + r) * L1 + col) : 0.f;
          x = rnd<T>(__fmul_rn(rnd<T>(z), m));
        } else {
          x = rnd<T>(fmaxf(z, 0.f));
        }
        Xs[r * ldx + col] = x;
      }
    }
  }
  __syncthreads();
}

__device__ __forceinline__ float sigmoidf(float x) { return 1.f / (1.f + expf(-x)); }

// Forward pass 1: per row tile, xc (to scratch) and the raw scores s.
template <typename T>
__global__ void __launch_bounds__(THREADS)
trunk_fwd_kernel(const T* __restrict__ h, const int64_t* __restrict__ perm,
                 const float* __restrict__ lam, const T* __restrict__ wf,
                 const float* __restrict__ bf, const T* __restrict__ wa,
                 const float* __restrict__ ba, const T* __restrict__ wb,
                 const float* __restrict__ bb, const T* __restrict__ wc,
                 const float* __restrict__ bc, Dropout dp, T* __restrict__ xc_out,
                 float* __restrict__ s_out, int N, int Fin, int L1, int D) {
  extern __shared__ float smem[];
  const int ldh = Fin + 1, ldx = L1 + 1;
  float* Hs = smem;
  float* Xs = Hs + TM * ldh;
  float* Bs = Xs + TM * ldx;
  const int bag = blockIdx.y, r0 = blockIdx.x * TM;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  load_mixed_tile<T>(h, perm, lam, bag, r0, N, Fin, Hs, ldh);
  trunk_tile<T>(Hs, ldh, wf, bf, Fin, L1, bag, r0, dp, Bs, Xs, ldx);
  for (int e = threadIdx.x; e < TM * L1; e += THREADS) {
    const int r = e / L1, c = e % L1;
    if (r0 + r < N) xc_out[((size_t)bag * N + r0 + r) * L1 + c] = st<T>(Xs[r * ldx + c]);
  }

  const uint32_t key_a = murcl::bag_key(dp.seed, bag, 1), key_b = murcl::bag_key(dp.seed, bag, 2);
  float sacc[RM] = {};
  float ga[RM][RN], gb[RM][RN];
  for (int n0 = 0; n0 < D; n0 += TN) {
    gemm_tile<T>(Xs, ldx, wa, D, L1, n0, Bs, ga);
    gemm_tile<T>(Xs, ldx, wb, D, L1, n0, Bs, gb);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const uint32_t row = r0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const int col = n0 + tx + 16 * j;
        float a = rnd<T>(tanhf(ga[i][j] + ba[col]));
        float g = rnd<T>(sigmoidf(gb[i][j] + bb[col]));
        if (dp.on) {
          a = rnd<T>(__fmul_rn(a, keep_scale<T>(dp, key_a, row * D + col)));
          g = rnd<T>(__fmul_rn(g, keep_scale<T>(dp, key_b, row * D + col)));
        }
        const float u = rnd<T>(__fmul_rn(a, g));
        sacc[i] = fmaf(u, ld<T>(wc + col), sacc[i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    float v = sacc[i];
    for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(murcl::kFull, v, o);  // over tx
    const int row = r0 + ty + 16 * i;
    if (tx == 0 && row < N) s_out[(size_t)bag * N + row] = v + bc[0];
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

// Forward pass 2: masked softmax over the bag, M = bf16(p) @ xc for 128 columns.
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

// Backward pass 1: recompute mix and trunk; write hm, xc, dp = xc @ gm + gp.
template <typename T>
__global__ void __launch_bounds__(THREADS)
trunk_bwd_kernel(const T* __restrict__ h, const int64_t* __restrict__ perm,
                 const float* __restrict__ lam, const T* __restrict__ wf,
                 const float* __restrict__ bf, Dropout dp, const float* __restrict__ gm,
                 const float* __restrict__ gp, T* __restrict__ hm_out, T* __restrict__ xc_out,
                 float* __restrict__ dp_out, int N, int Fin, int L1) {
  extern __shared__ float smem[];
  const int ldh = Fin + 1, ldx = L1 + 1;
  float* Hs = smem;
  float* Xs = Hs + TM * ldh;
  float* Bs = Xs + TM * ldx;
  const int bag = blockIdx.y, r0 = blockIdx.x * TM;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  load_mixed_tile<T>(h, perm, lam, bag, r0, N, Fin, Hs, ldh);
  trunk_tile<T>(Hs, ldh, wf, bf, Fin, L1, bag, r0, dp, Bs, Xs, ldx);
  for (int e = threadIdx.x; e < TM * Fin; e += THREADS) {
    const int r = e / Fin, c = e % Fin;
    if (r0 + r < N) hm_out[((size_t)bag * N + r0 + r) * Fin + c] = st<T>(Hs[r * ldh + c]);
  }
  for (int e = threadIdx.x; e < TM * L1; e += THREADS) {
    const int r = e / L1, c = e % L1;
    if (r0 + r < N) xc_out[((size_t)bag * N + r0 + r) * L1 + c] = st<T>(Xs[r * ldx + c]);
  }
  const float* g = gm + (size_t)bag * L1;
  for (int r = warp; r < TM; r += THREADS / 32) {
    float acc = 0.f;
    for (int c = lane; c < L1; c += 32) acc = fmaf(Xs[r * ldx + c], rnd<T>(g[c]), acc);
    acc = warp_sum(acc);
    const int row = r0 + r;
    if (lane == 0 && row < N) dp_out[(size_t)bag * N + row] = acc + gp[(size_t)bag * N + row];
  }
}

// Backward pass 2: softmax backward, gate backward (dza, dzb, dwc, dbc) and
// dz = drop/relu'(bf16(p gm^T) + dza @ Wa^T + dzb @ Wb^T).
template <typename T>
__global__ void __launch_bounds__(THREADS)
gates_bwd_kernel(const T* __restrict__ xc, const T* __restrict__ wa,
                 const float* __restrict__ ba, const T* __restrict__ wb,
                 const float* __restrict__ bb, const T* __restrict__ wc,
                 const T* __restrict__ waT, const T* __restrict__ wbT,
                 const uint8_t* __restrict__ mask, Dropout dp, const float* __restrict__ p,
                 const float* __restrict__ gm, const float* __restrict__ gs,
                 const float* __restrict__ dpv, T* __restrict__ dza_out,
                 T* __restrict__ dzb_out, T* __restrict__ dz_out, float* __restrict__ dwc,
                 float* __restrict__ dbc, int N, int L1, int D) {
  extern __shared__ float smem[];
  const int ldx = L1 + 1, ldd = D + 1;
  float* Xs = smem;
  float* DAs = Xs + TM * ldx;
  float* DBs = DAs + TM * ldd;
  float* Bs = DBs + TM * ldd;
  float* Ds = Bs + KC * TN;  // TM: ds per row
  float* Ps = Ds + TM;       // TM: p per row
  float* Wcs = Ps + TM;      // D: this block's dwc partial
  float* red = Wcs + D;      // 32
  const int bag = blockIdx.y, r0 = blockIdx.x * TM;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const float* pb = p + (size_t)bag * N;
  const float* dpb = dpv + (size_t)bag * N;

  // cross-tile sum over the whole bag: c = sum_r p_r dp_r
  float part = 0.f;
  for (int r = threadIdx.x; r < N; r += THREADS) part += pb[r] * dpb[r];
  const float csum = block_sum(part, red);
  float dbc_part = 0.f;
  if (threadIdx.x < TM) {
    const int row = r0 + threadIdx.x;
    float ds = 0.f, pr = 0.f;
    if (row < N) {
      pr = pb[row];
      ds = pr * (dpb[row] - csum);
      if (!mask[(size_t)bag * N + row]) ds = 0.f;
      ds += gs[(size_t)bag * N + row];
    }
    Ds[threadIdx.x] = ds;
    Ps[threadIdx.x] = pr;
    dbc_part = ds;
  }
  for (int c = threadIdx.x; c < D; c += THREADS) Wcs[c] = 0.f;
  for (int e = threadIdx.x; e < TM * L1; e += THREADS) {
    const int r = e / L1, c = e % L1;
    Xs[r * ldx + c] = r0 + r < N ? ld<T>(xc + ((size_t)bag * N + r0 + r) * L1 + c) : 0.f;
  }
  const float dbc_blk = block_sum(dbc_part, red);  // also orders the smem writes above
  if (threadIdx.x == 0) atomicAdd(dbc, dbc_blk);

  const uint32_t key_a = murcl::bag_key(dp.seed, bag, 1), key_b = murcl::bag_key(dp.seed, bag, 2);
  float ga[RM][RN], gb[RM][RN];
  for (int n0 = 0; n0 < D; n0 += TN) {
    gemm_tile<T>(Xs, ldx, wa, D, L1, n0, Bs, ga);
    gemm_tile<T>(Xs, ldx, wb, D, L1, n0, Bs, gb);
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int col = n0 + tx + 16 * j;
      const float wc_t = ld<T>(wc + col);
      float wsum = 0.f;
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int r = ty + 16 * i;
        const uint32_t idx = (uint32_t)(r0 + r) * D + col;
        const float a = rnd<T>(tanhf(ga[i][j] + ba[col]));
        const float g = rnd<T>(sigmoidf(gb[i][j] + bb[col]));
        float ka = 1.f, kb = 1.f, a_eff = a, g_eff = g;
        if (dp.on) {
          ka = keep_scale<T>(dp, key_a, idx);
          kb = keep_scale<T>(dp, key_b, idx);
          a_eff = rnd<T>(__fmul_rn(a, ka));
          g_eff = rnd<T>(__fmul_rn(g, kb));
        }
        const float u = rnd<T>(__fmul_rn(a_eff, g_eff));
        const float ds_t = rnd<T>(Ds[r]);
        wsum = fmaf(u, ds_t, wsum);
        const float du = rnd<T>(__fmul_rn(ds_t, wc_t));
        float da = rnd<T>(__fmul_rn(du, g_eff));
        float dg = rnd<T>(__fmul_rn(du, a_eff));
        if (dp.on) {
          da = rnd<T>(__fmul_rn(da, ka));
          dg = rnd<T>(__fmul_rn(dg, kb));
        }
        const float dza = rnd<T>(__fmul_rn(da, rnd<T>(1.f - rnd<T>(__fmul_rn(a, a)))));
        const float dzb = rnd<T>(__fmul_rn(rnd<T>(__fmul_rn(dg, g)), rnd<T>(1.f - g)));
        const bool live = r0 + r < N;
        DAs[r * ldd + col] = live ? dza : 0.f;
        DBs[r * ldd + col] = live ? dzb : 0.f;
        if (live) {
          dza_out[((size_t)bag * N + r0 + r) * D + col] = st<T>(dza);
          dzb_out[((size_t)bag * N + r0 + r) * D + col] = st<T>(dzb);
        }
      }
      atomicAdd(&Wcs[col], wsum);
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < D; c += THREADS) atomicAdd(&dwc[c], Wcs[c]);

  const uint32_t key_x = murcl::bag_key(dp.seed, bag, 0);
  const float* gmb = gm + (size_t)bag * L1;
  float a1[RM][RN], a2[RM][RN];
  for (int n0 = 0; n0 < L1; n0 += TN) {
    gemm_tile<T>(DAs, ldd, waT, L1, D, n0, Bs, a1);
    gemm_tile<T>(DBs, ldd, wbT, L1, D, n0, Bs, a2);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = ty + 16 * i;
      if (r0 + r >= N) continue;
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const int col = n0 + tx + 16 * j;
        float dx = rnd<T>(__fadd_rn(rnd<T>(__fmul_rn(Ps[r], gmb[col])), rnd<T>(a1[i][j])));
        dx = rnd<T>(__fadd_rn(dx, rnd<T>(a2[i][j])));
        // relu'(z) is read as xc > 0; they differ only where 0 < z rounds
        // to a bf16 zero (|z| < 1e-40)
        const float x = Xs[r * ldx + col];
        float m;
        if (dp.on)
          m = x > 0.f ? keep_scale<T>(dp, key_x, (uint32_t)(r0 + r) * L1 + col) : 0.f;
        else
          m = x > 0.f ? 1.f : 0.f;
        dz_out[((size_t)bag * N + r0 + r) * L1 + col] = st<T>(rnd<T>(__fmul_rn(dx, m)));
      }
    }
  }
}

constexpr int WT = 64;  // output tile edge of the weight-gradient contraction
constexpr int WR = 32;  // rows staged per step

// dW[K1 x K2] += X[rows]^T @ Y[rows] over this block's split of the rows;
// blocks of the first K1 tile also add the column sums of Y into db.
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
    if (blockIdx.y == 0 && tid < WT)
      for (int rr = 0; rr < WR; ++rr) colsum += Ys[rr][tid];
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      atomicAdd(&dW[(size_t)(c1 + ty + 16 * i) * K2 + c2 + tx + 16 * j], acc[i][j]);
  if (blockIdx.y == 0 && tid < WT) atomicAdd(&db[c2 + tid], colsum);
}

size_t trunk_smem(int Fin, int L1) { return sizeof(float) * (TM * (Fin + 1) + TM * (L1 + 1) + KC * TN); }
size_t gates_smem(int L1, int D) {
  return sizeof(float) * (TM * (L1 + 1) + 2 * TM * (D + 1) + KC * TN + 2 * TM + D + 32);
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

template <typename T>
int fwd_impl(const void* h, const void* perm, const void* lam, const void* wf, const void* bf,
             const void* wa, const void* ba, const void* wb, const void* bb, const void* wc,
             const void* bc, const void* mask, Dropout dp, void* xc, void* m, void* p, void* s,
             int B, int N, int Fin, int L1, int D, cudaStream_t stream) {
  const size_t smem1 = trunk_smem(Fin, L1);
  MURCL_TRY(allow_smem(trunk_fwd_kernel<T>, smem1));
  const dim3 tiles((N + TM - 1) / TM, B);
  trunk_fwd_kernel<T><<<tiles, THREADS, smem1, stream>>>(
      (const T*)h, (const int64_t*)perm, (const float*)lam, (const T*)wf, (const float*)bf,
      (const T*)wa, (const float*)ba, (const T*)wb, (const float*)bb, (const T*)wc,
      (const float*)bc, dp, (T*)xc, (float*)s, N, Fin, L1, D);
  MURCL_TRY(cudaGetLastError());
  const size_t smem2 = sizeof(float) * (N + 32);
  MURCL_TRY(allow_smem(pool_kernel<T>, smem2));
  pool_kernel<T><<<dim3(L1 / TN, B), TN, smem2, stream>>>(
      (const float*)s, (const uint8_t*)mask, (const T*)xc, (float*)m, (float*)p, N, L1);
  return (int)cudaGetLastError();
}

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

template <typename T>
int bwd_impl(const void* h, const void* perm, const void* lam, const void* wf, const void* bf,
             const void* wa, const void* ba, const void* wb, const void* bb, const void* wc,
             const void* waT, const void* wbT, const void* mask, Dropout dp, const void* p,
             const void* gm, const void* gp, const void* gs, void* hm, void* xc, void* dpv,
             void* dza, void* dzb, void* dz, void* dwf, void* dbf, void* dwa, void* dba,
             void* dwb, void* dbb, void* dwc, void* dbc, int B, int N, int Fin, int L1, int D,
             cudaStream_t stream) {
  MURCL_TRY(cudaMemsetAsync(dwf, 0, sizeof(float) * Fin * L1, stream));
  MURCL_TRY(cudaMemsetAsync(dbf, 0, sizeof(float) * L1, stream));
  MURCL_TRY(cudaMemsetAsync(dwa, 0, sizeof(float) * L1 * D, stream));
  MURCL_TRY(cudaMemsetAsync(dba, 0, sizeof(float) * D, stream));
  MURCL_TRY(cudaMemsetAsync(dwb, 0, sizeof(float) * L1 * D, stream));
  MURCL_TRY(cudaMemsetAsync(dbb, 0, sizeof(float) * D, stream));
  MURCL_TRY(cudaMemsetAsync(dwc, 0, sizeof(float) * D, stream));
  MURCL_TRY(cudaMemsetAsync(dbc, 0, sizeof(float), stream));

  const dim3 tiles((N + TM - 1) / TM, B);
  const size_t smem1 = trunk_smem(Fin, L1);
  MURCL_TRY(allow_smem(trunk_bwd_kernel<T>, smem1));
  trunk_bwd_kernel<T><<<tiles, THREADS, smem1, stream>>>(
      (const T*)h, (const int64_t*)perm, (const float*)lam, (const T*)wf, (const float*)bf, dp,
      (const float*)gm, (const float*)gp, (T*)hm, (T*)xc, (float*)dpv, N, Fin, L1);
  MURCL_TRY(cudaGetLastError());

  const size_t smem2 = gates_smem(L1, D);
  MURCL_TRY(allow_smem(gates_bwd_kernel<T>, smem2));
  gates_bwd_kernel<T><<<tiles, THREADS, smem2, stream>>>(
      (const T*)xc, (const T*)wa, (const float*)ba, (const T*)wb, (const float*)bb,
      (const T*)wc, (const T*)waT, (const T*)wbT, (const uint8_t*)mask, dp, (const float*)p,
      (const float*)gm, (const float*)gs, (const float*)dpv, (T*)dza, (T*)dzb, (T*)dz,
      (float*)dwc, (float*)dbc, N, L1, D);
  MURCL_TRY(cudaGetLastError());

  const long long R = (long long)B * N;
  int err = wgrad<T>(hm, Fin, dz, L1, R, (float*)dwf, (float*)dbf, stream);
  if (err) return err;
  err = wgrad<T>(xc, L1, dza, D, R, (float*)dwa, (float*)dba, stream);
  if (err) return err;
  return wgrad<T>(xc, L1, dzb, D, R, (float*)dwb, (float*)dbb, stream);
}

}  // namespace

MURCL_API int murcl_fused_trunk_fwd(int is_bf16, const void* h, const void* perm,
                                    const void* lam, const void* wf, const void* bf,
                                    const void* wa, const void* ba, const void* wb,
                                    const void* bb, const void* wc, const void* bc,
                                    const void* mask, int use_dropout, uint32_t seed,
                                    uint32_t thresh, float scale, void* xc, void* m, void* p,
                                    void* s, int B, int N, int Fin, int L1, int D,
                                    void* stream) {
  const Dropout dp{use_dropout, seed, thresh, scale};
  auto strm = (cudaStream_t)stream;
  if (is_bf16)
    return fwd_impl<__nv_bfloat16>(h, perm, lam, wf, bf, wa, ba, wb, bb, wc, bc, mask, dp, xc,
                                   m, p, s, B, N, Fin, L1, D, strm);
  return fwd_impl<float>(h, perm, lam, wf, bf, wa, ba, wb, bb, wc, bc, mask, dp, xc, m, p, s,
                         B, N, Fin, L1, D, strm);
}

MURCL_API int murcl_fused_trunk_bwd(
    int is_bf16, const void* h, const void* perm, const void* lam, const void* wf,
    const void* bf, const void* wa, const void* ba, const void* wb, const void* bb,
    const void* wc, const void* waT, const void* wbT, const void* mask, int use_dropout,
    uint32_t seed, uint32_t thresh, float scale, const void* p, const void* gm, const void* gp,
    const void* gs, void* hm, void* xc, void* dpv, void* dza, void* dzb, void* dz, void* dwf,
    void* dbf, void* dwa, void* dba, void* dwb, void* dbb, void* dwc, void* dbc, int B, int N,
    int Fin, int L1, int D, void* stream) {
  const Dropout dp{use_dropout, seed, thresh, scale};
  auto strm = (cudaStream_t)stream;
  if (is_bf16)
    return bwd_impl<__nv_bfloat16>(h, perm, lam, wf, bf, wa, ba, wb, bb, wc, waT, wbT, mask, dp,
                                   p, gm, gp, gs, hm, xc, dpv, dza, dzb, dz, dwf, dbf, dwa, dba,
                                   dwb, dbb, dwc, dbc, B, N, Fin, L1, D, strm);
  return bwd_impl<float>(h, perm, lam, wf, bf, wa, ba, wb, bb, wc, waT, wbT, mask, dp, p, gm,
                         gp, gs, hm, xc, dpv, dza, dzb, dz, dwf, dbf, dwa, dba, dwb, dbb, dwc,
                         dbc, B, N, Fin, L1, D, strm);
}
