// K7f + K7b: (gated) attention pooling over a bag that is already the trunk's
// output, forward and backward with the gradient for the bag.
//
// Replaces murcl_tpu/ops/attention_pallas.py _make_fwd_kernel and
// _make_bwd_kernel (via _fwd_pallas and _bwd_pallas, reached by
// gated_attention_pool). Per bag (N rows, F -> D):
//   a = drop(tanh(x @ Wa + ba)),  g = drop(sigmoid(x @ Wb + bb))   (gated)
//   s = (a [* g]) @ wc + bc,  p = masked softmax(s),  M = rnd(p) @ x
// Unlike K2, a, g, u = a * g and the dropout scale stay f32: only Wa and Wb
// are rounded to the bag dtype for the gate products, and wc stays f32.
// Backward: dp = x @ rnd(gm) + gp, ds = p (dp - sum(p dp)) (masked) + gs,
// dza = ds wc g_eff ka (1 - a^2), dzb = ds wc a_eff kb g (1 - g) in f32;
// dWa = x^T @ rnd(dza) (same for Wb), dba/dbb sum the f32 dza/dzb, and
// dx = p gm + dza @ Wa^T + dzb @ Wb^T with the f32 weights, rounded once.
// Every product runs here, in FP32 FMA tiles (no tensor cores yet).
//
// Bound on the H100: FLOPs. At the supervised stage-1 shape (384 bags x
// 1024 rows, 512 -> 256) the gate products are about 0.2 TFLOP forward and
// 0.6 TFLOP backward. A bag (1 MiB in bf16) does not fit a block's shared
// memory, so blocks take 32-row tiles:
//  * forward:  gate_fwd_kernel writes the raw scores s per row tile;
//    pool_kernel (tiles.cuh) then takes the softmax over the whole bag and
//    M = rnd(p) @ x. The bag itself is the pooled tensor, so nothing is
//    written besides s.
//  * backward: dp_kernel writes dp (a pass of its own, because ds needs
//    each bag's sum of p dp before any gate gradient); gate_bwd_kernel
//    recomputes the gates, writes dza/dzb in the bag dtype for the weight
//    gradients, adds dWc, dbc and the f32 bias sums with atomics, and forms
//    dx from the f32 dza/dzb it keeps in shared memory; wgrad_kernel
//    (tiles.cuh) contracts x^T @ dza and x^T @ dzb split-K with f32 atomics.
// Gate dropout keep bits come from the counter hash of common.cuh, streams 1
// (a) and 2 (b), the streams K2 uses, so the backward regenerates the
// forward's masks.
#include "tiles.cuh"

namespace {

struct GateDropout {
  int on;
  uint32_t seed, thresh;
  float scale;  // 1 / (1 - rate) in f32, applied in f32
};

__device__ __forceinline__ float keep_f32(const GateDropout& dp, uint32_t key, uint32_t idx) {
  return murcl::dropout_bits(key, idx) >= dp.thresh ? dp.scale : 0.f;
}

// Xs[r][c] = bag rows r0 + r (zeros past N).
template <typename T>
__device__ void load_tile(const T* __restrict__ x, int bag, int r0, int N, int F, float* Xs,
                          int ldx) {
  const T* xb = x + (size_t)bag * N * F;
  for (int e = threadIdx.x; e < TM * F; e += THREADS) {
    const int r = e / F, c = e % F;
    Xs[r * ldx + c] = r0 + r < N ? ld<T>(xb + (size_t)(r0 + r) * F + c) : 0.f;
  }
}

// Forward pass 1: the raw scores s of one 32-row tile.
template <typename T, bool GATED>
__global__ void __launch_bounds__(THREADS)
gate_fwd_kernel(const T* __restrict__ x, const T* __restrict__ wa, const float* __restrict__ ba,
                const T* __restrict__ wb, const float* __restrict__ bb,
                const float* __restrict__ wc, const float* __restrict__ bc, GateDropout dp,
                float* __restrict__ s_out, int N, int F, int D) {
  extern __shared__ float smem[];
  const int ldx = F + 1;
  float* Xs = smem;
  float* Bs = Xs + TM * ldx;
  const int bag = blockIdx.y, r0 = blockIdx.x * TM;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  load_tile<T>(x, bag, r0, N, F, Xs, ldx);  // gemm_tile synchronises before reading

  const uint32_t key_a = murcl::bag_key(dp.seed, bag, 1), key_b = murcl::bag_key(dp.seed, bag, 2);
  float sacc[RM] = {};
  float ga[RM][RN], gb[RM][RN];
  for (int n0 = 0; n0 < D; n0 += TN) {
    gemm_tile<T>(Xs, ldx, wa, D, F, n0, Bs, ga);
    if (GATED) gemm_tile<T>(Xs, ldx, wb, D, F, n0, Bs, gb);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const uint32_t row = r0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const int col = n0 + tx + 16 * j;
        float u = tanhf(ga[i][j] + ba[col]);
        if (dp.on) u *= keep_f32(dp, key_a, row * D + col);
        if (GATED) {
          float g = sigmoidf(gb[i][j] + bb[col]);
          if (dp.on) g *= keep_f32(dp, key_b, row * D + col);
          u *= g;
        }
        sacc[i] = fmaf(u, wc[col], sacc[i]);
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

// Backward pass 1: dp = x @ rnd(gm) + gp, one warp per row.
template <typename T>
__global__ void __launch_bounds__(THREADS)
dp_kernel(const T* __restrict__ x, const float* __restrict__ gm, const float* __restrict__ gp,
          float* __restrict__ dp_out, int N, int F) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int bag = blockIdx.y, row = blockIdx.x * (THREADS / 32) + warp;
  if (row >= N) return;
  const T* xr = x + ((size_t)bag * N + row) * F;
  const float* g = gm + (size_t)bag * F;
  float acc = 0.f;
  for (int c = lane; c < F; c += 32) acc = fmaf(ld<T>(xr + c), rnd<T>(g[c]), acc);
  acc = warp_sum(acc);
  if (lane == 0) dp_out[(size_t)bag * N + row] = acc + gp[(size_t)bag * N + row];
}

// Backward pass 2: softmax backward, gate backward (dza, dzb, dwc, dbc, dba,
// dbb) and dx = p gm + dza @ Wa^T + dzb @ Wb^T for one 32-row tile.
template <typename T, bool GATED>
__global__ void __launch_bounds__(THREADS)
gate_bwd_kernel(const T* __restrict__ x, const T* __restrict__ wa, const float* __restrict__ ba,
                const T* __restrict__ wb, const float* __restrict__ bb,
                const float* __restrict__ wc, const float* __restrict__ waT,
                const float* __restrict__ wbT, const uint8_t* __restrict__ mask, GateDropout dp,
                const float* __restrict__ p, const float* __restrict__ gm,
                const float* __restrict__ gs, const float* __restrict__ dpv,
                T* __restrict__ dza_out, T* __restrict__ dzb_out, T* __restrict__ dx_out,
                float* __restrict__ dba, float* __restrict__ dbb, float* __restrict__ dwc,
                float* __restrict__ dbc, int N, int F, int D) {
  extern __shared__ float smem[];
  const int ldx = F + 1, ldd = D + 1;
  float* Xs = smem;
  float* DAs = Xs + TM * ldx;
  float* DBs = DAs + TM * ldd;
  float* Bs = DBs + TM * ldd;
  float* Ds = Bs + KC * TN;  // TM: ds per row
  float* Ps = Ds + TM;       // TM: p per row
  float* Wcs = Ps + TM;      // D: this block's dwc partial
  float* Sa = Wcs + D;       // D: this block's dba partial
  float* Sb = Sa + D;        // D: this block's dbb partial
  float* red = Sb + D;       // 32
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
  for (int c = threadIdx.x; c < D; c += THREADS) Wcs[c] = Sa[c] = Sb[c] = 0.f;
  load_tile<T>(x, bag, r0, N, F, Xs, ldx);
  const float dbc_blk = block_sum(dbc_part, red);  // also orders the smem writes above
  if (threadIdx.x == 0) atomicAdd(dbc, dbc_blk);

  const uint32_t key_a = murcl::bag_key(dp.seed, bag, 1), key_b = murcl::bag_key(dp.seed, bag, 2);
  float ga[RM][RN], gb[RM][RN];
  for (int n0 = 0; n0 < D; n0 += TN) {
    gemm_tile<T>(Xs, ldx, wa, D, F, n0, Bs, ga);
    if (GATED) gemm_tile<T>(Xs, ldx, wb, D, F, n0, Bs, gb);
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int col = n0 + tx + 16 * j;
      const float wc_c = wc[col];
      float wsum = 0.f, asum = 0.f, bsum = 0.f;
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int r = ty + 16 * i;
        const uint32_t idx = (uint32_t)(r0 + r) * D + col;
        const float a = tanhf(ga[i][j] + ba[col]);
        const float ka = dp.on ? keep_f32(dp, key_a, idx) : 1.f;
        const float a_eff = a * ka;
        float g = 0.f, kb = 1.f, g_eff = 0.f, u = a_eff;
        if (GATED) {
          g = sigmoidf(gb[i][j] + bb[col]);
          kb = dp.on ? keep_f32(dp, key_b, idx) : 1.f;
          g_eff = g * kb;
          u = a_eff * g_eff;
        }
        const float ds = Ds[r];
        wsum = fmaf(u, ds, wsum);
        const float du = ds * wc_c;
        const float dza = (GATED ? du * g_eff : du) * ka * (1.f - a * a);
        const bool live = r0 + r < N;
        DAs[r * ldd + col] = live ? dza : 0.f;
        if (live) {
          dza_out[((size_t)bag * N + r0 + r) * D + col] = st<T>(dza);
          asum += dza;
        }
        if (GATED) {
          const float dzb = du * a_eff * kb * g * (1.f - g);
          DBs[r * ldd + col] = live ? dzb : 0.f;
          if (live) {
            dzb_out[((size_t)bag * N + r0 + r) * D + col] = st<T>(dzb);
            bsum += dzb;
          }
        }
      }
      atomicAdd(&Wcs[col], wsum);
      atomicAdd(&Sa[col], asum);
      if (GATED) atomicAdd(&Sb[col], bsum);
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < D; c += THREADS) {
    atomicAdd(&dwc[c], Wcs[c]);
    atomicAdd(&dba[c], Sa[c]);
    if (GATED) atomicAdd(&dbb[c], Sb[c]);
  }

  const float* gmb = gm + (size_t)bag * F;
  float a1[RM][RN], a2[RM][RN];
  for (int n0 = 0; n0 < F; n0 += TN) {
    gemm_tile<float>(DAs, ldd, waT, F, D, n0, Bs, a1);
    if (GATED) gemm_tile<float>(DBs, ldd, wbT, F, D, n0, Bs, a2);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = ty + 16 * i;
      if (r0 + r >= N) continue;
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const int col = n0 + tx + 16 * j;
        float dx = Ps[r] * gmb[col] + a1[i][j];
        if (GATED) dx += a2[i][j];
        dx_out[((size_t)bag * N + r0 + r) * F + col] = st<T>(dx);
      }
    }
  }
}

size_t fwd_smem(int F) { return sizeof(float) * (TM * (F + 1) + KC * TN); }
size_t bwd_smem(int F, int D) {
  return sizeof(float) * (TM * (F + 1) + 2 * TM * (D + 1) + KC * TN + 2 * TM + 3 * D + 32);
}

template <typename T, bool GATED>
int fwd_impl(const void* x, const void* wa, const void* ba, const void* wb, const void* bb,
             const void* wc, const void* bc, const void* mask, GateDropout dp, void* m, void* p,
             void* s, int B, int N, int F, int D, cudaStream_t stream) {
  const size_t smem = fwd_smem(F);
  MURCL_TRY(allow_smem(gate_fwd_kernel<T, GATED>, smem));
  gate_fwd_kernel<T, GATED><<<dim3((N + TM - 1) / TM, B), THREADS, smem, stream>>>(
      (const T*)x, (const T*)wa, (const float*)ba, (const T*)wb, (const float*)bb,
      (const float*)wc, (const float*)bc, dp, (float*)s, N, F, D);
  MURCL_TRY(cudaGetLastError());
  return pool<T>((const float*)s, (const uint8_t*)mask, (const T*)x, (float*)m, (float*)p, B, N,
                 F, stream);
}

template <typename T, bool GATED>
int bwd_impl(const void* x, const void* wa, const void* ba, const void* wb, const void* bb,
             const void* wc, const void* waT, const void* wbT, const void* mask, GateDropout dp,
             const void* p, const void* gm, const void* gp, const void* gs, void* dpv,
             void* dza, void* dzb, void* dx, void* dwa, void* dba, void* dwb, void* dbb,
             void* dwc, void* dbc, int B, int N, int F, int D, cudaStream_t stream) {
  MURCL_TRY(cudaMemsetAsync(dwa, 0, sizeof(float) * F * D, stream));
  MURCL_TRY(cudaMemsetAsync(dba, 0, sizeof(float) * D, stream));
  MURCL_TRY(cudaMemsetAsync(dwb, 0, sizeof(float) * F * D, stream));
  MURCL_TRY(cudaMemsetAsync(dbb, 0, sizeof(float) * D, stream));
  MURCL_TRY(cudaMemsetAsync(dwc, 0, sizeof(float) * D, stream));
  MURCL_TRY(cudaMemsetAsync(dbc, 0, sizeof(float), stream));

  dp_kernel<T><<<dim3((N + THREADS / 32 - 1) / (THREADS / 32), B), THREADS, 0, stream>>>(
      (const T*)x, (const float*)gm, (const float*)gp, (float*)dpv, N, F);
  MURCL_TRY(cudaGetLastError());

  const size_t smem = bwd_smem(F, D);
  MURCL_TRY(allow_smem(gate_bwd_kernel<T, GATED>, smem));
  gate_bwd_kernel<T, GATED><<<dim3((N + TM - 1) / TM, B), THREADS, smem, stream>>>(
      (const T*)x, (const T*)wa, (const float*)ba, (const T*)wb, (const float*)bb,
      (const float*)wc, (const float*)waT, (const float*)wbT, (const uint8_t*)mask, dp,
      (const float*)p, (const float*)gm, (const float*)gs, (const float*)dpv, (T*)dza, (T*)dzb,
      (T*)dx, (float*)dba, (float*)dbb, (float*)dwc, (float*)dbc, N, F, D);
  MURCL_TRY(cudaGetLastError());

  const long long R = (long long)B * N;
  const int err = wgrad<T>(x, F, dza, D, R, (float*)dwa, nullptr, stream);
  if (err || !GATED) return err;
  return wgrad<T>(x, F, dzb, D, R, (float*)dwb, nullptr, stream);
}

}  // namespace

MURCL_API int murcl_attention_pool_fwd(int is_bf16, int gated, const void* x, const void* wa,
                                       const void* ba, const void* wb, const void* bb,
                                       const void* wc, const void* bc, const void* mask,
                                       int use_dropout, uint32_t seed, uint32_t thresh,
                                       float scale, void* m, void* p, void* s, int B, int N,
                                       int F, int D, void* stream) {
  const GateDropout dp{use_dropout, seed, thresh, scale};
  auto strm = (cudaStream_t)stream;
  if (is_bf16 && gated)
    return fwd_impl<__nv_bfloat16, true>(x, wa, ba, wb, bb, wc, bc, mask, dp, m, p, s, B, N, F,
                                         D, strm);
  if (is_bf16)
    return fwd_impl<__nv_bfloat16, false>(x, wa, ba, wb, bb, wc, bc, mask, dp, m, p, s, B, N, F,
                                          D, strm);
  if (gated)
    return fwd_impl<float, true>(x, wa, ba, wb, bb, wc, bc, mask, dp, m, p, s, B, N, F, D, strm);
  return fwd_impl<float, false>(x, wa, ba, wb, bb, wc, bc, mask, dp, m, p, s, B, N, F, D, strm);
}

MURCL_API int murcl_attention_pool_bwd(
    int is_bf16, int gated, const void* x, const void* wa, const void* ba, const void* wb,
    const void* bb, const void* wc, const void* waT, const void* wbT, const void* mask,
    int use_dropout, uint32_t seed, uint32_t thresh, float scale, const void* p, const void* gm,
    const void* gp, const void* gs, void* dpv, void* dza, void* dzb, void* dx, void* dwa,
    void* dba, void* dwb, void* dbb, void* dwc, void* dbc, int B, int N, int F, int D,
    void* stream) {
  const GateDropout dp{use_dropout, seed, thresh, scale};
  auto strm = (cudaStream_t)stream;
#define MURCL_POOL_BWD(T, G)                                                                  \
  bwd_impl<T, G>(x, wa, ba, wb, bb, wc, waT, wbT, mask, dp, p, gm, gp, gs, dpv, dza, dzb, dx, \
                 dwa, dba, dwb, dbb, dwc, dbc, B, N, F, D, strm)
  if (is_bf16 && gated) return MURCL_POOL_BWD(__nv_bfloat16, true);
  if (is_bf16) return MURCL_POOL_BWD(__nv_bfloat16, false);
  if (gated) return MURCL_POOL_BWD(float, true);
  return MURCL_POOL_BWD(float, false);
#undef MURCL_POOL_BWD
}
