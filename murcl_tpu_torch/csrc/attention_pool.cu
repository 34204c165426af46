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
// dx = p gm + dza @ Wa^T + dzb @ Wb^T with the f32 dza, dzb and weights,
// rounded once.
//
// Bound on the H100: FLOPs. At the supervised stage-1 shape (384 bags x
// 1024 rows, 512 -> 256) the gate products are about 0.2 TFLOP forward and
// 0.6 TFLOP backward. A bag (1 MiB in bf16) does not fit a block's shared
// memory, so blocks take row tiles: the forward writes the raw scores s and
// pool_kernel (tiles.cuh) then takes the softmax over the whole bag and
// M = rnd(p) @ x (the bag itself is the pooled tensor, so nothing is written
// besides s); the backward writes dp in a pass of its own (dp_kernel, a GEMV
// that reads x once: ds needs each bag's sum of p dp before any gate
// gradient), recomputes the gates, writes dza/dzb to scratch, forms dx, and
// contracts x^T @ rnd(dza) and x^T @ rnd(dzb) split-K with f32 atomics. No
// backward block holds a term in N, so K7b takes any bag length (K7f's
// softmax pass holds N scores).
// Two instantiations:
//  * bf16 (supervised CLAM and ABMIL), on the tensor cores (mma_tiles.cuh:
//    mma.sync m16n8k16, x's 64-row tile in shared memory as bf16, weights
//    through a cp.async ring), two blocks per SM at D 256:
//    - pool_gates_fwd_tc: the gate products, one pass over [Wa | Wb] per 64
//      columns (or Wa per 128), and an f32 epilogue that sums s per row;
//    - pool_gates_bwd_tc: the same products, then the softmax and gate
//      backward in f32; dza and dzb go to scratch as two bf16 planes,
//      hi = rnd(dza) (the operand of dWa) and lo = rnd(dza - hi); dwc, dba,
//      dbb and dbc are summed from the f32 values;
//    - pool_dx_tc: dx's products take f32 operands in the TPU kernel, which
//      one bf16 product would round to 2^-9. Three bf16 products,
//      hi Whi + hi Wlo + lo Whi (W^T split into hi and lo planes by the
//      caller), keep about 2^-16: one pass of [lo | hi] over [Whi; Wlo] and
//      one of hi over Whi, gate a then gate b into one accumulator, per
//      64-row tile and 128 columns of dx;
//    - tc::wgrad: dWa = x^T @ hi (and dWb).
//  * f32 (the tests, K8's backward on f32 heatmap bags): FP32 FMA tiles
//    (tiles.cuh), 32 rows per block, in gate_fwd_kernel, gate_bwd_kernel
//    (which forms dx from the f32 dza/dzb it keeps in shared memory) and
//    wgrad_kernel. TF32 would round beyond the f32 tolerance of 1e-4.
// Gate dropout keep bits come from the counter hash of common.cuh, streams 1
// (a) and 2 (b), the streams K2 uses, so the backward regenerates the
// forward's masks.
#include "mma_tiles.cuh"
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

// f32 on FMA tiles. Xs[r][c] = bag rows r0 + r (zeros past N).
__device__ void load_tile(const float* __restrict__ x, int bag, int r0, int N, int F, float* Xs,
                          int ldx) {
  const float* xb = x + (size_t)bag * N * F;
  for (int e = threadIdx.x; e < TM * F; e += THREADS) {
    const int r = e / F, c = e % F;
    Xs[r * ldx + c] = r0 + r < N ? xb[(size_t)(r0 + r) * F + c] : 0.f;
  }
}

// Forward pass 1: the raw scores s of one 32-row tile.
template <bool GATED>
__global__ void __launch_bounds__(THREADS)
gate_fwd_kernel(const float* __restrict__ x, const float* __restrict__ wa,
                const float* __restrict__ ba, const float* __restrict__ wb,
                const float* __restrict__ bb,
                const float* __restrict__ wc, const float* __restrict__ bc, GateDropout dp,
                float* __restrict__ s_out, int N, int F, int D) {
  extern __shared__ float smem[];
  const int ldx = F + 1;
  float* Xs = smem;
  float* Bs = Xs + TM * ldx;
  const int bag = blockIdx.y, r0 = blockIdx.x * TM;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  load_tile(x, bag, r0, N, F, Xs, ldx);  // gemm_tile synchronises before reading

  const uint32_t key_a = murcl::bag_key(dp.seed, bag, 1), key_b = murcl::bag_key(dp.seed, bag, 2);
  float sacc[RM] = {};
  float ga[RM][RN], gb[RM][RN];
  for (int n0 = 0; n0 < D; n0 += TN) {
    gemm_tile<float>(Xs, ldx, wa, D, F, n0, Bs, ga);
    if (GATED) gemm_tile<float>(Xs, ldx, wb, D, F, n0, Bs, gb);
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
template <bool GATED>
__global__ void __launch_bounds__(THREADS)
gate_bwd_kernel(const float* __restrict__ x, const float* __restrict__ wa,
                const float* __restrict__ ba, const float* __restrict__ wb,
                const float* __restrict__ bb, const float* __restrict__ wc,
                const float* __restrict__ waT, const float* __restrict__ wbT,
                const uint8_t* __restrict__ mask, GateDropout dp, const float* __restrict__ p,
                const float* __restrict__ gm, const float* __restrict__ gs,
                const float* __restrict__ dpv, float* __restrict__ dza_out,
                float* __restrict__ dzb_out, float* __restrict__ dx_out,
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
  load_tile(x, bag, r0, N, F, Xs, ldx);
  const float dbc_blk = block_sum(dbc_part, red);  // also orders the smem writes above
  if (threadIdx.x == 0) atomicAdd(dbc, dbc_blk);

  const uint32_t key_a = murcl::bag_key(dp.seed, bag, 1), key_b = murcl::bag_key(dp.seed, bag, 2);
  float ga[RM][RN], gb[RM][RN];
  for (int n0 = 0; n0 < D; n0 += TN) {
    gemm_tile<float>(Xs, ldx, wa, D, F, n0, Bs, ga);
    if (GATED) gemm_tile<float>(Xs, ldx, wb, D, F, n0, Bs, gb);
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
          dza_out[((size_t)bag * N + r0 + r) * D + col] = dza;
          asum += dza;
        }
        if (GATED) {
          const float dzb = du * a_eff * kb * g * (1.f - g);
          DBs[r * ldd + col] = live ? dzb : 0.f;
          if (live) {
            dzb_out[((size_t)bag * N + r0 + r) * D + col] = dzb;
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
        dx_out[((size_t)bag * N + r0 + r) * F + col] = dx;
      }
    }
  }
}

size_t fwd_smem(int F) { return sizeof(float) * (TM * (F + 1) + KC * TN); }
size_t bwd_smem(int F, int D) {
  return sizeof(float) * (TM * (F + 1) + 2 * TM * (D + 1) + KC * TN + 2 * TM + 3 * D + 32);
}

template <bool GATED>
int fwd_impl(const void* x, const void* wa, const void* ba, const void* wb, const void* bb,
             const void* wc, const void* bc, const void* mask, GateDropout dp, void* m, void* p,
             void* s, int B, int N, int F, int D, cudaStream_t stream) {
  const size_t smem = fwd_smem(F);
  MURCL_TRY(allow_smem(gate_fwd_kernel<GATED>, smem));
  gate_fwd_kernel<GATED><<<dim3((N + TM - 1) / TM, B), THREADS, smem, stream>>>(
      (const float*)x, (const float*)wa, (const float*)ba, (const float*)wb, (const float*)bb,
      (const float*)wc, (const float*)bc, dp, (float*)s, N, F, D);
  MURCL_TRY(cudaGetLastError());
  return pool<float>((const float*)s, (const uint8_t*)mask, (const float*)x, (float*)m,
                     (float*)p, B, N, F, stream);
}

template <typename T>
cudaError_t launch_dp(const void* x, const void* gm, const void* gp, void* dpv, int B, int N,
                      int F, cudaStream_t stream) {
  dp_kernel<T><<<dim3((N + THREADS / 32 - 1) / (THREADS / 32), B), THREADS, 0, stream>>>(
      (const T*)x, (const float*)gm, (const float*)gp, (float*)dpv, N, F);
  return cudaGetLastError();
}

template <bool GATED>
int bwd_impl(const void* x, const void* wa, const void* ba, const void* wb, const void* bb,
             const void* wc, const void* waT, const void* wbT, const void* mask, GateDropout dp,
             const void* p, const void* gm, const void* gp, const void* gs, void* dpv,
             void* dza, void* dzb, void* dx, void* dwa, void* dba, void* dwb, void* dbb,
             void* dwc, void* dbc, int B, int N, int F, int D, cudaStream_t stream) {
  MURCL_TRY(launch_dp<float>(x, gm, gp, dpv, B, N, F, stream));
  const size_t smem = bwd_smem(F, D);
  MURCL_TRY(allow_smem(gate_bwd_kernel<GATED>, smem));
  gate_bwd_kernel<GATED><<<dim3((N + TM - 1) / TM, B), THREADS, smem, stream>>>(
      (const float*)x, (const float*)wa, (const float*)ba, (const float*)wb, (const float*)bb,
      (const float*)wc, (const float*)waT, (const float*)wbT, (const uint8_t*)mask, dp,
      (const float*)p, (const float*)gm, (const float*)gs, (const float*)dpv, (float*)dza,
      (float*)dzb, (float*)dx, (float*)dba, (float*)dbb, (float*)dwc, (float*)dbc, N, F, D);
  MURCL_TRY(cudaGetLastError());

  const long long R = (long long)B * N;
  const int err = wgrad<float>(x, F, dza, D, R, (float*)dwa, nullptr, stream);
  if (err || !GATED) return err;
  return wgrad<float>(x, F, dzb, D, R, (float*)dwb, nullptr, stream);
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores. The scratch dza (and dzb) holds two planes of
// B x N x D: hi = rnd(dza), then lo = rnd(dza - hi), `lo` elements apart;
// waT (and wbT) hold W^T's hi plane (D x F) and then its lo plane.
// ops/attention.py (pool_tile_smem) reckons the same shared-memory sums.
// ---------------------------------------------------------------------------
using tc::BM;
using tc::bf16;
using tc::PAD;

// the x tile, the ring, BM x 4 row partials (or ds), three D-wide partials
size_t tc_gates_smem(int F, int D) {
  return sizeof(bf16) * BM * (F + PAD) + tc::RING_BYTES + sizeof(float) * (BM * 4 + 3 * D + 32);
}
// the [lo | hi] tile of one gate's scratch, the ring, p per row
size_t tc_dx_smem(int D) {
  return sizeof(bf16) * BM * (2 * D + PAD) + tc::RING_BYTES + sizeof(float) * BM;
}

// The gates at one element, in f32 as the TPU kernel keeps them: a = tanh(za),
// g = sigmoid(zb) (gated only), their keep scales ka, kb (1 without dropout)
// and u = a ka (g kb).
struct Gates {
  float a, ka, g, kb, u;
};
__device__ __forceinline__ Gates gates_f32(float za, float zb, int gated, const GateDropout& dp,
                                           uint32_t key_a, uint32_t key_b, uint32_t idx) {
  Gates t{tanhf(za), 1.f, 0.f, 1.f, 0.f};
  if (dp.on) t.ka = keep_f32(dp, key_a, idx);
  t.u = t.a * t.ka;
  if (gated) {
    t.g = sigmoidf(zb);
    if (dp.on) t.kb = keep_f32(dp, key_b, idx);
    t.u *= t.g * t.kb;
  }
  return t;
}

// An f32 pair as hi = rnd(v) at p and lo = rnd(v - hi) at p + lo (v - hi is
// exact in f32).
__device__ __forceinline__ void st_split(bf16* p, size_t lo, const float (&v)[2]) {
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[0], v[1]);
  *reinterpret_cast<__nv_bfloat162*>(p) = hi;
  tc::st2(p + lo, v[0] - __low2float(hi), v[1] - __high2float(hi));
}

// Forward: the raw scores s of one 64-row tile.
__global__ void __launch_bounds__(tc::THREADS, 2)
pool_gates_fwd_tc(const bf16* __restrict__ x, const bf16* __restrict__ wa,
                  const float* __restrict__ ba, const bf16* __restrict__ wb,
                  const float* __restrict__ bb, const float* __restrict__ wc,
                  const float* __restrict__ bc, GateDropout dp, int gated,
                  float* __restrict__ s_out, int N, int F, int D) {
  extern __shared__ uint4 tc_smem[];
  bf16* Xs = reinterpret_cast<bf16*>(tc_smem);
  const int bag = blockIdx.y, r0 = blockIdx.x * BM, wm = tc::warp_m();
  tc::BSrc b{wa, gated ? wb : nullptr, D, 0};
  tc::Ring ring = tc::tile_start(x, bag, r0, N, F, b, Xs);
  float* red = reinterpret_cast<float*>(tc::ring_end(ring));  // BM x 4

  const uint32_t key_a = murcl::bag_key(dp.seed, bag, 1), key_b = murcl::bag_key(dp.seed, bag, 2);
  float rowp[2][2] = {};
  tc::Acc acc;
  const int step = gated ? tc::BN / 2 : tc::BN;
  for (int n0 = 0; n0 < D; n0 += step) {
    b.n0 = n0;
    const tc::BSrc next{n0 + step < D ? wa : nullptr, gated ? wb : nullptr, D, n0 + step};
    tc::mma_pass(Xs, nullptr, F + PAD, F, b, next, ring, acc);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (gated && j >= 2) continue;  // g: read beside a
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t row = r0 + wm * 32 + tc::frag_row(mi, e);
          const int col = tc::gate_col(gated, n0, j, e);
          const Gates t = gates_f32(acc[mi][j][e] + ba[col],
                                    gated ? acc[mi][(j + 2) & 3][e] + bb[col] : 0.f, gated, dp,
                                    key_a, key_b, row * D + col);
          rowp[mi][e >> 1] = fmaf(t.u, wc[col], rowp[mi][e >> 1]);
        }
      }
  }
  tc::row_partials(rowp, red);
  __syncthreads();
  const int r = threadIdx.x;
  if (r < BM && r0 + r < N)
    s_out[(size_t)bag * N + r0 + r] = red[r * 4] + red[r * 4 + 1] + red[r * 4 + 2] +
                                      red[r * 4 + 3] + bc[0];
}

// Backward pass 2: softmax backward and gate backward of one 64-row tile:
// dza, dzb (to scratch, hi and lo), dwc, dba, dbb and dbc.
__global__ void __launch_bounds__(tc::THREADS, 2)
pool_gates_bwd_tc(const bf16* __restrict__ x, const bf16* __restrict__ wa,
                  const float* __restrict__ ba, const bf16* __restrict__ wb,
                  const float* __restrict__ bb, const float* __restrict__ wc,
                  const uint8_t* __restrict__ mask, GateDropout dp, int gated,
                  const float* __restrict__ p, const float* __restrict__ gs,
                  const float* __restrict__ dpv, bf16* __restrict__ dza_out,
                  bf16* __restrict__ dzb_out, size_t lo, float* __restrict__ dba,
                  float* __restrict__ dbb, float* __restrict__ dwc, float* __restrict__ dbc,
                  int N, int F, int D) {
  extern __shared__ uint4 tc_smem[];
  bf16* Xs = reinterpret_cast<bf16*>(tc_smem);
  const int bag = blockIdx.y, r0 = blockIdx.x * BM;
  const int lane = threadIdx.x & 31, wm = tc::warp_m();
  tc::BSrc b{wa, gated ? wb : nullptr, D, 0};
  tc::Ring ring = tc::tile_start(x, bag, r0, N, F, b, Xs);
  float* Ds = reinterpret_cast<float*>(tc::ring_end(ring));  // BM: ds per row
  float* Wcs = Ds + BM * 4;                                   // D: this block's dwc partial
  float* Sa = Wcs + D;                                        // D: dba partial
  float* Sb = Sa + D;                                         // D: dbb partial
  float* red = Sb + D;                                        // 32
  const float* pb = p + (size_t)bag * N;
  const float* dpb = dpv + (size_t)bag * N;

  // cross-tile sum over the whole bag: c = sum_r p_r dp_r
  float part = 0.f;
  for (int r = threadIdx.x; r < N; r += tc::THREADS) part += pb[r] * dpb[r];
  const float csum = block_sum(part, red);
  float dbc_part = 0.f;
  if (threadIdx.x < BM) {
    const int row = r0 + threadIdx.x;
    float ds = 0.f;
    if (row < N) {
      ds = pb[row] * (dpb[row] - csum);
      if (!mask[(size_t)bag * N + row]) ds = 0.f;
      ds += gs[(size_t)bag * N + row];  // a masked row keeps the score's own cotangent
    }
    Ds[threadIdx.x] = ds;
    dbc_part = ds;
  }
  for (int c = threadIdx.x; c < D; c += tc::THREADS) Wcs[c] = Sa[c] = Sb[c] = 0.f;
  const float dbc_blk = block_sum(dbc_part, red);  // also orders the smem writes above
  if (threadIdx.x == 0) atomicAdd(dbc, dbc_blk);

  const uint32_t key_a = murcl::bag_key(dp.seed, bag, 1), key_b = murcl::bag_key(dp.seed, bag, 2);
  tc::Acc acc;
  const int step = gated ? tc::BN / 2 : tc::BN;
  for (int n0 = 0; n0 < D; n0 += step) {
    b.n0 = n0;
    const tc::BSrc next{n0 + step < D ? wa : nullptr, gated ? wb : nullptr, D, n0 + step};
    tc::mma_pass(Xs, nullptr, F + PAD, F, b, next, ring, acc);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (gated && j >= 2) continue;
      const int col = tc::gate_col(gated, n0, j, 0);  // the thread's columns: col, col + 1
      float wsum[2] = {}, asum[2] = {}, bsum[2] = {};
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = wm * 32 + tc::frag_row(mi, 2 * hh);
          const float ds = Ds[r];  // 0 past N
          float dza[2], dzb[2];
#pragma unroll
          for (int eb = 0; eb < 2; ++eb) {
            const int e = 2 * hh + eb, c = col + eb;
            const Gates t = gates_f32(acc[mi][j][e] + ba[c],
                                      gated ? acc[mi][(j + 2) & 3][e] + bb[c] : 0.f, gated, dp,
                                      key_a, key_b, (uint32_t)(r0 + r) * D + c);
            wsum[eb] = fmaf(t.u, ds, wsum[eb]);
            const float du = ds * wc[c];
            dza[eb] = (gated ? du * (t.g * t.kb) : du) * t.ka * (1.f - t.a * t.a);
            dzb[eb] = gated ? du * (t.a * t.ka) * t.kb * t.g * (1.f - t.g) : 0.f;
            asum[eb] += dza[eb];
            bsum[eb] += dzb[eb];
          }
          if (r0 + r >= N) continue;
          const size_t at = ((size_t)bag * N + r0 + r) * D + col;
          st_split(dza_out + at, lo, dza);
          if (gated) st_split(dzb_out + at, lo, dzb);
        }
#pragma unroll
      for (int eb = 0; eb < 2; ++eb) {  // over the lanes that share a column: lane % 4 equal
        float v[3] = {wsum[eb], asum[eb], bsum[eb]};
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          v[k] += __shfl_xor_sync(murcl::kFull, v[k], 4);
          v[k] += __shfl_xor_sync(murcl::kFull, v[k], 8);
          v[k] += __shfl_xor_sync(murcl::kFull, v[k], 16);
        }
        if (lane < 4) {
          atomicAdd(&Wcs[col + eb], v[0]);
          atomicAdd(&Sa[col + eb], v[1]);
          if (gated) atomicAdd(&Sb[col + eb], v[2]);
        }
      }
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < D; c += tc::THREADS) {
    atomicAdd(&dwc[c], Wcs[c]);
    atomicAdd(&dba[c], Sa[c]);
    if (gated) atomicAdd(&dbb[c], Sb[c]);
  }
}

// One gate's scratch rows r0.. as the tile [lo | hi] (BM x (2 D + PAD)),
// zeros past N, asynchronously; the caller commits the group. z: the bag's
// hi plane.
__device__ __forceinline__ void load_split(const bf16* __restrict__ z, size_t lo, int D, int r0,
                                           int N, bf16* tile) {
  const int cpr = D / 8;  // 16-byte chunks per row of one plane
  for (int e = threadIdx.x; e < 2 * BM * cpr; e += tc::THREADS) {
    const int hi = e / (BM * cpr), rem = e % (BM * cpr);
    const int r = rem / cpr, c = (rem % cpr) * 8;
    const bool ok = r0 + r < N;
    tc::cp16(tile + r * (2 * D + PAD) + hi * D + c,
             z + (hi ? 0 : lo) + (size_t)(ok ? r0 + r : 0) * D + c, ok);
  }
}

// Backward pass 3: dx = p gm + dza @ Wa^T + dzb @ Wb^T for one 64-row tile
// and 128 columns of dx (blockIdx.x = tile * F / 128 + column slice), each
// product as [lo | hi] @ [Whi; Wlo] + hi @ Whi into one accumulator; rounded
// to bf16 once.
__global__ void __launch_bounds__(tc::THREADS, 2)
pool_dx_tc(const bf16* __restrict__ waT, const bf16* __restrict__ wbT, int gated,
           const float* __restrict__ p, const float* __restrict__ gm,
           const bf16* __restrict__ dza, const bf16* __restrict__ dzb, size_t lo,
           bf16* __restrict__ dx_out, int N, int F, int D) {
  extern __shared__ uint4 tc_smem[];
  const int ldz = 2 * D + PAD, slices = F / tc::BN;
  bf16* Zs = reinterpret_cast<bf16*>(tc_smem);
  tc::Ring ring{Zs + BM * ldz, 0, true};
  float* Ps = reinterpret_cast<float*>(tc::ring_end(ring));  // BM: p per row
  const int bag = blockIdx.y, r0 = (blockIdx.x / slices) * BM;
  const int n0 = (blockIdx.x % slices) * tc::BN, wm = tc::warp_m(), wn = tc::warp_n();
  const size_t z0 = (size_t)bag * N * D;

  const tc::BSrc ba{waT, nullptr, F, n0}, bb{gated ? wbT : nullptr, nullptr, F, n0};
  tc::load_b(ba, 0, ring.buf);
  load_split(dza + z0, lo, D, r0, N, Zs);
  tc::cp_commit();
  if (threadIdx.x < BM)
    Ps[threadIdx.x] = r0 + threadIdx.x < N ? p[(size_t)bag * N + r0 + threadIdx.x] : 0.f;

  tc::Acc acc;
  tc::mma_pass(Zs, nullptr, ldz, 2 * D, ba, ba, ring, acc);             // lo Whi + hi Wlo
  tc::mma_pass<false, true>(Zs + D, nullptr, ldz, D, ba, bb, ring, acc);  // + hi Whi
  if (gated) {
    __syncthreads();  // every warp is done with dza's tile
    load_split(dzb + z0, lo, D, r0, N, Zs);
    tc::cp_commit();
    tc::mma_pass<false, true>(Zs, nullptr, ldz, 2 * D, bb, bb, ring, acc);
    tc::mma_pass<false, true>(Zs + D, nullptr, ldz, D, bb, tc::BSrc{nullptr, nullptr, F, 0},
                              ring, acc);
  }
  const float* gmb = gm + (size_t)bag * F;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = wm * 32 + tc::frag_row(mi, 2 * hh);
        if (r0 + r >= N) continue;
        const int col = n0 + wn * 32 + tc::frag_col(j, 0);
        tc::st2(dx_out + ((size_t)bag * N + r0 + r) * F + col,
                Ps[r] * gmb[col] + acc[mi][j][2 * hh],
                Ps[r] * gmb[col + 1] + acc[mi][j][2 * hh + 1]);
      }
}

int fwd_tc(const void* x, const void* wa, const void* ba, const void* wb, const void* bb,
           const void* wc, const void* bc, const void* mask, GateDropout dp, int gated, void* m,
           void* p, void* s, int B, int N, int F, int D, cudaStream_t stream) {
  const size_t smem = tc_gates_smem(F, D);
  MURCL_TRY(allow_smem(pool_gates_fwd_tc, smem));
  pool_gates_fwd_tc<<<dim3((N + BM - 1) / BM, B), tc::THREADS, smem, stream>>>(
      (const bf16*)x, (const bf16*)wa, (const float*)ba, (const bf16*)wb, (const float*)bb,
      (const float*)wc, (const float*)bc, dp, gated, (float*)s, N, F, D);
  MURCL_TRY(cudaGetLastError());
  return pool<bf16>((const float*)s, (const uint8_t*)mask, (const bf16*)x, (float*)m, (float*)p,
                    B, N, F, stream);
}

int bwd_tc(const void* x, const void* wa, const void* ba, const void* wb, const void* bb,
           const void* wc, const void* waT, const void* wbT, const void* mask, GateDropout dp,
           int gated, const void* p, const void* gm, const void* gp, const void* gs, void* dpv,
           void* dza, void* dzb, void* dx, void* dwa, void* dba, void* dwb, void* dbb, void* dwc,
           void* dbc, int B, int N, int F, int D, cudaStream_t stream) {
  MURCL_TRY(launch_dp<bf16>(x, gm, gp, dpv, B, N, F, stream));
  const int tiles = (N + BM - 1) / BM;
  const size_t lo = (size_t)B * N * D;
  const size_t smem2 = tc_gates_smem(F, D);
  MURCL_TRY(allow_smem(pool_gates_bwd_tc, smem2));
  pool_gates_bwd_tc<<<dim3(tiles, B), tc::THREADS, smem2, stream>>>(
      (const bf16*)x, (const bf16*)wa, (const float*)ba, (const bf16*)wb, (const float*)bb,
      (const float*)wc, (const uint8_t*)mask, dp, gated, (const float*)p, (const float*)gs,
      (const float*)dpv, (bf16*)dza, (bf16*)dzb, lo, (float*)dba, (float*)dbb, (float*)dwc,
      (float*)dbc, N, F, D);
  MURCL_TRY(cudaGetLastError());

  const size_t smem3 = tc_dx_smem(D);
  MURCL_TRY(allow_smem(pool_dx_tc, smem3));
  pool_dx_tc<<<dim3(tiles * (F / tc::BN), B), tc::THREADS, smem3, stream>>>(
      (const bf16*)waT, (const bf16*)wbT, gated, (const float*)p, (const float*)gm,
      (const bf16*)dza, (const bf16*)dzb, lo, (bf16*)dx, N, F, D);
  MURCL_TRY(cudaGetLastError());

  const long long R = (long long)B * N;
  const int err = tc::wgrad(x, F, dza, D, R, (float*)dwa, nullptr, stream);
  if (err || !gated) return err;
  return tc::wgrad(x, F, dzb, D, R, (float*)dwb, nullptr, stream);
}

// The backward's outputs are sums: zero them before any pass adds to them.
int zero_grads(void* dwa, void* dba, void* dwb, void* dbb, void* dwc, void* dbc, int F, int D,
               cudaStream_t stream) {
  MURCL_TRY(cudaMemsetAsync(dwa, 0, sizeof(float) * F * D, stream));
  MURCL_TRY(cudaMemsetAsync(dba, 0, sizeof(float) * D, stream));
  MURCL_TRY(cudaMemsetAsync(dwb, 0, sizeof(float) * F * D, stream));
  MURCL_TRY(cudaMemsetAsync(dbb, 0, sizeof(float) * D, stream));
  MURCL_TRY(cudaMemsetAsync(dwc, 0, sizeof(float) * D, stream));
  MURCL_TRY(cudaMemsetAsync(dbc, 0, sizeof(float), stream));
  return 0;
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
  if (is_bf16)
    return fwd_tc(x, wa, ba, wb, bb, wc, bc, mask, dp, gated, m, p, s, B, N, F, D, strm);
  if (gated) return fwd_impl<true>(x, wa, ba, wb, bb, wc, bc, mask, dp, m, p, s, B, N, F, D, strm);
  return fwd_impl<false>(x, wa, ba, wb, bb, wc, bc, mask, dp, m, p, s, B, N, F, D, strm);
}

// In bf16, dza and dzb (dzb may be null when ungated) hold 2 B N D elements
// (the hi plane, then the lo plane), and waT, wbT are W^T's bf16 hi plane
// (D x F) followed by its lo plane; in f32 they are B N D elements and W^T.
MURCL_API int murcl_attention_pool_bwd(
    int is_bf16, int gated, const void* x, const void* wa, const void* ba, const void* wb,
    const void* bb, const void* wc, const void* waT, const void* wbT, const void* mask,
    int use_dropout, uint32_t seed, uint32_t thresh, float scale, const void* p, const void* gm,
    const void* gp, const void* gs, void* dpv, void* dza, void* dzb, void* dx, void* dwa,
    void* dba, void* dwb, void* dbb, void* dwc, void* dbc, int B, int N, int F, int D,
    void* stream) {
  const GateDropout dp{use_dropout, seed, thresh, scale};
  auto strm = (cudaStream_t)stream;
  const int err = zero_grads(dwa, dba, dwb, dbb, dwc, dbc, F, D, strm);
  if (err) return err;
  if (is_bf16)
    return bwd_tc(x, wa, ba, wb, bb, wc, waT, wbT, mask, dp, gated, p, gm, gp, gs, dpv, dza, dzb,
                  dx, dwa, dba, dwb, dbb, dwc, dbc, B, N, F, D, strm);
#define MURCL_POOL_BWD(G)                                                                     \
  bwd_impl<G>(x, wa, ba, wb, bb, wc, waT, wbT, mask, dp, p, gm, gp, gs, dpv, dza, dzb, dx, dwa, \
              dba, dwb, dbb, dwc, dbc, B, N, F, D, strm)
  if (gated) return MURCL_POOL_BWD(true);
  return MURCL_POOL_BWD(false);
#undef MURCL_POOL_BWD
}
