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
// Bound on the H100: at the supervised stage-1 shape (384 bags x 1024 rows,
// 512 -> 256, gated; R = 393,216 rows) the gate products are 0.21 TFLOP
// forward; the backward recomputes them and adds dx's (0.62 TFLOP as three
// bf16 products, below) and dWa + dWb (0.21). A bag (1 MiB in bf16) does not
// fit a block's shared memory, so blocks take row tiles: the forward writes
// the raw scores s and pool_kernel (tiles.cuh) then takes the softmax over
// the whole bag and M = rnd(p) @ x (the bag itself is the pooled tensor, so
// nothing is written besides s); the backward writes dp in a pass of its own
// (dp_kernel, a GEMV that reads x once: ds needs each bag's sum of p dp
// before any gate gradient), recomputes the gates, writes dza/dzb to
// scratch, forms dx, and contracts x^T @ rnd(dza) and x^T @ rnd(dzb)
// split-K with f32 atomics. No backward block holds a term in N, so K7b
// takes any bag length (K7f's softmax pass holds N scores).
// Two instantiations:
//  * bf16 (supervised CLAM and ABMIL): warpgroup products (wgmma m64n128k16)
//    over 128-row tiles, both operands copied by TMA into an mbarrier ring
//    by one producer thread (wgmma_tiles.cuh, as K2/K3), persistent kernels
//    of one 384-thread block per SM whose producer warpgroup's three other
//    warps hash each pass's dropout keep bits ahead of its epilogue, biases
//    and wc staged in shared memory once per block, bf16 tiles stored by TMA
//    through swizzled staging:
//    - pool_gates_fwd_wg: the gate products (x K-major, Wa and Wb read
//      MN-major as stored: 64 columns of each per pass gated, 128 of Wa
//      ungated) and an f32 epilogue that sums s per row;
//    - pool_gates_bwd_wg: the same products, then the gate backward in f32
//      from each row's ds (softmax_bwd_kernel's, per bag); dza and dzb go to
//      scratch as two bf16 planes, hi = rnd(dz) (the operand of dWa, dWb)
//      and lo = rnd(dz - hi); dwc, dba and dbb are summed from the f32 values
//      as block partials;
//    - pool_dx_wg: dx's products take f32 operands in the TPU kernel, which
//      one bf16 product would round to 2^-9. Three bf16 products, hi Whi +
//      hi Wlo + lo Whi (W split into hi and lo planes by the caller), keep
//      about 2^-16; a block owns a 128-row tile and walks its F / 128 column
//      passes, gate a then gate b into one accumulator. Where the tile's
//      planes fit beside the ring (ungated D 128: 64 KB) they are copied
//      into shared memory once per tile and only W's planes stream; else
//      (gated D 256: 256 KB, more than a block's 227 KB) each stage holds a
//      k-slice of the tile's hi and lo planes beside W's, so each A slice
//      feeds two products and the passes after the first read the tile
//      again from L2, not device memory;
//    - wgrad_wg (shared with K3): dWa and dWb in one pass over x against
//      the scratch's hi plane [dza | dzb].
//    Device-memory bytes of the backward at the supervised shape: x read by
//    dp_kernel, the gates and the weight gradients (3 x 0.40 GB), the
//    scratch written once and read by dx (2 x 0.81) and its hi plane by the
//    weight gradients (0.40), dx written (0.40): 3.6 GB, 1.08 ms at 3.35
//    TB/s, beside 1.04 ms for its 1.03 TFLOP of bf16 products.
//  * f32 (the supervised CLIs' and the runbook's default dtype, and K8's
//    backward on f32 heatmap bags): still the FP32 FMA tiles (tiles.cuh),
//    32 rows per block, in gate_fwd_kernel, gate_bwd_kernel (which forms dx
//    from the f32 dza/dzb it keeps in shared memory) and wgrad_kernel; their
//    redesign as three bf16 wgmma products, as K2/K3's f32 route has it, is
//    queued (ROADMAP Queue 2). TF32 would round beyond the f32 tolerance of
//    1e-4.
// Gate dropout keep bits come from the counter hash of common.cuh, streams 1
// (a) and 2 (b), the streams K2 uses, so the backward regenerates the
// forward's masks.
#include "tiles.cuh"
#include "wgmma_tiles.cuh"

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

// Backward pass 1: dp = x @ rnd(gm) + gp (gp null: x @ rnd(gm)), one warp per
// row.
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
  if (lane == 0) dp_out[(size_t)bag * N + row] = acc + (gp ? gp[(size_t)bag * N + row] : 0.f);
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
// bf16: warpgroup products (wgmma) fed by TMA over 128-row tiles
// (wgmma_tiles.cuh), one persistent kernel per pass, each block walking the
// (bag, 128-row tile) pairs t = blockIdx.x, + gridDim.x, ...:
//   forward:  pool_gates_fwd_wg (the scores s), then pool_kernel;
//   backward: dp_kernel (x @ rnd(gm) per row), softmax_bwd_kernel (per bag:
//             c = sum_r p_r dp_r, ds and dbc), pool_gates_bwd_wg (the dz
//             scratch, dwc, dba, dbb), pool_dx_wg (dx), then wgrad_wg once:
//             dWa and dWb in one pass over x against the scratch's hi plane.
// The dz scratch is two planes of (B, N, Wg), Wg = 2 D gated ([dza | dzb]
// per row) or D: hi = rnd(dz) (the weight gradients' operand), then lo =
// rnd(dz - hi), B N Wg elements on; its tensor maps read it as 2 B bags, the
// lo plane's bag b as bag B + b. Wa and Wb reach dx as planes (2 F, D) each:
// rnd(W) (F rows), then rnd(W - rnd(W)).
// ops/attention.py (pool_plans) reckons the same shared-memory sums.
// ---------------------------------------------------------------------------
using wg::bf16;
using wg::BK;
using wg::BM;
using wg::BN;
using wg::TILE_A;
using wg::TILE_B;

// The gates at one element, in f32 as the TPU kernel keeps them: a = tanh(za),
// g = sigmoid(zb) (gated only), their keep scales ka, kb (1 without dropout;
// else `scale` where the keep bit is set) and u = a ka (g kb).
struct Gates {
  float a, ka, g, kb, u;
};
__device__ __forceinline__ Gates gates_f32(float za, float zb, int gated, bool drop, bool keep_a,
                                           bool keep_b, float scale) {
  Gates t{tanhf(za), 1.f, 0.f, 1.f, 0.f};
  if (drop) t.ka = keep_a ? scale : 0.f;
  t.u = t.a * t.ka;
  if (gated) {
    t.g = sigmoidf(zb);
    if (drop) t.kb = keep_b ? scale : 0.f;
    t.u *= t.g * t.kb;
  }
  return t;
}

// The gate parameters of a block in shared memory: ba, bb (0 ungated) and
// wc, D floats each.
__device__ __forceinline__ void gate_params(float* ps, const float* __restrict__ ba,
                                            const float* __restrict__ bb,
                                            const float* __restrict__ wc, int gated, int D) {
  for (int c = threadIdx.x; c < D; c += wg::CONSUMERS) {
    ps[c] = ba[c];
    ps[D + c] = gated ? bb[c] : 0.f;
    ps[2 * D + c] = wc[c];
  }
}

// Forward: the raw scores s of each 128-row tile of x (B, N, F); rows past N
// read as zeros and are not written.
__global__ void __launch_bounds__(wg::THREADS, 1)
pool_gates_fwd_wg(const __grid_constant__ CUtensorMap x_map,
                  const __grid_constant__ CUtensorMap wa_map,
                  const __grid_constant__ CUtensorMap wb_map, const float* __restrict__ ba,
                  const float* __restrict__ bb, const float* __restrict__ wc,
                  const float* __restrict__ bc, GateDropout dp, int gated,
                  float* __restrict__ s_out, int stages, int B, int N, int F, int D) {
  extern __shared__ uint8_t smem_raw[];
  wg::Pipe pipe = wg::pipe_setup(smem_raw, TILE_A + TILE_B, stages, 0, false);
  if (wg::is_producer()) {
    wg::producer_regs();
    if (threadIdx.x == wg::PRODUCER)
      produce_gates(pipe, &x_map, &wa_map, &wb_map, gated, B, N, F, D);
    else if (dp.on && threadIdx.x >= wg::PRODUCER + 32)
      bits_passes(pipe, dp.seed, dp.thresh, 1, gated, gated ? 64 : BN, D, B, N);
    return;
  }
  wg::consumer_regs();
  float* bas = reinterpret_cast<float*>(pipe.extra);  // ba, bb, wc: D each
  const float *bbs = bas + D, *wcs = bas + 2 * D;
  gate_params(bas, ba, bb, wc, gated, D);
  wg::sync_consumers();
  const int tiles = (N + BM - 1) / BM, step = gated ? 64 : BN;
  float acc[64];
  for (int t = blockIdx.x; t < tiles * B; t += gridDim.x) {
    const int bag = t / tiles, r0 = (t % tiles) * BM;
    float rowp[2] = {};
    for (int n0 = 0; n0 < D; n0 += step) {
      wg::mainloop<0, 1>(pipe, F / BK, 0, TILE_A, acc, wg::NoPre{});
      const uint2 kb = dp.on ? wg::take_bits(pipe) : make_uint2(0u, 0u);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        if (gated && j >= 8) continue;  // g: read beside a
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int eb = 0; eb < 2; ++eb) {
            const int e = 4 * j + 2 * hh + eb, col = n0 + wg::frag_col(j) + eb;
            const Gates g = gates_f32(acc[e] + bas[col], gated ? acc[e + 32] + bbs[col] : 0.f,
                                      gated, dp.on, wg::bit(kb, e), wg::bit(kb, e + 32 * gated),
                                      dp.scale);
            rowp[hh] = fmaf(g.u, wcs[col], rowp[hh]);
          }
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float v = rowp[hh];
      v += __shfl_xor_sync(murcl::kFull, v, 1);  // over the 4 lanes of a row
      v += __shfl_xor_sync(murcl::kFull, v, 2);
      const int r = r0 + wg::frag_row(hh);
      if ((threadIdx.x & 3) == 0 && r < N) s_out[(size_t)bag * N + r] = v + bc[0];
    }
  }
}

// Backward pass 3: the gate backward of each 128-row tile from x and the
// rows' ds, in f32: dza and dzb into the scratch's two planes (staged in
// four 64-column boxes a warpgroup, stored by TMA: hi at columns c0 and c1
// of bag `bag`, lo of bag B + bag), and the block's partials of dwc, dba
// and dbb, added to the outputs once at the end. Each consumer warp keeps
// its own partials in shared memory and adds to them without atomics (a
// shared-memory f32 atomic is a compare-and-swap loop, and eight warps
// would contend for each column).
__global__ void __launch_bounds__(wg::THREADS, 1)
pool_gates_bwd_wg(const __grid_constant__ CUtensorMap x_map,
                  const __grid_constant__ CUtensorMap wa_map,
                  const __grid_constant__ CUtensorMap wb_map,
                  const __grid_constant__ CUtensorMap z_st, const float* __restrict__ ba,
                  const float* __restrict__ bb, const float* __restrict__ wc, GateDropout dp,
                  int gated, const float* __restrict__ ds, float* __restrict__ dwc,
                  float* __restrict__ dba, float* __restrict__ dbb, int stages, int B, int N,
                  int F, int D) {
  extern __shared__ uint8_t smem_raw[];
  wg::Pipe pipe = wg::pipe_setup(smem_raw, TILE_A + TILE_B, stages, 4 * wg::OUT_TILE, false);
  if (wg::is_producer()) {
    wg::producer_regs();
    if (threadIdx.x == wg::PRODUCER)
      produce_gates(pipe, &x_map, &wa_map, &wb_map, gated, B, N, F, D);
    else if (dp.on && threadIdx.x >= wg::PRODUCER + 32)
      bits_passes(pipe, dp.seed, dp.thresh, 1, gated, gated ? 64 : BN, D, B, N);
    return;
  }
  wg::consumer_regs();
  // ba, bb, wc (D each), then per consumer warp its partials of dwc, dba
  // and dbb (3 D)
  float* bas = reinterpret_cast<float*>(pipe.extra);
  const float *bbs = bas + D, *wcs = bas + 2 * D;
  float* parts = bas + 3 * D;
  const int tid = threadIdx.x, lane = tid & 31, w = wg::wg_index();
  float* part = parts + (tid >> 5) * 3 * D;       // this warp's
  uint8_t* lo_out = pipe.out + 2 * wg::OUT_TILE;  // this warpgroup's lo staging
  gate_params(bas, ba, bb, wc, gated, D);
  for (int c = tid; c < 8 * 3 * D; c += wg::CONSUMERS) parts[c] = 0.f;
  wg::sync_consumers();
  const int tiles = (N + BM - 1) / BM, step = gated ? 64 : BN;
  float acc[64];
  for (int t = blockIdx.x; t < tiles * B; t += gridDim.x) {
    const int bag = t / tiles, r0 = (t % tiles) * BM;
    float ds_t[2];  // this thread's two rows; dead rows 0, so their dz are 0
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = r0 + wg::frag_row(hh);
      ds_t[hh] = r < N ? ds[(size_t)bag * N + r] : 0.f;
    }
    for (int n0 = 0; n0 < D; n0 += step) {
      wg::mainloop<0, 1>(pipe, F / BK, 0, TILE_A, acc, wg::NoPre{});
      const uint2 kb = dp.on ? wg::take_bits(pipe) : make_uint2(0u, 0u);
      wg::stage_begin();
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        if (gated && j >= 8) continue;
        const int c = wg::frag_col(j), col = n0 + c;  // the thread's columns: col, col + 1
        float sums[3][2] = {};                        // u ds, dza, dzb per column
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float dza[2], dzb[2];
#pragma unroll
          for (int eb = 0; eb < 2; ++eb) {
            const int e = 4 * j + 2 * hh + eb, cc = col + eb;
            const Gates g = gates_f32(acc[e] + bas[cc], gated ? acc[e + 32] + bbs[cc] : 0.f,
                                      gated, dp.on, wg::bit(kb, e), wg::bit(kb, e + 32 * gated),
                                      dp.scale);
            const float du = ds_t[hh] * wcs[cc];
            dza[eb] = (gated ? du * (g.g * g.kb) : du) * g.ka * (1.f - g.a * g.a);
            dzb[eb] = gated ? du * (g.a * g.ka) * g.kb * g.g * (1.f - g.g) : 0.f;
            sums[0][eb] = fmaf(g.u, ds_t[hh], sums[0][eb]);
            sums[1][eb] += dza[eb];
            sums[2][eb] += dzb[eb];
          }
          // gated: box 0 holds dza's 64 columns, box 1 dzb's
          const int rl = wg::frag_row(hh) - 64 * w;
          wg::stage_split(pipe.out, lo_out, rl, c, dza);
          if (gated) wg::stage_split(pipe.out, lo_out, rl, c + 64, dzb);
        }
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          if (k == 2 && !gated) break;  // no dzb
#pragma unroll
          for (int eb = 0; eb < 2; ++eb) {  // over the lanes that share a column: lane % 4
            float v = sums[k][eb];
            v += __shfl_xor_sync(murcl::kFull, v, 4);
            v += __shfl_xor_sync(murcl::kFull, v, 8);
            v += __shfl_xor_sync(murcl::kFull, v, 16);
            if (lane < 4) part[k * D + col + eb] += v;  // lanes 0-3: distinct columns
          }
        }
      }
      wg::fence_async();
      wg::sync_wg();
      if ((tid & 127) == 0) {
        const int c1 = gated ? D + n0 : n0 + 64, r = r0 + 64 * w;
        wg::tma_store_3d(&z_st, pipe.out, n0, r, bag);
        wg::tma_store_3d(&z_st, pipe.out + wg::BOX, c1, r, bag);
        wg::tma_store_3d(&z_st, lo_out, n0, r, B + bag);
        wg::tma_store_3d(&z_st, lo_out + wg::BOX, c1, r, B + bag);
        wg::store_commit();
      }
    }
  }
  wg::stage_drain();
  wg::sync_consumers();
  for (int c = tid; c < 3 * D; c += wg::CONSUMERS) {
    if (c >= 2 * D && !gated) break;
    float v = 0.f;
    for (int wp = 0; wp < 8; ++wp) v += parts[wp * 3 * D + c];
    atomicAdd(c < D ? &dwc[c] : c < 2 * D ? &dba[c - D] : &dbb[c - 2 * D], v);
  }
}

// Backward pass 4: dx = p gm + dza @ Wa^T + dzb @ Wb^T for each 128-row
// tile, 128 columns of dx a pass, each product as three bf16 products
// hi Whi + hi Wlo + lo Whi into one f32 accumulator (gate a, then gate b),
// rounded to bf16 once and stored by TMA through a 64-column staging box per
// warpgroup (two rounds a pass). Every operand is K-major: the scratch as
// stored, and W's planes as stored (a row of W is a column of W^T). Two
// layouts of a stage:
//  * streamed: a 64-deep k-slice of the tile's hi and lo planes beside W's
//    hi and lo slices (64 KB): each A slice feeds two products, each B
//    slice of Whi two; the passes after a tile's first read its planes
//    again from L2;
//  * resident (when the tile's planes of every gate fit, at ungated D 128):
//    the producer copies the tile's planes once into shared memory, and a
//    stage holds W's two slices alone (32 KB); the planes are released for
//    the next tile when the last pass's products have completed.
__global__ void __launch_bounds__(wg::THREADS, 1)
pool_dx_wg(const __grid_constant__ CUtensorMap z_map, const __grid_constant__ CUtensorMap wa_map,
           const __grid_constant__ CUtensorMap wb_map, const __grid_constant__ CUtensorMap dx_st,
           const float* __restrict__ p, const float* __restrict__ gm, int gated, int resident,
           int stages, int B, int N, int F, int D) {
  extern __shared__ uint8_t smem_raw[];
  const int stage_bytes = resident ? 2 * TILE_B : 2 * TILE_A + 2 * TILE_B;
  wg::Pipe pipe = wg::pipe_setup(smem_raw, stage_bytes, stages, 2 * wg::BOX, false);
  // the resident planes' barriers (landed; released by the 8 consumer
  // warps), gm per warpgroup, then the planes from a 1024-aligned offset
  uint64_t* res_full = reinterpret_cast<uint64_t*>(pipe.extra);
  uint64_t* res_empty = res_full + 1;
  float* gms = reinterpret_cast<float*>(res_empty + 1);
  uint8_t* res = reinterpret_cast<uint8_t*>(gms + 2 * F);
  res += (1024 - (wg::saddr(res) & 1023)) & 1023;
  if (threadIdx.x == 0) {
    wg::bar_init(res_full, 1);
    wg::bar_init(res_empty, wg::CONSUMERS / 32);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int tiles = (N + BM - 1) / BM, nk = D / BK, gates = gated ? 2 : 1;
  // slice (g, plane, k) of the resident planes
  auto res_at = [&](int g, int pl, int k) { return res + ((g * 2 + pl) * nk + k) * TILE_A; };
  if (wg::is_producer()) {
    wg::producer_regs();
    if (threadIdx.x != wg::PRODUCER) return;
    for (int t = blockIdx.x, ord = 0; t < tiles * B; t += gridDim.x, ++ord) {
      const int bag = t / tiles, r0 = (t % tiles) * BM;
      if (resident) {
        wg::bar_wait(res_empty, (ord & 1) ^ 1);
        wg::bar_expect(res_full, (uint32_t)(gates * 2 * nk * TILE_A));
        for (int g = 0; g < gates; ++g)
          for (int pl = 0; pl < 2; ++pl)
            for (int k = 0; k < nk; ++k)
              wg::tma_load_3d(res_at(g, pl, k), &z_map, res_full, g * D + k * BK, r0,
                              pl * B + bag);
      }
      for (int n0 = 0; n0 < F; n0 += BN)
        for (int g = 0; g < gates; ++g)
          for (int k = 0; k < nk; ++k) {
            uint64_t* bar;
            uint8_t* st = wg::produce(pipe, bar);
            if (!resident) {
              wg::tma_load_3d(st, &z_map, bar, g * D + k * BK, r0, bag);
              wg::tma_load_3d(st + TILE_A, &z_map, bar, g * D + k * BK, r0, B + bag);
              st += 2 * TILE_A;
            }
            const CUtensorMap* wm = g ? &wb_map : &wa_map;
            wg::tma_load_2d(st, wm, bar, k * BK, n0);
            wg::tma_load_2d(st + TILE_B, wm, bar, k * BK, F + n0);
          }
    }
    return;
  }
  wg::consumer_regs();
  const int w = wg::wg_index(), lane = threadIdx.x & 31;
  pipe.out = pipe.base + stages * stage_bytes + w * wg::BOX;  // one box a warpgroup
  float* gmw = gms + w * F;
  float acc[64];
  for (int t = blockIdx.x, ord = 0; t < tiles * B; t += gridDim.x, ++ord) {
    const int bag = t / tiles, r0 = (t % tiles) * BM;
    wg::sync_wg();
    to_shared(gmw, gm + (size_t)bag * F, F, false, threadIdx.x & 127, 128);
    wg::sync_wg();
    float pr[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = r0 + wg::frag_row(hh);
      pr[hh] = r < N ? p[(size_t)bag * N + r] : 0.f;
    }
    if (resident) wg::bar_wait(res_full, ord & 1);
    for (int n0 = 0; n0 < F; n0 += BN) {
      for (int i = 0; i < gates * nk; ++i) {
        const int g = i / nk, k = i % nk, s = pipe.it % stages;
        wg::bar_wait(&pipe.full[s], (pipe.it / stages) & 1);
        const uint8_t* st = pipe.base + s * stage_bytes;
        const uint8_t* ahi = resident ? res_at(g, 0, k) : st;
        const uint8_t* alo = resident ? res_at(g, 1, k) : st + TILE_A;
        const uint8_t* bhi = resident ? st : st + 2 * TILE_A;
        const uint64_t dah = wg::operand<0>(ahi + w * wg::HALF_A);
        const uint64_t dal = wg::operand<0>(alo + w * wg::HALF_A);
        const uint64_t dbh = wg::operand<0>(bhi), dbl = wg::operand<0>(bhi + TILE_B);
        wg::wgmma_fence();
        wg::fence_acc(acc);
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          const uint64_t ks = wg::kstep<0>(kk);
          wg::mma<0, 0>(acc, dah + ks, dbh + ks, (i | kk) != 0);
          wg::mma<0, 0>(acc, dah + ks, dbl + ks, 1);
          wg::mma<0, 0>(acc, dal + ks, dbh + ks, 1);
        }
        wg::wgmma_commit();
        wg::fence_acc(acc);
        if (i > 0) {
          wg::wgmma_wait<1>();
          wg::release(pipe, pipe.it - 1);
        }
        ++pipe.it;
      }
      wg::wgmma_wait<0>();
      wg::fence_acc(acc);
      wg::release(pipe, pipe.it - 1);
      if (resident && n0 + BN >= F) {  // the tile's last products have read its planes
        __syncwarp();
        if (lane == 0) wg::bar_arrive(res_empty);
      }
#pragma unroll
      for (int box = 0; box < 2; ++box) {
        wg::stage_begin();
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int rl = wg::frag_row(hh) - 64 * w;
#pragma unroll
          for (int j = 8 * box; j < 8 * box + 8; ++j) {
            const int c = wg::frag_col(j), col = n0 + c, e = 4 * j + 2 * hh;
            wg::stage_pair(pipe.out, rl, c - 64 * box, fmaf(pr[hh], gmw[col], acc[e]),
                           fmaf(pr[hh], gmw[col + 1], acc[e + 1]));
          }
        }
        wg::stage_end(pipe, &dx_st, n0 + 64 * box, -1, r0 + 64 * w, bag);
      }
    }
  }
  wg::stage_drain();
}

// Launch plans (ops/attention.py pool_plans mirrors them): the gate kernels'
// stages of a 128-row x slice and a B slice, beside their f32 arrays (ba,
// bb, wc; the backward also each consumer warp's three partials) and,
// backward, the hi and lo staging of two warpgroups (at least 2 stages); pool_dx_wg resident where the tile's planes fit
// beside at least 3 stages, else streamed, with at least 2 stages.
Plan fwd_plan(int D) { return plan(TILE_A + TILE_B, 0, sizeof(float) * 3 * D); }
Plan bwd_plan(int D) {  // 3-4 stages at D <= 512, 2 beyond
  return plan(TILE_A + TILE_B, 4 * wg::OUT_TILE, sizeof(float) * (3 + 8 * 3) * D, 2);
}
struct DxPlan {
  Plan plan;
  int resident;
};
DxPlan dx_plan(int F, int D, int gated) {
  const size_t arrays = 2 * sizeof(uint64_t) + sizeof(float) * 2 * F;
  const size_t planes = (size_t)(gated ? 2 : 1) * 2 * (D / BK) * TILE_A;
  const Plan r = plan(2 * TILE_B, 2 * wg::BOX, arrays + 1024 + planes);
  if (r.smem <= wg::SMEM_LIMIT) return {r, 1};
  return {plan(2 * TILE_A + 2 * TILE_B, 2 * wg::BOX, arrays, 2), 0};
}

int fwd_wg(const void* x, const void* wa, const void* ba, const void* wb, const void* bb,
           const void* wc, const void* bc, const void* mask, GateDropout dp, int gated, void* m,
           void* p, void* s, int B, int N, int F, int D, cudaStream_t stream) {
  const unsigned grid = persistent_grid((long long)((N + BM - 1) / BM) * B);
  CUtensorMap xm, wam, wbm;
  MURCL_TRY((cudaError_t)wg::map3(&xm, x, F, N, B, BM));
  MURCL_TRY((cudaError_t)wg::map2(&wam, wa, D, F, BK));
  MURCL_TRY((cudaError_t)wg::map2(&wbm, wb, D, F, BK));
  const Plan pl = fwd_plan(D);
  MURCL_TRY(allow_smem(pool_gates_fwd_wg, pl.smem));
  pool_gates_fwd_wg<<<grid, wg::THREADS, pl.smem, stream>>>(
      xm, wam, wbm, (const float*)ba, (const float*)bb, (const float*)wc, (const float*)bc, dp,
      gated, (float*)s, pl.stages, B, N, F, D);
  MURCL_TRY(cudaGetLastError());
  return pool<bf16>((const float*)s, (const uint8_t*)mask, (const bf16*)x, (float*)m, (float*)p,
                    B, N, F, stream);
}

// dpv: (2, B, N) f32 scratch, dp then ds; z: the dz scratch (2, B, N, Wg);
// wa2, wb2: W's planes (2 F, D).
int bwd_wg(const void* x, const void* wa, const void* ba, const void* wb, const void* bb,
           const void* wc, const void* wa2, const void* wb2, const void* mask, GateDropout dp,
           int gated, const void* p, const void* gm, const void* gp, const void* gs, void* dpv,
           void* z, void* dx, void* dwa, void* dba, void* dwb, void* dbb, void* dwc, void* dbc,
           int B, int N, int F, int D, cudaStream_t stream) {
  float* dpp = (float*)dpv;
  float* ds = dpp + (size_t)B * N;
  MURCL_TRY(launch_dp<bf16>(x, gm, nullptr, dpp, B, N, F, stream));
  softmax_bwd_kernel<<<B, THREADS, 0, stream>>>(dpp, 1, (const float*)p, (const float*)gp,
                                                (const float*)gs, (const uint8_t*)mask, ds,
                                                (float*)dbc, B, N);
  MURCL_TRY(cudaGetLastError());

  const unsigned grid = persistent_grid((long long)((N + BM - 1) / BM) * B);
  const int wz = gated ? 2 * D : D;
  CUtensorMap xm, wam, wbm, zst, zm, wak, wbk, dxst;
  MURCL_TRY((cudaError_t)wg::map3(&xm, x, F, N, B, BM));
  MURCL_TRY((cudaError_t)wg::map2(&wam, wa, D, F, BK));
  MURCL_TRY((cudaError_t)wg::map2(&wbm, wb, D, F, BK));
  MURCL_TRY((cudaError_t)wg::map3(&zst, z, wz, N, 2 * B, 64));
  MURCL_TRY((cudaError_t)wg::map3(&zm, z, wz, N, 2 * B, BM));
  MURCL_TRY((cudaError_t)wg::map2(&wak, wa2, D, 2 * F, BN));
  MURCL_TRY((cudaError_t)wg::map2(&wbk, wb2, D, 2 * F, BN));
  MURCL_TRY((cudaError_t)wg::map3(&dxst, dx, F, N, B, 64));

  const Plan p3 = bwd_plan(D);
  MURCL_TRY(allow_smem(pool_gates_bwd_wg, p3.smem));
  pool_gates_bwd_wg<<<grid, wg::THREADS, p3.smem, stream>>>(
      xm, wam, wbm, zst, (const float*)ba, (const float*)bb, (const float*)wc, dp, gated, ds,
      (float*)dwc, (float*)dba, (float*)dbb, p3.stages, B, N, F, D);
  MURCL_TRY(cudaGetLastError());

  const DxPlan p4 = dx_plan(F, D, gated);
  MURCL_TRY(allow_smem(pool_dx_wg, p4.plan.smem));
  pool_dx_wg<<<grid, wg::THREADS, p4.plan.smem, stream>>>(zm, wak, wbk, dxst, (const float*)p,
                                                          (const float*)gm, gated, p4.resident,
                                                          p4.plan.stages, B, N, F, D);
  MURCL_TRY(cudaGetLastError());

  return wgrad_wg_launch(x, F, z, wz, (long long)B * N, (float*)dwa, (float*)dwb, D, D, nullptr,
                         nullptr, stream);
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
    return fwd_wg(x, wa, ba, wb, bb, wc, bc, mask, dp, gated, m, p, s, B, N, F, D, strm);
  if (gated) return fwd_impl<true>(x, wa, ba, wb, bb, wc, bc, mask, dp, m, p, s, B, N, F, D, strm);
  return fwd_impl<false>(x, wa, ba, wb, bb, wc, bc, mask, dp, m, p, s, B, N, F, D, strm);
}

// In bf16, dpv holds 2 B N floats (dp, then ds), dza is the dz scratch (see
// bwd_wg: 2 B N Wg elements) and dzb is unread, and waT, wbT are W's bf16
// planes (2 F x D: rnd(W), then rnd(W - rnd(W))); in f32 dpv holds B N
// floats, dza and dzb (null when ungated) B N D each, and waT, wbT are W^T.
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
    return bwd_wg(x, wa, ba, wb, bb, wc, waT, wbT, mask, dp, gated, p, gm, gp, gs, dpv, dza, dx,
                  dwa, dba, dwb, dbb, dwc, dbc, B, N, F, D, strm);
#define MURCL_POOL_BWD(G)                                                                     \
  bwd_impl<G>(x, wa, ba, wb, bb, wc, waT, wbT, mask, dp, p, gm, gp, gs, dpv, dza, dzb, dx, dwa, \
              dba, dwb, dbb, dwc, dbc, B, N, F, D, strm)
  if (gated) return MURCL_POOL_BWD(true);
  return MURCL_POOL_BWD(false);
#undef MURCL_POOL_BWD
}
