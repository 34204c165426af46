// K2 + K3: CLAM's fused mixup + trunk + attention pool, forward and
// backward, gated or not, with the bags' gradient dh on request.
//
// Replaces murcl_tpu/ops/attention_pallas.py _make_fused_trunk_fwd_kernel
// and _make_fused_trunk_bwd_kernel (via _fused_trunk_fwd_pallas and
// _fused_trunk_bwd_pallas, reached by fused_trunk_attention_pool).
// Per bag i (N rows, Fin -> L1 -> D):
//   h   = lam_i * h_i + (1 - lam_i) * h_perm[i]             (1 - lam in f32)
//   xc  = drop(relu(h @ Wf + bf))
//   a   = drop(tanh(xc @ Wa + ba)),  g = drop(sigmoid(xc @ Wb + bb))
//   u   = a * g (gated) or a (ungated: Wb, bb unread, their grads zero)
//   s   = u @ wc + bc,  p = masked softmax(s),  M = p @ xc
// and with need_dh (unmixed only) dh = dz @ Wf^T, dz the trunk's
// pre-activation gradient in the bag dtype, rounded as the TPU kernel does.
// xc, a, g and the backward's dx chain are rounded to the bag dtype right
// after they are evaluated, as the TPU kernels do; products accumulate in
// f32.
//
// Bound on the H100: at the main path's call (1536 bags x 1024 rows, 512 ->
// 512 -> 256; R = 1,572,864 rows) the products are 1.65 TFLOP forward and
// 4.13 TFLOP backward (1.67 and 4.17 ms at 989 TFLOP/s in bf16), and one bf16
// (R, 512) tensor is 1.61 GB (0.48 ms at 3.35 TB/s). A bag (1 MiB in bf16)
// does not fit a block's 227 KB of shared memory, and at 128-row tiles
// neither do a tile of the mixed bag and its xc together (128 KB each at
// Fin = L1 = 512), so each pass below writes a scratch in device memory that
// the next reads back; M = bf16(p) @ xc comes from pool_kernel (tiles.cuh),
// an exact softmax over the whole bag.
// Two instantiations:
//  * bf16 (the training path): warpgroup products (wgmma m64n128k16) over
//    128-row tiles, both operands copied by TMA into an mbarrier ring (as
//    many stages as fit beside the output staging: 5-6 of 32 KB, 3 of 48 KB
//    with the mixup's partner slice) by one producer thread
//    (wgmma_tiles.cuh), weights read as stored (wgmma's transpose bit, no
//    transposed copies), one persistent kernel per pass (a block per SM
//    walks the tiles, so its producer loads the next pass while its
//    consumers finish an epilogue). The tensor cores multiply exactly the
//    bf16 values the FMA tiles multiplied (the mixed bag, xc, dza, dzb and dz
//    are rounded before they are stored), so results differ from the FMA
//    version's only in summation order. The softmax backward's bag sum
//    c = sum_r p_r dp_r takes dp_r = xc_r . bf16(gm) + gp_r from the trunk
//    pass's per-128-column partials, summed in a fixed order (so dh stays
//    bitwise from run to run); c taken instead as M . bf16(gm) + sum_r p_r
//    gp_r from the forward's M, which would let the gates follow the trunk
//    with no pass between, missed the bf16 tolerance on dbc (2.99e-2 > 2e-2
//    at N 100: M rounds p to bf16, and dbc sums the near-cancelling
//    p_r (dp_r - c)).
//    Device-memory bytes per pass at the main call (reads + writes, GB):
//      forward  trunk_wg 3.22 + 3.22 (h, h[perm]; xc and the mixed bag hm,
//               written once so that the later column passes read it back
//               instead of mixing again), gates_fwd_wg 1.61, pool_kernel
//               1.61: 9.66 GB (2.88 ms), hm's 1.61 more than the mma.sync
//               kernels moved (unmixed 6.44);
//      backward trunk_wg 3.22 + 3.22 (xc, hm), gates_bwd_wg 1.61 + 1.61
//               ([dza | dzb]), dx_wg 3.22 + 1.61 (dz), wgrad_wg dWf 3.22
//               and dWa + dWb 3.22 (one pass over xc against [dza | dzb]),
//               and 0.06 of dp partials and ds: 21.0 GB (6.26 ms), where the
//               mma.sync kernels moved 22.5 GB (their second xc read is
//               gone).
//    So both stay bound by device memory above their FLOP bound; one
//    kernel per tile for the whole chain (xc and [dza | dzb] kept on chip)
//    is the next step. Each 16 KB weight slice that lands feeds 128 rows: a
//    product streams 6.4 GB of weights from L2 where the 64-row tiles
//    streamed 12.9; the A slices are read again from L2 for each 128
//    columns of output (L1 / 128 times in the trunk, D / 64 times gated in
//    the gates). A block is 384 threads: two consumer warpgroups of 64
//    rows and a producer warpgroup, whose other three warps mix the bags and
//    hash each pass's dropout keep bits ahead of its epilogue; the
//    epilogues (tanh and sigmoid, the bf16 roundings) write their tiles
//    through shared memory for TMA stores while the producer's copies
//    proceed. Launches: the forward's trunk_wg and gates_fwd_wg, the
//    backward's trunk_wg, softmax_bwd_kernel, gates_bwd_wg, dx_wg (dh_wg
//    with need_dh) and two wgrad_wg; the weight gradients add their row
//    splits with f32 atomics.
//  * f32 (the tests and the heatmap's bags up to 3,072 padded patches): the
//    FP32 FMA tiles of tiles.cuh, 32 rows per block, in trunk_fwd_kernel,
//    trunk_bwd_kernel, gates_bwd_kernel and wgrad_kernel. TF32 would round
//    beyond the f32 tolerance of 1e-4.
// The gated flag is a runtime argument, uniform over the launch: ungated
// blocks skip the Wb products, dzb and dWb. Gate a keeps dropout stream 1 in
// both modes.
// Dropout keep bits come from a counter hash keyed by (seed, bag, stream,
// row, col) (common.cuh), so the backward regenerates the forward's masks.
#include "tiles.cuh"
#include "wgmma_tiles.cuh"

namespace {

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

// Forward pass 1: per row tile, xc (to scratch) and the raw scores s.
template <typename T>
__global__ void __launch_bounds__(THREADS)
trunk_fwd_kernel(const T* __restrict__ h, const int64_t* __restrict__ perm,
                 const float* __restrict__ lam, const T* __restrict__ wf,
                 const float* __restrict__ bf, const T* __restrict__ wa,
                 const float* __restrict__ ba, const T* __restrict__ wb,
                 const float* __restrict__ bb, const T* __restrict__ wc,
                 const float* __restrict__ bc, Dropout dp, int gated, T* __restrict__ xc_out,
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
    if (gated) gemm_tile<T>(Xs, ldx, wb, D, L1, n0, Bs, gb);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const uint32_t row = r0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const int col = n0 + tx + 16 * j;
        float a = rnd<T>(tanhf(ga[i][j] + ba[col]));
        if (dp.on) a = rnd<T>(__fmul_rn(a, keep_scale<T>(dp, key_a, row * D + col)));
        float u = a;
        if (gated) {
          float g = rnd<T>(sigmoidf(gb[i][j] + bb[col]));
          if (dp.on) g = rnd<T>(__fmul_rn(g, keep_scale<T>(dp, key_b, row * D + col)));
          u = rnd<T>(__fmul_rn(a, g));
        }
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

// Backward pass 2: softmax backward, gate backward (dza, dzb, dwc, dbc),
// dz = drop/relu'(bf16(p gm^T) + dza @ Wa^T + dzb @ Wb^T) and, when dh_out is
// set, dh = dz @ Wf^T.
template <typename T>
__global__ void __launch_bounds__(THREADS)
gates_bwd_kernel(const T* __restrict__ xc, const T* __restrict__ wa,
                 const float* __restrict__ ba, const T* __restrict__ wb,
                 const float* __restrict__ bb, const T* __restrict__ wc,
                 const T* __restrict__ waT, const T* __restrict__ wbT,
                 const T* __restrict__ wfT, const uint8_t* __restrict__ mask, Dropout dp,
                 int gated, const float* __restrict__ p, const float* __restrict__ gm,
                 const float* __restrict__ gs, const float* __restrict__ dpv,
                 T* __restrict__ dza_out, T* __restrict__ dzb_out, T* __restrict__ dz_out,
                 T* __restrict__ dh_out, float* __restrict__ dwc, float* __restrict__ dbc,
                 int N, int Fin, int L1, int D) {
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
    if (gated) gemm_tile<T>(Xs, ldx, wb, D, L1, n0, Bs, gb);
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
        float ka = 1.f, a_eff = a;
        if (dp.on) {
          ka = keep_scale<T>(dp, key_a, idx);
          a_eff = rnd<T>(__fmul_rn(a, ka));
        }
        float g = 0.f, kb = 1.f, g_eff = 0.f, u = a_eff;
        if (gated) {
          g = rnd<T>(sigmoidf(gb[i][j] + bb[col]));
          g_eff = g;
          if (dp.on) {
            kb = keep_scale<T>(dp, key_b, idx);
            g_eff = rnd<T>(__fmul_rn(g, kb));
          }
          u = rnd<T>(__fmul_rn(a_eff, g_eff));
        }
        const float ds_t = rnd<T>(Ds[r]);
        wsum = fmaf(u, ds_t, wsum);
        const float du = rnd<T>(__fmul_rn(ds_t, wc_t));
        float da = gated ? rnd<T>(__fmul_rn(du, g_eff)) : du;
        if (dp.on) da = rnd<T>(__fmul_rn(da, ka));
        const float dza = rnd<T>(__fmul_rn(da, rnd<T>(1.f - rnd<T>(__fmul_rn(a, a)))));
        float dzb = 0.f;
        if (gated) {
          float dg = rnd<T>(__fmul_rn(du, a_eff));
          if (dp.on) dg = rnd<T>(__fmul_rn(dg, kb));
          dzb = rnd<T>(__fmul_rn(rnd<T>(__fmul_rn(dg, g)), rnd<T>(1.f - g)));
        }
        const bool live = r0 + r < N;
        DAs[r * ldd + col] = live ? dza : 0.f;
        DBs[r * ldd + col] = live ? dzb : 0.f;
        if (live) {
          dza_out[((size_t)bag * N + r0 + r) * D + col] = st<T>(dza);
          if (gated) dzb_out[((size_t)bag * N + r0 + r) * D + col] = st<T>(dzb);
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
    if (gated) gemm_tile<T>(DBs, ldd, wbT, L1, D, n0, Bs, a2);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = ty + 16 * i;
      if (r0 + r >= N) continue;
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const int col = n0 + tx + 16 * j;
        float dx = rnd<T>(__fadd_rn(rnd<T>(__fmul_rn(Ps[r], gmb[col])), rnd<T>(a1[i][j])));
        if (gated) dx = rnd<T>(__fadd_rn(dx, rnd<T>(a2[i][j])));
        // relu'(z) is read as xc > 0; they differ only where 0 < z rounds
        // to a bf16 zero (|z| < 1e-40)
        const float x = Xs[r * ldx + col];
        float m;
        if (dp.on)
          m = x > 0.f ? keep_scale<T>(dp, key_x, (uint32_t)(r0 + r) * L1 + col) : 0.f;
        else
          m = x > 0.f ? 1.f : 0.f;
        const float dz = rnd<T>(__fmul_rn(dx, m));
        dz_out[((size_t)bag * N + r0 + r) * L1 + col] = st<T>(dz);
        // this thread alone reads and writes Xs[r][col]: the tile becomes dz
        if (dh_out) Xs[r * ldx + col] = dz;
      }
    }
  }
  if (!dh_out) return;
  // dh = dz @ Wf^T, rounded to T once (the tile's dead rows hold xc = 0)
  float acc[RM][RN];
  for (int n0 = 0; n0 < Fin; n0 += TN) {
    gemm_tile<T>(Xs, ldx, wfT, Fin, L1, n0, Bs, acc);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int row = r0 + ty + 16 * i;
      if (row >= N) continue;
#pragma unroll
      for (int j = 0; j < RN; ++j)
        dh_out[((size_t)bag * N + row) * Fin + n0 + tx + 16 * j] = st<T>(acc[i][j]);
    }
  }
}

size_t trunk_smem(int Fin, int L1) { return sizeof(float) * (TM * (Fin + 1) + TM * (L1 + 1) + KC * TN); }
size_t gates_smem(int L1, int D) {
  return sizeof(float) * (TM * (L1 + 1) + 2 * TM * (D + 1) + KC * TN + 2 * TM + D + 32);
}

// ---------------------------------------------------------------------------
// bf16: warpgroup products (wgmma) fed by TMA over 128-row tiles
// (wgmma_tiles.cuh), one persistent kernel per pass, each block walking the
// (bag, 128-row tile) pairs t = blockIdx.x, + gridDim.x, ...:
//   forward:  trunk_wg (mix and trunk; xc to scratch), gates_fwd_wg (the
//             scores s, from xc), then pool_kernel;
//   backward: trunk_wg (again; also the mixed bag hm and each row's dp
//             partial per 128 columns), softmax_bwd_kernel (per bag: the sum
//             c = sum_r p_r dp_r, ds and dbc), gates_bwd_wg (dza and dzb side
//             by side in one scratch, dwc), dx_wg (dz), dh_wg (with need_dh),
//             then wgrad_wg twice: dWf over [hm | dz] and dWa, dWb in one pass
//             over xc against [dza | dzb].
// ops/attention.py (trunk_tile_smem) reckons the same shared-memory sums.
// ---------------------------------------------------------------------------
using wg::bf16;
using wg::BK;
using wg::BM;
using wg::BN;
using wg::TILE_A;
using wg::TILE_B;

// A kernel's launch plan: ring stages (as many as fit beside the output
// staging and its arrays, at least 3) and shared-memory bytes.
struct Plan {
  int stages;
  size_t smem;
};
Plan plan(int stage_bytes, bool staging, size_t extra) {
  const int out = staging ? 2 * wg::OUT_TILE : 0;
  const int stages = wg::plan_stages(stage_bytes, out, extra);
  // fewer than 3 stages: a size no block may take, so that the launch fails
  return {stages,
          stages >= 3 ? wg::smem_bytes(stage_bytes, stages, out, extra) : wg::SMEM_LIMIT + 1};
}

// Persistent grids: one block of 384 threads per SM (a block takes most of
// an SM's shared memory and registers).
int sm_count() {
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}
unsigned persistent_grid(long long tiles) {
  return (unsigned)(tiles < sm_count() ? tiles : sm_count());
}

// The gates at one element, rounded to bf16 where gates_bwd_kernel<bf16>
// rounds them: a = tanh(za), g = sigmoid(zb) (gated only), their keep
// scales ka, kb (from the keep bits, `scale` the bf16 keep scale), the kept
// a_eff, g_eff and u = a_eff * g_eff (or a_eff).
struct Gates {
  float a, ka, a_eff, g, kb, g_eff, u;
};
__device__ __forceinline__ Gates gates_at(float za, float zb, int gated, bool drop, bool keep_a,
                                          bool keep_b, float scale) {
  Gates t{rnd<bf16>(tanhf(za)), 1.f, 0.f, 0.f, 1.f, 0.f, 0.f};
  t.a_eff = t.a;
  if (drop) {
    t.ka = keep_a ? scale : 0.f;
    t.a_eff = rnd<bf16>(__fmul_rn(t.a, t.ka));
  }
  t.u = t.a_eff;
  if (gated) {
    t.g = t.g_eff = rnd<bf16>(sigmoidf(zb));
    if (drop) {
      t.kb = keep_b ? scale : 0.f;
      t.g_eff = rnd<bf16>(__fmul_rn(t.g, t.kb));
    }
    t.u = rnd<bf16>(__fmul_rn(t.a_eff, t.g_eff));
  }
  return t;
}

// The helper warps' keep bits of every pass of a kernel's tiles, in the
// consumers' order: passes of `step` columns over `width` (the hash
// stream's row width), stream `stream` (and, gated gates, streams 1 and 2).
__device__ __forceinline__ void bits_passes(wg::Pipe& pipe, const Dropout& dp, int stream,
                                            bool two, int step, int width, int B, int N) {
  const int tiles = (N + BM - 1) / BM, ht = threadIdx.x - wg::PRODUCER - 32;
  for (int t = blockIdx.x; t < tiles * B; t += gridDim.x) {
    const int bag = t / tiles, r0 = (t % tiles) * BM;
    const uint32_t k0 = murcl::bag_key(dp.seed, bag, stream), k1 = murcl::bag_key(dp.seed, bag, 2);
    for (int n0 = 0; n0 < width; n0 += step)
      wg::make_bits(pipe, k0, k1, two, width, r0, n0, dp.thresh, ht);
  }
}

// Copies `n` floats of src into shared memory (rounded to bf16 when
// `round`), by `threads` threads numbered from `tid`.
__device__ __forceinline__ void to_shared(float* dst, const float* __restrict__ src, int n,
                                          bool round, int tid, int threads) {
  for (int i = tid; i < n; i += threads) dst[i] = round ? rnd<bf16>(src[i]) : src[i];
}

// Mix and trunk of 128-row tiles, 128 columns of xc a pass: xc = drop(relu(Hs
// @ Wf + bf)) to the scratch (staged, stored by TMA), Wf read MN-major as
// stored. With a partner bag (perm), the first pass of a tile loads the
// partner's slices beside the bag's, the producer warpgroup's three other
// warps mix them in place and store them to hm by TMA, and the later passes
// read the mixed tile back from hm (the helpers' last store complete
// before the producer's first load of it: the aux barrier), so a tile is
// mixed once. With dpp (the backward) each pass c also writes dpp[c][row] =
// xc[row, 128 c ..] . bf16(gm[bag, 128 c ..]).
__global__ void __launch_bounds__(wg::THREADS, 1)
trunk_wg(const __grid_constant__ CUtensorMap h_map, const __grid_constant__ CUtensorMap wf_map,
         const __grid_constant__ CUtensorMap hm_map, const __grid_constant__ CUtensorMap hm_st,
         const __grid_constant__ CUtensorMap xc_map, const int64_t* __restrict__ perm,
         const float* __restrict__ lam, const float* __restrict__ bf, Dropout dp,
         const float* __restrict__ gm, float* __restrict__ dpp, int stages, int B, int N,
         int Fin, int L1) {
  extern __shared__ uint8_t smem_raw[];
  const bool mixed = perm != nullptr;
  const int a_bytes = TILE_A * (mixed ? 2 : 1);
  wg::Pipe pipe = wg::pipe_setup(smem_raw, a_bytes + TILE_B, stages, 2 * wg::OUT_TILE, mixed);
  const int tiles = (N + BM - 1) / BM, nk = Fin / BK;
  if (wg::is_producer()) {
    wg::producer_regs();
    if (threadIdx.x == wg::PRODUCER) {
      for (int t = blockIdx.x, ord = 0; t < tiles * B; t += gridDim.x, ++ord) {
        const int bag = t / tiles, r0 = (t % tiles) * BM;
        const int partner = mixed ? (int)perm[bag] : 0;
        for (int n0 = 0; n0 < L1; n0 += BN) {
          const bool from_hm = mixed && n0 > 0;
          if (from_hm && n0 == BN) {  // the tile's mixed slices are in hm
            wg::bar_wait(pipe.aux, ord & 1);
            wg::fence_async_global();
          }
          for (int k = 0; k < nk; ++k) {
            uint64_t* bar;
            uint8_t* st = wg::produce(pipe, bar, from_hm ? TILE_A + TILE_B : 0);
            if (from_hm) {
              wg::tma_load_3d(st, &hm_map, bar, k * BK, r0, bag);
            } else {
              wg::tma_load_3d(st, &h_map, bar, k * BK, r0, bag);
              if (mixed) wg::tma_load_3d(st + TILE_A, &h_map, bar, k * BK, r0, partner);
            }
            wg::load_b_mn(st + a_bytes, &wf_map, n0, &wf_map, n0 + 64, k * BK, bar);
          }
        }
      }
    } else if ((mixed || dp.on) && threadIdx.x >= wg::PRODUCER + 32) {
      const int mt = threadIdx.x - wg::PRODUCER - 32;  // 0 .. 95
      // the keep bits of pass (t, n0), made one pass ahead of the mixing
      auto bits = [&](int t, int n0) {
        const int bag = t / tiles;
        wg::make_bits(pipe, murcl::bag_key(dp.seed, bag, 0), 0, false, L1, (t % tiles) * BM, n0,
                      dp.thresh, mt);
      };
      if (dp.on && (int)blockIdx.x < tiles * B) bits(blockIdx.x, 0);
      for (int t = blockIdx.x; t < tiles * B; t += gridDim.x) {
        const int bag = t / tiles, r0 = (t % tiles) * BM;
        const __nv_bfloat162 lam2 = __float2bfloat162_rn(mixed ? lam[bag] : 1.f);
        const __nv_bfloat162 oml2 = __float2bfloat162_rn(mixed ? 1.f - lam[bag] : 0.f);
        for (int n0 = 0; n0 < L1; n0 += BN) {
          // mixed: mix and store the first pass's slices; pass the later ones on
          for (int k = 0; mixed && k < nk; ++k, ++pipe.it) {
            const int s = pipe.it % pipe.stages;
            wg::bar_wait(&pipe.full[s], (pipe.it / pipe.stages) & 1);
            if (n0 == 0) {
              uint8_t* st = pipe.base + s * pipe.stage_bytes;
              wg::mix_slice(st, st + TILE_A, lam2, oml2, mt);
              wg::fence_async();
              asm volatile("bar.sync 4, 96;\n" ::: "memory");  // the slice is mixed
              if (mt == 0) {
                wg::tma_store_3d(&hm_st, st, k * BK, r0, bag);
                wg::tma_store_3d(&hm_st, st + wg::HALF_A, k * BK, r0 + 64, bag);
                wg::store_commit();
                wg::store_wait_read();
              }
            }
            __syncwarp();
            if ((mt & 31) == 0) wg::bar_arrive(&pipe.mixed[s]);
          }
          if (mixed && n0 == 0 && mt == 0) {
            wg::store_wait_done();
            wg::bar_arrive(pipe.aux);
          }
          const int tn = n0 + BN < L1 ? t : t + (int)gridDim.x, nn = n0 + BN < L1 ? n0 + BN : 0;
          if (dp.on && tn < tiles * B) bits(tn, nn);
        }
      }
    }
    return;
  }
  wg::consumer_regs();
  const int w = wg::wg_index(), tid = threadIdx.x;
  float* bfs = reinterpret_cast<float*>(pipe.extra);  // L1: bf
  float* gms = bfs + L1 + w * L1;                     // L1 per warpgroup: bf16(gm) of its bag
  to_shared(bfs, bf, L1, false, tid, wg::CONSUMERS);
  wg::sync_consumers();
  float acc[64];
  const float scale = rnd<bf16>(dp.scale);
  for (int t = blockIdx.x; t < tiles * B; t += gridDim.x) {
    const int bag = t / tiles, r0 = (t % tiles) * BM;
    if (dpp) {
      wg::sync_wg();
      to_shared(gms, gm + (size_t)bag * L1, L1, true, tid & 127, 128);
      wg::sync_wg();
    }
    for (int n0 = 0; n0 < L1; n0 += BN) {
      wg::mainloop<0, 1>(pipe, nk, 0, a_bytes, acc, wg::NoPre{});
      const uint2 kb = dp.on ? wg::take_bits(pipe) : make_uint2(0u, 0u);
      wg::stage_begin();
      float rowp[2] = {};
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int rl = wg::frag_row(hh), c = wg::frag_col(j), col = n0 + c;
          float x[2];
#pragma unroll
          for (int eb = 0; eb < 2; ++eb) {
            const float z = acc[4 * j + 2 * hh + eb] + bfs[col + eb];
            if (dp.on) {
              const float m = z > 0.f && wg::bit(kb, 4 * j + 2 * hh + eb) ? scale : 0.f;
              x[eb] = rnd<bf16>(__fmul_rn(rnd<bf16>(z), m));
            } else {
              x[eb] = rnd<bf16>(fmaxf(z, 0.f));
            }
          }
          wg::stage_pair(pipe.out, rl - 64 * w, c, x[0], x[1]);
          if (dpp) rowp[hh] = fmaf(x[1], gms[col + 1], fmaf(x[0], gms[col], rowp[hh]));
        }
      wg::stage_end(pipe, &xc_map, n0, n0 + 64, r0 + 64 * w, bag);
      if (!dpp) continue;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float v = rowp[hh];
        v += __shfl_xor_sync(murcl::kFull, v, 1);  // over the 4 lanes of a row
        v += __shfl_xor_sync(murcl::kFull, v, 2);
        const int r = r0 + wg::frag_row(hh);
        if ((threadIdx.x & 3) == 0 && r < N) dpp[((size_t)(n0 / BN) * B + bag) * N + r] = v;
      }
    }
  }
  wg::stage_drain();
}

// The softmax backward over one bag per block: dp_r = sum of the trunk's
// partials (in pass order) + gp_r, c = sum_r p_r dp_r, ds_r = p_r (dp_r - c)
// on live rows, plus gs_r; dbc += sum_r ds_r.
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

// The gate passes of each 128-row tile over xc: gated, 64 columns of Wa and
// the same 64 of Wb per pass (accumulator j and j + 8 hold a and g of one
// element); ungated, 128 columns of Wa.
__device__ __forceinline__ void produce_gates(wg::Pipe& pipe, const CUtensorMap* xc_map,
                                              const CUtensorMap* wa_map,
                                              const CUtensorMap* wb_map, int gated, int B,
                                              int N, int L1, int D) {
  const int tiles = (N + BM - 1) / BM, step = gated ? 64 : BN;
  for (int t = blockIdx.x; t < tiles * B; t += gridDim.x) {
    const int bag = t / tiles, r0 = (t % tiles) * BM;
    for (int n0 = 0; n0 < D; n0 += step)
      for (int k = 0; k < L1 / BK; ++k) {
        uint64_t* bar;
        uint8_t* st = wg::produce(pipe, bar);
        wg::tma_load_3d(st, xc_map, bar, k * BK, r0, bag);
        if (gated)
          wg::load_b_mn(st + TILE_A, wa_map, n0, wb_map, n0, k * BK, bar);
        else
          wg::load_b_mn(st + TILE_A, wa_map, n0, wa_map, n0 + 64, k * BK, bar);
      }
  }
}

// The gate parameters of a block in shared memory: ba, bb and wc (bf16
// values) as f32, D each.
__device__ __forceinline__ void gate_params(float* ps, const float* __restrict__ ba,
                                            const float* __restrict__ bb,
                                            const bf16* __restrict__ wc, int gated, int D) {
  for (int c = threadIdx.x; c < D; c += wg::CONSUMERS) {
    ps[c] = ba[c];
    ps[D + c] = gated ? bb[c] : 0.f;
    ps[2 * D + c] = ld<bf16>(wc + c);
  }
}

// Forward pass 2: the raw scores s of each 128-row tile from its xc.
__global__ void __launch_bounds__(wg::THREADS, 1)
gates_fwd_wg(const __grid_constant__ CUtensorMap xc_map, const __grid_constant__ CUtensorMap wa_map,
             const __grid_constant__ CUtensorMap wb_map, const float* __restrict__ ba,
             const float* __restrict__ bb, const bf16* __restrict__ wc,
             const float* __restrict__ bc, Dropout dp, int gated, float* __restrict__ s_out,
             int stages, int B, int N, int L1, int D) {
  extern __shared__ uint8_t smem_raw[];
  wg::Pipe pipe = wg::pipe_setup(smem_raw, TILE_A + TILE_B, stages, 0, false);
  if (wg::is_producer()) {
    wg::producer_regs();
    if (threadIdx.x == wg::PRODUCER)
      produce_gates(pipe, &xc_map, &wa_map, &wb_map, gated, B, N, L1, D);
    else if (dp.on && threadIdx.x >= wg::PRODUCER + 32)
      bits_passes(pipe, dp, 1, gated, gated ? 64 : BN, D, B, N);
    return;
  }
  wg::consumer_regs();
  float* bas = reinterpret_cast<float*>(pipe.extra);  // ba, bb, wc: D each
  const float *bbs = bas + D, *wcs = bas + 2 * D;
  gate_params(bas, ba, bb, wc, gated, D);
  wg::sync_consumers();
  const int tiles = (N + BM - 1) / BM, step = gated ? 64 : BN;
  const float scale = rnd<bf16>(dp.scale);
  float acc[64];
  for (int t = blockIdx.x; t < tiles * B; t += gridDim.x) {
    const int bag = t / tiles, r0 = (t % tiles) * BM;
    float rowp[2] = {};
    for (int n0 = 0; n0 < D; n0 += step) {
      wg::mainloop<0, 1>(pipe, L1 / BK, 0, TILE_A, acc, wg::NoPre{});
      const uint2 kb = dp.on ? wg::take_bits(pipe) : make_uint2(0u, 0u);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        if (gated && j >= 8) continue;  // g: read beside a
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
          for (int eb = 0; eb < 2; ++eb) {
            const int e = 4 * j + 2 * hh + eb, col = n0 + wg::frag_col(j) + eb;
            const Gates g = gates_at(acc[e] + bas[col], gated ? acc[e + 32] + bbs[col] : 0.f,
                                     gated, dp.on, wg::bit(kb, e), wg::bit(kb, e + 32 * gated),
                                     scale);
            rowp[hh] = fmaf(g.u, wcs[col], rowp[hh]);
          }
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

// Backward pass 3: the gate backward of each 128-row tile from its xc and
// the rows' ds: dza and dzb (side by side: row stride 2 D gated, D
// ungated; staged and stored by TMA) and dwc, as gates_bwd_kernel<bf16> up
// to dx.
__global__ void __launch_bounds__(wg::THREADS, 1)
gates_bwd_wg(const __grid_constant__ CUtensorMap xc_map, const __grid_constant__ CUtensorMap wa_map,
             const __grid_constant__ CUtensorMap wb_map,
             const __grid_constant__ CUtensorMap zab_map,
             const float* __restrict__ ba, const float* __restrict__ bb,
             const bf16* __restrict__ wc, Dropout dp, int gated, const float* __restrict__ ds,
             float* __restrict__ dwc, int stages, int B, int N, int L1, int D) {
  extern __shared__ uint8_t smem_raw[];
  wg::Pipe pipe = wg::pipe_setup(smem_raw, TILE_A + TILE_B, stages, 2 * wg::OUT_TILE, false);
  if (wg::is_producer()) {
    wg::producer_regs();
    if (threadIdx.x == wg::PRODUCER)
      produce_gates(pipe, &xc_map, &wa_map, &wb_map, gated, B, N, L1, D);
    else if (dp.on && threadIdx.x >= wg::PRODUCER + 32)
      bits_passes(pipe, dp, 1, gated, gated ? 64 : BN, D, B, N);
    return;
  }
  wg::consumer_regs();
  float* bas = reinterpret_cast<float*>(pipe.extra);  // ba, bb, wc, then dwc's partial: D each
  const float *bbs = bas + D, *wcs = bas + 2 * D;
  float* Wcs = bas + 3 * D;
  const int tid = threadIdx.x, lane = tid & 31, w = wg::wg_index();
  gate_params(bas, ba, bb, wc, gated, D);
  for (int c = tid; c < D; c += wg::CONSUMERS) Wcs[c] = 0.f;
  wg::sync_consumers();
  const int tiles = (N + BM - 1) / BM, step = gated ? 64 : BN;
  const float scale = rnd<bf16>(dp.scale);
  float acc[64];
  for (int t = blockIdx.x; t < tiles * B; t += gridDim.x) {
    const int bag = t / tiles, r0 = (t % tiles) * BM;
    float ds_t[2];  // this thread's two rows; dead rows 0
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = r0 + wg::frag_row(hh);
      ds_t[hh] = r < N ? rnd<bf16>(ds[(size_t)bag * N + r]) : 0.f;
    }
    for (int n0 = 0; n0 < D; n0 += step) {
      wg::mainloop<0, 1>(pipe, L1 / BK, 0, TILE_A, acc, wg::NoPre{});
      const uint2 kb = dp.on ? wg::take_bits(pipe) : make_uint2(0u, 0u);
      wg::stage_begin();
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        if (gated && j >= 8) continue;
        const int c = wg::frag_col(j), col = n0 + c;  // the thread's columns: col, col + 1
        float wsum[2] = {};
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int rl = wg::frag_row(hh);
          float dza[2], dzb[2];
#pragma unroll
          for (int eb = 0; eb < 2; ++eb) {
            const int e = 4 * j + 2 * hh + eb, cc = col + eb;
            const Gates g = gates_at(acc[e] + bas[cc], gated ? acc[e + 32] + bbs[cc] : 0.f,
                                     gated, dp.on, wg::bit(kb, e), wg::bit(kb, e + 32 * gated),
                                     scale);
            wsum[eb] = fmaf(g.u, ds_t[hh], wsum[eb]);
            const float du = rnd<bf16>(__fmul_rn(ds_t[hh], wcs[cc]));
            float da = gated ? rnd<bf16>(__fmul_rn(du, g.g_eff)) : du;
            if (dp.on) da = rnd<bf16>(__fmul_rn(da, g.ka));
            dza[eb] = rnd<bf16>(__fmul_rn(da, rnd<bf16>(1.f - rnd<bf16>(__fmul_rn(g.a, g.a)))));
            dzb[eb] = 0.f;
            if (gated) {
              float dg = rnd<bf16>(__fmul_rn(du, g.a_eff));
              if (dp.on) dg = rnd<bf16>(__fmul_rn(dg, g.kb));
              dzb[eb] = rnd<bf16>(__fmul_rn(rnd<bf16>(__fmul_rn(dg, g.g)), rnd<bf16>(1.f - g.g)));
            }
          }
          // gated: box 0 holds dza's 64 columns, box 1 dzb's
          wg::stage_pair(pipe.out, rl - 64 * w, c, dza[0], dza[1]);
          if (gated) wg::stage_pair(pipe.out, rl - 64 * w, c + 64, dzb[0], dzb[1]);
        }
#pragma unroll
        for (int eb = 0; eb < 2; ++eb) {  // over the lanes that share a column: lane % 4 equal
          float v = wsum[eb];
          v += __shfl_xor_sync(murcl::kFull, v, 4);
          v += __shfl_xor_sync(murcl::kFull, v, 8);
          v += __shfl_xor_sync(murcl::kFull, v, 16);
          if (lane < 4) atomicAdd(&Wcs[col + eb], v);
        }
      }
      wg::stage_end(pipe, &zab_map, n0, gated ? D + n0 : n0 + 64, r0 + 64 * w, bag);
    }
  }
  wg::stage_drain();
  wg::sync_consumers();
  for (int c = tid; c < D; c += wg::CONSUMERS) atomicAdd(&dwc[c], Wcs[c]);
}

// Backward pass 4: dz = drop/relu'(bf16(p gm^T) + bf16(dza @ Wa^T) +
// bf16(dzb @ Wb^T)) for each 128-row tile, 128 columns a pass, the two
// products one after the other into two accumulators (rounded apart, as
// the twin rounds them), Wa and Wb read K-major as stored (a row of W^T is
// a column of W). relu'(z) is read as xc > 0, from the scratch, loaded
// ahead of the products.
__global__ void __launch_bounds__(wg::THREADS, 1)
dx_wg(const __grid_constant__ CUtensorMap dz_ab_map, const __grid_constant__ CUtensorMap wa_map,
      const __grid_constant__ CUtensorMap wb_map, const __grid_constant__ CUtensorMap dz_map,
      const bf16* __restrict__ xc, const float* __restrict__ p, const float* __restrict__ gm,
      Dropout dp, int gated, int stages, int B, int N, int L1, int D) {
  extern __shared__ uint8_t smem_raw[];
  wg::Pipe pipe = wg::pipe_setup(smem_raw, TILE_A + TILE_B, stages, 2 * wg::OUT_TILE, false);
  const int tiles = (N + BM - 1) / BM, nk = D / BK;
  if (wg::is_producer()) {
    wg::producer_regs();
    if (threadIdx.x == wg::PRODUCER)
      for (int t = blockIdx.x; t < tiles * B; t += gridDim.x) {
        const int bag = t / tiles, r0 = (t % tiles) * BM;
        for (int n0 = 0; n0 < L1; n0 += BN)
          for (int g = 0; g < (gated ? 2 : 1); ++g)
            for (int k = 0; k < nk; ++k) {
              uint64_t* bar;
              uint8_t* st = wg::produce(pipe, bar);
              wg::tma_load_3d(st, &dz_ab_map, bar, g * D + k * BK, r0, bag);
              wg::tma_load_2d(st + TILE_A, g ? &wb_map : &wa_map, bar, k * BK, n0);
            }
      }
    else if (dp.on && threadIdx.x >= wg::PRODUCER + 32)
      bits_passes(pipe, dp, 0, false, BN, L1, B, N);
    return;
  }
  wg::consumer_regs();
  const int w = wg::wg_index();
  float* gms = reinterpret_cast<float*>(pipe.extra) + w * L1;  // L1 per warpgroup: gm of its bag
  const float scale = rnd<bf16>(dp.scale);
  float acc_a[64], acc_b[64];
  for (int t = blockIdx.x; t < tiles * B; t += gridDim.x) {
    const int bag = t / tiles, r0 = (t % tiles) * BM;
    wg::sync_wg();
    to_shared(gms, gm + (size_t)bag * L1, L1, false, threadIdx.x & 127, 128);
    wg::sync_wg();
    float pr[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = r0 + wg::frag_row(hh);
      pr[hh] = r < N ? p[(size_t)bag * N + r] : 0.f;
    }
    for (int n0 = 0; n0 < L1; n0 += BN) {
      // this thread's xc pairs, loaded ahead of the products they wait for
      uint32_t xv[2][16];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = r0 + wg::frag_row(hh);
#pragma unroll
        for (int j = 0; j < 16; ++j)
          xv[hh][j] = r < N ? __ldg(reinterpret_cast<const unsigned int*>(
                                  xc + ((size_t)bag * N + r) * L1 + n0 + wg::frag_col(j)))
                            : 0u;
      }
      wg::mainloop<0, 0>(pipe, nk, 0, TILE_A, acc_a, wg::NoPre{});
      if (gated) wg::mainloop<0, 0>(pipe, nk, 0, TILE_A, acc_b, wg::NoPre{});
      const uint2 kb = dp.on ? wg::take_bits(pipe) : make_uint2(0u, 0u);
      wg::stage_begin();
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int rl = wg::frag_row(hh);
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int c = wg::frag_col(j), col = n0 + c;
          const __nv_bfloat162 x2 = *reinterpret_cast<const __nv_bfloat162*>(&xv[hh][j]);
          float out[2];
#pragma unroll
          for (int eb = 0; eb < 2; ++eb) {
            const int e = 4 * j + 2 * hh + eb;
            float dx = rnd<bf16>(
                __fadd_rn(rnd<bf16>(__fmul_rn(pr[hh], gms[col + eb])), rnd<bf16>(acc_a[e])));
            if (gated) dx = rnd<bf16>(__fadd_rn(dx, rnd<bf16>(acc_b[e])));
            const float x = eb ? __high2float(x2) : __low2float(x2);
            float mk;
            if (dp.on)
              mk = x > 0.f && wg::bit(kb, e) ? scale : 0.f;
            else
              mk = x > 0.f ? 1.f : 0.f;
            out[eb] = rnd<bf16>(__fmul_rn(dx, mk));  // dead rows: xc = 0, so dz = 0
          }
          wg::stage_pair(pipe.out, rl - 64 * w, c, out[0], out[1]);
        }
      }
      wg::stage_end(pipe, &dz_map, n0, n0 + 64, r0 + 64 * w, bag);
    }
  }
  wg::stage_drain();
}

// The bags' gradient dh = dz @ Wf^T for each 128-row tile, 128 columns of
// Fin a pass, rounded to bf16 once (staged, stored by TMA); Wf read K-major
// as stored.
__global__ void __launch_bounds__(wg::THREADS, 1)
dh_wg(const __grid_constant__ CUtensorMap dz_map, const __grid_constant__ CUtensorMap wf_map,
      const __grid_constant__ CUtensorMap dh_map, int stages, int B, int N, int Fin, int L1) {
  extern __shared__ uint8_t smem_raw[];
  wg::Pipe pipe = wg::pipe_setup(smem_raw, TILE_A + TILE_B, stages, 2 * wg::OUT_TILE, false);
  const int tiles = (N + BM - 1) / BM, nk = L1 / BK;
  if (wg::is_producer()) {
    wg::producer_regs();
    if (threadIdx.x == wg::PRODUCER)
      for (int t = blockIdx.x; t < tiles * B; t += gridDim.x) {
        const int bag = t / tiles, r0 = (t % tiles) * BM;
        for (int n0 = 0; n0 < Fin; n0 += BN)
          for (int k = 0; k < nk; ++k) {
            uint64_t* bar;
            uint8_t* st = wg::produce(pipe, bar);
            wg::tma_load_3d(st, &dz_map, bar, k * BK, r0, bag);
            wg::tma_load_2d(st + TILE_A, &wf_map, bar, k * BK, n0);
          }
      }
    return;
  }
  wg::consumer_regs();
  const int w = wg::wg_index();
  float acc[64];
  for (int t = blockIdx.x; t < tiles * B; t += gridDim.x) {
    const int bag = t / tiles, r0 = (t % tiles) * BM;
    for (int n0 = 0; n0 < Fin; n0 += BN) {
      wg::mainloop<0, 0>(pipe, nk, 0, TILE_A, acc, wg::NoPre{});
      wg::stage_begin();
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int j = 0; j < 16; ++j)
          wg::stage_pair(pipe.out, wg::frag_row(hh) - 64 * w, wg::frag_col(j),
                         acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
      wg::stage_end(pipe, &dh_map, n0, n0 + 64, r0 + 64 * w, bag);
    }
  }
  wg::stage_drain();
}

// Weight gradients: dW[M x Nc] += X^T @ Y over this block's split of the R
// rows (X (R, M), Y (R, Nc) bf16 row-major, both read MN-major as stored),
// on 128 x 128 output tiles; the columns of Y below `split` go to out0, the
// rest to out1 (row stride ldo). Blocks of the first M tile also add Y's
// column sums into db0 / db1 (db0 null: none).
__global__ void __launch_bounds__(wg::THREADS, 1)
wgrad_wg(const __grid_constant__ CUtensorMap x_map, const __grid_constant__ CUtensorMap y_map,
         float* __restrict__ out0, float* __restrict__ out1, int split, int ldo,
         float* __restrict__ db0, float* __restrict__ db1, long long R, long long per, int M,
         int stages) {
  extern __shared__ uint8_t smem_raw[];
  wg::Pipe pipe = wg::pipe_setup(smem_raw, TILE_A + TILE_B, stages, 0, false);
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const long long rbeg = blockIdx.z * per, rend = min(R, rbeg + per);
  const int nk = (int)((rend - rbeg + BK - 1) / BK);
  if (wg::is_producer()) {
    wg::producer_regs();
    if (threadIdx.x == wg::PRODUCER)
      for (int k = 0; k < nk; ++k) {
        uint64_t* bar;
        uint8_t* st = wg::produce(pipe, bar);
        const int r = (int)(rbeg + (long long)k * BK);
        wg::load_b_mn(st, &x_map, m0, &x_map, m0 + 64, r, bar);
        wg::load_b_mn(st + TILE_A, &y_map, n0, &y_map, n0 + 64, r, bar);
      }
    return;
  }
  wg::consumer_regs();
  const int tid = threadIdx.x;
  const bool sums = db0 != nullptr && blockIdx.y == 0 && tid < BN;
  float colsum = 0.f;
  float acc[64];
  wg::mainloop<1, 1>(pipe, nk, 0, TILE_A, acc, [&](int, uint8_t* st) {
    if (!sums) return;
    const uint8_t* y = st + TILE_A + (tid >> 6) * wg::BOX;
    const int cc = tid & 63;
    for (int rr = 0; rr < BK; ++rr)
      colsum += __bfloat162float(
          *reinterpret_cast<const bf16*>(wg::chunk_at(y, rr, cc >> 3) + ((cc & 7) << 1)));
  });
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int mr = m0 + wg::frag_row(hh);
    if (mr >= M) continue;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int eb = 0; eb < 2; ++eb) {
        const int c = n0 + wg::frag_col(j) + eb;
        float* o = c < split ? out0 + (size_t)mr * ldo + c : out1 + (size_t)mr * ldo + c - split;
        atomicAdd(o, acc[4 * j + 2 * hh + eb]);
      }
  }
  if (sums) {
    const int c = n0 + tid;
    atomicAdd(c < split ? db0 + c : db1 + c - split, colsum);
  }
}

// dW += X^T @ Y over all R rows, split over rows so that about two blocks
// per SM are in flight (one fits an SM at a time); M % 64 == 0, Nc % 128 ==
// 0.
int wgrad_wg_launch(const void* X, int M, const void* Y, int Nc, long long R, float* out0,
                    float* out1, int split, int ldo, float* db0, float* db1,
                    cudaStream_t stream) {
  CUtensorMap xm, ym;
  MURCL_TRY((cudaError_t)wg::map2(&xm, X, M, R, BK));
  MURCL_TRY((cudaError_t)wg::map2(&ym, Y, Nc, R, BK));
  const int tiles = (Nc / BN) * ((M + BM - 1) / BM);
  long long splits = max(1, 2 * sm_count() / tiles);
  splits = min(splits, (R + BK - 1) / BK);
  long long per = (R + splits - 1) / splits;
  per = (per + BK - 1) / BK * BK;
  const Plan pl = plan(TILE_A + TILE_B, false, 0);
  MURCL_TRY(allow_smem(wgrad_wg, pl.smem));
  const dim3 grid(Nc / BN, (M + BM - 1) / BM, (unsigned)((R + per - 1) / per));
  wgrad_wg<<<grid, wg::THREADS, pl.smem, stream>>>(xm, ym, out0, out1, split, ldo, db0, db1, R,
                                                   per, M, pl.stages);
  return (int)cudaGetLastError();
}

// hm: the mixed bag's scratch (null unmixed).
int fwd_wg(const void* h, const void* perm, const void* lam, const void* wf, const void* bf,
           const void* wa, const void* ba, const void* wb, const void* bb, const void* wc,
           const void* bc, const void* mask, Dropout dp, int gated, void* xc, void* hm, void* m,
           void* p, void* s, int B, int N, int Fin, int L1, int D, cudaStream_t stream) {
  const unsigned grid = persistent_grid((long long)((N + BM - 1) / BM) * B);
  const bool mixed = perm != nullptr;
  CUtensorMap hmap, wfm, hml, hst, xm, xst, wam, wbm;
  MURCL_TRY((cudaError_t)wg::map3(&hmap, h, Fin, N, B, BM));
  MURCL_TRY((cudaError_t)wg::map3(&hml, mixed ? hm : h, Fin, N, B, BM));
  MURCL_TRY((cudaError_t)wg::map3(&hst, mixed ? hm : h, Fin, N, B, 64));
  MURCL_TRY((cudaError_t)wg::map2(&wfm, wf, L1, Fin, BK));
  MURCL_TRY((cudaError_t)wg::map3(&xm, xc, L1, N, B, BM));
  MURCL_TRY((cudaError_t)wg::map3(&xst, xc, L1, N, B, 64));
  MURCL_TRY((cudaError_t)wg::map2(&wam, wa, D, L1, BK));
  MURCL_TRY((cudaError_t)wg::map2(&wbm, wb, D, L1, BK));
  const Plan p1 = plan(TILE_A * (mixed ? 2 : 1) + TILE_B, true, sizeof(float) * 3 * L1);
  MURCL_TRY(allow_smem(trunk_wg, p1.smem));
  trunk_wg<<<grid, wg::THREADS, p1.smem, stream>>>(
      hmap, wfm, hml, hst, xst, (const int64_t*)perm, (const float*)lam, (const float*)bf, dp,
      nullptr, nullptr, p1.stages, B, N, Fin, L1);
  MURCL_TRY(cudaGetLastError());
  const Plan p2 = plan(TILE_A + TILE_B, false, sizeof(float) * 3 * D);
  MURCL_TRY(allow_smem(gates_fwd_wg, p2.smem));
  gates_fwd_wg<<<grid, wg::THREADS, p2.smem, stream>>>(
      xm, wam, wbm, (const float*)ba, (const float*)bb, (const bf16*)wc, (const float*)bc, dp,
      gated, (float*)s, p2.stages, B, N, L1, D);
  MURCL_TRY(cudaGetLastError());
  return pool<bf16>((const float*)s, (const uint8_t*)mask, (const bf16*)xc, (float*)m, (float*)p,
                    B, N, L1, stream);
}

// dzab: (B, N, 2 D) gated ([dza | dzb] per row), (B, N, D) ungated; hm the
// mixed bag's scratch (null unmixed: dWf then reads h itself); dpp
// (L1 / 128, B, N) and ds (B, N) f32 scratch.
int bwd_wg(const void* h, const void* perm, const void* lam, const void* wf, const void* bf,
           const void* wa, const void* ba, const void* wb, const void* bb, const void* wc,
           const void* mask, Dropout dp, int gated, const void* p, const void* gm,
           const void* gp, const void* gs, void* hm, void* xc, void* dpp, void* ds, void* dzab,
           void* dz, void* dh, void* dwf, void* dbf, void* dwa, void* dba, void* dwb, void* dbb,
           void* dwc, void* dbc, int B, int N, int Fin, int L1, int D, cudaStream_t stream) {
  const unsigned grid = persistent_grid((long long)((N + BM - 1) / BM) * B);
  const int ldz = gated ? 2 * D : D;
  const bool mixed = perm != nullptr;
  CUtensorMap hmap, wfm, hml, hst, xm, xst, wam, wbm, zabm, zabst, wak, wbk, zst;
  MURCL_TRY((cudaError_t)wg::map3(&hmap, h, Fin, N, B, BM));
  MURCL_TRY((cudaError_t)wg::map2(&wfm, wf, L1, Fin, BK));
  MURCL_TRY((cudaError_t)wg::map3(&hml, mixed ? hm : h, Fin, N, B, BM));
  MURCL_TRY((cudaError_t)wg::map3(&hst, mixed ? hm : h, Fin, N, B, 64));
  MURCL_TRY((cudaError_t)wg::map3(&xm, xc, L1, N, B, BM));
  MURCL_TRY((cudaError_t)wg::map3(&xst, xc, L1, N, B, 64));
  MURCL_TRY((cudaError_t)wg::map2(&wam, wa, D, L1, BK));
  MURCL_TRY((cudaError_t)wg::map2(&wbm, wb, D, L1, BK));
  MURCL_TRY((cudaError_t)wg::map3(&zabm, dzab, ldz, N, B, BM));
  MURCL_TRY((cudaError_t)wg::map3(&zabst, dzab, ldz, N, B, 64));
  MURCL_TRY((cudaError_t)wg::map2(&wak, wa, D, L1, BN));
  MURCL_TRY((cudaError_t)wg::map2(&wbk, wb, D, L1, BN));
  MURCL_TRY((cudaError_t)wg::map3(&zst, dz, L1, N, B, 64));

  const Plan p1 = plan(TILE_A * (mixed ? 2 : 1) + TILE_B, true, sizeof(float) * 3 * L1);
  MURCL_TRY(allow_smem(trunk_wg, p1.smem));
  trunk_wg<<<grid, wg::THREADS, p1.smem, stream>>>(
      hmap, wfm, hml, hst, xst, (const int64_t*)perm, (const float*)lam, (const float*)bf, dp,
      (const float*)gm, (float*)dpp, p1.stages, B, N, Fin, L1);
  MURCL_TRY(cudaGetLastError());

  softmax_bwd_kernel<<<B, THREADS, 0, stream>>>((const float*)dpp, L1 / BN, (const float*)p,
                                                (const float*)gp, (const float*)gs,
                                                (const uint8_t*)mask, (float*)ds, (float*)dbc,
                                                B, N);
  MURCL_TRY(cudaGetLastError());

  const Plan p2 = plan(TILE_A + TILE_B, true, sizeof(float) * 4 * D);
  MURCL_TRY(allow_smem(gates_bwd_wg, p2.smem));
  gates_bwd_wg<<<grid, wg::THREADS, p2.smem, stream>>>(
      xm, wam, wbm, zabst, (const float*)ba, (const float*)bb, (const bf16*)wc, dp, gated,
      (const float*)ds, (float*)dwc, p2.stages, B, N, L1, D);
  MURCL_TRY(cudaGetLastError());

  const Plan p3 = plan(TILE_A + TILE_B, true, sizeof(float) * 2 * L1);
  MURCL_TRY(allow_smem(dx_wg, p3.smem));
  dx_wg<<<grid, wg::THREADS, p3.smem, stream>>>(zabm, wak, wbk, zst, (const bf16*)xc,
                                                (const float*)p, (const float*)gm, dp, gated,
                                                p3.stages, B, N, L1, D);
  MURCL_TRY(cudaGetLastError());

  if (dh) {
    CUtensorMap zm, wfk, dhst;
    MURCL_TRY((cudaError_t)wg::map3(&zm, dz, L1, N, B, BM));
    MURCL_TRY((cudaError_t)wg::map2(&wfk, wf, L1, Fin, BN));
    MURCL_TRY((cudaError_t)wg::map3(&dhst, dh, Fin, N, B, 64));
    const Plan p4 = plan(TILE_A + TILE_B, true, 0);
    MURCL_TRY(allow_smem(dh_wg, p4.smem));
    dh_wg<<<grid, wg::THREADS, p4.smem, stream>>>(zm, wfk, dhst, p4.stages, B, N, Fin, L1);
    MURCL_TRY(cudaGetLastError());
  }

  const long long R = (long long)B * N;
  int err = wgrad_wg_launch(mixed ? hm : h, Fin, dz, L1, R, (float*)dwf, nullptr, L1, L1,
                            (float*)dbf, nullptr, stream);
  if (err) return err;
  return wgrad_wg_launch(xc, L1, dzab, ldz, R, (float*)dwa, (float*)dwb, D, D, (float*)dba,
                         (float*)dbb, stream);
}

// The backward's outputs are sums: zero them before any pass adds to them.
int zero_grads(void* dwf, void* dbf, void* dwa, void* dba, void* dwb, void* dbb, void* dwc,
               void* dbc, int Fin, int L1, int D, cudaStream_t stream) {
  MURCL_TRY(cudaMemsetAsync(dwf, 0, sizeof(float) * Fin * L1, stream));
  MURCL_TRY(cudaMemsetAsync(dbf, 0, sizeof(float) * L1, stream));
  MURCL_TRY(cudaMemsetAsync(dwa, 0, sizeof(float) * L1 * D, stream));
  MURCL_TRY(cudaMemsetAsync(dba, 0, sizeof(float) * D, stream));
  MURCL_TRY(cudaMemsetAsync(dwb, 0, sizeof(float) * L1 * D, stream));
  MURCL_TRY(cudaMemsetAsync(dbb, 0, sizeof(float) * D, stream));
  MURCL_TRY(cudaMemsetAsync(dwc, 0, sizeof(float) * D, stream));
  MURCL_TRY(cudaMemsetAsync(dbc, 0, sizeof(float), stream));
  return 0;
}

template <typename T>
int fwd_impl(const void* h, const void* perm, const void* lam, const void* wf, const void* bf,
             const void* wa, const void* ba, const void* wb, const void* bb, const void* wc,
             const void* bc, const void* mask, Dropout dp, int gated, void* xc, void* m,
             void* p, void* s, int B, int N, int Fin, int L1, int D, cudaStream_t stream) {
  const size_t smem1 = trunk_smem(Fin, L1);
  MURCL_TRY(allow_smem(trunk_fwd_kernel<T>, smem1));
  const dim3 tiles((N + TM - 1) / TM, B);
  trunk_fwd_kernel<T><<<tiles, THREADS, smem1, stream>>>(
      (const T*)h, (const int64_t*)perm, (const float*)lam, (const T*)wf, (const float*)bf,
      (const T*)wa, (const float*)ba, (const T*)wb, (const float*)bb, (const T*)wc,
      (const float*)bc, dp, gated, (T*)xc, (float*)s, N, Fin, L1, D);
  MURCL_TRY(cudaGetLastError());
  return pool<T>((const float*)s, (const uint8_t*)mask, (const T*)xc, (float*)m, (float*)p, B, N,
                 L1, stream);
}

template <typename T>
int bwd_impl(const void* h, const void* perm, const void* lam, const void* wf, const void* bf,
             const void* wa, const void* ba, const void* wb, const void* bb, const void* wc,
             const void* waT, const void* wbT, const void* wfT, const void* mask, Dropout dp,
             int gated, const void* p, const void* gm, const void* gp, const void* gs, void* hm,
             void* xc, void* dpv, void* dza, void* dzb, void* dz, void* dh, void* dwf, void* dbf,
             void* dwa, void* dba, void* dwb, void* dbb, void* dwc, void* dbc, int B, int N,
             int Fin, int L1, int D, cudaStream_t stream) {
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
      (const T*)wc, (const T*)waT, (const T*)wbT, (const T*)wfT, (const uint8_t*)mask, dp,
      gated, (const float*)p, (const float*)gm, (const float*)gs, (const float*)dpv, (T*)dza,
      (T*)dzb, (T*)dz, (T*)dh, (float*)dwc, (float*)dbc, N, Fin, L1, D);
  MURCL_TRY(cudaGetLastError());

  const long long R = (long long)B * N;
  int err = wgrad<T>(hm, Fin, dz, L1, R, (float*)dwf, (float*)dbf, stream);
  if (err) return err;
  err = wgrad<T>(xc, L1, dza, D, R, (float*)dwa, (float*)dba, stream);
  if (err || !gated) return err;
  return wgrad<T>(xc, L1, dzb, D, R, (float*)dwb, (float*)dbb, stream);
}

}  // namespace

// hm: bf16, the mixed bag's (B, N, Fin) scratch when mixed, else null; f32
// leaves it unread.
MURCL_API int murcl_fused_trunk_fwd(int is_bf16, int gated, const void* h, const void* perm,
                                    const void* lam, const void* wf, const void* bf,
                                    const void* wa, const void* ba, const void* wb,
                                    const void* bb, const void* wc, const void* bc,
                                    const void* mask, int use_dropout, uint32_t seed,
                                    uint32_t thresh, float scale, void* xc, void* hm, void* m,
                                    void* p, void* s, int B, int N, int Fin, int L1, int D,
                                    void* stream) {
  const Dropout dp{use_dropout, seed, thresh, scale};
  auto strm = (cudaStream_t)stream;
  if (is_bf16)
    return fwd_wg(h, perm, lam, wf, bf, wa, ba, wb, bb, wc, bc, mask, dp, gated, xc, hm, m, p, s,
                  B, N, Fin, L1, D, strm);
  return fwd_impl<float>(h, perm, lam, wf, bf, wa, ba, wb, bb, wc, bc, mask, dp, gated, xc, m, p,
                         s, B, N, Fin, L1, D, strm);
}

// f32: waT, wbT (and, with dh, wfT) are the weights transposed, dpv (B, N)
// f32, dza, dzb (null when ungated) and hm scratch. bf16: dpv is the
// (L1 / 128 + 1, B, N) f32 scratch of dp partials and ds, dza the
// [dza | dzb] scratch (see bwd_wg), hm the mixed bag (null unmixed), and
// waT, wbT, wfT and dzb unread. dh null unless the bags' gradient is wanted.
MURCL_API int murcl_fused_trunk_bwd(
    int is_bf16, int gated, const void* h, const void* perm, const void* lam, const void* wf,
    const void* bf, const void* wa, const void* ba, const void* wb, const void* bb,
    const void* wc, const void* waT, const void* wbT, const void* wfT, const void* mask,
    int use_dropout, uint32_t seed, uint32_t thresh, float scale, const void* p, const void* gm,
    const void* gp, const void* gs, void* hm, void* xc, void* dpv, void* dza, void* dzb,
    void* dz, void* dh, void* dwf, void* dbf, void* dwa, void* dba, void* dwb, void* dbb,
    void* dwc, void* dbc, int B, int N, int Fin, int L1, int D, void* stream) {
  const Dropout dp{use_dropout, seed, thresh, scale};
  auto strm = (cudaStream_t)stream;
  const int err = zero_grads(dwf, dbf, dwa, dba, dwb, dbb, dwc, dbc, Fin, L1, D, strm);
  if (err) return err;
  if (is_bf16) {
    float* ds = (float*)dpv + (size_t)(L1 / BN) * B * N;
    return bwd_wg(h, perm, lam, wf, bf, wa, ba, wb, bb, wc, mask, dp, gated, p, gm, gp, gs, hm,
                  xc, dpv, ds, dza, dz, dh, dwf, dbf, dwa, dba, dwb, dbb, dwc, dbc, B, N, Fin, L1,
                  D, strm);
  }
  return bwd_impl<float>(h, perm, lam, wf, bf, wa, ba, wb, bb, wc, waT, wbT, wfT, mask, dp,
                         gated, p, gm, gp, gs, hm, xc, dpv, dza, dzb, dz, dh, dwf, dbf, dwa, dba,
                         dwb, dbb, dwc, dbc, B, N, Fin, L1, D, strm);
}
