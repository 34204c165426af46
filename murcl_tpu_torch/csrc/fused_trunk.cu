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
// Bound on the H100: FLOPs. The main path's call (1536 bags x 1024 rows,
// 512 -> 512 -> 256) is about 1.6 TFLOP forward and 4.1 TFLOP backward.
// A bag (1 MiB in bf16) does not fit a block's 227 KB of shared memory, so
// the TPU's whole-bag-in-VMEM design is replaced by row tiles and scratch in
// device memory: the forward writes xc and the raw scores s, and
// pool_kernel (tiles.cuh) then takes the softmax over the whole bag and
// pools M = bf16(p) @ xc, the price of a simple exact softmax being one
// extra round trip of B x N x L1 elements; the backward recomputes the mix
// and the trunk (writing the mixed bag hm, xc and dp = xc @ gm + gp), sums
// p * dp over the bag (the cross-tile sum the softmax backward needs),
// recomputes the gates, writes dza, dzb and dz (and, with need_dh,
// dh = dz @ Wf^T: one more (N, L1) x (L1, Fin) product per bag), and
// contracts the scratches into dWf, dWa, dWb (and the bias sums) as a
// split-K sum over all B x N rows, adding the splits with f32 atomics.
// Two instantiations:
//  * bf16 (the training path), on the tensor cores (mma_tiles.cuh:
//    mma.sync m16n8k16 fed by ldmatrix, B through a cp.async ring) over
//    64-row tiles whose A operand sits in shared memory as bf16. The tensor
//    cores multiply exactly the bf16 values the FMA tiles multiplied (the
//    mixed bag, xc, dza, dzb and dz are rounded before they are stored), so
//    results differ from the FMA version's only in summation order. Five
//    kernels each hold one large tile, so that two blocks share an SM at the
//    main widths: trunk_tc (forward and backward), gates_fwd_tc,
//    gates_bwd_tc (the gates in one pass over [Wa | Wb] per 64 columns),
//    dx_tc (dza @ Wa^T and dzb @ Wb^T in one pass of two accumulators,
//    rounded apart as the twin rounds them) and tc::wgrad (X^T @ Y).
//  * f32 (the tests and the heatmap's bags up to 3,072 padded patches): the
//    FP32 FMA tiles of tiles.cuh, 32 rows per block, in trunk_fwd_kernel,
//    trunk_bwd_kernel, gates_bwd_kernel and wgrad_kernel. TF32 would round
//    beyond the f32 tolerance of 1e-4.
// The gated flag is a runtime argument, uniform over the launch: ungated
// blocks skip the Wb products, dzb and dWb. Gate a keeps dropout stream 1 in
// both modes.
// Dropout keep bits come from a counter hash keyed by (seed, bag, stream,
// row, col) (common.cuh), so the backward regenerates the forward's masks.
#include "mma_tiles.cuh"
#include "tiles.cuh"

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
// bf16 on the tensor cores: five kernels over 64-row tiles, each holding one
// large bf16 tile in shared memory, so that two blocks share an SM at the
// main widths and one block's loads and epilogues overlap the other's
// products:
//   forward:  trunk_tc (mix and trunk; xc to scratch), gates_fwd_tc (the
//             scores s, from xc), then pool_kernel;
//   backward: trunk_tc (again; also hm and dp), gates_bwd_tc (dza, dzb, dwc,
//             dbc, from xc), dx_tc (dz and, with dh_out, dh, from dza and
//             dzb), then the weight gradients (tc::wgrad).
// ops/attention.py (trunk_tile_smem) reckons the same shared-memory sums.
// ---------------------------------------------------------------------------
using tc::BM;
using tc::bf16;
using tc::gate_col;
using tc::PAD;
using tc::ring_end;
using tc::row_partials;
using tc::st2;

size_t tc_trunk_smem(int Fin) {
  return sizeof(bf16) * BM * (Fin + PAD) + tc::RING_BYTES + sizeof(float) * BM * 4;
}
size_t tc_gates_smem(int L1, int D) {
  return sizeof(bf16) * BM * (L1 + PAD) + tc::RING_BYTES + sizeof(float) * (BM * 4 + D + 32);
}
size_t tc_dx_smem(int L1, int D, bool dh) {
  return sizeof(bf16) * (2 * BM * (D + PAD) + (dh ? BM * (L1 + PAD) : 0)) + tc::RING_BYTES +
         sizeof(float) * BM;
}

// Hs = the mixed bag rows r0.. (zeros past N), bf16, row stride Fin + PAD;
// the mix rounds as load_mixed_tile<bf16> does. With hm_out, the rows below
// N are also stored there.
__device__ void tc_load_mixed(const bf16* __restrict__ h, const int64_t* __restrict__ perm,
                              const float* __restrict__ lam, int bag, int r0, int N, int Fin,
                              bf16* Hs, bf16* __restrict__ hm_out) {
  const bf16* self = h + (size_t)bag * N * Fin;
  const bf16* partner = perm ? h + (size_t)perm[bag] * N * Fin : nullptr;
  float lam_t = 0.f, oml_t = 0.f;
  if (perm) {
    lam_t = rnd<bf16>(lam[bag]);
    oml_t = rnd<bf16>(1.f - lam[bag]);
  }
  const int cpr = Fin / 8;  // 16-byte chunks per row
  for (int e = threadIdx.x; e < BM * cpr; e += tc::THREADS) {
    const int r = e / cpr, c = (e % cpr) * 8, row = r0 + r;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (row < N) {
      v = *reinterpret_cast<const uint4*>(self + (size_t)row * Fin + c);
      if (perm) {
        const uint4 w = *reinterpret_cast<const uint4*>(partner + (size_t)row * Fin + c);
        bf16* pv = reinterpret_cast<bf16*>(&v);
        const bf16* pw = reinterpret_cast<const bf16*>(&w);
#pragma unroll
        for (int i = 0; i < 8; ++i)
          pv[i] = st<bf16>(__fadd_rn(rnd<bf16>(__fmul_rn(lam_t, __bfloat162float(pv[i]))),
                                     rnd<bf16>(__fmul_rn(oml_t, __bfloat162float(pw[i])))));
      }
      if (hm_out)
        *reinterpret_cast<uint4*>(hm_out + ((size_t)bag * N + row) * Fin + c) = v;
    }
    *reinterpret_cast<uint4*>(Hs + r * (Fin + PAD) + c) = v;
  }
}

// Mix and trunk of one 64-row tile: xc = drop(relu(Hs @ Wf + bf)) to the
// scratch; in the backward (hm_out set) also the mixed rows and
// dp = xc @ bf16(gm) + gp.
__global__ void __launch_bounds__(tc::THREADS, 2)
trunk_tc(const bf16* __restrict__ h, const int64_t* __restrict__ perm,
         const float* __restrict__ lam, const bf16* __restrict__ wf,
         const float* __restrict__ bf, Dropout dp, const float* __restrict__ gm,
         const float* __restrict__ gp, bf16* __restrict__ xc_out, bf16* __restrict__ hm_out,
         float* __restrict__ dp_out, int N, int Fin, int L1) {
  extern __shared__ uint4 tc_smem[];
  bf16* Hs = reinterpret_cast<bf16*>(tc_smem);
  tc::Ring ring{Hs + BM * (Fin + PAD), 0, true};
  float* red = reinterpret_cast<float*>(ring_end(ring));  // BM x 4
  const int bag = blockIdx.y, r0 = blockIdx.x * BM, wm = tc::warp_m(), wn = tc::warp_n();

  tc::BSrc b{wf, nullptr, L1, 0};
  tc::load_b(b, 0, ring.buf);  // Wf's first slice streams in while the tile is mixed
  tc::cp_commit();
  tc_load_mixed(h, perm, lam, bag, r0, N, Fin, Hs, hm_out);

  const uint32_t key = murcl::bag_key(dp.seed, bag, 0);
  const float* g = dp_out ? gm + (size_t)bag * L1 : nullptr;
  float rowp[2][2] = {};
  tc::Acc acc;
  for (int n0 = 0; n0 < L1; n0 += tc::BN) {
    b.n0 = n0;
    const tc::BSrc next{n0 + tc::BN < L1 ? wf : nullptr, nullptr, L1, n0 + tc::BN};
    tc::mma_pass(Hs, nullptr, Fin + PAD, Fin, b, next, ring, acc);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = wm * 32 + tc::frag_row(mi, 2 * hh);
          const int col = n0 + wn * 32 + tc::frag_col(j, 0);
          float x[2];
#pragma unroll
          for (int eb = 0; eb < 2; ++eb) {
            const float z = acc[mi][j][2 * hh + eb] + bf[col + eb];
            if (dp.on) {
              const float m =
                  z > 0.f ? keep_scale<bf16>(dp, key, (uint32_t)(r0 + r) * L1 + col + eb) : 0.f;
              x[eb] = rnd<bf16>(__fmul_rn(rnd<bf16>(z), m));
            } else {
              x[eb] = rnd<bf16>(fmaxf(z, 0.f));
            }
          }
          if (r0 + r < N) st2(xc_out + ((size_t)bag * N + r0 + r) * L1 + col, x[0], x[1]);
          if (g)
            rowp[mi][hh] = fmaf(x[1], rnd<bf16>(g[col + 1]),
                                fmaf(x[0], rnd<bf16>(g[col]), rowp[mi][hh]));
        }
  }
  if (!dp_out) return;
  row_partials(rowp, red);
  __syncthreads();
  const int r = threadIdx.x, row = r0 + r;
  if (r < BM && row < N)
    dp_out[(size_t)bag * N + row] = red[r * 4] + red[r * 4 + 1] + red[r * 4 + 2] +
                                    red[r * 4 + 3] + gp[(size_t)bag * N + row];
}

// The gates at one element, rounded to bf16 where gates_bwd_kernel<bf16>
// rounds them: a = tanh(za), g = sigmoid(zb) (gated only), their keep
// scales ka, kb, the kept a_eff, g_eff and u = a_eff * g_eff (or a_eff).
struct Gates {
  float a, ka, a_eff, g, kb, g_eff, u;
};
__device__ __forceinline__ Gates gates_at(float za, float zb, int gated, const Dropout& dp,
                                          uint32_t key_a, uint32_t key_b, uint32_t idx) {
  Gates t{rnd<bf16>(tanhf(za)), 1.f, 0.f, 0.f, 1.f, 0.f, 0.f};
  t.a_eff = t.a;
  if (dp.on) {
    t.ka = keep_scale<bf16>(dp, key_a, idx);
    t.a_eff = rnd<bf16>(__fmul_rn(t.a, t.ka));
  }
  t.u = t.a_eff;
  if (gated) {
    t.g = t.g_eff = rnd<bf16>(sigmoidf(zb));
    if (dp.on) {
      t.kb = keep_scale<bf16>(dp, key_b, idx);
      t.g_eff = rnd<bf16>(__fmul_rn(t.g, t.kb));
    }
    t.u = rnd<bf16>(__fmul_rn(t.a_eff, t.g_eff));
  }
  return t;
}

// Forward pass 2: the raw scores s of one 64-row tile from its xc.
__global__ void __launch_bounds__(tc::THREADS, 2)
gates_fwd_tc(const bf16* __restrict__ xc, const bf16* __restrict__ wa,
             const float* __restrict__ ba, const bf16* __restrict__ wb,
             const float* __restrict__ bb, const bf16* __restrict__ wc,
             const float* __restrict__ bc, Dropout dp, int gated, float* __restrict__ s_out,
             int N, int L1, int D) {
  extern __shared__ uint4 tc_smem[];
  bf16* Xs = reinterpret_cast<bf16*>(tc_smem);
  const int bag = blockIdx.y, r0 = blockIdx.x * BM, wm = tc::warp_m();
  tc::BSrc b{wa, gated ? wb : nullptr, D, 0};
  tc::Ring ring = tc::tile_start(xc, bag, r0, N, L1, b, Xs);
  float* red = reinterpret_cast<float*>(ring_end(ring));  // BM x 4

  const uint32_t key_a = murcl::bag_key(dp.seed, bag, 1), key_b = murcl::bag_key(dp.seed, bag, 2);
  float rowp[2][2] = {};
  tc::Acc acc;
  const int step = gated ? tc::BN / 2 : tc::BN;
  for (int n0 = 0; n0 < D; n0 += step) {
    b.n0 = n0;
    const tc::BSrc next{n0 + step < D ? wa : nullptr, gated ? wb : nullptr, D, n0 + step};
    tc::mma_pass(Xs, nullptr, L1 + PAD, L1, b, next, ring, acc);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (gated && j >= 2) continue;  // g: read beside a
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t row = r0 + wm * 32 + tc::frag_row(mi, e);
          const int col = gate_col(gated, n0, j, e);
          const Gates t = gates_at(acc[mi][j][e] + ba[col],
                                   gated ? acc[mi][(j + 2) & 3][e] + bb[col] : 0.f, gated, dp,
                                   key_a, key_b, row * D + col);
          rowp[mi][e >> 1] = fmaf(t.u, ld<bf16>(wc + col), rowp[mi][e >> 1]);
        }
      }
  }
  row_partials(rowp, red);
  __syncthreads();
  const int r = threadIdx.x;
  if (r < BM && r0 + r < N)
    s_out[(size_t)bag * N + r0 + r] = red[r * 4] + red[r * 4 + 1] + red[r * 4 + 2] +
                                      red[r * 4 + 3] + bc[0];
}

// Backward pass 2: softmax backward and gate backward of one 64-row tile:
// dza, dzb (to scratch), dwc and dbc; as gates_bwd_kernel<bf16> up to dx.
__global__ void __launch_bounds__(tc::THREADS, 2)
gates_bwd_tc(const bf16* __restrict__ xc, const bf16* __restrict__ wa,
             const float* __restrict__ ba, const bf16* __restrict__ wb,
             const float* __restrict__ bb, const bf16* __restrict__ wc,
             const uint8_t* __restrict__ mask, Dropout dp, int gated, const float* __restrict__ p,
             const float* __restrict__ gs, const float* __restrict__ dpv,
             bf16* __restrict__ dza_out, bf16* __restrict__ dzb_out, float* __restrict__ dwc,
             float* __restrict__ dbc, int N, int L1, int D) {
  extern __shared__ uint4 tc_smem[];
  bf16* Xs = reinterpret_cast<bf16*>(tc_smem);
  const int bag = blockIdx.y, r0 = blockIdx.x * BM;
  const int lane = threadIdx.x & 31, wm = tc::warp_m();
  tc::BSrc b{wa, gated ? wb : nullptr, D, 0};
  tc::Ring ring = tc::tile_start(xc, bag, r0, N, L1, b, Xs);
  float* Ds = reinterpret_cast<float*>(ring_end(ring));  // BM: ds per row
  float* Wcs = Ds + BM * 4;                               // D: this block's dwc partial
  float* red = Wcs + D;                                   // 32
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
      ds += gs[(size_t)bag * N + row];
    }
    Ds[threadIdx.x] = ds;
    dbc_part = ds;
  }
  for (int c = threadIdx.x; c < D; c += tc::THREADS) Wcs[c] = 0.f;
  const float dbc_blk = block_sum(dbc_part, red);  // also orders the smem writes above
  if (threadIdx.x == 0) atomicAdd(dbc, dbc_blk);

  const uint32_t key_a = murcl::bag_key(dp.seed, bag, 1), key_b = murcl::bag_key(dp.seed, bag, 2);
  tc::Acc acc;
  const int step = gated ? tc::BN / 2 : tc::BN;
  for (int n0 = 0; n0 < D; n0 += step) {
    b.n0 = n0;
    const tc::BSrc next{n0 + step < D ? wa : nullptr, gated ? wb : nullptr, D, n0 + step};
    tc::mma_pass(Xs, nullptr, L1 + PAD, L1, b, next, ring, acc);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (gated && j >= 2) continue;
      const int col = gate_col(gated, n0, j, 0);  // the thread's columns: col, col + 1
      float wsum[2] = {};
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = wm * 32 + tc::frag_row(mi, 2 * hh);
          const float ds_t = rnd<bf16>(Ds[r]);
          float dza[2], dzb[2];
#pragma unroll
          for (int eb = 0; eb < 2; ++eb) {
            const int e = 2 * hh + eb, c = col + eb;
            const Gates t = gates_at(acc[mi][j][e] + ba[c],
                                     gated ? acc[mi][(j + 2) & 3][e] + bb[c] : 0.f, gated, dp,
                                     key_a, key_b, (uint32_t)(r0 + r) * D + c);
            wsum[eb] = fmaf(t.u, ds_t, wsum[eb]);
            const float du = rnd<bf16>(__fmul_rn(ds_t, ld<bf16>(wc + c)));
            float da = gated ? rnd<bf16>(__fmul_rn(du, t.g_eff)) : du;
            if (dp.on) da = rnd<bf16>(__fmul_rn(da, t.ka));
            dza[eb] = rnd<bf16>(__fmul_rn(da, rnd<bf16>(1.f - rnd<bf16>(__fmul_rn(t.a, t.a)))));
            dzb[eb] = 0.f;
            if (gated) {
              float dg = rnd<bf16>(__fmul_rn(du, t.a_eff));
              if (dp.on) dg = rnd<bf16>(__fmul_rn(dg, t.kb));
              dzb[eb] = rnd<bf16>(__fmul_rn(rnd<bf16>(__fmul_rn(dg, t.g)), rnd<bf16>(1.f - t.g)));
            }
          }
          if (r0 + r >= N) continue;
          const size_t at = ((size_t)bag * N + r0 + r) * D + col;
          st2(dza_out + at, dza[0], dza[1]);
          if (gated) st2(dzb_out + at, dzb[0], dzb[1]);
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
  }
  __syncthreads();
  for (int c = threadIdx.x; c < D; c += tc::THREADS) atomicAdd(&dwc[c], Wcs[c]);
}

// Backward pass 3: dz = drop/relu'(bf16(p gm^T) + bf16(dza @ Wa^T)
// + bf16(dzb @ Wb^T)) of one 64-row tile, the two products in one pass of
// two accumulators (rounded apart, as the twin rounds them), and, with
// dh_out, dh = dz @ Wf^T; as gates_bwd_kernel<bf16> from dx on. relu'(z) is
// read as xc > 0 (see gates_bwd_kernel), from the scratch.
__global__ void __launch_bounds__(tc::THREADS, 2)
dx_tc(const bf16* __restrict__ xc, const bf16* __restrict__ waT, const bf16* __restrict__ wbT,
      const bf16* __restrict__ wfT, Dropout dp, int gated, const float* __restrict__ p,
      const float* __restrict__ gm, const bf16* __restrict__ dza, const bf16* __restrict__ dzb,
      bf16* __restrict__ dz_out, bf16* __restrict__ dh_out, int N, int Fin, int L1, int D) {
  extern __shared__ uint4 tc_smem[];
  const int ldd = D + PAD, ldz = L1 + PAD;
  bf16* DAs = reinterpret_cast<bf16*>(tc_smem);
  bf16* DBs = DAs + BM * ldd;
  tc::Ring ring{DBs + BM * ldd, 0, true};
  float* Ps = reinterpret_cast<float*>(ring_end(ring));  // BM: p per row
  bf16* DZs = reinterpret_cast<bf16*>(Ps + BM);           // with dh_out: the dz tile
  const int bag = blockIdx.y, r0 = blockIdx.x * BM, wm = tc::warp_m(), wn = tc::warp_n();

  tc::load_rows(dza + (size_t)bag * N * D, D, r0, N, DAs);
  if (gated) tc::load_rows(dzb + (size_t)bag * N * D, D, r0, N, DBs);
  const int step = gated ? tc::BN / 2 : tc::BN;
  tc::BSrc b{waT, gated ? wbT : nullptr, L1, 0};
  tc::load_b(b, 0, ring.buf);
  tc::cp_commit();
  if (threadIdx.x < BM) Ps[threadIdx.x] = r0 + threadIdx.x < N ? p[(size_t)bag * N + r0 + threadIdx.x] : 0.f;

  const uint32_t key_x = murcl::bag_key(dp.seed, bag, 0);
  const float* gmb = gm + (size_t)bag * L1;
  tc::Acc acc;
  for (int n0 = 0; n0 < L1; n0 += step) {
    // this thread's xc pairs, loaded ahead of the products they wait for
    uint32_t xv[2][4][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = r0 + wm * 32 + tc::frag_row(mi, 2 * hh);
          xv[mi][j][hh] = 0u;
          if (!(gated && j >= 2) && row < N)
            xv[mi][j][hh] = __ldg(reinterpret_cast<const unsigned int*>(
                xc + ((size_t)bag * N + row) * L1 + gate_col(gated, n0, j, 0)));
        }
    b.n0 = n0;
    const tc::BSrc next = n0 + step < L1 ? tc::BSrc{waT, gated ? wbT : nullptr, L1, n0 + step}
                                          : tc::BSrc{dh_out ? wfT : nullptr, nullptr, Fin, 0};
    if (gated)
      tc::mma_pass<true>(DAs, DBs, ldd, D, b, next, ring, acc);
    else
      tc::mma_pass(DAs, nullptr, ldd, D, b, next, ring, acc);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (gated && j >= 2) continue;  // dzb @ Wb^T: read beside dza @ Wa^T
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = wm * 32 + tc::frag_row(mi, 2 * hh);
          const int col = gate_col(gated, n0, j, 0);
          const __nv_bfloat162 x2 = *reinterpret_cast<const __nv_bfloat162*>(&xv[mi][j][hh]);
          float dz[2];
#pragma unroll
          for (int eb = 0; eb < 2; ++eb) {
            const int e = 2 * hh + eb;
            float dx = rnd<bf16>(__fadd_rn(rnd<bf16>(__fmul_rn(Ps[r], gmb[col + eb])),
                                           rnd<bf16>(acc[mi][j][e])));
            if (gated) dx = rnd<bf16>(__fadd_rn(dx, rnd<bf16>(acc[mi][(j + 2) & 3][e])));
            const float x = eb ? __high2float(x2) : __low2float(x2);
            float m;
            if (dp.on)
              m = x > 0.f ? keep_scale<bf16>(dp, key_x, (uint32_t)(r0 + r) * L1 + col + eb)
                          : 0.f;
            else
              m = x > 0.f ? 1.f : 0.f;
            dz[eb] = rnd<bf16>(__fmul_rn(dx, m));  // dead rows: xc = 0, so dz = 0
          }
          if (r0 + r < N) st2(dz_out + ((size_t)bag * N + r0 + r) * L1 + col, dz[0], dz[1]);
          if (dh_out) st2(DZs + r * ldz + col, dz[0], dz[1]);
        }
      }
  }
  if (!dh_out) return;
  // dh = dz @ Wf^T, rounded to bf16 once
  for (int n0 = 0; n0 < Fin; n0 += tc::BN) {
    const tc::BSrc bh{wfT, nullptr, Fin, n0};
    const tc::BSrc next{n0 + tc::BN < Fin ? wfT : nullptr, nullptr, Fin, n0 + tc::BN};
    tc::mma_pass(DZs, nullptr, ldz, L1, bh, next, ring, acc);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = r0 + wm * 32 + tc::frag_row(mi, 2 * hh);
          if (row < N)
            st2(dh_out + ((size_t)bag * N + row) * Fin + n0 + wn * 32 + tc::frag_col(j, 0),
                rnd<bf16>(acc[mi][j][2 * hh]), rnd<bf16>(acc[mi][j][2 * hh + 1]));
        }
  }
}

int fwd_tc(const void* h, const void* perm, const void* lam, const void* wf, const void* bf,
           const void* wa, const void* ba, const void* wb, const void* bb, const void* wc,
           const void* bc, const void* mask, Dropout dp, int gated, void* xc, void* m, void* p,
           void* s, int B, int N, int Fin, int L1, int D, cudaStream_t stream) {
  const dim3 tiles((N + BM - 1) / BM, B);
  const size_t smem1 = tc_trunk_smem(Fin);
  MURCL_TRY(allow_smem(trunk_tc, smem1));
  trunk_tc<<<tiles, tc::THREADS, smem1, stream>>>(
      (const bf16*)h, (const int64_t*)perm, (const float*)lam, (const bf16*)wf,
      (const float*)bf, dp, nullptr, nullptr, (bf16*)xc, nullptr, nullptr, N, Fin, L1);
  MURCL_TRY(cudaGetLastError());
  const size_t smem2 = tc_gates_smem(L1, D);
  MURCL_TRY(allow_smem(gates_fwd_tc, smem2));
  gates_fwd_tc<<<tiles, tc::THREADS, smem2, stream>>>(
      (const bf16*)xc, (const bf16*)wa, (const float*)ba, (const bf16*)wb, (const float*)bb,
      (const bf16*)wc, (const float*)bc, dp, gated, (float*)s, N, L1, D);
  MURCL_TRY(cudaGetLastError());
  return pool<bf16>((const float*)s, (const uint8_t*)mask, (const bf16*)xc, (float*)m, (float*)p,
                    B, N, L1, stream);
}

int bwd_tc(const void* h, const void* perm, const void* lam, const void* wf, const void* bf,
           const void* wa, const void* ba, const void* wb, const void* bb, const void* wc,
           const void* waT, const void* wbT, const void* wfT, const void* mask, Dropout dp,
           int gated, const void* p, const void* gm, const void* gp, const void* gs, void* hm,
           void* xc, void* dpv, void* dza, void* dzb, void* dz, void* dh, void* dwf, void* dbf,
           void* dwa, void* dba, void* dwb, void* dbb, void* dwc, void* dbc, int B, int N,
           int Fin, int L1, int D, cudaStream_t stream) {
  const dim3 tiles((N + BM - 1) / BM, B);
  const size_t smem1 = tc_trunk_smem(Fin);
  MURCL_TRY(allow_smem(trunk_tc, smem1));
  trunk_tc<<<tiles, tc::THREADS, smem1, stream>>>(
      (const bf16*)h, (const int64_t*)perm, (const float*)lam, (const bf16*)wf,
      (const float*)bf, dp, (const float*)gm, (const float*)gp, (bf16*)xc, (bf16*)hm,
      (float*)dpv, N, Fin, L1);
  MURCL_TRY(cudaGetLastError());

  const size_t smem2 = tc_gates_smem(L1, D);
  MURCL_TRY(allow_smem(gates_bwd_tc, smem2));
  gates_bwd_tc<<<tiles, tc::THREADS, smem2, stream>>>(
      (const bf16*)xc, (const bf16*)wa, (const float*)ba, (const bf16*)wb, (const float*)bb,
      (const bf16*)wc, (const uint8_t*)mask, dp, gated, (const float*)p, (const float*)gs,
      (const float*)dpv, (bf16*)dza, (bf16*)dzb, (float*)dwc, (float*)dbc, N, L1, D);
  MURCL_TRY(cudaGetLastError());

  const size_t smem3 = tc_dx_smem(L1, D, dh != nullptr);
  MURCL_TRY(allow_smem(dx_tc, smem3));
  dx_tc<<<tiles, tc::THREADS, smem3, stream>>>(
      (const bf16*)xc, (const bf16*)waT, (const bf16*)wbT, (const bf16*)wfT, dp, gated,
      (const float*)p, (const float*)gm, (const bf16*)dza, (const bf16*)dzb, (bf16*)dz,
      (bf16*)dh, N, Fin, L1, D);
  MURCL_TRY(cudaGetLastError());

  const long long R = (long long)B * N;
  int err = tc::wgrad(hm, Fin, dz, L1, R, (float*)dwf, (float*)dbf, stream);
  if (err) return err;
  err = tc::wgrad(xc, L1, dza, D, R, (float*)dwa, (float*)dba, stream);
  if (err || !gated) return err;
  return tc::wgrad(xc, L1, dzb, D, R, (float*)dwb, (float*)dbb, stream);
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

MURCL_API int murcl_fused_trunk_fwd(int is_bf16, int gated, const void* h, const void* perm,
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
    return fwd_tc(h, perm, lam, wf, bf, wa, ba, wb, bb, wc, bc, mask, dp, gated, xc, m, p, s, B,
                  N, Fin, L1, D, strm);
  return fwd_impl<float>(h, perm, lam, wf, bf, wa, ba, wb, bb, wc, bc, mask, dp, gated, xc, m, p,
                         s, B, N, Fin, L1, D, strm);
}

// dzb may be null when ungated; dh (and wfT) null unless the bags' gradient
// is wanted.
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
  if (is_bf16)
    return bwd_tc(h, perm, lam, wf, bf, wa, ba, wb, bb, wc, waT, wbT, wfT, mask, dp, gated, p,
                  gm, gp, gs, hm, xc, dpv, dza, dzb, dz, dh, dwf, dbf, dwa, dba, dwb, dbb, dwc,
                  dbc, B, N, Fin, L1, D, strm);
  return bwd_impl<float>(h, perm, lam, wf, bf, wa, ba, wb, bb, wc, waT, wbT, wfT, mask, dp,
                         gated, p, gm, gp, gs, hm, xc, dpv, dza, dzb, dz, dh, dwf, dbf, dwa, dba,
                         dwb, dbb, dwc, dbc, B, N, Fin, L1, D, strm);
}
