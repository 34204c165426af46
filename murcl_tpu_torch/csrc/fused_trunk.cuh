// K2/K3's warpgroup kernels' bodies and what their two sources share.
// fused_trunk.cu holds the production kernels, the passes that launch them
// and the entry points (its header comment sets out the design);
// fused_trunk_ablate.cu holds the ablation kernels (X_ablate_wg) of the
// measurement probes and their entry points, which run fused_trunk.cu's
// passes with some of their kernels swapped or some passes skipped. Each
// kernel with variants is a body here (a __device__ function, inlined) that
// the production kernel runs at kLean and its ablation kernel at another
// variant, so the production kernels keep their names and code, and the
// probes' instantiations build beside them, in their own source.
#pragma once
#include "wgmma_tiles.cuh"

// The kernels of the passes that fused_trunk_fwd_with and
// fused_trunk_bwd_with launch: each null for the production kernel, or the
// address of an ablation kernel with the production kernel's parameters.
struct TrunkKernels {
  const void* trunk = nullptr;
  const void* gates_fwd = nullptr;
  const void* gates_bwd = nullptr;
  const void* dx = nullptr;
};

// murcl_fused_trunk_fwd's and murcl_fused_trunk_bwd's parameters (their
// meaning at those entry points, fused_trunk.cu).
#define TRUNK_FWD_API_PARAMS                                                                   \
  int is_bf16, int gated, const void *h, const void *perm, const void *lam, const void *wf,    \
      const void *bf, const void *wa, const void *ba, const void *wb, const void *bb,          \
      const void *wc, const void *bc, void *x3, const void *mask, int use_dropout,             \
      uint32_t seed, uint32_t thresh, float scale, void *xc, void *hm, void *m, void *p,       \
      void *s, int B, int N, int Fin, int L1, int D, int L1l, int Dl, void *stream
#define TRUNK_FWD_API_ARGS                                                                     \
  is_bf16, gated, h, perm, lam, wf, bf, wa, ba, wb, bb, wc, bc, x3, mask, use_dropout, seed,   \
      thresh, scale, xc, hm, m, p, s, B, N, Fin, L1, D, L1l, Dl, stream
#define TRUNK_BWD_API_PARAMS                                                                   \
  int is_bf16, int gated, const void *h, const void *perm, const void *lam, const void *wf,    \
      const void *bf, const void *wa, const void *ba, const void *wb, const void *bb,          \
      const void *wc, void *x3, const void *mask, int use_dropout, uint32_t seed,              \
      uint32_t thresh, float scale, const void *p, const void *gm, const void *gp,             \
      const void *gs, void *hm, void *xc, void *dpv, void *dzab, void *dz, void *dh,           \
      void *dwf, void *dbf, void *dwa, void *dba, void *dwb, void *dbb, void *dwc, void *dbc,  \
      int B, int N, int Fin, int L1, int D, int L1l, int Dl, void *stream
#define TRUNK_BWD_API_ARGS                                                                     \
  is_bf16, gated, h, perm, lam, wf, bf, wa, ba, wb, bb, wc, x3, mask, use_dropout, seed,       \
      thresh, scale, p, gm, gp, gs, hm, xc, dpv, dzab, dz, dh, dwf, dbf, dwa, dba, dwb, dbb,   \
      dwc, dbc, B, N, Fin, L1, D, L1l, Dl, stream

// The backward's passes that an ablation skips (fused_trunk_bwd_with's
// `skip`): kSkipWgrad both weight-gradient passes (dWf, dbf, dWa, dba, dWb
// and dbb stay zero: wgrad_wg sums the biases too); kSkipDx dx_wg, dh_wg and
// dWf's pass (dWf and dbf stay zero).
constexpr int kSkipWgrad = 1, kSkipDx = 2;

// murcl_fused_trunk_fwd and murcl_fused_trunk_bwd with their passes'
// kernels from `k`, the backward without the passes in `skip`. Hidden: each
// library (ops/_cuda.py's kernels and probes) binds its own copy, whose
// launches find the kernels that library registered.
__attribute__((visibility("hidden"))) int fused_trunk_fwd_with(const TrunkKernels& k,
                                                               TRUNK_FWD_API_PARAMS);
__attribute__((visibility("hidden"))) int fused_trunk_bwd_with(const TrunkKernels& k, int skip,
                                                               TRUNK_BWD_API_PARAMS);

namespace {

// The keep bits of element (row, col) hash index row * stride + col, the
// strides the logical L1 (trunk, dx chain) and D (gates): at widths the
// wrappers zero-padded to 128 (ops/attention.py pad_trunk_widths) every
// real unit keeps the twin's bit, and a padded unit's bit, which lands on
// another index, meets a value that is 0 whatever it is.
struct Dropout {
  int on;
  uint32_t seed, thresh;
  float scale;  // 1 / (1 - rate) in f32; rounded to T at each use
  int l1, d;    // the hash's row strides: the logical L1 and D
};

// The bodies' variants (the ablations' in fused_trunk_ablate.cu, the ports
// of scripts/dbg_vpu_lean.py and dbg_bwd_ablate.py, which ablate the TPU
// kernels). kLean is the production
// kernels' epilogues: relu and the keep bit folded into one {0, scale}
// multiplier. kPreLean takes relu, the 0/1 keep and the scale as separate
// rounded products (trunk, gates and dz chain; bitwise the same values).
// kLean2 (bf16) sums dx's three terms in one f32 accumulator and rounds once.
// kDwcOnly replays the gates and sums dwc alone (no dza, dzb).
constexpr int kLean = 0, kPreLean = 1, kLean2 = 2, kDwcOnly = 3;
// The kernels' tensor maps: kernel parameters (KMAP), which the bodies take
// by reference (BMAP).
#define KMAP const __grid_constant__ CUtensorMap
#define BMAP const CUtensorMap&

using wg::bf16;
using wg::BK;
using wg::BM;
using wg::BN;
using wg::TILE_A;
using wg::TILE_B;

// What the f32 trunk needs to take an element's z again in f32 (refine).
struct Refine {
  const float* h;    // the f32 bags (B, N, Fin)
  const float* wft;  // Wf^T (L1, Fin), f32
  const float* rn;   // (B, N): the norms of the (mixed) bags' rows
  const float* cn;   // (L1): the norms of Wf's columns
  uint32_t* mask;    // (B, N, L1 / 128, 4): the elements to take again
};

// Three bf16 products give z = acc + bf within about 3 2^-18 sum_i |h_i
// Wf_ic| of the f32 product, and where |z| is that close to 0 the side of
// relu's kink is uncertain: a flip moves dz by all of dx (2e-4 to 4e-4 of
// dWf and dh against the f32 twin, beyond the 1e-4 tolerance). So the trunk
// flags each element whose |z| is at most kRefine ||h row|| ||Wf column||
// (2^-15: Cauchy-Schwarz bounds the sum by the norms, with room for the
// accumulation's rounding; about 5e-4 of the elements), and refine_kernel
// takes them again.
constexpr float kRefine = 1.f / 32768.f;

// The trunk epilogue's flags: for each of this thread's two rows, a word of
// its 32 columns of the pass, bit 2 j + eb for column n0 + frag_col(j) + eb,
// at mask[(row, pass)][lane % 4].
__device__ __forceinline__ void flag_near_zero(const float (&acc)[64], const float* bfs,
                                               const float* cns, const Refine& rf, int bag,
                                               int r0, int n0, int N, int L1) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = r0 + wg::frag_row(hh);
    if (row >= N) continue;
    const float bound = kRefine * rf.rn[(size_t)bag * N + row];
    uint32_t m = 0u;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int eb = 0; eb < 2; ++eb) {
        const int col = n0 + wg::frag_col(j) + eb;
        if (fabsf(acc[4 * j + 2 * hh + eb] + bfs[col]) <= bound * cns[col])
          m |= 1u << (2 * j + eb);
      }
    rf.mask[(((size_t)bag * N + row) * (L1 / BN) + n0 / BN) * 4 + (threadIdx.x & 3)] = m;
  }
}

// v times its keep multiplier k, rounded to T: Lean, k in {0, scale}, one
// product; pre-lean (kPreLean), k in {0, 1}, then the scale.
template <typename T, bool Lean>
__device__ __forceinline__ float kept(float v, float k, float scale) {
  const float x = rnd<T>(__fmul_rn(v, k));
  return Lean ? x : rnd<T>(__fmul_rn(x, scale));
}

// The gates at one element, rounded to T where the TPU kernel rounds them:
// a = tanh(za), g = sigmoid(zb) (gated only), their keep multipliers ka, kb
// (from the keep bits and `scale`, the keep scale in T; see kept), the kept
// a_eff, g_eff and u = a_eff * g_eff (or a_eff).
struct Gates {
  float a, ka, a_eff, g, kb, g_eff, u;
};
template <typename T, bool Lean = true>
__device__ __forceinline__ Gates gates_at(float za, float zb, int gated, bool drop, bool keep_a,
                                          bool keep_b, float scale) {
  Gates t{rnd<T>(tanhf(za)), 1.f, 0.f, 0.f, 1.f, 0.f, 0.f};
  t.a_eff = t.a;
  if (drop) {
    t.ka = keep_a ? (Lean ? scale : 1.f) : 0.f;
    t.a_eff = kept<T, Lean>(t.a, t.ka, scale);
  }
  t.u = t.a_eff;
  if (gated) {
    t.g = t.g_eff = rnd<T>(sigmoidf(zb));
    if (drop) {
      t.kb = keep_b ? (Lean ? scale : 1.f) : 0.f;
      t.g_eff = kept<T, Lean>(t.g, t.kb, scale);
    }
    t.u = rnd<T>(__fmul_rn(t.a_eff, t.g_eff));
  }
  return t;
}

// Mix and trunk of 128-row tiles, 128 columns of xc a pass: xc = drop(relu(Hs
// @ Wf + bf)) to the scratch (staged, stored by TMA), Wf read MN-major as
// stored. bf16: with a partner bag (perm), the first pass of a tile loads the
// partner's slices beside the bag's, the producer warpgroup's three other
// warps mix them in place and store them to hm by TMA, and the later passes
// read the mixed tile back from hm (the helpers' last store complete before
// the producer's first load of it: the aux barrier), so a tile is mixed
// once. f32: h_map reads the bags' planes (hi of bag b, lo as bag B + b) and
// wf_map Wf's (lo at rows Fin ..), and xc goes out as its two
// planes (lo as bag B + b of xc_map), its elements near relu's kink
// flagged for refine_kernel (flag_near_zero; perm is unread). With dpp (the
// backward) each pass c also writes dpp[c][row] = xc[row, 128 c ..] .
// rnd(gm[bag, 128 c ..]). The body of trunk_wg (V = kLean) and of its
// ablation trunk_ablate_wg (kPreLean: the epilogue's relu, keep and scale
// taken apart).
#define TRUNK_PARAMS(MAP)                                                                     \
  MAP h_map, MAP wf_map, MAP hm_map, MAP hm_st, MAP xc_map, const int64_t *__restrict__ perm,  \
      const float *__restrict__ lam, const float *__restrict__ bf, Dropout dp,                \
      const float *__restrict__ gm, float *__restrict__ dpp, Refine rf, int stages, int B,    \
      int N, int Fin, int L1
#define TRUNK_ARGS h_map, wf_map, hm_map, hm_st, xc_map, perm, lam, bf, dp, gm, dpp, rf, stages, \
                   B, N, Fin, L1
template <typename T, int V>
__device__ __forceinline__ void trunk_body(TRUNK_PARAMS(BMAP)) {
  constexpr bool X3 = kX3<T>;
  extern __shared__ uint8_t smem_raw[];
  const bool mixed = !X3 && perm != nullptr;
  // a stage: the bag's A slice, then the partner's (bf16 mixed) or the lo
  // plane's (f32), then Wf's slice (and, f32, its lo plane's)
  const int a_bytes = TILE_A * (X3 || mixed ? 2 : 1);
  wg::Pipe pipe = wg::pipe_setup(smem_raw, a_bytes + kPlanes<T> * TILE_B, stages,
                                 2 * kPlanes<T> * wg::OUT_TILE, mixed);
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
              if (X3 || mixed)
                wg::tma_load_3d(st + TILE_A, &h_map, bar, k * BK, r0, X3 ? B + bag : partner);
            }
            wg::load_b_mn(st + a_bytes, &wf_map, n0, &wf_map, n0 + 64, k * BK, bar);
            if (X3)
              wg::load_b_mn(st + a_bytes + TILE_B, &wf_map, n0, &wf_map, n0 + 64, Fin + k * BK,
                            bar);
          }
        }
      }
    } else if ((mixed || dp.on) && threadIdx.x >= wg::PRODUCER + 32) {
      const int mt = threadIdx.x - wg::PRODUCER - 32;  // 0 .. 95
      // the keep bits of pass (t, n0), made one pass ahead of the mixing
      auto bits = [&](int t, int n0) {
        const int bag = t / tiles;
        wg::make_bits(pipe, murcl::bag_key(dp.seed, bag, 0), 0, false, dp.l1, (t % tiles) * BM,
                      n0, dp.thresh, mt);
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
  float* gms = bfs + L1 + w * L1;                     // L1 per warpgroup: rnd(gm) of its bag
  float* cns = bfs + 3 * L1;                          // f32: L1, the norms of Wf's columns
  to_shared(bfs, bf, L1, false, tid, wg::CONSUMERS);
  if (X3) to_shared(cns, rf.cn, L1, false, tid, wg::CONSUMERS);
  wg::sync_consumers();
  float acc[64];
  const float scale = rnd<T>(dp.scale);
  for (int t = blockIdx.x; t < tiles * B; t += gridDim.x) {
    const int bag = t / tiles, r0 = (t % tiles) * BM;
    if (dpp) {
      wg::sync_wg();
      to_shared(gms, gm + (size_t)bag * L1, L1, !X3, tid & 127, 128);
      wg::sync_wg();
    }
    for (int n0 = 0; n0 < L1; n0 += BN) {
      wg::mainloop<0, 1, X3>(pipe, nk, 0, a_bytes, acc, wg::NoPre{}, TILE_A, a_bytes + TILE_B);
      if constexpr (X3) flag_near_zero(acc, bfs, cns, rf, bag, r0, n0, N, L1);
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
            if (dp.on && V == kPreLean) {
              const float keep = wg::bit(kb, 4 * j + 2 * hh + eb) ? 1.f : 0.f;
              x[eb] = kept<T, false>(rnd<T>(fmaxf(z, 0.f)), keep, scale);
            } else if (dp.on) {
              const float m = z > 0.f && wg::bit(kb, 4 * j + 2 * hh + eb) ? scale : 0.f;
              x[eb] = rnd<T>(__fmul_rn(rnd<T>(z), m));
            } else {
              x[eb] = rnd<T>(fmaxf(z, 0.f));
            }
          }
          if constexpr (X3)
            wg::stage_split(pipe.out, pipe.out + 2 * wg::OUT_TILE, rl - 64 * w, c, x);
          else
            wg::stage_pair(pipe.out, rl - 64 * w, c, x[0], x[1]);
          if (dpp) rowp[hh] = fmaf(x[1], gms[col + 1], fmaf(x[0], gms[col], rowp[hh]));
        }
      wg::stage_end(pipe, &xc_map, n0, n0 + 64, r0 + 64 * w, bag, X3 ? B + bag : -1);
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

// The gate parameters of a block in shared memory: ba, bb and wc (values of
// T) as f32, D each.
template <typename T>
__device__ __forceinline__ void gate_params(float* ps, const float* __restrict__ ba,
                                            const float* __restrict__ bb,
                                            const T* __restrict__ wc, int gated, int D) {
  for (int c = threadIdx.x; c < D; c += wg::CONSUMERS) {
    ps[c] = ba[c];
    ps[D + c] = gated ? bb[c] : 0.f;
    ps[2 * D + c] = ld<T>(wc + c);
  }
}

// Forward pass 2: the raw scores s of each 128-row tile from its xc (f32:
// its planes, as bags B .. of xc_map the lo plane; Wa's and Wb's lo planes
// at rows L1 ..). The body of gates_fwd_wg (kLean) and gates_fwd_ablate_wg
// (kPreLean: the gates' keep and scale apart).
#define GATES_FWD_PARAMS(MAP)                                                                \
  MAP xc_map, MAP wa_map, MAP wb_map, const float *__restrict__ ba,                         \
      const float *__restrict__ bb, const T *__restrict__ wc, const float *__restrict__ bc, \
      Dropout dp, int gated, float *__restrict__ s_out, int stages, int B, int N, int L1, int D
#define GATES_FWD_ARGS xc_map, wa_map, wb_map, ba, bb, wc, bc, dp, gated, s_out, stages, B, N, L1, D
template <typename T, int V>
__device__ __forceinline__ void gates_fwd_body(GATES_FWD_PARAMS(BMAP)) {
  constexpr bool X3 = kX3<T>;
  constexpr int P = kPlanes<T>;
  extern __shared__ uint8_t smem_raw[];
  wg::Pipe pipe = wg::pipe_setup(smem_raw, P * (TILE_A + TILE_B), stages, 0, false);
  if (wg::is_producer()) {
    wg::producer_regs();
    if (threadIdx.x == wg::PRODUCER)
      produce_gates(pipe, &xc_map, &wa_map, &wb_map, gated, B, N, L1, D, X3);
    else if (dp.on && threadIdx.x >= wg::PRODUCER + 32)
      bits_passes(pipe, dp.seed, dp.thresh, 1, gated, gated ? 64 : BN, D, B, N, dp.d);
    return;
  }
  wg::consumer_regs();
  float* bas = reinterpret_cast<float*>(pipe.extra);  // ba, bb, wc: D each
  const float *bbs = bas + D, *wcs = bas + 2 * D;
  gate_params<T>(bas, ba, bb, wc, gated, D);
  wg::sync_consumers();
  const int tiles = (N + BM - 1) / BM, step = gated ? 64 : BN;
  const float scale = rnd<T>(dp.scale);
  float acc[64];
  for (int t = blockIdx.x; t < tiles * B; t += gridDim.x) {
    const int bag = t / tiles, r0 = (t % tiles) * BM;
    float rowp[2] = {};
    for (int n0 = 0; n0 < D; n0 += step) {
      wg::mainloop<0, 1, X3>(pipe, L1 / BK, 0, P * TILE_A, acc, wg::NoPre{}, TILE_A,
                             2 * TILE_A + TILE_B);
      const uint2 kb = dp.on ? wg::take_bits(pipe) : make_uint2(0u, 0u);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        if (gated && j >= 8) continue;  // g: read beside a
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
          for (int eb = 0; eb < 2; ++eb) {
            const int e = 4 * j + 2 * hh + eb, col = n0 + wg::frag_col(j) + eb;
            const Gates g = gates_at<T, V != kPreLean>(
                acc[e] + bas[col], gated ? acc[e + 32] + bbs[col] : 0.f, gated, dp.on,
                wg::bit(kb, e), wg::bit(kb, e + 32 * gated), scale);
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
// ungated; staged and stored by TMA; f32: as their two planes, the lo plane
// as bags B .. of zab_map) and dwc. The body of gates_bwd_wg (kLean) and
// gates_bwd_ablate_wg (kPreLean: the keep and scale apart; kDwcOnly: the
// gates replayed for u, dwc summed, no dza, dzb or store).
#define GATES_BWD_PARAMS(MAP)                                                                  \
  MAP xc_map, MAP wa_map, MAP wb_map, MAP zab_map, const float *__restrict__ ba,              \
      const float *__restrict__ bb, const T *__restrict__ wc, Dropout dp, int gated,          \
      const float *__restrict__ ds, float *__restrict__ dwc, int stages, int B, int N, int L1, \
      int D
#define GATES_BWD_ARGS \
  xc_map, wa_map, wb_map, zab_map, ba, bb, wc, dp, gated, ds, dwc, stages, B, N, L1, D
template <typename T, int V>
__device__ __forceinline__ void gates_bwd_body(GATES_BWD_PARAMS(BMAP)) {
  constexpr bool Lean = V != kPreLean, Dwc = V == kDwcOnly;
  constexpr bool X3 = kX3<T>;
  constexpr int P = kPlanes<T>;
  extern __shared__ uint8_t smem_raw[];
  wg::Pipe pipe =
      wg::pipe_setup(smem_raw, P * (TILE_A + TILE_B), stages, 2 * P * wg::OUT_TILE, false);
  if (wg::is_producer()) {
    wg::producer_regs();
    if (threadIdx.x == wg::PRODUCER)
      produce_gates(pipe, &xc_map, &wa_map, &wb_map, gated, B, N, L1, D, X3);
    else if (dp.on && threadIdx.x >= wg::PRODUCER + 32)
      bits_passes(pipe, dp.seed, dp.thresh, 1, gated, gated ? 64 : BN, D, B, N, dp.d);
    return;
  }
  wg::consumer_regs();
  float* bas = reinterpret_cast<float*>(pipe.extra);  // ba, bb, wc, then dwc's partial: D each
  const float *bbs = bas + D, *wcs = bas + 2 * D;
  float* Wcs = bas + 3 * D;
  const int tid = threadIdx.x, lane = tid & 31, w = wg::wg_index();
  gate_params<T>(bas, ba, bb, wc, gated, D);
  for (int c = tid; c < D; c += wg::CONSUMERS) Wcs[c] = 0.f;
  wg::sync_consumers();
  const int tiles = (N + BM - 1) / BM, step = gated ? 64 : BN;
  const float scale = rnd<T>(dp.scale);
  float acc[64];
  for (int t = blockIdx.x; t < tiles * B; t += gridDim.x) {
    const int bag = t / tiles, r0 = (t % tiles) * BM;
    float ds_t[2];  // this thread's two rows; dead rows 0
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = r0 + wg::frag_row(hh);
      ds_t[hh] = r < N ? rnd<T>(ds[(size_t)bag * N + r]) : 0.f;
    }
    for (int n0 = 0; n0 < D; n0 += step) {
      wg::mainloop<0, 1, X3>(pipe, L1 / BK, 0, P * TILE_A, acc, wg::NoPre{}, TILE_A,
                             2 * TILE_A + TILE_B);
      const uint2 kb = dp.on ? wg::take_bits(pipe) : make_uint2(0u, 0u);
      if (!Dwc) wg::stage_begin();
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        if (gated && j >= 8) continue;
        const int c = wg::frag_col(j), col = n0 + c;  // the thread's columns: col, col + 1
        float wsum[2] = {};
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int rl = wg::frag_row(hh) - 64 * w;
          float dza[2], dzb[2];
#pragma unroll
          for (int eb = 0; eb < 2; ++eb) {
            const int e = 4 * j + 2 * hh + eb, cc = col + eb;
            const Gates g = gates_at<T, Lean>(acc[e] + bas[cc],
                                              gated ? acc[e + 32] + bbs[cc] : 0.f, gated, dp.on,
                                              wg::bit(kb, e), wg::bit(kb, e + 32 * gated), scale);
            wsum[eb] = fmaf(g.u, ds_t[hh], wsum[eb]);
            if (Dwc) continue;
            const float du = rnd<T>(__fmul_rn(ds_t[hh], wcs[cc]));
            float da = gated ? rnd<T>(__fmul_rn(du, g.g_eff)) : du;
            if (dp.on) da = kept<T, Lean>(da, g.ka, scale);
            dza[eb] = rnd<T>(__fmul_rn(da, rnd<T>(1.f - rnd<T>(__fmul_rn(g.a, g.a)))));
            dzb[eb] = 0.f;
            if (gated) {
              float dg = rnd<T>(__fmul_rn(du, g.a_eff));
              if (dp.on) dg = kept<T, Lean>(dg, g.kb, scale);
              dzb[eb] = rnd<T>(__fmul_rn(rnd<T>(__fmul_rn(dg, g.g)), rnd<T>(1.f - g.g)));
            }
          }
          if (Dwc) continue;
          // gated: box 0 holds dza's 64 columns, box 1 dzb's
          if constexpr (X3) {
            uint8_t* lo = pipe.out + 2 * wg::OUT_TILE;
            wg::stage_split(pipe.out, lo, rl, c, dza);
            if (gated) wg::stage_split(pipe.out, lo, rl, c + 64, dzb);
          } else {
            wg::stage_pair(pipe.out, rl, c, dza[0], dza[1]);
            if (gated) wg::stage_pair(pipe.out, rl, c + 64, dzb[0], dzb[1]);
          }
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
      if (!Dwc)
        wg::stage_end(pipe, &zab_map, n0, gated ? D + n0 : n0 + 64, r0 + 64 * w, bag,
                      X3 ? B + bag : -1);
    }
  }
  if (!Dwc) wg::stage_drain();
  wg::sync_consumers();
  for (int c = tid; c < D; c += wg::CONSUMERS) atomicAdd(&dwc[c], Wcs[c]);
}

// Backward pass 4: dz = drop/relu'(rnd(p gm^T) + rnd(dza @ Wa^T) +
// rnd(dzb @ Wb^T)) for each 128-row tile, 128 columns a pass, Wa and Wb
// read K-major as stored (a row of W^T is a column of W). bf16: the two
// products one after the other into two accumulators (rounded apart, as the
// twin rounds them); f32: both into one accumulator, each as three products
// of the planes (the [dza | dzb] planes as bags B .., W's lo planes at rows
// L1 ..), and dz out as its two planes. relu'(z) is read as xc > 0 from the
// scratch (f32: its hi plane, which is positive where xc is), loaded ahead
// of the products. The body of dx_wg (kLean) and dx_ablate_wg (kPreLean:
// dz = rnd(rnd(rnd(dx keep) scale) relu'), the keep 0 or 1; kLean2, bf16:
// dx = rnd(p gm + dza Wa^T + dzb Wb^T), both products in one accumulator as
// in f32).
#define DX_PARAMS(MAP)                                                                     \
  MAP dz_ab_map, MAP wa_map, MAP wb_map, MAP dz_map, const bf16 *__restrict__ xc,         \
      const float *__restrict__ p, const float *__restrict__ gm, Dropout dp, int gated,   \
      int stages, int B, int N, int L1, int D
#define DX_ARGS dz_ab_map, wa_map, wb_map, dz_map, xc, p, gm, dp, gated, stages, B, N, L1, D
template <typename T, int V>
__device__ __forceinline__ void dx_body(DX_PARAMS(BMAP)) {
  constexpr bool X3 = kX3<T>, One = X3 || V == kLean2;  // one accumulator
  constexpr int P = kPlanes<T>;
  extern __shared__ uint8_t smem_raw[];
  wg::Pipe pipe =
      wg::pipe_setup(smem_raw, P * (TILE_A + TILE_B), stages, 2 * P * wg::OUT_TILE, false);
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
              for (int pl = 0; pl < P; ++pl)
                wg::tma_load_3d(st + pl * TILE_A, &dz_ab_map, bar, g * D + k * BK, r0,
                                pl * B + bag);
              for (int pl = 0; pl < P; ++pl)
                wg::tma_load_2d(st + P * TILE_A + pl * TILE_B, g ? &wb_map : &wa_map, bar,
                                k * BK, pl * L1 + n0);
            }
      }
    else if (dp.on && threadIdx.x >= wg::PRODUCER + 32)
      bits_passes(pipe, dp.seed, dp.thresh, 0, false, BN, L1, B, N, dp.l1);
    return;
  }
  wg::consumer_regs();
  const int w = wg::wg_index();
  float* gms = reinterpret_cast<float*>(pipe.extra) + w * L1;  // L1 per warpgroup: gm of its bag
  const float scale = rnd<T>(dp.scale);
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
      if constexpr (X3) {
        wg::mainloop<0, 0, true>(pipe, nk, 0, 2 * TILE_A, acc_a, wg::NoPre{}, TILE_A,
                                 2 * TILE_A + TILE_B);
        if (gated)
          wg::mainloop<0, 0, true>(pipe, nk, 0, 2 * TILE_A, acc_a, wg::NoPre{}, TILE_A,
                                   2 * TILE_A + TILE_B, true);
      } else if constexpr (One) {
        wg::mainloop<0, 0>(pipe, nk, 0, TILE_A, acc_a, wg::NoPre{});
        if (gated) wg::mainloop<0, 0>(pipe, nk, 0, TILE_A, acc_a, wg::NoPre{}, 0, 0, true);
      } else {
        wg::mainloop<0, 0>(pipe, nk, 0, TILE_A, acc_a, wg::NoPre{});
        if (gated) wg::mainloop<0, 0>(pipe, nk, 0, TILE_A, acc_b, wg::NoPre{});
      }
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
            float dx;
            if constexpr (One) {
              dx = rnd<T>(__fadd_rn(__fmul_rn(pr[hh], gms[col + eb]), acc_a[e]));
            } else {
              dx = rnd<bf16>(
                  __fadd_rn(rnd<bf16>(__fmul_rn(pr[hh], gms[col + eb])), rnd<bf16>(acc_a[e])));
              if (gated) dx = rnd<bf16>(__fadd_rn(dx, rnd<bf16>(acc_b[e])));
            }
            const float x = eb ? __high2float(x2) : __low2float(x2);
            float mk;
            if (dp.on && V == kPreLean) {
              dx = kept<T, false>(dx, wg::bit(kb, e) ? 1.f : 0.f, scale);
              mk = x > 0.f ? 1.f : 0.f;
            } else if (dp.on) {
              mk = x > 0.f && wg::bit(kb, e) ? scale : 0.f;
            } else {
              mk = x > 0.f ? 1.f : 0.f;
            }
            out[eb] = rnd<T>(__fmul_rn(dx, mk));  // dead rows: xc = 0, so dz = 0
          }
          if constexpr (X3)
            wg::stage_split(pipe.out, pipe.out + 2 * wg::OUT_TILE, rl - 64 * w, c, out);
          else
            wg::stage_pair(pipe.out, rl - 64 * w, c, out[0], out[1]);
        }
      }
      wg::stage_end(pipe, &dz_map, n0, n0 + 64, r0 + 64 * w, bag, X3 ? B + bag : -1);
    }
  }
  wg::stage_drain();
}

}  // namespace
