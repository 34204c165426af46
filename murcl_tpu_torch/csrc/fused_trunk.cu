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
// after they are evaluated, as the TPU kernels do (nothing is rounded in
// f32); products accumulate in f32.
//
// Bound on the H100: at the main path's call (1536 bags x 1024 rows, 512 ->
// 512 -> 256; R = 1,572,864 rows) the products are 1.65 TFLOP forward and
// 4.13 TFLOP backward: 1.67 and 4.17 ms at 989 TFLOP/s in bf16, 3.33 and
// 8.34 ms at TF32's 495 TFLOP/s for f32 operands. One bf16 (R, 512) tensor
// is 1.61 GB (0.48 ms at 3.35 TB/s), an f32 one 3.22 GB. A bag does not fit
// a block's 227 KB of shared memory, and at 128-row tiles neither do a tile
// of the mixed bag and its xc together (128 KB each at Fin = L1 = 512 in
// bf16), so each pass below writes a scratch in device memory that the next
// reads back; M = p @ xc comes from pool_kernel (tiles.cuh), an exact
// softmax over the whole bag.
// Both dtypes run the same warpgroup kernels, templates on the bag dtype T:
// products (wgmma m64n128k16) over 128-row tiles, both operands copied by
// TMA into an mbarrier ring by one producer thread (wgmma_tiles.cuh),
// weights read as stored (wgmma's transpose bit, no transposed copies), one
// persistent kernel per pass (a block per SM walks the tiles, so its
// producer loads the next pass while its consumers finish an epilogue).
//  * bf16 (the training path with --compute_dtype bfloat16): a stage holds
//    a slice of each operand (32 KB; 48 KB with the mixup's partner slice),
//    5-6 stages (3 mixing). The mixed bag, xc, dza, dzb and dz are rounded
//    before they are stored, as the TPU kernel rounds them. The softmax
//    backward's bag sum c = sum_r p_r dp_r takes dp_r = xc_r . bf16(gm) +
//    gp_r from the trunk pass's per-128-column partials, summed in a fixed
//    order (so dh stays bitwise from run to run); c taken instead as
//    M . bf16(gm) + sum_r p_r gp_r from the forward's M, which would let the
//    gates follow the trunk with no pass between, missed the bf16 tolerance
//    on dbc (2.99e-2 > 2e-2 at N 100: M rounds p to bf16, and dbc sums the
//    near-cancelling p_r (dp_r - c)).
//    Device-memory bytes per pass at the main call (reads + writes, GB):
//      forward  trunk_wg 3.22 + 3.22 (h, h[perm]; xc and the mixed bag hm,
//               written once so that the later column passes read it back
//               instead of mixing again), gates_fwd_wg 1.61, pool_kernel
//               1.61: 9.66 GB (2.88 ms);
//      backward trunk_wg 3.22 + 3.22 (xc, hm), gates_bwd_wg 1.61 + 1.61
//               ([dza | dzb]), dx_wg 3.22 + 1.61 (dz), wgrad_wg dWf 3.22
//               and dWa + dWb 3.22 (one pass over xc against [dza | dzb]),
//               and 0.06 of dp partials and ds: 21.0 GB (6.26 ms).
//  * f32 (the default dtype of both CLIs and of the runbook, and the
//    heatmap's bags up to 3,072 padded patches): no f32 operand reaches the
//    tensor cores within the tolerance of 1e-4 (TF32 keeps 10 mantissa bits,
//    and its wgmma reads both operands K-major only, where the weights are
//    read as stored), so each f32 operand t goes to them as two bf16 planes,
//    hi = rnd(t) and lo = rnd(t - hi), and each product as three bf16
//    products hi hi + hi lo + lo hi into the one f32 accumulator (about
//    2^-16 relative; mainloop<.., X3>), a stage holding the hi and lo slices
//    of both operands (64 KB; 2-3 stages). split_kernel writes the planes of
//    the bags (mixed in f32 first: an f32 slice and its partner's take 64 KB
//    of a stage, so the trunk mixes nothing) and of Wf, Wa and Wb; each tile
//    that goes through device memory (xc, [dza | dzb], dz) is written by its
//    epilogue as its two planes; M = p @ (xc_hi + xc_lo) and dh in f32.
//    Device-memory bytes at the main call (GB): forward split_kernel 6.44 +
//    3.22 (h, h[perm]; the planes), trunk_wg 3.22 + 3.22, gates_fwd_wg 3.22,
//    pool_kernel 3.22: 22.5 GB (6.73 ms); backward split_kernel 9.66,
//    trunk_wg 6.44, gates_bwd_wg 6.44, dx_wg 3.22 + 1.61 + 3.22 (the
//    [dza | dzb] planes, xc's hi plane for relu', dz's planes), wgrad_wg
//    dWf 6.44 and dWa + dWb 6.44: 43.5 GB (13.0 ms).
// Each 16 KB weight slice that lands feeds 128 rows; the A slices are read
// again from L2 for each 128 columns of output (L1 / 128 times in the trunk,
// D / 64 times gated in the gates). A block is 384 threads: two consumer
// warpgroups of 64 rows and a producer warpgroup, whose other three warps
// mix the bags (bf16) and hash each pass's dropout keep bits ahead of its
// epilogue; the epilogues (tanh and sigmoid, the roundings) write their
// tiles through shared memory for TMA stores while the producer's copies
// proceed. Launches: the f32 route's split_kernel (the bags, then Wf, Wa,
// Wb) and wf_columns_kernel; the forward's trunk_wg (f32: refine_kernel),
// gates_fwd_wg and pool_kernel; the backward's trunk_wg (f32:
// refine_kernel), softmax_bwd_kernel, gates_bwd_wg, dx_wg (dh_wg with
// need_dh) and two wgrad_wg; the weight gradients add their row splits with
// f32 atomics.
// The gated flag is a runtime argument, uniform over the launch: ungated
// blocks skip the Wb products, dzb and dWb. Gate a keeps dropout stream 1 in
// both modes.
// Dropout keep bits come from a counter hash keyed by (seed, bag, stream,
// row, col) (common.cuh), so the backward regenerates the forward's masks.
#include "wgmma_tiles.cuh"

namespace {

struct Dropout {
  int on;
  uint32_t seed, thresh;
  float scale;  // 1 / (1 - rate) in f32; rounded to T at each use
};

using wg::bf16;
using wg::BK;
using wg::BM;
using wg::BN;
using wg::TILE_A;
using wg::TILE_B;

// Wf^T (L1, Fin) in f32 and the norms of Wf's columns, a warp a column.
__global__ void __launch_bounds__(256)
wf_columns_kernel(const float* __restrict__ wf, float* __restrict__ wft, float* __restrict__ cn,
                  int Fin, int L1) {
  const int c = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (c >= L1) return;
  float ss = 0.f;
  for (int i = lane; i < Fin; i += 32) {
    const float v = wf[(size_t)i * L1 + c];
    wft[(size_t)c * Fin + i] = v;
    ss = fmaf(v, v, ss);
  }
  ss = warp_sum(ss);
  if (lane == 0) cn[c] = sqrtf(ss);
}

// What the f32 trunk needs to take an element's z again in f32 (refine).
struct Refine {
  const float* h;    // the f32 bags (B, N, Fin)
  const float* wft;  // Wf^T (L1, Fin), f32
  const float* rn;   // (B, N): the norms of the (mixed) bags' rows
  const float* cn;   // (L1): the norms of Wf's columns
  uint32_t* mask;    // (B, N, L1 / 128, 4): the elements to take again
};

// The f32 route's inputs as planes: the (mixed) bags into hm (2, B, N, Fin);
// into the scratch x3 the weights' planes, Wf (2 Fin, L1), then Wa and Wb
// (2 L1, D) each (bf16), the refine masks (B N L1 / 32 words), then in f32
// the rows' norms (B N), Wf's columns' norms (L1) and Wf^T (L1 Fin). h and
// the weights then point at their planes, and rf at what refine reads.
int split_inputs(const void*& h, const void* perm, const void* lam, const void*& wf,
                 const void*& wa, const void*& wb, void* hm, void* x3, Refine& rf, int B,
                 int N, int Fin, int L1, int D, cudaStream_t stream) {
  const long long fl = (long long)Fin * L1, ld = (long long)L1 * D;
  bf16* wf2 = (bf16*)x3;
  bf16 *wa2 = wf2 + 2 * fl, *wb2 = wa2 + 2 * ld;
  uint32_t* mask = reinterpret_cast<uint32_t*>(wb2 + 2 * ld);
  float* rn = reinterpret_cast<float*>(mask + (size_t)B * N * (L1 / 32));
  float *cn = rn + (size_t)B * N, *wft = cn + L1;
  rf = {(const float*)h, wft, rn, cn, mask};
  MURCL_TRY(split(h, perm, lam, hm, rn, (long long)B * N, Fin, N, stream));
  MURCL_TRY(split(wf, nullptr, nullptr, wf2, nullptr, Fin, L1, Fin, stream));
  MURCL_TRY(split(wa, nullptr, nullptr, wa2, nullptr, L1, D, L1, stream));
  MURCL_TRY(split(wb, nullptr, nullptr, wb2, nullptr, L1, D, L1, stream));
  wf_columns_kernel<<<(L1 + 7) / 8, 256, 0, stream>>>((const float*)wf, wft, cn, Fin, L1);
  MURCL_TRY(cudaGetLastError());
  h = hm;
  wf = wf2;
  wa = wa2;
  wb = wb2;
  return 0;
}

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

// The flagged elements of the trunk, a warp per 32 (row, 128-column pass)
// entries of the masks: for each entry with a flag, the warp stages the
// bag's row, mixed as split_kernel mixes it, in shared memory, and for each
// flagged column Wf's column; then one lane takes z again as their f32 dot
// product, one fused multiply-add after another from k = 0, as an f32 matrix
// product accumulates (the twin's): a sum in another order rounds
// otherwise, and where |z| is about 1e-7 can land on the other side of 0
// than the twin's. Then xc = drop(relu(z + bf)) as the trunk's epilogue
// takes it, written over xc's two planes, so relu and the backward's relu'
// see the f32 product's side of 0. A kernel of its own: in the epilogue
// each such 512-term chain of loads would hold its warpgroup for
// microseconds (the trunk ran at 31 TFLOP/s so), and a thread an entry
// reading device memory took 4 ms a call at the main shape. With dpp, the
// pass's dp partial of the row gets the change of xc . gm from the lane
// that owns the entry, so dp stays a sum in a fixed order (no atomics on
// dh's path). 2 Fin floats of shared memory a warp.
constexpr int kRefineWarps = 4;

__global__ void __launch_bounds__(32 * kRefineWarps)
refine_kernel(Refine rf, const int64_t* __restrict__ perm, const float* __restrict__ lam,
              const float* __restrict__ bf, Dropout dp, bf16* __restrict__ xc,
              const float* __restrict__ gm, float* __restrict__ dpp, int B, int N, int Fin,
              int L1) {
  extern __shared__ float buf[];
  const int lane = threadIdx.x & 31;
  float* av = buf + (threadIdx.x >> 5) * 2 * Fin;  // this warp's row, then column
  float* bv = av + Fin;
  const int passes = L1 / BN;
  const long long total = (long long)B * N * passes;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const uint4 w4 = t < total ? reinterpret_cast<const uint4*>(rf.mask)[t] : make_uint4(0, 0, 0, 0);
  const size_t plane = (size_t)B * N * L1;
  for (unsigned todo = __ballot_sync(murcl::kFull, (w4.x | w4.y | w4.z | w4.w) != 0u); todo;
       todo &= todo - 1) {
    const int src = __ffs(todo) - 1;
    const uint32_t words[4] = {__shfl_sync(murcl::kFull, w4.x, src),
                               __shfl_sync(murcl::kFull, w4.y, src),
                               __shfl_sync(murcl::kFull, w4.z, src),
                               __shfl_sync(murcl::kFull, w4.w, src)};
    const long long entry = t - lane + src, rowg = entry / passes;
    const int pass = (int)(entry % passes), bag = (int)(rowg / N), row = (int)(rowg % N);
    const float* a = rf.h + rowg * Fin;
    const float* q = perm ? rf.h + ((long long)perm[bag] * N + row) * Fin : nullptr;
    const float l = perm ? lam[bag] : 1.f, o = 1.f - l;
    __syncwarp();  // the last entry's reads of av are done
    for (int i = lane; i < Fin; i += 32)
      av[i] = q ? __fadd_rn(__fmul_rn(l, a[i]), __fmul_rn(o, q[i])) : a[i];
    float delta = 0.f;
    for (int word = 0; word < 4; ++word)
      for (uint32_t bits = words[word]; bits; bits &= bits - 1) {
        const int bit = __ffs(bits) - 1;
        const int col = pass * BN + 8 * (bit >> 1) + 2 * word + (bit & 1);
        __syncwarp();  // the last column's reads of bv are done
        for (int i = lane; i < Fin; i += 32) bv[i] = rf.wft[(size_t)col * Fin + i];
        __syncwarp();
        if (lane != 0) continue;
        float sum = 0.f;
#pragma unroll 8  // shared-memory reads ahead of the chain of multiply-adds
        for (int i = 0; i < Fin; ++i) sum = fmaf(av[i], bv[i], sum);
        const float z = sum + bf[col];
        float x;
        if (dp.on) {
          const bool keep = murcl::dropout_bits(murcl::bag_key(dp.seed, bag, 0),
                                                (uint32_t)row * L1 + col) >= dp.thresh;
          x = __fmul_rn(z, z > 0.f && keep ? dp.scale : 0.f);
        } else {
          x = fmaxf(z, 0.f);
        }
        const size_t at = (size_t)rowg * L1 + col;
        const float old = __bfloat162float(xc[at]) + __bfloat162float(xc[plane + at]);
        const bf16 hi = __float2bfloat16_rn(x);
        xc[at] = hi;
        xc[plane + at] = __float2bfloat16_rn(x - __bfloat162float(hi));
        if (dpp) delta = fmaf(x - old, gm[(size_t)bag * L1 + col], delta);
      }
    if (dpp && lane == 0) dpp[((size_t)pass * B + bag) * N + row] += delta;
  }
}

cudaError_t refine_launch(const Refine& rf, const void* perm, const void* lam, const void* bf,
                          const Dropout& dp, void* xc, const void* gm, void* dpp, int B, int N,
                          int Fin, int L1, cudaStream_t stream) {
  const long long n = (long long)B * N * (L1 / BN);
  const int threads = 32 * kRefineWarps;
  const size_t smem = sizeof(float) * 2 * Fin * kRefineWarps;
  const cudaError_t err = allow_smem(refine_kernel, smem);
  if (err != cudaSuccess) return err;
  refine_kernel<<<(unsigned)((n + threads - 1) / threads), threads, smem, stream>>>(
      rf, (const int64_t*)perm, (const float*)lam, (const float*)bf, dp, (bf16*)xc,
      (const float*)gm, (float*)dpp, B, N, Fin, L1);
  return cudaGetLastError();
}

// The gates at one element, rounded to T where the TPU kernel rounds them:
// a = tanh(za), g = sigmoid(zb) (gated only), their keep scales ka, kb
// (from the keep bits, `scale` the keep scale in T), the kept a_eff, g_eff
// and u = a_eff * g_eff (or a_eff).
struct Gates {
  float a, ka, a_eff, g, kb, g_eff, u;
};
template <typename T>
__device__ __forceinline__ Gates gates_at(float za, float zb, int gated, bool drop, bool keep_a,
                                          bool keep_b, float scale) {
  Gates t{rnd<T>(tanhf(za)), 1.f, 0.f, 0.f, 1.f, 0.f, 0.f};
  t.a_eff = t.a;
  if (drop) {
    t.ka = keep_a ? scale : 0.f;
    t.a_eff = rnd<T>(__fmul_rn(t.a, t.ka));
  }
  t.u = t.a_eff;
  if (gated) {
    t.g = t.g_eff = rnd<T>(sigmoidf(zb));
    if (drop) {
      t.kb = keep_b ? scale : 0.f;
      t.g_eff = rnd<T>(__fmul_rn(t.g, t.kb));
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
// rnd(gm[bag, 128 c ..]).
template <typename T>
__global__ void __launch_bounds__(wg::THREADS, 1)
trunk_wg(const __grid_constant__ CUtensorMap h_map, const __grid_constant__ CUtensorMap wf_map,
         const __grid_constant__ CUtensorMap hm_map, const __grid_constant__ CUtensorMap hm_st,
         const __grid_constant__ CUtensorMap xc_map, const int64_t* __restrict__ perm,
         const float* __restrict__ lam, const float* __restrict__ bf, Dropout dp,
         const float* __restrict__ gm, float* __restrict__ dpp, Refine rf, int stages, int B,
         int N, int Fin, int L1) {
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
            if (dp.on) {
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
// at rows L1 ..).
template <typename T>
__global__ void __launch_bounds__(wg::THREADS, 1)
gates_fwd_wg(const __grid_constant__ CUtensorMap xc_map, const __grid_constant__ CUtensorMap wa_map,
             const __grid_constant__ CUtensorMap wb_map, const float* __restrict__ ba,
             const float* __restrict__ bb, const T* __restrict__ wc,
             const float* __restrict__ bc, Dropout dp, int gated, float* __restrict__ s_out,
             int stages, int B, int N, int L1, int D) {
  constexpr bool X3 = kX3<T>;
  constexpr int P = kPlanes<T>;
  extern __shared__ uint8_t smem_raw[];
  wg::Pipe pipe = wg::pipe_setup(smem_raw, P * (TILE_A + TILE_B), stages, 0, false);
  if (wg::is_producer()) {
    wg::producer_regs();
    if (threadIdx.x == wg::PRODUCER)
      produce_gates(pipe, &xc_map, &wa_map, &wb_map, gated, B, N, L1, D, X3);
    else if (dp.on && threadIdx.x >= wg::PRODUCER + 32)
      bits_passes(pipe, dp.seed, dp.thresh, 1, gated, gated ? 64 : BN, D, B, N);
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
            const Gates g = gates_at<T>(acc[e] + bas[col], gated ? acc[e + 32] + bbs[col] : 0.f,
                                        gated, dp.on, wg::bit(kb, e),
                                        wg::bit(kb, e + 32 * gated), scale);
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
// as bags B .. of zab_map) and dwc.
template <typename T>
__global__ void __launch_bounds__(wg::THREADS, 1)
gates_bwd_wg(const __grid_constant__ CUtensorMap xc_map, const __grid_constant__ CUtensorMap wa_map,
             const __grid_constant__ CUtensorMap wb_map,
             const __grid_constant__ CUtensorMap zab_map,
             const float* __restrict__ ba, const float* __restrict__ bb,
             const T* __restrict__ wc, Dropout dp, int gated, const float* __restrict__ ds,
             float* __restrict__ dwc, int stages, int B, int N, int L1, int D) {
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
      bits_passes(pipe, dp.seed, dp.thresh, 1, gated, gated ? 64 : BN, D, B, N);
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
      wg::stage_begin();
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
            const Gates g = gates_at<T>(acc[e] + bas[cc], gated ? acc[e + 32] + bbs[cc] : 0.f,
                                        gated, dp.on, wg::bit(kb, e),
                                        wg::bit(kb, e + 32 * gated), scale);
            wsum[eb] = fmaf(g.u, ds_t[hh], wsum[eb]);
            const float du = rnd<T>(__fmul_rn(ds_t[hh], wcs[cc]));
            float da = gated ? rnd<T>(__fmul_rn(du, g.g_eff)) : du;
            if (dp.on) da = rnd<T>(__fmul_rn(da, g.ka));
            dza[eb] = rnd<T>(__fmul_rn(da, rnd<T>(1.f - rnd<T>(__fmul_rn(g.a, g.a)))));
            dzb[eb] = 0.f;
            if (gated) {
              float dg = rnd<T>(__fmul_rn(du, g.a_eff));
              if (dp.on) dg = rnd<T>(__fmul_rn(dg, g.kb));
              dzb[eb] = rnd<T>(__fmul_rn(rnd<T>(__fmul_rn(dg, g.g)), rnd<T>(1.f - g.g)));
            }
          }
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
      wg::stage_end(pipe, &zab_map, n0, gated ? D + n0 : n0 + 64, r0 + 64 * w, bag,
                    X3 ? B + bag : -1);
    }
  }
  wg::stage_drain();
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
// of the products.
template <typename T>
__global__ void __launch_bounds__(wg::THREADS, 1)
dx_wg(const __grid_constant__ CUtensorMap dz_ab_map, const __grid_constant__ CUtensorMap wa_map,
      const __grid_constant__ CUtensorMap wb_map, const __grid_constant__ CUtensorMap dz_map,
      const bf16* __restrict__ xc, const float* __restrict__ p, const float* __restrict__ gm,
      Dropout dp, int gated, int stages, int B, int N, int L1, int D) {
  constexpr bool X3 = kX3<T>;
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
      bits_passes(pipe, dp.seed, dp.thresh, 0, false, BN, L1, B, N);
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
            if constexpr (X3) {
              dx = __fadd_rn(__fmul_rn(pr[hh], gms[col + eb]), acc_a[e]);
            } else {
              dx = rnd<bf16>(
                  __fadd_rn(rnd<bf16>(__fmul_rn(pr[hh], gms[col + eb])), rnd<bf16>(acc_a[e])));
              if (gated) dx = rnd<bf16>(__fadd_rn(dx, rnd<bf16>(acc_b[e])));
            }
            const float x = eb ? __high2float(x2) : __low2float(x2);
            float mk;
            if (dp.on)
              mk = x > 0.f && wg::bit(kb, e) ? scale : 0.f;
            else
              mk = x > 0.f ? 1.f : 0.f;
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

// The bags' gradient dh = dz @ Wf^T for each 128-row tile, 128 columns of
// Fin a pass, Wf read K-major as stored: bf16 rounded once (staged, stored by
// TMA); f32 from dz's and Wf's planes (lo as bags B .. of dz_map, at rows
// Fin .. of wf_map), written as f32 straight from the accumulators to dh32.
template <typename T>
__global__ void __launch_bounds__(wg::THREADS, 1)
dh_wg(const __grid_constant__ CUtensorMap dz_map, const __grid_constant__ CUtensorMap wf_map,
      const __grid_constant__ CUtensorMap dh_map, float* __restrict__ dh32, int stages, int B,
      int N, int Fin, int L1) {
  constexpr bool X3 = kX3<T>;
  constexpr int P = kPlanes<T>;
  extern __shared__ uint8_t smem_raw[];
  wg::Pipe pipe =
      wg::pipe_setup(smem_raw, P * (TILE_A + TILE_B), stages, X3 ? 0 : 2 * wg::OUT_TILE, false);
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
            for (int pl = 0; pl < P; ++pl)
              wg::tma_load_3d(st + pl * TILE_A, &dz_map, bar, k * BK, r0, pl * B + bag);
            for (int pl = 0; pl < P; ++pl)
              wg::tma_load_2d(st + P * TILE_A + pl * TILE_B, &wf_map, bar, k * BK,
                              pl * Fin + n0);
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
      wg::mainloop<0, 0, X3>(pipe, nk, 0, P * TILE_A, acc, wg::NoPre{}, TILE_A,
                             2 * TILE_A + TILE_B);
      if constexpr (X3) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = r0 + wg::frag_row(hh);
          if (row >= N) continue;
          float* o = dh32 + ((size_t)bag * N + row) * Fin + n0;
#pragma unroll
          for (int j = 0; j < 16; ++j)
            *reinterpret_cast<float2*>(o + wg::frag_col(j)) =
                make_float2(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
        }
      } else {
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
  }
  wg::stage_drain();
}

// A K2/K3 kernel's launch plan (ops/attention.py trunk_plans mirrors it): a
// stage holds `slices` 16 KB slices (T = float: each as two planes), beside
// `staged` 16 KB output tiles (two planes each) and `floats` f32 arrays; at
// least 3 stages in bf16, 2 in f32.
template <typename T>
Plan kplan(int slices, int staged, int floats) {
  constexpr int P = kPlanes<T>;
  return plan(P * slices * TILE_A, P * staged * wg::OUT_TILE, sizeof(float) * floats,
              P == 2 ? 2 : 3);
}

// bf16: hm the mixed bag's scratch (null unmixed), x3 unread. f32: hm the
// bags' planes (2, B, N, Fin), x3 the weights' planes and what refine
// reads (split_inputs), xc the trunk's planes (2, B, N, L1).
template <typename T>
int fwd_wg(const void* h, const void* perm, const void* lam, const void* wf, const void* bf,
           const void* wa, const void* ba, const void* wb, const void* bb, const void* wc,
           const void* bc, void* x3, const void* mask, Dropout dp, int gated, void* xc, void* hm,
           void* m, void* p, void* s, int B, int N, int Fin, int L1, int D,
           cudaStream_t stream) {
  constexpr bool X3 = kX3<T>;
  constexpr int P = kPlanes<T>;
  const unsigned grid = persistent_grid((long long)((N + BM - 1) / BM) * B);
  const bool mixed = !X3 && perm != nullptr;
  Refine rf{};
  if (X3) {
    const int err = split_inputs(h, perm, lam, wf, wa, wb, hm, x3, rf, B, N, Fin, L1, D, stream);
    if (err) return err;
  }
  CUtensorMap hmap, wfm, hml, hst, xm, xst, wam, wbm;
  MURCL_TRY((cudaError_t)wg::map3(&hmap, h, Fin, N, P * B, BM));
  MURCL_TRY((cudaError_t)wg::map3(&hml, mixed ? hm : h, Fin, N, B, BM));
  MURCL_TRY((cudaError_t)wg::map3(&hst, mixed ? hm : h, Fin, N, B, 64));
  MURCL_TRY((cudaError_t)wg::map2(&wfm, wf, L1, P * Fin, BK));
  MURCL_TRY((cudaError_t)wg::map3(&xm, xc, L1, N, P * B, BM));
  MURCL_TRY((cudaError_t)wg::map3(&xst, xc, L1, N, P * B, 64));
  MURCL_TRY((cudaError_t)wg::map2(&wam, wa, D, P * L1, BK));
  MURCL_TRY((cudaError_t)wg::map2(&wbm, wb, D, P * L1, BK));
  const Plan p1 = kplan<T>(mixed ? 3 : 2, 2, (X3 ? 4 : 3) * L1);
  MURCL_TRY(allow_smem(trunk_wg<T>, p1.smem));
  trunk_wg<T><<<grid, wg::THREADS, p1.smem, stream>>>(
      hmap, wfm, hml, hst, xst, mixed ? (const int64_t*)perm : nullptr, (const float*)lam,
      (const float*)bf, dp, nullptr, nullptr, rf, p1.stages, B, N, Fin, L1);
  MURCL_TRY(cudaGetLastError());
  if (X3) MURCL_TRY(refine_launch(rf, perm, lam, bf, dp, xc, nullptr, nullptr, B, N, Fin, L1, stream));
  const Plan p2 = kplan<T>(2, 0, 3 * D);
  MURCL_TRY(allow_smem(gates_fwd_wg<T>, p2.smem));
  gates_fwd_wg<T><<<grid, wg::THREADS, p2.smem, stream>>>(
      xm, wam, wbm, (const float*)ba, (const float*)bb, (const T*)wc, (const float*)bc, dp,
      gated, (float*)s, p2.stages, B, N, L1, D);
  MURCL_TRY(cudaGetLastError());
  return pool<bf16, X3>((const float*)s, (const uint8_t*)mask, (const bf16*)xc, (float*)m,
                        (float*)p, B, N, L1, stream);
}

// dzab: [dza | dzb] per row gated (row stride 2 D), dza ungated (D); dpp
// (L1 / 128, B, N) and ds (B, N) f32 scratch. bf16: hm the mixed bag's
// scratch (null unmixed: dWf then reads h itself), x3 unread. f32: hm, x3
// and xc as in fwd_wg, dzab and dz as their planes (2, B, N, .), dh f32.
template <typename T>
int bwd_wg(const void* h, const void* perm, const void* lam, const void* wf, const void* bf,
           const void* wa, const void* ba, const void* wb, const void* bb, const void* wc,
           void* x3, const void* mask, Dropout dp, int gated, const void* p, const void* gm,
           const void* gp, const void* gs, void* hm, void* xc, void* dpp, void* ds, void* dzab,
           void* dz, void* dh, void* dwf, void* dbf, void* dwa, void* dba, void* dwb, void* dbb,
           void* dwc, void* dbc, int B, int N, int Fin, int L1, int D, cudaStream_t stream) {
  constexpr bool X3 = kX3<T>;
  constexpr int P = kPlanes<T>;
  const unsigned grid = persistent_grid((long long)((N + BM - 1) / BM) * B);
  const int ldz = gated ? 2 * D : D;
  const bool mixed = !X3 && perm != nullptr;
  Refine rf{};
  if (X3) {
    const int err = split_inputs(h, perm, lam, wf, wa, wb, hm, x3, rf, B, N, Fin, L1, D, stream);
    if (err) return err;
  }
  CUtensorMap hmap, wfm, hml, hst, xm, xst, wam, wbm, zabm, zabst, wak, wbk, zst;
  MURCL_TRY((cudaError_t)wg::map3(&hmap, h, Fin, N, P * B, BM));
  MURCL_TRY((cudaError_t)wg::map2(&wfm, wf, L1, P * Fin, BK));
  MURCL_TRY((cudaError_t)wg::map3(&hml, mixed ? hm : h, Fin, N, B, BM));
  MURCL_TRY((cudaError_t)wg::map3(&hst, mixed ? hm : h, Fin, N, B, 64));
  MURCL_TRY((cudaError_t)wg::map3(&xm, xc, L1, N, P * B, BM));
  MURCL_TRY((cudaError_t)wg::map3(&xst, xc, L1, N, P * B, 64));
  MURCL_TRY((cudaError_t)wg::map2(&wam, wa, D, P * L1, BK));
  MURCL_TRY((cudaError_t)wg::map2(&wbm, wb, D, P * L1, BK));
  MURCL_TRY((cudaError_t)wg::map3(&zabm, dzab, ldz, N, P * B, BM));
  MURCL_TRY((cudaError_t)wg::map3(&zabst, dzab, ldz, N, P * B, 64));
  MURCL_TRY((cudaError_t)wg::map2(&wak, wa, D, P * L1, BN));
  MURCL_TRY((cudaError_t)wg::map2(&wbk, wb, D, P * L1, BN));
  MURCL_TRY((cudaError_t)wg::map3(&zst, dz, L1, N, P * B, 64));

  const Plan p1 = kplan<T>(mixed ? 3 : 2, 2, (X3 ? 4 : 3) * L1);
  MURCL_TRY(allow_smem(trunk_wg<T>, p1.smem));
  trunk_wg<T><<<grid, wg::THREADS, p1.smem, stream>>>(
      hmap, wfm, hml, hst, xst, mixed ? (const int64_t*)perm : nullptr, (const float*)lam,
      (const float*)bf, dp, (const float*)gm, (float*)dpp, rf, p1.stages, B, N, Fin, L1);
  MURCL_TRY(cudaGetLastError());
  if (X3) MURCL_TRY(refine_launch(rf, perm, lam, bf, dp, xc, gm, dpp, B, N, Fin, L1, stream));

  softmax_bwd_kernel<<<B, THREADS, 0, stream>>>((const float*)dpp, L1 / BN, (const float*)p,
                                                (const float*)gp, (const float*)gs,
                                                (const uint8_t*)mask, (float*)ds, (float*)dbc,
                                                B, N);
  MURCL_TRY(cudaGetLastError());

  const Plan p2 = kplan<T>(2, 2, 4 * D);
  MURCL_TRY(allow_smem(gates_bwd_wg<T>, p2.smem));
  gates_bwd_wg<T><<<grid, wg::THREADS, p2.smem, stream>>>(
      xm, wam, wbm, zabst, (const float*)ba, (const float*)bb, (const T*)wc, dp, gated,
      (const float*)ds, (float*)dwc, p2.stages, B, N, L1, D);
  MURCL_TRY(cudaGetLastError());

  const Plan p3 = kplan<T>(2, 2, 2 * L1);
  MURCL_TRY(allow_smem(dx_wg<T>, p3.smem));
  dx_wg<T><<<grid, wg::THREADS, p3.smem, stream>>>(zabm, wak, wbk, zst, (const bf16*)xc,
                                                   (const float*)p, (const float*)gm, dp, gated,
                                                   p3.stages, B, N, L1, D);
  MURCL_TRY(cudaGetLastError());

  if (dh) {
    CUtensorMap zm, wfk, dhst;
    MURCL_TRY((cudaError_t)wg::map3(&zm, dz, L1, N, P * B, BM));
    MURCL_TRY((cudaError_t)wg::map2(&wfk, wf, L1, P * Fin, BN));
    dhst = zm;  // f32 writes dh from the accumulators
    if (!X3) MURCL_TRY((cudaError_t)wg::map3(&dhst, dh, Fin, N, B, 64));
    const Plan p4 = kplan<T>(2, X3 ? 0 : 2, 0);
    MURCL_TRY(allow_smem(dh_wg<T>, p4.smem));
    dh_wg<T><<<grid, wg::THREADS, p4.smem, stream>>>(zm, wfk, dhst, X3 ? (float*)dh : nullptr,
                                                     p4.stages, B, N, Fin, L1);
    MURCL_TRY(cudaGetLastError());
  }

  const long long R = (long long)B * N;
  int err = wgrad_wg_launch<T>(X3 || mixed ? hm : h, Fin, dz, L1, R, (float*)dwf, nullptr, L1,
                               L1, (float*)dbf, nullptr, stream);
  if (err) return err;
  return wgrad_wg_launch<T>(xc, L1, dzab, ldz, R, (float*)dwa, (float*)dwb, D, D, (float*)dba,
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

}  // namespace

// Scratch (see fwd_wg). bf16 bags: xc (B, N, L1), hm the mixed bag (B, N,
// Fin) when mixed, else null, x3 null. f32 bags: xc (2, B, N, L1) and hm (2,
// B, N, Fin) bf16, x3 4 (Fin L1 + 2 L1 D) + B N L1 / 8 + 4 (B N + L1 + L1
// Fin) bytes.
MURCL_API int murcl_fused_trunk_fwd(int is_bf16, int gated, const void* h, const void* perm,
                                    const void* lam, const void* wf, const void* bf,
                                    const void* wa, const void* ba, const void* wb,
                                    const void* bb, const void* wc, const void* bc, void* x3,
                                    const void* mask, int use_dropout, uint32_t seed,
                                    uint32_t thresh, float scale, void* xc, void* hm, void* m,
                                    void* p, void* s, int B, int N, int Fin, int L1, int D,
                                    void* stream) {
  const Dropout dp{use_dropout, seed, thresh, scale};
  auto strm = (cudaStream_t)stream;
  if (is_bf16)
    return fwd_wg<bf16>(h, perm, lam, wf, bf, wa, ba, wb, bb, wc, bc, x3, mask, dp, gated, xc,
                        hm, m, p, s, B, N, Fin, L1, D, strm);
  return fwd_wg<float>(h, perm, lam, wf, bf, wa, ba, wb, bb, wc, bc, x3, mask, dp, gated, xc, hm,
                       m, p, s, B, N, Fin, L1, D, strm);
}

// dpv: the (L1 / 128 + 1, B, N) f32 scratch of dp partials, then ds; dzab
// the [dza | dzb] scratch and dz (see bwd_wg); hm, xc and x3 as in
// murcl_fused_trunk_fwd; dh (the bag dtype) null unless the bags' gradient
// is wanted.
MURCL_API int murcl_fused_trunk_bwd(
    int is_bf16, int gated, const void* h, const void* perm, const void* lam, const void* wf,
    const void* bf, const void* wa, const void* ba, const void* wb, const void* bb,
    const void* wc, void* x3, const void* mask, int use_dropout, uint32_t seed, uint32_t thresh,
    float scale, const void* p, const void* gm, const void* gp, const void* gs, void* hm,
    void* xc, void* dpv, void* dzab, void* dz, void* dh, void* dwf, void* dbf, void* dwa,
    void* dba, void* dwb, void* dbb, void* dwc, void* dbc, int B, int N, int Fin, int L1, int D,
    void* stream) {
  const Dropout dp{use_dropout, seed, thresh, scale};
  auto strm = (cudaStream_t)stream;
  const int err = zero_grads(dwf, dbf, dwa, dba, dwb, dbb, dwc, dbc, Fin, L1, D, strm);
  if (err) return err;
  float* ds = (float*)dpv + (size_t)(L1 / BN) * B * N;
  if (is_bf16)
    return bwd_wg<bf16>(h, perm, lam, wf, bf, wa, ba, wb, bb, wc, x3, mask, dp, gated, p, gm, gp,
                        gs, hm, xc, dpv, ds, dzab, dz, dh, dwf, dbf, dwa, dba, dwb, dbb, dwc,
                        dbc, B, N, Fin, L1, D, strm);
  return bwd_wg<float>(h, perm, lam, wf, bf, wa, ba, wb, bb, wc, x3, mask, dp, gated, p, gm, gp,
                       gs, hm, xc, dpv, ds, dzab, dz, dh, dwf, dbf, dwa, dba, dwb, dbb, dwc, dbc,
                       B, N, Fin, L1, D, strm);
}
