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
// The warpgroup kernels' bodies are in fused_trunk.cuh, shared with their
// ablations (fused_trunk_ablate.cu, the measurement probes), which this
// file's passes launch where fused_trunk_fwd_with's or
// fused_trunk_bwd_with's TrunkKernels name them.
#include "fused_trunk.cuh"

namespace {

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

// The flagged elements of the trunk, a warp per 32 (row, 128-column pass)
// entries of the masks: for each entry with a flag, the warp stages the
// bag's row, mixed as split_kernel mixes it, in shared memory, and for each
// flagged column Wf's column; then the warp takes z again as their dot
// product in float64, each lane a stride of the Fin terms (a product of two
// f32 values is exact there), the lanes' sums added by shuffles, and z + bf
// rounded to f32 once: its side of 0 is the exact product's wherever |z|
// exceeds about 1e-15. The f32 twin takes the same elements again in
// float64 (ops/attention.py _trunk_z), so the two agree on relu's side of 0:
// two f32 sums in different orders put a z of 2.7e-7 on different sides
// (one lane's chain of f32 multiply-adds from k = 0, this kernel's design
// before, against cuBLAS's f32 product at L1 200 and 256, moving dWf by
// 1.2e-4). Then xc = drop(relu(z + bf)) as the trunk's epilogue takes it,
// written over xc's two planes, so relu and the backward's relu' see that
// side of 0. A kernel of its own: in the epilogue each such 512-term
// product would hold its warpgroup for microseconds (the trunk ran at 31
// TFLOP/s so), and a thread an entry reading device memory took 4 ms a call
// at the main shape. With dpp, the pass's dp partial of the row gets the
// change of xc . gm from the lane that owns the entry, so dp stays a sum in
// a fixed order (no atomics on dh's path). 2 Fin floats of shared memory a
// warp.
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
        double sum = 0.0;
        for (int i = lane; i < Fin; i += 32) sum = fma((double)av[i], (double)bv[i], sum);
        for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(murcl::kFull, sum, o);
        if (lane != 0) continue;
        const float z = (float)(sum + (double)bf[col]);
        float x;
        if (dp.on) {
          const bool keep = murcl::dropout_bits(murcl::bag_key(dp.seed, bag, 0),
                                                (uint32_t)row * dp.l1 + col) >= dp.thresh;
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

template <typename T>
__global__ void __launch_bounds__(wg::THREADS, 1) trunk_wg(TRUNK_PARAMS(KMAP)) {
  trunk_body<T, kLean>(TRUNK_ARGS);
}
template <typename T>
__global__ void __launch_bounds__(wg::THREADS, 1) gates_fwd_wg(GATES_FWD_PARAMS(KMAP)) {
  gates_fwd_body<T, kLean>(GATES_FWD_ARGS);
}
template <typename T>
__global__ void __launch_bounds__(wg::THREADS, 1) gates_bwd_wg(GATES_BWD_PARAMS(KMAP)) {
  gates_bwd_body<T, kLean>(GATES_BWD_ARGS);
}
template <typename T>
__global__ void __launch_bounds__(wg::THREADS, 1) dx_wg(DX_PARAMS(KMAP)) {
  dx_body<T, kLean>(DX_ARGS);
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

// Launches the kernel at `fn`, or `proto` where fn is null, with `args`
// converted to proto's parameters: a pass's production kernel, or its
// ablation's (TrunkKernels) with the same parameters.
template <typename... P>
cudaError_t launch_wg(const void* fn, const Plan& pl, unsigned grid, cudaStream_t stream,
                      P... args) {
  const cudaError_t err = allow_smem(fn, pl.smem);
  if (err != cudaSuccess) return err;
  void* argv[] = {(void*)&args...};
  cudaLaunchKernel(fn, dim3(grid), dim3(wg::THREADS), argv, pl.smem, stream);
  return cudaGetLastError();
}
template <typename... P, typename... A>
cudaError_t launch_as(void (*proto)(P...), const void* fn, const Plan& pl, unsigned grid,
                      cudaStream_t stream, A... args) {
  return launch_wg<P...>(fn ? fn : (const void*)proto, pl, grid, stream, args...);
}

// bf16: hm the mixed bag's scratch (null unmixed), x3 unread. f32: hm the
// bags' planes (2, B, N, Fin), x3 the weights' planes and what refine
// reads (split_inputs), xc the trunk's planes (2, B, N, L1).
template <typename T>
int fwd_wg(const TrunkKernels& k, const void* h, const void* perm, const void* lam, const void* wf, const void* bf,
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
  MURCL_TRY(launch_as(&trunk_wg<T>, k.trunk, p1, grid, stream, hmap, wfm, hml, hst, xst,
                      mixed ? (const int64_t*)perm : nullptr, (const float*)lam,
                      (const float*)bf, dp, nullptr, nullptr, rf, p1.stages, B, N, Fin, L1));
  if (X3)
    MURCL_TRY(refine_launch(rf, perm, lam, bf, dp, xc, nullptr, nullptr, B, N, Fin, L1, stream));
  const Plan p2 = kplan<T>(2, 0, 3 * D);
  MURCL_TRY(launch_as(&gates_fwd_wg<T>, k.gates_fwd, p2, grid, stream, xm, wam, wbm,
                      (const float*)ba, (const float*)bb, (const T*)wc, (const float*)bc, dp,
                      gated, (float*)s, p2.stages, B, N, L1, D));
  return pool<bf16, X3>((const float*)s, (const uint8_t*)mask, (const bf16*)xc, (float*)m,
                        (float*)p, B, N, L1, stream);
}

// dzab: [dza | dzb] per row gated (row stride 2 D), dza ungated (D); dpp
// (L1 / 128, B, N) and ds (B, N) f32 scratch. bf16: hm the mixed bag's
// scratch (null unmixed: dWf then reads h itself), x3 unread. f32: hm, x3
// and xc as in fwd_wg, dzab and dz as their planes (2, B, N, .), dh f32.
// skip: the passes an ablation leaves out (kSkipWgrad, kSkipDx).
template <typename T>
int bwd_wg(const TrunkKernels& k, const void* h, const void* perm, const void* lam, const void* wf, const void* bf,
           const void* wa, const void* ba, const void* wb, const void* bb, const void* wc,
           void* x3, const void* mask, Dropout dp, int gated, const void* p, const void* gm,
           const void* gp, const void* gs, void* hm, void* xc, void* dpp, void* ds, void* dzab,
           void* dz, void* dh, void* dwf, void* dbf, void* dwa, void* dba, void* dwb, void* dbb,
           void* dwc, void* dbc, int B, int N, int Fin, int L1, int D, int skip,
           cudaStream_t stream) {
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
  MURCL_TRY(launch_as(&trunk_wg<T>, k.trunk, p1, grid, stream, hmap, wfm, hml, hst, xst,
                      mixed ? (const int64_t*)perm : nullptr, (const float*)lam,
                      (const float*)bf, dp, (const float*)gm, (float*)dpp, rf, p1.stages, B, N,
                      Fin, L1));
  if (X3)
    MURCL_TRY(refine_launch(rf, perm, lam, bf, dp, xc, gm, dpp, B, N, Fin, L1, stream));

  softmax_bwd_kernel<<<B, THREADS, 0, stream>>>((const float*)dpp, L1 / BN, (const float*)p,
                                                (const float*)gp, (const float*)gs,
                                                (const uint8_t*)mask, (float*)ds, (float*)dbc,
                                                B, N);
  MURCL_TRY(cudaGetLastError());

  const Plan p2 = kplan<T>(2, 2, 4 * D);
  MURCL_TRY(launch_as(&gates_bwd_wg<T>, k.gates_bwd, p2, grid, stream, xm, wam, wbm, zabst,
                      (const float*)ba, (const float*)bb, (const T*)wc, dp, gated,
                      (const float*)ds, (float*)dwc, p2.stages, B, N, L1, D));

  if (!(skip & kSkipDx)) {
    const Plan p3 = kplan<T>(2, 2, 2 * L1);
    MURCL_TRY(launch_as(&dx_wg<T>, k.dx, p3, grid, stream, zabm, wak, wbk, zst,
                        (const bf16*)xc, (const float*)p, (const float*)gm, dp, gated,
                        p3.stages, B, N, L1, D));
  }

  if (dh && !(skip & kSkipDx)) {
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
  if (!(skip & (kSkipWgrad | kSkipDx))) {
    const int err = wgrad_wg_launch<T>(X3 || mixed ? hm : h, Fin, dz, L1, R, (float*)dwf,
                                       nullptr, L1, L1, (float*)dbf, nullptr, stream);
    if (err) return err;
  }
  if (skip & kSkipWgrad) return 0;
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
// Fin) bytes. L1 and D are the kernels' widths (multiples of 128: the
// wrappers zero-pad the weights), L1l and Dl the logical ones, the dropout
// hash's row strides (Dropout).
MURCL_API int murcl_fused_trunk_fwd(TRUNK_FWD_API_PARAMS) {
  return fused_trunk_fwd_with(TrunkKernels{}, TRUNK_FWD_API_ARGS);
}

int fused_trunk_fwd_with(const TrunkKernels& k, TRUNK_FWD_API_PARAMS) {
  const Dropout dp{use_dropout, seed, thresh, scale, L1l, Dl};
  auto strm = (cudaStream_t)stream;
  if (is_bf16)
    return fwd_wg<bf16>(k, h, perm, lam, wf, bf, wa, ba, wb, bb, wc, bc, x3, mask, dp, gated, xc,
                        hm, m, p, s, B, N, Fin, L1, D, strm);
  return fwd_wg<float>(k, h, perm, lam, wf, bf, wa, ba, wb, bb, wc, bc, x3, mask, dp, gated, xc,
                       hm, m, p, s, B, N, Fin, L1, D, strm);
}

// dpv: the (L1 / 128 + 1, B, N) f32 scratch of dp partials, then ds; dzab
// the [dza | dzb] scratch and dz (see bwd_wg); hm, xc and x3 as in
// murcl_fused_trunk_fwd; dh (the bag dtype) null unless the bags' gradient
// is wanted.
MURCL_API int murcl_fused_trunk_bwd(TRUNK_BWD_API_PARAMS) {
  return fused_trunk_bwd_with(TrunkKernels{}, 0, TRUNK_BWD_API_ARGS);
}

int fused_trunk_bwd_with(const TrunkKernels& k, int skip, TRUNK_BWD_API_PARAMS) {
  const Dropout dp{use_dropout, seed, thresh, scale, L1l, Dl};
  auto strm = (cudaStream_t)stream;
  const int err = zero_grads(dwf, dbf, dwa, dba, dwb, dbb, dwc, dbc, Fin, L1, D, strm);
  if (err) return err;
  float* ds = (float*)dpv + (size_t)(L1 / BN) * B * N;
  if (is_bf16)
    return bwd_wg<bf16>(k, h, perm, lam, wf, bf, wa, ba, wb, bb, wc, x3, mask, dp, gated, p, gm,
                        gp, gs, hm, xc, dpv, ds, dzab, dz, dh, dwf, dbf, dwa, dba, dwb, dbb, dwc,
                        dbc, B, N, Fin, L1, D, skip, strm);
  return bwd_wg<float>(k, h, perm, lam, wf, bf, wa, ba, wb, bb, wc, x3, mask, dp, gated, p, gm,
                       gp, gs, hm, xc, dpv, ds, dzab, dz, dh, dwf, dbf, dwa, dba, dwb, dbb, dwc,
                       dbc, B, N, Fin, L1, D, skip, strm);
}
