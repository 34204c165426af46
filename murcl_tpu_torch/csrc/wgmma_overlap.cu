// Does CUDA-core work overlap a warpgroup product in flight? The overlap
// probe, four modes of one kernel.
//
// Replaces scripts/dbg_mxu_vpu_overlap.py's pallas_call (`run`, :96), the
// JAX package's TPU probe of whether independent MXU and VPU work overlap
// inside one program. Over `steps` tiles x_s, y_s (N, 512) bf16 and W (512,
// 512) bf16, in four modes:
//   mxu   m = rnd(m @ W) four times from m = x_s (warpgroup products);
//   vpu   v = rnd(tanh(v) sigmoid(v)) eight times from v = y_s, f32 math;
//   dep   vpu's chain on mxu's m;
//   indep both, independent, on the two consumer warpgroups side by side:
//         one issues the products while the other runs the chain (the
//         ping-pong's shape: one warpgroup's CUDA-core work beside the
//         other's warpgroup products in flight).
// Out: per step the f32 column sums of m and of v, m_out and v_out (steps,
// 512); vpu sums x_s's columns for m, mxu y_s's for v, as the TPU probe
// writes them. ops/overlap.py holds the plain twin (overlap_plain).
//
// Every mode splits the same way: consumer warpgroup 0 takes the products
// (mxu, dep, indep; vpu: x_s's column sums), warpgroup 1 the chain on y_s
// (vpu, indep; mxu: y_s's column sums; dep: nothing, as warpgroup 0 takes
// the chain on its products), so that mxu and vpu each time one side alone
// and indep both at once, and indep against the larger of the two says
// whether they overlap. A block takes whole steps, 128-row tiles in order,
// each column sum taken in one fixed order by one warpgroup's code: dep's
// m and mxu's, indep's m and v and mxu's m and vpu's v, are equal bit for
// bit. One producer thread, as in wgmma_tiles.cuh. A tile's m (128 x 512
// bf16, 128 KB) stays in shared memory as the products' A operand, in TMA's
// 128-byte swizzle (x_s's tile copied there by TMA, each product's result
// written back by warpgroup 0); W streams beside it through a ring of 16 KB
// k-slices (64 x 128, read MN-major as stored), 4 stages, once for each
// 64-row half of the tile, whose chain warpgroup 0 takes in turn. A product
// is four passes of 128 columns; the first pass's results wait in shared
// memory (the warpgroup's staging tile, in m's layout), the second's and
// third's in registers as bf16 pairs, until the fourth has read the last of
// m (three passes in registers spilled at the 168-register bound). The
// chain's column sums come from the accumulators (a warp's 16 rows by
// shuffles, the 4 warps through shared memory); the chain on y_s is taken
// by its owner threads, 4 columns and both halves' rows of a tile each, a
// row of each half at a time, the next loaded while they are worked.
// Bound on the H100 at the script's shape (256 steps of 1024 rows): mxu's
// products are 550 GFLOP, 0.556 ms at 989 TFLOP/s, and x, y (537 MB) take
// 0.160 ms at 3.35 TB/s; W's slices come from L2 (4 MB a tile). vpu reads
// the same bytes for about 3.2 G f32 operations (tanh, sigmoid and the
// product, eight rounds of 134 M values), 0.048 ms at 67 TFLOP/s: bytes.
#include "wgmma_tiles.cuh"

namespace {

using wg::bf16;
using wg::BK;
using wg::BM;
using wg::BN;
using wg::HALF_A;
using wg::TILE_A;
using wg::TILE_B;

constexpr int kMxu = 0, kVpu = 1, kDep = 2, kIndep = 3;
constexpr int DW = 512;               // the tiles' width, and W's
constexpr int SLICES = DW / BK;       // k-slices of a product
constexpr int PASSES = DW / BN;       // 128-column passes of a product
constexpr int PRODUCTS = 4, ROUNDS = 8;
constexpr int M_BYTES = SLICES * TILE_A;  // a tile's m: 128 KB
// before it, the product warpgroup's first pass of a product (64 x 128
// bf16, 16 KB; the chain warpgroup stages nothing)
constexpr int STAGING = wg::OUT_TILE + M_BYTES;
// the kernel's arrays: its two barriers, then f32 per-warp column partials
// (4 x 128 in use) and the step's column sums of m and v (512 each)
constexpr int EXTRA = 16 + 4 * (8 * BN + 2 * DW);

// rnd(tanh(v) sigmoid(v)), R times, in f32 math.
template <int R>
__device__ __forceinline__ float heavy(float v) {
#pragma unroll
  for (int r = 0; r < R; ++r) v = rnd<bf16>(__fmul_rn(tanhf(v), sigmoidf(v)));
  return v;
}

// This thread's 4 columns (4 tl ..) over 64 rows of a tile (a half), a row
// a step, the next row loaded ahead; each step adds heavy<R> of its 4
// values to the sums cs.
struct Rows {
  const bf16* p;
  int row;
  uint2 next;
  __device__ __forceinline__ void start(const bf16* base) {
    p = base;
    row = 0;
    next = __ldg(reinterpret_cast<const uint2*>(p));
  }
  template <int R>
  __device__ __forceinline__ void step(float (&cs)[4]) {
    const uint2 cur = next;
    if (++row < 64) next = __ldg(reinterpret_cast<const uint2*>(p + (size_t)row * DW));
    const __nv_bfloat162* v = reinterpret_cast<const __nv_bfloat162*>(&cur);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float2 f = __bfloat1622float2(v[i]);
      cs[2 * i] += heavy<R>(f.x);
      cs[2 * i + 1] += heavy<R>(f.y);
    }
  }
};

// A stage released by the product warpgroup alone: each of its 4 warps
// arrives for the 8 consumer warps the ring counts (wgmma_tiles.cuh).
__device__ __forceinline__ void release_stage(wg::Pipe& p, int it) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) {
    wg::bar_arrive(&p.empty[it % p.stages]);
    wg::bar_arrive(&p.empty[it % p.stages]);
  }
}

// acc = mh @ W[:, pass's 128 columns] over the ring's next SLICES stages, A
// the 64 rows of a half of m (mh: the half's rows in each k-slice), a stage
// released once the products that read it have completed, one behind.
__device__ __forceinline__ void product_pass(wg::Pipe& p, const uint8_t* mh, float (&acc)[64]) {
  for (int k = 0; k < SLICES; ++k) {
    const int s = p.it % p.stages;
    wg::bar_wait(&p.full[s], (p.it / p.stages) & 1);
    const uint64_t da = wg::operand<0>(mh + k * TILE_A);
    const uint64_t db = wg::operand<1>(p.base + s * p.stage_bytes);
    wg::wgmma_fence();
    wg::fence_acc(acc);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wg::mma<0, 1>(acc, da + wg::kstep<0>(kk), db + wg::kstep<1>(kk), (k | kk) != 0);
    wg::wgmma_commit();
    wg::fence_acc(acc);
    if (k > 0) {
      wg::wgmma_wait<1>();
      release_stage(p, p.it - 1);
    }
    ++p.it;
  }
  wg::wgmma_wait<0>();
  wg::fence_acc(acc);
  release_stage(p, p.it - 1);
}

__device__ __forceinline__ uint32_t pack(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float2 unpack(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

// Where element pair (j, hh) of this thread's pass sits in a K-major
// 64-column slice of this warpgroup's 64 rows (128-byte swizzle), column c of
// the pass's 128 in slice c / 64: as m's slices hold it, and the staging tile.
__device__ __forceinline__ int pair_at(int j, int hh) {
  const int rl = wg::frag_row(hh) - 64 * wg::wg_index(), c = wg::frag_col(j), cc = c & 63;
  return (c >> 6) * HALF_A + rl * 128 + (((cc >> 3) ^ (rl & 7)) << 4) + ((cc & 7) << 1);
}
// Pass q's rounded results (pairs of accumulator elements 4 j + 2 hh, + 1)
// into slices 2 q and 2 q + 1 of a half of m (mh), where the next product
// reads them as A.
__device__ __forceinline__ void write_back(uint8_t* mh, const uint32_t (&pairs)[32], int q) {
  uint8_t* base = mh + 2 * q * TILE_A;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int at = pair_at(j, hh);  // slice c / 64 is TILE_A on in m, HALF_A in the tile
      *reinterpret_cast<uint32_t*>(base + at + (at >= HALF_A ? TILE_A - HALF_A : 0)) =
          pairs[2 * j + hh];
    }
}

// Adds the column sums of a pass's 64 x 128 values (x: the product
// warpgroup's, in the accumulator's layout) to sums[q * 128 ..], in a fixed
// order: a warp's 16 rows by shuffles, then the 4 warps in turn through part.
__device__ __forceinline__ void frag_colsums(const float (&x)[64], float* part, float* sums, int q) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int eb = 0; eb < 2; ++eb) {
      float v = x[4 * j + eb] + x[4 * j + 2 + eb];
      v += __shfl_xor_sync(murcl::kFull, v, 4);  // over the lanes of a column
      v += __shfl_xor_sync(murcl::kFull, v, 8);
      v += __shfl_xor_sync(murcl::kFull, v, 16);
      if (lane < 4) part[warp * BN + wg::frag_col(j) + eb] = v;
    }
  wg::sync_wg();
  float t = 0.f;
  for (int wp = 0; wp < 4; ++wp) t += part[wp * BN + threadIdx.x];
  sums[q * BN + threadIdx.x] += t;
  wg::sync_wg();
}

// The last product's pass q: its m values summed by column, then, dep,
// heavy of them (in place) summed likewise.
template <int MODE>
__device__ __forceinline__ void final_sums(float (&vals)[64], float* part, float* colm,
                                           float* colv, int q) {
  frag_colsums(vals, part, colm, q);
  if constexpr (MODE == kDep) {
#pragma unroll
    for (int e = 0; e < 64; ++e) vals[e] = heavy<ROUNDS>(vals[e]);
    frag_colsums(vals, part, colv, q);
  }
}

// The product warpgroup's chain on one 64-row half of a tile's m: m =
// rnd(m @ W) PRODUCTS times, each written back over the half; the last
// product's column sums (and dep's chain on it) into colm (colv).
template <int MODE>
__device__ __forceinline__ void product_chain(wg::Pipe& pipe, uint8_t* mh, float* part,
                                              float* colm, float* colv) {
  for (int pr = 0; pr < PRODUCTS; ++pr) {
    uint32_t held[PASSES - 2][32];  // passes 1 and 2
    float acc[64];
#pragma unroll
    for (int q = 0; q < PASSES; ++q) {
      product_pass(pipe, mh, acc);
      if (q == 0)
#pragma unroll
        for (int i = 0; i < 32; ++i)
          *reinterpret_cast<uint32_t*>(pipe.out + pair_at(i >> 1, i & 1)) =
              pack(acc[2 * i], acc[2 * i + 1]);
      else if (q < PASSES - 1)
#pragma unroll
        for (int i = 0; i < 32; ++i) held[q - 1][i] = pack(acc[2 * i], acc[2 * i + 1]);
    }
    if (pr < PRODUCTS - 1) {  // m = rnd(m @ W), for the next product
      uint32_t last[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) last[i] = pack(acc[2 * i], acc[2 * i + 1]);
      wg::sync_wg();  // the warpgroup's products have read m; its first pass is staged
      // the first pass: the staging tile's two slices, 16 KB, as they are
      for (int i = threadIdx.x; i < wg::OUT_TILE / 16; i += 128) {
        const int box = i / (HALF_A / 16), at = i % (HALF_A / 16);
        reinterpret_cast<uint4*>(mh + box * TILE_A)[at] =
            reinterpret_cast<const uint4*>(pipe.out + box * HALF_A)[at];
      }
#pragma unroll
      for (int q = 1; q < PASSES - 1; ++q) write_back(mh, held[q - 1], q);
      write_back(mh, last, PASSES - 1);
      wg::fence_async();
      wg::sync_wg();
      continue;
    }
    // the last product: each pass's sums, pass 3 from acc, then 1 and 2
    // from registers, 0 from the staging tile
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[e] = rnd<bf16>(acc[e]);
    final_sums<MODE>(acc, part, colm, colv, PASSES - 1);
#pragma unroll
    for (int q = PASSES - 2; q >= 0; --q) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const float2 f = unpack(q > 0 ? held[q > 0 ? q - 1 : 0][i]
                                      : *reinterpret_cast<const uint32_t*>(
                                            pipe.out + pair_at(i >> 1, i & 1)));
        acc[2 * i] = f.x;
        acc[2 * i + 1] = f.y;
      }
      final_sums<MODE>(acc, part, colm, colv, q);
    }
  }
}

template <int MODE>
__global__ void __launch_bounds__(wg::THREADS, 1)
overlap_wg(const __grid_constant__ CUtensorMap x_map, const __grid_constant__ CUtensorMap w_map,
           const bf16* __restrict__ x, const bf16* __restrict__ y, float* __restrict__ m_out,
           float* __restrict__ v_out, int stages, int steps, int N) {
  constexpr bool MXU = MODE != kVpu;
  extern __shared__ uint8_t smem_raw[];
  // the ring, then as the pipe's staging the product warpgroup's first-pass
  // tile (its pipe.out) and m, then the barriers and arrays
  wg::Pipe pipe = wg::pipe_setup(smem_raw, TILE_B, stages, STAGING, false);
  uint8_t* m = pipe.base + stages * TILE_B + wg::OUT_TILE;
  uint64_t* mfull = reinterpret_cast<uint64_t*>(pipe.extra);  // x's tile landed in m
  uint64_t* mfree = mfull + 1;                                // warpgroup 0's 4 warps left m
  float* part = reinterpret_cast<float*>(mfree + 1);
  float *colm = part + 8 * BN, *colv = colm + DW;
  if (threadIdx.x == 0) {
    wg::bar_init(mfull, 1);
    wg::bar_init(mfree, 4);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int tiles = N / BM;
  if (wg::is_producer()) {
    wg::producer_regs();
    if (!MXU || threadIdx.x != wg::PRODUCER) return;
    int ord = 0;
    for (int s = blockIdx.x; s < steps; s += gridDim.x)
      for (int t = 0; t < tiles; ++t, ++ord) {
        wg::bar_wait(mfree, (ord & 1) ^ 1);
        wg::bar_expect(mfull, M_BYTES);
        for (int k = 0; k < SLICES; ++k)
          wg::tma_load_3d(m + k * TILE_A, &x_map, mfull, k * BK, t * BM, s);
        for (int h = 0; h < 2; ++h)  // W's slices for each half's chain
          for (int pr = 0; pr < PRODUCTS; ++pr)
            for (int q = 0; q < PASSES; ++q)
              for (int k = 0; k < SLICES; ++k) {
                uint64_t* bar;
                uint8_t* st = wg::produce(pipe, bar);
                wg::load_b_mn(st, &w_map, q * BN, &w_map, q * BN + 64, k * BK, bar);
              }
      }
    return;
  }
  wg::consumer_regs();
  const int tl = threadIdx.x & 127;
  if (wg::wg_index() == 1) {  // the chain warpgroup: y's chain (vpu, indep) or sums (mxu)
    if constexpr (MODE == kDep) return;
    constexpr int R = MODE == kMxu ? 0 : ROUNDS;  // mxu: y's sums alone
    for (int s = blockIdx.x; s < steps; s += gridDim.x) {
      float cs[2][4] = {};  // this thread's columns, over each half's rows
      for (int t = 0; t < tiles; ++t) {
        Rows r0, r1;
        r0.start(y + ((size_t)s * N + t * BM) * DW + 4 * tl);
        r1.start(y + ((size_t)s * N + t * BM + 64) * DW + 4 * tl);
        for (int r = 0; r < 64; ++r) {
          r0.step<R>(cs[0]);
          r1.step<R>(cs[1]);
        }
      }
      for (int i = 0; i < 4; ++i) v_out[(size_t)s * DW + 4 * tl + i] = cs[0][i] + cs[1][i];
    }
    return;
  }
  // the product warpgroup: the products (mxu, dep, indep) or x's sums (vpu)
  for (int c = tl; c < DW; c += 128) colm[c] = colv[c] = 0.f;
  wg::sync_wg();
  int ord = 0;
  for (int s = blockIdx.x; s < steps; s += gridDim.x) {
    float cs[2][4] = {};
    for (int t = 0; t < tiles; ++t, ++ord) {
      if constexpr (!MXU) {
        Rows r0, r1;
        r0.start(x + ((size_t)s * N + t * BM) * DW + 4 * tl);
        r1.start(x + ((size_t)s * N + t * BM + 64) * DW + 4 * tl);
        for (int r = 0; r < 64; ++r) {
          r0.step<0>(cs[0]);
          r1.step<0>(cs[1]);
        }
        continue;
      }
      wg::bar_wait(mfull, ord & 1);
      for (int h = 0; h < 2; ++h) product_chain<MODE>(pipe, m + h * HALF_A, part, colm, colv);
      wg::fence_async();  // the products' reads of m precede the next tile's copy
      __syncwarp();
      if ((threadIdx.x & 31) == 0) wg::bar_arrive(mfree);
    }
    wg::sync_wg();
    for (int i = 0; i < 4; ++i) {
      const int c = 4 * tl + i;
      m_out[(size_t)s * DW + c] = MXU ? colm[c] : cs[0][i] + cs[1][i];
      if (MODE == kDep) v_out[(size_t)s * DW + c] = colv[c];
      colm[c] = colv[c] = 0.f;
    }
    wg::sync_wg();
  }
}

template <int MODE>
int overlap_launch(const void* x, const void* y, const void* w, void* m_out, void* v_out,
                   int steps, int N, cudaStream_t stream) {
  CUtensorMap xm, wm;
  MURCL_TRY((cudaError_t)wg::map3(&xm, x, DW, N, steps, BM));
  MURCL_TRY((cudaError_t)wg::map2(&wm, w, DW, DW, BK));
  const Plan pl = plan(TILE_B, STAGING, EXTRA);
  MURCL_TRY(allow_smem(overlap_wg<MODE>, pl.smem));
  overlap_wg<MODE><<<persistent_grid(steps), wg::THREADS, pl.smem, stream>>>(
      xm, wm, (const bf16*)x, (const bf16*)y, (float*)m_out, (float*)v_out, pl.stages, steps, N);
  return (int)cudaGetLastError();
}

}  // namespace

// mode 0 mxu, 1 vpu, 2 dep, 3 indep; x, y (steps, N, 512) and w (512, 512)
// bf16, N a multiple of 128; m_out, v_out (steps, 512) f32.
MURCL_API int murcl_wgmma_overlap(int mode, const void* x, const void* y, const void* w,
                                  void* m_out, void* v_out, int steps, int N, void* stream) {
  if (N % BM || steps < 1) return (int)cudaErrorInvalidValue;
  auto strm = (cudaStream_t)stream;
  switch (mode) {
    case kMxu: return overlap_launch<kMxu>(x, y, w, m_out, v_out, steps, N, strm);
    case kVpu: return overlap_launch<kVpu>(x, y, w, m_out, v_out, steps, N, strm);
    case kDep: return overlap_launch<kDep>(x, y, w, m_out, v_out, steps, N, strm);
    case kIndep: return overlap_launch<kIndep>(x, y, w, m_out, v_out, steps, N, strm);
  }
  return (int)cudaErrorInvalidValue;
}
