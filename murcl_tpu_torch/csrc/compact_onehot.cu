// The one-hot compaction probes: K1's function computed as the TPU kernels
// compute it, a one-hot product per 128-row tile of a slide's window.
//
// Replaces the pallas_calls of the JAX package's TPU probes of its one-hot
// compaction: scripts/dbg_compact_ablate.py:160 (`fn` of build(mode), the
// kernel make_kernel :72-136: one bag per grid step) and the slide-grouped
// kernels of scripts/dbg_grouped_ablate.py:176 and dbg_grouped_gate.py:187
// (GROUP bags of one slide share each window chunk). The port's production
// compaction, K1 (compact.cu), is a row copy; these kernels time the
// formulation K1 replaced, variant by variant, beside it
// (murcl_tpu_torch/scripts/dbg_compact_ablate.py, dbg_grouped_ablate.py,
// dbg_grouped_gate.py; ops/compact_probes.py holds the twins). They are
// measurement probes, on no training path.
//
// Per bag (ranks: the kept patches' slots in patch order, -1 unkept), over
// the window's 128-row tiles t, with base the bag's kept count before t and
// base_al = min(128 floor(base / 128), F - 256): the one-hot slab
// oh[m][k] = (base_al + m == rank[128 t + k]) (256 x 128), prod = oh @
// rows_t in f32, acc[base_al .. base_al + 256] += prod rounded to the
// accumulator's type, and out = acc in bf16. Each slot gets its row from one
// tile (the ranks are unique), every other term is an exact zero, so out
// equals K1's bitwise.
//
// Design on the H100. One bag's f32 accumulator at D 512 is 2 MiB, against a
// block's 227 KB of shared memory, so a block owns a 64-column slice of D
// of one bag (or of one group of G bags) and keeps, per bag, a moving band
// of the accumulator: the slab's 256 rows, a ring of two 128-row halves. The
// ranks increase along the window, so base_al never falls; when it passes a
// half, that half's rows are final: the block writes them out (bf16) and
// zeroes the half for the rows 256 further on. A grid of (bags / G, D / 64)
// blocks of 288 threads: a producer warp, one thread of which copies each
// tile's 128 x 64 slice of the bank by TMA into a ring of 16 KB stages
// (128-byte swizzle), and two consumer warpgroups, each of which takes 128
// of the slab's rows: it writes its half of the one-hot slab into shared
// memory (K-major, swizzled as wgmma reads it), issues the products (wgmma
// m64n64k16: two m-blocks of 64 rows, 8 k-steps, the tile read MN-major as
// stored) into registers, and adds them into the band. Shared memory: the
// slab 64 KB, the band 64 KB per bag in f32 and 32 KB in bf16, the ring's
// stages (6 beside one f32 band, 2 beside the grouped kernels' four bf16
// bands). Each block reads its D slice of the window, so the window's bytes
// are read once in all, and writes each output element once.
//
// What each variant removes on this card (the scripts' names):
//   full      the formulation above: per tile and bag a compare of all 256 x
//             128 entries written to the slab, the products, and the band's
//             read-modify-write (RMW); the band f32 bag by bag, bf16 grouped
//             (the JAX grouped kernel accumulates in its bf16 output block).
//   normw     the products stored over the band's rows, not added: the RMW's
//             read half (another result; its twin defines it).
//   bf16acc   the band in bf16 (exact: a slot gets one nonzero term): half
//             the RMW's bytes and the band's shared memory.
//   leanoh    the tile's ones (at most 128) scattered into a zeroed slab at
//             (rank - base_al, k) and cleared after the products, instead of
//             the compare of all entries: the card's form of the TPU's
//             rebased compare.
//   bf16lean  bf16acc and leanoh together.
//   noonehot  a constant slab (row 0 all ones) built once: no compare; the
//             products and the RMW stay (another result: row base_al adds
//             the tile's column sums).
//   chunk16   the grouped window walked in chunks of 16 tiles, not 8. On the
//             TPU the chunk was the DMA unit; here the ring's stages carry
//             the copies and the chunk is only the unit of the liveness
//             gate and of the loop: the same work as full.
//   copy, nolive, noinner, nogate (the grouped gate script, chunks of 16):
//             the chunk-liveness gate (ch chunk < nump) is the chunks'
//             loop bound, the producer's and the consumers'; the per-tile
//             gate (tile_start < nump) a branch around a tile's work.
//   dmafloor  the window's rows read (each tile, as the TPU variant DMAs
//             them) and the first F written, tile by tile by TMA from a ring
//             in shared memory, by one thread a block (onehot_dmafloor).
// Bound on the H100 at the scripts' shape (1536 bags, windows of 2048 rows,
// F 1024, D 512, bf16): the function's bytes (K1's) 0.519 ms; the one-hot
// formulation's products, 1536 x 16 tiles x 2 x 256 x 128 x 512 = 825
// GFLOP, 0.83 ms at 989 TFLOP/s; dmafloor's own bytes, 3.22 GB of windows
// read and 1.61 GB written bag by bag (1.44 ms at 3.35 TB/s), 0.81 GB read
// grouped (0.72 ms).
#include "wgmma_tiles.cuh"

namespace {
namespace oh {

using wg::bf16;

constexpr int TILE = 128, SLAB = 256, DS = 64;  // tile rows, slab rows, a block's D slice
constexpr int CONSUMERS = 256, THREADS = 288, PRODUCER = 256;
constexpr int STAGE = TILE * DS * 2;  // a tile's D slice: two 64 x 64 boxes
constexpr int A_SLICE = SLAB * 128;   // a 64-deep k-slice of the slab: 256 rows of 128 bytes
constexpr int A_BYTES = 2 * A_SLICE;  // the slab, 256 x 128 bf16
constexpr int MAX_STAGES = 6, DMA_STAGES = 4;
constexpr int kCompare = 0, kScatter = 1, kConst = 2;  // how the slab is made
constexpr uint16_t kOne = 0x3F80;                      // bf16 1.0

struct Args {
  const int* ranks;     // (B, nmax) int32
  const int64_t* offs;  // (B,): the windows' first bank rows
  const int64_t* nump;  // (B,)
  bf16* out;            // (B, feat, D)
  int B, nmax, feat, D, slides, chunk_tiles, overwrite, tile_gate, live_gate;
};

// The small arrays ahead of the 1024-aligned buffers: the tile's ranks (G x
// 128 int16), their kept counts per 32 (G x 4 int) and the ring's barriers.
__host__ __device__ constexpr int small_bytes(int G) {
  return G * TILE * 2 + G * 4 * 4 + 2 * MAX_STAGES * 8;
}

// Bag j of group gi: the groups are (repeat / G, slides), bag (go G + j)
// slides + s the j-th of group (go, s); with G = 1 and slides = B, bag gi.
__device__ __forceinline__ int bag_of(const Args& a, int G, int gi, int j) {
  return ((gi / a.slides) * G + j) * a.slides + gi % a.slides;
}

// Byte offset of slab entry (m, k): K-major, two 64-deep k-slices, 128-byte
// swizzle (as TMA writes and wgmma reads a K-major operand, wgmma_tiles.cuh).
__device__ __forceinline__ int slab_at(int m, int k) {
  return (k >> 6) * A_SLICE + m * 128 + ((((k & 63) >> 3) ^ (m & 7)) << 4) + ((k & 7) << 1);
}

// The band: per bag SLAB ring rows of DS values, in 16-byte chunks swizzled
// by row, so that the accumulator fragments' read-modify-write and the
// flush's row reads meet few bank conflicts. pair(r, c): values (r, c) and
// (r, c + 1), c even; eight(r, ch): the values of columns 8 ch .. 8 ch + 7.
template <typename Acc>
struct Band;
template <>
struct Band<float> {
  __device__ static float* pair(float* b, int r, int c) {
    return b + r * DS + 4 * ((c >> 2) ^ ((r & 3) << 1)) + (c & 3);
  }
  __device__ static float* eight(float* b, int r, int ch) {
    return b + r * DS + 4 * ((2 * ch) ^ ((r & 3) << 1));
  }
  __device__ static uint4 to_bf16(const float* p) {  // 8 values rounded to bf16
    const float4 x = reinterpret_cast<const float4*>(p)[0], y = reinterpret_cast<const float4*>(p)[1];
    uint4 v;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
    h[0] = __floats2bfloat162_rn(x.x, x.y);
    h[1] = __floats2bfloat162_rn(x.z, x.w);
    h[2] = __floats2bfloat162_rn(y.x, y.y);
    h[3] = __floats2bfloat162_rn(y.z, y.w);
    return v;
  }
  __device__ static void zero8(float* p) {
    reinterpret_cast<float4*>(p)[0] = make_float4(0.f, 0.f, 0.f, 0.f);
    reinterpret_cast<float4*>(p)[1] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  // acc += (v0, v1), or = with `over` (normw)
  __device__ static void rmw(float* p, float v0, float v1, bool over) {
    float2* q = reinterpret_cast<float2*>(p);
    if (over) {
      *q = make_float2(v0, v1);
    } else {
      const float2 o = *q;
      *q = make_float2(__fadd_rn(o.x, v0), __fadd_rn(o.y, v1));
    }
  }
};
template <>
struct Band<bf16> {
  __device__ static bf16* pair(bf16* b, int r, int c) {
    return b + r * DS + 2 * ((c >> 1) ^ ((r & 7) << 2));
  }
  __device__ static bf16* eight(bf16* b, int r, int ch) { return b + r * DS + 8 * (ch ^ (r & 7)); }
  __device__ static uint4 to_bf16(const bf16* p) { return *reinterpret_cast<const uint4*>(p); }
  __device__ static void zero8(bf16* p) { *reinterpret_cast<uint4*>(p) = make_uint4(0u, 0u, 0u, 0u); }
  // acc = rnd(acc + rnd(v)), or rnd(v) with `over`
  __device__ static void rmw(bf16* p, float v0, float v1, bool over) {
    __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(p);
    const float r0 = murcl::rnd<bf16>(v0), r1 = murcl::rnd<bf16>(v1);
    if (over) {
      *q = __floats2bfloat162_rn(r0, r1);
    } else {
      const float2 o = __bfloat1622float2(*q);
      *q = __floats2bfloat162_rn(__fadd_rn(o.x, r0), __fadd_rn(o.y, r1));
    }
  }
};

// d (+)= A[64 x 16] @ B[16 x 64], A K-major, B MN-major (wgmma's transpose
// bit), from shared-memory descriptors.
__device__ __forceinline__ void mma64(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}
__device__ __forceinline__ void fence_acc(float (&d)[2][32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[0][i]), "+f"(d[1][i])::"memory");
}

// This warpgroup's two m-blocks of prod = slab @ tile (tile: the stage, its
// two 64-row boxes the two k-slices), into acc, completed on return.
__device__ __forceinline__ void products(const uint8_t* A, const uint8_t* st, float (&acc)[2][32]) {
  wg::wgmma_fence();
  fence_acc(acc);
#pragma unroll
  for (int mbl = 0; mbl < 2; ++mbl)
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const uint64_t da = wg::operand<0>(A + ks * A_SLICE + (2 * wg::wg_index() + mbl) * 8192);
      const uint64_t db = wg::operand<1>(st + ks * wg::BOX);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma64(acc[mbl], da + wg::kstep<0>(kk), db + wg::kstep<1>(kk), (ks | kk) != 0);
    }
  wg::wgmma_commit();
  fence_acc(acc);
  wg::wgmma_wait<0>();
  fence_acc(acc);
}

// Rows r0 .. r0 + 127 of a bag's band written to its output rows (bf16,
// columns d0 ..), and zeroed for the rows 256 further on.
template <typename Acc>
__device__ void flush_half(Acc* band, bf16* out, int r0, int D, int d0) {
  for (int i = threadIdx.x; i < 128 * 8; i += CONSUMERS) {
    const int r = r0 + (i >> 3), ch = i & 7;
    Acc* src = Band<Acc>::eight(band, r & (SLAB - 1), ch);
    *reinterpret_cast<uint4*>(out + (size_t)r * D + d0 + 8 * ch) = Band<Acc>::to_bf16(src);
    Band<Acc>::zero8(src);
  }
}

// Output rows r0 .. r1 - 1 (columns d0 ..) that no slab reached: zeros.
__device__ void zero_rows(bf16* out, int r0, int r1, int D, int d0) {
  for (int i = threadIdx.x; i < (r1 - r0) * 8; i += CONSUMERS)
    *reinterpret_cast<uint4*>(out + (size_t)(r0 + (i >> 3)) * D + d0 + 8 * (i & 7)) =
        make_uint4(0u, 0u, 0u, 0u);
}

// The tile's ranks of the group's bags into rk, and their kept counts per 32
// ranks into cnt (a warp's ballot).
template <int G>
__device__ __forceinline__ void stage_ranks(const Args& a, int gi, int t, int16_t* rk, int* cnt) {
  for (int e = threadIdx.x; e < G * TILE; e += CONSUMERS) {
    const int r = a.ranks[(size_t)bag_of(a, G, gi, e >> 7) * a.nmax + t * TILE + (e & 127)];
    rk[e] = (int16_t)r;
    const unsigned kept = __ballot_sync(murcl::kFull, r >= 0);
    if ((threadIdx.x & 31) == 0) cnt[e >> 5] = __popc(kept);
  }
}

// Row m of the slab (m = this thread, 0 .. 255) by the compare of all its
// 128 entries, oh[m][k] = (base_al + m == rank_k), in 16-byte chunks.
__device__ __forceinline__ void compare_row(uint8_t* A, const int16_t* rk, int base_al) {
  const int m = threadIdx.x, want = base_al + m;
#pragma unroll 4
  for (int ch = 0; ch < 16; ++ch) {
    const uint4 r8 = reinterpret_cast<const uint4*>(rk)[ch];  // ranks 8 ch .. 8 ch + 7
    const int16_t* r = reinterpret_cast<const int16_t*>(&r8);
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = (r[2 * i] == want ? (uint32_t)kOne : 0u) |
             (r[2 * i + 1] == want ? (uint32_t)kOne << 16 : 0u);
    *reinterpret_cast<uint4*>(A + slab_at(m, 8 * ch)) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

template <int G, typename Acc, int OH>
__global__ void __launch_bounds__(THREADS, 1)
onehot_wg(const __grid_constant__ CUtensorMap bank_map, const Args a, int stages) {
  extern __shared__ uint8_t smem_raw[];
  int16_t* rk = reinterpret_cast<int16_t*>(smem_raw);
  int* cnt = reinterpret_cast<int*>(rk + G * TILE);
  uint64_t* full = reinterpret_cast<uint64_t*>(cnt + G * 4);
  uint64_t* empty = full + MAX_STAGES;
  uint8_t* ring = smem_raw + small_bytes(G);
  ring += (1024 - (wg::saddr(ring) & 1023)) & 1023;
  uint8_t* A = ring + stages * STAGE;
  Acc* band = reinterpret_cast<Acc*>(A + A_BYTES);

  const int gi = blockIdx.x, d0 = blockIdx.y * DS;
  const int n_tiles = a.nmax / TILE, ct = a.chunk_tiles;
  const int n_chunks = (n_tiles + ct - 1) / ct;
  const int lead = bag_of(a, G, gi, 0);
  const long long nump = a.nump[lead], chunk_rows = (long long)ct * TILE;
  // the chunk-liveness gate: the chunks' loop bound
  const int live = a.live_gate ? (int)min((long long)n_chunks, (nump + chunk_rows - 1) / chunk_rows)
                               : n_chunks;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      wg::bar_init(&full[s], 1);
      wg::bar_init(&empty[s], CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {  // the producer warp: one thread copies the tiles
    if (threadIdx.x != PRODUCER) return;
    const int row0 = (int)a.offs[lead];
    int it = 0;
    for (int c = 0; c < live; ++c)
      for (int t = c * ct; t < min(n_tiles, (c + 1) * ct); ++t, ++it) {
        const int s = it % stages;
        wg::bar_wait(&empty[s], ((it / stages) & 1) ^ 1);
        wg::bar_expect(&full[s], STAGE);
        uint8_t* st = ring + s * STAGE;
        wg::tma_load_2d(st, &bank_map, &full[s], d0, row0 + t * TILE);
        wg::tma_load_2d(st + wg::BOX, &bank_map, &full[s], d0, row0 + t * TILE + 64);
      }
    return;
  }

  const int tid = threadIdx.x, lane = tid & 31;
  for (int i = tid; i < G * SLAB * DS * (int)sizeof(Acc) / 16; i += CONSUMERS)
    reinterpret_cast<uint4*>(band)[i] = make_uint4(0u, 0u, 0u, 0u);
  if (OH != kCompare) {
    for (int i = tid; i < A_BYTES / 16; i += CONSUMERS)
      reinterpret_cast<uint4*>(A)[i] = make_uint4(0u, 0u, 0u, 0u);
    wg::sync_consumers();
    if (OH == kConst && tid < TILE) *reinterpret_cast<uint16_t*>(A + slab_at(0, tid)) = kOne;
    wg::fence_async();
  }
  wg::sync_consumers();

  int base[G], lo[G];  // per bag: the kept count so far, the band's first row
#pragma unroll
  for (int j = 0; j < G; ++j) base[j] = lo[j] = 0;
  float acc[2][32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[0][i] = acc[1][i] = 0.f;
  const int g8 = lane >> 2, c2 = 2 * (lane & 3), wrow = 128 * wg::wg_index() + 16 * ((tid >> 5) & 3);
  int it = 0;
  for (int c = 0; c < live; ++c)
    for (int t = c * ct; t < min(n_tiles, (c + 1) * ct); ++t, ++it) {
      const int s = it % stages;
      wg::bar_wait(&full[s], (it / stages) & 1);
      // the per-tile gate: a branch around the tile's work
      if (!a.tile_gate || (long long)t * TILE < nump) {
        wg::sync_consumers();  // the last tile's reads of rk and cnt are done
        stage_ranks<G>(a, gi, t, rk, cnt);
        wg::sync_consumers();
        const uint8_t* st = ring + s * STAGE;
#pragma unroll 1
        for (int j = 0; j < G; ++j) {
          const int kept = cnt[4 * j] + cnt[4 * j + 1] + cnt[4 * j + 2] + cnt[4 * j + 3];
          const int base_al = min((base[j] >> 7) << 7, a.feat - SLAB);
          Acc* bj = band + j * SLAB * DS;
          bf16* oj = a.out + (size_t)bag_of(a, G, gi, j) * a.feat * a.D;
          while (lo[j] < base_al) {  // the half below base_al is final
            flush_half(bj, oj, lo[j], a.D, d0);
            wg::sync_consumers();
            lo[j] += 128;
          }
          int at = -1;  // leanoh: this thread's one in the slab
          if (OH == kCompare) {
            compare_row(A, rk + j * TILE, base_al);
            wg::fence_async();
            wg::sync_wg();  // a warpgroup's products read only its own 128 rows
          } else if (OH == kScatter) {
            if (tid < TILE) {
              const int m = rk[j * TILE + tid] - base_al;
              if (rk[j * TILE + tid] >= 0 && m >= 0 && m < SLAB) {
                at = slab_at(m, tid);
                *reinterpret_cast<uint16_t*>(A + at) = kOne;
              }
            }
            wg::fence_async();
            wg::sync_consumers();
          }
          products(A, st, acc);
          if (OH == kScatter) {
            wg::sync_consumers();  // both warpgroups' products have read the slab
            if (at >= 0) *reinterpret_cast<uint16_t*>(A + at) = 0;
          }
#pragma unroll
          for (int mbl = 0; mbl < 2; ++mbl)
#pragma unroll
            for (int j8 = 0; j8 < 8; ++j8)
#pragma unroll
              for (int hh = 0; hh < 2; ++hh) {
                const int r = (base_al + wrow + 64 * mbl + g8 + 8 * hh) & (SLAB - 1);
                Band<Acc>::rmw(Band<Acc>::pair(bj, r, 8 * j8 + c2), acc[mbl][4 * j8 + 2 * hh],
                               acc[mbl][4 * j8 + 2 * hh + 1], a.overwrite);
              }
          base[j] += kept;
        }
      }
      __syncwarp();
      if (lane == 0) wg::bar_arrive(&empty[s]);
    }
  wg::sync_consumers();
#pragma unroll 1
  for (int j = 0; j < G; ++j) {
    Acc* bj = band + j * SLAB * DS;
    bf16* oj = a.out + (size_t)bag_of(a, G, gi, j) * a.feat * a.D;
    flush_half(bj, oj, lo[j], a.D, d0);
    flush_half(bj, oj, lo[j] + 128, a.D, d0);
    zero_rows(oj, lo[j] + SLAB, a.feat, a.D, d0);
  }
}

// dmafloor: each tile of the group's window read by TMA into a ring, and
// those of the first F rows stored by TMA to each of the group's bags; one
// thread a block.
__global__ void __launch_bounds__(32)
onehot_dmafloor(const __grid_constant__ CUtensorMap bank_map,
                const __grid_constant__ CUtensorMap out_map, const Args a, int G) {
  extern __shared__ uint8_t smem_raw[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw);
  uint8_t* ring = smem_raw + 8 * DMA_STAGES;
  ring += (1024 - (wg::saddr(ring) & 1023)) & 1023;
  if (threadIdx.x != 0) return;
  for (int s = 0; s < DMA_STAGES; ++s) wg::bar_init(&full[s], 1);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  const int gi = blockIdx.x, d0 = blockIdx.y * DS, n_tiles = a.nmax / TILE;
  const int row0 = (int)a.offs[bag_of(a, G, gi, 0)];
  auto load = [&](int t) {
    const int s = t % DMA_STAGES;
    wg::bar_expect(&full[s], STAGE);
    wg::tma_load_2d(ring + s * STAGE, &bank_map, &full[s], d0, row0 + t * TILE);
    wg::tma_load_2d(ring + s * STAGE + wg::BOX, &bank_map, &full[s], d0, row0 + t * TILE + 64);
  };
  for (int t = 0; t < min(DMA_STAGES, n_tiles); ++t) load(t);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % DMA_STAGES;
    wg::bar_wait(&full[s], (t / DMA_STAGES) & 1);
    if (t * TILE < a.feat) {
      for (int j = 0; j < G; ++j) {
        const int bag = bag_of(a, G, gi, j);
        wg::tma_store_3d(&out_map, ring + s * STAGE, d0, t * TILE, bag);
        wg::tma_store_3d(&out_map, ring + s * STAGE + wg::BOX, d0, t * TILE + 64, bag);
      }
      wg::store_commit();
      wg::store_wait_read();  // the stage is free for the next load
    }
    if (t + DMA_STAGES < n_tiles) load(t + DMA_STAGES);
  }
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

template <int G, typename Acc, int OH>
int onehot_launch(const CUtensorMap& bank_map, const Args& a, cudaStream_t stream) {
  const size_t fixed = small_bytes(G) + 1024 + A_BYTES + (size_t)G * SLAB * DS * sizeof(Acc);
  const int stages = (int)std::min<size_t>(MAX_STAGES, (wg::SMEM_LIMIT - fixed) / STAGE);
  if (stages < 2) return (int)cudaErrorInvalidValue;
  const size_t smem = fixed + (size_t)stages * STAGE;
  MURCL_TRY(allow_smem(onehot_wg<G, Acc, OH>, smem));
  onehot_wg<G, Acc, OH><<<dim3(a.B / G, a.D / DS), THREADS, smem, stream>>>(bank_map, a, stages);
  return (int)cudaGetLastError();
}

}  // namespace oh
}  // namespace

// One variant of the one-hot compaction probes (ops/compact_probes.py):
// group G (1, or 4 bags of one slide sharing each window tile), the band's
// type (acc_bf16), how the slab is made (onehot: 0 the compare, 1 the
// scatter, 2 the constant), overwrite (normw), the per-tile and
// chunk-liveness gates, the chunk in tiles, or dmafloor. bank (rows, D)
// bf16, offs and nump (B,) int64, ranks (B, nmax) int32, out (B, feat, D)
// bf16; the groups (B / (G slides), slides). nmax % 128 == 0, feat % 128 ==
// 0 and >= 256, D % 64 == 0.
MURCL_API int murcl_compact_onehot(int group, int acc_bf16, int onehot, int overwrite,
                                   int tile_gate, int live_gate, int chunk_tiles, int dmafloor,
                                   const void* bank, long long bank_rows, const void* offs,
                                   const void* ranks, const void* nump, void* out, int B,
                                   int nmax, int feat, int D, int slides, void* stream) {
  using namespace oh;
  if (nmax % TILE || feat % TILE || feat < SLAB || D % DS || chunk_tiles < 1 || slides < 1 ||
      B % (group * slides) || (group != 1 && group != 4))
    return (int)cudaErrorInvalidValue;
  const Args a{(const int*)ranks, (const int64_t*)offs, (const int64_t*)nump, (bf16*)out,
               B, nmax, feat, D, slides, chunk_tiles, overwrite, tile_gate, live_gate};
  auto strm = (cudaStream_t)stream;
  CUtensorMap bm;
  MURCL_TRY((cudaError_t)wg::map2(&bm, bank, D, bank_rows, 64));
  if (dmafloor) {
    CUtensorMap om;
    MURCL_TRY((cudaError_t)wg::map3(&om, out, D, feat, B, 64));
    const size_t smem = 8 * DMA_STAGES + 1024 + (size_t)DMA_STAGES * STAGE;
    MURCL_TRY(allow_smem(onehot_dmafloor, smem));
    onehot_dmafloor<<<dim3(B / group, D / DS), 32, smem, strm>>>(bm, om, a, group);
    return (int)cudaGetLastError();
  }
  if (group == 1 && !acc_bf16 && onehot == kCompare) return onehot_launch<1, float, kCompare>(bm, a, strm);
  if (group == 1 && !acc_bf16 && onehot == kScatter) return onehot_launch<1, float, kScatter>(bm, a, strm);
  if (group == 1 && acc_bf16 && onehot == kCompare) return onehot_launch<1, bf16, kCompare>(bm, a, strm);
  if (group == 1 && acc_bf16 && onehot == kScatter) return onehot_launch<1, bf16, kScatter>(bm, a, strm);
  if (group == 4 && acc_bf16 && onehot == kCompare) return onehot_launch<4, bf16, kCompare>(bm, a, strm);
  if (group == 4 && acc_bf16 && onehot == kScatter) return onehot_launch<4, bf16, kScatter>(bm, a, strm);
  if (group == 4 && acc_bf16 && onehot == kConst) return onehot_launch<4, bf16, kConst>(bm, a, strm);
  return (int)cudaErrorInvalidValue;
}
