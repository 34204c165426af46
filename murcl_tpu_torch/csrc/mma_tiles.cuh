// bf16 tensor-core tiles on Ampere's route, for K8's tiled_pool_tc
// (attention_tiled.cu): a 64-row x 128-column product over an A tile that
// sits in shared memory as bf16, with B streamed in 64-deep k-slices through
// a two-stage cp.async ring (a pass may prime the next pass's first slice);
// and the cp.async helpers that K4 (ntxent.cu) stages its tiles with.
//
// The route is mma.sync.m16n8k16 (bf16 in, f32 accumulate) fed by ldmatrix:
// K8's epilogue needs each accumulator's true (row, column) (the score is a
// row sum over the gates), and mma.sync's per-thread fragment layout is
// fixed and documented. Hopper's route (wgmma fed by TMA through an mbarrier
// ring, wgmma_tiles.cuh) carries K2/K3 and K7.
//
// Layout: 256 threads = 8 warps, 2 (rows) x 4 (columns), each warp a 32 x 32
// accumulator tile (2 m16 x 4 n8 fragments). Shared rows are padded by 8
// bf16 (a row stride of 16 mod 128 bytes), so the 8 row addresses of one
// ldmatrix fall in distinct bank groups. Everything sits in an anonymous
// namespace, as tiles.cuh does, so each source that includes it gets its own
// copy.
#pragma once

#include "common.cuh"

namespace {
namespace tc {

using bf16 = __nv_bfloat16;

constexpr int BM = 64;        // bag rows per block
constexpr int BN = 128;       // output columns per product pass
constexpr int KS = 64;        // depth of one staged k-slice of B
constexpr int STAGES = 2;     // cp.async ring depth
constexpr int PAD = 8;        // bf16 padding of every shared-memory row
constexpr int LDB = BN + PAD;
constexpr int THREADS = 256;
constexpr size_t RING_BYTES = sizeof(bf16) * STAGES * KS * LDB;
static_assert(STAGES == 2, "mma_pass alternates two ring stages");

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid.
__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(saddr(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(saddr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(saddr(p)));
}

// c += a (16 x 16, row) @ b (16 x 8, col); not volatile, so the compiler
// may interleave it with the next k-step's ldmatrix (which stay volatile,
// in order with the barriers)
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

using Acc = float[2][4][4];  // [m16 fragment][n8 fragment][element]

__device__ __forceinline__ int warp_m() { return threadIdx.x >> 7; }       // 0..1
__device__ __forceinline__ int warp_n() { return (threadIdx.x >> 5) & 3; }  // 0..3
// Row and column, in the warp's 32 x 32 tile, of accumulator element
// acc[mi][j][e] (the m16n8 C fragment: rows lane/4 and lane/4 + 8, columns
// 2 (lane % 4) and the next).
__device__ __forceinline__ int frag_row(int mi, int e) {
  return mi * 16 + ((threadIdx.x & 31) >> 2) + (e >> 1) * 8;
}
__device__ __forceinline__ int frag_col(int j, int e) {
  return j * 8 + (threadIdx.x & 3) * 2 + (e & 1);
}

__device__ __forceinline__ void zero(Acc& acc) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.f;
}

// The B of one pass: rows of row-major (K, ldb) bf16 matrices. Plain (p1
// null): 128 columns of p0 from n0. Paired: 64 columns of p0 and the same
// 64 of p1, so that one pass yields two products at the same columns; warp
// wn then holds p0's columns n0 + 16 wn .. + 15 in fragments 0-1 and p1's in
// fragments 2-3.
struct BSrc {
  const bf16* p0;
  const bf16* p1;
  int ldb, n0;
};

// Stage column of fragment pair jj (fragments 2 jj and 2 jj + 1).
__device__ __forceinline__ int pair_col(const BSrc& b, int jj) {
  return b.p1 ? jj * 64 + warp_n() * 16 : warp_n() * 32 + jj * 16;
}

__device__ __forceinline__ void load_b(const BSrc& b, int k0, bf16* st) {
  for (int e = threadIdx.x; e < KS * BN / 8; e += THREADS) {
    const int kk = e / (BN / 8), c = (e % (BN / 8)) * 8;
    const size_t row = (size_t)(k0 + kk) * b.ldb + b.n0;
    const bf16* src = (b.p1 && c >= 64) ? b.p1 + row + c - 64 : b.p0 + row + c;
    cp16(st + kk * LDB + c, src, true);
  }
}

// The B ring (STAGES = 2 k-slices of KS x LDB bf16) and which stage holds the
// next slice. A pass may prime the next pass's first slice while its own
// last slice is multiplied, so a block's passes run back to back.
struct Ring {
  bf16* buf;
  int stage;
  bool primed;
};

// Rows r0.. of a row-major (rows, cols) bf16 matrix into a shared tile of BM
// rows (row stride cols + PAD), asynchronously, zeros past `rows`; the
// caller commits the group (mma_pass waits for it).
__device__ __forceinline__ void load_rows(const bf16* __restrict__ src, int cols, int r0,
                                          int rows, bf16* tile) {
  const int cpr = cols / 8;
  for (int e = threadIdx.x; e < BM * cpr; e += THREADS) {
    const int r = e / cpr, c = (e % cpr) * 8;
    const bool ok = r0 + r < rows;
    cp16(tile + r * (cols + PAD) + c, src + (size_t)(ok ? r0 + r : 0) * cols + c, ok);
  }
}

// acc = A[BM x K] @ B[K x 128 columns of b]: A bf16 in shared memory with row
// stride lda (K % KS == 0). With TWO_A, a paired b's fragments 2-3 multiply
// A1 instead (two products of the same shape, kept apart). With ACCUM, the
// product adds to what acc holds. With a next (next.p0 set), the last k-step
// primes next's first slice. Every k-slice waits at a block barrier, so A may
// have been written (or its cp.async group committed) just before the call
// by any thread.
template <bool TWO_A = false, bool ACCUM = false>
__device__ __forceinline__ void mma_pass(const bf16* A, const bf16* A1, int lda, int K,
                                         const BSrc& b, const BSrc& next, Ring& ring, Acc& acc) {
  const int lane = threadIdx.x & 31, wm = warp_m();
  if (!ACCUM) zero(acc);
  const int nk = K / KS;
  if (!ring.primed) {
    load_b(b, 0, ring.buf + ring.stage * KS * LDB);
    cp_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    const int cur_st = (ring.stage + kt) & 1;
    cp_wait<0>();
    __syncthreads();  // slice kt landed; every warp is done with slice kt - 1
    bf16* other = ring.buf + (cur_st ^ 1) * KS * LDB;
    if (kt + 1 < nk)
      load_b(b, (kt + 1) * KS, other);
    else if (next.p0)
      load_b(next, 0, other);
    cp_commit();
    const bf16* st = ring.buf + cur_st * KS * LDB;
    // fragments double-buffered: k-step ks + 1's load is issued before ks's
    // products; af[.][jj]: the A of fragment pair jj
    uint32_t af[2][2][2][4], bq[2][2][4];
    auto frags = [&](int ks, uint32_t (&a)[2][2][4], uint32_t (&bb)[2][4]) {
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        if (jj == 1 && !TWO_A) break;
        const bf16* src = jj ? A1 : A;
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          ldsm_x4(a[jj][mi], src + (wm * 32 + mi * 16 + (lane & 15)) * lda + kt * KS +
                                 ks * 16 + (lane >> 4) * 8);
      }
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
        ldsm_x4_t(bb[jj], st + (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDB +
                              pair_col(b, jj) + (lane >> 4) * 8);
    };
    frags(0, af[0], bq[0]);
#pragma unroll
    for (int ks = 0; ks < KS / 16; ++ks) {
      const int cur = ks & 1;
      if (ks + 1 < KS / 16) frags(ks + 1, af[cur ^ 1], bq[cur ^ 1]);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int aj = TWO_A ? jj : 0;
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma(acc[mi][2 * jj], af[cur][aj][mi], bq[cur][jj][0], bq[cur][jj][1]);
          mma(acc[mi][2 * jj + 1], af[cur][aj][mi], bq[cur][jj][2], bq[cur][jj][3]);
        }
      }
    }
  }
  ring.stage = (ring.stage + nk) & 1;
  ring.primed = next.p0 != nullptr;
}

// ---------------------------------------------------------------------------
// K8's block layout: its BM-row A tile, then the ring, then small arrays
// from ring_end.
// ---------------------------------------------------------------------------
__device__ __forceinline__ bf16* ring_end(const Ring& ring) { return ring.buf + STAGES * KS * LDB; }

// Row sums kept per thread (rowp[mi][hh]: row frag_row(mi, 2 hh) of the
// warp's tile) -> the block's BM sums in red[r * 4 + warp_n]; read after a
// barrier.
__device__ __forceinline__ void row_partials(const float (&rowp)[2][2], float* red) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float v = rowp[mi][hh];
      v += __shfl_xor_sync(murcl::kFull, v, 1);  // over the 4 lanes of a row
      v += __shfl_xor_sync(murcl::kFull, v, 2);
      if ((threadIdx.x & 3) == 0) red[(warp_m() * 32 + frag_row(mi, 2 * hh)) * 4 + warp_n()] = v;
    }
}

// Gate column of element e of fragment j in a gate pass at n0: paired
// (gated; fragments 0-1 are a, 2-3 g at the same columns) or plain.
__device__ __forceinline__ int gate_col(int gated, int n0, int j, int e) {
  return gated ? n0 + warp_n() * 16 + frag_col(j & 1, e) : n0 + warp_n() * 32 + frag_col(j, e);
}

}  // namespace tc
}  // namespace
