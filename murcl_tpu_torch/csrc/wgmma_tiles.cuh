// Hopper tile machinery for the kernels of K2/K3 (fused_trunk.cu) and K7
// (attention_pool.cu), bf16 and f32: warpgroup products
// (wgmma.mma_async m64n128k16, bf16 in, f32 accumulate) over operands that
// the Tensor Memory Accelerator (TMA) copies into a ring of shared-memory
// stages, each guarded by a pair of mbarriers. An f32 operand t reaches
// the tensor cores as two bf16 planes, hi = rnd(t) and lo = rnd(t - hi),
// and an f32 product as three bf16 products hi hi + hi lo + lo hi into one
// accumulator (about 2^-16 relative; `mainloop` with X3).
//
// A block is BM = 128 rows: two consumer warpgroups of 64 rows each, and a
// producer warpgroup of which one thread issues every copy (its registers go
// to the consumers with setmaxnreg). A product pass is C[128 x 128] =
// A[128 x K] @ B[K x 128], walked in 64-deep k-slices; one stage holds a
// slice of A (and, for the in-kernel mixup, the partner bag's slice) and a
// slice of B, so each 16 KB slice of B that lands feeds 128 rows. The
// kernels are persistent (a block per SM walks tiles): the producer runs
// ahead into the next pass and the next tile while the consumers finish an
// epilogue, as far as the ring's stages reach (3 to 6: as many as fit
// beside the output staging). The producer warpgroup's other three warps
// help: with the in-kernel mixup they mix each slice in place before the
// consumers' products read it, and with dropout they hash each pass's keep
// bits ahead of its epilogue. Epilogues write their bf16 tiles into a
// swizzled staging tile that one thread stores by TMA.
//
// Operands sit in shared memory in TMA's 128-byte swizzle, as the wgmma
// descriptors read them:
//  * K-major (K contiguous: a bag's rows, Wa/Wf read as W^T): a box of 64 K
//    columns x R rows, 128 bytes a row, 8-row groups 1024 bytes apart (the
//    descriptor's stride offset); a k-step of 16 adds 32 bytes.
//  * MN-major (M or N contiguous: Wf, Wa and Wb read as they are stored, and
//    X^T / Y of the weight gradients): boxes of 64 M/N columns x 64 K rows,
//    8 KB each; the descriptor's leading offset (8 KB) steps from one box of
//    64 columns to the next, the stride offset (1024) from 8 K rows to the
//    next; a k-step of 16 adds 2048 bytes. wgmma's transpose bit reads them.
// Accumulators follow the wgmma D fragment: warp w of a warpgroup holds rows
// 16 w + lane / 4 and + 8, columns 8 j + 2 (lane % 4) and the next, for
// j = 0 .. 15 (frag_row, frag_col).
//
// Everything sits in an anonymous namespace, as tiles.cuh does.
#pragma once

#include <cuda.h>

#include <algorithm>
#include <type_traits>

#include "common.cuh"
#include "tiles.cuh"

namespace {
namespace wg {

using bf16 = __nv_bfloat16;

constexpr int BM = 128;              // rows per block: two consumer warpgroups of 64
constexpr int BN = 128;              // output columns per product pass
constexpr int BK = 64;               // depth of a k-slice: one 128-byte swizzle row
constexpr int MAX_STAGES = 6;        // ring depth, at most
constexpr int BOX = 64 * 64 * 2;     // bytes of a 64 x 64 box
constexpr int HALF_A = BOX;          // one warpgroup's 64 rows of an A slice
constexpr int TILE_A = BM * BK * 2;  // a 128-row slice of A
constexpr int TILE_B = BK * BN * 2;  // a slice of B
constexpr int THREADS = 384;         // consumers, then the producer warpgroup
constexpr int CONSUMERS = 256;
constexpr int PRODUCER = 256;        // the thread that issues the copies


__device__ __forceinline__ uint32_t saddr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ int wg_index() { return threadIdx.x >> 7; }  // 0, 1 consumers
__device__ __forceinline__ bool is_producer() { return threadIdx.x >= CONSUMERS; }
// Row (in the block's 128) and column (in the pass's 128) of accumulator
// pair (j, hh): elements 4 j + 2 hh and 4 j + 2 hh + 1.
__device__ __forceinline__ int frag_row(int hh) {
  return (threadIdx.x >> 7) * 64 + ((threadIdx.x >> 5) & 3) * 16 + ((threadIdx.x & 31) >> 2) +
         8 * hh;
}
__device__ __forceinline__ int frag_col(int j) { return 8 * j + 2 * (threadIdx.x & 3); }

// ---- mbarriers, named barriers, fences ----
__device__ __forceinline__ void bar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(saddr(b)), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_expect(uint64_t* b, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(saddr(b)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(saddr(b)) : "memory");
}
__device__ __forceinline__ uint64_t now_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}
// Wait until the phase of parity `parity` has completed. A wait that has not
// ended after 10 s (a pipeline fault; a real one lasts microseconds) traps,
// so the launch fails instead of holding the card.
__device__ __forceinline__ void bar_wait(uint64_t* b, uint32_t parity) {
  uint64_t t0 = 0;
  for (uint32_t i = 0;; ++i) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(saddr(b)), "r"(parity)
        : "memory");
    if (done) return;
    if (i == 0) t0 = now_ns();
    else if ((i & 4095) == 0 && now_ns() - t0 > 10000000000ull) __trap();
  }
}
// Shared-memory writes of this thread, visible to the async proxy (wgmma,
// TMA stores) after the next barrier.
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void sync_wg() {  // the 128 threads of this consumer warpgroup
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg_index()) : "memory");
}
__device__ __forceinline__ void sync_consumers() {  // both consumer warpgroups
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// ---- TMA ----
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(saddr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(saddr(bar)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(saddr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(saddr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
// Shared -> global (rows outside the tensor are not written), into the
// thread's current bulk group (store_commit, store_wait_read).
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(saddr(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
// Two 64 x 64 MN-major boxes of a row-major (K, cols) matrix: columns n0 ..
// n0 + 63 and c1 .. c1 + 63 (c1 = n0 + 64 for 128 adjacent columns), rows
// k0 .. k0 + 63.
__device__ __forceinline__ void load_b_mn(uint8_t* dst, const CUtensorMap* m0, int n0,
                                          const CUtensorMap* m1, int c1, int k0, uint64_t* bar) {
  tma_load_2d(dst, m0, bar, n0, k0);
  tma_load_2d(dst + BOX, m1, bar, c1, k0);
}

// ---- register budget ----
__device__ __forceinline__ void producer_regs() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
}
__device__ __forceinline__ void consumer_regs() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
}

// ---- wgmma ----
// Descriptor of a 128-byte-swizzled operand at p (1024-aligned pattern).
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((saddr(p) & 0x3FFFF) >> 4) | (uint64_t)(lbo >> 4) << 16 |
         (uint64_t)(sbo >> 4) << 32 | 1ull << 62;
}
template <int MN>  // 0: K-major, 1: MN-major
__device__ __forceinline__ uint64_t operand(const void* p) {
  return MN ? desc(p, BOX, 1024) : desc(p, 16, 1024);
}
template <int MN>  // descriptor advance of k-step kk (16 deep)
__device__ __forceinline__ uint64_t kstep(int kk) {
  return MN ? (uint64_t)(128 * kk) : (uint64_t)(2 * kk);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous products.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A[64 x 16] @ B[16 x 128]; TA / TB: the operand is MN-major.
template <int TA, int TB>
__device__ __forceinline__ void mma(float (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, "
      "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, "
      "%52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

// ---- the ring ----
// A block's shared memory from a 1024-aligned base: the ring's stages, the
// consumers' output staging (two 16 KB tiles, one per warpgroup, or none),
// three barriers per stage, the keep bits' two buffers and four barriers,
// then the kernel's own arrays.
struct Pipe {
  uint8_t* base;  // stage 0
  int stage_bytes, stages;
  uint64_t* full;   // per stage: its copies landed
  uint64_t* empty;  // per stage: the 8 consumer warps are done with it
  uint64_t* mixed;  // per stage: the 3 mixer warps are done with it
  uint64_t* ready;  // what consumers wait for: full, or mixed with the mixup
  int it;           // k-slices produced (producer) or consumed (consumers) so far
  uint8_t* out;     // this warpgroup's output staging tile
  uint32_t* bits;   // 2 buffers x 256 consumer threads x 64 dropout keep bits
  uint64_t* bits_full;   // per buffer: the 3 helper warps wrote it
  uint64_t* bits_empty;  // per buffer: the 8 consumer warps read it
  int bits_it;           // keep-bit buffers written (helpers) or read (consumers)
  uint64_t* aux;         // a kernel's own barrier (one arrival a phase)
  uint8_t* extra;   // the kernel's own arrays
};

constexpr size_t SMEM_LIMIT = 232448;  // bytes of shared memory an H100 block may use
constexpr int OUT_TILE = 64 * BN * 2;   // a warpgroup's 64 x 128 bf16 output tile
constexpr int BITS_BYTES = 2 * CONSUMERS * 8 + 5 * 8;  // keep bits, their barriers, aux

// Stages the ring gets when `staging` bytes of output tiles and `extra`
// bytes of arrays must fit beside it: as many as fit, up to MAX_STAGES.
inline int plan_stages(int stage_bytes, int staging, size_t extra) {
  const long long room = (long long)SMEM_LIMIT - 1024 - staging - BITS_BYTES - (long long)extra;
  return (int)std::min<long long>(MAX_STAGES, room / (stage_bytes + 24));
}
inline size_t smem_bytes(int stage_bytes, int stages, int staging, size_t extra) {
  return 1024 + (size_t)stages * (stage_bytes + 24) + staging + BITS_BYTES + extra;
}

// Every thread: carve the shared memory; thread 0 initialises the barriers.
__device__ __forceinline__ Pipe pipe_setup(uint8_t* raw, int stage_bytes, int stages,
                                           int staging, bool mixing) {
  Pipe p;
  p.base = raw + ((1024 - (saddr(raw) & 1023)) & 1023);
  p.stage_bytes = stage_bytes;
  p.stages = stages;
  p.out = p.base + stages * stage_bytes + wg_index() * OUT_TILE;
  p.full = reinterpret_cast<uint64_t*>(p.base + stages * stage_bytes + staging);
  p.empty = p.full + stages;
  p.mixed = p.empty + stages;
  p.ready = mixing ? p.mixed : p.full;
  p.bits_full = p.mixed + stages;
  p.bits_empty = p.bits_full + 2;
  p.aux = p.bits_empty + 2;
  p.bits = reinterpret_cast<uint32_t*>(p.aux + 1);
  p.extra = reinterpret_cast<uint8_t*>(p.bits + 2 * CONSUMERS * 2);
  p.it = p.bits_it = 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      bar_init(&p.full[s], 1);
      bar_init(&p.empty[s], CONSUMERS / 32);
      bar_init(&p.mixed[s], 3);
    }
    for (int b = 0; b < 2; ++b) {
      bar_init(&p.bits_full[b], 3);
      bar_init(&p.bits_empty[b], CONSUMERS / 32);
    }
    bar_init(p.aux, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return p;
}

// Producer (one thread): the next stage once the consumers have released
// it, its full barrier armed for `bytes` (a whole stage unless given).
__device__ __forceinline__ uint8_t* produce(Pipe& p, uint64_t*& bar, int bytes = 0) {
  const int s = p.it % p.stages;
  bar_wait(&p.empty[s], ((p.it / p.stages) & 1) ^ 1);
  bar = &p.full[s];
  bar_expect(bar, (uint32_t)(bytes ? bytes : p.stage_bytes));
  ++p.it;
  return p.base + s * p.stage_bytes;
}

__device__ __forceinline__ void release(Pipe& p, int it) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) bar_arrive(&p.empty[it % p.stages]);
}

struct NoPre {
  __device__ void operator()(int, uint8_t*) const {}
};

// Consumers: acc = A @ B over the next nk stages of the ring, A at a_off in
// each stage (this warpgroup's 64 rows HALF_A further on), B at b_off.
// pre(k, stage) runs once the stage is ready, before its products (reads
// of the A slice). A stage is released as soon as the products that read it
// have completed, one stage behind. With X3 the operands are f32 values as
// their bf16 planes, hi at a_off / b_off and lo at a_lo / b_lo, and each
// k-step takes three products, hi hi + hi lo + lo hi. With `add` the
// products add to what acc holds.
template <int TA, int TB, bool X3 = false, typename Pre>
__device__ __forceinline__ void mainloop(Pipe& p, int nk, int a_off, int b_off,
                                         float (&acc)[64], Pre&& pre, int a_lo = 0,
                                         int b_lo = 0, bool add = false) {
  const int w = wg_index();
  for (int k = 0; k < nk; ++k) {
    const int s = p.it % p.stages;
    bar_wait(&p.ready[s], (p.it / p.stages) & 1);
    uint8_t* st = p.base + s * p.stage_bytes;
    pre(k, st);
    const uint64_t da = operand<TA>(st + a_off + w * HALF_A), db = operand<TB>(st + b_off);
    const uint64_t dal = X3 ? operand<TA>(st + a_lo + w * HALF_A) : 0;
    const uint64_t dbl = X3 ? operand<TB>(st + b_lo) : 0;
    wgmma_fence();
    fence_acc(acc);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      mma<TA, TB>(acc, da + kstep<TA>(kk), db + kstep<TB>(kk), add || (k | kk) != 0);
      if constexpr (X3) {
        mma<TA, TB>(acc, da + kstep<TA>(kk), dbl + kstep<TB>(kk), 1);
        mma<TA, TB>(acc, dal + kstep<TA>(kk), db + kstep<TB>(kk), 1);
      }
    }
    wgmma_commit();
    fence_acc(acc);
    if (k > 0) {
      wgmma_wait<1>();
      release(p, p.it - 1);
    }
    ++p.it;
  }
  wgmma_wait<0>();
  fence_acc(acc);
  release(p, p.it - 1);
}

// ---- the in-kernel mixup, on the producer warpgroup's other three warps ----
// A whole 128-row K-major A slice mixed in place with the partner's slice
// `b` (the same swizzled layout, so element by element): a = rnd(rnd(lam a)
// + rnd(oml b)), as the mixup twin rounds: a product of two bf16 values is
// exact in f32, so the packed bf16 product rounds it once, as rnd(lam * a)
// does; the sum is taken in f32 and rounded once more. (The packed bf16 sum
// does not give the twin's bits.)
__device__ __forceinline__ void mix_slice(uint8_t* a, const uint8_t* b, __nv_bfloat162 lam,
                                          __nv_bfloat162 oml, int mt) {
  for (int e = mt; e < TILE_A / 16; e += 96) {
    uint4 v = *reinterpret_cast<const uint4*>(a + e * 16);
    const uint4 u = *reinterpret_cast<const uint4*>(b + e * 16);
    __nv_bfloat162* pv = reinterpret_cast<__nv_bfloat162*>(&v);
    const __nv_bfloat162* pu = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(__hmul2(lam, pv[i]));
      const float2 y = __bfloat1622float2(__hmul2(oml, pu[i]));
      pv[i] = __floats2bfloat162_rn(__fadd_rn(x.x, y.x), __fadd_rn(x.y, y.y));
    }
    *reinterpret_cast<uint4*>(a + e * 16) = v;
  }
}

// ---- dropout keep bits, on the producer warpgroup's other three warps ----
// For one pass (output columns n0 .. n0 + 127 of 128 rows from r0): bit e of
// consumer thread T's 64 is the keep bit of its accumulator element e =
// 4 j + 2 hh + eb (row frag_row(hh), column n0 + frag_col(j) + eb) in the
// hash stream of `key0`, indices row * width + column; with key1 (the gated
// gates' passes of 64 columns) bits 32 .. 63 are stream key1's at the
// columns of bits 0 .. 31. Helper thread ht (0 .. 95) writes threads ht,
// ht + 96, ... of a buffer the consumers have released.
__device__ __forceinline__ void make_bits(Pipe& p, uint32_t key0, uint32_t key1, bool two,
                                          int width, int r0, int n0, uint32_t thresh, int ht) {
  const int b = p.bits_it & 1;
  bar_wait(&p.bits_empty[b], ((p.bits_it >> 1) & 1) ^ 1);
  uint32_t* out = p.bits + b * CONSUMERS * 2;
  for (int T = ht; T < CONSUMERS; T += 96) {
    const int row = r0 + (T >> 7) * 64 + ((T >> 5) & 3) * 16 + ((T & 31) >> 2);
    const int col = n0 + 2 * (T & 3);
    uint32_t w[2] = {0u, 0u};
#pragma unroll
    for (int e = 0; e < 64; ++e) {
      const int j = e >> 2, hh = (e >> 1) & 1, eb = e & 1;
      const bool second = two && e >= 32;
      const uint32_t idx =
          (uint32_t)(row + 8 * hh) * width + col + 8 * (second ? j - 8 : j) + eb;
      w[e >> 5] |= (uint32_t)(murcl::dropout_bits(second ? key1 : key0, idx) >= thresh)
                   << (e & 31);
    }
    out[2 * T] = w[0];
    out[2 * T + 1] = w[1];
  }
  __syncwarp();
  if ((threadIdx.x & 31) == 0) bar_arrive(&p.bits_full[b]);
  ++p.bits_it;
}
// Consumers: this thread's 64 keep bits of the next pass; the buffer is
// released at once.
__device__ __forceinline__ uint2 take_bits(Pipe& p) {
  const int b = p.bits_it & 1;
  bar_wait(&p.bits_full[b], (p.bits_it >> 1) & 1);
  const uint2 v = *reinterpret_cast<const uint2*>(p.bits + b * CONSUMERS * 2 + 2 * threadIdx.x);
  __syncwarp();
  if ((threadIdx.x & 31) == 0) bar_arrive(&p.bits_empty[b]);
  ++p.bits_it;
  return v;
}
__device__ __forceinline__ bool bit(const uint2& v, int e) {
  return ((e < 32 ? v.x >> e : v.y >> (e - 32)) & 1u) != 0;
}

// ---- output tiles through shared memory, stored by TMA ----
// Element pair (row rl of the warpgroup's 64, columns c, c + 1 of 128) into
// the staging tile: two 64-column boxes, 128-byte swizzled as the store's
// tensor map reads them.
__device__ __forceinline__ void stage_pair(uint8_t* out, int rl, int c, float x0, float x1) {
  uint8_t* box = out + (c >> 6) * BOX;
  const int cc = c & 63;
  *reinterpret_cast<__nv_bfloat162*>(box + rl * 128 + ((((cc >> 3) ^ (rl & 7))) << 4) +
                                     ((cc & 7) << 1)) = __floats2bfloat162_rn(x0, x1);
}
// An f32 pair of row rl, columns c and c + 1, into a warpgroup's staging
// tiles as hi = rnd(v) and lo = rnd(v - hi) (v - hi is exact in f32).
__device__ __forceinline__ void stage_split(uint8_t* hi, uint8_t* lo, int rl, int c,
                                            const float (&v)[2]) {
  const float h0 = murcl::rnd<bf16>(v[0]), h1 = murcl::rnd<bf16>(v[1]);
  stage_pair(hi, rl, c, h0, h1);
  stage_pair(lo, rl, c, v[0] - h0, v[1] - h1);
}
__device__ __forceinline__ void store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// The thread's bulk stores have been written to global memory, ordered for
// the async proxy (TMA loads issued after a barrier that follows).
__device__ __forceinline__ void store_wait_done() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}
__device__ __forceinline__ void fence_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}
// Before a warpgroup writes its staging tile: the previous tile's stores
// have read it.
__device__ __forceinline__ void stage_begin() {
  if ((threadIdx.x & 127) == 0) store_wait_read();
  sync_wg();
}
// After: one thread stores the two boxes, at columns c0 and c1 of rows
// r of bag `bag` (c1 < 0: the first box only); with lo_bag >= 0 also the
// lo tile of stage_split (2 OUT_TILE further on) at bag lo_bag.
__device__ __forceinline__ void stage_end(Pipe& p, const CUtensorMap* map, int c0, int c1, int r,
                                          int bag, int lo_bag = -1) {
  fence_async();
  sync_wg();
  if ((threadIdx.x & 127) == 0) {
    tma_store_3d(map, p.out, c0, r, bag);
    if (c1 >= 0) tma_store_3d(map, p.out + BOX, c1, r, bag);
    if (lo_bag >= 0) {
      tma_store_3d(map, p.out + 2 * OUT_TILE, c0, r, lo_bag);
      if (c1 >= 0) tma_store_3d(map, p.out + 2 * OUT_TILE + BOX, c1, r, lo_bag);
    }
    store_commit();
  }
}
// At the end of a consumer: its last stores have read the staging tile.
__device__ __forceinline__ void stage_drain() {
  if ((threadIdx.x & 127) == 0) store_wait_read();
}

// Element (r, c) of a K-major slice (64 columns, 128-byte rows, swizzled).
__device__ __forceinline__ const uint8_t* chunk_at(const uint8_t* slice, int r, int chunk) {
  return slice + r * 128 + ((chunk ^ (r & 7)) << 4);
}

// ---- host: tensor maps ----
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API call; the library links only the
// runtime, so the driver's entry point is fetched through it.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
#endif
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 tensor of `rank` dims (innermost first; dims[0] contiguous) read in
// boxes of 64 x box1 (x 1), 128-byte swizzle, zeros outside the tensor.
inline int make_map(CUtensorMap* map, const void* ptr, int rank, const uint64_t* dims,
                    uint32_t box1) {
  EncodeTiled fn = encode_tiled();
  if (!fn) return (int)cudaErrorNotSupported;
  cuuint64_t gdim[3], gstride[2];
  cuuint32_t box[3] = {64, box1, 1}, estride[3] = {1, 1, 1};
  uint64_t stride = 2;
  for (int i = 0; i < rank; ++i) {
    gdim[i] = dims[i];
    if (i) gstride[i - 1] = stride;
    stride *= dims[i];
  }
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, (cuuint32_t)rank,
                        const_cast<void*>(ptr), gdim, gstride, box, estride,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}
// (cols, rows) row-major, boxes of 64 columns x box_rows rows.
inline int map2(CUtensorMap* map, const void* ptr, int cols, long long rows, int box_rows) {
  const uint64_t dims[2] = {(uint64_t)cols, (uint64_t)rows};
  return make_map(map, ptr, 2, dims, (uint32_t)box_rows);
}
// (bags, rows, cols) row-major, boxes of 64 columns x box_rows rows of one bag.
inline int map3(CUtensorMap* map, const void* ptr, int cols, int rows, int bags, int box_rows) {
  const uint64_t dims[3] = {(uint64_t)cols, (uint64_t)rows, (uint64_t)bags};
  return make_map(map, ptr, 3, dims, (uint32_t)box_rows);
}

}  // namespace wg

// ---------------------------------------------------------------------------
// What the kernels of K2/K3 (fused_trunk.cu) and K7 (attention_pool.cu)
// share: launch plans, persistent grids, the f32 route's split into planes,
// the gate passes' producer and keep bits, and the weight-gradient kernel.
// ---------------------------------------------------------------------------

// A kernel's launch plan: ring stages (as many as fit beside `staging` bytes
// of output tiles and `extra` bytes of arrays, at least `min_stages`) and
// shared-memory bytes.
struct Plan {
  int stages;
  size_t smem;
};
inline Plan plan(int stage_bytes, int staging, size_t extra, int min_stages = 3) {
  const int stages = wg::plan_stages(stage_bytes, staging, extra);
  // fewer than min_stages: a size no block may take, so that the launch fails
  return {stages, stages >= min_stages ? wg::smem_bytes(stage_bytes, stages, staging, extra)
                                       : wg::SMEM_LIMIT + 1};
}

// Persistent grids: one block of 384 threads per SM (a block takes most of
// an SM's shared memory and registers).
inline int sm_count() {
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}
inline unsigned persistent_grid(long long tiles) {
  return (unsigned)(tiles < sm_count() ? tiles : sm_count());
}

// Copies `n` floats of src into shared memory (rounded to bf16 when
// `round`), by `threads` threads numbered from `tid`.
__device__ __forceinline__ void to_shared(float* dst, const float* __restrict__ src, int n,
                                          bool round, int tid, int threads) {
  for (int i = tid; i < n; i += threads) dst[i] = round ? rnd<wg::bf16>(src[i]) : src[i];
}

// T = float: the f32 route, every operand as two bf16 planes (kPlanes).
template <typename T>
constexpr bool kX3 = std::is_same<T, float>::value;
template <typename T>
constexpr int kPlanes = kX3<T> ? 2 : 1;

// The f32 route's operands as bf16 planes, a warp a row of K values: out[i]
// = rnd(v_i) and out[rows K + i] = rnd(v_i - rnd(v_i)); with perm, v = lam x
// + (1 - lam) x[perm] of each bag of `per` rows first, in f32 (1 - lam in
// f32, as the mixup twin apply_mix computes it); with rn, rn[row] = the
// norm of the row's v. K % 4 == 0.
__global__ void __launch_bounds__(256)
split_kernel(const float* __restrict__ x, const int64_t* __restrict__ perm,
             const float* __restrict__ lam, wg::bf16* __restrict__ out, float* __restrict__ rn,
             long long rows, int K, int per) {
  const long long row = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const long long bag = row / per;
  const float* a = x + row * K;
  const float* q = perm ? x + (perm[bag] * per + row % per) * K : nullptr;
  const float l = perm ? lam[bag] : 1.f, o = 1.f - l;
  wg::bf16* hi = out + row * K;
  wg::bf16* lo = hi + rows * K;
  float ss = 0.f;
  for (int i = 4 * lane; i < K; i += 128) {
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v[e] = a[i + e];
      if (q) v[e] = __fadd_rn(__fmul_rn(l, v[e]), __fmul_rn(o, q[i + e]));
      ss = fmaf(v[e], v[e], ss);
    }
    uint2 hv, lv;
    __nv_bfloat162* ph = reinterpret_cast<__nv_bfloat162*>(&hv);
    __nv_bfloat162* pl = reinterpret_cast<__nv_bfloat162*>(&lv);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      ph[e] = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
      const float2 hf = __bfloat1622float2(ph[e]);
      pl[e] = __floats2bfloat162_rn(v[2 * e] - hf.x, v[2 * e + 1] - hf.y);
    }
    *reinterpret_cast<uint2*>(hi + i) = hv;
    *reinterpret_cast<uint2*>(lo + i) = lv;
  }
  if (rn) {
    ss = warp_sum(ss);
    if (lane == 0) rn[row] = sqrtf(ss);
  }
}

inline cudaError_t split(const void* x, const void* perm, const void* lam, void* out, float* rn,
                         long long rows, int K, long long per, cudaStream_t stream) {
  split_kernel<<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(
      (const float*)x, (const int64_t*)perm, (const float*)lam, (wg::bf16*)out, rn, rows, K,
      (int)per);
  return cudaGetLastError();
}

// The helper warps' keep bits of every pass of a kernel's tiles, in the
// consumers' order: passes of `step` columns over `width`, stream `stream`
// (and, gated gates, streams 1 and 2). `stride` is the hash stream's row
// width (0: `width`): K7 given widths zero-padded to 128 hashes at the
// logical width, so that every real unit keeps its bit (ops/attention.py
// _keep_bits); a padded column's bit falls on no real unit's and is unused,
// its gate being 0.
__device__ __forceinline__ void bits_passes(wg::Pipe& pipe, uint32_t seed, uint32_t thresh,
                                            int stream, bool two, int step, int width, int B,
                                            int N, int stride = 0) {
  const int tiles = (N + wg::BM - 1) / wg::BM, ht = threadIdx.x - wg::PRODUCER - 32;
  for (int t = blockIdx.x; t < tiles * B; t += gridDim.x) {
    const int bag = t / tiles, r0 = (t % tiles) * wg::BM;
    const uint32_t k0 = murcl::bag_key(seed, bag, stream), k1 = murcl::bag_key(seed, bag, 2);
    for (int n0 = 0; n0 < width; n0 += step)
      wg::make_bits(pipe, k0, k1, two, stride ? stride : width, r0, n0, thresh, ht);
  }
}

// The gate passes of each 128-row tile of a (B, N, K) bag tensor (a_map,
// K-major slices of 128 rows; rows past N read as zeros): gated, 64 columns
// of Wa and the same 64 of Wb per pass (accumulator j and j + 8 hold a and g
// of one element); ungated, 128 columns of Wa. Wa and Wb (K, D) are read
// MN-major as stored. With x3 each operand is two planes: the bag tensor's
// lo plane as bags B .. 2 B - 1 of a_map, W's as rows K .. 2 K - 1 (a
// stage: A hi, A lo, B hi, B lo).
__device__ __forceinline__ void produce_gates(wg::Pipe& pipe, const CUtensorMap* a_map,
                                              const CUtensorMap* wa_map,
                                              const CUtensorMap* wb_map, int gated, int B,
                                              int N, int K, int D, bool x3 = false) {
  const int tiles = (N + wg::BM - 1) / wg::BM, step = gated ? 64 : wg::BN, planes = x3 ? 2 : 1;
  for (int t = blockIdx.x; t < tiles * B; t += gridDim.x) {
    const int bag = t / tiles, r0 = (t % tiles) * wg::BM;
    for (int n0 = 0; n0 < D; n0 += step)
      for (int k = 0; k < K / wg::BK; ++k) {
        uint64_t* bar;
        uint8_t* st = wg::produce(pipe, bar);
        for (int pl = 0; pl < planes; ++pl)
          wg::tma_load_3d(st + pl * wg::TILE_A, a_map, bar, k * wg::BK, r0, pl * B + bag);
        for (int pl = 0; pl < planes; ++pl) {
          uint8_t* b = st + planes * wg::TILE_A + pl * wg::TILE_B;
          const int kr = pl * K + k * wg::BK;
          if (gated)
            wg::load_b_mn(b, wa_map, n0, wb_map, n0, kr, bar);
          else
            wg::load_b_mn(b, wa_map, n0, wa_map, n0 + 64, kr, bar);
        }
      }
  }
}

// Weight gradients: dW[M x Nc] += X^T @ Y over this block's split of the R
// rows (X (R, M), Y (R, Nc) bf16 row-major, both read MN-major as stored),
// on 128 x 128 output tiles; the columns of Y below `split` go to out0, the
// rest to out1 (row stride ldo). Blocks of the first M tile also add Y's
// column sums into db0 / db1 (db0 null: none). With T = float, X and Y are
// f32 values as their bf16 planes (x_map, y_map the hi planes, x_lo, y_lo
// the lo planes; a stage: X hi, X lo, Y hi, Y lo), the products three bf16
// products, summed 8 k-slices at a time by the tensor cores, and the
// column sums hi + lo.
template <typename T>
__global__ void __launch_bounds__(wg::THREADS, 1)
wgrad_wg(const __grid_constant__ CUtensorMap x_map, const __grid_constant__ CUtensorMap y_map,
         const __grid_constant__ CUtensorMap x_lo, const __grid_constant__ CUtensorMap y_lo,
         float* __restrict__ out0, float* __restrict__ out1, int split, int ldo,
         float* __restrict__ db0, float* __restrict__ db1, long long R, long long per, int M,
         int stages) {
  constexpr bool X3 = std::is_same<T, float>::value;
  constexpr int P = X3 ? 2 : 1;  // planes of each operand
  extern __shared__ uint8_t smem_raw[];
  wg::Pipe pipe = wg::pipe_setup(smem_raw, P * (wg::TILE_A + wg::TILE_B), stages, 0, false);
  const int n0 = blockIdx.x * wg::BN, m0 = blockIdx.y * wg::BM;
  const long long rbeg = blockIdx.z * per, rend = min(R, rbeg + per);
  const int nk = (int)((rend - rbeg + wg::BK - 1) / wg::BK);
  if (wg::is_producer()) {
    wg::producer_regs();
    if (threadIdx.x == wg::PRODUCER)
      for (int k = 0; k < nk; ++k) {
        uint64_t* bar;
        uint8_t* st = wg::produce(pipe, bar);
        const int r = (int)(rbeg + (long long)k * wg::BK);
        wg::load_b_mn(st, &x_map, m0, &x_map, m0 + 64, r, bar);
        if (X3) wg::load_b_mn(st + wg::TILE_A, &x_lo, m0, &x_lo, m0 + 64, r, bar);
        wg::load_b_mn(st + P * wg::TILE_A, &y_map, n0, &y_map, n0 + 64, r, bar);
        if (X3) wg::load_b_mn(st + 2 * wg::TILE_A + wg::TILE_B, &y_lo, n0, &y_lo, n0 + 64, r, bar);
      }
    return;
  }
  wg::consumer_regs();
  const int tid = threadIdx.x;
  const bool sums = db0 != nullptr && blockIdx.y == 0 && tid < wg::BN;
  float colsum = 0.f;
  float acc[64];
  auto colsums = [&](int, uint8_t* st) {
    if (!sums) return;
    const int cc = tid & 63;
    for (int pl = 0; pl < P; ++pl) {
      const uint8_t* y = st + P * wg::TILE_A + pl * wg::TILE_B + (tid >> 6) * wg::BOX;
      for (int rr = 0; rr < wg::BK; ++rr)
        colsum += __bfloat162float(
            *reinterpret_cast<const wg::bf16*>(wg::chunk_at(y, rr, cc >> 3) + ((cc & 7) << 1)));
    }
  };
  if constexpr (X3) {
    // The tensor cores' f32 accumulation drifts with the number of products
    // it adds (over a split of 98,304 rows at the main call, 3.3e-4 of dW
    // against the f32 twin, linear in the rows): f32 sums kPromote k-slices
    // at a time there, and the sums add in the CUDA cores.
    constexpr int kPromote = 8;
    float sum[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) sum[i] = 0.f;
    for (int k0 = 0; k0 < nk; k0 += kPromote) {
      wg::mainloop<1, 1, true>(pipe, min(kPromote, nk - k0), 0, 2 * wg::TILE_A, acc, colsums,
                               wg::TILE_A, 2 * wg::TILE_A + wg::TILE_B);
#pragma unroll
      for (int i = 0; i < 64; ++i) sum[i] += acc[i];
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = sum[i];
  } else {
    wg::mainloop<1, 1>(pipe, nk, 0, wg::TILE_A, acc, colsums);
  }
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
// 0. With T = float, X and Y are planes (2, R, M) and (2, R, Nc): hi, then
// lo, R M (R Nc) elements on.
template <typename T = wg::bf16>
int wgrad_wg_launch(const void* X, int M, const void* Y, int Nc, long long R, float* out0,
                    float* out1, int split, int ldo, float* db0, float* db1,
                    cudaStream_t stream) {
  constexpr bool X3 = std::is_same<T, float>::value;
  CUtensorMap xm, ym, xl, yl;
  MURCL_TRY((cudaError_t)wg::map2(&xm, X, M, R, wg::BK));
  MURCL_TRY((cudaError_t)wg::map2(&ym, Y, Nc, R, wg::BK));
  xl = xm;
  yl = ym;
  if (X3) {  // lo planes under maps of their own: a slice past R reads zeros, not hi rows
    MURCL_TRY((cudaError_t)wg::map2(&xl, (const wg::bf16*)X + (size_t)R * M, M, R, wg::BK));
    MURCL_TRY((cudaError_t)wg::map2(&yl, (const wg::bf16*)Y + (size_t)R * Nc, Nc, R, wg::BK));
  }
  const int tiles = (Nc / wg::BN) * ((M + wg::BM - 1) / wg::BM);
  long long splits = max(1, 2 * sm_count() / tiles);
  splits = min(splits, (R + wg::BK - 1) / wg::BK);
  long long per = (R + splits - 1) / splits;
  per = (per + wg::BK - 1) / wg::BK * wg::BK;
  const Plan pl = plan((X3 ? 2 : 1) * (wg::TILE_A + wg::TILE_B), 0, 0, X3 ? 2 : 3);
  MURCL_TRY(allow_smem(wgrad_wg<T>, pl.smem));
  const dim3 grid(Nc / wg::BN, (M + wg::BM - 1) / wg::BM, (unsigned)((R + per - 1) / per));
  wgrad_wg<T><<<grid, wg::THREADS, pl.smem, stream>>>(xm, ym, xl, yl, out0, out1, split, ldo, db0,
                                                      db1, R, per, M, pl.stages);
  return (int)cudaGetLastError();
}

}  // namespace
