// K1 (also K5/K5r): sub-bag compaction as slot-ordered tiles gathered by TMA
// bulk copies.
//
// Replaces murcl_tpu/ops/compact_pallas.py _make_kernel_grouped (reached
// through gather_compact(repeat > 1)), and serves _make_kernel_tiled and
// _make_kernel_resident (K5/K5r, one bag per slide) as well. The TPU kernel
// DMA'd each slide's window into VMEM and built the sub-bag with a one-hot
// MXU matmul, sharing one window read among the bags of a slide.
//
// out[i, f, :] = bank[offsets[i] + p, :] where ranks[i, p] == f and
// p < num_patches[i]; every other slot is zero. The copy is exact, so the
// result is bitwise that of the one-hot golden.
//
// Bound on the H100: bytes, each bank row read once and each sub-bag
// written once: at the main path's shape (1536 bags x 1024 slots x 512)
// 1.5 GiB written and 128 MiB of distinct rows read in bf16, 0.519 ms at
// 3.35 TB/s (1.033 in f32); a supervised step's 64 bags of distinct slides
// 64 MiB each way, 0.040 ms (0.080). Reaching it takes two things: many
// bytes in flight per SM, and the reads of a slide's rows by its 12-24 bags
// served from the 50 MB L2 cache rather than from HBM (the earlier design, a
// warp's row copy, had one 1 KiB row per warp in flight between round trips
// for the ranks, and ran the bags in index order, so each slide's window was
// read from HBM about as often as it has bags).
//
// Design. A grid of (bag, slot slice): a block owns `slot_slice` consecutive
// output slots of one bag (ops/compact.py compact_plan: as many slices as
// fill one wave of resident blocks where the bags are few, one slice a bag
// where they are many; one block per SM at D 512). 256 threads read the
// bag's ranks once, coalesced, 8 loads a thread in flight, and invert them
// into a slot -> patch table for the slice in shared memory (-1: a zero
// slot); ranks are unique per bag, so no two threads write one entry. Then
// one warp walks the slice's slots, a contiguous span of `out`, in tiles of
// `rows` slots through a ring of `ring` tile buffers in dynamic shared
// memory:
//  * fill(t): each lane takes up to two of the tile's rows; lane 0 arms the
//    buffer's mbarrier with the live rows' bytes (a plain arrive when none
//    is live), then every live row is one cp.async.bulk global -> shared
//    into its place in the tile, issued by its lane; the warp zeroes the
//    dead rows in shared memory and fences them for the async proxy
//    (fence.proxy.async.shared::cta);
//  * at tile t: wait for its barrier, store the whole tile with one
//    cp.async.bulk shared -> global (a ragged last tile stores only its own
//    rows), wait until the store of tile t - 1 has read its buffer
//    (cp.async.bulk.wait_group.read 1) and fill tile t + ring - 1 there.
// So ring - 1 tiles of loads are in flight per block (128 KB at D 512:
// tiles of 64 KB, 64 bf16 or 32 f32 rows, ring 3; compact_plan takes
// 64 KB / row bytes rows, 1 to 64, and a ring of up to 8 that keeps 128 KB
// in flight), each output tile is written once, whole, and zero slots need
// no second pass. Shared memory: 128 bytes of barriers, the table, the ring
// (198.8-200.8 KB at D 512 in either dtype).
// Where the grid takes more than one wave, the blocks take the bags in
// slide order: order_kernel ranks the bags by (offset, index) first (bags of
// one slide share its offset), and block x takes the bag of rank x, so the
// bags of a slide run side by side and read its window through L2.
#include "wgmma_tiles.cuh"

namespace {
namespace cmp {

constexpr int THREADS = 256;  // write the slot table; warp 0 then runs the copies
constexpr int UNROLL = 8;     // rank loads in flight per thread
constexpr int MAX_RING = 8;
constexpr int BAR_BYTES = 8 * MAX_RING;
constexpr int HEAD = 128;     // barriers, padded
static_assert(BAR_BYTES <= HEAD, "the ring's barriers fit the head");

__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(wg::saddr(dst)), "l"(src), "r"(bytes), "r"(wg::saddr(bar))
      : "memory");
}
__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(wg::saddr(src)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void store_wait_read_one() {  // all but the newest store have read
  asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
}

// The bags in slide order: order[rank] = j, rank the number of bags k whose
// (offset, k) precedes bag j's (bags of one slide share its offset). A block
// ranks 32 bags, a lane each; its 8 warps split the B keys, each lane
// loading 32 of them at a time and the warp broadcasting them by shuffles,
// and the partial ranks add in shared memory. B^2 compares in all, over
// B / 32 blocks (48 at the main path's 1536 bags).
constexpr int ORDER_WARPS = 8;

__global__ void __launch_bounds__(32 * ORDER_WARPS)
order_kernel(const int64_t* __restrict__ offsets, int batch, int64_t* __restrict__ order) {
  __shared__ int part[ORDER_WARPS][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int j = blockIdx.x * 32 + lane;
  const long long kj = j < batch ? offsets[j] : 0;
  const int per = (batch + ORDER_WARPS - 1) / ORDER_WARPS;
  const int k1 = min(batch, (warp + 1) * per);
  int rank = 0;
  for (int base = warp * per; base < k1; base += 32) {
    const long long key = base + lane < k1 ? offsets[base + lane] : 0;
    const int n = min(32, k1 - base);
    for (int s = 0; s < n; ++s) {
      const long long kk = __shfl_sync(murcl::kFull, key, s);
      rank += kk < kj || (kk == kj && base + s < j);
    }
  }
  part[warp][lane] = rank;
  __syncthreads();
  if (warp == 0 && j < batch) {
    for (int w = 1; w < ORDER_WARPS; ++w) rank += part[w][lane];
    order[rank] = j;
  }
}

__global__ void __launch_bounds__(THREADS)
compact_kernel(const uint8_t* __restrict__ bank, const int64_t* __restrict__ offsets,
               const int* __restrict__ ranks, const int64_t* __restrict__ num_patches,
               const int64_t* __restrict__ order, uint8_t* __restrict__ out, int nmax,
               int feat_size, int row_bytes, int slot_slice, int rows, int ring) {
  extern __shared__ uint8_t smem_raw[];  // the dynamic base: 16-byte aligned at least
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw);
  int* table = reinterpret_cast<int*>(smem_raw + HEAD);
  uint8_t* tiles = smem_raw + HEAD + ((4 * slot_slice + 127) & ~127);

  const int bag = order ? (int)order[blockIdx.x] : blockIdx.x;
  const int f0 = blockIdx.y * slot_slice, span = min(feat_size - f0, slot_slice);
  for (int j = threadIdx.x; j < span; j += THREADS) table[j] = -1;
  if (threadIdx.x == 0) {
    for (int s = 0; s < ring; ++s) wg::bar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // invert the ranks: table[f - f0] = p for the slice's slots
  const int* r = ranks + (size_t)bag * nmax;
  const int n = (int)min((long long)nmax, (long long)num_patches[bag]);
  for (int base = 0; base < n; base += THREADS * UNROLL) {
    int f[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int p = base + u * THREADS + threadIdx.x;
      f[u] = p < n ? __ldg(r + p) : -1;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (f[u] >= f0 && f[u] - f0 < span) table[f[u] - f0] = base + u * THREADS + threadIdx.x;
  }
  __syncthreads();
  if (threadIdx.x >= 32) return;

  const int lane = threadIdx.x;
  const uint8_t* src = bank + (size_t)offsets[bag] * row_bytes;
  uint8_t* dst = out + ((size_t)bag * feat_size + f0) * row_bytes;
  const int n_tiles = (span + rows - 1) / rows, vec = row_bytes / 16;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  auto fill = [&](int t) {
    const int s = t % ring, j0 = t * rows, nr = min(rows, span - j0);
    uint8_t* buf = tiles + (size_t)s * rows * row_bytes;
    int p[2];
    unsigned live[2], dead[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = 32 * h + lane;
      p[h] = j < nr ? table[j0 + j] : -1;
      live[h] = __ballot_sync(murcl::kFull, p[h] >= 0);
      dead[h] = __ballot_sync(murcl::kFull, j < nr && p[h] < 0);
    }
    const uint32_t bytes = (uint32_t)(__popc(live[0]) + __popc(live[1])) * row_bytes;
    if (lane == 0) {
      if (bytes) wg::bar_expect(&full[s], bytes);
      else wg::bar_arrive(&full[s]);
    }
    __syncwarp();
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (p[h] >= 0)
        bulk_load(buf + (size_t)(32 * h + lane) * row_bytes, src + (size_t)p[h] * row_bytes,
                  row_bytes, &full[s]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      for (unsigned m = dead[h]; m; m &= m - 1) {
        uint4* d = reinterpret_cast<uint4*>(buf + (size_t)(32 * h + __ffs(m) - 1) * row_bytes);
        for (int v = lane; v < vec; v += 32) d[v] = zero;
      }
    }
    wg::fence_async();  // this lane's zeros, visible to the tile's bulk store
  };

  for (int t = 0; t < min(ring - 1, n_tiles); ++t) fill(t);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % ring, nr = min(rows, span - t * rows);
    wg::bar_wait(&full[s], (t / ring) & 1);
    __syncwarp();
    if (lane == 0) {
      bulk_store(dst + (size_t)t * rows * row_bytes, tiles + (size_t)s * rows * row_bytes,
                 (uint32_t)nr * row_bytes);
      wg::store_commit();
      store_wait_read_one();  // tile t - 1's buffer is free
    }
    __syncwarp();
    if (t + ring - 1 < n_tiles) fill(t + ring - 1);
  }
  if (lane == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

}  // namespace cmp
}  // namespace

// slot_slice, rows and ring from ops/compact.py compact_plan; row_bytes a
// multiple of 16 on a 16-byte aligned bank (the wrapper checks both). order:
// null, block x takes bag x; else (B,) int64 scratch that order_kernel fills
// with the bags in slide order first, and block x takes bag order[x].
MURCL_API int murcl_compact(const void* bank, const void* offsets, const void* ranks,
                            const void* num_patches, void* order, void* out, int batch,
                            int nmax, int feat_size, int row_bytes, int slot_slice, int rows,
                            int ring, void* stream) {
  const size_t smem = cmp::HEAD + ((4 * (size_t)slot_slice + 127) & ~(size_t)127)
                      + (size_t)ring * rows * row_bytes;
  if (ring < 2 || ring > cmp::MAX_RING || rows < 1 || rows > 64 || slot_slice < 1 ||
      smem > wg::SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  const int slices = (feat_size + slot_slice - 1) / slot_slice;
  // the kernel's shared-memory limit, per device, raised only when a larger
  // plan comes (the attribute call costs microseconds on every launch)
  static size_t allowed[64] = {};
  int dev = 0;
  MURCL_TRY(cudaGetDevice(&dev));
  if (dev >= 64 || smem > allowed[dev]) {
    MURCL_TRY(allow_smem(cmp::compact_kernel, smem));
    if (dev < 64) allowed[dev] = smem;
  }
  if (order) {
    cmp::order_kernel<<<(batch + 31) / 32, 32 * cmp::ORDER_WARPS, 0, (cudaStream_t)stream>>>(
        (const int64_t*)offsets, batch, (int64_t*)order);
    MURCL_TRY(cudaGetLastError());
  }
  cmp::compact_kernel<<<dim3(batch, slices), cmp::THREADS, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)bank, (const int64_t*)offsets, (const int*)ranks,
      (const int64_t*)num_patches, (const int64_t*)order, (uint8_t*)out, nmax, feat_size,
      row_bytes, slot_slice, rows, ring);
  return (int)cudaGetLastError();
}

MURCL_API const char* murcl_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
