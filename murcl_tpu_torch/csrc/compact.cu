// K1: sub-bag compaction as a direct row copy.
//
// Replaces murcl_tpu/ops/compact_pallas.py _make_kernel_grouped (reached
// through gather_compact(repeat > 1)), and serves _make_kernel_tiled and
// _make_kernel_resident (K5/K5r, one bag per slide) as well. The TPU kernel
// DMA'd each slide's window into VMEM and built the sub-bag with a one-hot
// MXU matmul, sharing one window read among the bags of a slide.
//
// Bound on the H100: bytes. At the main path's shape it writes 1536 bags x
// 1024 rows x 1 KiB (1.5 GiB bf16) and reads about as much. Each selected
// row is read once per bag, and a slide's rows are reused by its 12 bags
// from the 50 MB L2 cache. Design: a grid of (bag, slot slice). A block owns
// `slot_slice` output slots of its bag (ops/compact.py compact_slot_slice:
// one slice per bag at the main shape, 8 of 128 slots at a supervised step's
// 64 bags, so that those fill the 132 SMs). Each warp takes 32 of the bag's
// ranks at a time with one coalesced load (every block of a bag scans all of
// them, from L2), and the warp copies each live row whose slot falls in the
// block's range with 16-byte vector accesses. A shared-memory bitmap of the
// range records the filled slots; the unfilled ones are zero-filled
// afterwards. The copy is exact, so the result is bitwise that of the
// one-hot golden.
#include "common.cuh"

namespace {

__global__ void compact_kernel(const uint4* __restrict__ bank,
                               const int64_t* __restrict__ offsets,
                               const int* __restrict__ ranks,
                               const int64_t* __restrict__ num_patches,
                               uint4* __restrict__ out, int nmax, int feat_size,
                               int vec_per_row, int slot_slice) {
  extern __shared__ unsigned filled[];
  const int bag = blockIdx.x;
  const int f0 = blockIdx.y * slot_slice, f1 = min(feat_size, f0 + slot_slice);
  const int words = (f1 - f0 + 31) / 32;
  for (int w = threadIdx.x; w < words; w += blockDim.x) filled[w] = 0u;
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int* r = ranks + (size_t)bag * nmax;
  const long long n = min((long long)nmax, (long long)num_patches[bag]);
  const uint4* src = bank + (size_t)offsets[bag] * vec_per_row;
  uint4* dst = out + (size_t)bag * feat_size * vec_per_row;

  for (long long base = (long long)warp * 32; base < n; base += (long long)nwarps * 32) {
    const long long p = base + lane;
    const int f = p < n ? r[p] : -1;
    const bool live = f >= f0 && f < f1;
    if (live) atomicOr(&filled[(f - f0) >> 5], 1u << ((f - f0) & 31));
    unsigned todo = __ballot_sync(murcl::kFull, live);
    while (todo) {
      const int j = __ffs(todo) - 1;
      todo &= todo - 1;
      const int fj = __shfl_sync(murcl::kFull, f, j);
      const uint4* s = src + (size_t)(base + j) * vec_per_row;
      uint4* d = dst + (size_t)fj * vec_per_row;
      for (int v = lane; v < vec_per_row; v += 32) d[v] = s[v];
    }
  }
  __syncthreads();

  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int f = f0 + warp; f < f1; f += nwarps) {
    if ((filled[(f - f0) >> 5] >> ((f - f0) & 31)) & 1u) continue;
    uint4* d = dst + (size_t)f * vec_per_row;
    for (int v = lane; v < vec_per_row; v += 32) d[v] = zero;
  }
}

}  // namespace

MURCL_API int murcl_compact(const void* bank, const void* offsets, const void* ranks,
                            const void* num_patches, void* out, int batch, int nmax,
                            int feat_size, int row_bytes, int slot_slice, void* stream) {
  const int vec_per_row = row_bytes / 16;
  const int slices = (feat_size + slot_slice - 1) / slot_slice;
  const size_t smem = sizeof(unsigned) * ((slot_slice + 31) / 32);
  compact_kernel<<<dim3(batch, slices), 256, smem, (cudaStream_t)stream>>>(
      (const uint4*)bank, (const int64_t*)offsets, (const int*)ranks,
      (const int64_t*)num_patches, (uint4*)out, nmax, feat_size, vec_per_row, slot_slice);
  return (int)cudaGetLastError();
}

MURCL_API const char* murcl_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
