// K1: sub-bag compaction as a direct row copy.
//
// Replaces murcl_tpu/ops/compact_pallas.py _make_kernel_grouped (reached
// through gather_compact(repeat > 1)). The TPU kernel DMA'd each slide's
// window into VMEM and built the sub-bag with a one-hot MXU matmul, sharing
// one window read among the bags of a slide.
//
// Bound on the H100: bytes. At the main path's shape it writes 1536 bags x
// 1024 rows x 1 KiB (1.5 GiB bf16) and reads about as much. Each selected
// row is read once per bag, and a slide's rows are reused by its 12 bags
// from the 50 MB L2 cache. Design: one block per bag. Each warp takes 32
// ranks at a time with one coalesced load, and the warp copies each live
// row with 16-byte vector accesses. A shared-memory bitmap records the
// filled slots; the unfilled ones are zero-filled afterwards. The copy is
// exact, so the result is bitwise that of the one-hot golden.
#include "common.cuh"

namespace {

__global__ void compact_kernel(const uint4* __restrict__ bank,
                               const int64_t* __restrict__ offsets,
                               const int* __restrict__ ranks,
                               const int64_t* __restrict__ num_patches,
                               uint4* __restrict__ out, int nmax, int feat_size,
                               int vec_per_row) {
  extern __shared__ unsigned filled[];
  const int bag = blockIdx.x;
  const int words = (feat_size + 31) / 32;
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
    const bool live = f >= 0 && f < feat_size;
    if (live) atomicOr(&filled[f >> 5], 1u << (f & 31));
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
  for (int f = warp; f < feat_size; f += nwarps) {
    if ((filled[f >> 5] >> (f & 31)) & 1u) continue;
    uint4* d = dst + (size_t)f * vec_per_row;
    for (int v = lane; v < vec_per_row; v += 32) d[v] = zero;
  }
}

}  // namespace

MURCL_API int murcl_compact(const void* bank, const void* offsets, const void* ranks,
                            const void* num_patches, void* out, int batch, int nmax,
                            int feat_size, int row_bytes, void* stream) {
  const int vec_per_row = row_bytes / 16;
  const size_t smem = sizeof(unsigned) * ((feat_size + 31) / 32);
  compact_kernel<<<batch, 256, smem, (cudaStream_t)stream>>>(
      (const uint4*)bank, (const int64_t*)offsets, (const int*)ranks,
      (const int64_t*)num_patches, (uint4*)out, nmax, feat_size, vec_per_row);
  return (int)cudaGetLastError();
}

MURCL_API const char* murcl_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
