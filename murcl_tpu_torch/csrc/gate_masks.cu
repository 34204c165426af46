// K7's gate keep masks, written out.
//
// Replaces the pallas_call of scripts/tpu_smoke.py:101 (mask_kernel,
// :96-99), the JAX package's TPU probe that wrote the gated attention
// pool's two dropout keep masks (murcl_tpu/ops/attention_pallas.py
// _dropout_masks, :130-147) to check the in-kernel dropout: ka and kb of
// (B, N, D) bool. The port's K7f and K7b (attention_pool.cu) draw their
// keep bits from the counter hash of common.cuh, streams 1 (gate a) and 2
// (gate b), at the hash width D (the logical D); this kernel writes the same
// bits, kept where dropout_bits(bag_key(seed, bag, stream), row D + col) >=
// thresh, as K7f and K7b keep them, so the masks say what those kernels drop
// (murcl_tpu_torch/scripts/dropout_smoke.py; the twin is ops/gate_masks.py's
// gate_keep_masks_plain). A probe, on no training path.
// Bound on the H100: bytes, the 2 B N D bytes of the masks written (1 MB at
// the script's (8, 256, 256): 0.3 us at 3.35 TB/s); the hash, about 12
// integer operations per bit, is below that. Design: a thread per element of
// a bag's (N, D), a block row of the grid per bag, both masks at once.
#include <algorithm>

#include "common.cuh"

namespace {

__global__ void __launch_bounds__(256)
gate_masks_kernel(uint32_t seed, uint32_t thresh, int N, int D, bool* __restrict__ ka,
                  bool* __restrict__ kb) {
  const int bag = blockIdx.y;
  const uint32_t k1 = murcl::bag_key(seed, bag, 1), k2 = murcl::bag_key(seed, bag, 2);
  const long long per = (long long)N * D;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < per;
       e += (long long)gridDim.x * blockDim.x) {
    const uint32_t idx = (uint32_t)e;  // row D + col
    ka[bag * per + e] = murcl::dropout_bits(k1, idx) >= thresh;
    kb[bag * per + e] = murcl::dropout_bits(k2, idx) >= thresh;
  }
}

}  // namespace

// ka, kb (B, N, D) bool: K7's keep bits of gates a and b at seed and
// threshold thresh.
MURCL_API int murcl_gate_masks(uint32_t seed, uint32_t thresh, int B, int N, int D, void* ka,
                               void* kb, void* stream) {
  if (B < 1 || N < 1 || D < 1) return (int)cudaErrorInvalidValue;
  const long long per = (long long)N * D;
  const unsigned blocks = (unsigned)std::min<long long>((per + 255) / 256, 1024);
  gate_masks_kernel<<<dim3(blocks, B), 256, 0, (cudaStream_t)stream>>>(seed, thresh, N, D,
                                                                     (bool*)ka, (bool*)kb);
  return (int)cudaGetLastError();
}
