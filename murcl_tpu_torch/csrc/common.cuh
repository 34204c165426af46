// Shared device helpers for the MuRCL kernels: bf16 rounding points and the
// counter-based dropout hash.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define MURCL_API extern "C" __attribute__((visibility("default")))

namespace murcl {

constexpr unsigned kFull = 0xffffffffu;

// Round a float to the storage type T and back. The JAX kernels cast xc, a, g
// and the backward's dx chain to the bag dtype right after each is
// evaluated; every such cast in the port goes through rnd<T>.
template <typename T> __device__ __forceinline__ float rnd(float x);
template <> __device__ __forceinline__ float rnd<float>(float x) { return x; }
template <> __device__ __forceinline__ float rnd<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <typename T> __device__ __forceinline__ float ld(const T* p);
template <> __device__ __forceinline__ float ld<float>(const float* p) { return *p; }
template <> __device__ __forceinline__ float ld<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T> __device__ __forceinline__ T st(float x);
template <> __device__ __forceinline__ float st<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 st<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// murmur3's 32-bit finaliser: a bijection on uint32.
__host__ __device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85ebca6bu;
  h ^= h >> 13;
  h *= 0xc2b2ae35u;
  h ^= h >> 16;
  return h;
}

// Dropout bits for element (row, col) of a (rows, cols) tensor of one bag.
// stream 0 = trunk, 1 = gate a, 2 = gate b. The plain PyTorch twin
// (ops/attention.py: _keep_bits) computes the same bits with int64 tensor
// ops masked to 32 bits, so kernel and plain version drop the same units.
__device__ __forceinline__ uint32_t bag_key(uint32_t seed, uint32_t bag, uint32_t stream) {
  return fmix32(seed ^ ((bag * 4u + stream + 1u) * 0x9e3779b1u));
}
__device__ __forceinline__ uint32_t dropout_bits(uint32_t key, uint32_t idx) {
  return fmix32(key ^ (idx * 0x7feb352du));
}

}  // namespace murcl
