// The cp.async helpers that K4 (ntxent.cu) stages its tiles with: 16-byte
// copies from device memory into shared memory that run while the threads
// go on, grouped and waited for. Everything sits in an anonymous namespace,
// as tiles.cuh does, so each source that includes it gets its own copy.
#pragma once

#include "common.cuh"

namespace {
namespace cpa {

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

}  // namespace cpa
}  // namespace
