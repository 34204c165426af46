// K6: bag-level mixup as one out-of-place pass over the bags.
//
// Replaces murcl_tpu/ops/compact_pallas.py _mix_kernel (via mixup_rows),
// the ABMIL MuRCL route's standalone mix. Per bag i of (B, F, D):
//   out[i] = lam_i * x[i] + (1 - lam_i) * x[perm_abs[i]]
// 1 - lam is taken in f32 and both factors are then rounded to the bag dtype
// T, as the TPU kernel does. Per element, p = rnd(lam * x) and
// q = rnd((1 - lam) * xp) are each rounded to T, then their sum is rounded
// to T: the order of the plain twin's per-op tensor arithmetic (apply_mix),
// so the two agree bit for bit. No FMA contraction (__fmul_rn, __fadd_rn).
//
// Bound on the H100: device memory bandwidth. The main path's call (1536 x
// 1024 x 512 bf16) reads 3 GiB and writes 1.5 GiB and does one multiply-add
// per element. Each thread moves 16-byte vectors, neighbouring threads on
// neighbouring addresses; a grid of (row chunks, bags) keeps every SM busy.
// perm_abs may point at any bag of the launch, so the pass never writes in
// place. Bags whose rows are not 16-byte aligned take the scalar loop.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int VECS_PER_THREAD = 4;  // 16-byte vectors per thread per grid pass

template <typename T>
__device__ __forceinline__ float mix1(float lam, float oml, float a, float b) {
  using murcl::rnd;
  return rnd<T>(__fadd_rn(rnd<T>(__fmul_rn(lam, a)), rnd<T>(__fmul_rn(oml, b))));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
mix_kernel(const T* __restrict__ x, const int64_t* __restrict__ perm,
           const float* __restrict__ lam, T* __restrict__ out, long long per_bag, int vec) {
  constexpr int V = 16 / sizeof(T);
  const int bag = blockIdx.y;
  const float lam_t = murcl::rnd<T>(lam[bag]);
  const float oml_t = murcl::rnd<T>(1.f - lam[bag]);
  const T* self = x + (size_t)bag * per_bag;
  const T* partner = x + (size_t)perm[bag] * per_bag;
  T* dst = out + (size_t)bag * per_bag;
  const long long stride = (long long)gridDim.x * THREADS;
  const long long first = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long nvec = vec ? per_bag / V : 0;
  for (long long v = first; v < nvec; v += stride) {
    const uint4 a = reinterpret_cast<const uint4*>(self)[v];
    const uint4 b = reinterpret_cast<const uint4*>(partner)[v];
    uint4 o;
    const T* av = reinterpret_cast<const T*>(&a);
    const T* bv = reinterpret_cast<const T*>(&b);
    T* ov = reinterpret_cast<T*>(&o);
#pragma unroll
    for (int k = 0; k < V; ++k)
      ov[k] = murcl::st<T>(mix1<T>(lam_t, oml_t, murcl::ld<T>(av + k), murcl::ld<T>(bv + k)));
    reinterpret_cast<uint4*>(dst)[v] = o;
  }
  for (long long e = nvec * V + first; e < per_bag; e += stride)
    dst[e] = murcl::st<T>(mix1<T>(lam_t, oml_t, murcl::ld<T>(self + e), murcl::ld<T>(partner + e)));
}

template <typename T>
int mix_impl(const void* x, const void* perm, const void* lam, void* out, int B,
             long long per_bag, int vec, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const long long units = vec ? per_bag / V : per_bag;
  const long long per_block = (long long)THREADS * VECS_PER_THREAD;
  const long long blocks = (units + per_block - 1) / per_block;
  const dim3 grid((unsigned)(blocks < 1 ? 1 : blocks), (unsigned)B);
  mix_kernel<T><<<grid, THREADS, 0, stream>>>((const T*)x, (const int64_t*)perm,
                                              (const float*)lam, (T*)out, per_bag, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// x, out: (B, per_bag) of T; perm: (B,) int64 absolute bag indices; lam: (B,)
// f32. vec = 1 when every bag starts on a 16-byte boundary.
MURCL_API int murcl_mixup_rows(int is_bf16, const void* x, const void* perm, const void* lam,
                               void* out, int B, long long per_bag, int vec, void* stream) {
  auto strm = (cudaStream_t)stream;
  if (is_bf16) return mix_impl<__nv_bfloat16>(x, perm, lam, out, B, per_bag, vec, strm);
  return mix_impl<float>(x, perm, lam, out, B, per_bag, vec, strm);
}
