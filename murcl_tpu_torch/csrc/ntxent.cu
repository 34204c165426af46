// K4: NT-Xent forward and backward, one block each.
//
// Replaces murcl_tpu/ops/ntxent_pallas.py _fwd_kernel and _bwd_kernel. Per
// step the loss sees 2B = 256 rows of 128-d projections: the whole problem
// (zn: 128 KiB of f32) fits in one block's shared memory, so it is bound by
// latency, not by bytes or FLOPs. Design: one block of 16 warps keeps zn in
// dynamic shared memory (row stride d+1, so a warp reading one column of 32
// rows hits 32 banks). A warp owns a row at a time: its lanes take 32 columns
// of the similarity row each, then reduce with shuffles. The backward first
// computes every row's max and sum-exp (phase 2), then the (G + G^T) @ zn
// term (phase 3), which needs the softmax of both rows i and j.
#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr float kEps = 1e-8f;      // torch CosineSimilarity norm clamp
constexpr float kNegInf = -1e9f;  // diagonal mask of the JAX kernels

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(murcl::kFull, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(murcl::kFull, v, o));
  return v;
}

// Phase 1: zn = z / max(|z|, eps) into shared memory (stride d+1).
__device__ void normalize(const float* zi, const float* zj, int b, int d, float* zn,
                          float* norms) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ld = d + 1;
  for (int i = warp; i < 2 * b; i += kWarps) {
    const float* z = i < b ? zi + (size_t)i * d : zj + (size_t)(i - b) * d;
    float ss = 0.f;
    for (int k = lane; k < d; k += 32) ss += z[k] * z[k];
    const float nrm = fmaxf(sqrtf(warp_sum(ss)), kEps);
    for (int k = lane; k < d; k += 32) zn[i * ld + k] = z[k] / nrm;
    if (lane == 0) norms[i] = nrm;
  }
}

__device__ __forceinline__ float sim_ij(const float* zn, int i, int j, int d, float temp) {
  const int ld = d + 1;
  float acc = 0.f;
  for (int k = 0; k < d; ++k) acc += zn[i * ld + k] * zn[j * ld + k];
  return acc / temp;
}

// Phase 2 for row i: masked row max and sum of exp (row buffer in smem).
__device__ void row_stats(const float* zn, int i, int n, int d, float temp, float* buf,
                          float* row_max, float* row_sum, float* pos) {
  const int lane = threadIdx.x & 31;
  const int partner = i < n / 2 ? i + n / 2 : i - n / 2;
  float m = -INFINITY;
  for (int j = lane; j < n; j += 32) {
    const float s = sim_ij(zn, i, j, d, temp);
    if (j == partner) *pos = s;
    const float v = j == i ? kNegInf : s;
    buf[j] = v;
    m = fmaxf(m, v);
  }
  m = warp_max(m);
  float acc = 0.f;
  for (int j = lane; j < n; j += 32) acc += expf(buf[j] - m);
  acc = warp_sum(acc);
  if (lane == 0) {
    row_max[i] = m;
    row_sum[i] = acc;
  }
}

__global__ void ntxent_fwd_kernel(const float* zi, const float* zj, float temp, float* loss,
                                  int b, int d) {
  extern __shared__ float smem[];
  const int n = 2 * b;
  float* zn = smem;                         // n * (d+1)
  float* norms = zn + n * (d + 1);          // n
  float* row_max = norms + n;               // n
  float* row_sum = row_max + n;             // n
  float* pos = row_sum + n;                 // n
  float* bufs = pos + n;                    // kWarps * n
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  normalize(zi, zj, b, d, zn, norms);
  __syncthreads();
  for (int i = warp; i < n; i += kWarps) {
    float p = 0.f;
    row_stats(zn, i, n, d, temp, bufs + warp * n, row_max, row_sum, &p);
    p = warp_sum(p);  // exactly one lane holds the positive
    if (lane == 0) pos[i] = p;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float acc = 0.f;
    for (int i = 0; i < n; ++i) acc += (logf(row_sum[i]) + row_max[i]) - pos[i];
    *loss = acc / n;
  }
}

constexpr int kMaxDimVec = 8;  // d <= 256, d % 32 == 0 (checked by the wrapper)

__global__ void ntxent_bwd_kernel(const float* zi, const float* zj, float temp,
                                  const float* gptr, float* dzi, float* dzj, int b, int d) {
  extern __shared__ float smem[];
  const int n = 2 * b;
  const int ld = d + 1;
  float* zn = smem;
  float* norms = zn + n * ld;
  float* row_max = norms + n;
  float* row_sum = row_max + n;
  float* bufs = row_sum + n;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float g = *gptr;
  normalize(zi, zj, b, d, zn, norms);
  __syncthreads();
  for (int i = warp; i < n; i += kWarps) {
    float unused = 0.f;
    row_stats(zn, i, n, d, temp, bufs + warp * n, row_max, row_sum, &unused);
  }
  __syncthreads();

  const int nk = d / 32;
  for (int i = warp; i < n; i += kWarps) {
    const int partner = i < b ? i + b : i - b;
    float acc[kMaxDimVec];
    for (int v = 0; v < kMaxDimVec; ++v) acc[v] = 0.f;
    for (int j0 = 0; j0 < n; j0 += 32) {
      const int j = j0 + lane;
      float c = 0.f;
      if (j < n && j != i) {
        // sim is symmetric bitwise (same products, same order), so G_ji uses
        // the same s with row j's statistics
        const float s = sim_ij(zn, i, j, d, temp);
        const float one = j == partner ? 1.f : 0.f;
        const float gij = ((expf(s - row_max[i]) / row_sum[i] - one) / n) * g;
        const float gji = ((expf(s - row_max[j]) / row_sum[j] - one) / n) * g;
        c = gij + gji;
      }
      const int jn = min(32, n - j0);
      for (int jj = 0; jj < jn; ++jj) {
        const float cj = __shfl_sync(murcl::kFull, c, jj);
        const float* znj = zn + (j0 + jj) * ld;
        for (int v = 0; v < nk; ++v) acc[v] += cj * znj[lane + 32 * v];
      }
    }
    float radial = 0.f;
    for (int v = 0; v < nk; ++v) {
      acc[v] /= temp;
      radial += zn[i * ld + lane + 32 * v] * acc[v];
    }
    radial = warp_sum(radial);
    const float nrm = norms[i];
    float* out = i < b ? dzi + (size_t)i * d : dzj + (size_t)(i - b) * d;
    for (int v = 0; v < nk; ++v) {
      const int k = lane + 32 * v;
      out[k] = nrm <= kEps ? acc[v] / kEps : (acc[v] - zn[i * ld + k] * radial) / nrm;
    }
  }
}

size_t fwd_smem(int b, int d) { return sizeof(float) * (2 * b * (d + 1) + 4 * 2 * b + kWarps * 2 * b); }
size_t bwd_smem(int b, int d) { return sizeof(float) * (2 * b * (d + 1) + 3 * 2 * b + kWarps * 2 * b); }

}  // namespace

MURCL_API int murcl_ntxent_fwd(const void* zi, const void* zj, float temp, void* loss, int b,
                               int d, void* stream) {
  const size_t smem = fwd_smem(b, d);
  cudaError_t err = cudaFuncSetAttribute(ntxent_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ntxent_fwd_kernel<<<1, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)zi, (const float*)zj, temp, (float*)loss, b, d);
  return (int)cudaGetLastError();
}

MURCL_API int murcl_ntxent_bwd(const void* zi, const void* zj, float temp, const void* g,
                               void* dzi, void* dzj, int b, int d, void* stream) {
  const size_t smem = bwd_smem(b, d);
  cudaError_t err = cudaFuncSetAttribute(ntxent_bwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ntxent_bwd_kernel<<<1, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)zi, (const float*)zj, temp, (const float*)g, (float*)dzi, (float*)dzj, b, d);
  return (int)cudaGetLastError();
}
