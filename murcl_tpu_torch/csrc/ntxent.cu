// K4: NT-Xent forward and backward, spread over the card's SMs.
//
// Replaces murcl_tpu/ops/ntxent_pallas.py _fwd_kernel and _bwd_kernel. Per
// pretraining step the loss sees n = 2B = 256 rows of 128-d projections: a
// 256 x 256 x 128 similarity product, about 17 MFLOP, a quarter of a
// microsecond of the card's f32 rate and below one launch's latency. So K4 is
// bound by latency, and the design spreads the rows over many blocks and
// keeps each block's dependent steps few:
// - ntxent_normalize_kernel: one warp per row writes zn = z / norm into a
//   scratch of (n_pad, d_pad) rows, zero past n and d (n_pad a multiple of
//   kCols, d_pad of kDepth), so the main kernels copy tiles without masks or
//   divides. The forward computes norm = max(|z|, 1e-8) (stats row 2); the
//   backward reads it back, so zn is the same bits in both.
// - ntxent_fwd_kernel: a block owns kRows rows and stages zn in tiles of
//   kCols rows by kDepth k through shared memory with cp.async, each warp on
//   512 contiguous bytes. (A thread loading its own row from memory instead
//   touches 32 cache lines per warp load, and on the H100 that took most of
//   the kernel's time.) Each thread owns one column of the tile and reads it, and the
//   block's rows as broadcasts, as float4; the row stride kLd puts the 8
//   lanes of each 16-byte phase in 8 bank groups. Two passes per
//   row as the TPU kernel does: the masked row max (diagonal -1e9), then the
//   sum of exp(s - max), from the sim rows kept in shared memory where
//   n <= kKeepCols, else recomputed. Each block writes its rows' max and sum
//   (the residual the backward reads) and lse - pos; the last block to finish
//   (a ticket counter, which that block resets) sums the n terms in a fixed
//   order, so the loss is the same bits from run to run.
// - ntxent_bwd_kernel: a block owns kRows rows, recomputes s over the same
//   tiles and forms c_ij = G_ij + G_ji from the forward's max and sum of rows
//   i and j (no statistics recomputed), then dzn_i = sum_j c_ij zn_j / temp
//   with two threads per k of the output, each over a fixed half of every
//   column tile in order, their sums added in order; the radial projection
//   and the norm clamp branch. No atomics: dz is the same bits run to run.
// Every sim entry is one fmaf chain over k = 0..d_pad-1 in order, whatever the
// tiling, so s_ij == s_ji bitwise and the backward's s equals the forward's.
// Any B >= 1 and d >= 1: rows, columns and k are tiled, padded with zeros.
#include "cp_async.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;              // rows of a block
constexpr int kCols = kThreads;       // columns of a tile, one per thread
constexpr int kDepth = 128;           // k per staged chunk
constexpr int kLd = kDepth + 4;       // shared row stride, in floats
constexpr int kWarps = kThreads / 32;
constexpr int kHalves = kThreads / kDepth;  // the backward's dzn: halves of j per k
constexpr int kSpan = kCols / kHalves;      // columns of a tile in each half
static_assert(kHalves == 2 && kSpan % 4 == 0, "two halves of float4 column groups");
constexpr int kKeepCols = 4096;       // forward keeps its sim rows up to this n
constexpr int kTileFloats = (kCols + kRows) * kLd;  // the column tile, then the rows
constexpr int kBwdBytes = sizeof(float) * kTileFloats;
constexpr int kFwdBytes = kBwdBytes + sizeof(float) * kRows * kKeepCols;
constexpr float kEps = 1e-8f;         // torch CosineSimilarity norm clamp
constexpr float kNegInf = -1e9f;      // diagonal mask of the JAX kernels

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(murcl::kFull, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(murcl::kFull, v, o));
  return v;
}

// Per row r < kRows, reduce v[r] over the block: the lanes' xor tree, then
// the warps in order. red: kRows x kWarps floats. Every thread gets the sums.
template <bool kMax>
__device__ __forceinline__ void block_reduce(float (&v)[kRows], float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float w = kMax ? warp_max(v[r]) : warp_sum(v[r]);
    if (lane == 0) red[r * kWarps + warp] = w;
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    float t = red[r * kWarps];
    for (int w = 1; w < kWarps; ++w) {
      const float x = red[r * kWarps + w];
      t = kMax ? fmaxf(t, x) : t + x;
    }
    v[r] = t;
  }
  __syncthreads();  // red is free again
}

// zn rows of the scratch: row r < n is z_r / norm_r up to d and 0 after;
// rows n..n_pad-1 are 0. One warp per row. norms_in null: compute the norm
// (lanes' fmaf chains, then the xor tree) into norms_out.
__global__ void __launch_bounds__(kThreads, 1)
    ntxent_normalize_kernel(const float* zi, const float* zj, int b, int d, int d_pad,
                            const float* norms_in, float* norms_out, float* zn) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarps + (threadIdx.x >> 5);
  float* out = zn + (size_t)r * d_pad;
  if (r >= 2 * b) {
    for (int k = lane; k < d_pad; k += 32) out[k] = 0.f;
    return;
  }
  const float* z = r < b ? zi + (size_t)r * d : zj + (size_t)(r - b) * d;
  float nrm;
  if (norms_in) {
    nrm = norms_in[r];
  } else {
    float ss = 0.f;
    for (int k = lane; k < d; k += 32) ss = fmaf(z[k], z[k], ss);
    nrm = fmaxf(sqrtf(warp_sum(ss)), kEps);
    if (lane == 0) norms_out[r] = nrm;
  }
  for (int k = lane; k < d_pad; k += 32) out[k] = k < d ? z[k] / nrm : 0.f;
}

// zn rows [r0, r0 + R) at k in [k0, k0 + kDepth) into dst (row stride kLd),
// 16 bytes per cp.async, consecutive threads on consecutive bytes.
template <int R>
__device__ __forceinline__ void stage(const float* zn, int d_pad, int r0, int k0, float* dst) {
  for (int e = threadIdx.x; e < R * kDepth / 4; e += kThreads) {
    const int r = e / (kDepth / 4), q = e % (kDepth / 4);
    cpa::cp16(dst + r * kLd + 4 * q, zn + (size_t)(r0 + r) * d_pad + k0 + 4 * q, true);
  }
}

// s[r] = sim(i0 + r, j0 + thread) / temp for the block's kRows rows: k in
// chunks of kDepth staged into tile (kCols rows, then kRows rows; stride
// kLd). On return tile holds the last chunk. Every thread calls it: it
// synchronises.
__device__ __forceinline__ void sim_column(const float* zn, int d_pad, int i0, int j0,
                                           float temp, float* tile, float (&s)[kRows]) {
  const float* rows = tile + kCols * kLd;
  const float4* col = reinterpret_cast<const float4*>(tile + threadIdx.x * kLd);
  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
  for (int k0 = 0; k0 < d_pad; k0 += kDepth) {
    __syncthreads();  // the last chunk's readers are done
    stage<kCols>(zn, d_pad, j0, k0, tile);
    stage<kRows>(zn, d_pad, i0, k0, tile + kCols * kLd);
    cpa::cp_commit();
    cpa::cp_wait<0>();
    __syncthreads();
#pragma unroll 8
    for (int q = 0; q < kDepth / 4; ++q) {
      const float4 c = col[q];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 a = reinterpret_cast<const float4*>(rows + r * kLd)[q];
        acc[r] = fmaf(a.x, c.x, acc[r]);
        acc[r] = fmaf(a.y, c.y, acc[r]);
        acc[r] = fmaf(a.z, c.z, acc[r]);
        acc[r] = fmaf(a.w, c.w, acc[r]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) s[r] = acc[r] / temp;
}

// Opts kernel into `bytes` of dynamic shared memory, once per device.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, unsigned long long& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && (done >> dev & 1ull))) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < 64) done |= 1ull << dev;
  return err;
}

__device__ __forceinline__ int partner_of(int i, int b) { return i < b ? i + b : i - b; }

__global__ void __launch_bounds__(kThreads, 1)
    ntxent_fwd_kernel(const float* zn, int d_pad, float temp, float* stats, float* terms,
                      unsigned* ticket, float* loss, int b) {
  __shared__ float red[kRows * kWarps], pos[kRows];
  __shared__ bool last;
  extern __shared__ float4 dyn[];  // the tile (kTileFloats), then kRows x n sim rows
  float* tile = reinterpret_cast<float*>(dyn);
  float* kept = tile + kTileFloats;  // when n <= kKeepCols
  const int n = 2 * b, i0 = blockIdx.x * kRows;
  const bool keep = n <= kKeepCols;

  // pass 1: the masked row max, and the positive pair's sim into pos
  float m[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) m[r] = -INFINITY;
  for (int j0 = 0; j0 < n; j0 += kCols) {
    float s[kRows];
    sim_column(zn, d_pad, i0, j0, temp, tile, s);
    const int j = j0 + threadIdx.x;
    if (j >= n) continue;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (j == partner_of(i0 + r, b)) pos[r] = s[r];
      const float v = j == i0 + r ? kNegInf : s[r];
      m[r] = fmaxf(m[r], v);
      if (keep) kept[r * n + j] = v;
    }
  }
  block_reduce<true>(m, red);

  // pass 2: sum of exp(v - max), each thread over its columns in order
  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
  if (keep) {
    for (int j = threadIdx.x; j < n; j += kCols) {  // the thread's own entries
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] += expf(kept[r * n + j] - m[r]);
    }
  } else {
    for (int j0 = 0; j0 < n; j0 += kCols) {
      float s[kRows];
      sim_column(zn, d_pad, i0, j0, temp, tile, s);
      const int j = j0 + threadIdx.x;
      if (j >= n) continue;
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] += expf((j == i0 + r ? kNegInf : s[r]) - m[r]);
    }
  }
  block_reduce<false>(acc, red);
  if (threadIdx.x < kRows && i0 + threadIdx.x < n) {
    const int r = threadIdx.x, i = i0 + r;
    float mr = m[0], sr = acc[0];
#pragma unroll
    for (int q = 1; q < kRows; ++q) {
      if (q == r) {
        mr = m[q];
        sr = acc[q];
      }
    }
    stats[i] = mr;
    stats[n + i] = sr;
    terms[i] = (logf(sr) + mr) - pos[r];
  }

  // the last block sums the n terms in a fixed order: per thread rows
  // t, t + kThreads, ..., then the lanes' tree, then the warps in order
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  float t[kRows] = {};
  for (int r = threadIdx.x; r < n; r += kThreads) t[0] += __ldcg(terms + r);
  block_reduce<false>(t, red);
  if (threadIdx.x == 0) {
    *loss = t[0] / n;
    *ticket = 0u;  // ready for the next launch on this stream
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    ntxent_bwd_kernel(const float* zn, int d_pad, float temp, const float* stats,
                      const float* gptr, float* dzi, float* dzj, int b, int d) {
  __shared__ float red[kRows * kWarps];
  __shared__ float4 ct[kCols / 4 * kRows];  // c_{i0 + r, j0 + jj} at [jj / 4][r], jj % 4
  __shared__ float half[kRows * kDepth];     // the second half's sums
  extern __shared__ float4 dyn[];  // the tile (kTileFloats)
  float* tile = reinterpret_cast<float*>(dyn);
  const int n = 2 * b, i0 = blockIdx.x * kRows;
  const float* row_max = stats;
  const float* row_sum = stats + n;
  const float* norms = stats + 2 * (size_t)n;
  const float g = *gptr;
  float mi[kRows], si[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const bool live = i0 + r < n;
    mi[r] = live ? row_max[i0 + r] : 0.f;
    si[r] = live ? row_sum[i0 + r] : 1.f;
  }

  float radial[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) radial[r] = 0.f;
  const int h = threadIdx.x / kDepth;  // the half of each column tile this thread sums
  for (int ko = 0; ko < d_pad; ko += kDepth) {  // kDepth k of dzn at a time
    const int k = ko + threadIdx.x % kDepth;
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
    for (int j0 = 0; j0 < n; j0 += kCols) {
      float s[kRows];
      sim_column(zn, d_pad, i0, j0, temp, tile, s);
      // c_ij = G_ij + G_ji, G = ((softmax - 1{partner}) / n) g, 0 on the diagonal
      const int j = j0 + threadIdx.x;
      const float mj = j < n ? row_max[j] : 0.f, sj = j < n ? row_sum[j] : 1.f;
      float* cf = reinterpret_cast<float*>(ct) + (threadIdx.x / 4) * 4 * kRows + threadIdx.x % 4;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int i = i0 + r;
        float c = 0.f;
        if (i < n && j < n && j != i) {
          const float one = j == partner_of(i, b) ? 1.f : 0.f;
          const float gij = ((expf(s[r] - mi[r]) / si[r] - one) / n) * g;
          const float gji = ((expf(s[r] - mj) / sj - one) / n) * g;
          c = gij + gji;
        }
        cf[4 * r] = c;
      }
      if (d_pad > kDepth) {  // the tile holds the last k chunk: stage chunk ko
        __syncthreads();
        stage<kCols>(zn, d_pad, j0, ko, tile);
        cpa::cp_commit();
        cpa::cp_wait<0>();
      }
      __syncthreads();
      const int jn = min(kSpan, n - j0 - h * kSpan);  // this half's columns
      const float* col = tile + h * kSpan * kLd + k - ko;
      const float4* cq = ct + h * (kSpan / 4) * kRows;
#pragma unroll 4
      for (int q = 0; q < (jn + 3) / 4; ++q) {  // j in order, 4 at a time
        float z4[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) z4[u] = col[(4 * q + u) * kLd];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float4 cr = cq[q * kRows + r];
          acc[r] = fmaf(cr.x, z4[0], acc[r]);
          acc[r] = fmaf(cr.y, z4[1], acc[r]);
          acc[r] = fmaf(cr.z, z4[2], acc[r]);
          acc[r] = fmaf(cr.w, z4[3], acc[r]);
        }
      }
    }
    // the second half hands its sums to the first, which adds them in order
    if (h == 1) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) half[r * kDepth + k - ko] = acc[r];
    }
    __syncthreads();
    if (h == 0 && k < d) {  // dzn into the output rows, read back after the barrier below
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int i = i0 + r;
        if (i >= n) continue;
        const float dzn = (acc[r] + half[r * kDepth + k - ko]) / temp;
        radial[r] = fmaf(zn[(size_t)i * d_pad + k], dzn, radial[r]);
        (i < b ? dzi + (size_t)i * d : dzj + (size_t)(i - b) * d)[k] = dzn;
      }
    }
  }
  block_reduce<false>(radial, red);
  // zn = z / max(|z|, eps): project out the radial part where |z| > eps
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = i0 + r;
    if (i >= n) continue;
    const float ni = norms[i];
    float* out = i < b ? dzi + (size_t)i * d : dzj + (size_t)(i - b) * d;
    for (int k = threadIdx.x; k < d; k += kThreads) {
      const float dzn = out[k], z = zn[(size_t)i * d_pad + k];
      out[k] = ni <= kEps ? dzn / kEps : __fsub_rn(dzn, __fmul_rn(z, radial[r])) / ni;
    }
  }
}

int n_pad_of(int b) { return (2 * b + kCols - 1) / kCols * kCols; }
int d_pad_of(int d) { return (d + kDepth - 1) / kDepth * kDepth; }

}  // namespace

// stats: (3, 2b) f32, row max, row sum of exp and norm, written for the
// backward; terms: 2b f32 scratch; ticket: one zeroed u32 per device, which
// the last block resets (launches that share it run on one stream). zn, in
// both entry points: the (n_pad, d_pad) f32 scratch (ops/ntxent.py _scratch).
MURCL_API int murcl_ntxent_fwd(const void* zi, const void* zj, float temp, void* loss,
                               void* stats, void* terms, void* ticket, void* zn, int b, int d,
                               void* stream) {
  static unsigned long long smem_set = 0;  // a bit per device
  cudaError_t err = allow_smem(ntxent_fwd_kernel, kFwdBytes, smem_set);
  if (err != cudaSuccess) return (int)err;
  const int n = 2 * b, d_pad = d_pad_of(d);
  const size_t smem = kBwdBytes + (n <= kKeepCols ? sizeof(float) * kRows * n : 0);
  cudaStream_t s = (cudaStream_t)stream;
  float* st = (float*)stats;
  ntxent_normalize_kernel<<<n_pad_of(b) / kWarps, kThreads, 0, s>>>(
      (const float*)zi, (const float*)zj, b, d, d_pad, nullptr, st + 2 * (size_t)n, (float*)zn);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ntxent_fwd_kernel<<<(n + kRows - 1) / kRows, kThreads, smem, s>>>(
      (const float*)zn, d_pad, temp, st, (float*)terms, (unsigned*)ticket, (float*)loss, b);
  return (int)cudaGetLastError();
}

MURCL_API int murcl_ntxent_bwd(const void* zi, const void* zj, float temp, const void* stats,
                               const void* g, void* dzi, void* dzj, void* zn, int b, int d,
                               void* stream) {
  static unsigned long long smem_set = 0;  // a bit per device
  cudaError_t err = allow_smem(ntxent_bwd_kernel, kBwdBytes, smem_set);
  if (err != cudaSuccess) return (int)err;
  const int n = 2 * b, d_pad = d_pad_of(d);
  cudaStream_t s = (cudaStream_t)stream;
  const float* st = (const float*)stats;
  ntxent_normalize_kernel<<<n_pad_of(b) / kWarps, kThreads, 0, s>>>(
      (const float*)zi, (const float*)zj, b, d, d_pad, st + 2 * (size_t)n, nullptr, (float*)zn);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ntxent_bwd_kernel<<<(n + kRows - 1) / kRows, kThreads, kBwdBytes, s>>>(
      (const float*)zn, d_pad, temp, st, (const float*)g, (float*)dzi, (float*)dzj, b, d);
  return (int)cudaGetLastError();
}
