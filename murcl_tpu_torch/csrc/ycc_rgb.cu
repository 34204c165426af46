// JPEG YCbCr planes -> interleaved RGB, as libjpeg(-turbo) decodes them:
// "fancy" upsampling of the chroma planes, then jdcolor.c's 16-bit
// fixed-point tables, clamped to 0-255.
//
// Not the port of a TPU kernel: it stands in for the upsampling and colour
// conversion inside OpenSlide's libjpeg, on nvJPEG's planes
// (preprocess/nvjpeg.py decodes JPEG tiles to Y, Cb and Cr planes because
// nvJPEG's own RGB output upsamples chroma otherwise). Its plain twin is
// nvjpeg.py ycc_to_rgb_plain, about 70 small PyTorch ops per tile; here one
// launch per tile, one thread per output pixel, so that 8 reading threads
// do not queue on the interpreter for each tile.
//
// Chroma planes are (ch, cw) for a (h, w) luma plane: full size, or halved
// across (h2v1), down (h1v2) or both (h2v2), sizes rounded up. Per output
// pixel, with neighbours clamped to the plane as libjpeg replicates edges:
//   h2v1 / h1v2: (3 * near + far + 1 or 2) >> 2 along the halved axis;
//   h2v2: column sums s = 3 * near row + far row, then
//         (3 * s[j] + s[j -/+ 1] + 8 or 7) >> 4 across.
// Integer arithmetic throughout, so the twin agrees bit for bit.
#include "common.cuh"

#include <cstdint>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ int px(const uint8_t* p, int pitch, int r, int c) {
  return p[(size_t)r * pitch + c];
}

// one chroma value at output (r, x); fv, fh: 2 where the axis is halved
__device__ __forceinline__ int chroma(const uint8_t* p, int pitch, int ch, int cw, int fv,
                                      int fh, int r, int x) {
  if (fv == 1 && fh == 1) return px(p, pitch, r, x);
  if (fv == 1) {  // h2v1
    const int j = x >> 1;
    const int nb = (x & 1) ? min(j + 1, cw - 1) : max(j - 1, 0);
    return (3 * px(p, pitch, r, j) + px(p, pitch, r, nb) + ((x & 1) ? 2 : 1)) >> 2;
  }
  if (fh == 1) {  // h1v2
    const int i = r >> 1;
    const int nb = (r & 1) ? min(i + 1, ch - 1) : max(i - 1, 0);
    return (3 * px(p, pitch, i, x) + px(p, pitch, nb, x) + ((r & 1) ? 2 : 1)) >> 2;
  }
  const int i = r >> 1;  // h2v2
  const int far = (r & 1) ? min(i + 1, ch - 1) : max(i - 1, 0);
  const int j = x >> 1;
  const int nb = (x & 1) ? min(j + 1, cw - 1) : max(j - 1, 0);
  const int s = 3 * px(p, pitch, i, j) + px(p, pitch, far, j);
  const int sn = 3 * px(p, pitch, i, nb) + px(p, pitch, far, nb);
  return (3 * s + sn + ((x & 1) ? 7 : 8)) >> 4;
}

// jdcolor.c's FIX(x): x in 16-bit fixed point, rounded
constexpr int kCrR = (int)(1.40200 * 65536.0 + 0.5);
constexpr int kCbB = (int)(1.77200 * 65536.0 + 0.5);
constexpr int kCrG = (int)(0.71414 * 65536.0 + 0.5);
constexpr int kCbG = (int)(0.34414 * 65536.0 + 0.5);

__global__ void __launch_bounds__(THREADS)
ycc_rgb_kernel(const uint8_t* __restrict__ y, const uint8_t* __restrict__ cb,
               const uint8_t* __restrict__ cr, uint8_t* __restrict__ out, int h, int w,
               int ch, int cw, int fv, int fh) {
  const long long e = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (e >= (long long)h * w) return;
  const int r = (int)(e / w), x = (int)(e % w);
  const int cbv = chroma(cb, cw, ch, cw, fv, fh, r, x) - 128;
  const int crv = chroma(cr, cw, ch, cw, fv, fh, r, x) - 128;
  const int half = 1 << 15;
  const int yy = y[e];
  const int rr = yy + ((kCrR * crv + half) >> 16);
  const int gg = yy + ((-kCbG * cbv + half - kCrG * crv) >> 16);
  const int bb = yy + ((kCbB * cbv + half) >> 16);
  uint8_t* o = out + 3 * e;
  o[0] = (uint8_t)min(max(rr, 0), 255);
  o[1] = (uint8_t)min(max(gg, 0), 255);
  o[2] = (uint8_t)min(max(bb, 0), 255);
}

}  // namespace

// y: (h, w), cb and cr: (ch, cw) uint8, each contiguous; out: (h, w, 3)
// uint8. fv, fh: 2 where chroma is halved down / across, else 1.
MURCL_API int murcl_ycc_to_rgb(const void* y, const void* cb, const void* cr, void* out, int h,
                               int w, int ch, int cw, int fv, int fh, void* stream) {
  const long long n = (long long)h * w;
  const unsigned blocks = (unsigned)((n + THREADS - 1) / THREADS);
  ycc_rgb_kernel<<<blocks < 1 ? 1 : blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)y, (const uint8_t*)cb, (const uint8_t*)cr, (uint8_t*)out, h, w, ch, cw,
      fv, fh);
  return (int)cudaGetLastError();
}
