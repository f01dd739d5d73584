// Multiband pyramid accumulate of one compose rect into the canvas bands.
//
// Replaces the TPU kernel image_stitching_tpu/kernels/multiband_pallas.py
// (pyramid_accumulate, body _kernel).  For one image: x4 = [warped (3
// planes); weight], Gaussian levels g[b + 1] = pyrDown(g[b]) with the 5-tap
// [1 4 6 4 1] / 16 kernel under BORDER_REFLECT_101, and per band
// lap = g[b] - pyrUp(g[b + 1]) (the last band lap = g[b]); then
// acc[b][0:3] += lap[0:3] * g[b][3] and acc[b][3] += g[b][3] at the band's
// offset.  The accumulators are the port's (4, Hb, Wb) planes, weight in
// channel 3, where the TPU kernel kept separate `accs` and `waccs`.
//
// What bounds it on the H100: memory traffic.  Per image it must read the
// rect (16 B a pixel) and read and write the accumulator window of every
// band (4/3 of 32 B a rect pixel); the 5x5 taps are a few dozen flops a
// pixel.  The TPU kernel kept the whole pyramid in VMEM; here the levels
// are small enough to stay in the 50 MB L2 between launches:
//   * one launch per level for the down pass: a thread per output pixel
//     and channel reads its 5x5 window (vertical sums first, then
//     horizontal, as the plain version's D_h x D_w^T), through L1/L2;
//   * one launch per band for "up, subtract, weight, accumulate": a thread
//     per band pixel computes the 4 channels' pyrUp from the next level's
//     3x3 footprint, the Laplacian, and the read-modify-write of its own 4
//     accumulator elements.  No two threads of a launch write the same
//     element, so no atomics.
// Rects of different images overlap on the canvas.  The TPU kernel relied
// on its sequential grid for the read-modify-write order; here the wrapper
// launches image after image on one stream, which orders them the same way.
//
// Numerics: the plain version sums the same taps through dense banded
// matrices in another order, so results agree to float32 rounding.

#include <cuda_runtime.h>

namespace {

constexpr int kTx = 32;
constexpr int kTy = 8;
constexpr int kMaxBands = 16;

__device__ __forceinline__ int reflect101(int i, int n) {
  if (n == 1) return 0;
  const int period = 2 * (n - 1);
  i %= period;
  if (i < 0) i += period;
  return i < n ? i : period - i;
}

__device__ __forceinline__ float tap(int k) {
  return k == 2 ? 0.375f : (k == 1 || k == 3 ? 0.25f : 0.0625f);
}

// src: channels 0-2 at rgb (planar, h x w each), channel 3 at wgt.
__global__ void pyr_down_kernel(const float* __restrict__ rgb,
                                const float* __restrict__ wgt, int h, int w,
                                float* __restrict__ dst) {
  const int oh = (h + 1) / 2, ow = (w + 1) / 2;
  const int x = blockIdx.x * kTx + threadIdx.x;
  const int y = blockIdx.y * kTy + threadIdx.y;
  const int c = blockIdx.z;
  if (x >= ow || y >= oh) return;
  const float* src = c < 3 ? rgb + (size_t)c * h * w : wgt;
  int rows[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) rows[i] = reflect101(2 * y + i - 2, h) * w;
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < 5; ++j) {
    const int col = reflect101(2 * x + j - 2, w);
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < 5; ++i) t += tap(i) * src[rows[i] + col];
    acc += tap(j) * t;
  }
  dst[((size_t)c * oh + y) * ow + x] = acc;
}

// g: level b, channels 0-2 at g_rgb and channel 3 at g_w (h x w); gn: the
// next level (4, hn, wn) or null for the last band.  acc: (4, acc_h, acc_w)
// with the band's window at (oy, ox).
__global__ void band_accumulate_kernel(const float* __restrict__ g_rgb,
                                       const float* __restrict__ g_w, int h,
                                       int w, const float* __restrict__ gn,
                                       int hn, int wn, float* __restrict__ acc,
                                       int acc_h, int acc_w, int oy, int ox) {
  const int x = blockIdx.x * kTx + threadIdx.x;
  const int y = blockIdx.y * kTy + threadIdx.y;
  if (x >= w || y >= h) return;
  const size_t plane = (size_t)h * w;
  const size_t p = (size_t)y * w + x;
  float lap[3];
  const float wt = g_w[p];
#pragma unroll
  for (int c = 0; c < 3; ++c) lap[c] = g_rgb[c * plane + p];
  if (gn != nullptr) {
    // pyrUp: zero-stuff x2, 5-tap blur per axis, x4.  Output row y takes
    // the taps a whose reflected row t is even, from input row t / 2.
    int rin[5], cin[5];
    float rw[5], cw[5];
#pragma unroll
    for (int a = 0; a < 5; ++a) {
      const int t = reflect101(y + a - 2, h);
      const bool ok = (t % 2 == 0) && (t / 2 < hn);
      rin[a] = ok ? t / 2 : 0;
      rw[a] = ok ? 2.f * tap(a) : 0.f;
      const int s = reflect101(x + a - 2, w);
      const bool oks = (s % 2 == 0) && (s / 2 < wn);
      cin[a] = oks ? s / 2 : 0;
      cw[a] = oks ? 2.f * tap(a) : 0.f;
    }
    const size_t nplane = (size_t)hn * wn;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float* src = gn + c * nplane;
      float up = 0.f;
#pragma unroll
      for (int a = 0; a < 5; ++a) {
        if (rw[a] == 0.f) continue;
        const float* row = src + (size_t)rin[a] * wn;
        float t = 0.f;
#pragma unroll
        for (int bb = 0; bb < 5; ++bb) t += cw[bb] * row[cin[bb]];
        up += rw[a] * t;
      }
      lap[c] -= up;
    }
  }
  const size_t aplane = (size_t)acc_h * acc_w;
  const size_t q = (size_t)(oy + y) * acc_w + (ox + x);
#pragma unroll
  for (int c = 0; c < 3; ++c) acc[c * aplane + q] += lap[c] * wt;
  acc[3 * aplane + q] += wt;
}

}  // namespace

// One image.  warped (3, ph, pw) and weight (ph, pw) f32; scratch holds
// levels 1..n_bands, each (4, ph >> b, pw >> b), back to back; accs[b] is
// band b's (4, acc_hw[2b], acc_hw[2b + 1]) accumulator with the window at
// offs[2b] (y), offs[2b + 1] (x).  Host arrays: accs, acc_hw, offs.
extern "C" int pyramid_accumulate_launch(const void* warped,
                                         const void* weight, void* scratch,
                                         int ph, int pw, int n_bands,
                                         const void* accs, const void* acc_hw,
                                         const void* offs, void* stream) {
  if (n_bands < 0 || n_bands >= kMaxBands) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  float* const* acc = (float* const*)accs;
  const int* hw = (const int*)acc_hw;
  const int* off = (const int*)offs;
  const float* lvl_rgb[kMaxBands + 1];
  const float* lvl_w[kMaxBands + 1];
  lvl_rgb[0] = (const float*)warped;
  lvl_w[0] = (const float*)weight;
  float* next = (float*)scratch;
  const dim3 block(kTx, kTy);
  for (int b = 1; b <= n_bands; ++b) {
    const int h = ph >> (b - 1), w = pw >> (b - 1);
    const int oh = ph >> b, ow = pw >> b;
    const dim3 grid((ow + kTx - 1) / kTx, (oh + kTy - 1) / kTy, 4);
    pyr_down_kernel<<<grid, block, 0, s>>>(lvl_rgb[b - 1], lvl_w[b - 1], h,
                                           w, next);
    lvl_rgb[b] = next;
    lvl_w[b] = next + 3 * (size_t)oh * ow;
    next += 4 * (size_t)oh * ow;
  }
  for (int b = 0; b <= n_bands; ++b) {
    const int h = ph >> b, w = pw >> b;
    const dim3 grid((w + kTx - 1) / kTx, (h + kTy - 1) / kTy);
    const float* gn = b < n_bands ? lvl_rgb[b + 1] : nullptr;
    band_accumulate_kernel<<<grid, block, 0, s>>>(
        lvl_rgb[b], lvl_w[b], h, w, gn, ph >> (b + 1), pw >> (b + 1), acc[b],
        hw[2 * b], hw[2 * b + 1], off[2 * b], off[2 * b + 1]);
  }
  return (int)cudaGetLastError();
}
