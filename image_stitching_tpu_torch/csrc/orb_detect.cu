// K6: one ORB pyramid level's detection maps in one launch.
//
// Replaces no TPU kernel: the JAX package leaves ORB's level detection to
// XLA, which fuses the chain of elementwise ops into a few loops on the
// TPU.  The port ran the same chain as ~680 eager PyTorch ops a level and
// image (ops/features/orb.py: resize, fast_corner_mask,
// harris_response_map, the NMS of detect_level, gaussian_blur), so the
// stitch's feature stage was the host dispatching those ops while the card
// waited.  This kernel computes, for one level of one image:
//   img    the level plane: the u8 or f32 image itself at level 0, else its
//          bilinear resize (ops/imgproc.py resize: half-pixel centres,
//          edge-clamped, each step an fma rounded once to f32 from the f64
//          product and sum);
//   blur   gaussian_blur(img, 2.0, 3): reflect-101 borders, rows then
//          columns, fma(k0, x0, k1 x1), then fma(k_i, x_i, acc);
//   harris harris_response_map(img): Sobel with edge replicate, the 7x7 box
//          sums of the gradient products added row-major from zero over
//          edge-replicated products, (det - k tr^2) * scale^4;
//   rank   harris where the FAST-9/16 corner of rint(img) (at level 0 the
//          image's own pixels) survives 3x3 NMS among corners inside the
//          `border`, else -inf: the plane detect_level sorts.
//
// What bounds it on the H100: the bytes.  Per output pixel it reads the
// image once (a u8 or f32 pixel, or the 4 taps of a resize, mostly cached)
// and writes four f32 planes: ~17 bytes a pixel, ~136 MB for a 2448x3264
// level 0 (~40 us at 3.35 TB/s).  The arithmetic is ~1,000 operations a
// pixel, most of them the 147 adds of the Harris box sums, which must run
// in the plain version's order.  The design:
//   * one block per 32x32 output tile; the level plane of the tile and a
//     5-pixel halo (FAST 3 + NMS 1 for the corners; Sobel 1 + box 3 + NMS 1
//     for the response; blur 3) is made once into shared memory, and every
//     later step reads shared memory only: gradient products over the tile
//     + 4, corner flags and responses over the tile + 1, the vertical blur
//     over the tile's rows and columns + 3;
//   * the halo is indexed by plane coordinates: each step applies its own
//     border rule (clamp for Sobel, the box and FAST, reflect-101 for the
//     blur) and reads the in-plane pixel it names, so tiles at the plane's
//     edge need no padded copies;
//   * the box sums slide down a column: a thread keeps the running sums of
//     5 vertically adjacent outputs in registers and reads each product row
//     once for all 5, adding each output's 49 taps in row-major order;
//   * the four planes are written once, 128 bytes a row of the tile.
// Numerics equal the plain version bit for bit: every float operation is a
// _rn intrinsic, so no multiply-add is contracted, and the fma steps are
// f64 products and sums rounded once to f32 as ops/imgproc.py::fma does.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;                 // output tile, rows and columns
constexpr int kThreads = 256;
constexpr int kImg = kTile + 10;          // level plane: tile + 5
constexpr int kProd = kTile + 8;          // gradient products: tile + 4
constexpr int kResp = kTile + 2;          // responses, corner flags: tile + 1
constexpr int kVb = kTile + 6;            // vertical blur columns: tile + 3
constexpr int kBandRows = 5;              // box-sum outputs a thread
constexpr int kBands = (kResp + kBandRows - 1) / kBandRows;
constexpr int kTaps = 7;                  // blur taps and box width

struct Consts {
  float taps[kTaps];     // gaussian_kernel1d(2.0, 3)
  float harris_k;        // 0.04 as float32
  float harris_scale;    // (1 / (4 * 7 * 255))^4 as float32
};

// FAST's ring, (dx, dy) clockwise from 12 o'clock (orb.py _FAST_RING).
__constant__ int kRingDx[16] = {0, 1, 2, 3, 3, 3, 2, 1,
                                0, -1, -2, -3, -3, -3, -2, -1};
__constant__ int kRingDy[16] = {3, 3, 2, 1, 0, -1, -2, -3,
                                -3, -3, -2, -1, 0, 1, 2, 3};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ int reflect101(int i, int n) {
  i = i < 0 ? -i : i;
  return i > n - 1 ? 2 * (n - 1) - i : i;
}

// a * b + c, the f64 product and sum rounded once to f32 (imgproc.fma).
__device__ __forceinline__ float fma64(float a, float b, float c) {
  return __double2float_rn(__dadd_rn(__dmul_rn((double)a, (double)b),
                                     (double)c));
}

// One bilinear source coordinate of `resize`: the floored, clamped tap,
// the next tap and the clamped weight.
__device__ __forceinline__ void resize_axis(int i, float s, int n, int* i0,
                                            int* i1, float* wt) {
  const float src = fma64(__fadd_rn((float)i, 0.5f), s, -0.5f);
  const float f = fminf(fmaxf(floorf(src), 0.f), (float)(n - 1));
  *wt = fminf(fmaxf(__fsub_rn(src, f), 0.f), 1.f);
  *i0 = (int)f;
  *i1 = min(*i0 + 1, n - 1);
}

template <typename T>
__device__ __forceinline__ float level_pixel(const T* __restrict__ gray,
                                             int h, int w, int y, int x,
                                             bool resize, float sy,
                                             float sx) {
  if (!resize) return (float)gray[(size_t)y * w + x];
  int y0, y1, x0, x1;
  float wy, wx;
  resize_axis(y, sy, h, &y0, &y1, &wy);
  resize_axis(x, sx, w, &x0, &x1, &wx);
  const T* r0 = gray + (size_t)y0 * w;
  const T* r1 = gray + (size_t)y1 * w;
  const float a0 = (float)r0[x0], b0 = (float)r1[x0];
  const float a1 = (float)r0[x1], b1 = (float)r1[x1];
  const float c0 = fma64(__fsub_rn(b0, a0), wy, a0);
  const float c1 = fma64(__fsub_rn(b1, a1), wy, a1);
  return fma64(__fsub_rn(c1, c0), wx, c0);
}

// The blur's 7-tap sum in the plain version's order.
__device__ __forceinline__ float blur_taps(const Consts& cs, const float* v) {
  float acc = fma64(v[0], cs.taps[0], __fmul_rn(cs.taps[1], v[1]));
#pragma unroll
  for (int i = 2; i < kTaps; ++i) acc = fma64(v[i], cs.taps[i], acc);
  return acc;
}

__device__ __forceinline__ bool run9(unsigned r) {
#pragma unroll
  for (int i = 0; i < 8; ++i) r &= ((r << 1) | (r >> 15)) & 0xFFFFu;
  return r != 0u;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
orb_detect_maps_kernel(const T* __restrict__ gray, int h, int w, int lh,
                       int lw, int resize, const Consts cs, int threshold,
                       int border, float* __restrict__ img_out,
                       float* __restrict__ blur_out,
                       float* __restrict__ harris_out,
                       float* __restrict__ rank_out) {
  __shared__ float s_img[kImg][kImg];       // origin (gy0 - 5, gx0 - 5)
  __shared__ float s_xx[kProd][kProd];      // origin (gy0 - 4, gx0 - 4)
  __shared__ float s_yy[kProd][kProd];
  __shared__ float s_xy[kProd][kProd];
  __shared__ float s_h[kResp][kResp];       // origin (gy0 - 1, gx0 - 1)
  __shared__ unsigned char s_c[kResp][kResp];
  __shared__ float s_vb[kTile][kVb];        // origin (gy0, gx0 - 3)

  const int gy0 = blockIdx.y * kTile;
  const int gx0 = blockIdx.x * kTile;
  const int tid = threadIdx.x;
  const float sy = __double2float_rn((double)h / (double)lh);
  const float sx = __double2float_rn((double)w / (double)lw);

  // 1. The level plane over the tile + 5, in-plane pixels only.
  for (int i = tid; i < kImg * kImg; i += kThreads) {
    const int r = i / kImg, c = i % kImg;
    const int y = gy0 - 5 + r, x = gx0 - 5 + c;
    if (y < 0 || y >= lh || x < 0 || x >= lw) continue;
    s_img[r][c] = level_pixel(gray, h, w, y, x, resize != 0, sy, sx);
  }
  __syncthreads();

  // Plane pixel (y, x), clamped to the plane (Sobel's and FAST's reads).
  auto img_at = [&](int y, int x) {
    return s_img[clampi(y, 0, lh - 1) - (gy0 - 5)]
                [clampi(x, 0, lw - 1) - (gx0 - 5)];
  };

  // 2a. Sobel gradient products over the tile + 4.
  for (int i = tid; i < kProd * kProd; i += kThreads) {
    const int r = i / kProd, c = i % kProd;
    const int y = gy0 - 4 + r, x = gx0 - 4 + c;
    if (y < 0 || y >= lh || x < 0 || x >= lw) continue;
    const float gx = __fsub_rn(
        __fadd_rn(__fadd_rn(img_at(y - 1, x + 1),
                            __fmul_rn(2.f, img_at(y, x + 1))),
                  img_at(y + 1, x + 1)),
        __fadd_rn(__fadd_rn(img_at(y - 1, x - 1),
                            __fmul_rn(2.f, img_at(y, x - 1))),
                  img_at(y + 1, x - 1)));
    const float gy = __fsub_rn(
        __fadd_rn(__fadd_rn(img_at(y + 1, x - 1),
                            __fmul_rn(2.f, img_at(y + 1, x))),
                  img_at(y + 1, x + 1)),
        __fadd_rn(__fadd_rn(img_at(y - 1, x - 1),
                            __fmul_rn(2.f, img_at(y - 1, x))),
                  img_at(y - 1, x + 1)));
    s_xx[r][c] = __fmul_rn(gx, gx);
    s_yy[r][c] = __fmul_rn(gy, gy);
    s_xy[r][c] = __fmul_rn(gx, gy);
  }

  // 2b. FAST-9/16 corner flags over the tile + 1.
  for (int i = tid; i < kResp * kResp; i += kThreads) {
    const int r = i / kResp, c = i % kResp;
    const int y = gy0 - 1 + r, x = gx0 - 1 + c;
    bool corner = false;
    if (y >= 3 && y < lh - 3 && x >= 3 && x < lw - 3) {
      const int center = (int)rintf(img_at(y, x));
      const int hi = center + threshold, lo = center - threshold;
      unsigned bright = 0u, dark = 0u;
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const int nb = (int)rintf(img_at(y + kRingDy[k], x + kRingDx[k]));
        bright |= (unsigned)(nb > hi) << k;
        dark |= (unsigned)(nb < lo) << k;
      }
      corner = run9(bright) || run9(dark);
    }
    s_c[r][c] = corner;
  }

  // 2c. The vertical blur pass over the tile's rows, its columns + 3.
  for (int i = tid; i < kTile * kVb; i += kThreads) {
    const int r = i / kVb, c = i % kVb;
    const int y = gy0 + r, x = gx0 - 3 + c;
    if (y >= lh || x < 0 || x >= lw) continue;
    float v[kTaps];
#pragma unroll
    for (int k = 0; k < kTaps; ++k) {
      v[k] = s_img[reflect101(y + k - 3, lh) - (gy0 - 5)][x - (gx0 - 5)];
    }
    s_vb[r][c] = blur_taps(cs, v);
  }
  __syncthreads();

  // 3a. Harris responses over the tile + 1: thread (band, column) slides
  // down kBandRows outputs, reading each clamped product row once.
  if (tid < kBands * kResp) {
    const int c = tid % kResp;
    const int r0 = (tid / kResp) * kBandRows;
    const int x = gx0 - 1 + c;
    if (x >= 0 && x < lw) {
      int cols[kTaps];
#pragma unroll
      for (int k = 0; k < kTaps; ++k) {
        cols[k] = clampi(x + k - 3, 0, lw - 1) - (gx0 - 4);
      }
      float axx[kBandRows], ayy[kBandRows], axy[kBandRows];
#pragma unroll
      for (int o = 0; o < kBandRows; ++o) axx[o] = ayy[o] = axy[o] = 0.f;
#pragma unroll
      for (int j = 0; j < kBandRows + kTaps - 1; ++j) {
        // Product row of output o's tap row j - o; rows of outputs past the
        // region (the last band) are kept inside the array and not stored.
        const int pr = min(clampi(gy0 - 1 + r0 + j - 3, 0, lh - 1) -
                               (gy0 - 4), kProd - 1);
        float vxx[kTaps], vyy[kTaps], vxy[kTaps];
#pragma unroll
        for (int k = 0; k < kTaps; ++k) {
          vxx[k] = s_xx[pr][cols[k]];
          vyy[k] = s_yy[pr][cols[k]];
          vxy[k] = s_xy[pr][cols[k]];
        }
#pragma unroll
        for (int o = 0; o < kBandRows; ++o) {
          if (j - o >= 0 && j - o < kTaps) {
#pragma unroll
            for (int k = 0; k < kTaps; ++k) {
              axx[o] = __fadd_rn(axx[o], vxx[k]);
              ayy[o] = __fadd_rn(ayy[o], vyy[k]);
              axy[o] = __fadd_rn(axy[o], vxy[k]);
            }
          }
        }
      }
#pragma unroll
      for (int o = 0; o < kBandRows; ++o) {
        const int r = r0 + o;
        const int y = gy0 - 1 + r;
        if (r < kResp && y >= 0 && y < lh) {
          const float det = __fsub_rn(__fmul_rn(axx[o], ayy[o]),
                                      __fmul_rn(axy[o], axy[o]));
          const float tr = __fadd_rn(axx[o], ayy[o]);
          s_h[r][c] = __fmul_rn(
              __fsub_rn(det, __fmul_rn(__fmul_rn(cs.harris_k, tr), tr)),
              cs.harris_scale);
        }
      }
    }
  }

  // 3b. The level plane and the horizontal blur pass out.
  for (int i = tid; i < kTile * kTile; i += kThreads) {
    const int r = i / kTile, c = i % kTile;
    const int y = gy0 + r, x = gx0 + c;
    if (y >= lh || x >= lw) continue;
    float v[kTaps];
#pragma unroll
    for (int k = 0; k < kTaps; ++k) {
      v[k] = s_vb[r][reflect101(x + k - 3, lw) - (gx0 - 3)];
    }
    const size_t o = (size_t)y * lw + x;
    img_out[o] = s_img[r + 5][c + 5];
    blur_out[o] = blur_taps(cs, v);
  }
  __syncthreads();

  // 4. The response and the rank plane out: a corner inside the border
  // that no corner of its 3x3 neighbourhood exceeds (max_pool2d over the
  // corners' responses, NaN propagating, then masked >= pooled).
  for (int i = tid; i < kTile * kTile; i += kThreads) {
    const int r = i / kTile, c = i % kTile;
    const int y = gy0 + r, x = gx0 + c;
    if (y >= lh || x >= lw) continue;
    const float hc = s_h[r + 1][c + 1];
    bool cand = s_c[r + 1][c + 1] && y >= border && y < lh - border &&
                x >= border && x < lw - border;
    if (cand) {
#pragma unroll
      for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
        for (int dx = -1; dx <= 1; ++dx) {
          const int yy = y + dy, xx = x + dx;
          if (yy >= 0 && yy < lh && xx >= 0 && xx < lw &&
              s_c[r + 1 + dy][c + 1 + dx] &&
              !(s_h[r + 1 + dy][c + 1 + dx] <= hc)) {
            cand = false;
          }
        }
      }
    }
    const size_t o = (size_t)y * lw + x;
    harris_out[o] = hc;
    rank_out[o] = cand ? hc : -INFINITY;
  }
}

}  // namespace

extern "C" int orb_detect_maps_launch(const void* gray, int gray_u8, int h,
                                      int w, int lh, int lw, int resize,
                                      const float* consts, int threshold,
                                      int border, void* img, void* blur,
                                      void* harris, void* rank,
                                      void* stream) {
  if (h < 1 || w < 1 || lh < 4 || lw < 4 || (!resize && (lh != h ||
                                                          lw != w))) {
    return (int)cudaErrorInvalidValue;
  }
  Consts cs;
  for (int i = 0; i < kTaps; ++i) cs.taps[i] = consts[i];
  cs.harris_k = consts[kTaps];
  cs.harris_scale = consts[kTaps + 1];
  const dim3 grid((lw + kTile - 1) / kTile, (lh + kTile - 1) / kTile);
  cudaStream_t st = (cudaStream_t)stream;
  if (gray_u8) {
    orb_detect_maps_kernel<uint8_t><<<grid, kThreads, 0, st>>>(
        (const uint8_t*)gray, h, w, lh, lw, resize, cs, threshold, border,
        (float*)img, (float*)blur, (float*)harris, (float*)rank);
  } else {
    orb_detect_maps_kernel<float><<<grid, kThreads, 0, st>>>(
        (const float*)gray, h, w, lh, lw, resize, cs, threshold, border,
        (float*)img, (float*)blur, (float*)harris, (float*)rank);
  }
  return (int)cudaGetLastError();
}
