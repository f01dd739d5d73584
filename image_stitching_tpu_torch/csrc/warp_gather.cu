// Compose-scale bilinear warp sample: out[c, v, u] = bilinear(img, sx, sy).
//
// Replaces the TPU kernel image_stitching_tpu/kernels/warp_gather_pallas.py
// (warp_bilinear_pallas, body _kernel).  The TPU kernel turned the gather
// into interpolation-matrix products on the MXU and needed clamped,
// anchored coordinates to fit a VMEM window.  On Hopper the gather is
// direct, so this kernel computes what the reference's CPU path computes
// (gather_sample in pipeline/compose_fused.py:242-268): a 4-tap bilinear
// sample with BORDER_REFLECT for every coordinate, in range or not.
//
// What bounds it on the H100: memory traffic.  Per output pixel it reads
// sx, sy (8 B), four RGB taps (48 B, mostly L1/L2 hits: neighbouring
// output pixels sample neighbouring source pixels) and writes 12 B of
// planar output; the arithmetic is a few dozen flops.  The design is one
// thread per output pixel, consecutive threads on consecutive columns, so
// the coordinate loads and the three planar stores are coalesced and the
// interleaved (hc, wc, 3) source is read through the cache.  No shared
// memory: the source footprint of a block has no fixed bound for a
// general warp.
//
// Numerics equal the plain PyTorch version bit for bit: the same
// expression order, with __fmul_rn/__fadd_rn so that no fused
// multiply-add changes a rounding.  Tap indices take the reference's
// int32 arithmetic for every float: the floored coordinate saturates at
// the int32 range and NaN becomes 0 (XLA's conversion on the CPU), and
// the next tap wraps at 2^31 (computed unsigned, so no signed overflow).

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int to_int32(float f) {
  if (f != f) return 0;
  if (f >= 2147483648.f) return 2147483647;
  if (f < -2147483648.f) return -2147483647 - 1;
  return (int)f;
}

__device__ __forceinline__ int next_tap(int c) {
  return (int)((unsigned)c + 1u);
}

__device__ __forceinline__ int reflect(int c, int n) {
  // cv BORDER_REFLECT: -1 -> 0, -2 -> 1, n -> n-1 (edge duplicated).
  const int period = 2 * n;
  int m = c % period;
  if (m < 0) m += period;
  return m >= n ? period - 1 - m : m;
}

__global__ void warp_bilinear_kernel(const float* __restrict__ img, int hc,
                                     int wc, const float* __restrict__ sx,
                                     const float* __restrict__ sy, int h,
                                     int w, float* __restrict__ out) {
  const long long n = (long long)h * w;
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const float x = sx[p];
  const float y = sy[p];
  const float x0 = floorf(x);
  const float y0 = floorf(y);
  const float fx = __fsub_rn(x, x0);
  const float fy = __fsub_rn(y, y0);
  const float gx = __fsub_rn(1.f, fx);
  const float gy = __fsub_rn(1.f, fy);
  const int x0i = to_int32(x0);
  const int y0i = to_int32(y0);
  const int xa = reflect(x0i, wc), xb = reflect(next_tap(x0i), wc);
  const int ya = reflect(y0i, hc), yb = reflect(next_tap(y0i), hc);
  const float* r0 = img + (size_t)ya * wc * 3;
  const float* r1 = img + (size_t)yb * wc * 3;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float i00 = r0[xa * 3 + c], i01 = r0[xb * 3 + c];
    const float i10 = r1[xa * 3 + c], i11 = r1[xb * 3 + c];
    float acc = __fmul_rn(__fmul_rn(i00, gx), gy);
    acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(i01, fx), gy));
    acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(i10, gx), fy));
    acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(i11, fx), fy));
    out[(size_t)c * n + p] = acc;
  }
}

}  // namespace

extern "C" int warp_bilinear_launch(const void* img, int hc, int wc,
                                    const void* sx, const void* sy, int h,
                                    int w, void* out, void* stream) {
  const long long n = (long long)h * w;
  if (n > 0) {
    const int threads = 256;
    const long long blocks = (n + threads - 1) / threads;
    warp_bilinear_kernel<<<(unsigned)blocks, threads, 0,
                           (cudaStream_t)stream>>>(
        (const float*)img, hc, wc, (const float*)sx, (const float*)sy, h, w,
        (float*)out);
  }
  return (int)cudaGetLastError();
}
