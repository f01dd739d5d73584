// ORB per-keypoint sampling over all pyramid levels of one image in one
// launch: IC-angle moments + rotated rBRIEF reads.
//
// Replaces the TPU kernels image_stitching_tpu/kernels/orb_sample_pallas.py
// (orb_sample_pallas, body _kernel) and kernels/orb_stream_pallas.py
// (orb_sample_stream_pallas, the same contract for planes past the TPU's
// VMEM budget).  Per keypoint it computes the intensity-centroid moments
// (m10, m01) over the radius-r disk of its level's raw plane, the angle
// atan2(m01, m10), and the 512 rBRIEF endpoint reads on the level's
// sigma-2 blurred plane, rotated by cos/sin of that angle, rounded half to
// even and clipped to the image box; the 256 pair comparisons are packed
// LSB-first into 8 descriptor words.
//
// What bounds it on the H100: memory latency.  Each keypoint reads ~1.3k
// disk pixels (short contiguous rows, cached) and 512 scattered pixels of
// the blurred plane; there is almost no arithmetic.  Counting each pixel
// the keypoints read once, the default path's 4000 keypoints of one image
// move ~18 MB, 0.005 ms at the HBM rate (chip_smoke.py phase 5); the
// kernel's time is the latency of its dependent reads.  The TPU kernel staged
// windows in VMEM, one level per call.  Here:
//   * one launch takes every level of an image: the level planes come as a
//     table of up to 8 (raw, blur, h, w) entries passed by value, and each
//     keypoint carries its level index, so ~4000 keypoints make ~500 blocks
//     of 8 warps (one warp per keypoint) instead of 8 launches of 31-109;
//   * the disk is walked by rows: a row's half-width comes from a table in
//     shared memory (no division or modulo per pixel), lanes take
//     neighbouring pixels of the row (a second read covers rows wider than
//     32), and the row loop is unrolled so that several independent reads
//     are in flight per lane; a keypoint whose disk lies inside the plane
//     skips the clamps;
//   * the 16 endpoint reads of a lane are all issued before the first
//     comparison, and __ballot_sync packs the 256 comparisons into
//     descriptor words with no shared memory;
//   * the samples are written only when asked for (the detector needs the
//     angle and the descriptor words); the kernel writes the angle it used.
// No VMEM-style plane budget exists here, so one kernel serves every level.
//
// Numerics follow the plain PyTorch version (kernels/orb_sample.py):
// reads clamp to the image (edge padding); the rotation uses cos/sin of
// atan2 like the reference's XLA path; products and sums in the rotation
// use __fmul_rn/__fadd_rn so no fused multiply-add changes a rounding.
// The moment sum runs in another order than the plain version's matmul,
// so a sample may differ where a rotated coordinate lies within rounding
// error of a .5 boundary.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSamples = 512;
constexpr int kWarpsPerBlock = 8;
constexpr int kMaxLevels = 8;
constexpr int kMaxRadius = 31;

struct Levels {
  const float* raw[kMaxLevels];
  const float* blur[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__global__ void __launch_bounds__(32 * kWarpsPerBlock)
orb_sample_levels_kernel(const Levels lv, const float* __restrict__ xy,
                         const int* __restrict__ level,
                         const float* __restrict__ pattern, int n_kp,
                         int radius, float* __restrict__ samples,
                         float* __restrict__ angle,
                         float* __restrict__ moments,
                         int32_t* __restrict__ desc) {
  __shared__ int s_hw[2 * kMaxRadius + 1];
  if (threadIdx.x <= 2 * radius) {
    // floor(sqrt(r^2 - dy^2)), exact for these small integers.
    const int dy = (int)threadIdx.x - radius;
    const int n = radius * radius - dy * dy;
    int s = (int)sqrtf((float)n);
    while (s * s > n) --s;
    while ((s + 1) * (s + 1) <= n) ++s;
    s_hw[threadIdx.x] = s;
  }
  __syncthreads();
  const int kp = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (kp >= n_kp) return;  // whole warp leaves together: ballots stay full

  // The keypoint's level plane, selected with static indices so that the
  // table stays in the parameter space.
  const int lvl = level[kp];
  const float* raw = lv.raw[0];
  const float* blur = lv.blur[0];
  int h = lv.h[0], w = lv.w[0];
#pragma unroll
  for (int l = 1; l < kMaxLevels; ++l) {
    if (l == lvl) {
      raw = lv.raw[l];
      blur = lv.blur[l];
      h = lv.h[l];
      w = lv.w[l];
    }
  }

  const float xf = xy[2 * kp];
  const float yf = xy[2 * kp + 1];
  const int cx = clampi(__float2int_rn(xf), 0, w - 1);
  const int cy = clampi(__float2int_rn(yf), 0, h - 1);
  const bool inside = cx >= radius && cx + radius < w && cy >= radius &&
                      cy + radius < h;

  // IC-angle moments over the disk of the raw plane, row by row.
  float m10 = 0.f, m01 = 0.f;
#pragma unroll 4
  for (int dy = -radius; dy <= radius; ++dy) {
    const int hw = s_hw[dy + radius];
    const int dx0 = lane - hw;
    const int dx1 = dx0 + 32;
    const float* rp =
        raw + (size_t)(inside ? cy + dy : clampi(cy + dy, 0, h - 1)) * w;
    float v0 = 0.f, v1 = 0.f;
    if (dx0 <= hw) {
      v0 = __ldg(rp + (inside ? cx + dx0 : clampi(cx + dx0, 0, w - 1)));
    }
    if (dx1 <= hw) {
      v1 = __ldg(rp + (inside ? cx + dx1 : clampi(cx + dx1, 0, w - 1)));
    }
    m10 = __fadd_rn(m10, __fmul_rn(v0, (float)dx0));
    m01 = __fadd_rn(m01, __fmul_rn(v0, (float)dy));
    m10 = __fadd_rn(m10, __fmul_rn(v1, (float)dx1));
    m01 = __fadd_rn(m01, __fmul_rn(v1, (float)dy));
  }
  for (int off = 16; off > 0; off >>= 1) {
    m10 += __shfl_xor_sync(0xffffffffu, m10, off);
    m01 += __shfl_xor_sync(0xffffffffu, m01, off);
  }
  const float ang = atan2f(m01, m10);
  const float ca = cosf(ang);
  const float sa = sinf(ang);

  // Endpoint j = t * 32 + lane: t < 8 are the first points of pairs
  // j, t >= 8 the second points of pairs j - 256.
  float v[16];
#pragma unroll
  for (int t = 0; t < 16; ++t) {
    const int j = t * 32 + lane;
    const float px = __ldg(pattern + j);
    const float py = __ldg(pattern + kSamples + j);
    const float rx = __fsub_rn(__fmul_rn(ca, px), __fmul_rn(sa, py));
    const float ry = __fadd_rn(__fmul_rn(sa, px), __fmul_rn(ca, py));
    const int gx = clampi(__float2int_rn(__fadd_rn(xf, rx)), 0, w - 1);
    const int gy = clampi(__float2int_rn(__fadd_rn(yf, ry)), 0, h - 1);
    v[t] = __ldg(blur + (size_t)gy * w + gx);
  }
  if (samples != nullptr) {
    float* out = samples + (size_t)kp * kSamples;
#pragma unroll
    for (int t = 0; t < 16; ++t) out[t * 32 + lane] = v[t];
  }
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    const unsigned word = __ballot_sync(0xffffffffu, v[t] < v[t + 8]);
    if (lane == 0) desc[kp * 8 + t] = (int32_t)word;
  }
  if (lane == 0) {
    angle[kp] = ang;
    moments[2 * kp] = m10;
    moments[2 * kp + 1] = m01;
  }
}

}  // namespace

extern "C" int orb_sample_levels_launch(int n_levels, const void* const* raws,
                                        const void* const* blurs,
                                        const int* hs, const int* ws,
                                        const void* xy, const void* level,
                                        const void* pattern, int n_kp,
                                        int radius, void* samples,
                                        void* angle, void* moments,
                                        void* desc, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || radius < 0 ||
      radius > kMaxRadius) {
    return (int)cudaErrorInvalidValue;
  }
  Levels lv = {};
  for (int l = 0; l < n_levels; ++l) {
    lv.raw[l] = (const float*)raws[l];
    lv.blur[l] = (const float*)blurs[l];
    lv.h[l] = hs[l];
    lv.w[l] = ws[l];
  }
  if (n_kp > 0) {
    const int blocks = (n_kp + kWarpsPerBlock - 1) / kWarpsPerBlock;
    orb_sample_levels_kernel<<<blocks, 32 * kWarpsPerBlock, 0,
                               (cudaStream_t)stream>>>(
        lv, (const float*)xy, (const int*)level, (const float*)pattern, n_kp,
        radius, (float*)samples, (float*)angle, (float*)moments,
        (int32_t*)desc);
  }
  return (int)cudaGetLastError();
}
