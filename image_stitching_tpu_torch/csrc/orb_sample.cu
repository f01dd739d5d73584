// ORB per-keypoint sampling: IC-angle moments + rotated rBRIEF reads.
//
// Replaces the TPU kernel image_stitching_tpu/kernels/orb_sample_pallas.py
// (orb_sample_pallas, body _kernel).  Per keypoint it computes the
// intensity-centroid moments (m10, m01) over the radius-r disk of the raw
// level plane, the angle atan2(m01, m10), and the 512 rBRIEF endpoint reads
// on the sigma-2 blurred plane, rotated by cos/sin of that angle, rounded
// half to even and clipped to the image box; the 256 pair comparisons are
// packed LSB-first into 8 descriptor words.
//
// What bounds it on the H100: memory latency.  Each keypoint reads ~1.3k
// disk pixels (contiguous rows, cached) and 512 scattered pixels of the
// blurred plane; there is almost no arithmetic.  The design keeps many
// independent reads in flight instead of staging windows in shared memory
// the way the TPU kernel had to stage them in VMEM:
//   * one warp per keypoint, eight keypoints per 256-thread block, so a
//     level's ~300-1500 keypoints fill the SMs with independent warps;
//   * the lanes stride the disk window row-major (neighbouring lanes read
//     neighbouring pixels) and reduce with __shfl_xor_sync;
//   * each lane then issues 16 endpoint reads through L1/L2 (the planes,
//     a few MB, sit in the 50 MB L2), and __ballot_sync packs the 256
//     comparisons into descriptor words with no shared memory.
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

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__global__ void orb_sample_kernel(const float* __restrict__ raw,
                                  const float* __restrict__ blur, int h,
                                  int w, const float* __restrict__ xy,
                                  const float* __restrict__ pattern, int n_kp,
                                  int radius, float* __restrict__ samples,
                                  float* __restrict__ moments,
                                  int32_t* __restrict__ desc) {
  const int kp = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (kp >= n_kp) return;  // whole warp leaves together: ballots stay full

  const float xf = xy[2 * kp];
  const float yf = xy[2 * kp + 1];
  const int cx = clampi(__float2int_rn(xf), 0, w - 1);
  const int cy = clampi(__float2int_rn(yf), 0, h - 1);

  // IC-angle moments over the disk of the raw plane.
  const int side = 2 * radius + 1;
  const int rr = radius * radius;
  float m10 = 0.f, m01 = 0.f;
  for (int i = lane; i < side * side; i += 32) {
    const int dy = i / side - radius;
    const int dx = i % side - radius;
    if (dx * dx + dy * dy <= rr) {
      const float v = raw[clampi(cy + dy, 0, h - 1) * w +
                          clampi(cx + dx, 0, w - 1)];
      m10 = __fadd_rn(m10, __fmul_rn(v, (float)dx));
      m01 = __fadd_rn(m01, __fmul_rn(v, (float)dy));
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    m10 += __shfl_xor_sync(0xffffffffu, m10, off);
    m01 += __shfl_xor_sync(0xffffffffu, m01, off);
  }
  const float angle = atan2f(m01, m10);
  const float ca = cosf(angle);
  const float sa = sinf(angle);

  // Endpoint j = t * 32 + lane: t < 8 are the first points of pairs
  // j, t >= 8 the second points of pairs j - 256.
  float first[8];
  float* out = samples + (size_t)kp * kSamples;
#pragma unroll
  for (int t = 0; t < 16; ++t) {
    const int j = t * 32 + lane;
    const float px = pattern[j];
    const float py = pattern[kSamples + j];
    const float rx = __fsub_rn(__fmul_rn(ca, px), __fmul_rn(sa, py));
    const float ry = __fadd_rn(__fmul_rn(sa, px), __fmul_rn(ca, py));
    const int gx = clampi(__float2int_rn(__fadd_rn(xf, rx)), 0, w - 1);
    const int gy = clampi(__float2int_rn(__fadd_rn(yf, ry)), 0, h - 1);
    const float v = blur[gy * w + gx];
    out[j] = v;
    if (t < 8) {
      first[t] = v;
    } else {
      const unsigned word = __ballot_sync(0xffffffffu, first[t - 8] < v);
      if (lane == 0) desc[kp * 8 + (t - 8)] = (int32_t)word;
    }
  }
  if (lane == 0) {
    moments[2 * kp] = m10;
    moments[2 * kp + 1] = m01;
  }
}

}  // namespace

extern "C" int orb_sample_launch(const void* raw, const void* blur, int h,
                                 int w, const void* xy, const void* pattern,
                                 int n_kp, int radius, void* samples,
                                 void* moments, void* desc, void* stream) {
  if (n_kp > 0) {
    const int blocks = (n_kp + kWarpsPerBlock - 1) / kWarpsPerBlock;
    orb_sample_kernel<<<blocks, 32 * kWarpsPerBlock, 0,
                        (cudaStream_t)stream>>>(
        (const float*)raw, (const float*)blur, h, w, (const float*)xy,
        (const float*)pattern, n_kp, radius, (float*)samples,
        (float*)moments, (int32_t*)desc);
  }
  return (int)cudaGetLastError();
}
