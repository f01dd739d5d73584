// K7: RANSAC's hypothesis scoring, for a block of pairs, in one launch.
//
// Replaces no TPU kernel: the JAX package leaves the scoring in
// ops/ransac.py::ransac_homography to XLA, which fuses the projection, the
// squared error and the count into one loop on the TPU.  The port ran it as
// eager PyTorch ops that materialised (P, n_hyp, m, 3) float tensors (the
// expanded scoring points, apply_h's homogeneous copy and product, the
// projections and squared errors): about 20 MB a pair at n_hyp 512 and m
// 1024, which kept the RANSAC blocks of match_all_pairs at two pairs.  This
// kernel computes, for each pair p and hypothesis h,
//   counts[p, h] = #{ j < m : err2(h, j) < t2 },
//   err2 = |apply_h(H[p, h], src[p, idx[p, j]]) - dst[p, idx[p, j]]|^2,
// with apply_h's guard on the third coordinate (|z| < 1e-12 -> 1e-12), and
// writes only the (P, n_hyp) int64 counts.
//
// What bounds it on the H100: the arithmetic.  A point test is ~15 FP32
// operations (two 3-term rows and the third coordinate, two divisions, the
// squared error), so the rig's 666 x 512 x 1024 tests are ~5.2 GFLOP,
// ~0.08 ms at 67 TFLOP/s; the bytes are the hypotheses and the gathered
// points (~24 KB a pair), microseconds.  The design:
//   * one block per (pair, 64 hypotheses); the pair's scoring points are
//     gathered once a block into shared memory as (x, y, u, v), up to 1024
//     at a time (16 KB), and the block's hypotheses are staged beside them;
//   * each warp takes 8 hypotheses; its lanes walk the points 32 apart and
//     keep one count a hypothesis in registers; a warp reduction gives the
//     count, and lane 0 writes it;
//   * nothing of size P x n_hyp x m is written.
// Numerics follow the plain version's order: each row of H times (x, y, 1)
// as fma(h1, y, h0 * x) + h2 (a 3-term dot product's accumulation order),
// IEEE division, (px - u)^2 + (py - v)^2 with no contraction (every float
// operation is a _rn intrinsic).  A product summed in another order can
// put a point within rounding of t2 on the other side: the counts may
// differ from the plain version's by such points alone.  An index outside
// [0, M) reads no memory and counts as no inlier.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kHypPerWarp = 8;
constexpr int kHypPerBlock = kWarps * kHypPerWarp;  // 64
constexpr int kTile = 1024;                         // points staged a pass

__global__ void __launch_bounds__(kThreads)
ransac_score_kernel(const float* __restrict__ h,
                    const float* __restrict__ src,
                    const float* __restrict__ dst,
                    const long long* __restrict__ idx, int n_hyp, int m_slots,
                    int m, int hyp_blocks, float t2,
                    long long* __restrict__ counts) {
  __shared__ float4 pts[kTile];
  __shared__ float hs[kHypPerBlock * 9];
  const long long p = blockIdx.x / hyp_blocks;
  const int h0 = (blockIdx.x % hyp_blocks) * kHypPerBlock;
  const int n_here = min(kHypPerBlock, n_hyp - h0);
  const float* hp = h + (p * n_hyp + h0) * 9;
  for (int i = threadIdx.x; i < n_here * 9; i += kThreads) hs[i] = hp[i];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long* ip = idx + p * m;
  const float* sp = src + p * m_slots * 2;
  const float* dp = dst + p * m_slots * 2;
  int c[kHypPerWarp];
#pragma unroll
  for (int i = 0; i < kHypPerWarp; ++i) c[i] = 0;

  for (int base = 0; base < m; base += kTile) {
    const int n_pts = min(kTile, m - base);
    __syncthreads();  // the previous tile is read (the first: hs written)
    for (int j = threadIdx.x; j < n_pts; j += kThreads) {
      const long long k = ip[base + j];
      const float nan = __int_as_float(0x7fffffff);
      float4 v = make_float4(nan, nan, nan, nan);
      if (k >= 0 && k < m_slots) {
        v = make_float4(sp[2 * k], sp[2 * k + 1], dp[2 * k], dp[2 * k + 1]);
      }
      pts[j] = v;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kHypPerWarp; ++i) {
      const int hl = warp * kHypPerWarp + i;
      if (hl < n_here) {
        const float* hh = hs + hl * 9;
        const float a0 = hh[0], a1 = hh[1], a2 = hh[2];
        const float b0 = hh[3], b1 = hh[4], b2 = hh[5];
        const float g0 = hh[6], g1 = hh[7], g2 = hh[8];
        int cnt = 0;
        for (int j = lane; j < n_pts; j += 32) {
          const float4 v = pts[j];
          const float qx = __fadd_rn(__fmaf_rn(a1, v.y, __fmul_rn(a0, v.x)),
                                     a2);
          const float qy = __fadd_rn(__fmaf_rn(b1, v.y, __fmul_rn(b0, v.x)),
                                     b2);
          float z = __fadd_rn(__fmaf_rn(g1, v.y, __fmul_rn(g0, v.x)), g2);
          z = fabsf(z) < 1e-12f ? 1e-12f : z;
          const float dx = __fsub_rn(__fdiv_rn(qx, z), v.z);
          const float dy = __fsub_rn(__fdiv_rn(qy, z), v.w);
          const float e = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
          cnt += e < t2;
        }
        c[i] += cnt;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kHypPerWarp; ++i) {
    const int total = __reduce_add_sync(0xffffffffu, c[i]);
    const int hl = warp * kHypPerWarp + i;
    if (lane == 0 && hl < n_here) counts[p * n_hyp + h0 + hl] = total;
  }
}

}  // namespace

// h (p, n_hyp, 3, 3) f32, src and dst (p, m_slots, 2) f32, idx (p, m) int64,
// counts (p, n_hyp) int64, all contiguous; t2 the squared threshold.
extern "C" int ransac_score_launch(const void* h, const void* src,
                                   const void* dst, const void* idx, int p,
                                   int n_hyp, int m_slots, int m, float t2,
                                   void* counts, void* stream) {
  if (p < 1 || n_hyp < 1 || m_slots < 0 || m < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int hyp_blocks = (n_hyp + kHypPerBlock - 1) / kHypPerBlock;
  if ((long long)p * hyp_blocks > 0x7fffffffLL) {
    return (int)cudaErrorInvalidConfiguration;
  }
  ransac_score_kernel<<<p * hyp_blocks, kThreads, 0,
                        (cudaStream_t)stream>>>(
      (const float*)h, (const float*)src, (const float*)dst,
      (const long long*)idx, n_hyp, m_slots, m, hyp_blocks, t2,
      (long long*)counts);
  return (int)cudaGetLastError();
}
