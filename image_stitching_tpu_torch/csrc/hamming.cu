// Hamming 2-NN over 256-bit binary descriptors, batched over image pairs.
//
// Replaces the TPU kernel image_stitching_tpu/kernels/hamming_pallas.py
// (hamming_two_nn_pallas and hamming_two_nn_pallas_batched).  For every
// row of A it returns the nearest and second-nearest valid column of B:
// (i1, d1, i2, d2), with d = popcount(a ^ b) over the 8 words, invalid
// columns at exactly 2^30, ties to the lower column.  The (Ka, Kb)
// distance matrix is never written to device memory.
//
// What bounds it on the H100: operations.  The bytes are small (K = 4000
// descriptors of 32 B per side, 128 KB); the work is Ka * Kb distances of
// 8 XOR + 8 POPC + 8 adds each, plus the running compare.  The TPU kernel
// turned the distance into a bit-plane matrix product for the MXU; here
// the integer units do it directly:
//   * one block per (pair, 64 rows of A); each thread keeps its A row's
//     8 words in registers and a running (d1, i1, d2, i2);
//   * B's descriptors and validity go through shared memory in tiles of
//     512 (16 KB), loaded by the whole block; every thread of a warp then
//     reads the same B descriptor (a broadcast, no bank conflicts);
//   * columns are walked in ascending order and a column replaces a
//     running value only when strictly smaller, which is argmin's
//     lower-index rule.
// The running values start at (2^30, column 0), so an invalid column never
// replaces them and a row with fewer than two valid columns reports what
// the plain version (two argmins over the masked matrix) reports.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;     // A rows per block, one per thread
constexpr int kTileB = 512;   // B descriptors per shared-memory tile
constexpr int kInvalid = 1 << 30;

__global__ void hamming_two_nn_kernel(const uint4* __restrict__ a,
                                      const uint4* __restrict__ b,
                                      const unsigned char* __restrict__ valid,
                                      int ka, int kb,
                                      long long* __restrict__ i1,
                                      float* __restrict__ d1,
                                      long long* __restrict__ i2,
                                      float* __restrict__ d2) {
  __shared__ uint4 sb[2 * kTileB];
  __shared__ unsigned char sv[kTileB];
  const int p = blockIdx.y;
  const int row = blockIdx.x * kRows + threadIdx.x;
  const bool live = row < ka;
  uint4 a0 = make_uint4(0, 0, 0, 0), a1 = make_uint4(0, 0, 0, 0);
  if (live) {
    const uint4* ap = a + 2 * ((size_t)p * ka + row);
    a0 = ap[0];
    a1 = ap[1];
  }
  const uint4* bp = b + 2 * (size_t)p * kb;
  const unsigned char* vp = valid + (size_t)p * kb;
  int best1 = kInvalid, best2 = kInvalid, idx1 = 0, idx2 = 0;
  for (int base = 0; base < kb; base += kTileB) {
    const int n = min(kTileB, kb - base);
    __syncthreads();
    for (int t = threadIdx.x; t < 2 * n; t += kRows) {
      sb[t] = bp[2 * (size_t)base + t];
    }
    for (int t = threadIdx.x; t < n; t += kRows) sv[t] = vp[base + t];
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < n; ++j) {
      if (!sv[j]) continue;
      const uint4 b0 = sb[2 * j], b1 = sb[2 * j + 1];
      const int d = __popc(a0.x ^ b0.x) + __popc(a0.y ^ b0.y) +
                    __popc(a0.z ^ b0.z) + __popc(a0.w ^ b0.w) +
                    __popc(a1.x ^ b1.x) + __popc(a1.y ^ b1.y) +
                    __popc(a1.z ^ b1.z) + __popc(a1.w ^ b1.w);
      if (d < best1) {
        best2 = best1;
        idx2 = idx1;
        best1 = d;
        idx1 = base + j;
      } else if (d < best2) {
        best2 = d;
        idx2 = base + j;
      }
    }
  }
  if (live) {
    const size_t o = (size_t)p * ka + row;
    i1[o] = idx1;
    d1[o] = (float)best1;
    i2[o] = idx2;
    d2[o] = (float)best2;
  }
}

}  // namespace

extern "C" int hamming_two_nn_launch(const void* desc_a, const void* desc_b,
                                     const void* valid_b, int p, int ka,
                                     int kb, void* i1, void* d1, void* i2,
                                     void* d2, void* stream) {
  if (p > 0 && ka > 0) {
    const dim3 grid((ka + kRows - 1) / kRows, p);
    hamming_two_nn_kernel<<<grid, kRows, 0, (cudaStream_t)stream>>>(
        (const uint4*)desc_a, (const uint4*)desc_b,
        (const unsigned char*)valid_b, ka, kb, (long long*)i1, (float*)d1,
        (long long*)i2, (float*)d2);
  }
  return (int)cudaGetLastError();
}
