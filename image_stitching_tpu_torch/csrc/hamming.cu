// The first of K4's two launches: each binary descriptor of W 32-bit words
// unpacked once into 32 W int8 of +1 (bit 0) or -1 (bit 1), bit b of word
// w at byte 32 w + b, so that
//     hamming(a, b) = (32 W - <pm1(a), pm1(b)>) / 2,
// an int8 dot product that hamming_chunked.cu takes on the tensor cores
// (its header says why).  Zero padding bits are +1 in both rows and add
// nothing to the distance.  Bound by bytes: W * 4 in, 32 W out a
// descriptor.  The plain twin is kernels/hamming.py::pm1_rows.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void hamming_unpack_kernel(const uint32_t* __restrict__ words,
                                      int n_words,
                                      uint32_t* __restrict__ out,
                                      long long n_out) {
  // One output word (4 bytes of +-1) per thread: bits 4 j .. 4 j + 3 of
  // the descriptor, LSB first.
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n_out) return;
  const int per_row = 8 * n_words;
  const long long row = i / per_row;
  const int j = (int)(i - row * per_row);
  const uint32_t nib =
      (words[row * n_words + (j >> 3)] >> ((j & 7) * 4)) & 0xFu;
  uint32_t v = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    v |= ((nib >> b) & 1u ? 0xFFu : 0x01u) << (8 * b);
  }
  out[i] = v;
}

}  // namespace

extern "C" int hamming_unpack_launch(const void* desc, long long n_desc,
                                     int n_words, void* pm1, void* stream) {
  const long long n_out = n_desc * 8 * n_words;
  if (n_out > 0) {
    const int threads = 256;
    const long long blocks = (n_out + threads - 1) / threads;
    hamming_unpack_kernel<<<(unsigned)blocks, threads, 0,
                            (cudaStream_t)stream>>>(
        (const uint32_t*)desc, n_words, (uint32_t*)pm1, n_out);
  }
  return (int)cudaGetLastError();
}
