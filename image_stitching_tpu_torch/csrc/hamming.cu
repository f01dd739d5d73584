// Hamming 2-NN over binary descriptors of W 32-bit words (ORB's 256 bits,
// W = 8; AKAZE's 360 bits padded to 384, W = 12): every pair of an image
// stack, both directions, in one launch, the distances int8 dot products
// on the tensor cores (hamming_pairs_kernel, a template on W).  Every
// other W from 1 to 2047 takes hamming_chunked.cu, which reads the same
// unpacked rows with W at run time and shares the key, the top-2 and the
// output layout.
//
// Replaces the TPU kernel image_stitching_tpu/kernels/hamming_pallas.py
// (hamming_two_nn_pallas and hamming_two_nn_pallas_batched).  For pair p
// the forward direction takes the rows of image ii[p] against the columns
// of image jj[p], the reverse one the rows of jj[p] against the columns of
// ii[p].  For every row it returns the nearest and second-nearest valid
// column: (i1, d1, i2, d2), d the Hamming distance, invalid columns at
// exactly 2^30, ties to the lower column.  No distance matrix is written to
// device memory.
//
// What bounds it on the H100: operations.  The descriptors are small (4000
// of 32 B per image); the work is K * K distances per (pair, direction).
// On the CUDA cores a distance costs W XOR + W POPC + adds, and POPC runs
// at 16 a clock per SM.  On the tensor cores it is one int8 dot product:
// with each bit unpacked to +1 (bit 0) or -1 (bit 1),
//     hamming = (32 W - dot) / 2,
// exact, since dot = (#equal bits) - (#differing bits).  Zero padding bits
// are +1 in both rows and add nothing to the distance.  At the main
// path's shape (8 images of K = 4000, 28 pairs x 2 directions, 896M
// distances) that is 512 operations a distance at the int8 dense peak,
// 0.23 ms, against 0.32 ms for 24 operations at the CUDA-core peak
// (chip_smoke.py phase 6 prints both).  So:
//   * hamming_unpack_kernel writes each descriptor once as 32 W int8 of
//     +-1 (bit b of word w at byte 32 w + b);
//   * hamming_pairs_kernel: one block per (256 rows of A, pair, direction),
//     8 warps of 32 rows, two blocks an SM.  A warp holds its rows'
//     fragments in registers for the whole run; the block streams B
//     through shared memory in tiles of 64 columns with cp.async,
//     double-buffered, and every warp takes the dots of its rows with the
//     tile's 8-column subtiles by mma.sync m16n8k32 (s8 x s8 -> s32), W
//     k-steps each.  The kernel is a template on W.  At W = 12 a tile
//     holds 32 columns (two tiles of 64 rows of 448 bytes would pass the
//     48 KB of static shared memory) and a block takes an SM alone, so
//     that its 96 A-fragment registers a thread do not spill.  Each B
//     fragment read from shared memory feeds both
//     16-row m-tiles of the warp, which halves the shared-memory reads
//     of one m-tile a warp (PERF.md has both times); what remains over the
//     bound is mma.sync's rate, which wgmma would raise;
//   * the dot product is a sum over k, so A and B may be read in any k
//     order as long as both use the same one.  Lane t of a quad reads the
//     16-byte chunks t, t + 4, ..., t + 4 (W / 2 - 1) of a row (W / 2
//     128-bit shared loads) and takes word 2 s + h of those 2 W as its
//     fragment register for k-step s, half h.  Rows are padded by 64 bytes
//     (to 320 at W = 8, 448 at W = 12: 16 banks past a multiple of 32), so
//     the eight lanes of each quarter-warp load hit distinct banks;
//   * epilogue: each distance becomes one 32-bit key (d << 16 | column),
//     or 0xFFFFFFFF for an invalid column, so the (d, column) order is the
//     order of the keys and a running top-2 per row is three min/max
//     operations.  The four lanes that share a row merge their top-2 by
//     two shuffles at the end.  A block walks all of B's columns, so
//     nothing merges across blocks.
// The running top-2 starts at the key 0xFFFFFFFF, read back as (column 0,
// 2^30): an invalid column never replaces it, and a row with fewer than
// two valid columns reports what the plain version (two argmins over the
// masked matrix) reports.  Keys need K <= 65536 and 32 W <= 65535.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kMTiles = 2;                     // 16-row m-tiles a warp
constexpr int kRowsPerWarp = 16 * kMTiles;
constexpr int kRows = kWarps * kRowsPerWarp;   // A rows per block
constexpr unsigned kNone = 0xFFFFFFFFu;
constexpr int kInvalid = 1 << 30;

// The shapes that depend on the word count W (even, so that a quad's four
// lanes split a row's 2 W chunks evenly).
template <int W>
struct Shape {
  static_assert(W % 2 == 0 && W >= 2 && 32 * W < 65536, "word count");
  static constexpr int kRowBytes = 32 * W;        // one unpacked descriptor
  static constexpr int kPitch = kRowBytes + 64;   // padded shared row
  static constexpr int kChunks = kRowBytes / 16;  // 16-byte chunks per row
  static constexpr int kLaneChunks = kChunks / 4; // chunks a quad lane reads
  static constexpr int kTileB = W <= 8 ? 64 : 32; // B columns per stage
  static constexpr int kMinBlocks = W <= 8 ? 2 : 1;  // blocks an SM keeps
};

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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Insert a key into a running top-2 (b1 < b2 unless both are kNone).
__device__ __forceinline__ void top2(unsigned& b1, unsigned& b2, unsigned k) {
  b2 = min(b2, max(b1, k));
  b1 = min(b1, k);
}

template <int W>
struct Shared {
  using S = Shape<W>;
  unsigned char b[2][S::kTileB * S::kPitch];
  unsigned key[2][S::kTileB];
};

template <int W>
__device__ __forceinline__ void load_tile(Shared<W>& sh, int buf,
                                          const unsigned char* bimg,
                                          const bool* vimg, int base, int k) {
  using S = Shape<W>;
  constexpr int kTileB = S::kTileB, kChunks = S::kChunks;
  constexpr int kPitch = S::kPitch, kRowBytes = S::kRowBytes;
  for (int c = threadIdx.x; c < kTileB * kChunks; c += kWarps * 32) {
    const int r = c / kChunks;   // constant divisor
    const int q = c % kChunks;
    unsigned char* dst = &sh.b[buf][r * kPitch + q * 16];
    if (base + r < k) {
      cp_async16(dst, bimg + (size_t)(base + r) * kRowBytes + q * 16);
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
  }
  if (threadIdx.x < kTileB) {
    const int col = base + threadIdx.x;
    sh.key[buf][threadIdx.x] =
        (col < k && vimg[col]) ? (unsigned)col : kNone;
  }
}

template <int W>
__global__ void __launch_bounds__(kWarps * 32, Shape<W>::kMinBlocks)
hamming_pairs_kernel(const unsigned char* __restrict__ pm1,
                     const bool* __restrict__ valid,
                     const int* __restrict__ ii, const int* __restrict__ jj,
                     int n_pairs, int k, long long* __restrict__ i1,
                     float* __restrict__ d1, long long* __restrict__ i2,
                     float* __restrict__ d2) {
  using S = Shape<W>;
  constexpr int kTileB = S::kTileB, kPitch = S::kPitch;
  constexpr int kRowBytes = S::kRowBytes, kLaneChunks = S::kLaneChunks;
  __shared__ __align__(16) Shared<W> sh;
  const int p = blockIdx.y;
  const int dir = blockIdx.z;
  const int img_a = dir ? jj[p] : ii[p];
  const int img_b = dir ? ii[p] : jj[p];
  const unsigned char* aimg = pm1 + (size_t)img_a * k * kRowBytes;
  const unsigned char* bimg = pm1 + (size_t)img_b * k * kRowBytes;
  const bool* vimg = valid + (size_t)img_b * k;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;   // fragment row (A) / column (B) in the tile
  const int t = lane & 3;    // quad lane: which 16-byte chunks it reads
  const int row0 = blockIdx.x * kRows + warp * kRowsPerWarp + g;

  const int n_tiles = (k + kTileB - 1) / kTileB;
  load_tile<W>(sh, 0, bimg, vimg, 0, k);
  cp_async_commit();

  // A fragments for all W k-steps of the warp's m-tiles: fragment row
  // f = 2 m + half is row row0 + 8 f; chunks t + 4 q of it, word 2 s + h
  // of those 2 W for k-step s, half h.
  uint32_t wa[2 * kMTiles][2 * W];
#pragma unroll
  for (int f = 0; f < 2 * kMTiles; ++f) {
    const int r = row0 + 8 * f;
#pragma unroll
    for (int q = 0; q < kLaneChunks; ++q) {
      uint4 v = make_uint4(0, 0, 0, 0);
      if (r < k) {
        v = *reinterpret_cast<const uint4*>(aimg + (size_t)r * kRowBytes +
                                            (q * 4 + t) * 16);
      }
      wa[f][4 * q] = v.x;
      wa[f][4 * q + 1] = v.y;
      wa[f][4 * q + 2] = v.z;
      wa[f][4 * q + 3] = v.w;
    }
  }

  unsigned b1[2 * kMTiles], b2[2 * kMTiles];
#pragma unroll
  for (int f = 0; f < 2 * kMTiles; ++f) b1[f] = b2[f] = kNone;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int buf = tile & 1;
    if (tile + 1 < n_tiles) {
      load_tile<W>(sh, buf ^ 1, bimg, vimg, (tile + 1) * kTileB, k);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const unsigned char* sb = sh.b[buf];
#pragma unroll 1
    for (int sub = 0; sub < kTileB / 8; ++sub) {
      const unsigned char* brow = sb + (sub * 8 + g) * kPitch;
      uint32_t wb[2 * W];
#pragma unroll
      for (int q = 0; q < kLaneChunks; ++q) {
        const uint4 v =
            *reinterpret_cast<const uint4*>(brow + (q * 4 + t) * 16);
        wb[4 * q] = v.x;
        wb[4 * q + 1] = v.y;
        wb[4 * q + 2] = v.z;
        wb[4 * q + 3] = v.w;
      }
      // One B fragment serves every m-tile: independent accumulators.
      int c[kMTiles][4];
#pragma unroll
      for (int m = 0; m < kMTiles; ++m) {
        c[m][0] = c[m][1] = c[m][2] = c[m][3] = 0;
      }
#pragma unroll
      for (int s = 0; s < W; ++s) {
#pragma unroll
        for (int m = 0; m < kMTiles; ++m) {
          const uint32_t a[4] = {wa[2 * m][2 * s], wa[2 * m + 1][2 * s],
                                 wa[2 * m][2 * s + 1],
                                 wa[2 * m + 1][2 * s + 1]};
          mma_s8(c[m], a, wb[2 * s], wb[2 * s + 1]);
        }
      }
      // c[m][0], c[m][1]: row 16 m + g, columns 2t, 2t + 1; c[m][2],
      // c[m][3]: row 16 m + g + 8.
      const uint2 ck = *reinterpret_cast<const uint2*>(
          &sh.key[buf][sub * 8 + 2 * t]);
#pragma unroll
      for (int m = 0; m < kMTiles; ++m) {
        // d << 16 = (32 W - dot) << 15: 32 W - dot is even.
        top2(b1[2 * m], b2[2 * m],
             ((unsigned)(kRowBytes - c[m][0]) << 15) | ck.x);
        top2(b1[2 * m], b2[2 * m],
             ((unsigned)(kRowBytes - c[m][1]) << 15) | ck.y);
        top2(b1[2 * m + 1], b2[2 * m + 1],
             ((unsigned)(kRowBytes - c[m][2]) << 15) | ck.x);
        top2(b1[2 * m + 1], b2[2 * m + 1],
             ((unsigned)(kRowBytes - c[m][3]) << 15) | ck.y);
      }
    }
    __syncthreads();
  }

  // Merge the quad's four disjoint column sets.
#pragma unroll
  for (int f = 0; f < 2 * kMTiles; ++f) {
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      const unsigned o1 = __shfl_xor_sync(0xffffffffu, b1[f], off);
      const unsigned o2 = __shfl_xor_sync(0xffffffffu, b2[f], off);
      b2[f] = min(max(b1[f], o1), min(b2[f], o2));
      b1[f] = min(b1[f], o1);
    }
    const int r = row0 + 8 * f;
    if (t == 0 && r < k) {
      const size_t o = ((size_t)dir * n_pairs + p) * k + r;
      i1[o] = b1[f] == kNone ? 0 : (long long)(b1[f] & 0xFFFFu);
      d1[o] = b1[f] == kNone ? (float)kInvalid : (float)(b1[f] >> 16);
      i2[o] = b2[f] == kNone ? 0 : (long long)(b2[f] & 0xFFFFu);
      d2[o] = b2[f] == kNone ? (float)kInvalid : (float)(b2[f] >> 16);
    }
  }
}

template <int W>
void launch_pairs(const void* pm1, const void* valid, const void* ii,
                  const void* jj, int n_pairs, int k, void* i1, void* d1,
                  void* i2, void* d2, cudaStream_t stream) {
  const dim3 grid((k + kRows - 1) / kRows, n_pairs, 2);
  hamming_pairs_kernel<W><<<grid, kWarps * 32, 0, stream>>>(
      (const unsigned char*)pm1, (const bool*)valid, (const int*)ii,
      (const int*)jj, n_pairs, k, (long long*)i1, (float*)d1,
      (long long*)i2, (float*)d2);
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

// The word counts the pairs kernel is built for; any other returns
// cudaErrorInvalidValue without a launch.
extern "C" int hamming_pairs_launch(const void* pm1, const void* valid,
                                    const void* ii, const void* jj,
                                    int n_pairs, int k, int n_words,
                                    void* i1, void* d1, void* i2, void* d2,
                                    void* stream) {
  if (n_words != 8 && n_words != 12) return (int)cudaErrorInvalidValue;
  if (n_pairs > 0 && k > 0) {
    const cudaStream_t s = (cudaStream_t)stream;
    if (n_words == 8) {
      launch_pairs<8>(pm1, valid, ii, jj, n_pairs, k, i1, d1, i2, d2, s);
    } else {
      launch_pairs<12>(pm1, valid, ii, jj, n_pairs, k, i1, d1, i2, d2, s);
    }
  }
  return (int)cudaGetLastError();
}
