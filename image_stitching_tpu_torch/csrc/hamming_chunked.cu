// K4, the Hamming 2-NN of binary descriptors: every pair of an image stack,
// both directions, in one launch, at any word count W, any descriptor
// count K and any pair count, the dot products on the tensor cores by
// wgmma with the rows brought in by TMA.
//
// Replaces the TPU kernel image_stitching_tpu/kernels/hamming_pallas.py
// (hamming_two_nn_pallas and hamming_two_nn_pallas_batched).  For pair p
// the forward direction takes the rows of image ii[p] against the columns
// of image jj[p], the reverse one the rows of jj[p] against the columns of
// ii[p]; every row gets its nearest and second-nearest valid column (i1,
// d1, i2, d2), ties to the lower column, invalid columns at exactly 2^30.
// No distance matrix is written to device memory.
//
// K4 is two launches.  The first, hamming_unpack_kernel below, unpacks
// each descriptor once into 32 W int8 of +1 (bit 0) or -1 (bit 1), bit b
// of word w at byte 32 w + b (zero padding bits are +1 in both rows and
// add nothing to a distance); it is bound by bytes, W * 4 in and 32 W out
// a descriptor, and kernels/hamming.py::pm1_rows is its plain twin.  The
// second, hamming_wgmma_kernel, takes the pairs.
//
// What bounds the second on the H100: operations.  With each descriptor
// bit unpacked to +-1,
//     hamming = (32 W - dot) / 2,
// exact, since dot = (#equal bits) - (#differing bits): an int8 dot
// product of depth 32 W, 64 W operations a distance on the tensor cores
// (1,979 TOP/s dense int8), against W XOR + W POPC on the CUDA cores,
// where POPC issues 16 a clock per SM.  So the kernel takes the ordinary
// GEMM shape: per (pair, direction) a product of M = K rows of A by N = K
// columns of B at depth 32 W, in stages of 128 bytes of depth (the
// 128-byte swizzle's width), the int32 sums of a 128 x 128 tile kept in
// registers across the stages:
//   * one block per (128 A rows, pair, direction), the pairs folded into
//     grid.x with the row tiles (grid.y would cap them at 65535): two
//     consumer warpgroups of 64 rows issue wgmma m64n128k32 (s8 x s8 ->
//     s32), both operands K-major in shared memory under the 128-byte
//     swizzle; one producer warp loads them by TMA from a 3-D tensor map
//     over the (N, K, 32 W) int8 stack.  Rows past K and bytes past 32 W
//     read as zeros, which add nothing to a dot product, so no W needs
//     padding; the last stage issues only the 32-byte k-steps that hold
//     data;
//   * where A's 128 rows fit beside a ring of B stages with two blocks an
//     SM (W <= 16: at most 4 stages of 16 KB), A is loaded once and stays;
//     the ring then carries B alone, which halves the bytes shared memory
//     takes in from L2 (beyond that A streams with B, 32 KB a stage, 3
//     stages).  Full/empty mbarriers pace the ring; the producer runs
//     ahead into the next column tile, so the loads overlap an epilogue;
//   * the block walks every column tile of B that holds a valid column,
//     so nothing merges across blocks.  It first writes B's validity as
//     bits and the list of live tiles into shared memory: a tile with no
//     valid column is skipped (all its keys would be the all-ones
//     sentinel, which never enters a top-2), and each quad lane gets its
//     32 columns' validity of a tile in one word;
//   * epilogue after a tile's last stage: each distance d becomes a key
//     whose order is the (d, column) order, or the all-ones sentinel for
//     an invalid column, and enters its row's running top-2 (three
//     min/max operations); the four lanes that share a row merge at the
//     end.  The key is 32 bits, d << 16 | column, while K <= 65536 and
//     32 W <= 65535 (ORB's 8 words, AKAZE's 12, every other width in
//     use); past either, 64 bits, d << 32 | column.  The caller picks the
//     instantiation (kernels/hamming.py's key_bits); the launch refuses
//     32-bit keys where they do not fit.
// The running top-2 starts at the sentinel, read back as (column 0,
// 2^30): a row with fewer than two valid columns reports what the plain
// version (two argmins over the masked matrix) reports.  On an H100 80GB
// HBM3 at 700 W (PERF.md) W = 16 over 28 pairs of K = 4000 both ways
// takes 0.95 ms, 49% of the tensor-core bound: the epilogue's ~5 integer
// operations a distance and each stage's wait for its products hold it
// there.  What bounds the input is memory: the N K 32 W bytes of +-1 rows,
// 36 bytes of shared memory a column tile (hamming_chunked_max_k: K <=
// 472960 on the H100) and TMA's signed 32-bit coordinates.

#include <climits>

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kInvalid = 1 << 30;
constexpr int kTile = 128;                      // A rows a block, B columns a tile
constexpr int kDepth = 128;                     // bytes of depth a stage
constexpr int kOperand = kTile * kDepth;        // one operand's stage, 16 KB
constexpr int kStageBytes = 2 * kOperand;       // A then B
constexpr int kWgThreads = 288;                 // 2 consumer warpgroups + 1 warp
// A return code past the CUDA runtime's: the tensor map's CUresult + this.
constexpr int kTensorMapError = 100000;

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// A key (unsigned or unsigned long long) holds a distance above a column,
// each in half its bits; all ones is the sentinel for none.
template <typename Key>
__device__ __forceinline__ constexpr Key none() {
  return ~(Key)0;
}

// Insert a key into a running top-2 (b1 < b2 unless both are none).
template <typename Key>
__device__ __forceinline__ void top2(Key& b1, Key& b2, Key k) {
  b2 = min(b2, max(b1, k));
  b1 = min(b1, k);
}

// Merge the top-2 of the four lanes of a quad (disjoint column sets).
template <typename Key>
__device__ __forceinline__ void quad_merge(Key& b1, Key& b2) {
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    const Key o1 = __shfl_xor_sync(0xffffffffu, b1, off);
    const Key o2 = __shfl_xor_sync(0xffffffffu, b2, off);
    b2 = min(max(b1, o1), min(b2, o2));
    b1 = min(b1, o1);
  }
}

// The key of a distance from its dot product: with s = 4 sizeof(Key) and
// rb = 32 W << (s - 1), rb - (dot << (s - 1)) is d << s (32 W - dot is
// even); col_key is the column, or none() for an invalid column.
template <typename Key>
__device__ __forceinline__ Key dist_key(Key rb, int dot, Key col_key) {
  return (rb - ((Key)(long long)dot << (4 * sizeof(Key) - 1))) | col_key;
}

template <typename Key>
__device__ __forceinline__ void write_row(long long* i1, float* d1,
                                          long long* i2, float* d2, size_t o,
                                          Key b1, Key b2) {
  constexpr int kShift = 4 * sizeof(Key);
  constexpr Key kCol = ((Key)1 << kShift) - 1;
  i1[o] = b1 == none<Key>() ? 0 : (long long)(b1 & kCol);
  d1[o] = b1 == none<Key>() ? (float)kInvalid : (float)(b1 >> kShift);
  i2[o] = b2 == none<Key>() ? 0 : (long long)(b2 & kCol);
  d2[o] = b2 == none<Key>() ? (float)kInvalid : (float)(b2 >> kShift);
}

// Writes B's validity as bits into mask (4 words a tile, 0 past K), the
// tiles that hold a valid column, in order, into live, and for each tile
// and quad lane t the word lane_bits[4 tile + t] whose bit 2 j + e is
// column 8 j + 2 t + e of the tile, the columns lane t holds in a wgmma
// accumulator.  Returns the count of live tiles (kept in *count).  Every
// thread of the block calls it; it ends in a barrier.
__device__ int live_tiles(const bool* __restrict__ vimg, int k,
                          int n_tiles, uint32_t* mask, int* live,
                          uint32_t* lane_bits, int* count) {
  for (int w = threadIdx.x; w < 4 * n_tiles; w += blockDim.x) {
    uint32_t bits = 0;
    for (int b = 0; b < 32; ++b) {
      const int c = 32 * w + b;
      if (c < k && vimg[c]) bits |= 1u << b;
    }
    mask[w] = bits;
  }
  __syncthreads();
  for (int w = threadIdx.x; w < 4 * n_tiles; w += blockDim.x) {
    const int base = (w >> 2) * kTile + 2 * (w & 3);
    uint32_t bits = 0;
    for (int j = 0; j < 16; ++j) {
      const int c = base + 8 * j;
      bits |= ((mask[c >> 5] >> (c & 31)) & 3u) << (2 * j);
    }
    lane_bits[w] = bits;
  }
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int n = 0;
    for (int base = 0; base < n_tiles; base += 32) {
      const int tile = base + lane;
      const bool any = tile < n_tiles &&
          (mask[4 * tile] | mask[4 * tile + 1] | mask[4 * tile + 2] |
           mask[4 * tile + 3]) != 0u;
      const unsigned ballot = __ballot_sync(0xffffffffu, any);
      if (any) live[n + __popc(ballot & ((1u << lane) - 1u))] = tile;
      n += __popc(ballot);
    }
    if (lane == 0) *count = n;
  }
  __syncthreads();
  return *count;
}

// ---- wgmma + TMA -------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
      "selp.u32 %0, 1, 0, P1;\n"
      "}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

// Waits for the phase of parity `parity` to complete.  A wait that never
// ends (a lost arrival) traps after 2^26 polls, so the launch fails with an
// error instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (int n = 0; !mbar_try(bar, parity); ++n) {
    if (n == (1 << 26)) __trap();
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const void* tmap,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"((uint64_t)tmap), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// A wgmma shared-memory descriptor of a K-major operand under the 128-byte
// swizzle: rows of 128 bytes, 8-row groups 1024 bytes apart (SBO), the
// leading offset unused (1), layout type 1 (128B swizzle).  The operand's
// base is 1024-aligned; the k-step of 32 bytes adds 2 to the address field.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator accesses across the async
// wgmma boundary.
__device__ __forceinline__ void fence_acc(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (64 x 128 int32 over the warpgroup) (+)= A (64 x 32 s8) B^T (128 x 32).
__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// The kernel's shared memory: A's resident stages (if any), the ring of
// stages, then the barriers (full[kMaxStages], empty[kMaxStages], A's),
// the live-tile count, the validity bits, the live tiles and the lane
// bits.
struct WgLayout {
  bool resident;   // A held for the block's life, B alone in the ring
  int n_stages;    // ring stages
  size_t bytes;    // dynamic shared memory, with the 1024-alignment slack
};

constexpr int kMaxStages = 4;
// Dynamic shared memory a block may take so that two fit an SM (228 KB,
// 1 KB of it reserved per block).
constexpr size_t kTwoBlocks = 112 * 1024;

WgLayout wgmma_layout(int n_kst, int n_tiles) {
  const size_t tail = 1024 + 8 * (2 * kMaxStages + 1) + 8 +
                      (size_t)n_tiles * 4 * 4 * 2 + (size_t)n_tiles * 4;
  const size_t a_bytes = (size_t)n_kst * kOperand;
  WgLayout l{false, 3, tail + 3 * (size_t)kStageBytes};
  if (tail + a_bytes + 2 * (size_t)kOperand > kTwoBlocks) return l;
  const size_t fit = (kTwoBlocks - tail - a_bytes) / kOperand;
  const int n = fit < (size_t)kMaxStages ? (int)fit : kMaxStages;
  return WgLayout{true, n, tail + a_bytes + (size_t)n * kOperand};
}

template <typename Key>
__global__ void __launch_bounds__(kWgThreads, 2)
hamming_wgmma_kernel(const __grid_constant__ CUtensorMap tmap,
                     const bool* __restrict__ valid,
                     const int* __restrict__ ii, const int* __restrict__ jj,
                     int n_pairs, int k, int n_words, int resident,
                     int n_stages, long long* __restrict__ i1,
                     float* __restrict__ d1, long long* __restrict__ i2,
                     float* __restrict__ d2) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* smem = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  const int row_bytes = 32 * n_words;
  const int n_kst = (row_bytes + kDepth - 1) / kDepth;
  const int slot = resident ? kOperand : kStageBytes;
  // Resident: A's stages s at a_res + s * kOperand, then the ring of B
  // stages.  Streamed: ring stage = A's stage, then B's.
  const uint32_t a_res = smem_u32(smem);
  const uint32_t ring = a_res + (resident ? n_kst * kOperand : 0);
  const int b_off = resident ? 0 : kOperand;
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      smem + (ring - a_res) + (size_t)n_stages * slot);
  const uint32_t full0 = smem_u32(bars);
  const uint32_t empty0 = full0 + 8 * kMaxStages;
  const uint32_t a_bar = full0 + 16 * kMaxStages;
  int* count = reinterpret_cast<int*>(bars + 2 * kMaxStages + 1);
  const int n_tiles = (k + kTile - 1) / kTile;
  uint32_t* mask = reinterpret_cast<uint32_t*>(count + 2);
  int* live = reinterpret_cast<int*>(mask + 4 * n_tiles);
  uint32_t* lane_bits = reinterpret_cast<uint32_t*>(live + n_tiles);

  // grid.x holds n_tiles row tiles a pair, pair after pair.
  const int p = blockIdx.x / n_tiles;
  const int dir = blockIdx.z;
  const int img_a = dir ? jj[p] : ii[p];
  const int img_b = dir ? ii[p] : jj[p];
  const int row0 = (blockIdx.x - p * n_tiles) * kTile;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < n_stages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 8);   // lane 0 of each consumer warp
    }
    mbar_init(a_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  const int n_live = live_tiles(valid + (size_t)img_b * k, k, n_tiles, mask,
                                live, lane_bits, count);

  if (warp == 8) {
    // Producer: one thread walks (live tile, stage) in the consumers'
    // order, n_stages ahead at most; a resident A first, in one go.
    if (lane == 0) {
      if (resident && n_live > 0) {
        mbar_expect_tx(a_bar, n_kst * kOperand);
        for (int s = 0; s < n_kst; ++s) {
          tma_load_3d(a_res + s * kOperand, &tmap, a_bar, s * kDepth, row0,
                      img_a);
        }
      }
      int stage = 0;
      uint32_t phase = 0;
      for (int i = 0; i < n_live; ++i) {
        const int col0 = live[i] * kTile;
        for (int s = 0; s < n_kst; ++s) {
          mbar_wait(empty0 + 8 * stage, phase ^ 1u);
          const uint32_t full = full0 + 8 * stage;
          const uint32_t dst = ring + stage * slot;
          mbar_expect_tx(full, slot);
          if (!resident) {
            tma_load_3d(dst, &tmap, full, s * kDepth, row0, img_a);
          }
          tma_load_3d(dst + b_off, &tmap, full, s * kDepth, col0, img_b);
          if (++stage == n_stages) {
            stage = 0;
            phase ^= 1u;
          }
        }
      }
    }
    return;
  }

  // Consumers: warpgroup wg takes A rows 64 wg .. 64 wg + 63 of the block;
  // lane (g, t) of warp w holds rows 16 w + g and 16 w + g + 8, columns
  // 8 j + 2 t and 8 j + 2 t + 1 of the tile (d[4 j .. 4 j + 3]).
  const int wg = warp >> 2;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r_lo = row0 + wg * 64 + (warp & 3) * 16 + g;
  const Key rb = (Key)row_bytes << (4 * sizeof(Key) - 1);
  Key b1[2] = {none<Key>(), none<Key>()}, b2[2] = {none<Key>(), none<Key>()};
  int d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0;
  if (resident && n_live > 0) mbar_wait(a_bar, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (int i = 0; i < n_live; ++i) {
    for (int s = 0; s < n_kst; ++s) {
      mbar_wait(full0 + 8 * stage, phase);
      const int nk = min(kDepth, row_bytes - s * kDepth) / 32;
      const uint32_t dst = ring + stage * slot;
      const uint64_t da = sw128_desc(
          (resident ? a_res + s * kOperand : dst) + wg * 64 * kDepth);
      const uint64_t db = sw128_desc(dst + b_off);
      fence_acc(d);
      wgmma_fence();
      for (int kk = 0; kk < nk; ++kk) {
        wgmma_s8(d, da + 2 * kk, db + 2 * kk, (s | kk) != 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(d);
      if (lane == 0) mbar_arrive(empty0 + 8 * stage);
      if (++stage == n_stages) {
        stage = 0;
        phase ^= 1u;
      }
    }
    const int col0 = live[i] * kTile + 2 * t;
    const uint32_t vb = lane_bits[4 * live[i] + t];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      // Columns 8 j + 2 t, 8 j + 2 t + 1 of rows g, g + 8.
      const uint32_t bits = vb >> (2 * j);
      const int c = col0 + 8 * j;
      const Key k0 = (bits & 1u) ? (Key)c : none<Key>();
      const Key k1 = (bits & 2u) ? (Key)(c + 1) : none<Key>();
      top2(b1[0], b2[0], dist_key(rb, d[4 * j], k0));
      top2(b1[0], b2[0], dist_key(rb, d[4 * j + 1], k1));
      top2(b1[1], b2[1], dist_key(rb, d[4 * j + 2], k0));
      top2(b1[1], b2[1], dist_key(rb, d[4 * j + 3], k1));
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    quad_merge(b1[h], b2[h]);
    const int r = r_lo + 8 * h;
    if (t == 0 && r < k) {
      write_row(i1, d1, i2, d2, ((size_t)dir * n_pairs + p) * k + r, b1[h],
                b2[h]);
    }
  }
}

// ---- host --------------------------------------------------------------

using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point (no link
// against libcuda); null if the driver lacks it.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(ptr);
    }
  }
  return fn;
}

// Raises a kernel's dynamic shared-memory limit to `bytes` when it is
// below, with the whole carveout for shared memory (so that two blocks of
// up to kTwoBlocks fit an SM); returns the runtime's code.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, size_t& allowed) {
  if (bytes <= allowed) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      (int)cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  }
  if (err == cudaSuccess) allowed = bytes;
  return err;
}

// One launch of the kernel on key type Key: grid.x the n_tiles row tiles of
// every pair, grid.z the two directions.
template <typename Key>
cudaError_t launch_keys(const CUtensorMap& tmap, const WgLayout& l,
                        int n_tiles, const void* valid, const void* ii,
                        const void* jj, int n_pairs, int k, int n_words,
                        void* i1, void* d1, void* i2, void* d2,
                        cudaStream_t stream) {
  static size_t allowed = 48 * 1024;
  const cudaError_t err =
      allow_smem(hamming_wgmma_kernel<Key>, l.bytes, allowed);
  if (err != cudaSuccess) return err;
  hamming_wgmma_kernel<Key><<<dim3(n_tiles * n_pairs, 1, 2), kWgThreads,
                              l.bytes, stream>>>(
      tmap, (const bool*)valid, (const int*)ii, (const int*)jj, n_pairs, k,
      n_words, (int)l.resident, l.n_stages, (long long*)i1, (float*)d1,
      (long long*)i2, (float*)d2);
  return cudaGetLastError();
}

}  // namespace

// The +-1 rows of n_desc descriptors of n_words words: pm1 (n_desc, 32
// n_words) int8 from desc (n_desc, n_words) uint32.
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

// The most descriptors an image (k) the kernel takes at n_words on device
// `device`: the largest k whose shared-memory layout fits the device's
// opt-in limit a block.  Returns minus the runtime's error code if the
// device cannot be read.
extern "C" int hamming_chunked_max_k(int n_words, int device) {
  int optin = 0;
  const cudaError_t err = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return -(int)err;
  const int n_kst = (int)((32 * (long long)n_words + kDepth - 1) / kDepth);
  int lo = 0, hi = INT_MAX / kTile;  // lo tiles fit; hi * kTile is an int
  while (lo < hi) {
    const int mid = lo + (hi - lo + 1) / 2;
    if (wgmma_layout(n_kst, mid).bytes <= (size_t)optin) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  return lo * kTile;
}

// K4 on the +-1 rows that hamming_unpack_launch writes: pm1 (n_images, k,
// 32 n_words) int8, any n_words >= 1, k and n_pairs, on (distance, column)
// keys of key_bits 32 (d << 16 | column) or 64 (d << 32 | column).
// Returns the runtime's error code (cudaErrorInvalidValue, no launch, for
// a negative count, 32 n_words past a signed 32-bit TMA coordinate, more
// blocks than grid.x holds, which the outputs would pass any card's memory
// first, or 32-bit keys past k = 65536 or 32 n_words = 65535), or
// kTensorMapError + the CUresult of a refused tensor map.
extern "C" int hamming_chunked_launch(const void* pm1, const void* valid,
                                      const void* ii, const void* jj,
                                      int n_images, int n_pairs, int k,
                                      int n_words, int key_bits, void* i1,
                                      void* d1, void* i2, void* d2,
                                      void* stream) {
  const int n_tiles = (k + kTile - 1) / kTile;
  if (n_words < 1 || n_words > INT_MAX / 32 || k < 0 || n_pairs < 0 ||
      (long long)n_tiles * n_pairs > INT_MAX ||
      (key_bits != 32 && key_bits != 64) ||
      (key_bits == 32 && (k > (1 << 16) || 32 * n_words > 65535))) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_pairs == 0 || k == 0) return (int)cudaGetLastError();
  if (n_images < 1) return (int)cudaErrorInvalidValue;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kTensorMapError + (int)CUDA_ERROR_NOT_FOUND;
  // Innermost first: the 32 W bytes of a row, the K rows of an image, the
  // images.  A box is one stage of one operand: 128 bytes of 128 rows.
  const cuuint64_t row_bytes = 32 * (cuuint64_t)n_words;
  const cuuint64_t dims[3] = {row_bytes, (cuuint64_t)k,
                              (cuuint64_t)n_images};
  const cuuint64_t strides[2] = {row_bytes, row_bytes * (cuuint64_t)k};
  const cuuint32_t box[3] = {kDepth, kTile, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  CUtensorMap tmap;
  const CUresult res = encode(
      &tmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(pm1), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return kTensorMapError + (int)res;
  const WgLayout l = wgmma_layout((int)((row_bytes + kDepth - 1) / kDepth),
                                  n_tiles);
  const cudaStream_t st = (cudaStream_t)stream;
  if (key_bits == 32) {
    return (int)launch_keys<unsigned>(tmap, l, n_tiles, valid, ii, jj,
                                      n_pairs, k, n_words, i1, d1, i2, d2,
                                      st);
  }
  return (int)launch_keys<unsigned long long>(tmap, l, n_tiles, valid, ii,
                                              jj, n_pairs, k, n_words, i1,
                                              d1, i2, d2, st);
}
