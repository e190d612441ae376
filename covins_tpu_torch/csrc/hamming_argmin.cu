// Fused Hamming distance + row argmin over packed 256-bit descriptors, with
// the distances formed on the tensor cores.
//
// Replaces: the Pallas kernel covins_tpu/ops/hamming_pallas.py::
// hamming_distance_packed_T (removed from the JAX package, whose live
// equivalent is covins_tpu/ops/descriptors.py::hamming_distance_best, the
// unpack-to-+-1 matmul) together with the jnp.argmin every main-path
// caller takes at once (models/kf_database.py:_insert_and_score word
// assignment, ops/bow.py:assign_words, the k-medians assignment of
// ops/bow.py:train_vocabulary).
//
// Bound on the H100: the work is M*N descriptor pairs of 256 bits each,
// while the bytes are tiny (M*32 + N*32 in, M*8 out).  The least time is
// the same product as a +-1 int8 tensor-core matmul (2*M*N*256 operations
// at the int8 rate), so the kernel is bound by operations, not bytes.
//
// Design: one binary tensor-core product a 16 x 8 tile.
//   mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc
// takes a whole 256-bit descriptor as the depth, straight from the packed
// words, and gives popc(a & b) exactly; the distance is
// popc(a) + popc(b) - 2 popc(a & b).  A warp keeps its 16 query rows' A
// fragment (rows g and g + 8, words t and t + 4 of lane 4g + t) in four
// registers for the whole launch; a block of kWarps warps takes kRows
// rows, its kColSplits warps per row tile walking interleaved column
// tiles.  The vocabulary is staged in shared memory kTileN words at a time,
// each word's eight 32-bit words stored as the pairs (k, k + 4) its B
// fragment reads in one 8-byte load, and beside it a key part
// popc(b) << kColBits | column.  The epilogue stays in registers: each
// (row, column) forms the key (distance << kColBits | column) as
// (popc(a) << kColBits) + key part - (popc(a & b) << (kColBits + 1)), and
// a running unsigned min keeps the smallest distance and, on ties, the
// lowest column, in any order.  The four lanes of a quad, then the warps
// sharing a row tile, are merged by the same min.  Columns past N (the
// last tile padded to 8) hold zero words and a key part above every real
// key.  The full (M, N) distance matrix is written only when asked for.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRowTiles = 2;   // 16-row tiles a block
constexpr int kColSplits = 4;  // warps sharing one row tile's columns
constexpr int kWarps = kRowTiles * kColSplits;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kRowTiles;  // query rows a block
constexpr int kTileN = 1024;           // vocabulary words a shared-memory tile
constexpr int kColBits = 22;           // key = distance << kColBits | column
constexpr unsigned kColMask = (1u << kColBits) - 1u;
// the key part of a padded column: popc(a & 0) = 0, so its key is
// (popc(a) + 300) << kColBits, above every real key (distance <= 256) and
// below 2^32 (popc(a) <= 256)
constexpr unsigned kPadKey = 300u << kColBits;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void mma_and_popc(unsigned (&d)[4], const unsigned (&a)[4],
                                             unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "r"(0), "r"(0), "r"(0), "r"(0));
}

__device__ __forceinline__ unsigned quad_min(unsigned k) {
  k = min(k, __shfl_xor_sync(kFull, k, 1));
  return min(k, __shfl_xor_sync(kFull, k, 2));
}

__global__ void __launch_bounds__(kThreads)
hamming_argmin_kernel(const unsigned* __restrict__ a, const unsigned* __restrict__ b,
                      const uint8_t* __restrict__ row_mask, int M, int N,
                      int32_t* __restrict__ idx, int32_t* __restrict__ dmin,
                      int32_t* __restrict__ dist) {
  __shared__ uint2 sb[4 * kTileN];   // word pairs (k, k + 4), k = 0..3, of each word
  __shared__ unsigned skey[kTileN];  // popc(word) << kColBits | column
  __shared__ unsigned sbest[kColSplits][kRows];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rt = warp % kRowTiles, cs = warp / kRowTiles;
  const int row_a = blockIdx.x * kRows + rt * 16 + g, row_b = row_a + 8;

  // A fragment: rows row_a (a0, a2) and row_b (a1, a3), words t and t + 4
  unsigned fa[4] = {0u, 0u, 0u, 0u};
  if (row_a < M) {
    fa[0] = a[8 * (int64_t)row_a + t];
    fa[2] = a[8 * (int64_t)row_a + t + 4];
  }
  if (row_b < M) {
    fa[1] = a[8 * (int64_t)row_b + t];
    fa[3] = a[8 * (int64_t)row_b + t + 4];
  }
  int pa = __popc(fa[0]) + __popc(fa[2]), pb = __popc(fa[1]) + __popc(fa[3]);
  pa += __shfl_xor_sync(kFull, pa, 1);
  pa += __shfl_xor_sync(kFull, pa, 2);
  pb += __shfl_xor_sync(kFull, pb, 1);
  pb += __shfl_xor_sync(kFull, pb, 2);
  const unsigned ka = static_cast<unsigned>(pa) << kColBits;
  const unsigned kb = static_cast<unsigned>(pb) << kColBits;
  unsigned best_a = kFull, best_b = kFull;

  for (int j0 = 0; j0 < N; j0 += kTileN) {
    const int n = min(kTileN, N - j0);
    const int n8 = (n + 7) & ~7;
    __syncthreads();  // the previous tile is no longer read
    // four lanes a word (whole warps: 4 * n8 is a multiple of 32)
    for (int i = threadIdx.x; i < 4 * n8; i += kThreads) {
      const int j = i >> 2, k = i & 3;
      unsigned lo = 0u, hi = 0u;
      if (j < n) {
        lo = b[8 * (int64_t)(j0 + j) + k];
        hi = b[8 * (int64_t)(j0 + j) + k + 4];
      }
      sb[i] = make_uint2(lo, hi);
      int p = __popc(lo) + __popc(hi);
      p += __shfl_xor_sync(kFull, p, 1);
      p += __shfl_xor_sync(kFull, p, 2);
      if (k == 0) skey[j] = j < n ? (static_cast<unsigned>(p) << kColBits) | (j0 + j) : kPadKey;
    }
    __syncthreads();
    for (int c0 = 8 * cs; c0 < n8; c0 += 8 * kColSplits) {
      const uint2 fb = sb[4 * (c0 + g) + t];  // column c0 + g, words t and t + 4
      unsigned and_popc[4];
      mma_and_popc(and_popc, fa, fb.x, fb.y);
      // accumulator: (row_a, c0 + 2t), (row_a, c0 + 2t + 1), then row_b
      const uint2 part = *reinterpret_cast<const uint2*>(&skey[c0 + 2 * t]);
      const unsigned k0 = ka + part.x - (and_popc[0] << (kColBits + 1));
      const unsigned k1 = ka + part.y - (and_popc[1] << (kColBits + 1));
      const unsigned k2 = kb + part.x - (and_popc[2] << (kColBits + 1));
      const unsigned k3 = kb + part.y - (and_popc[3] << (kColBits + 1));
      best_a = min(best_a, min(k0, k1));
      best_b = min(best_b, min(k2, k3));
      if (dist != nullptr) {
        const int col = j0 + c0 + 2 * t;
        if (row_a < M) {
          if (col < N) dist[(int64_t)row_a * N + col] = static_cast<int>(k0 >> kColBits);
          if (col + 1 < N) dist[(int64_t)row_a * N + col + 1] = static_cast<int>(k1 >> kColBits);
        }
        if (row_b < M) {
          if (col < N) dist[(int64_t)row_b * N + col] = static_cast<int>(k2 >> kColBits);
          if (col + 1 < N) dist[(int64_t)row_b * N + col + 1] = static_cast<int>(k3 >> kColBits);
        }
      }
    }
  }

  best_a = quad_min(best_a);
  best_b = quad_min(best_b);
  if (t == 0) {
    sbest[cs][rt * 16 + g] = best_a;
    sbest[cs][rt * 16 + g + 8] = best_b;
  }
  __syncthreads();
  if (threadIdx.x < kRows) {
    const int row = blockIdx.x * kRows + threadIdx.x;
    unsigned key = sbest[0][threadIdx.x];
#pragma unroll
    for (int s = 1; s < kColSplits; ++s) key = min(key, sbest[s][threadIdx.x]);
    if (row < M) {
      dmin[row] = static_cast<int>(key >> kColBits);
      idx[row] = (row_mask != nullptr && row_mask[row] == 0) ? -1
                                                             : static_cast<int>(key & kColMask);
    }
  }
}

}  // namespace

// a: (M, 32) u8, b: (N, 32) u8, both 4-byte aligned and contiguous,
// 0 < N < 2^22; row_mask: (M,) bool or null; dist: (M, N) int32 or null.
extern "C" int covins_hamming_argmin(const void* a, const void* b,
                                     const void* row_mask, int M, int N,
                                     void* idx, void* dmin, void* dist,
                                     void* stream) {
  if (M <= 0) return 0;
  if (N <= 0 || N > static_cast<int>(kColMask)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((M + kRows - 1) / kRows);
  hamming_argmin_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(a), static_cast<const unsigned*>(b),
      static_cast<const uint8_t*>(row_mask), M, N,
      static_cast<int32_t*>(idx), static_cast<int32_t*>(dmin),
      static_cast<int32_t*>(dist));
  return static_cast<int>(cudaGetLastError());
}
