// Fused Hamming distance + row argmin over packed 256-bit descriptors.
//
// Replaces: the Pallas kernel covins_tpu/ops/hamming_pallas.py::
// hamming_distance_packed_T (removed from the JAX package, whose live
// equivalent is covins_tpu/ops/descriptors.py::hamming_distance_best, the
// unpack-to-+-1 matmul) together with the jnp.argmin every main-path
// caller takes at once (models/kf_database.py:_insert_and_score word
// assignment, ops/bow.py:assign_words, the k-medians assignment of
// ops/bow.py:train_vocabulary).
//
// Bound on the H100: the work is M*N descriptor pairs of 8 XOR + 8
// popcount + adds on 32-bit words, while the bytes are tiny (M*32 + N*32
// in, M*8 out).  The least time is the same product done as a +-1 int8
// tensor-core matmul (2*M*N*256 operations at the int8 rate), so the
// kernel is bound by operations, not bytes.
//
// Simple design: one thread per query row keeps its descriptor in
// registers as two uint4 (8 words); each block stages a tile of kTile
// database descriptors in shared memory, and every thread of the block
// reads the same tile entry at the same time (a shared-memory broadcast).
// The running minimum uses a strict '<' over ascending column indices, so
// ties go to the lowest index, as jnp.argmin and torch.argmin do.  The
// full (M, N) distance matrix is written only when asked for.  Later work:
// tensor-core +-1 products or several rows per thread.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;  // query rows per block
constexpr int kTile = 256;    // database descriptors per shared-memory tile

__device__ __forceinline__ int popc8(const uint4& a0, const uint4& a1,
                                     const uint4& b0, const uint4& b1) {
  return __popc(a0.x ^ b0.x) + __popc(a0.y ^ b0.y) + __popc(a0.z ^ b0.z) +
         __popc(a0.w ^ b0.w) + __popc(a1.x ^ b1.x) + __popc(a1.y ^ b1.y) +
         __popc(a1.z ^ b1.z) + __popc(a1.w ^ b1.w);
}

__global__ void __launch_bounds__(kThreads)
hamming_argmin_kernel(const uint4* __restrict__ a, const uint4* __restrict__ b,
                      const uint8_t* __restrict__ row_mask, int M, int N,
                      int32_t* __restrict__ idx, int32_t* __restrict__ dmin,
                      int32_t* __restrict__ dist) {
  __shared__ uint4 tile[2 * kTile];
  const int row = blockIdx.x * kThreads + threadIdx.x;
  const bool live = row < M;
  uint4 q0 = make_uint4(0u, 0u, 0u, 0u);
  uint4 q1 = q0;
  if (live) {
    q0 = a[2 * (int64_t)row];
    q1 = a[2 * (int64_t)row + 1];
  }
  int best = 0x7fffffff;
  int best_j = 0;
  for (int j0 = 0; j0 < N; j0 += kTile) {
    const int n = min(kTile, N - j0);
    __syncthreads();  // the previous tile is no longer read
    for (int t = threadIdx.x; t < 2 * n; t += kThreads) {
      tile[t] = b[2 * (int64_t)j0 + t];
    }
    __syncthreads();
    if (live) {
      for (int j = 0; j < n; ++j) {
        const int d = popc8(q0, q1, tile[2 * j], tile[2 * j + 1]);
        if (dist != nullptr) dist[(int64_t)row * N + j0 + j] = d;
        if (d < best) {
          best = d;
          best_j = j0 + j;
        }
      }
    }
  }
  if (live) {
    dmin[row] = best;
    idx[row] = (row_mask != nullptr && row_mask[row] == 0) ? -1 : best_j;
  }
}

}  // namespace

// a: (M, 32) u8, b: (N, 32) u8, both 16-byte aligned and contiguous;
// row_mask: (M,) bool or null; dist: (M, N) int32 or null.
extern "C" int covins_hamming_argmin(const void* a, const void* b,
                                     const void* row_mask, int M, int N,
                                     void* idx, void* dmin, void* dist,
                                     void* stream) {
  if (M <= 0) return 0;
  const dim3 grid((M + kThreads - 1) / kThreads);
  hamming_argmin_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(a), static_cast<const uint4*>(b),
      static_cast<const uint8_t*>(row_mask), M, N,
      static_cast<int32_t*>(idx), static_cast<int32_t*>(dmin),
      static_cast<int32_t*>(dist));
  return static_cast<int>(cudaGetLastError());
}
