// Masked mutual-nearest-neighbour matching of packed 256-bit descriptors.
//
// Replaces: covins_tpu/ops/descriptors.py::masked_dist + match_mutual_nn,
// as stage 1 of the COVINS loop verification calls them
// (covins_tpu/ops/loopverify.py:_covins_stage14_body, lines 88-90): the
// (Q, C) Hamming matrix of the query keyframe's and the candidate
// keyframe's landmark-tied descriptors, masked rows and columns set to
// 2^30, the row argmin, the column argmin, the mutual check and the
// `dist < max_dist` gate.
//
// Bound on the H100: Q*C descriptor pairs of 8 XOR + 8 popcount on 32-bit
// words; the bytes are tiny (Q*32 + C*32 in, Q*4 out).  The least time is
// the same product as a +-1 int8 tensor-core matmul, so the work is bound
// by operations.  At the main path's 1024 x 1024 it is one launch's
// latency either way.
//
// Design: the JAX version materialises the masked matrix and reduces it
// twice.  Here the first launch runs two kinds of blocks over the packed
// descriptors: row blocks take, for each valid query row, the argmin over
// the valid columns; column blocks take, for each valid column, the
// argmin over the valid rows.  Both walk their candidates in ascending
// order with a strict '<', so ties go to the lowest index as jnp.argmin's
// do, whatever order the blocks run in; no atomics and no (Q, C) matrix.
// A masked entry never wins, as 2^30 never does in the reference (a valid
// row has at least one distance <= 256 whenever any column is valid).
// The second launch is the epilogue: idx[m] = fwd[m] where the pair is
// mutual and its distance passes the gate, else -1.  A row or column
// with nothing valid to compare gets -1, where the reference's argmin
// returns 0 with distance 2^30; neither reaches the result.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;  // query descriptors per block
constexpr int kTile = 256;    // candidate descriptors per shared-memory tile

__device__ __forceinline__ int popc8(const uint4& a0, const uint4& a1,
                                     const uint4& b0, const uint4& b1) {
  return __popc(a0.x ^ b0.x) + __popc(a0.y ^ b0.y) + __popc(a0.z ^ b0.z) +
         __popc(a0.w ^ b0.w) + __popc(a1.x ^ b1.x) + __popc(a1.y ^ b1.y) +
         __popc(a1.z ^ b1.z) + __popc(a1.w ^ b1.w);
}

// One pass: for each query descriptor q < nq (valid per qmask), the index
// of the nearest valid database descriptor (lowest index on ties) and its
// distance; -1 where the query is masked or no database entry is valid.
__device__ void argmin_pass(int block, const uint4* __restrict__ q,
                            const uint8_t* __restrict__ qmask, int nq,
                            const uint4* __restrict__ db,
                            const uint8_t* __restrict__ dbmask, int ndb,
                            int32_t* __restrict__ best_idx,
                            int32_t* __restrict__ best_dist) {
  __shared__ uint4 tile[2 * kTile];
  __shared__ uint8_t tile_ok[kTile];
  const int row = block * kThreads + threadIdx.x;
  const bool live = row < nq && qmask[row] != 0;
  uint4 q0 = make_uint4(0u, 0u, 0u, 0u);
  uint4 q1 = q0;
  if (live) {
    q0 = q[2 * (int64_t)row];
    q1 = q[2 * (int64_t)row + 1];
  }
  int best = 0x7fffffff;
  int best_j = -1;
  for (int j0 = 0; j0 < ndb; j0 += kTile) {
    const int n = min(kTile, ndb - j0);
    __syncthreads();
    for (int t = threadIdx.x; t < 2 * n; t += kThreads) {
      tile[t] = db[2 * (int64_t)j0 + t];
    }
    for (int t = threadIdx.x; t < n; t += kThreads) {
      tile_ok[t] = dbmask[j0 + t];
    }
    __syncthreads();
    if (live) {
      for (int j = 0; j < n; ++j) {
        if (!tile_ok[j]) continue;
        const int d = popc8(q0, q1, tile[2 * j], tile[2 * j + 1]);
        if (d < best) {
          best = d;
          best_j = j0 + j;
        }
      }
    }
  }
  if (row < nq) {
    best_idx[row] = best_j;
    best_dist[row] = best;
  }
}

__global__ void __launch_bounds__(kThreads)
mutual_argmin_kernel(const uint4* __restrict__ a, const uint8_t* __restrict__ amask,
                     int M, const uint4* __restrict__ b,
                     const uint8_t* __restrict__ bmask, int N, int row_blocks,
                     int32_t* __restrict__ fwd, int32_t* __restrict__ dfwd,
                     int32_t* __restrict__ bwd, int32_t* __restrict__ dbwd) {
  if ((int)blockIdx.x < row_blocks) {
    argmin_pass(blockIdx.x, a, amask, M, b, bmask, N, fwd, dfwd);
  } else {
    argmin_pass(blockIdx.x - row_blocks, b, bmask, N, a, amask, M, bwd, dbwd);
  }
}

__global__ void mutual_epilogue_kernel(const int32_t* __restrict__ fwd,
                                       const int32_t* __restrict__ dfwd,
                                       const int32_t* __restrict__ bwd, int M,
                                       float max_dist, int32_t* __restrict__ idx) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  const int f = fwd[m];
  const bool ok = f >= 0 && bwd[f] == m && (float)dfwd[m] < max_dist;
  idx[m] = ok ? f : -1;
}

}  // namespace

// a: (M, 32) u8, b: (N, 32) u8, contiguous and 16-byte aligned; amask (M,)
// and bmask (N,) bool; scratch: fwd, dfwd (M,) and bwd, dbwd (N,) int32;
// idx: (M,) int32 output.
extern "C" int covins_hamming_mutual_nn(const void* a, const void* amask, int M,
                                        const void* b, const void* bmask, int N,
                                        float max_dist, void* fwd, void* dfwd,
                                        void* bwd, void* dbwd, void* idx,
                                        void* stream) {
  if (M <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int row_blocks = (M + kThreads - 1) / kThreads;
  const int col_blocks = (N + kThreads - 1) / kThreads;
  mutual_argmin_kernel<<<row_blocks + col_blocks, kThreads, 0, s>>>(
      static_cast<const uint4*>(a), static_cast<const uint8_t*>(amask), M,
      static_cast<const uint4*>(b), static_cast<const uint8_t*>(bmask), N,
      row_blocks, static_cast<int32_t*>(fwd), static_cast<int32_t*>(dfwd),
      static_cast<int32_t*>(bwd), static_cast<int32_t*>(dbwd));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  mutual_epilogue_kernel<<<(M + 255) / 256, 256, 0, s>>>(
      static_cast<const int32_t*>(fwd), static_cast<const int32_t*>(dfwd),
      static_cast<const int32_t*>(bwd), M, max_dist, static_cast<int32_t*>(idx));
  return static_cast<int>(cudaGetLastError());
}
