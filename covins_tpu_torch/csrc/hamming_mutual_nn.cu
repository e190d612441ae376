// Masked mutual-nearest-neighbour matching of packed 256-bit descriptors.
//
// Replaces: covins_tpu/ops/descriptors.py::masked_dist + match_mutual_nn,
// as stage 1 of the COVINS loop verification calls them
// (covins_tpu/ops/loopverify.py:_covins_stage14_body, lines 88-90): the
// (M, N) Hamming matrix of the query keyframe's and the candidate
// keyframe's landmark-tied descriptors, masked rows and columns set to
// 2^30, the row argmin, the column argmin (ties to the lowest index), the
// mutual check and the `dist < max_dist` gate in float32.
//
// Bound on the H100: M*N descriptor pairs of 8 XOR + 8 popcount on 32-bit
// words; the bytes are tiny (M*32 + N*32 in, M*4 out).  The least time is
// the same product as a +-1 int8 tensor-core matmul, so the work is bound
// by operations; at the main path's 1024 x 1024 it is about 8.4 M popcounts,
// microseconds spread over the card.  Tensor cores are not used: an int8
// mma would first unpack every descriptor to 256 +-1 bytes, eight times
// its packed size, to save work that is not what this call waits for.
// Measured on one H100 (700 W limit): 9.0 us busy at 1024 x 1024, of
// which 6.4 us is the launch and its two barriers (the same call at
// 1 x 1), so the popcounts take under 3 us.
//
// Design, one cooperative launch (a grid the card holds at once, at least
// one block per SM at the main path's size; a refused launch returns its
// error and the caller raises):
//   0  grid-stride: every row key and column key = max;
//   -- grid barrier --
//   1  the (M, N) plane in 64 x 64 tiles, grid-stride over the blocks;
//      each block stages its 64 row and 64 column descriptors in shared
//      memory with cp.async and forms each pair's distance once (eight
//      32-bit XOR + __popc).  Each valid pair folds into its row's and its
//      column's minimum as a packed 64-bit key (dist << 32 | index), so
//      the smallest key is the smallest distance with the lowest index:
//      a row's minimum over the tile by shuffles, a column's by shuffles
//      and a shared-memory atomicMin, then one global atomicMin each.  The
//      minimum does not depend on the order, so two launches give the
//      same result;
//   -- grid barrier --
//   2  grid-stride over the rows: idx = the row key's column where the
//      column key points back at the row and the distance passes the
//      gate, else -1.
// Masked rows and columns never fold, as 2^30 never wins in the reference
// (a valid row has a distance <= 256 to every valid column); a row or
// column with nothing valid keeps the max key and gives -1, where the
// reference's argmin returns 0 at distance 2^30, which fails the gate.

#include <algorithm>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "coop_launch.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 64;  // rows and columns of a tile
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned long long NONE = ~0ull;

struct Args {
  const uint4* a;  // (M, 2) uint4: M descriptors
  const uint8_t* amask;
  int M;
  const uint4* b;  // (N, 2)
  const uint8_t* bmask;
  int N;
  float max_dist;
  unsigned long long* keys;  // (M + N): row keys, then column keys
  int32_t* idx;              // (M,)
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ unsigned long long umin(unsigned long long x,
                                                   unsigned long long y) {
  return x < y ? x : y;
}

__device__ __forceinline__ int popc8(const uint4& a0, const uint4& a1, const uint4& b0,
                                     const uint4& b1) {
  return __popc(a0.x ^ b0.x) + __popc(a0.y ^ b0.y) + __popc(a0.z ^ b0.z) +
         __popc(a0.w ^ b0.w) + __popc(a1.x ^ b1.x) + __popc(a1.y ^ b1.y) +
         __popc(a1.z ^ b1.z) + __popc(a1.w ^ b1.w);
}

__global__ void __launch_bounds__(THREADS) mutual_nn_kernel(Args g) {
  cg::grid_group grid = cg::this_grid();
  __shared__ uint4 sa[2 * TILE], sb[2 * TILE];
  __shared__ uint8_t oka[TILE], okb[TILE];
  __shared__ unsigned long long colmin[TILE];
  const int tid = blockIdx.x * THREADS + threadIdx.x;
  const int nthreads = gridDim.x * THREADS;
  unsigned long long* rowkey = g.keys;
  unsigned long long* colkey = g.keys + g.M;

  // phase 0
  for (int k = tid; k < g.M + g.N; k += nthreads) g.keys[k] = NONE;
  grid.sync();

  // phase 1: thread (ty, tx) takes rows 4 ty .. 4 ty + 3 and columns
  // tx + 16 c, c < 4, of the tile
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int tiles_c = (g.N + TILE - 1) / TILE;
  const int tiles = ((g.M + TILE - 1) / TILE) * tiles_c;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int i0 = (t / tiles_c) * TILE, j0 = (t % tiles_c) * TILE;
    __syncthreads();  // the previous tile's reads are done
    {
      // one 16-byte chunk per thread: 2 x 64 row chunks, then 2 x 64 column
      const int c = threadIdx.x & (2 * TILE - 1);
      if (threadIdx.x < 2 * TILE) {
        if (i0 + c / 2 < g.M) cp_async16(&sa[c], &g.a[2 * (int64_t)i0 + c]);
      } else if (j0 + c / 2 < g.N) {
        cp_async16(&sb[c], &g.b[2 * (int64_t)j0 + c]);
      }
      if (threadIdx.x < TILE) {
        const int i = i0 + threadIdx.x;
        oka[threadIdx.x] = i < g.M && g.amask[i] != 0;
        colmin[threadIdx.x] = NONE;
      } else if (threadIdx.x < 2 * TILE) {
        const int j = j0 + threadIdx.x - TILE;
        okb[threadIdx.x - TILE] = j < g.N && g.bmask[j] != 0;
      }
      cp_async_wait_all();
    }
    __syncthreads();
    unsigned long long rk[4] = {NONE, NONE, NONE, NONE};
    unsigned long long ck[4] = {NONE, NONE, NONE, NONE};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int li = 4 * ty + r;
      if (!oka[li]) continue;
      const uint4 a0 = sa[2 * li], a1 = sa[2 * li + 1];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int lj = tx + 16 * c;
        if (!okb[lj]) continue;
        const unsigned long long d = popc8(a0, a1, sb[2 * lj], sb[2 * lj + 1]);
        rk[r] = umin(rk[r], (d << 32) | (unsigned)(j0 + lj));
        ck[c] = umin(ck[c], (d << 32) | (unsigned)(i0 + li));
      }
    }
    // a row's 16 threads are 16 consecutive lanes
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rk[r] = umin(rk[r], __shfl_xor_sync(FULL, rk[r], off));
      if (tx == 0 && rk[r] != NONE) atomicMin(&rowkey[i0 + 4 * ty + r], rk[r]);
    }
    // a column's threads: lanes tx and tx + 16 of every warp
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      ck[c] = umin(ck[c], __shfl_xor_sync(FULL, ck[c], 16));
      if ((threadIdx.x & 16) == 0 && ck[c] != NONE) atomicMin(&colmin[tx + 16 * c], ck[c]);
    }
    __syncthreads();
    if (threadIdx.x < TILE && colmin[threadIdx.x] != NONE)
      atomicMin(&colkey[j0 + threadIdx.x], colmin[threadIdx.x]);
  }
  grid.sync();

  // phase 2: the mutual check and the gate
  for (int m = tid; m < g.M; m += nthreads) {
    const unsigned long long k = rowkey[m];
    int out = -1;
    if (k != NONE) {
      const int f = static_cast<int>(k & 0xffffffffu);
      const int d = static_cast<int>(k >> 32);
      if (static_cast<int>(colkey[f] & 0xffffffffu) == m && static_cast<float>(d) < g.max_dist)
        out = f;
    }
    g.idx[m] = out;
  }
}

}  // namespace

// a: (M, 32) u8, b: (N, 32) u8, contiguous and 16-byte aligned; amask (M,)
// and bmask (N,) bool; keys: (M + N,) 64-bit scratch; idx: (M,) int32
// output.  Returns 0 or the CUDA error.
extern "C" int covins_hamming_mutual_nn(const void* a, const void* amask, int M, const void* b,
                                        const void* bmask, int N, float max_dist, void* keys,
                                        void* idx, void* stream) {
  if (M <= 0) return 0;
  Args g{static_cast<const uint4*>(a),
         static_cast<const uint8_t*>(amask),
         M,
         static_cast<const uint4*>(b),
         static_cast<const uint8_t*>(bmask),
         N,
         max_dist,
         static_cast<unsigned long long*>(keys),
         static_cast<int32_t*>(idx)};
  void* args[] = {&g};
  const long long tiles =
      static_cast<long long>((M + TILE - 1) / TILE) * ((N + TILE - 1) / TILE);
  const long long items = std::max<long long>(tiles * THREADS, M + (long long)N);
  return coop::launch(mutual_nn_kernel, THREADS, 0, items, 1 << 30, coop::Slots::kRefuse, args,
                      static_cast<cudaStream_t>(stream));
}
