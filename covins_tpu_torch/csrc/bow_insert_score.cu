// A window's BoW vectors, their insertion into the retrieval database, and
// every window row's scores and common-word counts against the database,
// in one cooperative launch.
//
// Replaces: covins_tpu/models/kf_database.py::_insert_and_score after its
// word assignment (one XLA program in the JAX package):
// ops/bow.py::bow_vectors_batch with idf=None, db.at[rows].set(vecs,
// mode="drop"), scores = vecs @ db.T and common = (vecs > 0) @ (db > 0).T,
// against the database rows [0, n) after the insertion.
//
// Bound on the H100: bytes.  The window's W x F word ids and the n x V
// database rows are read once, the W inserted rows, the W vectors and the
// W x 2 x n results written once; the arithmetic is one add per word and
// 2 W operations per database value read (W = 12: 6 a byte, below the 20 a
// byte at which the float32 peak would outrun the memory).
//
// Design, two phases split by one grid barrier:
//  1. one block per window row (block-stride): a V-bin histogram in
//     shared memory by atomicAdd, the sum of the squared counts as an
//     unsigned integer (exact), then count / max(sqrt(sum), 1e-12) in IEEE
//     float32 (sqrtf and division correctly rounded, no fast-math), written
//     to the vectors and, when 0 <= dest < cap, to the database row.
//     Destinations inside [0, cap) are distinct: the database assigns them.
//  2. each block loads a group of window vectors into shared memory (as
//     many as fit a budget the wrapper sets; more groups one after
//     another), and each warp takes database rows: lane l sums
//     vec[v] * row[v] over v = l, l + 32, ... in increasing v (rows padded
//     with zeros to a multiple of 32), then adds across the warp by an
//     xor butterfly 16, 8, 4, 2, 1.  Products and sums are separately
//     rounded (built with --fmad=false, written with __fmul_rn and
//     __fadd_rn), so the score is one written order that the plain
//     version repeats bit for bit.  The common-word count is exact in any
//     order.  Results go to one (W, 2, n) buffer: scores, then the counts
//     as their int32 bit patterns.
// With n = 0 the launch is phase 1 alone and no block waits at the
// barrier.  The database rows phase 2 reads and the vectors it loads were
// written in phase 1 by other blocks: they are read through L2 (__ldcg),
// kBatch loads a thread at a time, so that their latencies overlap.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "coop_launch.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRegRows = 16;  // window rows a warp scores at once, in registers
constexpr int kBatch = 8;     // global loads a thread keeps in flight
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const int32_t* words;  // (W, F)
  const int64_t* dest;   // (W,)
  float* db;             // (cap, V)
  float* vecs;           // (W, V)
  float* out;            // (W, 2, n)
  int W, F, V, Vp;       // Vp: V rounded up to a multiple of 32
  int64_t cap;
  int n, group;          // scored rows; window rows a group in shared memory
};

__device__ __forceinline__ unsigned warp_sum(unsigned x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

__global__ void __launch_bounds__(kThreads) bow_insert_score_kernel(Args p) {
  extern __shared__ float smem[];  // phase 1: V counts; phase 2: group x Vp vectors
  __shared__ unsigned partial[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // phase 1: the vectors and their insertion
  unsigned* hist = reinterpret_cast<unsigned*>(smem);
  for (int row = blockIdx.x; row < p.W; row += gridDim.x) {
    const int64_t d = p.dest[row];
    __syncthreads();  // the previous row's counts are no longer read
    for (int v = threadIdx.x; v < p.V; v += kThreads) hist[v] = 0u;
    __syncthreads();
    const int32_t* w = p.words + (int64_t)row * p.F;
    for (int f0 = threadIdx.x; f0 < p.F; f0 += kBatch * kThreads) {
      int id[kBatch];  // kBatch loads in flight a thread
#pragma unroll
      for (int u = 0; u < kBatch; ++u) id[u] = f0 + u * kThreads < p.F ? w[f0 + u * kThreads] : -1;
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (id[u] >= 0 && id[u] < p.V) atomicAdd(&hist[id[u]], 1u);
    }
    __syncthreads();
    unsigned ss = 0u;
    for (int v = threadIdx.x; v < p.V; v += kThreads) ss += hist[v] * hist[v];
    ss = warp_sum(ss);
    if (lane == 0) partial[warp] = ss;
    __syncthreads();
    unsigned total = 0u;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) total += partial[k];
    const float norm = fmaxf(sqrtf(__uint2float_rn(total)), 1e-12f);
    const bool store = d >= 0 && d < p.cap;
    float* vec = p.vecs + (int64_t)row * p.V;
    float* dbrow = p.db + (store ? d : 0) * p.V;
    for (int v = threadIdx.x; v < p.V; v += kThreads) {
      const float x = __fdiv_rn(__uint2float_rn(hist[v]), norm);
      vec[v] = x;
      if (store) dbrow[v] = x;
    }
    __syncthreads();  // partial[] is rewritten by the next row
  }
  if (p.n == 0) return;  // the same for every block: no one waits below
  cg::this_grid().sync();

  // phase 2: scores and common-word counts against rows [0, n)
  const int gwarp = blockIdx.x * kWarps + warp, nwarps = gridDim.x * kWarps;
  for (int g0 = 0; g0 < p.W; g0 += p.group) {
    const int gw = min(p.group, p.W - g0);
    __syncthreads();  // the previous group is no longer read
    const int total = gw * p.Vp;
    for (int i0 = threadIdx.x; i0 < total; i0 += kBatch * kThreads) {
      float x[kBatch];  // kBatch loads in flight a thread
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + u * kThreads, r = i / p.Vp, v = i - r * p.Vp;
        x[u] = i < total && v < p.V ? __ldcg(p.vecs + (int64_t)(g0 + r) * p.V + v) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (i0 + u * kThreads < total) smem[i0 + u * kThreads] = x[u];
    }
    __syncthreads();
    for (int row = gwarp; row < p.n; row += nwarps) {
      const float* dbrow = p.db + (int64_t)row * p.V;
      for (int i0 = 0; i0 < gw; i0 += kRegRows) {
        float acc[kRegRows];
        unsigned cnt[kRegRows];
#pragma unroll
        for (int k = 0; k < kRegRows; ++k) {
          acc[k] = 0.f;
          cnt[k] = 0u;
        }
        for (int c0 = 0; c0 < p.Vp; c0 += 32 * kBatch) {
          float x[kBatch];  // the row's next kBatch chunks, loads in flight
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            const int v = c0 + 32 * u + lane;
            x[u] = v < p.V ? __ldcg(dbrow + v) : 0.f;
          }
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            const int v = c0 + 32 * u + lane;
            if (c0 + 32 * u >= p.Vp) break;  // the same for the whole warp
#pragma unroll
            for (int k = 0; k < kRegRows; ++k) {
              const float q = i0 + k < gw ? smem[(i0 + k) * p.Vp + v] : 0.f;
              acc[k] = __fadd_rn(acc[k], __fmul_rn(q, x[u]));
              cnt[k] += (q > 0.f) & (x[u] > 0.f);
            }
          }
        }
#pragma unroll
        for (int k = 0; k < kRegRows; ++k) {
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) {
            acc[k] = __fadd_rn(acc[k], __shfl_xor_sync(kFull, acc[k], off));
            cnt[k] += __shfl_xor_sync(kFull, cnt[k], off);
          }
          // every lane holds the same sums: lane k writes window row i0 + k
          if (lane == k && i0 + k < gw) {
            float* o = p.out + (int64_t)(g0 + i0 + k) * 2 * p.n;
            o[row] = acc[k];
            o[p.n + row] = __uint_as_float(cnt[k]);
          }
        }
      }
    }
  }
}

}  // namespace

// words: (W, F) int32, -1 = invalid; dest: (W,) int64; db: (cap, V) f32,
// updated in place; vecs: (W, V) f32 output; out: (W, 2, n) f32 output, or
// null with n = 0; group: window rows a group in shared memory (>= 1).
// Returns 0 or the CUDA error.
extern "C" int covins_bow_insert_score(const void* words, const void* dest, void* db,
                                       void* vecs, void* out, int W, int F, int V,
                                       int64_t cap, int n, int group, void* stream) {
  if (W <= 0) return 0;
  const int Vp = (V + 31) / 32 * 32;
  const size_t smem = static_cast<size_t>(group) * Vp * sizeof(float);
  int room = 0;
  cudaError_t err = coop::smem_room(reinterpret_cast<const void*>(bow_insert_score_kernel),
                                    &room);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (group < 1 || smem > static_cast<size_t>(room))
    return static_cast<int>(cudaErrorInvalidValue);
  Args p{static_cast<const int32_t*>(words), static_cast<const int64_t*>(dest),
         static_cast<float*>(db), static_cast<float*>(vecs), static_cast<float*>(out),
         W, F, V, Vp, cap, n, group};
  void* args[] = {&p};
  // a block per window row, and a warp per scored row
  const long long items = std::max<long long>(static_cast<long long>(W) * kThreads,
                                              32LL * n);
  return coop::launch(bow_insert_score_kernel, kThreads, smem, items, 1 << 30,
                      coop::Slots::kRefuse, args, static_cast<cudaStream_t>(stream));
}
