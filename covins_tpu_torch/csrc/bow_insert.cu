// Batched BoW vectors + in-place insertion into the retrieval database.
//
// Replaces: the histogram, L2-normalise and row-scatter part of
// covins_tpu/models/kf_database.py::_insert_and_score (one XLA program in
// the JAX package: ops/bow.py::bow_vectors_batch with idf=None, then
// db.at[rows].set(vecs, mode="drop")).  The two score products that follow
// stay torch.matmul, as they were plain matmuls in the JAX package.
//
// Bound on the H100: bytes.  Each window row reads F word ids and writes V
// floats twice (its vector and its database row); the arithmetic is one
// add per word and a few operations per bin.
//
// Simple design: one block per window row.  The block builds a V-bin
// histogram in shared memory with atomicAdd, reduces the sum of squared
// counts over the block (warp shuffles, then one warp over the per-warp
// sums), and writes counts / max(sqrt(sum), 1e-12) to the output row and,
// when the destination row lies in [0, cap), to the database row.  Counts
// are integers below 2^24, so the float sum is exact in any order, and
// sqrtf and the division are IEEE-rounded (no fast-math): the result
// equals the plain float32 version bit for bit.  Word ids outside [0, V)
// count as invalid.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

__global__ void __launch_bounds__(kThreads)
bow_insert_kernel(const int32_t* __restrict__ words,
                  const int64_t* __restrict__ dest, float* __restrict__ db,
                  float* __restrict__ vecs, int F, int V, int64_t cap) {
  extern __shared__ unsigned int hist[];
  __shared__ float partial[kThreads / 32];
  const int row = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  for (int v = threadIdx.x; v < V; v += kThreads) hist[v] = 0u;
  __syncthreads();
  const int32_t* w = words + (int64_t)row * F;
  for (int f = threadIdx.x; f < F; f += kThreads) {
    const int id = w[f];
    if (id >= 0 && id < V) atomicAdd(&hist[id], 1u);
  }
  __syncthreads();

  float ss = 0.f;
  for (int v = threadIdx.x; v < V; v += kThreads) {
    const float c = static_cast<float>(hist[v]);
    ss += c * c;
  }
  ss = warp_sum(ss);
  if (lane == 0) partial[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float s = lane < kThreads / 32 ? partial[lane] : 0.f;
    s = warp_sum(s);
    if (lane == 0) partial[0] = s;
  }
  __syncthreads();
  const float norm = fmaxf(sqrtf(partial[0]), 1e-12f);

  const int64_t d = dest[row];
  const bool store = d >= 0 && d < cap;
  float* out = vecs + (int64_t)row * V;
  float* dbrow = db + (store ? d : 0) * V;
  for (int v = threadIdx.x; v < V; v += kThreads) {
    const float x = static_cast<float>(hist[v]) / norm;
    out[v] = x;
    if (store) dbrow[v] = x;
  }
}

}  // namespace

// words: (W, F) int32, -1 = invalid; dest: (W,) int64; db: (cap, V) f32,
// updated in place; vecs: (W, V) f32.
extern "C" int covins_bow_insert(const void* words, const void* dest,
                                 void* db, void* vecs, int W, int F, int V,
                                 int64_t cap, void* stream) {
  if (W <= 0) return 0;
  const size_t smem = static_cast<size_t>(V) * sizeof(unsigned int);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        bow_insert_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  bow_insert_kernel<<<W, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(words), static_cast<const int64_t*>(dest),
      static_cast<float*>(db), static_cast<float*>(vecs), F, V, cap);
  return static_cast<int>(cudaGetLastError());
}
