// K15: per-keyframe redundancy values of keyframe culling, in one
// cooperative launch.
//
// Replaces: covins_tpu/ops/covisibility.py::redundancy_values (line 58,
// `_RED_TABLE` :52): each landmark's live-observation count (an int32
// scatter-add of the mask), each observation's score from the table
// {0, 0, 0, 0.4, 0.7, 0.9, 1.0}[min(count, 6)] times its mask, the float32
// scatter-adds of those scores and of the masks by keyframe, and their
// quotient tot / max(cnt, 1).  The JAX package's scatter-adds on the CPU
// add each keyframe's values in observation order; atomics would add them
// in arrival order, ulps apart from run to run, and culling sorts these
// values to pick the keyframe it erases, among many near-ties (the table
// has five values).  So this kernel adds in observation order too, and
// agrees bit for bit with its plain version
// (ops/covisibility.py::redundancy_values_plain).
//
// Bound on the H100: bytes.  Each observation's keyframe, landmark and
// mask (12 bytes) are read, n_kf floats written; the arithmetic is a few
// operations an observation.  At the five-agent map's 1.6e5 observations
// that is about 2 MB, under a microsecond at 3.35 TB/s.  The design below
// pays for its order instead: every block reads the keyframe column of
// all observations, and one thread a block adds its keyframes' values one
// at a time.
//
// Design, two phases split by one grid barrier:
//  1. grid-stride over the observations: atomicAdd of the truncated mask
//     into the landmark's int32 count (exact in any order; the counts are
//     zeroed by cudaMemsetAsync before the launch).
//  2. block b owns a range of consecutive keyframes (the n_kf rows cut
//     into as many ranges as there are blocks, at most kMaxOwned a range;
//     more ranges are taken block-stride).  It scans the observations in
//     chunks of kChunk, kItems a thread, and compacts the chunk's
//     observations of its keyframes in observation order into shared
//     memory (warp ballots, a prefix over the (item, warp) groups in
//     order): their keyframe, score x mask (__fmul_rn) and mask.  Thread 0
//     then adds them, one at a time in that order, to the range's running
//     sums in shared memory (__fadd_rn, from +0.0).  The range's values
//     are tot / (cnt < 1 ? 1 : cnt) (__fdiv_rn; a NaN count stays NaN, as
//     jnp.maximum keeps it).  The counts written in phase 1 by other
//     blocks are read through L2 (__ldcg).

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "coop_launch.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;  // observations a thread reads per chunk
constexpr int kChunk = kThreads * kItems;
constexpr int kGroups = kItems * kWarps;  // (item, warp) groups of a chunk, in order
constexpr int kMaxOwned = 1024;  // keyframes a block sums at once
constexpr unsigned kFull = 0xffffffffu;

__constant__ float kTable[7] = {0.0f, 0.0f, 0.0f, 0.4f, 0.7f, 0.9f, 1.0f};

struct Args {
  const int32_t* obs_kf;  // (O,)
  const int32_t* obs_lm;  // (O,)
  const float* mask;      // (O,)
  int O, n_kf;
  int32_t* lm_count;  // (n_lm,), zeroed
  float* out;         // (n_kf,)
};

__global__ void __launch_bounds__(kThreads) redundancy_values_kernel(Args p) {
  __shared__ float s_tot[kMaxOwned], s_cnt[kMaxOwned];
  __shared__ float c_val[kChunk], c_msk[kChunk];
  __shared__ int c_kf[kChunk];
  __shared__ int g_base[kGroups + 1];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long stride = 1LL * gridDim.x * kThreads;
  for (long long o = 1LL * blockIdx.x * kThreads + tid; o < p.O; o += stride) {
    const int w = __float2int_rz(p.mask[o]);
    if (w != 0) atomicAdd(&p.lm_count[p.obs_lm[o]], w);
  }
  cg::this_grid().sync();

  const int per_block = (p.n_kf + gridDim.x - 1) / gridDim.x;
  const int owned = per_block < kMaxOwned ? per_block : kMaxOwned;
  const int ranges = (p.n_kf + owned - 1) / owned;
  const unsigned lt = (1u << lane) - 1u;
  for (int r = blockIdx.x; r < ranges; r += gridDim.x) {
    const int k0 = r * owned;
    const int nk = min(owned, p.n_kf - k0);
    for (int i = tid; i < nk; i += kThreads) {
      s_tot[i] = 0.0f;
      s_cnt[i] = 0.0f;
    }
    for (int base = 0; base < p.O; base += kChunk) {
      unsigned rel[kItems], ball[kItems];
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        const int o = base + j * kThreads + tid;
        rel[j] = o < p.O ? static_cast<unsigned>(p.obs_kf[o] - k0) : 0xffffffffu;
        ball[j] = __ballot_sync(kFull, rel[j] < static_cast<unsigned>(nk));
        if (lane == 0) g_base[j * kWarps + warp] = __popc(ball[j]);
      }
      __syncthreads();
      if (tid == 0) {
        int run = 0;
        for (int g = 0; g < kGroups; ++g) {
          const int c = g_base[g];
          g_base[g] = run;
          run += c;
        }
        g_base[kGroups] = run;
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        if (rel[j] < static_cast<unsigned>(nk)) {
          const int o = base + j * kThreads + tid;
          const int pos = g_base[j * kWarps + warp] + __popc(ball[j] & lt);
          const int c = __ldcg(&p.lm_count[p.obs_lm[o]]);
          const float m = p.mask[o];
          c_val[pos] = __fmul_rn(kTable[c < 0 ? 0 : (c > 6 ? 6 : c)], m);
          c_msk[pos] = m;
          c_kf[pos] = static_cast<int>(rel[j]);
        }
      }
      __syncthreads();
      if (tid == 0) {
        const int n = g_base[kGroups];
        for (int i = 0; i < n; ++i) {
          const int k = c_kf[i];
          s_tot[k] = __fadd_rn(s_tot[k], c_val[i]);
          s_cnt[k] = __fadd_rn(s_cnt[k], c_msk[i]);
        }
      }
      __syncthreads();
    }
    for (int i = tid; i < nk; i += kThreads) {
      const float c = s_cnt[i];
      p.out[k0 + i] = __fdiv_rn(s_tot[i], c < 1.0f ? 1.0f : c);
    }
    __syncthreads();
  }
}

}  // namespace

// obs_kf, obs_lm: (O,) int32 with 0 <= obs_kf < n_kf, 0 <= obs_lm < n_lm;
// mask: (O,) float32; lm_count: (n_lm,) int32 scratch; out: (n_kf,)
// float32.  Returns 0 or the CUDA error.
extern "C" int covins_redundancy_values(const void* obs_kf, const void* obs_lm,
                                        const void* mask, int O, int n_kf, int n_lm,
                                        void* lm_count, void* out, void* stream) {
  if (n_kf <= 0) return 0;
  if (O < 0 || n_lm <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = cudaMemsetAsync(lm_count, 0, sizeof(int32_t) * n_lm, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  Args p{static_cast<const int32_t*>(obs_kf), static_cast<const int32_t*>(obs_lm),
         static_cast<const float*>(mask), O, n_kf, static_cast<int32_t*>(lm_count),
         static_cast<float*>(out)};
  void* args[] = {&p};
  // a block per keyframe at most, and enough blocks to spread phase 1
  const long long items = std::max<long long>(O, 1LL * n_kf * kThreads);
  return coop::launch(redundancy_values_kernel, kThreads, 0, items, 1 << 30,
                      coop::Slots::kRefuse, args, st);
}
