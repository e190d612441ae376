// K17: the covisibility counts of a batch of query keyframes, in one
// cooperative launch.
//
// Replaces: covins_tpu/ops/covisibility.py::covis_weights_batch (line 45,
// the jax.vmap of :25 covis_weights_for).  For query keyframe q and every
// keyframe k, out[q][k] counts k's live observations of the landmarks that
// q observes live: `seen` is a scatter-max, so a landmark q sees twice
// counts once on q's side, while a keyframe that observes a landmark twice
// counts twice; out[q][q] is 0.  The counts are integers, exact in any
// order, so the kernel agrees bit for bit with its plain version
// (ops/covisibility.py::covis_weights_batch_plain) whatever order its
// atomics take.
//
// Bound on the H100: bytes.  The COO is read once (a keyframe, a landmark
// and a mask byte an observation, 9 bytes) and the (Q, n_kf) int32 counts
// written once: at the server's snapshot (some 152 queries, 160 keyframes,
// 100,000 observations) about 1.0 MB, 0.0003 ms at 3.35 TB/s.  The
// additions are far below any compute peak.  What sets the time is
// latency and atomics: the launch and two grid barriers (the launch with
// no observation takes some 0.007 ms at the server's shape), the mark's
// atomicOr an observation of a queried keyframe, the count's atomicAdd a
// (query, keyframe) a warp; at a long session's 1,024 queries also the
// bitmap's zeroing (n_lm x 132 bytes).  Observations in random order add
// bit by bit, one atomicAdd a bit.
//
// Design: a query bitmap, with no grouping of the observations and one
// instance for any map.  The queries are taken 1,024 at a time (a pass:
// W = ceil(Q / 32) bitmap words, at most 32 a pass, `ws` words a row); a
// pass is three phases between two grid barriers:
//  0. The output (first pass only), the bitmap `seen` (n_lm x ws words: bit
//     b of word w of landmark l says query 32 w + b of the pass sees l) and
//     `lmw` (bit w: seen[l][w] is nonzero) zeroed; the table `kfq` (n_kf x
//     ws: bit b of word w of keyframe k says query 32 w + b is k; repeated
//     queries set several bits) and `kfw` (its nonzero words), each word
//     written whole from one warp ballot over the pass's queries, which
//     each block holds in shared memory, a warp a keyframe.
//  1. Mark: each live observation (k, l) of a queried keyframe ORs k's
//     nonzero words into l's (atomicOr): a bit is set however often the
//     query sees l, which is the max.  The observation that finds a word
//     still 0 sets its bit in lmw.
//  2. Count: each live observation (k, l) adds one to out[q][k] for each
//     bit q of seen[l][w] & ~kfq[k][w] (the query's own entry stays 0),
//     over the nonzero words of l alone, kBatch words' loads at once.  A
//     warp whose lanes share a keyframe (a map appends its observations
//     keyframe by keyframe, so most warps hold one or two) sums each bit
//     over its lanes at once: the 32 x 32 bit matrix of the lanes' words
//     is transposed in five shuffles, so that lane b holds bit b of every
//     lane, and adds its popcount into query b's count, one add a (query,
//     keyframe) a warp; a warp of more than kMaxGroups keyframes adds bit
//     by bit.  Each block takes one range of the observations, and the
//     counts of the kWindow keyframes from the range's first gather in
//     shared memory and go into the output once a block; other keyframes'
//     counts go straight into the output in device memory.
// A pass after the first begins behind a third barrier, once the last
// count has read the bitmap.  The work is W words an observation whatever
// its landmark's observer list, and nothing is taken back.  The grid is
// at most every block the card holds at once (half of them measured
// slower; scripts/port_k17_phases.py times this and other variants).
// Values written in the launch are read through L2 (__ldcg).

#include <cooperative_groups.h>
#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

#include "coop_launch.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kPassWords = 32;  // bitmap words a pass: 1,024 queries
constexpr int kMaxGroups = 4;   // keyframes a warp sums by transposes
constexpr int kWindow = 4;      // keyframes a block counts in shared memory
constexpr int kBatch = 4;       // bitmap words a lane loads at once
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const int32_t* query;   // (Q,)
  const int32_t* obs_kf;  // (O,)
  const int32_t* obs_lm;  // (O,)
  const uint8_t* mask;    // (O,) live if nonzero
  int Q, O, n_kf, n_lm;
  int ws;          // words of a bitmap row: min(ceil(Q / 32), kPassWords)
  uint32_t* seen;  // (n_lm, ws) which of the pass's queries see each landmark
  uint32_t* lmw;   // (n_lm,) the nonzero words of seen, right behind it
  uint32_t* kfq;   // (n_kf, ws) which of the pass's queries are each keyframe
  uint32_t* kfw;   // (n_kf,) the nonzero words of kfq
  int32_t* out;    // (Q, n_kf)
};

// n words from a (16-byte aligned) to zero, 16 bytes a store
__device__ void zero_words(uint32_t* a, long long n, long long gtid, long long stride) {
  uint4* a4 = reinterpret_cast<uint4*>(a);
  for (long long i = gtid; i < n / 4; i += stride) a4[i] = make_uint4(0u, 0u, 0u, 0u);
  for (long long i = (n / 4) * 4 + gtid; i < n; i += stride) a[i] = 0u;
}

// lane b gets the number of lanes whose x has bit b set: the 32 x 32 bit
// matrix of the lanes' words transposed (its blocks of 16, 8, 4, 2 and 1
// swapped across the diagonal, a shuffle each), then counted
__device__ __forceinline__ int column_counts(unsigned x, int lane) {
  const unsigned masks[5] = {0x0000ffffu, 0x00ff00ffu, 0x0f0f0f0fu, 0x33333333u, 0x55555555u};
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const int s = 16 >> i;
    const unsigned m = masks[i];
    const unsigned y = __shfl_xor_sync(kFull, x, s);
    x = (lane & s) ? (x & ~m) | ((y & ~m) >> s) : (x & m) | ((y & m) << s);
  }
  return __popc(x);
}

// observation o's keyframe and landmark, if it is live and inside the map
__device__ __forceinline__ bool live_obs(const Args& p, long long o, int* kf, int* lm) {
  if (o >= p.O || p.mask[o] == 0) return false;
  const int k = p.obs_kf[o], l = p.obs_lm[o];
  if (k < 0 || k >= p.n_kf || l < 0 || l >= p.n_lm) return false;
  *kf = k;
  *lm = l;
  return true;
}

__global__ void __launch_bounds__(kThreads) covis_weights_kernel(Args p) {
  __shared__ int s_cnt[kWindow * 32 * kPassWords];  // (keyframe - base, query)
  __shared__ int s_q[32 * kPassWords];              // the pass's queries
  cg::grid_group grid = cg::this_grid();
  const int lane = threadIdx.x & 31;
  const long long stride = 1LL * gridDim.x * kThreads;
  const long long gtid = 1LL * blockIdx.x * kThreads + threadIdx.x;
  const long long n_warps = stride / 32, gwarp = gtid / 32;
  const int ws = p.ws;

  zero_words(reinterpret_cast<uint32_t*>(p.out), 1LL * p.Q * p.n_kf, gtid, stride);
  for (int q0 = 0; q0 < p.Q; q0 += 32 * kPassWords) {
    const int wp = min(ws, (p.Q - q0 + 31) / 32);  // the pass's words
    if (q0 > 0) grid.sync();  // the last pass's count has read the bitmap

    // 0. the bitmap zeroed; the keyframes' table, a warp a keyframe, from
    // the pass's queries in shared memory
    zero_words(p.seen, 1LL * p.n_lm * (ws + 1), gtid, stride);  // and lmw, behind it
    for (int i = threadIdx.x; i < 32 * wp; i += kThreads)
      s_q[i] = q0 + i < p.Q ? p.query[q0 + i] : -1;
    __syncthreads();
    for (long long k = gwarp; k < p.n_kf; k += n_warps) {
      unsigned mine = 0, nonzero = 0;
      for (int w = 0; w < wp; ++w) {
        const unsigned word = __ballot_sync(kFull, s_q[32 * w + lane] == k);
        if (lane == w) mine = word;
        if (word != 0u) nonzero |= 1u << w;
      }
      if (lane < ws) p.kfq[k * ws + lane] = mine;
      if (lane == 0) p.kfw[k] = nonzero;
    }
    grid.sync();

    // 1. mark: the queries that see each landmark; the first to mark a
    // word marks it in lmw
    for (long long o = gtid; o < p.O; o += stride) {
      int kf, lm;
      if (!live_obs(p, o, &kf, &lm)) continue;
      for (unsigned kw = __ldcg(&p.kfw[kf]); kw != 0u; kw &= kw - 1u) {
        const int w = __ffs(kw) - 1;
        if (atomicOr(&p.seen[1LL * lm * ws + w], __ldcg(&p.kfq[1LL * kf * ws + w])) == 0u)
          atomicOr(&p.lmw[lm], 1u << w);
      }
    }
    grid.sync();

    // 2. count, each block over its own range of observations, in whole
    // warps: the counts of the keyframes in [base, base + kWindow), base
    // the range's first keyframe, gather in shared memory and go into the
    // output once a block; any other keyframe's go straight into it
    const int n_q = 32 * wp;
    for (int i = threadIdx.x; i < kWindow * n_q; i += kThreads) s_cnt[i] = 0;
    const long long share = ((p.O + gridDim.x - 1) / gridDim.x + 31) / 32 * 32;
    const long long o_begin = blockIdx.x * share, o_end = min(1LL * p.O, o_begin + share);
    const int base = o_begin < o_end ? min(max(p.obs_kf[o_begin], 0), p.n_kf - 1) : 0;
    __syncthreads();
    auto add = [&](int k, int w, int b, int c) {
      if (k - base >= 0 && k - base < kWindow)
        atomicAdd(&s_cnt[(k - base) * n_q + 32 * w + b], c);
      else
        atomicAdd(&p.out[1LL * (q0 + 32 * w + b) * p.n_kf + k], c);
    };
    // the loop is warp-uniform for the shuffles
    for (long long first = o_begin + (threadIdx.x - lane); first < o_end; first += kThreads) {
      int kf = -1, lm = 0;
      unsigned lw = 0;
      if (first + lane < o_end && live_obs(p, first + lane, &kf, &lm)) lw = __ldcg(&p.lmw[lm]);
      const unsigned words = __reduce_or_sync(kFull, lw);
      if (words == 0u) continue;
      if (lw == 0u) kf = -1;
      // the warp's keyframes, by their first lane
      const unsigned peers = __match_any_sync(kFull, kf);
      const unsigned leaders = __ballot_sync(kFull, kf >= 0 && lane == __ffs(peers) - 1);
      const bool by_groups = __popc(leaders) <= kMaxGroups;
      // kBatch words at a time, their loads issued together
      for (int w0 = 0; w0 < ws; w0 += kBatch) {
        if (((words >> w0) & ((1u << kBatch) - 1u)) == 0u) continue;
        unsigned x[kBatch];
#pragma unroll
        for (int i = 0; i < kBatch; ++i) {
          const int w = w0 + i;
          x[i] = w < ws && ((lw >> w) & 1u)
                     ? __ldcg(&p.seen[1LL * lm * ws + w]) & ~__ldcg(&p.kfq[1LL * kf * ws + w])
                     : 0u;
        }
#pragma unroll
        for (int i = 0; i < kBatch; ++i) {
          const int w = w0 + i;
          if (((words >> w) & 1u) == 0u) continue;
          if (by_groups) {
            for (unsigned g = leaders; g != 0u; g &= g - 1u) {
              const int gk = __shfl_sync(kFull, kf, __ffs(g) - 1);
              const unsigned y = kf == gk ? x[i] : 0u;
              if (!__any_sync(kFull, y != 0u)) continue;
              const int c = column_counts(y, lane);
              if (c != 0) add(gk, w, lane, c);
            }
          } else {
            for (unsigned y = x[i]; y != 0u; y &= y - 1u) add(kf, w, __ffs(y) - 1, 1);
          }
        }
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kWindow * n_q; i += kThreads) {
      const int c = s_cnt[i];
      if (c != 0) atomicAdd(&p.out[1LL * (q0 + i % n_q) * p.n_kf + base + i / n_q], c);
    }
  }
}

}  // namespace

// query: (Q,) int32; obs_kf, obs_lm: (O,) int32 with 0 <= obs_kf < n_kf
// and 0 <= obs_lm < n_lm (an observation outside counts as dead); mask:
// (O,) bool; scratch: 16-byte aligned, at least (n_lm + n_kf) (ws + 1)
// words, ws = min(ceil(Q / 32), 32); out: (Q, n_kf) int32, 16-byte
// aligned.  Returns 0 or the CUDA error.
extern "C" int covins_covis_weights(const void* query, int Q, const void* obs_kf,
                                    const void* obs_lm, const void* mask, int O, int n_kf,
                                    int n_lm, void* scratch, long long scratch_len, void* out,
                                    void* stream) {
  if (Q <= 0 || n_kf <= 0) return 0;
  if (O < 0 || n_lm <= 0 || O > (1 << 29) || 1LL * n_kf + n_lm >= (1LL << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  const int ws = std::min((Q + 31) / 32, kPassWords);
  if (scratch_len < (1LL * n_lm + n_kf) * (ws + 1) ||
      (reinterpret_cast<uintptr_t>(scratch) | reinterpret_cast<uintptr_t>(out)) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  uint32_t* w = static_cast<uint32_t*>(scratch);
  Args p;
  p.query = static_cast<const int32_t*>(query);
  p.obs_kf = static_cast<const int32_t*>(obs_kf);
  p.obs_lm = static_cast<const int32_t*>(obs_lm);
  p.mask = static_cast<const uint8_t*>(mask);
  p.Q = Q;
  p.O = O;
  p.n_kf = n_kf;
  p.n_lm = n_lm;
  p.ws = ws;
  p.seen = w;  // first, and lmw right behind it: both zeroed by 16-byte stores
  w += 1LL * n_lm * ws;
  p.lmw = w;
  w += n_lm;
  p.kfq = w;
  w += 1LL * n_kf * ws;
  p.kfw = w;
  p.out = static_cast<int32_t*>(out);
  void* args[] = {&p};
  // threads for the longest grid-stride loop; coop::launch cuts the grid
  // to the blocks the card holds at once
  const long long items = std::max({1LL * O, 1LL * n_lm * ws / 4, 1LL * Q * n_kf / 4,
                                    32LL * n_kf, 1LL});
  return coop::launch(covis_weights_kernel, kThreads, 0, items, 1 << 30, coop::Slots::kRefuse,
                      args, static_cast<cudaStream_t>(stream));
}
