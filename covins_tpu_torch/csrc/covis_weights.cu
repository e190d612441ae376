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
// Bound on the H100: bytes, and in practice latency.  The COO is read
// once (a keyframe, a landmark and a mask byte an observation, 9 bytes)
// and the (Q, n_kf) int32 counts written once: at the server's snapshot
// (some 152 queries, 160 keyframes, 100,000 observations) about 1.0 MB,
// 0.0003 ms at 3.35 TB/s.  The additions (over q's landmarks, the squares
// of their observation counts) are far below any compute peak.  What sets
// the time at that size is latency: four grid barriers, two of them after a
// pass over the observations, and the dependent gathers of the walk.
//
// Design: the live observations are grouped twice, by keyframe and by
// landmark, into one array of 2 O entries, and then each query's row is
// counted from its own segment alone.  Four phases split by four grid
// barriers (two inside phase 2).
//  0. The counts (n_kf keyframes, then n_lm landmarks, then one 0) and the
//     output are zeroed in the launch.
//  1. Counts: grid-stride over the observations.  int32 atomicAdd of one
//     into the keyframe's and the landmark's count, whose old values are
//     the observation's two slots (one atomic a keyframe a warp by
//     __match_any_sync: a map appends its observations keyframe by
//     keyframe).
//  2. One exclusive scan of the n_kf + n_lm + 1 counts: each block scans
//     a slice in warp shuffles, and after a barrier every block scans the
//     slices' totals into shared memory, so that a segment starts at its
//     slice offset plus its place in the slice.  The keyframe segments
//     fill entries [0, O_live) and the landmark segments [O_live, 2
//     O_live).  Then each live observation writes its landmark at its
//     place in its keyframe's segment, with the place of its entry in its
//     landmark's segment (`pos`), and its keyframe at that place.
//  3. The queries shared out among the blocks, max(1, G / Q) blocks a
//     query, each over a share of the query's keyframe segment.  A warp
//     takes 32 entries, a landmark each, and walks their landmarks'
//     segments together, the items of the segments' concatenation dealt
//     to the lanes in turn (a map's landmarks are seen by a few keyframes
//     or by a hundred, so a thread an entry would wait on the longest),
//     adding one into the count of each observer but the query.  Where an
//     entry of the query lies before an entry's own place in its landmark's
//     segment, another of the query's observations counts that landmark
//     (the max), and the entry's adds are taken back.  The counts live in
//     shared memory (kSharedKf keyframes at most) and each block adds its
//     nonzero ones into the query's row, which phase 0 zeroed (so the
//     query's own entry stays 0); the second instance, for larger maps,
//     adds into the row in device memory.
// Values written in the launch are read through L2 (__ldcg).

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "coop_launch.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGrid = 2048;       // blocks, and slots for the slices' totals
constexpr int kSharedKf = 32768;     // keyframes a block counts in shared memory
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const int32_t* query;   // (Q,)
  const int32_t* obs_kf;  // (O,)
  const int32_t* obs_lm;  // (O,)
  const uint8_t* mask;    // (O,) live if nonzero
  int Q, O, n_kf, n_lm;
  int32_t* start;      // (n_kf + n_lm + 1,) counts, then starts within a slice
  int32_t* slice_tot;  // (kMaxGrid,)
  int32_t* slot;       // (2 O,) each observation's place in its two segments
  int32_t* ent;        // (2 O,) keyframe segments: landmarks; landmark ones: keyframes
  int32_t* pos;        // (O,) a keyframe entry's place among the landmark entries
  int32_t* out;        // (Q, n_kf)
};

// exclusive prefix of v over the block's threads in thread order, and the
// block's total; every thread calls it
__device__ int block_exclusive(int v, int* s_warp, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? s_warp[lane] : 0;
#pragma unroll
    for (int d = 1; d < kWarps; d <<= 1) {
      const int y = __shfl_up_sync(kFull, w, d);
      if (lane >= d) w += y;
    }
    if (lane < kWarps) s_warp[lane] = w;
  }
  __syncthreads();
  const int before = warp > 0 ? s_warp[warp - 1] : 0;
  *total = s_warp[kWarps - 1];
  __syncthreads();  // s_warp is written again by the next call
  return before + x - v;
}

// kShared: the counts of a query in shared memory (n_kf <= kSharedKf), else
// added into its output row in device memory
template <bool kShared>
__global__ void __launch_bounds__(kThreads) covis_weights_kernel(Args p) {
  extern __shared__ __align__(16) int s_cnt[];  // (n_kf,) when kShared
  __shared__ int s_off[kMaxGrid];               // the slices' offsets
  __shared__ int s_warp[kWarps];

  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = gridDim.x;
  const long long stride = 1LL * G * kThreads;
  const long long gtid = 1LL * blockIdx.x * kThreads + tid;
  const int n_seg = p.n_kf + p.n_lm + 1;

  // 0. the counts and the output to zero
  for (long long i = gtid; i < n_seg; i += stride) p.start[i] = 0;
  for (long long i = gtid; i < 1LL * p.Q * p.n_kf; i += stride) p.out[i] = 0;
  grid.sync();

  // 1. counts and slots; the loop is warp-uniform for __match_any_sync
  for (long long first = gtid - lane; first < p.O; first += stride) {
    const long long o = first + lane;
    int kf = -1, lm = 0;
    if (o < p.O && p.mask[o] != 0) {
      kf = p.obs_kf[o];
      lm = p.obs_lm[o];
      if (kf < 0 || kf >= p.n_kf || lm < 0 || lm >= p.n_lm) kf = -1;
    }
    const unsigned peers = __match_any_sync(kFull, kf);
    const int leader = __ffs(peers) - 1;
    int base = 0;
    if (kf >= 0 && lane == leader) base = atomicAdd(&p.start[kf], __popc(peers));
    base = __shfl_sync(kFull, base, leader);
    if (kf >= 0) {
      p.slot[2 * o] = base + __popc(peers & ((1u << lane) - 1u));
      p.slot[2 * o + 1] = atomicAdd(&p.start[p.n_kf + lm], 1);
    }
  }
  grid.sync();

  // 2. starts within each block's slice of the counts, then the slices'
  // offsets, then the two entries of each live observation
  const int slice = (n_seg + G - 1) / G;
  {
    const int k0 = min(static_cast<int>(blockIdx.x) * slice, n_seg);
    const int k1 = min(k0 + slice, n_seg);
    int carry = 0;
    for (int base = k0; base < k1; base += kThreads) {
      const int k = base + tid;
      const int c = k < k1 ? __ldcg(&p.start[k]) : 0;
      int total;
      const int ex = block_exclusive(c, s_warp, &total);
      if (k < k1) p.start[k] = carry + ex;
      carry += total;
    }
    if (tid == 0) p.slice_tot[blockIdx.x] = carry;
  }
  grid.sync();
  {
    int carry = 0;
    for (int base = 0; base < G; base += kThreads) {
      const int b = base + tid;
      const int t = b < G ? __ldcg(&p.slice_tot[b]) : 0;
      int total;
      const int ex = block_exclusive(t, s_warp, &total);
      if (b < G) s_off[b] = carry + ex;
      carry += total;
    }
  }
  __syncthreads();
  auto seg_start = [&](int k) { return __ldcg(&p.start[k]) + s_off[k / slice]; };
  for (long long o = gtid; o < p.O; o += stride) {
    if (p.mask[o] == 0) continue;
    const int kf = p.obs_kf[o], lm = p.obs_lm[o];
    if (kf < 0 || kf >= p.n_kf || lm < 0 || lm >= p.n_lm) continue;
    const int at_kf = seg_start(kf) + __ldcg(&p.slot[2 * o]);
    const int at_lm = seg_start(p.n_kf + lm) + __ldcg(&p.slot[2 * o + 1]);
    p.ent[at_kf] = lm;
    p.pos[at_kf] = at_lm;
    p.ent[at_lm] = kf;
  }
  grid.sync();

  // 3. `parts` blocks a query, each over every parts-th run of kThreads of
  // its entries, counting into shared memory (kShared) and then adding
  // its counts into the query's row, or adding into the row in place
  const int parts = max(1, G / max(p.Q, 1));
  for (long long item = blockIdx.x; item < 1LL * p.Q * parts; item += G) {
    const int q = static_cast<int>(item / parts), part = static_cast<int>(item % parts);
    const int qk = p.query[q];
    int32_t* row = p.out + 1LL * q * p.n_kf;
    int32_t* cnt = kShared ? s_cnt : row;
    if (kShared) {
      for (int k = tid; k < p.n_kf; k += kThreads) s_cnt[k] = 0;
      __syncthreads();
    }
    if (qk >= 0 && qk < p.n_kf) {
      const int e1 = seg_start(qk + 1);
      // a warp takes 32 entries at a time, one a lane, and walks their
      // landmarks' observer lists together: item t of the lists' concatenation
      // goes to lane t mod 32, so a long list costs the warp its length / 32
      for (int base = seg_start(qk) + (part * kWarps + warp) * 32; base < e1;
           base += parts * kThreads) {
        const int e = base + lane;
        int l0 = 0, len = 0, at = 0;
        if (e < e1) {
          const int lm = __ldcg(&p.ent[e]);
          at = __ldcg(&p.pos[e]);
          l0 = seg_start(p.n_kf + lm);
          len = seg_start(p.n_kf + lm + 1) - l0;
        }
        int incl = len;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const int y = __shfl_up_sync(kFull, incl, d);
          if (lane >= d) incl += y;
        }
        const int total = __shfl_sync(kFull, incl, 31);
        // one add an observer but the query; an observation of the query
        // before an entry's own place in its landmark's list counts that
        // landmark instead (the max): such entries' adds are taken back
        unsigned dup = 0;
        for (int t0 = 0; t0 < total; t0 += 32) {
          const int t = t0 + lane;
          int i = 0;  // the entry holding item t: the lanes whose lists end at or before t
#pragma unroll
          for (int step = 16; step > 0; step >>= 1) {
            if (__shfl_sync(kFull, incl, i + step - 1) <= t) i += step;
          }
          const int i_l0 = __shfl_sync(kFull, l0, i);
          const int i_start = __shfl_sync(kFull, incl - len, i);
          const int i_at = __shfl_sync(kFull, at, i);
          unsigned mine = 0;
          if (t < total) {
            const int j = i_l0 + (t - i_start);
            const int o = __ldcg(&p.ent[j]);
            if (o != qk) {
              atomicAdd(&cnt[o], 1);
            } else if (j < i_at) {
              mine = 1u << i;
            }
          }
          dup |= __reduce_or_sync(kFull, mine);
        }
        if ((dup >> lane) & 1u) {
          for (int j = l0; j < l0 + len; ++j) {
            const int o = __ldcg(&p.ent[j]);
            if (o != qk) atomicSub(&cnt[o], 1);
          }
        }
      }
    }
    if (kShared) {
      __syncthreads();
      for (int k = tid; k < p.n_kf; k += kThreads) {
        const int c = s_cnt[k];
        if (c != 0) atomicAdd(&row[k], c);
      }
      __syncthreads();  // s_cnt is zeroed again for the next item
    }
  }
}

}  // namespace

// query: (Q,) int32; obs_kf, obs_lm: (O,) int32 with 0 <= obs_kf < n_kf
// and 0 <= obs_lm < n_lm (an observation outside counts as dead); mask:
// (O,) bool; scratch: int32 of at least n_kf + n_lm + 1 + 2048 + 5 O
// entries; out: (Q, n_kf) int32.  Returns 0 or the CUDA error.
extern "C" int covins_covis_weights(const void* query, int Q, const void* obs_kf,
                                    const void* obs_lm, const void* mask, int O, int n_kf,
                                    int n_lm, void* scratch, long long scratch_len, void* out,
                                    void* stream) {
  if (Q <= 0 || n_kf <= 0) return 0;
  if (O < 0 || n_lm <= 0 || O > (1 << 29)) return static_cast<int>(cudaErrorInvalidValue);
  const long long n_seg = 1LL * n_kf + n_lm + 1;
  if (n_seg > (1LL << 30) || scratch_len < n_seg + kMaxGrid + 5LL * O)
    return static_cast<int>(cudaErrorInvalidValue);
  int32_t* w = static_cast<int32_t*>(scratch);
  Args p;
  p.query = static_cast<const int32_t*>(query);
  p.obs_kf = static_cast<const int32_t*>(obs_kf);
  p.obs_lm = static_cast<const int32_t*>(obs_lm);
  p.mask = static_cast<const uint8_t*>(mask);
  p.Q = Q;
  p.O = O;
  p.n_kf = n_kf;
  p.n_lm = n_lm;
  p.start = w;
  w += n_seg;
  p.slice_tot = w;
  w += kMaxGrid;
  p.slot = w;
  w += 2LL * O;
  p.ent = w;
  w += 2LL * O;
  p.pos = w;
  p.out = static_cast<int32_t*>(out);
  void* args[] = {&p};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool shared = n_kf <= kSharedKf;
  const auto kernel = shared ? covis_weights_kernel<true> : covis_weights_kernel<false>;
  const void* fn = reinterpret_cast<const void*>(kernel);
  const size_t smem = shared ? 4ull * n_kf : 0;
  int room = 0, resident = 0;
  cudaError_t err = coop::smem_room(fn, &room);
  if (err == cudaSuccess) err = coop::co_resident(fn, kThreads, smem, &resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (static_cast<size_t>(room) < smem) return static_cast<int>(cudaErrorInvalidConfiguration);
  // half the blocks the card holds at once: phase 3 shares the queries
  // among them, and on the H100 grid barriers over every block cost more
  // than the second half gives, at the server's snapshot as at 1,024
  // queries
  const long long items = 1LL * kThreads * std::max(1, resident / 2);
  return coop::launch(kernel, kThreads, smem, items, kMaxGrid, coop::Slots::kCap, args, st);
}
