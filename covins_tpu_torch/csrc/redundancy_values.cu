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
// mask (12 bytes) are read once and n_kf floats written; the arithmetic
// is a few operations an observation.  At prunemap's 101,712 observations
// and 160 keyframes that is 1.22 MB, 0.000365 ms at 3.35 TB/s.  What
// holds the kernel above it is the order: each keyframe's two sums are
// dependent chains of float32 adds (about 5 cycles an observation), and
// the partition by keyframe needs grid barriers.
//
// Design: the observations are partitioned by keyframe, then each
// keyframe's sums are taken over its own segment; four phases split by
// three grid barriers (four when n_kf > kLocalKf).
//  0. The counters are zeroed (in the launch: a memset before it costs
//     more than a barrier).
//  1. Counts: grid-stride over the observations, kUnroll at a time.
//     int32 atomicAdd of the truncated mask into the landmark's count, and
//     of one into the keyframe's count, whose old value is the
//     observation's slot (one atomic a keyframe a warp, __match_any_sync).
//     Up to kLocalKf keyframes a block counts in shared memory and then
//     takes its base in each keyframe's segment with one global atomic.
//     Exact in any order.
//  2. Segment starts, an exclusive scan of the keyframe counts in warp
//     shuffles.  Up to kLocalKf keyframes every block scans them all into
//     shared memory; beyond, each block scans its slice of keyframes,
//     lists those of 2..kWarpMax observations and those of more, and after
//     a grid barrier every block scans the slices' totals.  Then each
//     observation's (score x mask, mask) goes to scratch (__fmul_rn) and
//     its index to its segment at its slot.
//  3. Ordered sums.  A thread takes a keyframe of at most one
//     observation.  A warp takes one of at most kWarpMax: each lane ranks
//     its index among the warp's by shuffles, and lane 0 adds the pairs in
//     rank order.  A block takes each larger one.  Its segment's indices (in
//     the atomics' order) are ranked without a sort: each sets its bit in
//     a shared bitmap of kBits consecutive indices, a scan of the words'
//     popcounts gives each word's first rank, and an index's rank is that
//     plus the popcount of the bits below it.  Each (score, mask) pair goes
//     to its rank in shared memory, and one thread adds the two sums as two
//     interleaved chains in registers (__fadd_rn, from +0.0; the pairs are
//     padded with +0.0, which leaves a sum that is not -0.0 unchanged).  A
//     segment of more than kCap indices, or wider than the bitmap, is taken
//     in windows of kCap consecutive indices: the block buckets its indices
//     by window into the segment's span of the slot scratch (a shared
//     histogram, kCap windows at a time), then ranks and adds runs of
//     consecutive windows holding at most kCap indices within kBits.  The
//     values are tot / (cnt < 1 ? 1 : cnt) (__fdiv_rn; a NaN count stays
//     NaN, as jnp.maximum keeps it).
// The first design (a block a range of keyframes) read every observation
// in every block, formed each chunk's prefix in one thread and added in
// shared memory: here the prefixes are shuffles, the running sums live in
// registers, and a block reads only its keyframe's segment, ranked by a
// bitmap rather than sorted.  Values written in the launch are read
// through L2 (__ldcg).

#include <climits>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "coop_launch.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;                // indices a thread holds in a block's run
constexpr int kCap = kThreads * kItems;  // indices a block ranks at once
constexpr int kBits = 1 << 17;           // the rank bitmap's width in indices
constexpr int kWords = kBits / 32;
constexpr int kWordsPer = kWords / kThreads;
constexpr int kUnroll = 4;               // observations a thread loads at once; the
                                         // grid is sized for one such batch a thread
constexpr int kWarpMax = 32;             // segments one warp sums
constexpr int kLocalKf = 4096;           // keyframes a block counts and scans itself
constexpr int kMaxGrid = 2048;           // blocks, and slots for the slices' totals
constexpr unsigned kFull = 0xffffffffu;
static_assert(2 * kCap >= kLocalKf, "the block's counts live in the pairs' space");
static_assert(kMaxGrid <= kLocalKf + 1, "the slices' offsets live in the starts' space");

// dynamic shared memory, in bytes
constexpr int kVmOff = 0;                              // kCap (score, mask) pairs
constexpr int kBitsOff = kVmOff + 8 * kCap;            // kWords bitmap words
constexpr int kPreOff = kBitsOff + 4 * kWords;         // kWords first ranks
constexpr int kHistOff = kPreOff + 4 * kWords;         // kCap window counts
constexpr int kStartOff = kHistOff + 4 * kCap;         // kLocalKf + 1 segment starts
constexpr int kSmem = kStartOff + 4 * (kLocalKf + 1);

__constant__ float kTable[7] = {0.0f, 0.0f, 0.0f, 0.4f, 0.7f, 0.9f, 1.0f};

struct Args {
  const int32_t* obs_kf;  // (O,)
  const int32_t* obs_lm;  // (O,)
  const float* mask;      // (O,)
  int O, n_kf, n_lm;
  float2* vm;          // (O,) score x mask, mask
  int32_t* lm_count;   // (n_lm,)
  int32_t* kf_count;   // (n_kf,), after lm_count
  int32_t* n_listed;   // (2,), after kf_count: the two ends' lengths in `listed`
  int32_t* kf_local;   // (n_kf,) segment start within the slice
  int32_t* slice_tot;  // (kMaxGrid,)
  int32_t* listed;     // (n_kf,) keyframes of 2..kWarpMax observations from the
                       // front, of more from the back
  int32_t* slot;       // (O,) each observation's place in its segment
  int32_t* perm;       // (O,) observation indices by segment
  float* out;          // (n_kf,)
};

struct Shared {
  float2* vm;
  unsigned* bits;
  int* pre;
  int* hist;
  int* start;
  int* warp;  // 2 kWarps
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

// the block's least and greatest of each thread's (mn, mx)
__device__ __forceinline__ void block_min_max(int& mn, int& mx, int* s_warp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    mn = min(mn, __shfl_xor_sync(kFull, mn, d));
    mx = max(mx, __shfl_xor_sync(kFull, mx, d));
  }
  __syncthreads();  // s_warp's last readers are done
  if (lane == 0) {
    s_warp[warp] = mn;
    s_warp[kWarps + warp] = mx;
  }
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    mn = min(mn, s_warp[w]);
    mx = max(mx, s_warp[kWarps + w]);
  }
}

// adds, in ascending order, the (score, mask) pairs of the block's n <=
// kCap observation indices v (kItems a thread, -1 where none), all in
// [lo, lo + kBits), to thread 0's running sums; every thread calls it
__device__ __forceinline__ void add_run(const int (&v)[kItems], int n, int lo, const float2* vm,
                                        const Shared& s, float& tot, float& cnt) {
  const int tid = threadIdx.x;
  float2 pair[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j)
    pair[j] = v[j] >= 0 ? __ldcg(&vm[v[j]]) : make_float2(0.0f, 0.0f);
  __syncthreads();  // thread 0 is done with s.vm, every thread with s.bits and s.pre
  for (int i = 4 * tid; i < kWords; i += 4 * kThreads)
    *reinterpret_cast<uint4*>(s.bits + i) = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (v[j] >= 0) {
      const int d = v[j] - lo;
      atomicOr(&s.bits[d >> 5], 1u << (d & 31));
    }
  }
  __syncthreads();
  int pc[kWordsPer], sum = 0;
#pragma unroll
  for (int i = 0; i < kWordsPer; ++i) {
    pc[i] = __popc(s.bits[tid * kWordsPer + i]);
    sum += pc[i];
  }
  int total;
  int ex = block_exclusive(sum, s.warp, &total);
#pragma unroll
  for (int i = 0; i < kWordsPer; ++i) {
    s.pre[tid * kWordsPer + i] = ex;
    ex += pc[i];
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (v[j] >= 0) {
      const int d = v[j] - lo, w = d >> 5;
      const int r = s.pre[w] + __popc(s.bits[w] & ((1u << (d & 31)) - 1u));
      s.vm[r] = pair[j];
    }
  }
  const int n16 = (n + 15) & ~15;
  for (int e = n + tid; e < n16; e += kThreads) s.vm[e] = make_float2(0.0f, 0.0f);
  __syncthreads();
  if (tid != 0) return;
  const float4* q = reinterpret_cast<const float4*>(s.vm);  // two pairs each
  for (int i = 0; i < n16; i += 16) {
    float4 b[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) b[j] = q[i / 2 + j];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      tot = __fadd_rn(tot, b[j].x);
      cnt = __fadd_rn(cnt, b[j].y);
      tot = __fadd_rn(tot, b[j].z);
      cnt = __fadd_rn(cnt, b[j].w);
    }
  }
}

__device__ __forceinline__ float quotient(float tot, float cnt) {
  return __fdiv_rn(tot, cnt < 1.0f ? 1.0f : cnt);
}

__global__ void __launch_bounds__(kThreads) redundancy_values_kernel(Args p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_warp[2 * kWarps];
  __shared__ int s_n;
  const Shared sh{reinterpret_cast<float2*>(smem + kVmOff),
                  reinterpret_cast<unsigned*>(smem + kBitsOff),
                  reinterpret_cast<int*>(smem + kPreOff), reinterpret_cast<int*>(smem + kHistOff),
                  reinterpret_cast<int*>(smem + kStartOff), s_warp};
  int* s_cnt = reinterpret_cast<int*>(sh.vm);  // phases 1-2: the block's counts, then bases

  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x, lane = tid & 31;
  const unsigned lt = (1u << lane) - 1u;
  const int G = gridDim.x;
  const long long stride = 1LL * G * kThreads;
  const long long gtid = 1LL * blockIdx.x * kThreads + tid;
  const bool local = p.n_kf <= kLocalKf;

  // 0. the counters to zero, the block's own too; thread gtid's first
  // observations (gtid + m * stride, kUnroll at a time) load meanwhile
  int okf[kUnroll], olm[kUnroll], ow[kUnroll];
  auto load_counted = [&](long long first) {  // first: the warp's first
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long o = first + u * stride + lane;
      const bool in = o < p.O;
      okf[u] = in ? p.obs_kf[o] : -1;
      olm[u] = in ? p.obs_lm[o] : 0;
      ow[u] = in ? __float2int_rz(p.mask[o]) : 0;
    }
  };
  const long long warp_first = gtid - lane;
  load_counted(warp_first);
  for (long long i = gtid; i < p.n_lm + 1LL * p.n_kf + 2; i += stride) p.lm_count[i] = 0;
  if (local) {
    for (int k = tid; k < p.n_kf; k += kThreads) s_cnt[k] = 0;
  }
  grid.sync();

  // 1. counts, and each observation's slot (within the block's share of
  // its keyframe's segment where `local`)
  int* counts = local ? s_cnt : p.kf_count;
  for (long long first = warp_first; first < p.O; first += kUnroll * stride) {
    if (first != warp_first) load_counted(first);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (ow[u] != 0) atomicAdd(&p.lm_count[olm[u]], ow[u]);
      const unsigned peers = __match_any_sync(kFull, okf[u]);
      const int leader = __ffs(peers) - 1;
      int base = 0;
      if (okf[u] >= 0 && lane == leader) base = atomicAdd(&counts[okf[u]], __popc(peers));
      base = __shfl_sync(kFull, base, leader);
      if (okf[u] >= 0) p.slot[first + u * stride + lane] = base + __popc(peers & lt);
    }
  }
  if (local) {
    __syncthreads();
    for (int k = tid; k < p.n_kf; k += kThreads) {
      const int c = s_cnt[k];
      if (c != 0) s_cnt[k] = atomicAdd(&p.kf_count[k], c);
    }
  }
  grid.sync();

  // 2. segment starts, then the observations' pairs and places.  The
  // first batch of each thread's observations is loaded before the scan,
  // whose latency it shares.
  int kf[kUnroll], at[kUnroll];
  float2 pair[kUnroll];
  auto load_placed = [&](long long first) {
    int lm[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long o = first + u * stride;
      const bool in = o < p.O;
      kf[u] = in ? p.obs_kf[o] : 0;
      lm[u] = in ? p.obs_lm[o] : 0;
      pair[u].y = in ? p.mask[o] : 0.0f;
      at[u] = in ? __ldcg(&p.slot[o]) : 0;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int c = first + u * stride < p.O ? __ldcg(&p.lm_count[lm[u]]) : 0;
      pair[u].x = __fmul_rn(kTable[c < 0 ? 0 : (c > 6 ? 6 : c)], pair[u].y);
    }
  };
  int slice = 1;
  if (local) {
    constexpr int kPer = kLocalKf / kThreads;
    const int kb = tid * kPer;
    int c[kPer], sum = 0;
#pragma unroll
    for (int j = 0; j < kPer; ++j) c[j] = kb + j < p.n_kf ? __ldcg(&p.kf_count[kb + j]) : 0;
    load_placed(gtid);
#pragma unroll
    for (int j = 0; j < kPer; ++j) sum += c[j];
    int total;
    int ex = block_exclusive(sum, s_warp, &total);
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      if (kb + j < p.n_kf) sh.start[kb + j] = ex;
      ex += c[j];
    }
    if (tid == 0) sh.start[p.n_kf] = total;
  } else {
    load_placed(gtid);
    slice = (p.n_kf + G - 1) / G;
    const int k0 = static_cast<int>(min(1LL * blockIdx.x * slice, 1LL * p.n_kf));
    const int k1 = static_cast<int>(min(1LL * k0 + slice, 1LL * p.n_kf));
    int carry = 0;
    for (int base = k0; base < k1; base += kThreads) {
      const int k = base + tid;
      const int c = k < k1 ? __ldcg(&p.kf_count[k]) : 0;
      int total;
      const int ex = block_exclusive(c, s_warp, &total);
      if (k < k1) {
        p.kf_local[k] = carry + ex;
        if (c > kWarpMax) p.listed[p.n_kf - 1 - atomicAdd(&p.n_listed[1], 1)] = k;
        else if (c > 1) p.listed[atomicAdd(&p.n_listed[0], 1)] = k;
      }
      carry += total;
    }
    if (tid == 0) p.slice_tot[blockIdx.x] = carry;
    grid.sync();
    carry = 0;
    for (int base = 0; base < G; base += kThreads) {
      const int b = base + tid;
      const int t = b < G ? __ldcg(&p.slice_tot[b]) : 0;
      int total;
      const int ex = block_exclusive(t, s_warp, &total);
      if (b < G) sh.start[b] = carry + ex;
      carry += total;
    }
  }
  __syncthreads();
  auto seg_start = [&](int k) {
    return local ? sh.start[k] : __ldcg(&p.kf_local[k]) + sh.start[k / slice];
  };
  auto seg_count = [&](int k) {
    return local ? sh.start[k + 1] - sh.start[k] : __ldcg(&p.kf_count[k]);
  };
  for (long long first = gtid; first < p.O; first += kUnroll * stride) {
    if (first != gtid) load_placed(first);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long o = first + u * stride;
      if (o < p.O) {
        p.vm[o] = pair[u];
        p.perm[seg_start(kf[u]) + (local ? s_cnt[kf[u]] : 0) + at[u]] = static_cast<int>(o);
      }
    }
  }
  grid.sync();

  // 3a. a thread a keyframe of at most one observation
  for (long long kk = gtid; kk < p.n_kf; kk += stride) {
    const int k = static_cast<int>(kk);
    const int c = seg_count(k);
    if (c > 1) continue;
    float tot = 0.0f, cnt = 0.0f;
    if (c == 1) {
      const float2 e = __ldcg(&p.vm[__ldcg(&p.perm[seg_start(k)])]);
      tot = __fadd_rn(tot, e.x);
      cnt = __fadd_rn(cnt, e.y);
    }
    p.out[k] = quotient(tot, cnt);
  }

  // 3b. a warp a keyframe of 2..kWarpMax observations: each lane ranks its
  // index among the warp's by shuffles and puts its pair at its rank in the
  // warp's part of sh.vm, and lane 0 adds them
  {
    const int warps = G * kWarps, gw = blockIdx.x * kWarps + (tid >> 5);
    const int n_mid = local ? p.n_kf : __ldcg(&p.n_listed[0]);
    float2* buf = sh.vm + (tid >> 5) * 32;
    for (int i = gw; i < n_mid; i += warps) {
      const int k = local ? i : __ldcg(&p.listed[i]);
      const int c = seg_count(k);
      if (c < 2 || c > kWarpMax) continue;
      const int o = lane < c ? __ldcg(&p.perm[seg_start(k) + lane]) : INT_MAX;
      const float2 pr = lane < c ? __ldcg(&p.vm[o]) : make_float2(0.0f, 0.0f);
      int rank = 0;
#pragma unroll
      for (int j = 0; j < 32; ++j) rank += __shfl_sync(kFull, o, j) < o;
      if (lane < c) buf[rank] = pr;
      __syncwarp();
      if (lane == 0) {
        float tot = 0.0f, cnt = 0.0f;
        for (int r = 0; r < c; ++r) {
          tot = __fadd_rn(tot, buf[r].x);
          cnt = __fadd_rn(cnt, buf[r].y);
        }
        p.out[k] = quotient(tot, cnt);
      }
      __syncwarp();
    }
  }

  // 3c. a block a keyframe of more than kWarpMax observations
  const int n_big = local ? p.n_kf : __ldcg(&p.n_listed[1]);
  const int e0 = tid * kItems;
  for (int bi = blockIdx.x; bi < n_big; bi += G) {
    const int k = local ? bi : __ldcg(&p.listed[p.n_kf - 1 - bi]);
    const int c = seg_count(k);
    if (c <= kWarpMax) continue;
    const int s = seg_start(k);
    float tot = 0.0f, cnt = 0.0f;  // thread 0's
    int v[kItems];
    bool done = false;
    if (c <= kCap) {
      int mn = INT_MAX, mx = -1;
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        v[j] = e0 + j < c ? __ldcg(&p.perm[s + e0 + j]) : -1;
        if (v[j] >= 0) mn = min(mn, v[j]), mx = max(mx, v[j]);
      }
      block_min_max(mn, mx, s_warp);
      if (mx - mn < kBits) {
        add_run(v, c, mn, p.vm, sh, tot, cnt);
        done = true;
      }
    }
    if (!done) {
      // windows of kCap consecutive indices, kCap windows a group: bucket
      // the segment by window into its span of `slot` (sh.hist[w] the start
      // of window w, then, after the scatter, its end), then add runs of
      // consecutive windows of at most kCap indices within kBits
      int* buf = p.slot + s;
      const int n_groups = static_cast<int>((p.O + 1LL * kCap * kCap - 1) / (1LL * kCap * kCap));
      for (int g = 0; g < n_groups; ++g) {
        __syncthreads();
        for (int w = tid; w < kCap; w += kThreads) sh.hist[w] = 0;
        __syncthreads();
        for (int pass = 0; pass < 2; ++pass) {
          for (int base = 0; base < c; base += kCap) {
#pragma unroll
            for (int j = 0; j < kItems; ++j) {
              const int i = base + j * kThreads + tid;
              v[j] = i < c ? __ldcg(&p.perm[s + i]) : -1;
            }
#pragma unroll
            for (int j = 0; j < kItems; ++j) {
              const int w = v[j] < 0 ? -1 : v[j] / kCap - g * kCap;
              const int win = w >= 0 && w < kCap ? w : -1;
              const unsigned peers = __match_any_sync(kFull, win);
              const int leader = __ffs(peers) - 1;
              int at = 0;
              if (win >= 0 && lane == leader) at = atomicAdd(&sh.hist[win], __popc(peers));
              at = __shfl_sync(kFull, at, leader);
              if (pass == 1 && win >= 0) buf[at + __popc(peers & lt)] = v[j];
            }
          }
          __syncthreads();
          if (pass == 0) {
            int h[kItems], sum = 0;
#pragma unroll
            for (int j = 0; j < kItems; ++j) {
              h[j] = sh.hist[e0 + j];
              sum += h[j];
            }
            int total;
            int ex = block_exclusive(sum, s_warp, &total);
#pragma unroll
            for (int j = 0; j < kItems; ++j) {
              sh.hist[e0 + j] = ex;
              ex += h[j];
            }
            __syncthreads();
          }
        }
        const int group_total = sh.hist[kCap - 1];
        for (int w0 = 0, b0 = 0; b0 < group_total;) {
          if (tid == 0) {
            // the first window that holds an index past b0, and the last
            // one after it whose end is within kCap of b0 and within kBits
            int lo = w0, hi = kCap - 1;
            while (lo < hi) {
              const int mid = (lo + hi) >> 1;
              if (sh.hist[mid] > b0) hi = mid;
              else lo = mid + 1;
            }
            s_warp[0] = lo;
            hi = min(kCap - 1, lo + kBits / kCap - 1);
            while (lo < hi) {
              const int mid = (lo + hi + 1) >> 1;
              if (sh.hist[mid] - b0 <= kCap) lo = mid;
              else hi = mid - 1;
            }
            s_n = lo;
          }
          __syncthreads();
          const int first = s_warp[0], last = s_n;
          const int n = sh.hist[last] - b0;
#pragma unroll
          for (int j = 0; j < kItems; ++j) v[j] = e0 + j < n ? __ldcg(&buf[b0 + e0 + j]) : -1;
          add_run(v, n, static_cast<int>((1LL * g * kCap + first) * kCap), p.vm, sh, tot, cnt);
          b0 += n;
          w0 = last + 1;
        }
      }
    }
    if (tid == 0) p.out[k] = quotient(tot, cnt);
  }
}

}  // namespace

// obs_kf, obs_lm: (O,) int32 with 0 <= obs_kf < n_kf, 0 <= obs_lm < n_lm;
// mask: (O,) float32; scratch: int32 of at least
// 4 O + n_lm + 3 n_kf + 2 + 2048 entries, 8-byte aligned; out: (n_kf,)
// float32.  Returns 0 or the CUDA error.
extern "C" int covins_redundancy_values(const void* obs_kf, const void* obs_lm,
                                        const void* mask, int O, int n_kf, int n_lm,
                                        void* scratch, long long scratch_len, void* out,
                                        void* stream) {
  if (n_kf <= 0) return 0;
  if (O < 0 || n_lm <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (scratch_len < 4LL * O + n_lm + 3LL * n_kf + 2 + kMaxGrid)
    return static_cast<int>(cudaErrorInvalidValue);
  int room = 0;
  cudaError_t err = coop::smem_room(reinterpret_cast<const void*>(redundancy_values_kernel), &room);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (room < kSmem) return static_cast<int>(cudaErrorInvalidConfiguration);
  int32_t* w = static_cast<int32_t*>(scratch);
  Args p;
  p.obs_kf = static_cast<const int32_t*>(obs_kf);
  p.obs_lm = static_cast<const int32_t*>(obs_lm);
  p.mask = static_cast<const float*>(mask);
  p.O = O;
  p.n_kf = n_kf;
  p.n_lm = n_lm;
  p.out = static_cast<float*>(out);
  p.vm = reinterpret_cast<float2*>(w);
  w += 2LL * O;
  p.lm_count = w;
  w += n_lm;
  p.kf_count = w;
  w += n_kf;
  p.n_listed = w;
  w += 2;
  p.kf_local = w;
  w += n_kf;
  p.slice_tot = w;
  w += kMaxGrid;
  p.listed = w;
  w += n_kf;
  p.slot = w;
  w += O;
  p.perm = w;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  void* args[] = {&p};
  // enough threads for kUnroll observations each, and a block a keyframe
  // where they are few (phase 3b's blocks)
  const long long items = std::max<long long>(O / kUnroll, 1LL * n_kf * kThreads);
  return coop::launch(redundancy_values_kernel, kThreads, kSmem, items, kMaxGrid,
                      coop::Slots::kCap, args, st);
}
