// Squared-L2 word assignment (K13) and masked top-2 L2 ratio matching per
// column segment (K14) over 128-dimensional float32 (SIFT) descriptors.
//
// Replaces:
//   K13 covins_tpu/ops/descriptors.py:89 l2_distance_sq and the jnp.argmin
//       that models/kf_database.py:60-61 (_insert_and_score, L2 branch),
//       ops/bow.py:89 assign_words_l2 and the k-means assignment of
//       ops/bow.py:68 train_vocabulary_l2 take of it;
//   K14 the COVINS-G verification's L2 image matching,
//       covins_tpu/ops/loopverify.py:490-505 (_covinsg_verify_impl, metric
//       "l2"): jnp.sqrt(l2_distance_sq) + descriptors.py:103 masked_dist
//       over the query rig x candidate rig descriptors, then per (query
//       keyframe, candidate keyframe) block :114 knn2 and :124 match_ratio.
//
// Arithmetic, shared by both entries and written alike by the plain
// versions (ops/descriptors.py l2_distance_sq): per row aa = sum a_k a_k,
// per column bb = sum b_k b_k, per pair ab = sum a_k b_k, each a float32
// running sum over k = 0..127 in that order, every product and sum rounded
// on its own (this source is built with --fmad=false); d = (aa + bb) - 2 ab
// in float32, then clamped at 0 by a comparison that keeps NaN, as
// jnp.maximum and torch.clamp do; K14 takes its IEEE square root.  The
// card and the plain version therefore agree bit for bit; against the JAX
// package, whose XLA product sums in its own blocked order, they agree
// within rounding.
//
// Bound on the H100: M*N*128 multiply-adds (2*M*N*128 float32 operations
// at 67 TFLOP/s) against (M + N)*512 bytes in and 8 bytes (K13) or 12
// bytes (K14) a (row, segment) out, so operations.  Without FMA contraction
// a multiply-add is two instructions: at most half that peak.
//
// Design: a block takes 64 rows and one part of one column segment (the
// grid is (row tile, segment, part); parts of at least 256 columns, at
// most 8, chosen as K11 chooses them, so that the blocks outnumber the SMs
// fourfold where rows and segments alone do not).  Its rows stay in shared
// memory, dimension-major, for the whole launch; the columns come through
// in tiles of 64, a tile's 128 dimensions in four chunks of 32.  256
// threads, each a 4 x 4 block of (row, column) sums in registers, read
// their 4 rows and 4 columns with one 16-byte load each per dimension.
// The key (distance bits << 32 | column), an unsigned 64-bit integer,
// orders non-negative distances as their floats do and ties by the lower
// column, so one unsigned min (K13) or a top 2 of two mins and a max (K14)
// keeps jnp.argmin's and lax.top_k's choice in any order.  The 16 threads
// of a row merge their keys by shuffles; with several parts each block
// writes its rows' keys to scratch and the last block of a (row tile,
// segment) to finish merges them (a counter per pair, zeroed before the
// launch).  K14 counts a masked row or column as exactly 2^30, as
// masked_dist fills them, and gates in float32 (d1 < max_dist, d1 < ratio
// * d2), as the reference's weakly typed scalars make it.  No (M, N)
// matrix is written.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;

constexpr int kDim = 128;      // descriptor dimensions
constexpr int kTile = 64;      // rows of a block; columns of a tile
constexpr int kChunk = 32;     // dimensions of a column tile staged at once
constexpr int kThreads = 256;  // 16 x 16 threads, 4 rows x 4 columns each
constexpr int kMaxParts = 8;   // column parts a segment at most
constexpr int kMinPart = 256;  // columns a part at least
constexpr u64 kNone = ~0ull;
constexpr unsigned kBigBits = 0x4e800000u;  // 2^30 in float32 (descriptors.py:100)
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const float4* a;        // (M, 128)
  const uint8_t* a_mask;  // (M,) or null
  int M;
  const float4* b;        // (N, 128)
  const uint8_t* b_mask;  // (N,) or null
  int N, seg, P, chunk;
  float max_dist, ratio;
  int32_t* out0;  // K13: idx (M,); K14: idx (M, S)
  int32_t* out1;  // K13: the minimum's float bits (M,); K14: d1 bits (M, S)
  int32_t* out2;  // K14: d2 bits (M, S)
  u64* part;      // (M, S, P, 2) keys of the parts
  int* done;      // (S, row tiles) counters
};

// (b1, b2) the two smallest keys so far, b1 <= b2; insert x
__device__ __forceinline__ void insert2(u64& b1, u64& b2, u64 x) {
  b2 = min(max(b1, x), b2);
  b1 = min(b1, x);
}

// merge the pair (c1, c2) into (b1, b2)
__device__ __forceinline__ void merge2(u64& b1, u64& b2, u64 c1, u64 c2) {
  b2 = min(max(b1, c1), min(b2, c2));
  b1 = min(b1, c1);
}

// the outputs of one (row, segment) from its smallest keys
template <bool kTop2>
__device__ __forceinline__ void write_row(const Params& p, int S, int s, int row, u64 k1,
                                          u64 k2) {
  if (!kTop2) {
    const bool ok = p.a_mask == nullptr || p.a_mask[row] != 0;
    p.out0[row] = ok ? static_cast<int32_t>(k1 & kFull) : -1;
    p.out1[row] = static_cast<int32_t>(k1 >> 32);
    return;
  }
  const unsigned b1 = static_cast<unsigned>(k1 >> 32), b2 = static_cast<unsigned>(k2 >> 32);
  const float d1 = __uint_as_float(b1), d2 = __uint_as_float(b2);
  int idx = -1;
  if (d1 < p.max_dist && d1 < __fmul_rn(p.ratio, d2))
    idx = static_cast<int>(k1 & kFull) - s * p.seg;
  const int64_t o = (int64_t)row * S + s;
  p.out0[o] = idx;
  p.out1[o] = static_cast<int32_t>(b1);
  p.out2[o] = static_cast<int32_t>(b2);
}

template <bool kTop2>
__global__ void __launch_bounds__(kThreads) l2_match_kernel(Params p) {
  __shared__ __align__(16) float sa[kDim][kTile];    // the block's rows, dimension-major
  __shared__ __align__(16) float sb[kChunk][kTile];  // a column tile's chunk
  __shared__ float saa[kTile], sbb[kTile];
  __shared__ int last;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int S = p.N / p.seg, Mt = (p.M + kTile - 1) / kTile;
  // blocks of one column part are consecutive: (segment, part) major
  const int tile = blockIdx.x % Mt, sp = blockIdx.x / Mt;
  const int s = sp / p.P, part = sp % p.P;
  const int r0 = tile * kTile;

  // the rows, zero past M; consecutive threads take consecutive rows
  for (int i = tid; i < kTile * (kDim / 4); i += kThreads) {
    const int r = i & (kTile - 1), q = i / kTile;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < p.M) v = p.a[(int64_t)(r0 + r) * (kDim / 4) + q];
    sa[4 * q][r] = v.x;
    sa[4 * q + 1][r] = v.y;
    sa[4 * q + 2][r] = v.z;
    sa[4 * q + 3][r] = v.w;
  }
  __syncthreads();
  if (tid < kTile) {
    float aa = 0.f;
    for (int k = 0; k < kDim; ++k) aa = __fadd_rn(aa, __fmul_rn(sa[k][tid], sa[k][tid]));
    saa[tid] = aa;
  }
  bool row_ok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + 4 * ty + i;
    row_ok[i] = row < p.M && (p.a_mask == nullptr || p.a_mask[row] != 0);
  }

  // this block's columns [c_lo, c_hi) of segment s
  const int c_lo = s * p.seg + min(p.seg, part * p.chunk);
  const int c_hi = s * p.seg + min(p.seg, (part + 1) * p.chunk);
  u64 k1[4] = {kNone, kNone, kNone, kNone}, k2[4] = {kNone, kNone, kNone, kNone};
  for (int c0 = c_lo; c0 < c_hi; c0 += kTile) {
    const int n = min(kTile, c_hi - c0);
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    float bb = 0.f;  // column c0 + tid, for tid < kTile
    for (int kc = 0; kc < kDim; kc += kChunk) {
      __syncthreads();  // the previous chunk (and epilogue) is read
      for (int i = tid; i < kTile * (kChunk / 4); i += kThreads) {
        const int c = i & (kTile - 1), q = i / kTile;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (c < n) v = p.b[(int64_t)(c0 + c) * (kDim / 4) + kc / 4 + q];
        sb[4 * q][c] = v.x;
        sb[4 * q + 1][c] = v.y;
        sb[4 * q + 2][c] = v.z;
        sb[4 * q + 3][c] = v.w;
      }
      __syncthreads();
      if (tid < kTile)
        for (int d = 0; d < kChunk; ++d) bb = __fadd_rn(bb, __fmul_rn(sb[d][tid], sb[d][tid]));
#pragma unroll 8
      for (int d = 0; d < kChunk; ++d) {
        const float4 av = *reinterpret_cast<const float4*>(&sa[kc + d][4 * ty]);
        const float4 bv = *reinterpret_cast<const float4*>(&sb[d][4 * tx]);
        const float ar[4] = {av.x, av.y, av.z, av.w}, br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(ar[i], br[j]));
      }
    }
    if (tid < kTile) sbb[tid] = bb;
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int cl = 4 * tx + j;
      if (cl >= n) continue;
      const int col = c0 + cl;
      const bool col_ok = !kTop2 || p.b_mask == nullptr || p.b_mask[col] != 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float d = __fsub_rn(__fadd_rn(saa[4 * ty + i], sbb[cl]), __fmul_rn(2.f, acc[i][j]));
        d = d < 0.f ? 0.f : d;  // keeps NaN
        unsigned bits;
        if (kTop2) {
          bits = (row_ok[i] && col_ok) ? __float_as_uint(__fsqrt_rn(d)) : kBigBits;
        } else {
          bits = __float_as_uint(d);
        }
        const u64 key = (static_cast<u64>(bits) << 32) | static_cast<unsigned>(col);
        if (kTop2)
          insert2(k1[i], k2[i], key);
        else
          k1[i] = min(k1[i], key);
      }
    }
  }
  // the 16 threads of a row tile's rows are lanes of one warp
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int o = 1; o < 16; o <<= 1) {
      const u64 c1 = __shfl_xor_sync(kFull, k1[i], o);
      const u64 c2 = __shfl_xor_sync(kFull, k2[i], o);
      if (kTop2)
        merge2(k1[i], k2[i], c1, c2);
      else
        k1[i] = min(k1[i], c1);
    }
  if (p.P == 1) {
    if (tx == 0)
      for (int i = 0; i < 4; ++i) {
        const int row = r0 + 4 * ty + i;
        if (row < p.M) write_row<kTop2>(p, S, s, row, k1[i], k2[i]);
      }
    return;
  }
  // the parts' keys: the last block of this (row tile, segment) merges them
  if (tx == 0)
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + 4 * ty + i;
      if (row >= p.M) continue;
      u64* pp = p.part + 2 * (((int64_t)row * S + s) * p.P + part);
      pp[0] = k1[i];
      pp[1] = k2[i];
    }
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(p.done + (int64_t)s * Mt + tile, 1) == p.P - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (tid < kTile && r0 + tid < p.M) {
    const int row = r0 + tid;
    const u64* pp = p.part + 2 * ((int64_t)row * S + s) * p.P;
    u64 m1 = kNone, m2 = kNone;
    for (int q = 0; q < p.P; ++q) {
      const u64 c1 = __ldcg(pp + 2 * q), c2 = __ldcg(pp + 2 * q + 1);
      if (kTop2)
        merge2(m1, m2, c1, c2);
      else
        m1 = min(m1, c1);
    }
    write_row<kTop2>(p, S, s, row, m1, m2);
  }
}

// the SM count of the current device, queried once per device
int sm_count() {
  static int cached[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (cached[dev] == 0) {
    int sms = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return 132;
    cached[dev] = sms;
  }
  return cached[dev];
}

template <bool kTop2>
int launch(Params p, void* scratch, cudaStream_t st) {
  if (p.M <= 0) return 0;
  if (p.N <= 0 || p.seg <= 0 || p.N % p.seg != 0 || (kTop2 && p.seg < 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const int S = p.N / p.seg, Mt = (p.M + kTile - 1) / kTile;
  const long long pairs = 1LL * Mt * S;
  const long long target = 4LL * sm_count();
  int P = 1;
  if (pairs < target)
    P = static_cast<int>(std::min<long long>((target + pairs - 1) / pairs,
                                             std::min(p.seg / kMinPart, kMaxParts)));
  p.P = std::max(P, 1);
  const long long blocks = pairs * p.P;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  p.chunk = (p.seg + p.P - 1) / p.P;
  p.part = static_cast<u64*>(scratch);
  p.done = reinterpret_cast<int*>(p.part + 2LL * p.M * S * kMaxParts);
  if (p.P > 1) {
    const cudaError_t err = cudaMemsetAsync(p.done, 0, sizeof(int) * pairs, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  l2_match_kernel<kTop2><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a (M, 128) f32 with row_mask (M,) bool or null; b (N, 128) f32; rows
// 16-byte aligned and contiguous; outputs idx (M,) int32 (the first
// minimum's column, -1 where masked) and dmin (M,) f32 (the minimum);
// scratch: 8-byte aligned, 128 * M + 4 * ceil(M / 64) bytes.
extern "C" int covins_l2_argmin(const void* a, const void* row_mask, int M, const void* b,
                                int N, void* idx, void* dmin, void* scratch, void* stream) {
  Params p{};
  p.a = static_cast<const float4*>(a);
  p.a_mask = static_cast<const uint8_t*>(row_mask);
  p.M = M;
  p.b = static_cast<const float4*>(b);
  p.N = N;
  p.seg = N;
  p.out0 = static_cast<int32_t*>(idx);
  p.out1 = static_cast<int32_t*>(dmin);
  return launch<false>(p, scratch, static_cast<cudaStream_t>(stream));
}

// a (M, 128) f32 and a_mask (M,) bool; b (N, 128) f32 and b_mask (N,)
// bool, rows 16-byte aligned and contiguous, N a multiple of seg >= 2;
// out: (3, M, N / seg) int32 (index within the segment or -1, d1 and d2
// as float32 bits); scratch: 8-byte aligned, 128 * M * (N / seg) + 4 *
// ceil(M / 64) * (N / seg) bytes.
extern "C" int covins_l2_ratio_match(const void* a, const void* a_mask, int M, const void* b,
                                     const void* b_mask, int N, int seg, float max_dist,
                                     float ratio, void* out, void* scratch, void* stream) {
  Params p{};
  p.a = static_cast<const float4*>(a);
  p.a_mask = static_cast<const uint8_t*>(a_mask);
  p.M = M;
  p.b = static_cast<const float4*>(b);
  p.b_mask = static_cast<const uint8_t*>(b_mask);
  p.N = N;
  p.seg = seg;
  p.max_dist = max_dist;
  p.ratio = ratio;
  if (seg > 0 && N % seg == 0) {
    const int64_t ms = static_cast<int64_t>(M) * (N / seg);
    p.out0 = static_cast<int32_t*>(out);
    p.out1 = p.out0 + ms;
    p.out2 = p.out1 + ms;
  }
  return launch<true>(p, scratch, static_cast<cudaStream_t>(stream));
}
