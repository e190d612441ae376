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
// Arithmetic of the result, written alike by the plain versions
// (ops/descriptors.py l2_distance_sq): per row aa = sum a_k a_k, per
// column bb = sum b_k b_k, per pair ab = sum a_k b_k, each a float32
// running sum over k = 0..127 in that order, every product and sum rounded
// on its own (this source is built with --fmad=false); d = (aa + bb) - 2 ab
// in float32, then clamped at 0 by a comparison that keeps NaN, as
// jnp.maximum and torch.clamp do; K14 takes its IEEE square root.  The
// card and the plain version agree bit for bit; against the JAX package,
// whose XLA product sums in its own blocked order, they agree within
// rounding.
//
// Design: the tensor cores filter, the CUDA cores decide.  A block takes
// 64 rows and one part of one column segment (grid (row tile, segment,
// part); at most 8 parts: K13's of at least 256 columns, as many as one
// wave of two blocks an SM takes; K14's equal shares of a segment's valid
// columns, at least 64 of its columns a part, as many as make the blocks
// outnumber the SMs fourfold).  Its rows stay in shared memory; its columns
// come in windows of 512, whose columns of the part are listed, then in
// tiles of 64, double-buffered with cp.async.  Four warps of 32 x 32 (row, column) pairs form ab~ =
// hi.hi' + hi.lo' + lo.hi' (3xTF32: hi = rna_tf32(x), lo = tf32(x -
// hi), truncated) with mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32, each
// step's 8 products independent of the step before, the accumulator
// restarting every 16 dimensions and its chunks summed on the CUDA cores;
// meanwhile each lane sums its warp's column's norm bb exactly.  Each pair
// gets the interval [lo, hi] = [x~ - T, max(x~, 0) + T] around the filter's
// x~ = fl(fl(aa + bb) - 2 ab~), which holds the plain version's d (below);
// the smallest hi is that of the smallest x~, and a column can be a
// candidate only if x~ <= bound + T.  Each warp keeps, for each of its rows and its half of the columns, the
// smallest hi so far (K13) or the two smallest (K14), in registers, and a
// list of at most 8 candidates: the columns whose lo does not exceed that
// bound, pruned whenever it falls; no barrier but the tile's own.  After
// the part, the lists are pruned to the bound of both halves and each
// candidate's ab is recomputed on the CUDA cores in the plain order (the
// row from shared memory), giving the exact key (distance bits << 32 |
// column), an unsigned 64-bit integer that orders non-negative distances
// as their floats do and ties by the lower column; a row whose list ever
// needed a ninth candidate is recomputed exactly over the whole part
// instead (counted).  The exact keys then go as before: one min (K13) or a top 2 (K14), the
// parts' keys merged by the last block of a (row tile, segment) to finish
// (a counter per pair, zeroed before the launch).  No (M, N) matrix.
//
// K14 computes only valid x valid pairs: a block takes the 64 valid rows
// of its rank among a_mask's valid rows and lists only its part's valid
// columns.  A masked row or column counts as exactly 2^30, as masked_dist
// fills them: the blocks of part 0 write the masked rows of their 64-row
// range (keys (2^30, first column), (2^30, second column)) and put the
// segment's first two masked columns, as (2^30, column) keys, into their
// rows' top 2.  Gates in float32 (d1 < max_dist, d1 < ratio * d2), as the
// reference's weakly typed scalars make it.  K13 computes every row: its
// dmin holds masked rows' minima too.
//
// Why the candidates hold the plain version's answer.  u = 2^-24, g128 =
// 128u / (1 - 128u), C_TC the relative error allowed to the tensor-core
// product (L2_FILTER_REL_ERR in ops/descriptors.py, passed in).  For a
// pair, with s = fl(aa + bb) shared by both:
//  - recursive summation bounds the plain product, |ab - a.b| <= g128
//    sum |a_k b_k| <= g128 |a| |b| (Cauchy-Schwarz), and |a| |b| <=
//    sqrt(aa bb) / (1 - g128), since aa and bb sum non-negative terms;
//  - the 3xTF32 product obeys |ab~ - a.b| <= C |a| |b| with C < C_TC / 4
//    (next paragraph);
//  - the two subtractions x = fl(s - 2 ab) and x~ = fl(s - 2 ab~) round by
//    at most u |s - 2 ab| each, s <= (1 + u)(aa + bb), 2 |ab| <= (aa + bb)
//    (1 + 2^-13);
//  so |x~ - x| <= T = 2 (C_TC + g128) sqrt(aa bb) + 4u (aa + bb), the
//  terms of order u^2 (aa + bb) and u sqrt(aa bb) left over being covered
//  by 2 (C_TC - C) sqrt(aa bb).  The clamp at 0 is 1-Lipschitz and keeps
//  x~'s NaN, so d = max(x, 0) lies in [x~ - T, max(x~, 0) + T]; T and the
//  interval are computed rounding outward (__fmul_ru, __fsub_rd, ...), T
//  of a row at the largest bb of the warp's 32 columns of the tile.
//  A column whose lo exceeds the smallest hi of the part cannot be its
//  minimum (K13): every column of the minimum's distance, ties included,
//  stays a candidate.  For K14 the keys compare sqrt_rn(d), and sqrt_rn(x)
//  <= sqrt_rn(y) with x > y needs x <= y (1 + u)^2 / (1 - u)^2 < y (1 +
//  2^-21): a column can be in the top 2 only if lo <= (second smallest hi)
//  (1 + 2^-21).  A NaN lo is always a candidate; NaN hi bounds nothing.
//
// C, the 3xTF32 product's error.  hi keeps 11 significant bits, |x - hi| <=
// 2^-11 |x|; x - hi is exact in float32, and lo, its truncation to TF32,
// leaves |x - hi - lo| < 2^-10 |x - hi| <= 2^-21 |x|.  Products of TF32
// values are exact; dropping lo.lo' and the remainders costs at most 5.01
// * 2^-22 |a_k b_k| a dimension.  The tensor core's float32 accumulation
// is not documented; we allow each m16n8k8 step an
// error of 16 float32 ulps of the sum of the magnitudes it adds, 2^-19
// (|c| + sum |p|).  The accumulator restarts every 16 dimensions (6 steps:
// 3 products x 2 k8), so the steps of a chunk add up to at most 6 (1 +
// 2^-8) 2^-19 times the chunk's sum |a_k b_k|; the 8 chunk sums are added
// on the CUDA cores (7u).  So C <= (6.03 * 2^-19 + 7u + 5.01 * 2^-22)
// |a| |b| < 2^-16.2 |a| |b|, under a quarter of C_TC = 2^-14.  The bound
// is checked on the card: covins_l2_filter_debug writes the real kernel's
// max(x~, 0) for every pair, and chip_smoke.py fails where |d~ - d| > T or
// where the product's share of it, (|d~ - d| - 4u (aa + bb)) / (2 sqrt(aa
// bb)), exceeds C_TC / 8.
//
// Bound on the H100: the exact answer needs M*N*128 float32 multiply-adds
// (2*M*N*128 operations at 67 TFLOP/s, K14 over valid pairs only) against
// (M + N)*512 bytes in and 8 (K13) or 12 (K14) bytes a (row, segment)
// out: operations.  This design's own floor: three TF32 products (2*3*128
// operations a computed pair at 495 TFLOP/s) plus the candidates' exact
// products on the CUDA cores.  What holds the kernel from it: mma.sync's
// TF32 rate, well below the 495 that wgmma reaches, the split and the
// filter's bookkeeping, and eight warps an SM (two blocks of 112 KB of
// shared memory and about 200 registers a thread).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "coop_launch.cuh"

namespace {

typedef unsigned long long u64;

constexpr int kDim = 128;         // descriptor dimensions
constexpr int kTile = 64;         // rows of a block; columns of a tile
constexpr int kStride = kDim + 4; // floats a staged row: conflict-free fragment loads
constexpr int kThreads = 128;     // 4 warps of 32 rows x 32 columns
constexpr int kWarps = kThreads / 32;
constexpr int kWindow = 512;      // columns listed at once
constexpr int kCand = 8;          // candidates a (row, column half)
constexpr int kMaxParts = 8;      // column parts a segment at most
constexpr int kMinPart = 256;     // columns a part at least
constexpr u64 kNone = ~0ull;
constexpr unsigned kBigBits = 0x4e800000u;  // 2^30 in float32 (descriptors.py:100)
constexpr unsigned kFull = 0xffffffffu;
constexpr float kFourU = 2.384185791015625e-07f;  // 4u = 2^-22
constexpr float kSqrtSlack = 1.000000476837158203125f;  // 1 + 2^-21

enum Mode { kArgmin = 0, kTop2 = 1, kDebug = 2 };

struct Params {
  const float* a;         // (M, 128)
  const uint8_t* a_mask;  // (M,) or null
  int M;
  const float* b;         // (N, 128)
  const uint8_t* b_mask;  // (N,) or null
  int N, seg, P, chunk;
  float max_dist, ratio;
  float coef;     // 2 (C_TC + g128), rounded up
  int32_t* out0;  // K13: idx (M,); K14: idx (M, S)
  int32_t* out1;  // K13: the minimum's float bits (M,); K14: d1 bits (M, S)
  int32_t* out2;  // K14: d2 bits (M, S)
  float* dtilde;  // debug: max(x~, 0) (M, N)
  u64* part;      // (M, S, P, 2) keys of the parts
  int* done;      // (S, row tiles) counters
  u64* stats;     // (4,): rows filtered, candidates, most candidates a row, rows rescanned; or null
};

struct __align__(16) Smem {
  float a[kTile][kStride];  // the block's rows
  union {
    float b[2][kTile][kStride];       // column tiles, double-buffered
    struct { u64 k1[kTile], k2[kTile]; } key;  // after the tiles: the exact keys a row
  };
  int col[kWindow];                     // the window's valid columns
  float bb[kWarps][32];                 // each warp's columns' bb (infinite past the tile)
  int row[kTile];                       // the block's rows' indices
  float aa[kTile], pa[kTile], qa[kTile];  // aa, coef sqrt(aa) and 4u aa (rounded up)
  float u[2][kTile][2];                 // each column half's two smallest hi a row
  int cnt[2][kTile];                    // candidates a (column half, row); above kCand: rescanned
  int cand_col[2][kTile][kCand];
  float cand_lo[2][kTile][kCand];
  u64 red[kWarps][2];
  int scan[kWarps];
  int n_rows, n_cols, last;
  int part_lo, part_hi;                 // the part's first column and one past its last
  int mcol[2];                          // K14: the segment's first two masked columns (-1: none)
  int stat[3];                          // candidates, the most a row, rows rescanned
};

static_assert(sizeof(Smem) <= 113 * 1024, "two blocks an SM");

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

// the two smallest floats so far; NaN is never taken
__device__ __forceinline__ void fmin2(float& m1, float& m2, float x) {
  if (x < m1) {
    m2 = m1;
    m1 = x;
  } else if (x < m2) {
    m2 = x;
  }
}

__device__ __forceinline__ u64 make_key(unsigned bits, int col) {
  return (static_cast<u64>(bits) << 32) | static_cast<unsigned>(col);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// x = hi + lo + r: hi TF32 rounded to nearest (ties away), lo the TF32
// truncation of x - hi (exact in float32), |r| < 2^-10 |x - hi| <= 2^-21 |x|
__device__ __forceinline__ void split_tf32(float x, unsigned& hi, unsigned& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
  lo = __float_as_uint(__fsub_rn(x, __uint_as_float(hi))) & 0xffffe000u;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// the exclusive prefix of v over the block's threads, and its total
__device__ __forceinline__ int block_scan(int v, int* scratch, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) scratch[warp] = x;
  __syncthreads();
  int before = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int t = scratch[w];
    before += w < warp ? t : 0;
    total += t;
  }
  __syncthreads();
  return before + x - v;
}

__device__ __forceinline__ bool col_ok(const Params& p, int c) {
  return p.b_mask == nullptr || p.b_mask[c] != 0;
}

// the plain version's distance of the block's row r and column c: ab and
// bb running sums in order, as l2_distance_sq
__device__ __forceinline__ float exact_d(const Smem& sm, const Params& p, int r, int c) {
  const float4* bp = reinterpret_cast<const float4*>(p.b + (int64_t)c * kDim);
  const float* ar = sm.a[r];
  float ab = 0.f, bb = 0.f;
#pragma unroll
  for (int q = 0; q < kDim / 4; ++q) {
    const float4 v = __ldg(bp + q);
    const float4 x = *reinterpret_cast<const float4*>(ar + 4 * q);
    ab = __fadd_rn(ab, __fmul_rn(x.x, v.x));
    bb = __fadd_rn(bb, __fmul_rn(v.x, v.x));
    ab = __fadd_rn(ab, __fmul_rn(x.y, v.y));
    bb = __fadd_rn(bb, __fmul_rn(v.y, v.y));
    ab = __fadd_rn(ab, __fmul_rn(x.z, v.z));
    bb = __fadd_rn(bb, __fmul_rn(v.z, v.z));
    ab = __fadd_rn(ab, __fmul_rn(x.w, v.w));
    bb = __fadd_rn(bb, __fmul_rn(v.w, v.w));
  }
  const float d = __fsub_rn(__fadd_rn(sm.aa[r], bb), __fmul_rn(2.f, ab));
  return d < 0.f ? 0.f : d;  // keeps NaN
}

// the exact key of row r and column c (K14: of the square root)
template <int kMode>
__device__ __forceinline__ u64 exact_key(const Smem& sm, const Params& p, int r, int c) {
  const float d = exact_d(sm, p, r, c);
  return make_key(__float_as_uint(kMode == kTop2 ? __fsqrt_rn(d) : d), c);
}

// the outputs of one (row, segment) from its smallest keys
template <int kMode>
__device__ __forceinline__ void write_row(const Params& p, int S, int s, int row, u64 k1,
                                          u64 k2) {
  if (kMode == kArgmin) {
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

// stage the list's columns [t0, t0 + n) into buffer `buf`, zero past n
__device__ __forceinline__ void load_tile(Smem& sm, const Params& p, int buf, int t0, int n) {
  for (int i = threadIdx.x; i < kTile * (kDim / 4); i += kThreads) {
    const int c = i / (kDim / 4), q = i % (kDim / 4);
    float* dst = &sm.b[buf][c][4 * q];
    if (c < n)
      cp_async16(dst, p.b + (int64_t)sm.col[t0 + c] * kDim + 4 * q);
    else
      *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  cp_async_commit();
}

// a warp's 32 x 32 products ab~ of the block's rows [32 wr, 32 wr + 32) and
// the tile's columns [32 wc, 32 wc + 32): sum[i][j] is the m16n8 fragment
// of rows 16 i and columns 8 j.  Each lane also sums the squares of the
// tile's column 32 wc + lane in the plain order, into bb.
__device__ __forceinline__ void tile_products(const Smem& sm, int buf, int wr, int wc,
                                              float (&sum)[2][4][4], float& bb) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* A = &sm.a[32 * wr + g][t];
  const float* B = &sm.b[buf][32 * wc + g][t];
  const float* N = sm.b[buf][32 * wc + lane];
  bb = 0.f;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sum[i][j][e] = 0.f;
#pragma unroll 2
  for (int kc = 0; kc < kDim; kc += 16) {
    float acc[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
#pragma unroll
    for (int kk = kc; kk < kc + 16; kk += 8) {
      unsigned ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float* r = A + 16 * i * kStride + kk;
        split_tf32(r[0], ah[i][0], al[i][0]);
        split_tf32(r[8 * kStride], ah[i][1], al[i][1]);
        split_tf32(r[4], ah[i][2], al[i][2]);
        split_tf32(r[8 * kStride + 4], ah[i][3], al[i][3]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float* c = B + 8 * j * kStride + kk;
        split_tf32(c[0], bh[j][0], bl[j][0]);
        split_tf32(c[4], bh[j][1], bl[j][1]);
      }
      {
        const float4 v = *reinterpret_cast<const float4*>(N + kk);
        const float4 w = *reinterpret_cast<const float4*>(N + kk + 4);
        bb = __fadd_rn(bb, __fmul_rn(v.x, v.x));
        bb = __fadd_rn(bb, __fmul_rn(v.y, v.y));
        bb = __fadd_rn(bb, __fmul_rn(v.z, v.z));
        bb = __fadd_rn(bb, __fmul_rn(v.w, v.w));
        bb = __fadd_rn(bb, __fmul_rn(w.x, w.x));
        bb = __fadd_rn(bb, __fmul_rn(w.y, w.y));
        bb = __fadd_rn(bb, __fmul_rn(w.z, w.z));
        bb = __fadd_rn(bb, __fmul_rn(w.w, w.w));
      }
      // the three products in turn, so that consecutive steps are independent
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_tf32(acc[i][j], al[i], bh[j]);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_tf32(acc[i][j], ah[i], bl[j]);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_tf32(acc[i][j], ah[i], bh[j]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sum[i][j][e] = __fadd_rn(sum[i][j][e], acc[i][j][e]);
  }
}

template <int kMode>
__global__ void __launch_bounds__(kThreads, 2) l2_match_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, wr = warp & 1, wc = warp >> 1;
  const int S = p.N / p.seg, Mt = (p.M + kTile - 1) / kTile;
  // blocks of one column part are consecutive: (segment, part) major
  const int tile = blockIdx.x % Mt, sp = blockIdx.x / Mt;
  const int s = sp / p.P, part = sp % p.P, s0 = s * p.seg;

  // the block's rows: K14 the valid rows of rank [64 tile, 64 tile + 64),
  // after part 0 has written the masked rows of [64 tile, 64 tile + 64)
  if (kMode == kTop2) {
    if (part == 0)
      for (int i = tid; i < kTile; i += kThreads) {
        const int row = tile * kTile + i;
        if (row < p.M && p.a_mask[row] == 0)
          write_row<kMode>(p, S, s, row, make_key(kBigBits, s0), make_key(kBigBits, s0 + 1));
      }
    const int want = tile * kTile;
    int found = 0;  // valid rows before `base`, the same in every thread
    for (int base = 0; base < p.M && found < want + kTile; base += 16 * kThreads) {
      const int r0 = base + 16 * tid;
      bool ok[16];
      int v = 0;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        ok[i] = r0 + i < p.M && p.a_mask[r0 + i] != 0;
        v += ok[i];
      }
      int total;
      int rank = found + block_scan(v, sm.scan, total);
#pragma unroll
      for (int i = 0; i < 16; ++i)
        if (ok[i]) {
          if (rank >= want && rank < want + kTile) sm.row[rank - want] = r0 + i;
          ++rank;
        }
      found += total;
    }
    if (tid == 0) sm.n_rows = min(max(found - want, 0), kTile);
  } else {
    if (tid < kTile) sm.row[tid] = tile * kTile + tid;
    if (tid == 0) sm.n_rows = min(kTile, p.M - tile * kTile);
  }
  __syncthreads();
  const int nr = sm.n_rows;
  if (nr == 0) return;

  for (int i = tid; i < kTile * (kDim / 4); i += kThreads) {
    const int r = i / (kDim / 4), q = i % (kDim / 4);
    float* dst = &sm.a[r][4 * q];
    if (r < nr)
      cp_async16(dst, p.a + (int64_t)sm.row[r] * kDim + 4 * q);
    else
      *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  cp_async_commit();  // the rows arrive while the segment is counted
  if (tid < 2) sm.mcol[tid] = -1;
  if (tid < 3) sm.stat[tid] = 0;
  if (tid == 0) sm.part_lo = sm.part_hi = 0;

  // the part's columns, as ranks among the segment's listed columns
  // [rk_lo, rk_hi): K13 every column, in parts of p.chunk; K14 the valid
  // ones, in parts of equal counts, after counting them and noting the
  // segment's first two masked columns
  int rk_lo = min(p.seg, part * p.chunk), rk_hi = min(p.seg, (part + 1) * p.chunk);
  int w0 = s0 + rk_lo, seen = rk_lo;  // the first window, and the ranks before it
  if (kMode == kTop2) {
    int nv = 0, masked = 0;
    for (int base = 0; base < p.seg; base += 16 * kThreads) {
      const int c0 = base + 16 * tid;
      unsigned ok = 0;
      int v = 0, m = 0;
#pragma unroll
      for (int i = 0; i < 16; ++i)
        if (c0 + i < p.seg) {
          const bool o = col_ok(p, s0 + c0 + i);
          ok |= static_cast<unsigned>(o) << i;
          v += o;
          m += !o;
        }
      int total;
      int mr = masked + (block_scan(v + (m << 16), sm.scan, total) >> 16);
#pragma unroll
      for (int i = 0; i < 16; ++i)
        if (c0 + i < p.seg && !(ok >> i & 1u)) {
          if (mr < 2) sm.mcol[mr] = s0 + c0 + i;
          ++mr;
        }
      nv += total & 0xffff;
      masked += total >> 16;
    }
    const int per = (nv + p.P - 1) / p.P;
    rk_lo = min(nv, part * per);
    rk_hi = min(nv, rk_lo + per);
    w0 = s0;
    seen = 0;
  }
  cp_async_wait<0>();
  __syncthreads();
  if (tid < kTile) {
    float aa = 0.f;
#pragma unroll
    for (int q = 0; q < kDim / 4; ++q) {
      const float4 x = *reinterpret_cast<const float4*>(&sm.a[tid][4 * q]);
      aa = __fadd_rn(aa, __fmul_rn(x.x, x.x));
      aa = __fadd_rn(aa, __fmul_rn(x.y, x.y));
      aa = __fadd_rn(aa, __fmul_rn(x.z, x.z));
      aa = __fadd_rn(aa, __fmul_rn(x.w, x.w));
    }
    sm.aa[tid] = aa;
    sm.pa[tid] = __fmul_ru(p.coef, __fsqrt_ru(aa));
    sm.qa[tid] = __fmul_ru(kFourU, aa);
    sm.cnt[0][tid] = sm.cnt[1][tid] = 0;
  }
  // the lane's rows q = 2 i + h: 32 wr + 16 i + 8 h + g; each column
  // half's bounds on them, the same in the four lanes of a quad
  float u1[4], u2[4], bound[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) u1[q] = u2[q] = bound[q] = INFINITY;

  for (; w0 < s0 + p.seg && seen < rk_hi; w0 += kWindow) {
    // list the window's columns of ranks [rk_lo, rk_hi) (K14: valid ones)
    {
      const int c0 = w0 + 4 * tid;
      bool ok[4];
      int v = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ok[i] = c0 + i < s0 + p.seg && (kMode != kTop2 || col_ok(p, c0 + i));
        v += ok[i];
      }
      int total;
      int rank = seen + block_scan(v, sm.scan, total);
      const int first = max(seen, rk_lo);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (ok[i]) {
          if (rank >= rk_lo && rank < rk_hi) sm.col[rank - first] = c0 + i;
          if (rank == rk_lo) sm.part_lo = c0 + i;
          if (rank == rk_hi - 1) sm.part_hi = c0 + i + 1;
          ++rank;
        }
      if (tid == 0) sm.n_cols = max(0, min(seen + total, rk_hi) - first);
      seen += total;
    }
    __syncthreads();
    const int nw = sm.n_cols;
    if (nw == 0) continue;
    load_tile(sm, p, 0, 0, min(kTile, nw));

    for (int t0 = 0, buf = 0; t0 < nw; t0 += kTile, buf ^= 1) {
      const int n = min(kTile, nw - t0);
      cp_async_wait<0>();
      __syncthreads();  // the tile is in place; every warp is done with the other buffer
      if (t0 + kTile < nw) load_tile(sm, p, buf ^ 1, t0 + kTile, min(kTile, nw - t0 - kTile));
      float sum[2][4][4], bb;
      tile_products(sm, buf, wr, wc, sum, bb);
      // the warp's column norms; past the tile's columns bb is infinite, so
      // that those pairs' hi bound nothing, and they widen no threshold
      const bool col_in = 32 * wc + lane < n;
      sm.bb[warp][lane] = col_in ? bb : INFINITY;
      float nb = col_in ? __fsqrt_ru(bb) : 0.f, qb = col_in ? __fmul_ru(kFourU, bb) : 0.f;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        nb = fmaxf(nb, __shfl_xor_sync(kFull, nb, o));
        qb = fmaxf(qb, __shfl_xor_sync(kFull, qb, o));
      }
      __syncwarp();

      // the lane's pairs: rows 32 wr + 16 i + 8 h + g, columns 32 wc + 8 j + 2 t + e
      if (kMode == kDebug) {
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = 32 * wr + 16 * i + 8 * h + g;
            if (r >= nr) continue;
            const float aa = sm.aa[r];
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int c = 8 * j + 2 * t + e;
                if (32 * wc + c >= n) continue;
                const float x = __fmaf_rn(-2.f, sum[i][j][2 * h + e],
                                          __fadd_rn(aa, sm.bb[warp][c]));
                p.dtilde[(int64_t)sm.row[r] * p.N + sm.col[t0 + 32 * wc + c]] =
                    x < 0.f ? 0.f : x;
              }
          }
        __syncwarp();
        continue;
      }
      // hi = max(x~, 0) + T rises with x~, so a row's smallest hi is that of
      // its smallest x~; and a column whose d can be at most the bound b
      // has x~ - T <= b, that is x~ <= b + T
      float xs[4][8], bbv[8], cut[4], T[4];
      bool fell[4];
#pragma unroll
      for (int k = 0; k < 8; ++k) bbv[k] = sm.bb[warp][8 * (k >> 1) + 2 * t + (k & 1)];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = q >> 1, h = q & 1;
        const int r = 32 * wr + 16 * i + 8 * h + g;
        const int rr = min(r, nr - 1);
        const float aa = sm.aa[rr];
        // T of the row against the largest column norm of the warp's
        // columns: at least each pair's own
        T[q] = __fmaf_ru(sm.pa[rr], nb, __fadd_ru(sm.qa[rr], qb));
        float m1 = INFINITY, m2 = INFINITY;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          xs[q][k] = __fmaf_rn(-2.f, sum[i][k >> 1][2 * h + (k & 1)], __fadd_rn(aa, bbv[k]));
          if (kMode == kTop2) {  // a NaN counts as infinite: it bounds nothing
            const float x = fminf(xs[q][k], INFINITY);
            m2 = fminf(m2, fmaxf(m1, x));
            m1 = fminf(m1, x);
          } else {
            m1 = fminf(m1, xs[q][k]);
          }
        }
#pragma unroll
        for (int o = 1; o < 4; o <<= 1) {
          const float x1 = __shfl_xor_sync(kFull, m1, o);
          if (kMode == kTop2) {
            const float x2 = __shfl_xor_sync(kFull, m2, o);
            m2 = fminf(fmaxf(m1, x1), fminf(m2, x2));
          }
          m1 = fminf(m1, x1);
        }
        const float h1 = __fadd_ru(m1 < 0.f ? 0.f : m1, T[q]);
        if (kMode == kTop2)
          u2[q] = fminf(fmaxf(u1[q], h1), fminf(u2[q], __fadd_ru(m2 < 0.f ? 0.f : m2, T[q])));
        u1[q] = fminf(u1[q], h1);
        const float b = kMode == kTop2 ? __fmul_ru(u2[q], kSqrtSlack) : u1[q];
        cut[q] = __fadd_ru(b, T[q]);
        fell[q] = b < bound[q];
        bound[q] = b;
      }
      // the (column half, row) lists whose bound fell, pruned to it, by lane t = 0
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = 32 * wr + 16 * (q >> 1) + 8 * (q & 1) + g;
        if (t == 0 && fell[q] && r < nr && sm.cnt[wc][r] <= kCand) {
          const int c = sm.cnt[wc][r];
          int kept = 0;
          for (int k = 0; k < c; ++k)
            if (!(sm.cand_lo[wc][r][k] > bound[q])) {
              sm.cand_col[wc][r][kept] = sm.cand_col[wc][r][k];
              sm.cand_lo[wc][r][kept] = sm.cand_lo[wc][r][k];
              ++kept;
            }
          sm.cnt[wc][r] = kept;
        }
      }
      __syncwarp();
      // this tile's candidates (a NaN x~ is one), with their lo = x~ - T
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = 32 * wr + 16 * (q >> 1) + 8 * (q & 1) + g;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int c = 32 * wc + 8 * (k >> 1) + 2 * t + (k & 1);
          if (!(xs[q][k] > cut[q]) && r < nr && c < n) {
            const int slot = atomicAdd(&sm.cnt[wc][r], 1);
            if (slot < kCand) {
              sm.cand_col[wc][r][slot] = sm.col[t0 + c];
              sm.cand_lo[wc][r][slot] = __fsub_rd(xs[q][k], T[q]);
            }
          }
        }
      }
    }
    __syncthreads();  // the window's list is read before the next one is written
  }
  if (kMode == kDebug) return;

  // each column half's bounds, then the candidates of both halves under
  // the part's: two threads a row, one a half
  if (t == 0)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r = 32 * wr + 16 * (q >> 1) + 8 * (q & 1) + g;
      sm.u[wc][r][0] = u1[q];
      sm.u[wc][r][1] = u2[q];
    }
  __syncthreads();
  bool over;  // this thread's row overflowed a list
  {
    const int r = tid >> 1, half = tid & 1;
    u64 e1 = kNone, e2 = kNone;
    over = r < nr && (sm.cnt[0][r] > kCand || sm.cnt[1][r] > kCand);
    int kept = 0;
    if (r < nr && !over) {
      float b1 = sm.u[0][r][0], b2 = sm.u[0][r][1];
      fmin2(b1, b2, sm.u[1][r][0]);
      fmin2(b1, b2, sm.u[1][r][1]);
      const float b = kMode == kTop2 ? __fmul_ru(b2, kSqrtSlack) : b1;
      for (int k = 0; k < sm.cnt[half][r]; ++k)
        if (!(sm.cand_lo[half][r][k] > b)) {
          const u64 key = exact_key<kMode>(sm, p, r, sm.cand_col[half][r][k]);
          insert2(e1, e2, key);
          ++kept;
        }
    }
    merge2(e1, e2, __shfl_xor_sync(kFull, e1, 1), __shfl_xor_sync(kFull, e2, 1));
    kept += __shfl_xor_sync(kFull, kept, 1);
    if (half == 0 && r < nr) {
      sm.key.k1[r] = e1;
      sm.key.k2[r] = e2;
    }
    const bool mine = half == 0 && r < nr;
    const int cands = __reduce_add_sync(kFull, mine && !over ? kept : 0);
    const int most = __reduce_max_sync(kFull, mine && !over ? kept : 0);
    const int overs = __reduce_add_sync(kFull, mine && over);
    if (lane == 0) {
      atomicAdd(&sm.stat[0], cands);
      atomicMax(&sm.stat[1], most);
      atomicAdd(&sm.stat[2], overs);
    }
  }
  // rows that overflowed a list: every listed column of the part, exactly
  if (__syncthreads_or(over))
    for (int r = 0; r < nr; ++r) {
      if (sm.cnt[0][r] <= kCand && sm.cnt[1][r] <= kCand) continue;  // the same in every thread
      u64 e1 = kNone, e2 = kNone;
      for (int c = sm.part_lo + tid; c < sm.part_hi; c += kThreads)
        if (kMode != kTop2 || col_ok(p, c)) insert2(e1, e2, exact_key<kMode>(sm, p, r, c));
#pragma unroll
      for (int o = 1; o < 32; o <<= 1)
        merge2(e1, e2, __shfl_xor_sync(kFull, e1, o), __shfl_xor_sync(kFull, e2, o));
      if (lane == 0) {
        sm.red[warp][0] = e1;
        sm.red[warp][1] = e2;
      }
      __syncthreads();
      if (tid == 0) {
        for (int w = 1; w < kWarps; ++w) merge2(e1, e2, sm.red[w][0], sm.red[w][1]);
        sm.key.k1[r] = e1;
        sm.key.k2[r] = e2;
      }
      __syncthreads();
    }
  if (tid == 0 && p.stats != nullptr) {
    atomicAdd(p.stats, static_cast<u64>(nr));
    atomicAdd(p.stats + 1, static_cast<u64>(sm.stat[0]));
    atomicMax(p.stats + 2, static_cast<u64>(sm.stat[1]));
    atomicAdd(p.stats + 3, static_cast<u64>(sm.stat[2]));
  }

  if (kMode == kTop2 && part == 0)  // the segment's first two masked columns, as 2^30 keys
    for (int r = tid; r < nr; r += kThreads)
      for (int q = 0; q < 2; ++q)
        if (sm.mcol[q] >= 0)
          insert2(sm.key.k1[r], sm.key.k2[r], make_key(kBigBits, sm.mcol[q]));
  if (p.P > 1) {
    // the parts' keys: the last block of this (row tile, segment) merges them
    for (int r = tid; r < nr; r += kThreads) {
      u64* pp = p.part + 2 * (((int64_t)sm.row[r] * S + s) * p.P + part);
      pp[0] = sm.key.k1[r];
      pp[1] = sm.key.k2[r];
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) sm.last = atomicAdd(p.done + (int64_t)s * Mt + tile, 1) == p.P - 1;
    __syncthreads();
    if (!sm.last) return;
    __threadfence();
    for (int r = tid; r < nr; r += kThreads) {
      const u64* pp = p.part + 2 * ((int64_t)sm.row[r] * S + s) * p.P;
      u64 m1 = kNone, m2 = kNone;
      for (int q = 0; q < p.P; ++q) merge2(m1, m2, __ldcg(pp + 2 * q), __ldcg(pp + 2 * q + 1));
      sm.key.k1[r] = m1;
      sm.key.k2[r] = m2;
    }
  }
  for (int r = tid; r < nr; r += kThreads)
    write_row<kMode>(p, S, s, sm.row[r], sm.key.k1[r], sm.key.k2[r]);
}

// the SM count of the current device, queried once per device
int sm_count() {
  static std::atomic<int> cached[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  int sms = cached[dev].load();
  if (sms == 0) {
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return 132;
    cached[dev].store(sms);
  }
  return sms;
}

// 2 (C_TC + g128) rounded up to float32
float filter_coef(float rel_err) {
  const double u = std::ldexp(1.0, -24), g128 = 128.0 * u / (1.0 - 128.0 * u);
  return std::nextafter(static_cast<float>(2.0 * (static_cast<double>(rel_err) + g128)),
                        INFINITY);
}

template <int kMode>
int launch(Params p, void* scratch, cudaStream_t st) {
  if (p.M <= 0) return 0;
  if (p.N <= 0 || p.seg <= 0 || p.N % p.seg != 0 || (kMode == kTop2 && p.seg < 2))
    return static_cast<int>(cudaErrorInvalidValue);
  // the opt-in to more than 48 KB of shared memory, and all of the SM's
  // unified memory as shared memory, so that two blocks fit an SM
  const void* kernel = reinterpret_cast<const void*>(&l2_match_kernel<kMode>);
  int room = 0;
  cudaError_t err = coop::smem_room(kernel, &room);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (room < static_cast<int>(sizeof(Smem))) return static_cast<int>(cudaErrorInvalidConfiguration);
  static std::atomic<bool> carved[64];
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess && dev >= 0 && dev < 64 && !carved[dev].load()) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    carved[dev].store(err == cudaSuccess);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int S = p.N / p.seg, Mt = (p.M + kTile - 1) / kTile;
  const long long pairs = 1LL * Mt * S, sms = sm_count();
  // K13: parts of at least kMinPart columns, as many as one wave of two
  // blocks an SM takes; K14: parts of at least a tile's share of the
  // segment, enough for the blocks to outnumber the SMs fourfold (blocks
  // past the valid rows have no work)
  const long long want = kMode == kTop2 ? (4 * sms + pairs - 1) / pairs : 2 * sms / pairs;
  int P = static_cast<int>(std::min<long long>(
      want, std::min(p.seg / (kMode == kTop2 ? kTile : kMinPart), kMaxParts)));
  p.P = kMode == kDebug ? 1 : std::max(P, 1);
  const long long blocks = pairs * p.P;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  p.chunk = (p.seg + p.P - 1) / p.P;
  if (scratch != nullptr) {
    p.part = static_cast<u64*>(scratch);
    p.done = reinterpret_cast<int*>(p.part + 2LL * p.M * S * kMaxParts);
  }
  if (p.P > 1) {
    err = cudaMemsetAsync(p.done, 0, sizeof(int) * pairs, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  l2_match_kernel<kMode><<<static_cast<unsigned>(blocks), kThreads, sizeof(Smem), st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a (M, 128) f32 with row_mask (M,) bool or null; b (N, 128) f32; rows
// 16-byte aligned and contiguous; rel_err the tensor-core product's
// allowed relative error (C_TC); outputs idx (M,) int32 (the first
// minimum's column, -1 where masked) and dmin (M,) f32 (the minimum);
// scratch: 8-byte aligned, 128 * M + 4 * ceil(M / 64) bytes; stats: 4
// uint64 counters added to (rows filtered, candidates, most candidates a
// row, rows rescanned) or null.
extern "C" int covins_l2_argmin(const void* a, const void* row_mask, int M, const void* b,
                                int N, float rel_err, void* idx, void* dmin, void* scratch,
                                void* stats, void* stream) {
  Params p{};
  p.a = static_cast<const float*>(a);
  p.a_mask = static_cast<const uint8_t*>(row_mask);
  p.M = M;
  p.b = static_cast<const float*>(b);
  p.N = N;
  p.seg = N;
  p.coef = filter_coef(rel_err);
  p.out0 = static_cast<int32_t*>(idx);
  p.out1 = static_cast<int32_t*>(dmin);
  p.stats = static_cast<u64*>(stats);
  return launch<kArgmin>(p, scratch, static_cast<cudaStream_t>(stream));
}

// a (M, 128) f32 and a_mask (M,) bool; b (N, 128) f32 and b_mask (N,)
// bool, rows 16-byte aligned and contiguous, N a multiple of seg >= 2;
// out: (3, M, N / seg) int32 (index within the segment or -1, d1 and d2
// as float32 bits); scratch: 8-byte aligned, 128 * M * (N / seg) + 4 *
// ceil(M / 64) * (N / seg) bytes; rel_err and stats as covins_l2_argmin's.
extern "C" int covins_l2_ratio_match(const void* a, const void* a_mask, int M, const void* b,
                                     const void* b_mask, int N, int seg, float max_dist,
                                     float ratio, float rel_err, void* out, void* scratch,
                                     void* stats, void* stream) {
  Params p{};
  p.a = static_cast<const float*>(a);
  p.a_mask = static_cast<const uint8_t*>(a_mask);
  p.M = M;
  p.b = static_cast<const float*>(b);
  p.b_mask = static_cast<const uint8_t*>(b_mask);
  p.N = N;
  p.seg = seg;
  p.max_dist = max_dist;
  p.ratio = ratio;
  p.coef = filter_coef(rel_err);
  p.stats = static_cast<u64*>(stats);
  if (seg > 0 && N % seg == 0) {
    const int64_t ms = static_cast<int64_t>(M) * (N / seg);
    p.out0 = static_cast<int32_t*>(out);
    p.out1 = p.out0 + ms;
    p.out2 = p.out1 + ms;
  }
  return launch<kTop2>(p, scratch, static_cast<cudaStream_t>(stream));
}

// The filter's value max(x~, 0) of every pair of a (M, 128) and b (N,
// 128) f32 into out (M, N) f32, from the same tile products as the two
// entries above: for checking the filter's error bound on the card.
extern "C" int covins_l2_filter_debug(const void* a, int M, const void* b, int N, void* out,
                                      void* stream) {
  Params p{};
  p.a = static_cast<const float*>(a);
  p.M = M;
  p.b = static_cast<const float*>(b);
  p.N = N;
  p.seg = N;
  p.dtilde = static_cast<float*>(out);
  return launch<kDebug>(p, nullptr, static_cast<cudaStream_t>(stream));
}
