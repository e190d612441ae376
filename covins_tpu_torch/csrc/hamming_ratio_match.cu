// Masked top-2 Hamming matching with the ratio test, per column segment, with
// the distances formed on the tensor cores.
//
// Replaces: the COVINS-G verification's image matching,
// covins_tpu/ops/loopverify.py:488-505 (_covinsg_verify_impl):
// descriptors.py:58 hamming_distance_best + :103 masked_dist over the query
// rig x candidate rig descriptors, then per (query keyframe, candidate
// keyframe) block :114 knn2 and :124 match_ratio.  The top-2 epilogue sits
// on K1's product (hamming_argmin.cu), the port of the Pallas kernel
// hamming_pallas.py::hamming_distance_packed_T.
//
// Bound on the H100: M*N descriptor pairs of 256 bits each against M*32 +
// N*32 bytes in and 12 bytes a (row, segment) out, so operations: the same
// product as a +-1 int8 tensor-core matmul, 2*M*N*256 operations at the
// int8 rate.
//
// Design: K1's tile loop.  One mma.sync.m16n8k256 b1 AND+popc per 16 x 8
// tile gives popc(a & b) for a whole descriptor; the key (distance << 22 |
// column) folds distance and column into one unsigned value, so ties go to
// the lowest column in any order.  A block takes 32 rows and one part of
// one column segment: the grid is (row tile, segment, part), the parts
// (at most 8, at least 256 columns each) chosen so that the blocks
// outnumber the SMs fourfold where the rows and segments alone do not
// (2048 x 3072 in segments of 1024: 64 x 3 x 3 = 576 blocks).  Each
// thread keeps, per accumulator row, the two smallest keys of its part in
// registers (an insert is two mins and a max); the lanes of a quad and the
// warps sharing a row tile merge their pairs.  With one part the block
// writes index, d1 and d2 of each (row, segment); with more, it writes its
// pair to scratch, and the last block of a (row tile, segment) to finish
// (a counter per pair, zeroed before the launch) merges the parts' pairs,
// exact in any order, and writes the outputs.  The (M, N) matrix is never
// written.  A masked column is
// staged as zero words with the key part (512 << 22 | column), so its key
// is ((popc(a) + 512) << 22 | column): above every real key, and ordered
// by column among the masked, as the reference's sentinel 2^30 is.  Padded
// columns (a part's last tile rounded to 8) have a key part above that.
// Codes above 256 decode to 2^30.  The gate is float32, as the reference's
// weakly typed scalars make it: d1 < max_dist and d1 < ratio * d2.
//
// A second entry, covins_hamming_knn2, is the same kernel over one segment
// of all N columns with no masks and no gate: it writes both keys' columns
// and distances, each row's two nearest columns, ties to the lower column
// (replaces the +-1 dot_general and lax.top_k of
// covins_tpu/parallel/sharding.py:67 sharded_hamming_knn for k <= 2).

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRowTiles = 2;   // 16-row tiles a block
constexpr int kColSplits = 4;  // warps sharing one row tile's columns
constexpr int kWarps = kRowTiles * kColSplits;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kRowTiles;  // query rows a block
constexpr int kTileN = 1024;           // columns a shared-memory tile
constexpr int kColBits = 22;           // key = distance << kColBits | column
constexpr unsigned kColMask = (1u << kColBits) - 1u;
constexpr unsigned kMaskedPart = 512u << kColBits;           // | column
constexpr unsigned kPadPart = (767u << kColBits) | kColMask;  // above masked
constexpr int kBig = 1 << 30;  // the reference's sentinel (descriptors.py:100)
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxParts = 8;      // column parts a segment at most
constexpr int kMinPart = 256;     // columns a part at least

__device__ __forceinline__ void mma_and_popc(unsigned (&d)[4], const unsigned (&a)[4],
                                             unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "r"(0), "r"(0), "r"(0), "r"(0));
}

// (b1, b2) the two smallest keys so far, b1 <= b2; insert x
__device__ __forceinline__ void insert(unsigned& b1, unsigned& b2, unsigned x) {
  b2 = min(max(b1, x), b2);
  b1 = min(b1, x);
}

// merge the pair (c1, c2) into (b1, b2)
__device__ __forceinline__ void merge(unsigned& b1, unsigned& b2, unsigned c1, unsigned c2) {
  b2 = min(max(b1, c1), min(b2, c2));
  b1 = min(b1, c1);
}

__device__ __forceinline__ void quad_merge(unsigned& b1, unsigned& b2) {
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    const unsigned c1 = __shfl_xor_sync(kFull, b1, o);
    const unsigned c2 = __shfl_xor_sync(kFull, b2, o);
    merge(b1, b2, c1, c2);
  }
}

__device__ __forceinline__ int decode(unsigned key) {
  const int code = static_cast<int>(key >> kColBits);
  return code <= 256 ? code : kBig;
}

// the outputs of one (row, segment) from its two smallest keys
__device__ __forceinline__ void write_match(const uint8_t* a_mask, int M, int S, int s, int seg,
                                            int row, unsigned k1, unsigned k2, float max_dist,
                                            float ratio, int32_t* out) {
  int idx = -1, d1 = kBig, d2 = kBig;
  if (a_mask[row] != 0) {
    d1 = decode(k1);
    d2 = decode(k2);
    const float f1 = static_cast<float>(d1), f2 = static_cast<float>(d2);
    if (f1 < max_dist && f1 < __fmul_rn(ratio, f2))
      idx = static_cast<int>(k1 & kColMask) - s * seg;
  }
  const int64_t o = (int64_t)row * S + s;
  out[o] = idx;
  out[(int64_t)M * S + o] = d1;
  out[2 * (int64_t)M * S + o] = d2;
}

// knn2: the two nearest columns of a row and their distances, out (2, M, 2):
// columns, then distances
__device__ __forceinline__ void write_knn2(int M, int row, unsigned k1, unsigned k2,
                                           int32_t* out) {
  out[2 * (int64_t)row] = static_cast<int>(k1 & kColMask);
  out[2 * (int64_t)row + 1] = static_cast<int>(k2 & kColMask);
  out[2 * (int64_t)M + 2 * (int64_t)row] = decode(k1);
  out[2 * (int64_t)M + 2 * (int64_t)row + 1] = decode(k2);
}

// with knn (a_mask and b_mask null, seg = N): write_knn2 instead of the gate
__global__ void __launch_bounds__(kThreads)
hamming_ratio_match_kernel(const unsigned* __restrict__ a, const uint8_t* __restrict__ a_mask,
                           int M, const unsigned* __restrict__ b,
                           const uint8_t* __restrict__ b_mask, int N, int seg, int P,
                           int chunk, float max_dist, float ratio, int knn,
                           int32_t* __restrict__ out, unsigned* __restrict__ part,
                           int* __restrict__ done) {
  __shared__ uint2 sb[4 * kTileN];   // word pairs (k, k + 4), k = 0..3, of each column
  __shared__ unsigned skey[kTileN];  // key part: popc(b) << kColBits | column
  __shared__ unsigned sbest[2][kColSplits][kRows];
  __shared__ int last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rt = warp % kRowTiles, cs = warp / kRowTiles;
  const int S = N / seg, Mt = (M + kRows - 1) / kRows;
  // blocks of one column part are consecutive: (segment, part) major
  const int tile = blockIdx.x % Mt, sp = blockIdx.x / Mt;
  const int s = sp / P, p = sp % P;
  const int row_a = tile * kRows + rt * 16 + g, row_b = row_a + 8;

  // A fragment: rows row_a (a0, a2) and row_b (a1, a3), words t and t + 4
  unsigned fa[4] = {0u, 0u, 0u, 0u};
  if (row_a < M) {
    fa[0] = a[8 * (int64_t)row_a + t];
    fa[2] = a[8 * (int64_t)row_a + t + 4];
  }
  if (row_b < M) {
    fa[1] = a[8 * (int64_t)row_b + t];
    fa[3] = a[8 * (int64_t)row_b + t + 4];
  }
  int pa = __popc(fa[0]) + __popc(fa[2]), pb = __popc(fa[1]) + __popc(fa[3]);
  pa += __shfl_xor_sync(kFull, pa, 1);
  pa += __shfl_xor_sync(kFull, pa, 2);
  pb += __shfl_xor_sync(kFull, pb, 1);
  pb += __shfl_xor_sync(kFull, pb, 2);
  const unsigned ka = static_cast<unsigned>(pa) << kColBits;
  const unsigned kb = static_cast<unsigned>(pb) << kColBits;

  // this block's columns [c_lo, c_hi) of segment s
  const int c_lo = s * seg + min(seg, p * chunk);
  const int c_hi = s * seg + min(seg, (p + 1) * chunk);
  unsigned a1 = kFull, a2 = kFull, b1 = kFull, b2 = kFull;
  for (int c_base = c_lo; c_base < c_hi; c_base += kTileN) {
    const int n = min(kTileN, c_hi - c_base);
    const int n8 = (n + 7) & ~7;
    __syncthreads();  // the previous tile is read
    // four lanes a column (whole warps: 4 * n8 is a multiple of 32)
    for (int i = threadIdx.x; i < 4 * n8; i += kThreads) {
      const int j = i >> 2, k = i & 3;
      const bool real = j < n;
      const bool valid = real && (knn || b_mask[c_base + j] != 0);
      unsigned lo = 0u, hi = 0u;
      if (valid) {
        lo = b[8 * (int64_t)(c_base + j) + k];
        hi = b[8 * (int64_t)(c_base + j) + k + 4];
      }
      sb[i] = make_uint2(lo, hi);
      int pc = __popc(lo) + __popc(hi);
      pc += __shfl_xor_sync(kFull, pc, 1);
      pc += __shfl_xor_sync(kFull, pc, 2);
      if (k == 0) {
        const unsigned col = static_cast<unsigned>(c_base + j);
        skey[j] = !real ? kPadPart
                        : (valid ? (static_cast<unsigned>(pc) << kColBits) | col
                                 : kMaskedPart | col);
      }
    }
    __syncthreads();
    for (int c0 = 8 * cs; c0 < n8; c0 += 8 * kColSplits) {
      const uint2 fb = sb[4 * (c0 + g) + t];  // column c0 + g, words t and t + 4
      unsigned and_popc[4];
      mma_and_popc(and_popc, fa, fb.x, fb.y);
      // accumulator: (row_a, c0 + 2t), (row_a, c0 + 2t + 1), then row_b
      const uint2 kp = *reinterpret_cast<const uint2*>(&skey[c0 + 2 * t]);
      insert(a1, a2, ka + kp.x - (and_popc[0] << (kColBits + 1)));
      insert(a1, a2, ka + kp.y - (and_popc[1] << (kColBits + 1)));
      insert(b1, b2, kb + kp.x - (and_popc[2] << (kColBits + 1)));
      insert(b1, b2, kb + kp.y - (and_popc[3] << (kColBits + 1)));
    }
  }
  quad_merge(a1, a2);
  quad_merge(b1, b2);
  if (t == 0) {
    sbest[0][cs][rt * 16 + g] = a1;
    sbest[1][cs][rt * 16 + g] = a2;
    sbest[0][cs][rt * 16 + g + 8] = b1;
    sbest[1][cs][rt * 16 + g + 8] = b2;
  }
  __syncthreads();
  const int row = tile * kRows + threadIdx.x;
  unsigned k1 = kFull, k2 = kFull;
  if (threadIdx.x < kRows) {
    k1 = sbest[0][0][threadIdx.x];
    k2 = sbest[1][0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < kColSplits; ++w)
      merge(k1, k2, sbest[0][w][threadIdx.x], sbest[1][w][threadIdx.x]);
  }
  if (P == 1) {
    if (threadIdx.x < kRows && row < M) {
      if (knn)
        write_knn2(M, row, k1, k2, out);
      else
        write_match(a_mask, M, S, s, seg, row, k1, k2, max_dist, ratio, out);
    }
    return;
  }
  // the parts' pairs: the last block of this (row tile, segment) merges them
  if (threadIdx.x < kRows && row < M) {
    unsigned* pp = part + 2 * (((int64_t)row * S + s) * P + p);
    pp[0] = k1;
    pp[1] = k2;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(done + (int64_t)s * Mt + tile, 1) == P - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (threadIdx.x < kRows && row < M) {
    const unsigned* pp = part + 2 * ((int64_t)row * S + s) * P;
    k1 = kFull;
    k2 = kFull;
    for (int q = 0; q < P; ++q) merge(k1, k2, __ldcg(pp + 2 * q), __ldcg(pp + 2 * q + 1));
    if (knn)
      write_knn2(M, row, k1, k2, out);
    else
      write_match(a_mask, M, S, s, seg, row, k1, k2, max_dist, ratio, out);
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

}  // namespace

namespace {

int launch(const void* a, const void* a_mask, int M, const void* b, const void* b_mask, int N,
           int seg, float max_dist, float ratio, int knn, void* out, void* scratch,
           void* stream) {
  if (M <= 0) return 0;
  if (N <= 0 || N > static_cast<int>(kColMask) || seg <= 0 || N % seg != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int S = N / seg, Mt = (M + kRows - 1) / kRows;
  const long long pairs = 1LL * Mt * S;
  const long long target = 4LL * sm_count();
  int P = 1;
  if (pairs < target)
    P = static_cast<int>(std::min<long long>((target + pairs - 1) / pairs,
                                             std::min(seg / kMinPart, kMaxParts)));
  P = std::max(P, 1);
  const long long blocks = pairs * P;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int chunk = (seg + P - 1) / P;
  unsigned* part = static_cast<unsigned*>(scratch);
  int* done = reinterpret_cast<int*>(part + 2LL * M * S * kMaxParts);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (P > 1) {
    const cudaError_t err = cudaMemsetAsync(done, 0, sizeof(int) * pairs, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  hamming_ratio_match_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      static_cast<const unsigned*>(a), static_cast<const uint8_t*>(a_mask), M,
      static_cast<const unsigned*>(b), static_cast<const uint8_t*>(b_mask), N, seg, P, chunk,
      max_dist, ratio, knn, static_cast<int32_t*>(out), part, done);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a: (M, 32) u8 and a_mask (M,) bool; b: (N, 32) u8 and b_mask (N,) bool,
// descriptors 4-byte aligned and contiguous, 0 < N < 2^22, N a multiple of
// seg; out: (3, M, N / seg) int32 (index within the segment or -1, d1, d2);
// scratch: (2 * M * (N / seg) * 8 + ceil(M / 32) * (N / seg),) int32.
extern "C" int covins_hamming_ratio_match(const void* a, const void* a_mask, int M,
                                          const void* b, const void* b_mask, int N,
                                          int seg, float max_dist, float ratio,
                                          void* out, void* scratch, void* stream) {
  return launch(a, a_mask, M, b, b_mask, N, seg, max_dist, ratio, 0, out, scratch, stream);
}

// a: (M, 32) u8, b: (N, 32) u8 as above, 2 <= N < 2^22; out: (2, M, 2)
// int32 (each row's nearest and second-nearest column, then their
// distances); scratch: (2 * M * 8 + ceil(M / 32),) int32.
extern "C" int covins_hamming_knn2(const void* a, int M, const void* b, int N, void* out,
                                   void* scratch, void* stream) {
  if (M > 0 && N < 2) return static_cast<int>(cudaErrorInvalidValue);
  return launch(a, nullptr, M, b, nullptr, N, N, 0.0f, 0.0f, 1, out, scratch, stream);
}
