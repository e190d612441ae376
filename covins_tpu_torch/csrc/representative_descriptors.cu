// Min-median-Hamming representative descriptor per landmark.
//
// Replaces: covins_tpu/ops/landmark_ops.py::representative_descriptors
// (one XLA program in the JAX package: a vmapped (P, P) Hamming matmul,
// a row sort, a median gather and an argmin per landmark), which runs on
// every ingest window through Map.update_landmark_attributes.
//
// Bound on the H100: bytes.  Each landmark reads P*32 descriptor bytes and
// P mask bytes and writes 32 bytes; its P*P popcounts are a few hundred
// integer operations per byte moved at P = 16, far below what would make
// the arithmetic the limit.
//
// Simple design: one warp per landmark (P <= 32).  Lane p loads
// observation p (two uint4) and computes its row of P distances against
// every other observation, which it receives by warp shuffles.  Masked
// columns count as 1e9, as in the reference.  Instead of sorting the row,
// the lane selects the element of rank max((n_valid-1)/2, 0) by counting,
// for each entry, how many entries are smaller and how many are not
// larger (all loops unrolled over 32, so the row stays in registers).  A
// warp-shuffle argmin over the per-row medians, with the lowest lane
// winning ties, picks the observation to copy.  A landmark with no valid
// observation returns its row 0, as the reference does; the caller masks
// such landmarks out.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxP = 32;
constexpr int kWarps = 8;  // landmarks per block
constexpr int kBig = 1000000000;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(32 * kWarps)
representative_descriptors_kernel(const uint4* __restrict__ descs,
                                  const uint8_t* __restrict__ mask, int L,
                                  int P, uint32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int lm = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (lm >= L) return;  // the whole warp leaves together
  const bool in_range = lane < P;
  uint4 d0 = make_uint4(0u, 0u, 0u, 0u);
  uint4 d1 = d0;
  bool valid = false;
  if (in_range) {
    const int64_t obs = (int64_t)lm * P + lane;
    d0 = descs[2 * obs];
    d1 = descs[2 * obs + 1];
    valid = mask[obs] != 0;
  }
  const unsigned valid_bits = __ballot_sync(kFull, valid);
  const int n_valid = __popc(valid_bits);
  const int k = max((n_valid - 1) / 2, 0);

  int row[kMaxP];
#pragma unroll
  for (int q = 0; q < kMaxP; ++q) {
    uint4 c0, c1;
    c0.x = __shfl_sync(kFull, d0.x, q);
    c0.y = __shfl_sync(kFull, d0.y, q);
    c0.z = __shfl_sync(kFull, d0.z, q);
    c0.w = __shfl_sync(kFull, d0.w, q);
    c1.x = __shfl_sync(kFull, d1.x, q);
    c1.y = __shfl_sync(kFull, d1.y, q);
    c1.z = __shfl_sync(kFull, d1.z, q);
    c1.w = __shfl_sync(kFull, d1.w, q);
    const int d = __popc(d0.x ^ c0.x) + __popc(d0.y ^ c0.y) +
                  __popc(d0.z ^ c0.z) + __popc(d0.w ^ c0.w) +
                  __popc(d1.x ^ c1.x) + __popc(d1.y ^ c1.y) +
                  __popc(d1.z ^ c1.z) + __popc(d1.w ^ c1.w);
    // columns past P sort after every real entry, so they never reach
    // rank k < P
    row[q] = q >= P ? INT_MAX : (((valid_bits >> q) & 1u) ? d : kBig);
  }

  // element of rank k of the row: v with #(< v) <= k < #(<= v)
  int med = kBig;
#pragma unroll
  for (int q = 0; q < kMaxP; ++q) {
    const int v = row[q];
    int lt = 0, le = 0;
#pragma unroll
    for (int r = 0; r < kMaxP; ++r) {
      lt += row[r] < v;
      le += row[r] <= v;
    }
    if (lt <= k && k < le) med = v;
  }
  if (!valid) med = in_range ? kBig : INT_MAX;

  // warp argmin, lowest lane on ties
  int best = med, best_lane = lane;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int ov = __shfl_xor_sync(kFull, best, off);
    const int ol = __shfl_xor_sync(kFull, best_lane, off);
    if (ov < best || (ov == best && ol < best_lane)) {
      best = ov;
      best_lane = ol;
    }
  }

  const uint32_t words[8] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
  uint32_t mine = 0u;
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    const uint32_t v = __shfl_sync(kFull, words[t], best_lane);
    if (lane == t) mine = v;
  }
  if (lane < 8) out[(int64_t)lm * 8 + lane] = mine;
}

}  // namespace

// descs: (L, P, 32) u8, 16-byte aligned and contiguous; mask: (L, P) bool;
// out: (L, 32) u8.  1 <= P <= 32.
extern "C" int covins_representative_descriptors(const void* descs,
                                                 const void* mask, int L,
                                                 int P, void* out,
                                                 void* stream) {
  if (L <= 0) return 0;
  const dim3 grid((L + kWarps - 1) / kWarps);
  representative_descriptors_kernel<<<grid, 32 * kWarps, 0,
                                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(descs), static_cast<const uint8_t*>(mask), L,
      P, static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
