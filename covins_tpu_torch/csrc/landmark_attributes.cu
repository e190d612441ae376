// The landmark-attribute refresh of a cohort in one launch: per landmark
// its representative descriptor, mean viewing direction and distance range.
//
// Replaces: covins_tpu/ops/landmark_ops.py::representative_descriptors
// (line 22: a vmapped (P, P) Hamming matmul, a row sort, a median gather
// and an argmin per landmark), ::distance_invariance (:54) and
// ::landmark_normals (:82), the three programs that
// covins_tpu/models/map_store.py::update_landmark_attributes dispatches on
// every ingest window and for every GBA write-back.
//
// Bound on the H100: bytes.  Each landmark reads P*32 descriptor bytes, P
// mask bytes and (3 + 4P) float64 values and writes 72 bytes; its P*P
// popcounts and ~30 float64 operations per observation are far below what
// would make the arithmetic the limit.
//
// Design: one warp per landmark (P <= 32), lane p holding observation p.
// The descriptor: lane p computes its row of P Hamming distances against
// every other observation, received by warp shuffles; masked columns count
// as 1e9, as in the reference.  Instead of sorting the row, the lane
// selects the element of rank max((n_valid-1)/2, 0) by counting, for each
// entry, how many entries are smaller and how many are not larger (loops
// unrolled over 32, so the row stays in registers).  A warp-shuffle argmin
// over the per-row medians, lowest lane on ties, picks the observation to
// copy; a landmark with no valid observation returns its row 0, as the
// reference does (the caller masks such landmarks out).  The normal and the
// range: lane p forms its unit direction and its distance estimate, masked
// to 0, and every lane sums them in observation order by shuffles, so the
// float64 sums have one fixed order, the one the plain version
// (ops/landmark_ops.py::landmark_attributes_plain) writes out; the build
// keeps FMA contraction off.  Without the float inputs the kernel computes
// the descriptor alone (landmark_ops.representative_descriptors).

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxP = 32;
constexpr int kWarps = 8;  // landmarks per block
constexpr int kBig = 1000000000;
constexpr unsigned kFull = 0xffffffffu;

// torch.clamp(x, min=lo): NaN stays NaN
__device__ inline double clamp_min(double x, double lo) { return x < lo ? lo : x; }

__global__ void __launch_bounds__(32 * kWarps)
landmark_attributes_kernel(const double* __restrict__ pos, const double* __restrict__ centers,
                           const double* __restrict__ octaves,
                           const uint4* __restrict__ descs, const uint8_t* __restrict__ mask,
                           int L, int P, double scale_factor, double top_scale,
                           double* __restrict__ out_f, uint32_t* __restrict__ out_desc) {
  const int lane = threadIdx.x & 31;
  const int lm = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (lm >= L) return;  // the whole warp leaves together
  const bool in_range = lane < P;
  const int64_t obs = (int64_t)lm * P + lane;
  uint4 d0 = make_uint4(0u, 0u, 0u, 0u);
  uint4 d1 = d0;
  bool valid = false;
  if (in_range) {
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
  if (lane < 8) out_desc[(int64_t)lm * 8 + lane] = mine;
  if (out_f == nullptr) return;

  // this observation's unit direction (landmark -> camera) and distance
  // estimate d * sf^octave, both times its mask
  const double w = valid ? 1.0 : 0.0;
  double ux = 0.0, uy = 0.0, uz = 0.0, est = 0.0;
  if (in_range) {
    const double dx = centers[3 * obs] - pos[3 * lm];
    const double dy = centers[3 * obs + 1] - pos[3 * lm + 1];
    const double dz = centers[3 * obs + 2] - pos[3 * lm + 2];
    const double n = sqrt((dx * dx + dy * dy) + dz * dz);
    const double nc = clamp_min(n, 1e-12);
    ux = (dx / nc) * w;
    uy = (dy / nc) * w;
    uz = (dz / nc) * w;
    est = (n * pow(scale_factor, octaves[obs])) * w;
  }
  // sums in observation order
  double sx = 0.0, sy = 0.0, sz = 0.0, cnt = 0.0, se = 0.0;
  for (int q = 0; q < P; ++q) {
    sx = sx + __shfl_sync(kFull, ux, q);
    sy = sy + __shfl_sync(kFull, uy, q);
    sz = sz + __shfl_sync(kFull, uz, q);
    cnt = cnt + __shfl_sync(kFull, w, q);
    se = se + __shfl_sync(kFull, est, q);
  }
  const double cc = clamp_min(cnt, 1.0);
  const double mx = sx / cc, my = sy / cc, mz = sz / cc;
  const double mn = clamp_min(sqrt((mx * mx + my * my) + mz * mz), 1e-12);
  const double max_dist = se / cc;
  const bool has = cnt > 0.0;
  const double vals[5] = {mx / mn, my / mn, mz / mn, has ? max_dist / top_scale : 0.0,
                          has ? max_dist : 0.0};
  double v = 0.0;
#pragma unroll
  for (int t = 0; t < 5; ++t)
    if (lane == t) v = vals[t];
  if (lane < 5) out_f[(int64_t)lm * 5 + lane] = v;
}

}  // namespace

// pos (L, 3), centers (L, P, 3), octaves (L, P) float64; descs (L, P, 32)
// u8, 16-byte aligned; mask (L, P) bytes; 1 <= P <= 32.  Outputs: out_f
// (L, 5) float64 [normal (3), min_dist, max_dist], out_desc (L, 32) u8.
// With pos, centers, octaves and out_f null, the descriptors alone.
extern "C" int covins_landmark_attributes(const void* pos, const void* centers,
                                          const void* octaves, const void* descs,
                                          const void* mask, int L, int P,
                                          double scale_factor, double top_scale, void* out_f,
                                          void* out_desc, void* stream) {
  if (L <= 0) return 0;
  const dim3 grid((L + kWarps - 1) / kWarps);
  landmark_attributes_kernel<<<grid, 32 * kWarps, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(pos), static_cast<const double*>(centers),
      static_cast<const double*>(octaves), static_cast<const uint4*>(descs),
      static_cast<const uint8_t*>(mask), L, P, scale_factor, top_scale,
      static_cast<double*>(out_f), static_cast<uint32_t*>(out_desc));
  return static_cast<int>(cudaGetLastError());
}
