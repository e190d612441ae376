// K16: DBoW2 vocabulary-tree descent over a child-block table.
//
// Replaces: covins_tpu/ops/dbow_import.py::HierVocabulary.assign (line 54;
// the jax.vmap of :83 over the descent of :70-81).  Each (32-byte) ORB
// descriptor starts at the root, node 0, and L times moves to the child of
// least 256-bit Hamming distance: an empty slot (-1) counts 1 << 14, the
// first (lowest) slot wins a tie, as jnp.argmin, and a node with no child
// keeps the descriptor where it is.  The result is the node's word id (-1
// for an inner node, as the JAX code returns it) and weight; a masked row
// gives (-1, 0.0).  Integers and one gathered float: bit for bit with the
// plain version (ops/dbow_import.py::dbow_descend_plain).
//
// Bound on the H100: bytes, and in practice latency.  The distinct bytes a
// call needs are the descriptors in, the ids and weights out, and for each
// node that some descent visits its children's ids and 32-byte rows; the
// popcounts are some 30 integer operations a child, far below any compute
// peak.  At ORBvoc's shape (k = 10, L = 6) a descent is L dependent rounds
// of loads; the upper levels stay in the 50 MB L2, each deeper level costs
// a trip to device memory.
//
// Design (the second; the first, a warp a descriptor, read a node's child
// ids and then, depending on them, the children's rows: two dependent
// gathers a level, with 20 of 32 lanes busy at k = 10):
//  - A child-block table (ops/dbow_import.py::child_blocks, built once per
//    device): the inner nodes (those with a child) numbered level by
//    level, and for each its k children's 32-byte rows in slot order
//    (`rows`, zeros for an empty slot) and their codes (`nxt`): the child's
//    inner number, ~node for a child without children, or kEmpty.  A level
//    is one round of loads that depend only on the current inner number.
//  - Two instances.  kWarp: a warp a descriptor, lane 2 s + h holding slot
//    16 q + s's half h in round q (one round for k <= 16), a running
//    minimum of keys (distance << 17 | slot) and one warp minimum
//    (__reduce_min_sync).  kGroups, for k <= 16: a lane takes one slot's
//    whole row (two 16-byte loads), so a warp carries floor(32 / k)
//    descriptors (3 at k = 10), each in a group of k lanes whose least key
//    is found by cyclic shuffles within the group.  The groups issue about
//    a third fewer instructions a descriptor, and at ORBvoc's shape the
//    kernel is bound by the SMs' issue and load latency rather than by
//    bytes (with every block in L1 a descent costs nearly as much), so
//    kGroups takes the calls of more descriptors than the card holds warps
//    at once; kWarp, with three times the warps in flight, the rest.
//  - Tried and measured slower at ORBvoc's shape (NVIDIA H100 80GB HBM3):
//    the upper levels staged in shared memory by persistent blocks (the
//    staging costs more than the L1 hits it replaces), two descriptors
//    interleaved in a warp, and the table's deep levels read past L1.
// The key's 15 distance bits hold NO_CHILD (1 << 14) and its 17 slot bits
// k <= 131072 (MAX_BRANCHING of the wrapper); the descriptors and the
// table's rows 16-byte aligned: the wrapper checks both.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "coop_launch.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNoChild = 1u << 14;  // NO_CHILD_DIST of the plain version
constexpr int kSlotBits = 17;            // key = distance << kSlotBits | slot
constexpr unsigned kSlotMask = (1u << kSlotBits) - 1u;
constexpr int kMaxK = 1 << kSlotBits;
constexpr int kSlotsPerRound = 16;       // kWarp: two lanes a slot
constexpr int32_t kEmpty = INT32_MIN;    // the code of an empty slot

struct Args {
  const uint4* descs;     // (N, 2)
  const uint8_t* mask;    // (N,) or null
  int N;
  const uint4* rows;      // (n_inner * k, 2): each inner node's children's rows
  const int32_t* nxt;     // (n_inner, k): their codes
  const int32_t* node_of; // (n_inner,): each inner number's node id
  const float* node_weight;
  const int32_t* leaf_word_id;
  int k, L, root;
  int32_t* word_out;
  float* weight_out;
};

__device__ __forceinline__ unsigned popc_xor(uint4 a, uint4 b) {
  return __popc(a.x ^ b.x) + __popc(a.y ^ b.y) + __popc(a.z ^ b.z) + __popc(a.w ^ b.w);
}

// the end of a descent: the node its last code names, its word and weight;
// a masked row (-1, 0.0)
__device__ __forceinline__ void write_end(const Args& p, long long row, bool live,
                                          int32_t cur) {
  if (!live) {
    p.word_out[row] = -1;
    p.weight_out[row] = 0.0f;
    return;
  }
  const int32_t node = cur >= 0 ? __ldg(p.node_of + cur) : ~cur;
  p.word_out[row] = __ldg(p.leaf_word_id + node);
  p.weight_out[row] = __ldg(p.node_weight + node);
}

// kWarp: a warp a descriptor, the slots in rounds of 16 (kRounds: k > 16)
template <bool kRounds>
__global__ void __launch_bounds__(kThreads) descend_warp(Args p) {
  const int lane = threadIdx.x & 31, half = lane & 1, s = lane >> 1;
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= p.N) return;  // the whole warp
  const int k = p.k;
  const bool live = p.mask == nullptr || p.mask[row] != 0;
  int32_t cur = p.root;
  if (live) {
    const uint4 d = __ldg(p.descs + 2 * row + half);
    for (int level = 0; level < p.L && cur >= 0; ++level) {
      // this lane's least key over its rounds and that slot's code (kFull
      // past k); slots rise with the rounds, so the first least key stays
      unsigned key = kFull;
      int32_t code = kEmpty;
      for (int q0 = 0; q0 < (kRounds ? k : 1); q0 += kSlotsPerRound) {
        const int slot = q0 + s;
        const bool in_slot = slot < k;
        const unsigned at = static_cast<unsigned>(cur) * k + slot;
        int32_t c = kEmpty;
        unsigned part = 0;
        if (in_slot) {
          c = __ldg(p.nxt + at);
          part = popc_xor(__ldg(p.rows + 2ull * at + half), d);
        }
        const unsigned dist = part + __shfl_xor_sync(kFull, part, 1);
        const unsigned kk =
            in_slot ? ((c == kEmpty ? kNoChild : dist) << kSlotBits | static_cast<unsigned>(slot))
                    : kFull;
        if (kk < key) {
          key = kk;
          code = c;
        }
      }
      const unsigned best = __reduce_min_sync(kFull, key);
      if ((best >> kSlotBits) >= kNoChild) break;  // no child: stay
      // slot b lies on lane 2 (b mod 16), whose least key is best
      cur = __shfl_sync(kFull, code, 2 * static_cast<int>(best & (kSlotsPerRound - 1)));
    }
  }
  if (lane == 0) write_end(p, row, live, cur);
}

// kGroups: k <= 16, floor(32 / k) descriptors a warp, a group of k lanes each
__global__ void __launch_bounds__(kThreads) descend_groups(Args p) {
  const int k = p.k;
  const int lane = threadIdx.x & 31;
  const int groups = 32 / k;
  const int g = lane / k, s = lane - g * k;
  const bool on = g < groups;
  const int base = on ? g * k : lane;  // an idle lane shuffles with itself
  const long long row =
      (static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5)) * groups + g;
  if (row - g >= p.N) return;  // the whole warp
  const bool in_row = on && row < p.N;
  const bool live = in_row && (p.mask == nullptr || p.mask[row] != 0);
  uint4 d0 = make_uint4(0u, 0u, 0u, 0u), d1 = d0;
  if (live) {
    d0 = __ldg(p.descs + 2 * row);
    d1 = __ldg(p.descs + 2 * row + 1);
  }
  int32_t cur = p.root;
  bool moving = live && cur >= 0;
  for (int level = 0; level < p.L; ++level) {
    if (!__any_sync(kFull, moving)) break;
    unsigned key = kFull;
    int32_t code = kEmpty;
    if (moving) {
      const unsigned at = static_cast<unsigned>(cur) * k + s;
      code = __ldg(p.nxt + at);
      const unsigned dist =
          popc_xor(__ldg(p.rows + 2ull * at), d0) + popc_xor(__ldg(p.rows + 2ull * at + 1), d1);
      key = (code == kEmpty ? kNoChild : dist) << kSlotBits | static_cast<unsigned>(s);
    }
    // the group's least key: each lane the least over 2 w cyclically
    // consecutive slots of its group, w doubling until 2 w >= k
    for (int w = 1; w < k; w <<= 1) {
      const int t = s + w;
      const int src = on ? base + (t < k ? t : t - k) : lane;
      key = min(key, __shfl_sync(kFull, key, src));
    }
    // the winning slot's lane (any lane where the group is not moving)
    const int src = moving ? base + static_cast<int>(key & kSlotMask) : lane;
    const int32_t next = __shfl_sync(kFull, code, src);
    if (moving) {
      if ((key >> kSlotBits) >= kNoChild) {
        moving = false;  // no child: stay
      } else {
        cur = next;
        moving = cur >= 0;
      }
    }
  }
  if (in_row && s == 0) write_end(p, row, live, cur);
}

}  // namespace

// descs: (N, 32) uint8, 16-byte aligned; mask: (N,) bool or null; rows:
// (n_inner * k, 32) uint8, 16-byte aligned, nxt: (n_inner, k) int32,
// node_of: (n_inner,) int32, the child-block table (n_inner * k < 2^31);
// root: the root's code.  Returns 0 or the CUDA error.
extern "C" int covins_dbow_descend(const void* descs, const void* mask, int N, const void* rows,
                                   const void* nxt, const void* node_of, int n_inner,
                                   const void* node_weight, const void* leaf_word_id, int k,
                                   int L, int root, void* word_out, void* weight_out,
                                   void* stream) {
  if (N <= 0) return 0;
  if (k < 1 || k > kMaxK || L < 0 || n_inner < 0 || 1LL * n_inner * k >= (1LL << 31) ||
      root >= n_inner)
    return static_cast<int>(cudaErrorInvalidValue);
  Args p;
  p.descs = static_cast<const uint4*>(descs);
  p.mask = static_cast<const uint8_t*>(mask);
  p.N = N;
  p.rows = static_cast<const uint4*>(rows);
  p.nxt = static_cast<const int32_t*>(nxt);
  p.node_of = static_cast<const int32_t*>(node_of);
  p.node_weight = static_cast<const float*>(node_weight);
  p.leaf_word_id = static_cast<const int32_t*>(leaf_word_id);
  p.k = k;
  p.L = L;
  p.root = root;
  p.word_out = static_cast<int32_t*>(word_out);
  p.weight_out = static_cast<float*>(weight_out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k > kSlotsPerRound) {
    descend_warp<true><<<(N + kWarps - 1) / kWarps, kThreads, 0, st>>>(p);
    return static_cast<int>(cudaGetLastError());
  }
  // a warp a descriptor while they fit the card at once, else the groups
  int resident = 0;
  const cudaError_t err = coop::co_resident(reinterpret_cast<const void*>(descend_warp<false>),
                                            kThreads, 0, &resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (N <= 1LL * resident * kWarps) {
    descend_warp<false><<<(N + kWarps - 1) / kWarps, kThreads, 0, st>>>(p);
  } else {
    const int per_block = kWarps * (32 / k);
    descend_groups<<<(N + per_block - 1) / per_block, kThreads, 0, st>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}
