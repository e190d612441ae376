// K16: DBoW2 vocabulary-tree descent, one warp a descriptor.
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
// peak.  At ORBvoc's shape (k = 10, L = 6) the descent is L dependent
// rounds of two dependent gathers (the child ids, then their rows): the
// upper levels stay in the 50 MB L2, each deeper level costs a trip to
// device memory.
//
// Design: a warp per descriptor (8 a block).  The k slots of a node are
// taken 16 at a time: in round q, lane 2 s + h holds slot 16 q + s's half
// h: it reads the child id, then the child row's half as one 16-byte load,
// XORs it with the descriptor's half (read once into registers as four
// 32-bit words) and takes __popc of each word; one shuffle adds the two
// halves.  Each lane keeps the least key (distance << 17 | slot) of its
// rounds and that slot's child id (a running minimum); one warp minimum
// (__reduce_min_sync) of the keys then picks the child, so the lowest slot
// wins a tie, and the lane of the winning slot (2 (slot mod 16)) shuffles
// its child id to the warp; least keys all NO_CHILD mean no child.  A
// node of at most 16 slots takes one round in its own instance of the
// kernel, with no round loop (a loop cost ~20-28% at ORBvoc's shape).  The
// key's 15 distance bits hold NO_CHILD (1 << 14) and its 17 slot bits
// k <= 131072 (MAX_BRANCHING of the wrapper); node_desc and the
// descriptors 16-byte aligned: the wrapper checks both.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNoChild = 1u << 14;  // NO_CHILD_DIST of the plain version
constexpr int kSlotBits = 17;            // key = distance << kSlotBits | slot
constexpr int kMaxK = 1 << kSlotBits;
constexpr int kSlotsPerRound = 16;       // two lanes a slot

// the key (distance << kSlotBits | slot) of one lane's slot of ``node``, and
// its child id in ``child``: an empty slot counts kNoChild, a slot past k
// gives kFull; both lanes of a slot get the whole distance
__device__ __forceinline__ unsigned slot_key(const int32_t* __restrict__ children,
                                             const uint4* __restrict__ node_desc, uint4 d,
                                             int32_t node, int k, int slot, int half,
                                             int32_t& child) {
  const bool in_slot = slot < k;
  child = in_slot ? __ldg(children + static_cast<long long>(node) * k + slot) : -1;
  const bool valid = child >= 0;
  unsigned part = 0;
  if (valid) {
    const uint4 c = __ldg(node_desc + 2 * static_cast<long long>(child) + half);
    part = __popc(c.x ^ d.x) + __popc(c.y ^ d.y) + __popc(c.z ^ d.z) + __popc(c.w ^ d.w);
  }
  const unsigned dist = part + __shfl_xor_sync(kFull, part, 1);
  return in_slot ? ((valid ? dist : kNoChild) << kSlotBits | static_cast<unsigned>(slot))
                 : kFull;
}

// kWide: k > 16, the slots in rounds (a node of at most 16 slots takes one
// round, with no loop left in the kernel)
template <bool kWide>
__global__ void __launch_bounds__(kThreads)
dbow_descend_kernel(const uint4* __restrict__ descs, const uint8_t* __restrict__ mask,
                    int N, const int32_t* __restrict__ children,
                    const uint4* __restrict__ node_desc,
                    const float* __restrict__ node_weight,
                    const int32_t* __restrict__ leaf_word_id, int k, int L,
                    int32_t* __restrict__ word_out, float* __restrict__ weight_out) {
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= N) return;  // the whole warp
  if (mask != nullptr && mask[row] == 0) {
    if (lane == 0) {
      word_out[row] = -1;
      weight_out[row] = 0.0f;
    }
    return;
  }
  const int half = lane & 1;
  const uint4 d = __ldg(descs + 2 * row + half);
  int32_t node = 0;
  for (int level = 0; level < L; ++level) {
    // this lane's least key over its rounds and that slot's child; slots
    // rise with the rounds, so the first least key stays
    int32_t child;
    unsigned key = slot_key(children, node_desc, d, node, k, lane >> 1, half, child);
    if constexpr (kWide) {
      for (int base = kSlotsPerRound; base < k; base += kSlotsPerRound) {
        int32_t c;
        const unsigned kk =
            slot_key(children, node_desc, d, node, k, base + (lane >> 1), half, c);
        if (kk < key) {
          key = kk;
          child = c;
        }
      }
    }
    const unsigned best = __reduce_min_sync(kFull, key);
    // no child: stay (and on every later level)
    if (!__any_sync(kFull, (key >> kSlotBits) < kNoChild)) break;
    // slot s lies on lane 2 (s mod 16), whose least key is best
    node = __shfl_sync(kFull, child, 2 * static_cast<int>(best & (kSlotsPerRound - 1)));
  }
  if (lane == 0) {
    word_out[row] = __ldg(leaf_word_id + node);
    weight_out[row] = __ldg(node_weight + node);
  }
}

}  // namespace

extern "C" int covins_dbow_descend(const void* descs, const void* mask, int N,
                                   const void* children, const void* node_desc,
                                   const void* node_weight, const void* leaf_word_id,
                                   int k, int L, void* word_out, void* weight_out,
                                   void* stream) {
  if (N <= 0) return 0;
  if (k < 1 || k > kMaxK || L < 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + kWarps - 1) / kWarps);
  auto kernel = k > kSlotsPerRound ? dbow_descend_kernel<true> : dbow_descend_kernel<false>;
  kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(descs), static_cast<const uint8_t*>(mask), N,
      static_cast<const int32_t*>(children), static_cast<const uint4*>(node_desc),
      static_cast<const float*>(node_weight), static_cast<const int32_t*>(leaf_word_id),
      k, L, static_cast<int32_t*>(word_out), static_cast<float*>(weight_out));
  return static_cast<int>(cudaGetLastError());
}
