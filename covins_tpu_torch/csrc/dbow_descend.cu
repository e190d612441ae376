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
// Design: a warp per descriptor (8 a block).  Lane 2 s + h holds slot s's
// half h: it reads the child id, then the child row's half as one 16-byte
// load, XORs it with the descriptor's half (read once into registers as
// four 32-bit words) and takes __popc of each word; one shuffle adds the
// two halves.  Each lane's key (distance << 4 | slot) goes into one warp
// minimum (__reduce_min_sync), so the lowest slot wins a tie, and the
// winning lane's child id is shuffled to the warp.  k <= 16 (the slot's 4
// bits, 2 k <= 32 lanes); node_desc and the descriptors 16-byte aligned:
// the wrapper checks both.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNoChild = 1u << 14;  // NO_CHILD_DIST of the plain version

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
  const int slot = lane >> 1;
  const int half = lane & 1;
  const bool in_slot = slot < k;
  const uint4 d = __ldg(descs + 2 * row + half);
  int32_t node = 0;
  for (int level = 0; level < L; ++level) {
    const int32_t child =
        in_slot ? __ldg(children + static_cast<long long>(node) * k + slot) : -1;
    const bool valid = child >= 0;
    unsigned part = 0;
    if (valid) {
      const uint4 c = __ldg(node_desc + 2 * static_cast<long long>(child) + half);
      part = __popc(c.x ^ d.x) + __popc(c.y ^ d.y) + __popc(c.z ^ d.z) + __popc(c.w ^ d.w);
    }
    const unsigned dist = part + __shfl_xor_sync(kFull, part, 1);
    const unsigned key =
        in_slot ? ((valid ? dist : kNoChild) << 4 | static_cast<unsigned>(slot)) : kFull;
    const unsigned best = __reduce_min_sync(kFull, key);
    if (!__any_sync(kFull, valid)) break;  // no child: stay (and on every later level)
    node = __shfl_sync(kFull, child, 2 * static_cast<int>(best & 15u));
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
  if (k < 1 || k > 16 || L < 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + kWarps - 1) / kWarps);
  dbow_descend_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(descs), static_cast<const uint8_t*>(mask), N,
      static_cast<const int32_t*>(children), static_cast<const uint4*>(node_desc),
      static_cast<const float*>(node_weight), static_cast<const int32_t*>(leaf_word_id),
      k, L, static_cast<int32_t*>(word_out), static_cast<float*>(weight_out));
  return static_cast<int>(cudaGetLastError());
}
