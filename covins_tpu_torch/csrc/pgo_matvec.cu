// Pose-graph Gauss-Newton matvec: out = (J^T J v) * free + damping * v.
//
// Replaces: the matvec Hv of covins_tpu/ops/pgo.py::optimize_pose_graph
// (lines 187-201), the one operator the block-Jacobi PCG (`_pcg`, :88)
// applies each iteration, 100 times per Gauss-Newton step: for each edge
// e = (i, j) with whitened 6x6 Jacobians Ji, Jj,
//   y_e = Ji (v_i f_i) + Jj (v_j f_j),
// node i gains Ji^T y_e and node j gains Jj^T y_e, then the sum is masked
// by the free mask f and damped.
//
// Bound on the H100: the inputs are 2 * E * 36 float64 Jacobian entries
// (about 1.3k edges on the main path) and N * 6 values; each edge costs
// about 300 flops.  It moves about 0.8 MB and so is bound by bytes, at
// well under a microsecond: a launch's latency dominates it.
//
// Design: the reference scatter-adds; float64 atomics would add in an
// order that changes from run to run, and 100 CG iterations amplify that.
// Instead the caller builds, once per Gauss-Newton step, a node ->
// incident-entry CSR with a stable sort (the i-side entries of a node in
// edge order, then its j-side entries), and here one thread owns one
// (node, component) output: it walks its node's entries in that fixed
// order, recomputes the edge's y_e and adds its J^T y_e component.  The
// sum order never changes, so two launches give the same bits, and it is
// the order a sequential scatter-add would use.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void pgo_matvec_kernel(const double* __restrict__ v,
                                  const double* __restrict__ free_,
                                  const double* __restrict__ Ji,
                                  const double* __restrict__ Jj,
                                  const int32_t* __restrict__ ei,
                                  const int32_t* __restrict__ ej, int E,
                                  const int32_t* __restrict__ rowptr,
                                  const int32_t* __restrict__ entries, int N,
                                  double damping, double* __restrict__ out) {
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= 6 * N) return;
  const int node = tid / 6;
  const int k = tid - 6 * node;
  double acc = 0.0;
  for (int p = rowptr[node]; p < rowptr[node + 1]; ++p) {
    const int ent = entries[p];
    const bool side_j = ent >= E;
    const int e = side_j ? ent - E : ent;
    const int i = ei[e];
    const int j = ej[e];
    const double* Ai = Ji + 36 * (int64_t)e;
    const double* Aj = Jj + 36 * (int64_t)e;
    const double fi = free_[i];
    const double fj = free_[j];
    const double* A = side_j ? Aj : Ai;
    double o = 0.0;
    for (int r = 0; r < 6; ++r) {
      double yi = 0.0;
      double yj = 0.0;
      for (int c = 0; c < 6; ++c) {
        yi += Ai[6 * r + c] * (v[6 * i + c] * fi);
        yj += Aj[6 * r + c] * (v[6 * j + c] * fj);
      }
      o += A[6 * r + k] * (yi + yj);
    }
    acc += o;
  }
  out[tid] = acc * free_[node] + damping * v[tid];
}

}  // namespace

// v (N, 6), free (N,) f64; Ji, Jj (E, 6, 6) f64 whitened Jacobians; ei, ej
// (E,) int32 endpoints; rowptr (N + 1,) and entries (2E,) int32, the
// node -> entry CSR (entry e < E is edge e's i side, E + e its j side);
// out (N, 6) f64.
extern "C" int covins_pgo_matvec(const void* v, const void* free_, const void* Ji,
                                 const void* Jj, const void* ei, const void* ej,
                                 int E, const void* rowptr, const void* entries,
                                 int N, double damping, void* out, void* stream) {
  if (N <= 0) return 0;
  const int threads = 256;
  pgo_matvec_kernel<<<(6 * N + threads - 1) / threads, threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(v), static_cast<const double*>(free_),
      static_cast<const double*>(Ji), static_cast<const double*>(Jj),
      static_cast<const int32_t*>(ei), static_cast<const int32_t*>(ej), E,
      static_cast<const int32_t*>(rowptr), static_cast<const int32_t*>(entries),
      N, damping, static_cast<double*>(out));
  return static_cast<int>(cudaGetLastError());
}
