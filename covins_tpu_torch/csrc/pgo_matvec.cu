// Pose-graph Gauss-Newton: the normal-matrix product and the whole
// block-Jacobi PCG of one Gauss-Newton step.
//
// Replaces: the matvec Hv of covins_tpu/ops/pgo.py::optimize_pose_graph
// (lines 187-201) and the Chronopoulos-Gear PCG loop around it, `_pcg`
// (:88, its `jax.lax.scan` at :124), which the reference runs as one device
// program per Gauss-Newton step.  For each edge e = (i, j) with whitened
// 6x6 Jacobians Ji, Jj
//   y_e = Ji (v_i f_i) + Jj (v_j f_j),
// node i gains Ji^T y_e and node j gains Jj^T y_e; the sum is masked by
// the free mask f and damped: Hv = (J^T J (v f)) f + damping v.
//
// Two entries:
// * covins_pgo_matvec: Hv alone, two launches (edges, then nodes);
// * covins_pgo_pcg: `_pcg` whole (the initial apply_M and Hv, n_iters
//   iterations, the safe_div scalars) in one cooperative launch; phases
//   separated by grid-wide barriers:
//     A  per node: p = u + beta p, s = w + beta s, x += alpha p,
//        r -= alpha s, u = (Minv r) f                  (node-local)
//     B  eight lanes per edge: lane r forms row r of
//        y_e = Ji (u_i f_i) + Jj (u_j f_j); with the rows exchanged by
//        shuffles, lane k forms component k of Ji^T y_e and Jj^T y_e, each
//        computed once, into scratch
//     C  per (node, component): w = (sum of its ends' terms) f + damping u,
//        and the block's partial sums of gamma = r.u and delta = w.u into
//        its slot
//     D  every block adds all slots in index order, so every block holds
//        the same gamma and delta without another barrier, and computes
//        beta and alpha; the next iteration's phase A follows at once.
//   The grid is the occupancy of the kernel times the SM count, capped at
//   the blocks the largest phase can use; a refused cooperative launch
//   (grid too large for the card) returns its error, and the caller raises.
//
// Bound on the H100: the inputs are read once (2 E 36 float64 Jacobian
// entries, N 36 Minv entries, b: about 0.8 MB at the main path's N = 256
// poses, E = 1270 edges, 0.25 us at 3.35 TB/s) and each iteration does
// about 300 E + 150 N float64 operations, 42 MFLOP for 100 iterations,
// 1.2 us at 34 TFLOP/s: bound by operations.  In practice each iteration is
// three grid barriers and three dependent phases, a few microseconds of
// latency; the 0.73 MB of Jacobians stay in the 50 MB L2 across the
// iterations (distributed shared memory of a cluster would hold them too,
// but a cluster spans at most 16 SMs, which would cap the grid and gain
// nothing over L2 hits at this size).
//
// The float64 tensor cores (DMMA, 8x8x4 tiles) are not used: every product
// here is a 6x6 block times one vector, with no reuse of the block across
// vectors, so the tile would be padded from 6 to 8 and still do a matrix-
// vector product; the work is latency-bound, not bound by the FMA rate.
//
// Determinism: the reference scatter-adds; float64 atomics would add in an
// order that changes from run to run, which 100 CG iterations amplify.
// Here every sum has a fixed order: a node sums its incident entries in
// the order of a node -> entry CSR built once per Gauss-Newton step with
// a stable sort (its i ends in edge order, then its j ends: the order a
// sequential scatter-add uses), and the dot products add per-thread sums,
// per-block tree sums and the block slots in index order.  Two launches
// on the same card give the same bits.  The source is built without FMA
// contraction, so each product rounds as the plain version's does.

#include <algorithm>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "coop_launch.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int STAGE = 4;  // CSR entries whose loads are issued together

struct Graph {
  const double* Ji;  // (E, 6, 6)
  const double* Jj;
  const int32_t* ei;  // (E,)
  const int32_t* ej;
  int E;
  const int32_t* rowptr;   // (N + 1,)
  const int32_t* entries;  // (2E,): e < E is edge e's i end, E + e its j end
  int N;
  const double* free_;  // (N,)
  double damping;
};

// lane q of the edge span (whole warps, eight lanes per edge): lane r forms
// row r of y_e = Ji (v_i f_i) + Jj (v_j f_j), then, with the rows exchanged
// by shuffles, component r of both ends' terms Ji^T y_e and Jj^T y_e, into
// contrib (2E, 6) at the ends' entry indices
__device__ inline void edge_lane(const Graph& g, const double* __restrict__ v, int q,
                                 double* __restrict__ contrib) {
  const int e = q >> 3;
  const int r = q & 7;
  const bool on = e < g.E && r < 6;
  const double* A = g.Ji + 36 * (int64_t)e;
  const double* B = g.Jj + 36 * (int64_t)e;
  double y = 0.0;
  if (on) {
    const int i = g.ei[e];
    const int j = g.ej[e];
    const double fi = g.free_[i];
    const double fj = g.free_[j];
    const double* vi = v + 6 * (int64_t)i;
    const double* vj = v + 6 * (int64_t)j;
    double yi = 0.0;
    double yj = 0.0;
    for (int c = 0; c < 6; ++c) {
      yi += A[6 * r + c] * (vi[c] * fi);
      yj += B[6 * r + c] * (vj[c] * fj);
    }
    y = yi + yj;
  }
  double ci = 0.0;
  double cj = 0.0;
  for (int s = 0; s < 6; ++s) {
    const double ys = __shfl_sync(FULL, y, s, 8);
    if (on) {
      ci += A[6 * s + r] * ys;
      cj += B[6 * s + r] * ys;
    }
  }
  if (on) {
    contrib[6 * (int64_t)e + r] = ci;
    contrib[6 * ((int64_t)g.E + e) + r] = cj;
  }
}

// component k of node's sum_e J_e^T y_e: its entries' terms in the CSR's
// order, the loads of four entries issued together
__device__ inline double node_sum(const Graph& g, const double* __restrict__ contrib,
                                  int node, int k) {
  double acc = 0.0;
  const int end = g.rowptr[node + 1];
  for (int q = g.rowptr[node]; q < end; q += STAGE) {
    double cv[STAGE];
#pragma unroll
    for (int j = 0; j < STAGE; ++j)
      if (q + j < end) cv[j] = contrib[6 * (int64_t)g.entries[q + j] + k];
#pragma unroll
    for (int j = 0; j < STAGE; ++j)
      if (q + j < end) acc += cv[j];
  }
  return acc;
}

__device__ inline int edge_span(int E) { return (8 * E + 31) & ~31; }

__global__ void __launch_bounds__(THREADS) edge_kernel(Graph g, const double* __restrict__ v,
                                                       double* __restrict__ contrib) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q < edge_span(g.E)) edge_lane(g, v, q, contrib);  // whole warps
}

__global__ void __launch_bounds__(THREADS) node_kernel(Graph g, const double* __restrict__ v,
                                                       const double* __restrict__ contrib,
                                                       double* __restrict__ out) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= 6 * g.N) return;
  const int node = q / 6;
  out[q] = node_sum(g, contrib, node, q - 6 * node) * g.free_[node] + g.damping * v[q];
}

__device__ inline double safe_div(double a, double b) {
  return a / (fabs(b) < 1e-30 ? 1e-30 : b);
}

// the block's sums of a and b, the same value in every thread; a fixed
// tree, so the same inputs give the same bits
__device__ inline void block_sum2(double& a, double& b, double (*red)[WARPS]) {
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_down_sync(FULL, a, off);
    b += __shfl_down_sync(FULL, b, off);
  }
  __syncthreads();  // earlier readers of red are done
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    red[0][warp] = a;
    red[1][warp] = b;
  }
  __syncthreads();
  a = red[0][0];
  b = red[1][0];
  for (int k = 1; k < WARPS; ++k) {
    a += red[0][k];
    b += red[1][k];
  }
}

struct Pcg {
  Graph g;
  const double* b;     // (N, 6)
  const double* Minv;  // (N, 6, 6)
  int n_iters;
  double* x;  // (N, 6) each
  double* r;
  double* u;
  double* p;
  double* s;
  double* w;
  double* contrib;  // (2E, 6)
  double* slots;    // (gridDim.x, 2)
};

// at most 128 registers, so that two blocks fit on an SM and the grid the
// phases want is co-resident
__global__ void __launch_bounds__(THREADS, 2) pcg_kernel(Pcg a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ double red[2][WARPS];
  const Graph& g = a.g;
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int nthreads = gridDim.x * blockDim.x;
  // phase A and C: eight lanes per node (six components), whole warps, so
  // the lanes of a node can exchange r by shuffles
  const int node_span = (8 * g.N + 31) & ~31;
  double alpha = 0.0, beta = 0.0, gamma = 0.0;
  for (int it = 0;; ++it) {
    for (int q = tid; q < node_span; q += nthreads) {
      const int node = q >> 3;
      const int k = q & 7;
      const bool on = node < g.N && k < 6;
      const int64_t idx = 6 * (int64_t)node + k;
      double rk = 0.0;
      if (on) {
        if (it == 0) {
          rk = a.b[idx];
          a.x[idx] = 0.0;
        } else {
          const double pk = it == 1 ? a.u[idx] : a.u[idx] + beta * a.p[idx];
          const double sk = it == 1 ? a.w[idx] : a.w[idx] + beta * a.s[idx];
          a.p[idx] = pk;
          a.s[idx] = sk;
          a.x[idx] = a.x[idx] + alpha * pk;
          rk = a.r[idx] - alpha * sk;
        }
        a.r[idx] = rk;
      }
      const double* M = a.Minv + 36 * (int64_t)node + 6 * k;
      double uk = 0.0;
      for (int c = 0; c < 6; ++c) {
        const double rc = __shfl_sync(FULL, rk, c, 8);
        if (on) uk += M[c] * rc;
      }
      if (on) a.u[idx] = uk * g.free_[node];
    }
    if (it == a.n_iters) break;
    grid.sync();
    for (int q = tid; q < edge_span(g.E); q += nthreads) edge_lane(g, a.u, q, a.contrib);
    grid.sync();
    double gp = 0.0, dp = 0.0;
    for (int q = tid; q < node_span; q += nthreads) {
      const int node = q >> 3;
      const int k = q & 7;
      if (node < g.N && k < 6) {
        const int64_t idx = 6 * (int64_t)node + k;
        const double uk = a.u[idx];
        const double wk = node_sum(g, a.contrib, node, k) * g.free_[node] + g.damping * uk;
        a.w[idx] = wk;
        gp += a.r[idx] * uk;
        dp += wk * uk;
      }
    }
    block_sum2(gp, dp, red);
    if (threadIdx.x == 0) {
      a.slots[2 * blockIdx.x] = gp;
      a.slots[2 * blockIdx.x + 1] = dp;
    }
    grid.sync();
    double g1 = 0.0, d1 = 0.0;
    for (int q = threadIdx.x; q < (int)gridDim.x; q += THREADS) {
      g1 += a.slots[2 * q];
      d1 += a.slots[2 * q + 1];
    }
    block_sum2(g1, d1, red);
    if (it == 0) {
      alpha = safe_div(g1, d1);
    } else {
      beta = safe_div(g1, gamma);
      alpha = safe_div(g1, d1 - safe_div(beta * g1, alpha));
    }
    gamma = g1;
  }
}

Graph make_graph(const void* free_, const void* Ji, const void* Jj, const void* ei,
                 const void* ej, int E, const void* rowptr, const void* entries, int N,
                 double damping) {
  return Graph{static_cast<const double*>(Ji),      static_cast<const double*>(Jj),
               static_cast<const int32_t*>(ei),     static_cast<const int32_t*>(ej),
               E,
               static_cast<const int32_t*>(rowptr), static_cast<const int32_t*>(entries),
               N,
               static_cast<const double*>(free_),   damping};
}

}  // namespace

// v (N, 6), free (N,) f64; Ji, Jj (E, 6, 6) f64 whitened Jacobians; ei, ej
// (E,) int32 endpoints; rowptr (N + 1,) and entries (2E,) int32, the
// node -> entry CSR; contrib (2E, 6) f64 scratch; out (N, 6) f64.
extern "C" int covins_pgo_matvec(const void* v, const void* free_, const void* Ji,
                                 const void* Jj, const void* ei, const void* ej, int E,
                                 const void* rowptr, const void* entries, int N,
                                 double damping, void* contrib, void* out, void* stream) {
  if (N <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Graph g = make_graph(free_, Ji, Jj, ei, ej, E, rowptr, entries, N, damping);
  if (E > 0)
    edge_kernel<<<(8 * E + THREADS - 1) / THREADS, THREADS, 0, st>>>(
        g, static_cast<const double*>(v), static_cast<double*>(contrib));
  node_kernel<<<(6 * N + THREADS - 1) / THREADS, THREADS, 0, st>>>(
      g, static_cast<const double*>(v), static_cast<const double*>(contrib),
      static_cast<double*>(out));
  return static_cast<int>(cudaGetLastError());
}

// b (N, 6), Minv (N, 6, 6), free (N,) f64 and the graph as above;
// work (6, N, 6) f64 holds x (the result, first), r, u, p, s, w; y (E, 6)
// and slots (slot_cap, 2) f64 scratch.
extern "C" int covins_pgo_pcg(const void* b, const void* Minv, const void* free_,
                              const void* Ji, const void* Jj, const void* ei, const void* ej,
                              int E, const void* rowptr, const void* entries, int N,
                              double damping, int n_iters, void* work, void* contrib, void* slots,
                              int slot_cap, void* stream) {
  if (N <= 0) return 0;
  double* wk = static_cast<double*>(work);
  const int64_t vec = 6 * (int64_t)N;
  Pcg a{make_graph(free_, Ji, Jj, ei, ej, E, rowptr, entries, N, damping),
        static_cast<const double*>(b),
        static_cast<const double*>(Minv),
        n_iters,
        wk,
        wk + vec,
        wk + 2 * vec,
        wk + 3 * vec,
        wk + 4 * vec,
        wk + 5 * vec,
        static_cast<double*>(contrib),
        static_cast<double*>(slots)};
  void* args[] = {&a};
  const int work_items = std::max((8 * E + 31) & ~31, (8 * N + 31) & ~31);
  return coop::launch(pcg_kernel, THREADS, 0, work_items, slot_cap, coop::Slots::kRefuse, args,
                      static_cast<cudaStream_t>(stream));
}
