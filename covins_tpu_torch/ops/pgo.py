"""Pose-graph optimisation: manifold Gauss-Newton with block-Jacobi PCG.

Counterpart of `covins_tpu/ops/pgo.py` (`Optimization::
PoseGraphOptimization`, `optimization_be.cpp:833-1086`): successor and
neighbour odometry edges, loop edges with fixed or covariance weights and
an optional Cauchy loss, a fixed-pose gauge.  Each Gauss-Newton step
evaluates all edge residuals and their Jacobians at once
(``torch.func.vmap`` of ``torch.func.jacfwd``), then solves the normal
equations matrix-free by Chronopoulos-Gear PCG.  On the card the whole
PCG of a step is one cooperative launch (:func:`pcg`, `csrc/pgo_matvec.cu`),
whose source also holds the standalone matvec K7 (:func:`matvec`); the
plain version is the eager loop :func:`_pcg` around :func:`matvec`.

Every scalar of the solve stays a device tensor: no ``.item()`` and no
Python branch on a device value inside the Gauss-Newton steps, so the
host queues the whole solve without waiting for the card.
"""

from __future__ import annotations

import dataclasses

import torch

from covins_tpu_torch import cuda_build
from covins_tpu_torch.device import check_cuda, check_f64, is_cpu
from covins_tpu_torch.ops import linalg
from covins_tpu_torch.ops import residuals as res
from covins_tpu_torch.utils import geometry as geo


@dataclasses.dataclass(frozen=True)
class PoseGraph:
    """Flat pose-graph problem on one device."""

    poses: torch.Tensor  # (N, 7) T_w_s, float64
    pose_mask: torch.Tensor  # (N,) bool — valid pose slots
    fixed: torch.Tensor  # (N,) bool — gauge-fixed poses
    edge_i: torch.Tensor  # (E,) int64
    edge_j: torch.Tensor  # (E,) int64
    edge_T: torch.Tensor  # (E, 7) measured T_i_j
    edge_sqrt_info: torch.Tensor  # (E, 6, 6) upper sqrt information
    edge_mask: torch.Tensor  # (E,) bool
    edge_is_loop: torch.Tensor  # (E,) bool — robust loss applies to these


def make_sqrt_info(rot_weight, trans_weight, n, dtype=torch.float64, device=None):
    """Diagonal sqrt-info blocks [rot(3), trans(3)] for n edges."""
    d = torch.tensor([rot_weight] * 3 + [trans_weight] * 3, dtype=dtype,
                     device=device)
    return torch.diag(d).expand(n, 6, 6)


def _edge_residual_jac(poses, g: PoseGraph):
    """Whitened residuals (E, 6) and Jacobians (E, 6, 6) for both ends."""

    def one(Ti, Tj, T_meas, S):
        def r_of(xi):
            return res.six_dof_between_residual(
                geo.pose_boxplus(Ti, xi[:6]), geo.pose_boxplus(Tj, xi[6:]),
                T_meas)

        zero = torch.zeros(12, dtype=Ti.dtype, device=Ti.device)
        J = torch.func.jacfwd(r_of)(zero)  # (6, 12)
        return S @ r_of(zero), S @ J[:, :6], S @ J[:, 6:]

    return torch.func.vmap(one)(poses[g.edge_i], poses[g.edge_j], g.edge_T,
                                g.edge_sqrt_info)


def _edge_residual(poses, g: PoseGraph):
    """Whitened residuals (E, 6) alone (the cost guard needs no Jacobian)."""
    r = res.six_dof_between_residual(poses[g.edge_i], poses[g.edge_j], g.edge_T)
    return (g.edge_sqrt_info @ r[..., None])[..., 0]


# ------------------------------------------------------------------- K7
@dataclasses.dataclass(frozen=True)
class MatvecGraph:
    """The edges of one Gauss-Newton step, with the node -> incident-entry
    CSR the kernel sums in: entry e < E is edge e's i end, E + e its j
    end; a node's entries are its i ends in edge order, then its j ends."""

    edge_i: torch.Tensor  # (E,) int64
    edge_j: torch.Tensor  # (E,) int64
    ei32: torch.Tensor
    ej32: torch.Tensor
    rowptr: torch.Tensor  # (N + 1,) int32
    entries: torch.Tensor  # (2E,) int32
    # the entries in CSR order as (node, slot in the node's row) pairs,
    # and the longest row: the layout of :func:`node_sums`
    entry_node: torch.Tensor  # (2E,) int64
    entry_slot: torch.Tensor  # (2E,) int64
    max_degree: int


def matvec_graph(edge_i, edge_j, n: int) -> MatvecGraph:
    keys = torch.cat([edge_i, edge_j])
    order = torch.sort(keys, stable=True).indices
    counts = torch.zeros(n, dtype=torch.int64, device=keys.device).index_add_(
        0, keys, torch.ones_like(keys))
    rowptr = torch.zeros(n + 1, dtype=torch.int32, device=keys.device)
    rowptr[1:] = torch.cumsum(counts, 0)
    node = keys[order]
    slot = torch.arange(node.shape[0], device=keys.device) - rowptr[node]
    max_degree = int(counts.max()) if n > 0 and node.shape[0] > 0 else 0
    return MatvecGraph(edge_i, edge_j, edge_i.to(torch.int32),
                       edge_j.to(torch.int32), rowptr,
                       order.to(torch.int32), node, slot, max_degree)


def node_sums(graph: MatvecGraph, n: int, at_i, at_j):
    """Each node's sum of the edge terms ``at_i`` (E, ...) at its i ends and
    ``at_j`` at its j ends, its terms added one at a time in CSR order
    (its i ends in edge order, then its j ends) from zero: bit for bit the
    CPU's ``zeros.index_add_(0, edge_i, at_i).index_add_(0, edge_j, at_j)``
    on any device, where CUDA's ``index_add_`` adds with atomics in an
    order that changes from run to run."""
    src = torch.cat([at_i, at_j])[graph.entries.long()]
    rows = src.new_zeros((n, graph.max_degree) + src.shape[1:])
    rows[graph.entry_node, graph.entry_slot] = src
    out = src.new_zeros((n,) + src.shape[1:])
    for k in range(graph.max_degree):
        out = out + rows[:, k]
    return out


def matvec_plain(v, free, Ji, Jj, graph: MatvecGraph, damping: float):
    """Plain version of :func:`matvec`: the reference's gathers, 6x6 block
    products and scatter-adds (any device)."""
    ei, ej = graph.edge_i, graph.edge_j
    vi = v[ei] * free[ei][:, None]
    vj = v[ej] * free[ej][:, None]
    y = (Ji @ vi[..., None])[..., 0] + (Jj @ vj[..., None])[..., 0]
    oi = (Ji.transpose(-1, -2) @ y[..., None])[..., 0]
    oj = (Jj.transpose(-1, -2) @ y[..., None])[..., 0]
    out = torch.zeros_like(v).index_add_(0, ei, oi).index_add_(0, ej, oj)
    return out * free[:, None] + damping * v


def _check(name, graph: MatvecGraph, n: int, e: int, *named):
    """Raise unless every (name, tensor, shape) is a contiguous float64
    tensor of that shape and the graph has n nodes and e edges."""
    check_f64(name, *named)
    if graph.rowptr.shape != (n + 1,) or graph.entries.shape != (2 * e,):
        raise ValueError(f"{name}: graph does not match the problem")


def matvec(v, free, Ji, Jj, graph: MatvecGraph, damping: float):
    """``(sum_e J_e^T (Ji v_i f_i + Jj v_j f_j)) * free + damping * v``
    for v (N, 6), free (N,) and whitened Jacobians Ji, Jj (E, 6, 6), all
    float64.  CPU tensors take the plain version; CUDA tensors launch the
    kernel (K7: y_e once per edge, then each node's terms summed in the
    graph's fixed order), or raise."""
    ts = (v, free, Ji, Jj, graph.rowptr)
    if all(is_cpu(t) for t in ts):
        return matvec_plain(v, free, Ji, Jj, graph, damping)
    dev = check_cuda("pgo matvec", *ts)
    n, e = v.shape[0], Ji.shape[0]
    _check("pgo matvec", graph, n, e, ("v", v, (n, 6)), ("free", free, (n,)),
           ("Ji", Ji, (e, 6, 6)), ("Jj", Jj, (e, 6, 6)))
    out = torch.empty_like(v)
    contrib = torch.empty((2 * e, 6), dtype=torch.float64, device=dev)
    lib = cuda_build.library("pgo_matvec")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.covins_pgo_matvec(
            v.data_ptr(), free.data_ptr(), Ji.data_ptr(), Jj.data_ptr(),
            graph.ei32.data_ptr(), graph.ej32.data_ptr(), e,
            graph.rowptr.data_ptr(), graph.entries.data_ptr(), n,
            float(damping), contrib.data_ptr(), out.data_ptr(), stream)
    cuda_build.check(rc, "pgo matvec")
    matvec.launches += 1
    return out


matvec.launches = 0


def _pcg(Hv, b, Minv_blocks, free, n_iters: int, total=torch.sum):
    """Block-Jacobi preconditioned CG on H x = b (b, x: (N, 6)), in the
    reference's Chronopoulos-Gear form: one matvec and one fused pair of
    reductions per iteration, each reduction ``total`` of a product."""

    def apply_M(r):
        return (Minv_blocks @ r[..., None])[..., 0] * free[:, None]

    def safe_div(a, bb):
        return a / torch.where(torch.abs(bb) < 1e-30, 1e-30, bb)

    x = torch.zeros_like(b)
    r = b
    u = apply_M(r)
    w = Hv(u)
    gamma = total(r * u)
    alpha = safe_div(gamma, total(w * u))
    p, s = u, w
    for _ in range(n_iters):
        x = x + alpha * p
        r = r - alpha * s
        u = apply_M(r)
        w = Hv(u)
        gamma1 = total(r * u)
        delta1 = total(w * u)
        beta1 = safe_div(gamma1, gamma)
        alpha = safe_div(gamma1, delta1 - safe_div(beta1 * gamma1, alpha))
        p = u + beta1 * p
        s = w + beta1 * s
        gamma = gamma1
    return x


def pcg(b, Minv, free, Ji, Jj, graph: MatvecGraph, damping: float, n_iters: int):
    """``n_iters`` iterations of block-Jacobi PCG on H x = b from x = 0,
    H v = :func:`matvec`; returns x (N, 6).  CPU tensors take the plain
    version, :func:`_pcg` around :func:`matvec`; CUDA tensors run the whole
    loop in one cooperative launch of the K7 source's PCG kernel, or
    raise."""
    ts = (b, Minv, free, Ji, Jj, graph.rowptr)
    if all(is_cpu(t) for t in ts):
        return _pcg(lambda v: matvec(v, free, Ji, Jj, graph, damping), b, Minv, free,
                    n_iters)
    dev = check_cuda("pgo pcg", *ts)
    n, e = b.shape[0], Ji.shape[0]
    _check("pgo pcg", graph, n, e, ("b", b, (n, 6)), ("Minv", Minv, (n, 6, 6)),
           ("free", free, (n,)), ("Ji", Ji, (e, 6, 6)), ("Jj", Jj, (e, 6, 6)))
    if n_iters < 0:
        raise ValueError(f"pgo pcg: n_iters must be >= 0, got {n_iters}")
    # one allocation: x (the result), r, u, p, s, w (N, 6) each, the edge
    # ends' terms (2E, 6) and the block slots
    sizes = (36 * n, 12 * e, 2 * cuda_build.SLOT_CAP)
    work, contrib, slots = torch.split(
        torch.empty(sum(sizes), dtype=torch.float64, device=dev), sizes)
    lib = cuda_build.library("pgo_matvec")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.covins_pgo_pcg(
            b.data_ptr(), Minv.data_ptr(), free.data_ptr(), Ji.data_ptr(), Jj.data_ptr(),
            graph.ei32.data_ptr(), graph.ej32.data_ptr(), e, graph.rowptr.data_ptr(),
            graph.entries.data_ptr(), n, float(damping), int(n_iters), work.data_ptr(),
            contrib.data_ptr(), slots.data_ptr(), cuda_build.SLOT_CAP, stream)
    cuda_build.check(rc, "pgo pcg")
    pcg.launches += 1
    return work[:6 * n].view(n, 6)


pcg.launches = 0


def normal_equations(poses, g: PoseGraph, free, damping: float, cauchy_scale: float,
                     graph: MatvecGraph = None):
    """Linearise every edge at ``poses``: (edge residuals r (E, 6), edge
    weights w (E,), whitened Jacobians Ji_w, Jj_w (E, 6, 6), the gradient
    b (N, 6) and the inverse block-Jacobi blocks Minv (N, 6, 6)).
    ``graph`` is ``g``'s :func:`matvec_graph`, built here if not given."""
    r, w, Ji_w, Jj_w, b, M = edge_sums(poses, g, free, cauchy_scale, graph)
    return r, w, Ji_w, Jj_w, b, inverse_blocks(M, damping)


def inverse_blocks(M, damping: float):
    """The block-Jacobi preconditioner: the inverses of the (N, 6, 6)
    blocks of J^T J plus (damping + 1e-9) I."""
    eye = torch.eye(6, dtype=M.dtype, device=M.device)
    return linalg.inv_psd_small(M + (damping + 1e-9) * eye)


def edge_sums(poses, g: PoseGraph, free, cauchy_scale: float, graph: MatvecGraph = None):
    """:func:`normal_equations` up to the undamped blocks: (r, w, Ji_w,
    Jj_w, b, the blocks of J^T J (N, 6, 6)), every node sum over ``g``'s
    edges alone, so that the sums of a graph split by edges add up.  The
    node sums are :func:`node_sums` over ``graph`` (``g``'s
    :func:`matvec_graph`, built here if not given): the same bits on every
    run and on every device."""
    n = poses.shape[0]
    if graph is None:
        graph = matvec_graph(g.edge_i, g.edge_j, n)
    dt = poses.dtype
    r, Ji, Jj = _edge_residual_jac(poses, g)
    w = g.edge_mask.to(dt)
    if cauchy_scale > 0:
        cw = res.cauchy_weight(torch.sum(r * r, dim=-1), cauchy_scale)
        w = w * torch.where(g.edge_is_loop, cw, 1.0)
    sw = torch.sqrt(w)[:, None]
    r_w = r * sw
    Ji_w = (Ji * sw[..., None]).contiguous()
    Jj_w = (Jj * sw[..., None]).contiguous()

    bi = -torch.einsum("eri,er->ei", Ji_w, r_w)
    bj = -torch.einsum("eri,er->ei", Jj_w, r_w)
    Pi = torch.einsum("eri,erj->eij", Ji_w, Ji_w)
    Pj = torch.einsum("eri,erj->eij", Jj_w, Jj_w)
    e = bi.shape[0]
    sums = node_sums(graph, n, torch.cat([bi, Pi.reshape(e, 36)], 1),
                     torch.cat([bj, Pj.reshape(e, 36)], 1))
    b = sums[:, :6] * free[:, None]
    M = sums[:, 6:].reshape(n, 6, 6)
    return r, w, Ji_w, Jj_w, b, M


def optimize_pose_graph(g: PoseGraph, n_gn: int = 8, n_cg: int = 100,
                        damping: float = 1e-6, cauchy_scale: float = 0.0):
    """Gauss-Newton + PCG pose-graph optimisation.

    Returns (poses (N, 7), final_cost ()), both device tensors."""
    n = g.poses.shape[0]
    free = (~g.fixed & g.pose_mask).to(g.poses.dtype)
    graph = matvec_graph(g.edge_i, g.edge_j, n)
    poses = g.poses
    cost = None
    for _ in range(n_gn):
        r, w, Ji_w, Jj_w, b, Minv = normal_equations(poses, g, free, damping, cauchy_scale,
                                                     graph)
        dx = pcg(b, Minv, free, Ji_w, Jj_w, graph, damping, n_cg) * free[:, None]
        poses_new = geo.pose_boxplus(poses, dx)
        # accept only if the cost fell (guard against CG blow-ups)
        r_new = _edge_residual(poses_new, g)
        c_old = torch.sum(w * torch.sum(r * r, -1))
        c_new = torch.sum(w * torch.sum(r_new * r_new, -1))
        poses = torch.where(c_new < c_old, poses_new, poses)
        cost = torch.minimum(c_new, c_old)
    return poses, cost
