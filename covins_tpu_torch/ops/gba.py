"""Global visual-inertial bundle adjustment with Schur-complement landmark
elimination.

Counterpart of `covins_tpu/ops/gba.py` (`Optimization::
GlobalBundleAdjustment`, `optimization_be.cpp:56-618`), with the reference's
semantics: per keyframe a 15-dof tangent [pose(6), velocity(3), bias(6)];
IMU preintegration factors between consecutive keyframes with the bias
random walk; one reprojection residual per observation with sigma =
(octave + 1) * 2 px; loop edges as 6-DoF between factors; landmarks
eliminated through their 3x3 blocks, the reduced camera system solved
matrix-free by block-Jacobi PCG; a step-length ladder and an adaptive
Levenberg-Marquardt damping; two rounds with outlier pruning between
them; the gauge fixed by the pose of the fixed keyframes.  Everything is
float64.

The observation work runs in two hand-written kernels on the card, each
behind a wrapper with a plain PyTorch version in this module:

* K8 :func:`reproj_blocks` (`csrc/gba_reproj_blocks.cu`): per observation
  the whitened residual and its written-out Jacobians, reduced in the
  same launch into each keyframe's gradient and 6x6 block and each
  landmark's gradient and 3x3 block; or the reprojection cost of several
  states at once (the step ladder's six and the current one); or the
  outlier norm;
* K9 :func:`reduced_matvec` (`csrc/gba_reduced_matvec.cu`): the
  observation part of the reduced camera matrix times a vector,
  Hpp(reproj) v - Hpl Hll^-1 Hlp v (for b_red and the step ladder);
* :func:`pcg` (the same source): each Gauss-Newton step's whole block-
  Jacobi PCG on the reduced camera system in one cooperative launch,
  with :func:`pcg_plain`, the eager loop around K9, as its plain version.

They sum in the fixed order of a keyframe -> observation and a landmark ->
observation CSR and a chunk layout built once per problem
(:func:`obs_graph`) and of node -> factor CSRs built once per step
(:func:`factors`), so equal inputs give equal bits.  The IMU and loop
factors' residuals and Jacobians (a few hundred factors) stay batched
PyTorch with ``torch.func.vmap(jacfwd)``, as the reference's
``jax.jacfwd``.  Every scalar of a solve (the CG scalars, the
step ladder's choice, the damping, the accept flag) stays a device
tensor, so a Gauss-Newton step never waits for the card.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from covins_tpu_torch import cuda_build
from covins_tpu_torch.device import check_cuda, check_f64, is_cpu
from covins_tpu_torch.ops import imu as imu_mod
from covins_tpu_torch.ops import linalg
from covins_tpu_torch.ops import residuals as res
from covins_tpu_torch.utils import cameras as cam_mod
from covins_tpu_torch.utils import geometry as geo

KF_DOF = 15  # [pose(6), vel(3), bias(6)]
LADDER = (1.0, 0.5, 0.25, 0.1, 0.03, 0.01)  # step scales tried per GN step


@dataclasses.dataclass(frozen=True)
class GBAProblem:
    """Flat VI-GBA problem on one device (invalid slots masked)."""

    # keyframe states
    poses: torch.Tensor  # (N, 7) T_w_s
    vels: torch.Tensor  # (N, 3)
    biases: torch.Tensor  # (N, 6) [bg, ba]
    kf_mask: torch.Tensor  # (N,) bool
    kf_fixed: torch.Tensor  # (N,) bool, gauge-fixed poses
    cam: cam_mod.Camera  # shared intrinsics and extrinsics, fixed
    # landmarks
    lms: torch.Tensor  # (M, 3)
    lm_mask: torch.Tensor  # (M,) bool
    # reprojection observations (COO)
    obs_kf: torch.Tensor  # (O,) int64
    obs_lm: torch.Tensor  # (O,) int64
    obs_uv: torch.Tensor  # (O, 2) distorted pixels
    obs_w: torch.Tensor  # (O,) 1/sigma
    obs_mask: torch.Tensor  # (O,) bool
    # IMU preintegration factors between keyframe pairs
    imu_i: torch.Tensor  # (F,) int64
    imu_j: torch.Tensor  # (F,) int64
    imu_pre: imu_mod.Preintegrated  # batched (F, ...)
    imu_sqrt_info: torch.Tensor  # (F, 9, 9)
    bias_sqrt_info: torch.Tensor  # (F, 6, 6) random-walk weights
    imu_mask: torch.Tensor  # (F,) bool
    gravity: torch.Tensor  # (3,)
    # loop-closure 6-DoF between edges
    loop_i: torch.Tensor  # (L,) int64
    loop_j: torch.Tensor  # (L,) int64
    loop_T: torch.Tensor  # (L, 7)
    loop_sqrt_info: torch.Tensor  # (L, 6, 6)
    loop_mask: torch.Tensor  # (L,) bool


def problem_to(p: GBAProblem, device) -> GBAProblem:
    """A copy of ``p`` with every tensor (the camera's and the factors'
    too) on ``device``."""
    def move(x):
        if isinstance(x, torch.Tensor):
            return x.to(device)
        if dataclasses.is_dataclass(x):
            return dataclasses.replace(x, **{f.name: move(getattr(x, f.name))
                                             for f in dataclasses.fields(x)})
        return x
    return move(p)


def _retract_kf(pose, vel, bias, xi):
    """Apply a 15-dof tangent to one keyframe state."""
    return geo.pose_boxplus(pose, xi[..., :6]), vel + xi[..., 6:9], bias + xi[..., 9:15]


# ------------------------------------------------------- observation graph
KF_CHUNK = 8  # observations per chunk of a keyframe's sums in K8 and K9


@dataclasses.dataclass(frozen=True)
class ObsGraph:
    """The observations grouped per keyframe and per landmark: CSR row
    pointers and observation indices in ascending order, the order a
    sequential scatter-add sums in; and each keyframe's row of ``kf_obs``
    cut into chunks of at most KF_CHUNK consecutive entries, the fixed
    first level of K8's and K9's keyframe sums.  It depends only on which
    keyframe and landmark each observation belongs to, not on the masks,
    so one graph serves both rounds of a solve."""

    obs_kf32: torch.Tensor  # (O,) int32
    obs_lm32: torch.Tensor  # (O,) int32
    kf_rowptr: torch.Tensor  # (N + 1,) int32
    kf_obs: torch.Tensor  # (O,) int32
    lm_rowptr: torch.Tensor  # (M + 1,) int32
    lm_obs: torch.Tensor  # (O,) int32
    chunk_ptr: torch.Tensor  # (C + 1,) int32, chunk c is kf_obs[chunk_ptr[c]:chunk_ptr[c + 1]]
    kf_chunk_ptr: torch.Tensor  # (N + 1,) int32, keyframe k's chunks

    @property
    def n_chunks(self) -> int:
        return self.chunk_ptr.shape[0] - 1


def _csr(keys, n):
    """Row pointers (n + 1,) and the stably sorted order of ``keys``, both
    int32; the counts come from a scatter-add, so nothing waits for the
    card."""
    order = torch.sort(keys, stable=True).indices
    counts = torch.zeros(n, dtype=torch.int64, device=keys.device).index_add_(
        0, keys, torch.ones_like(keys))
    rowptr = torch.zeros(n + 1, dtype=torch.int32, device=keys.device)
    rowptr[1:] = torch.cumsum(counts, 0)
    return rowptr, order.to(torch.int32)


def _chunks(kf_rowptr, o: int):
    """Cut each keyframe's CSR row into chunks of at most KF_CHUNK entries:
    (chunk_ptr, kf_chunk_ptr).  Reads the chunk count on the host
    (once per problem)."""
    dev = kf_rowptr.device
    n = kf_rowptr.shape[0] - 1
    counts = (kf_rowptr[1:] - kf_rowptr[:-1]).long()
    per_kf = (counts + KF_CHUNK - 1) // KF_CHUNK
    kf_chunk_ptr = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    kf_chunk_ptr[1:] = torch.cumsum(per_kf, 0)
    chunk_kf = torch.repeat_interleave(torch.arange(n, device=dev), per_kf)
    local = torch.arange(chunk_kf.shape[0], device=dev) - kf_chunk_ptr[chunk_kf]
    start = kf_rowptr[chunk_kf].long() + local * KF_CHUNK
    chunk_ptr = torch.cat([start, torch.full((1,), o, dtype=torch.int64, device=dev)])
    return chunk_ptr.to(torch.int32), kf_chunk_ptr.to(torch.int32)


def obs_graph(p: GBAProblem) -> ObsGraph:
    kf_rowptr, kf_obs = _csr(p.obs_kf, p.poses.shape[0])
    lm_rowptr, lm_obs = _csr(p.obs_lm, p.lms.shape[0])
    return ObsGraph(p.obs_kf.to(torch.int32), p.obs_lm.to(torch.int32),
                    kf_rowptr, kf_obs, lm_rowptr, lm_obs,
                    *_chunks(kf_rowptr, p.obs_kf.shape[0]))


# ------------------------------------------------------------------- K8
MODES = {"linearize": 0, "cost": 1, "outlier": 2}


@dataclasses.dataclass(frozen=True)
class ReprojInputs:
    """K8's inputs that hold for a whole problem: its weights and masks as
    float64 and the camera as the kernel reads it."""

    w: torch.Tensor  # (O,) obs_w * obs_mask
    w_raw: torch.Tensor  # (O,) obs_w
    kf_m: torch.Tensor  # (N,) kf_mask
    lm_m: torch.Tensor  # (M,) lm_mask
    cam: torch.Tensor  # (15,) [fx, fy, cx, cy, k1, k2, p1, p2, T_s_c(7)]


def _cam_params(cam: cam_mod.Camera):
    """[fx, fy, cx, cy, k1, k2, p1, p2, T_s_c(7)] float64, as K8 reads it."""
    return torch.cat([cam.intrinsics[:4], cam.dist[:4], cam.T_s_c[:7]]).to(
        torch.float64).contiguous()


def reproj_inputs(p: GBAProblem) -> ReprojInputs:
    """:class:`ReprojInputs` of ``p``.  They hold while its weights, masks
    and camera do, whatever its state: :func:`_gba_rounds` builds them once
    per round of :func:`global_bundle_adjustment` (the pruning between the
    rounds changes ``obs_mask``) and hands them to every K8 call of the
    round, beside the :class:`ObsGraph`.  A call given none builds them
    from ``p``."""
    dt = torch.float64
    return ReprojInputs((p.obs_w * p.obs_mask).to(dt).contiguous(),
                        p.obs_w.to(dt).contiguous(), p.kf_mask.to(dt).contiguous(),
                        p.lm_mask.to(dt).contiguous(), _cam_params(p.cam))


def _obs_weights(p: GBAProblem, r, valid, huber_k: float, c: ReprojInputs):
    """The reference's per-observation weight: 1/sigma, zero for masked or
    invalid observations, landmarks and keyframes, times the Huber IRLS
    weight sqrt(min(1, k / ||r w||)) when ``huber_k > 0``.  ``r`` (..., O,
    2) and ``valid`` (..., O) may carry leading state dimensions."""
    ww = c.w * valid * c.lm_m[p.obs_lm] * c.kf_m[p.obs_kf]
    if huber_k > 0.0:
        rw = r * ww[..., None]
        rn = linalg.sqrt_rn(rw[..., 0] * rw[..., 0] + rw[..., 1] * rw[..., 1])
        ww = ww * linalg.sqrt_rn(torch.clamp(huber_k / torch.clamp(rn, min=1e-12),
                                             max=1.0))
    return ww


def reproj_blocks_plain(p: GBAProblem, graph: ObsGraph, huber_k: float, mode: str,
                        inputs: Optional[ReprojInputs] = None):
    """Plain version of :func:`reproj_blocks` (any device)."""
    c = reproj_inputs(p) if inputs is None else inputs
    if mode == "cost":
        r, valid = res.reprojection_residual(p.cam, p.poses[:, p.obs_kf],
                                             p.lms[:, p.obs_lm], p.obs_uv)
        rw = r * _obs_weights(p, r, valid, huber_k, c)[..., None]
        return torch.sum(rw[..., 0] * rw[..., 0] + rw[..., 1] * rw[..., 1], dim=-1)
    pose, X = p.poses[p.obs_kf], p.lms[p.obs_lm]
    if mode == "outlier":
        r, valid = res.reprojection_residual(p.cam, pose, X, p.obs_uv)
        return linalg.sqrt_rn(r[:, 0] * r[:, 0] + r[:, 1] * r[:, 1]) * p.obs_w, valid
    r, valid, Jp, Jl = res.reprojection_jacobian(p.cam, pose, X, p.obs_uv)
    ww = _obs_weights(p, r, valid, huber_k, c)
    r, Jp, Jl = r * ww[:, None], Jp * ww[:, None, None], Jl * ww[:, None, None]
    n, m, dt = p.poses.shape[0], p.lms.shape[0], p.poses.dtype
    z = dict(dtype=dt, device=r.device)
    b6 = torch.zeros((n, 6), **z).index_add_(
        0, p.obs_kf, -torch.einsum("ori,or->oi", Jp, r))
    M6 = torch.zeros((n, 6, 6), **z).index_add_(
        0, p.obs_kf, torch.einsum("ori,orj->oij", Jp, Jp))
    b_l = torch.zeros((m, 3), **z).index_add_(
        0, p.obs_lm, -torch.einsum("ori,or->oi", Jl, r))
    Hll = torch.zeros((m, 3, 3), **z).index_add_(
        0, p.obs_lm, torch.einsum("ori,orj->oij", Jl, Jl))
    return r, Jp, Jl, b6, M6, b_l, Hll


def _given_projection(p: GBAProblem, code: int):
    """What K8 reads in place of its own projection for a camera it does
    not project (anything but a pinhole camera with no or radtan
    distortion): each observation's pixel (O, 2) and validity (O,) uint8,
    and for the linearisation d uv / d p_c (O, 2, 3), computed as the plain
    version computes them; the cost mode's with the S states leading.
    None for the cameras K8 projects itself."""
    cam = p.cam
    if cam.cam_model == cam_mod.PINHOLE and cam.dist_model in (cam_mod.DIST_NONE,
                                                               cam_mod.RADTAN):
        return None
    pose, X = ((p.poses[:, p.obs_kf], p.lms[:, p.obs_lm]) if code == 1
               else (p.poses[p.obs_kf], p.lms[p.obs_lm]))
    p_c = res.camera_point(cam, pose, X)
    if code == 0:
        uv, valid, P = cam_mod.project3_jacobian(cam, p_c)
        P = P.contiguous()
    else:
        (uv, valid), P = cam_mod.project3(cam, p_c), None
    return uv.contiguous(), valid.to(torch.uint8), P


def reproj_blocks(p: GBAProblem, graph: ObsGraph, huber_k: float = 0.0,
                  mode: str = "linearize", inputs: Optional[ReprojInputs] = None):
    """The reprojection factors of a GBA problem (K8), one launch per call.

    ``mode="linearize"``: the whitened residual r (O, 2) with the
    reference's weights (and the Huber weight when ``huber_k > 0``), the
    whitened Jacobians J_pose (O, 2, 6) and J_lm (O, 2, 3), each
    keyframe's b (N, 6) = -sum J_pose^T r and block (N, 6, 6) = sum
    J_pose^T J_pose, each landmark's b (M, 3) and block (M, 3, 3).
    ``mode="cost"``: ``p.poses`` (S, N, 7) and ``p.lms`` (S, M, 3) hold S
    states; returns each state's sum of |r|^2 over the observations (S,).
    ``mode="outlier"``: (||raw residual|| * obs_w (O,), valid (O,)), the
    norm `th_gba_outlier_global` thresholds.  ``inputs``: ``p``'s
    :class:`ReprojInputs`, built from ``p`` when None.  The norms take a
    correctly rounded square root on both routes.  The kernel projects a
    pinhole camera with no or radtan distortion itself; for every other
    camera the projection is computed in PyTorch and handed to it
    (:func:`_given_projection`).  CPU tensors take the plain version; CUDA
    tensors launch the kernel, or raise."""
    code = MODES[mode]
    ts = (p.poses, p.lms, p.obs_uv, p.obs_w, graph.kf_rowptr)
    if all(is_cpu(t) for t in ts):
        return reproj_blocks_plain(p, graph, huber_k, mode, inputs)
    dev = check_cuda("gba reproj blocks", *ts)
    cam = p.cam
    n, m, o = graph.kf_rowptr.shape[0] - 1, graph.lm_rowptr.shape[0] - 1, graph.kf_obs.shape[0]
    s = p.poses.shape[0] if code == 1 else 1
    lead = (s,) if code == 1 else ()
    poses, lms, uv = p.poses.contiguous(), p.lms.contiguous(), p.obs_uv.contiguous()
    check_f64("gba reproj blocks", ("poses", poses, lead + (n, 7)),
              ("lms", lms, lead + (m, 3)), ("obs_uv", uv, (o, 2)))
    _check_graph("gba reproj blocks", graph, n, m, o)
    c = reproj_inputs(p) if inputs is None else inputs
    given = _given_projection(p, code)
    f64 = dict(dtype=torch.float64, device=dev)
    out, val, valid = (None,) * 7, None, None
    if code == 0:
        out = (torch.empty((o, 2), **f64), torch.empty((o, 2, 6), **f64),
               torch.empty((o, 2, 3), **f64), torch.empty((n, 6), **f64),
               torch.empty((n, 6, 6), **f64), torch.empty((m, 3), **f64),
               torch.empty((m, 3, 3), **f64))
        scratch = torch.empty((graph.n_chunks, 27), **f64)
    elif code == 1:
        val = torch.empty((s,), **f64)
        scratch = torch.empty((s, cuda_build.SLOT_CAP), **f64)
    else:
        val = torch.empty((o,), **f64)
        valid = torch.empty((o,), dtype=torch.uint8, device=dev)
        scratch = None
    lib = cuda_build.library("gba_reproj_blocks")
    with torch.cuda.device(dev):
        rc = lib.covins_gba_reproj_blocks(
            code, s, poses.data_ptr(), lms.data_ptr(), c.cam.data_ptr(),
            0 if given else int(cam.dist_model), uv.data_ptr(),
            (c.w_raw if code == 2 else c.w).data_ptr(),
            c.kf_m.data_ptr(), c.lm_m.data_ptr(), graph.obs_kf32.data_ptr(),
            graph.obs_lm32.data_ptr(), o, n, m, graph.kf_obs.data_ptr(),
            graph.chunk_ptr.data_ptr(), graph.kf_chunk_ptr.data_ptr(), graph.n_chunks,
            graph.lm_rowptr.data_ptr(), graph.lm_obs.data_ptr(), float(huber_k),
            *(_ptr(t) for t in (given or (None,) * 3)), *(_ptr(t) for t in out), _ptr(val), _ptr(valid), _ptr(scratch),
            cuda_build.SLOT_CAP, torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(rc, "gba reproj blocks")
    reproj_blocks.launches += 1
    if code == 0:
        return out
    return val if code == 1 else (val, valid.bool())


reproj_blocks.launches = 0


# ------------------------------------------------------------------- K9
def reduced_matvec_plain(v6, c, Jp, Jl, Hll_inv, graph: ObsGraph, n: int,
                         t_only: bool = False):
    """Plain version of :func:`reduced_matvec` (any device)."""
    kf, lm = graph.obs_kf32.long(), graph.obs_lm32.long()
    m = Hll_inv.shape[0]
    z = dict(dtype=Jp.dtype, device=Jp.device)
    t = torch.zeros((m, 3), **z)
    if v6 is not None:
        y = (Jp @ v6[kf][..., None])[..., 0]  # (O, 2)
        t = t.index_add_(0, lm, (Jl.transpose(-1, -2) @ y[..., None])[..., 0])
    if t_only:
        return t
    w = (Hll_inv @ (t if c is None else t + c)[..., None])[..., 0]
    y2 = (Jl @ w[lm][..., None])[..., 0]
    b6 = torch.zeros((n, 6), **z).index_add_(
        0, kf, (Jp.transpose(-1, -2) @ y2[..., None])[..., 0])
    a6 = torch.zeros((n, 6), **z)
    if v6 is not None:
        a6 = a6.index_add_(0, kf, (Jp.transpose(-1, -2) @ y[..., None])[..., 0])
    return a6 - b6


def reduced_matvec_error_scale(v6, c, Jp, Jl, Hll_inv, graph: ObsGraph, n: int,
                               t_only: bool = False):
    """The sums of magnitudes behind each output of :func:`reduced_matvec`:
    the plain version's two terms on the inputs' absolute values, added.
    Hll^-1 of a landmark seen once or twice is nearly singular, so J_lm w
    cancels terms many orders larger than its result; a rounding
    difference is relative to these sums, not to the result."""
    a = [None if x is None else x.abs() for x in (v6, c, Jp, Jl, Hll_inv)]
    t = reduced_matvec_plain(a[0], None, a[2], a[3], a[4], graph, n, t_only=True)
    if t_only:
        return t
    pos = reduced_matvec_plain(a[0], None, a[2], a[3], a[4] * 0, graph, n)
    neg = reduced_matvec_plain(None, t if a[1] is None else t + a[1], a[2], a[3], a[4],
                               graph, n)
    return pos - neg


def _check_graph(name: str, graph: ObsGraph, n: int, m: int, o: int):
    if graph.kf_rowptr.shape != (n + 1,) or graph.lm_rowptr.shape != (m + 1,) \
            or graph.kf_obs.shape != (o,) or graph.kf_chunk_ptr.shape != (n + 1,):
        raise ValueError(f"{name}: graph does not match the problem")


def _graph_args(graph: ObsGraph, m: int):
    """The graph arguments of both K9 entries: obs_kf, obs_lm, lm_rowptr,
    lm_obs, M, kf_obs, chunk_ptr, kf_chunk_ptr, C."""
    return (graph.obs_kf32.data_ptr(), graph.obs_lm32.data_ptr(),
            graph.lm_rowptr.data_ptr(), graph.lm_obs.data_ptr(), m,
            graph.kf_obs.data_ptr(), graph.chunk_ptr.data_ptr(),
            graph.kf_chunk_ptr.data_ptr(), graph.n_chunks)


def _ptr(t):
    return 0 if t is None else t.data_ptr()


def reduced_matvec(v6: Optional[torch.Tensor], c: Optional[torch.Tensor], Jp, Jl,
                   Hll_inv, graph: ObsGraph, n: int, t_only: bool = False):
    """The observation part of the reduced camera matrix (K9).

    With t = Hlp v6 = sum_o J_lm,o^T J_pose,o v6[kf_o] per landmark and
    w = Hll_inv (t + c): returns Hpp(reproj) v6 - Hpl w (N, 6), i.e.
    sum_o J_pose,o^T (J_pose,o v6[kf_o]) - sum_o J_pose,o^T J_lm,o w[lm_o]
    per keyframe; or t (M, 3) alone with ``t_only``.  ``v6`` None stands for
    zeros (then the result is -Hpl Hll_inv c), ``c`` None for zeros.  All
    float64; Jp (O, 2, 6), Jl (O, 2, 3), Hll_inv (M, 3, 3).  CPU tensors
    take the plain version; CUDA tensors launch the kernel, or raise."""
    ts = (v6, c, Jp, Jl, Hll_inv, graph.kf_rowptr)
    if all(t is None or is_cpu(t) for t in ts):
        return reduced_matvec_plain(v6, c, Jp, Jl, Hll_inv, graph, n, t_only)
    dev = check_cuda("gba reduced matvec", *ts)
    o, m = Jp.shape[0], Hll_inv.shape[0]
    check_f64("gba reduced matvec", ("v6", v6, (n, 6)), ("c", c, (m, 3)),
              ("Jp", Jp, (o, 2, 6)), ("Jl", Jl, (o, 2, 3)), ("Hll_inv", Hll_inv, (m, 3, 3)))
    _check_graph("gba reduced matvec", graph, n, m, o)
    # one allocation: t (M, 3), then the scratch y (O, 2), w (M, 3), part
    # (C, 12), then out (N, 6)
    sizes = (3 * m, 2 * o, 3 * m, 12 * graph.n_chunks, 0 if t_only else 6 * n)
    buf = torch.empty(sum(sizes), dtype=torch.float64, device=dev)
    t_out, y, w_buf, part, out = torch.split(buf, sizes)
    lib = cuda_build.library("gba_reduced_matvec")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.covins_gba_reduced_matvec(
            _ptr(v6), _ptr(c), Jp.data_ptr(), Jl.data_ptr(), Hll_inv.data_ptr(),
            *_graph_args(graph, m), n, o, int(t_only),
            y.data_ptr(), t_out.data_ptr(), w_buf.data_ptr(), part.data_ptr(),
            out.data_ptr(), stream)
    cuda_build.check(rc, "gba reduced matvec")
    reduced_matvec.launches += 1
    return t_out.view(m, 3) if t_only else out.view(n, 6)


reduced_matvec.launches = 0


# --------------------------------------------------------- IMU and loops
_PRE_FIELDS = tuple(f.name for f in dataclasses.fields(imu_mod.Preintegrated))


def _imu_r(p: GBAProblem):
    """Whitened IMU residuals (..., F, 15) alone: [S9 r9, S6 (b_j - b_i)],
    with the leading state dimensions of ``p``'s states.  The cost
    evaluations take this and :func:`_loop_r`, not the `_r_J` functions,
    whose forward mode issues many times the operations on a step the host
    bounds."""
    i, j = p.imu_i, p.imu_j
    bi = p.biases[..., i, :]
    r9 = imu_mod.imu_residual(p.imu_pre, p.poses[..., i, :], p.vels[..., i, :],
                              bi[..., :3], bi[..., 3:], p.poses[..., j, :],
                              p.vels[..., j, :], gravity=p.gravity)
    rb = p.biases[..., j, :] - bi
    r = torch.cat([(p.imu_sqrt_info @ r9[..., None])[..., 0],
                   (p.bias_sqrt_info @ rb[..., None])[..., 0]], -1)
    mm = p.imu_mask.to(r.dtype) * p.kf_mask[i] * p.kf_mask[j]
    return r * mm[:, None]


def _imu_r_J(p: GBAProblem):
    """Per-factor whitened residual (F, 15) and Jacobian (F, 15, 30) w.r.t.
    [kf_i tangent(15), kf_j tangent(15)]."""
    i, j = p.imu_i, p.imu_j
    gravity = p.gravity

    def one(pose_i, vel_i, bias_i, pose_j, vel_j, bias_j, S9, S6, *pre_fields):
        pre = imu_mod.Preintegrated(*pre_fields)

        def r_of(xi):
            pi, vi, bi = _retract_kf(pose_i, vel_i, bias_i, xi[:15])
            pj, vj, bj = _retract_kf(pose_j, vel_j, bias_j, xi[15:])
            r9 = imu_mod.imu_residual(pre, pi, vi, bi[:3], bi[3:], pj, vj,
                                      gravity=gravity)
            r = torch.cat([S9 @ r9, S6 @ (bj - bi)])
            return r, r

        zero = torch.zeros(30, dtype=pose_i.dtype, device=pose_i.device)
        J, r = torch.func.jacfwd(r_of, has_aux=True)(zero)
        return r, J

    r, J = torch.func.vmap(one)(
        p.poses[i], p.vels[i], p.biases[i], p.poses[j], p.vels[j], p.biases[j],
        p.imu_sqrt_info, p.bias_sqrt_info,
        *(getattr(p.imu_pre, f) for f in _PRE_FIELDS))
    mm = p.imu_mask.to(r.dtype) * p.kf_mask[i] * p.kf_mask[j]
    return r * mm[:, None], J * mm[:, None, None]


def _loop_r(p: GBAProblem):
    """Whitened loop-edge residuals (..., L, 6), with the leading state
    dimensions of ``p``'s states."""
    r = res.six_dof_between_residual(p.poses[..., p.loop_i, :], p.poses[..., p.loop_j, :],
                                     p.loop_T)
    mm = p.loop_mask.to(r.dtype) * p.kf_mask[p.loop_i] * p.kf_mask[p.loop_j]
    return (p.loop_sqrt_info @ r[..., None])[..., 0] * mm[:, None]


def _loop_r_J(p: GBAProblem):
    """Per-loop-edge whitened residual (L, 6) and Jacobians (L, 6, 6) x 2
    (pose part only)."""

    def one(Ti, Tj, T_meas, S):
        def r_of(xi):
            r = S @ res.six_dof_between_residual(
                geo.pose_boxplus(Ti, xi[:6]), geo.pose_boxplus(Tj, xi[6:]), T_meas)
            return r, r

        zero = torch.zeros(12, dtype=Ti.dtype, device=Ti.device)
        J, r = torch.func.jacfwd(r_of, has_aux=True)(zero)
        return r, J[:, :6], J[:, 6:]

    r, Ji, Jj = torch.func.vmap(one)(p.poses[p.loop_i], p.poses[p.loop_j],
                                     p.loop_T, p.loop_sqrt_info)
    mm = (p.loop_mask.to(r.dtype) * p.kf_mask[p.loop_i] * p.kf_mask[p.loop_j])
    return r * mm[:, None], Ji * mm[:, None, None], Jj * mm[:, None, None]


def _bt(J, r):
    """sum_r J[..., r, i] r[..., r]: J^T r per factor."""
    return (J.transpose(-1, -2) @ r[..., None])[..., 0]


def _pad15(x6):
    """(N, 6) -> (N, 15) or (N, 6, 6) -> (N, 15, 15), zero-padded."""
    if x6.dim() == 2:
        return torch.nn.functional.pad(x6, (0, KF_DOF - 6))
    return torch.nn.functional.pad(x6, (0, KF_DOF - 6, 0, KF_DOF - 6))


def _with_state(p: GBAProblem, st) -> GBAProblem:
    """``p`` at the state ``st`` = (poses, vels, biases, lms)."""
    return dataclasses.replace(p, poses=st[0], vels=st[1], biases=st[2], lms=st[3])


def total_cost(p: GBAProblem, graph: ObsGraph, st, visual_only: bool,
               huber_k: float = 0.0, inputs: Optional[ReprojInputs] = None,
               allreduce=None):
    """Sum of the squared whitened residuals at state ``st`` = (poses,
    vels, biases, lms): a device scalar; or, with each of the four stacked
    over S states (a leading dimension, in place of the reference's
    ``jax.vmap``), the (S,) costs, whose reprojection sums are one K8
    launch.  A single state is evaluated as a stack of one.  ``inputs``
    as in :func:`reproj_blocks`.  ``allreduce`` (``*tensors -> tensors``,
    summed over the ranks that share the problem, see :func:`reduced_system`)
    sums the reprojection costs before the loop and IMU costs are added
    once."""
    single = st[0].dim() == 2
    pt = _with_state(p, tuple(x[None] for x in st) if single else st)
    c = reproj_blocks(pt, graph, huber_k, "cost", inputs)
    if allreduce is not None:
        c, = allreduce(c)
    r_l = _loop_r(pt)
    c = c + torch.sum(r_l * r_l, dim=(-2, -1))
    if not visual_only:
        r_f = _imu_r(pt)
        c = c + torch.sum(r_f * r_f, dim=(-2, -1))
    return c[0] if single else c


# ------------------------------------------------- one damped GN step
@dataclasses.dataclass(frozen=True)
class Factors:
    """The loop-edge and IMU factors' contiguous Jacobians of one Gauss-
    Newton step (the IMU ones None when visual only), their endpoints, and
    the node -> factor CSRs the PCG kernel sums their terms in: entry f < F
    is factor f's i end, F + f its j end; a node's entries are its i ends in
    factor order, then its j ends, the order of the plain version's
    index_adds."""

    loop_i: torch.Tensor  # (L,) int64
    loop_j: torch.Tensor
    Ji_l: torch.Tensor  # (L, 6, 6)
    Jj_l: torch.Tensor
    imu_i: torch.Tensor  # (F,) int64
    imu_j: torch.Tensor
    Ji_f: Optional[torch.Tensor]  # (F, 15, 15)
    Jj_f: Optional[torch.Tensor]
    loop_rowptr: torch.Tensor  # (N + 1,) int32
    loop_entries: torch.Tensor  # (2L,) int32
    imu_rowptr: torch.Tensor
    imu_entries: torch.Tensor
    loop_i32: torch.Tensor  # the endpoints as int32, for the kernel
    loop_j32: torch.Tensor
    imu_i32: torch.Tensor
    imu_j32: torch.Tensor


def factors(loop_i, loop_j, Ji_l, Jj_l, imu_i, imu_j, Ji_f, Jj_f, n: int) -> Factors:
    """:class:`Factors` with their node CSRs (no IMU terms when ``Ji_f`` is
    None)."""
    if Ji_f is None:
        imu_i = imu_j = loop_i[:0]
    else:
        Ji_f, Jj_f = Ji_f.contiguous(), Jj_f.contiguous()
    loop_rowptr, loop_entries = _csr(torch.cat([loop_i, loop_j]), n)
    imu_rowptr, imu_entries = _csr(torch.cat([imu_i, imu_j]), n)
    return Factors(loop_i, loop_j, Ji_l.contiguous(), Jj_l.contiguous(), imu_i, imu_j,
                   Ji_f, Jj_f, loop_rowptr, loop_entries, imu_rowptr, imu_entries,
                   *(t.to(torch.int32) for t in (loop_i, loop_j, imu_i, imu_j)))


@dataclasses.dataclass(frozen=True)
class ReducedSystem:
    """The damped reduced camera system of one Gauss-Newton step: Hpp -
    Hpl Hll^-1 Hlp + diag(lam_diag) on the free components, its right-hand
    side and block-Jacobi preconditioner, and what the landmark back-
    substitution needs."""

    b_red: torch.Tensor  # (N, 15)
    M_inv: torch.Tensor  # (N, 15, 15)
    free: torch.Tensor  # (N, 15) 0/1
    lam_diag: torch.Tensor  # (N, 15)
    Jp: torch.Tensor  # (O, 2, 6) whitened
    Jl: torch.Tensor  # (O, 2, 3)
    Hll_inv: torch.Tensor  # (M, 3, 3)
    b_l: torch.Tensor  # (M, 3)
    lm_free: torch.Tensor  # (M, 1)
    fac: Factors


def reduced_system(p: GBAProblem, graph: ObsGraph, state, lam, visual_only: bool,
                   huber_k: float = 0.0, inputs: Optional[ReprojInputs] = None,
                   allreduce=None) -> ReducedSystem:
    """Linearise at ``state`` and eliminate the landmarks (`gba.py:214-343`
    of the reference); ``lam`` is the Marquardt parameter, a device
    scalar; ``inputs`` as in :func:`reproj_blocks`.

    ``allreduce``: for a problem whose landmarks (with all their
    observations) are split over several ranks and whose keyframes, IMU and
    loop factors every rank holds whole, a function that sums tensors over
    those ranks (``*tensors -> tensors``).  It is called once, on the
    observation parts of the keyframe gradient, of the keyframe blocks and
    of -Hpl Hll^-1 b_l; the loop and IMU terms, the damping and the
    inverses are then added to the sums once, on every rank alike."""
    poses = state[0]
    pp = _with_state(p, state)
    n = poses.shape[0]
    dtype, dev = poses.dtype, poses.device
    # the gauge pins only the POSE of fixed keyframes; their velocity and
    # bias stay free (`optimization_be.cpp:88-89`)
    free_pose = (~p.kf_fixed & p.kf_mask).to(dtype)[:, None]
    free_vb = p.kf_mask.to(dtype)[:, None]
    free = torch.cat([free_pose.expand(n, 6), free_vb.expand(n, 9)], dim=-1)
    lm_free = p.lm_mask.to(dtype)[:, None]

    r_o, Jp_o, Jl_o, b6, M6, b_l, Hll = reproj_blocks(pp, graph, huber_k, "linearize",
                                                         inputs)
    # landmark blocks, damped, and their inverses (a landmark's
    # observations all lie on one rank), and the observation part of b_red
    b_l = b_l * lm_free
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    dll = torch.diagonal(Hll, dim1=-2, dim2=-1)
    Hll = Hll + lam * dll[..., None] * eye3 + 1e-10 * eye3
    Hll_inv = (linalg.inv33(Hll) * lm_free[..., None]).contiguous()
    c6 = reduced_matvec(None, b_l.contiguous(), Jp_o, Jl_o, Hll_inv, graph, n)
    if allreduce is not None:
        b6, M6, c6 = allreduce(b6, M6, c6)

    r_l, Ji_l, Jj_l = _loop_r_J(pp)
    Ji_f = Jj_f = None
    if not visual_only:
        r_f, J_f = _imu_r_J(pp)
        Ji_f, Jj_f = J_f[:, :, :15], J_f[:, :, 15:]

    # gradient b = -J^T r
    b6 = b6.index_add(0, p.loop_i, -_bt(Ji_l, r_l)).index_add(0, p.loop_j, -_bt(Jj_l, r_l))
    b_p = _pad15(b6)
    if not visual_only:
        b_p = b_p.index_add(0, p.imu_i, -_bt(Ji_f, r_f)).index_add(0, p.imu_j, -_bt(Jj_f, r_f))
    b_p = b_p * free

    # block-Jacobi blocks of Hpp (also the Marquardt diagonal)
    M6 = M6.index_add(0, p.loop_i, Ji_l.transpose(-1, -2) @ Ji_l).index_add(
        0, p.loop_j, Jj_l.transpose(-1, -2) @ Jj_l)
    M_blocks = _pad15(M6)
    if not visual_only:
        M_blocks = M_blocks.index_add(0, p.imu_i, Ji_f.transpose(-1, -2) @ Ji_f).index_add(
            0, p.imu_j, Jj_f.transpose(-1, -2) @ Jj_f)
    dpp = torch.diagonal(M_blocks, dim1=-2, dim2=-1)
    lam_diag = lam * dpp + 1e-8
    M_inv = linalg.inv_psd_small(M_blocks + torch.diag_embed(lam_diag))

    b_red = (b_p + _pad15(c6)) * free
    fac = factors(p.loop_i, p.loop_j, Ji_l, Jj_l, p.imu_i, p.imu_j, Ji_f, Jj_f, n)
    return ReducedSystem(b_red, M_inv, free, lam_diag, Jp_o, Jl_o, Hll_inv, b_l, lm_free,
                         fac)


def _hpp_factors(v, out6, fac: Factors):
    """Add the loop-edge and IMU terms of Hpp v to the observation part
    ``out6``; returns (N, 15)."""
    v6 = v[:, :6]
    y_l = (fac.Ji_l @ v6[fac.loop_i][..., None])[..., 0] \
        + (fac.Jj_l @ v6[fac.loop_j][..., None])[..., 0]
    out6 = out6.index_add(0, fac.loop_i, _bt(fac.Ji_l, y_l)).index_add(
        0, fac.loop_j, _bt(fac.Jj_l, y_l))
    out = _pad15(out6)
    if fac.Ji_f is not None:
        y_f = (fac.Ji_f @ v[fac.imu_i][..., None])[..., 0] \
            + (fac.Jj_f @ v[fac.imu_j][..., None])[..., 0]
        out = out.index_add(0, fac.imu_i, _bt(fac.Ji_f, y_f)).index_add(
            0, fac.imu_j, _bt(fac.Jj_f, y_f))
    return out


def reduced_Hv(s: ReducedSystem, graph: ObsGraph, v, matvec=None):
    """The damped reduced camera matrix times v (N, 15), its observation
    part through ``matvec`` (K9, :func:`reduced_matvec`, by default)."""
    v = v * s.free
    obs6 = (matvec or reduced_matvec)(v[:, :6].contiguous(), None, s.Jp, s.Jl, s.Hll_inv,
                                      graph, v.shape[0])
    return _hpp_factors(v, obs6, s.fac) * s.free + s.lam_diag * v


def _apply_M(s: ReducedSystem, r):
    return (s.M_inv @ r[..., None])[..., 0] * s.free


def _safe_div(a, b):
    return a / torch.where(torch.abs(b) < 1e-30, 1e-30, b)


def pcg_plain(s: ReducedSystem, graph: ObsGraph, n_cg: int, matvec=None, total=torch.sum):
    """Plain version of :func:`pcg`: Chronopoulos-Gear PCG, both scalars
    of an iteration from the same vectors, algebraically identical to the
    classic loop; eager PyTorch around K9 (any device), or around another
    observation ``matvec`` (:func:`reduced_Hv`), with each of the two
    reductions per iteration ``total`` of a product."""
    r = s.b_red
    u = _apply_M(s, r)
    w = reduced_Hv(s, graph, u, matvec)
    gamma = total(r * u)
    alpha = _safe_div(gamma, total(w * u))
    x = torch.zeros_like(s.b_red)
    pvec, svec = u, w
    for _ in range(n_cg):
        x = x + alpha * pvec
        r = r - alpha * svec
        u = _apply_M(s, r)
        w = reduced_Hv(s, graph, u, matvec)
        gamma1 = total(r * u)
        delta1 = total(w * u)
        beta1 = _safe_div(gamma1, gamma)
        alpha = _safe_div(gamma1, delta1 - _safe_div(beta1 * gamma1, alpha))
        pvec = u + beta1 * pvec
        svec = w + beta1 * svec
        gamma = gamma1
    return x


def _pcg_classic(s: ReducedSystem, graph: ObsGraph, n_cg: int, matvec=None):
    x, r = torch.zeros_like(s.b_red), s.b_red
    z = _apply_M(s, s.b_red)
    pvec = z
    for _ in range(n_cg):
        Hp = reduced_Hv(s, graph, pvec, matvec)
        rz = torch.sum(r * z)
        alpha = _safe_div(rz, torch.sum(pvec * Hp))
        x = x + alpha * pvec
        r = r - alpha * Hp
        z = _apply_M(s, r)
        beta = _safe_div(torch.sum(r * z), rz)
        pvec = z + beta * pvec
    return x


def _check_pcg(s: ReducedSystem, graph: ObsGraph, n_cg: int):
    """Raise unless ``s`` and ``graph`` are what the PCG kernel reads
    (contiguous float64 blocks of matching shapes, matching CSRs);
    returns the loop-edge and IMU factor counts."""
    n, o, m = s.b_red.shape[0], s.Jp.shape[0], s.Hll_inv.shape[0]
    fac = s.fac
    n_loop = fac.loop_i.shape[0]
    n_imu = 0 if fac.Ji_f is None else fac.imu_i.shape[0]
    check_f64("gba pcg", ("b_red", s.b_red, (n, 15)), ("M_inv", s.M_inv, (n, 15, 15)),
              ("free", s.free, (n, 15)), ("lam_diag", s.lam_diag, (n, 15)),
              ("Jp", s.Jp, (o, 2, 6)), ("Jl", s.Jl, (o, 2, 3)), ("Hll_inv", s.Hll_inv, (m, 3, 3)),
              ("Ji_l", fac.Ji_l, (n_loop, 6, 6)), ("Jj_l", fac.Jj_l, (n_loop, 6, 6)),
              ("Ji_f", fac.Ji_f, (n_imu, 15, 15)), ("Jj_f", fac.Jj_f, (n_imu, 15, 15)))
    _check_graph("gba pcg", graph, n, m, o)
    if fac.loop_rowptr.shape != (n + 1,) or fac.imu_rowptr.shape != (n + 1,):
        raise ValueError("gba pcg: factor CSRs do not match the problem")
    if n_cg < 0:
        raise ValueError(f"gba pcg: n_cg must be >= 0, got {n_cg}")
    return n_loop, n_imu


def pcg(s: ReducedSystem, graph: ObsGraph, n_cg: int):
    """Solve the reduced camera system by ``n_cg`` iterations of
    Chronopoulos-Gear block-Jacobi PCG from x = 0; returns x (N, 15).  CPU
    tensors take the plain version; CUDA tensors run the whole loop in one
    cooperative launch of the K9 source's PCG kernel, or raise."""
    ts = (s.b_red, s.M_inv, s.free, s.lam_diag, s.Jp, s.Jl, s.Hll_inv, s.fac.Ji_l,
          s.fac.Ji_f, graph.kf_rowptr)
    if all(t is None or is_cpu(t) for t in ts):
        return pcg_plain(s, graph, n_cg)
    dev = check_cuda("gba pcg", *ts)
    n_loop, n_imu = _check_pcg(s, graph, n_cg)
    n, o, m = s.b_red.shape[0], s.Jp.shape[0], s.Hll_inv.shape[0]
    fac = s.fac
    # one allocation: x (the result), r, u, v, p, s, w (N, 15) each, then
    # the scratch y (O, 2), w_lm (M, 3), part (C, 12), the loop and IMU
    # ends' J^T y (2L, 6), (2F, 15) and the block slots
    sizes = (7 * 15 * n, 2 * o, 3 * m, 12 * graph.n_chunks, 12 * n_loop,
             30 * n_imu, 2 * cuda_build.SLOT_CAP)
    buf = torch.empty(sum(sizes), dtype=torch.float64, device=dev)
    parts = torch.split(buf, sizes)
    lib = cuda_build.library("gba_reduced_matvec")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.covins_gba_pcg(
            *(t.data_ptr() for t in (s.b_red, s.M_inv, s.free, s.lam_diag, s.Jp, s.Jl,
                                     s.Hll_inv)), *_graph_args(graph, m), n, o,
            fac.loop_i32.data_ptr(), fac.loop_j32.data_ptr(), fac.Ji_l.data_ptr(),
            fac.Jj_l.data_ptr(), n_loop, fac.loop_rowptr.data_ptr(),
            fac.loop_entries.data_ptr(), fac.imu_i32.data_ptr(), fac.imu_j32.data_ptr(),
            _ptr(fac.Ji_f), _ptr(fac.Jj_f), n_imu, fac.imu_rowptr.data_ptr(),
            fac.imu_entries.data_ptr(), int(n_cg), *(t.data_ptr() for t in parts),
            cuda_build.SLOT_CAP, stream)
    cuda_build.check(rc, "gba pcg")
    pcg.launches += 1
    return parts[0][:15 * n].view(n, 15)


pcg.launches = 0


def _gn_schur_step(p: GBAProblem, graph: ObsGraph, state, lam, n_cg: int,
                   visual_only: bool, huber_k: float = 0.0,
                   cg_variant: str = "fused", inputs: Optional[ReprojInputs] = None,
                   allreduce=None):
    """One Levenberg-Marquardt step with Schur landmark elimination
    (`gba.py:214-450` of the reference).  ``lam`` is the adaptive
    Marquardt parameter, a device scalar; ``inputs`` as in
    :func:`reproj_blocks`; returns (state, lam, cost).

    ``allreduce`` as in :func:`reduced_system`, for a problem split by
    landmarks over several ranks (`parallel.sharding.gba_step_sharded`):
    the reduced system's observation sums, each PCG matvec's observation
    part (K9, then the sum) and the ladder's reprojection costs are summed
    over the ranks, one call each.  The PCG then runs as the eager loop
    (:func:`pcg_plain`, or the classic one), since a collective cannot run
    inside the persistent PCG kernel."""
    poses, vels, biases, lms = state
    n = poses.shape[0]
    if inputs is None:
        inputs = reproj_inputs(p)
    s = reduced_system(p, graph, state, lam, visual_only, huber_k, inputs, allreduce)
    matvec = None
    if allreduce is not None:
        def matvec(*args):
            return allreduce(reduced_matvec(*args))[0]
    if cg_variant == "classic":
        dx_p = _pcg_classic(s, graph, n_cg, matvec)
    elif cg_variant == "fused":
        dx_p = pcg(s, graph, n_cg) if matvec is None else pcg_plain(s, graph, n_cg, matvec)
    else:
        raise ValueError(f"unknown cg_variant {cg_variant!r}")
    dx_p = dx_p * s.free

    # the step-length ladder: every scale's cost, the best one taken if it
    # lowers the cost
    def state_at(alpha):
        dxp = alpha * dx_p
        t = reduced_matvec(dxp[:, :6].contiguous(), None, s.Jp, s.Jl, s.Hll_inv, graph,
                           n, t_only=True)
        dxl = (s.Hll_inv @ (s.b_l - t)[..., None])[..., 0] * s.lm_free
        return (geo.pose_boxplus(poses, dxp[:, :6]), vels + dxp[:, 6:9],
                biases + dxp[:, 9:15], lms + dxl)

    # the six scales and the current state, stacked, in one cost evaluation
    cands = tuple(torch.stack([*cs, old]) for cs, old in
                  zip(zip(*(state_at(a) for a in LADDER)), state))
    costs = total_cost(p, graph, cands, visual_only, huber_k, inputs, allreduce)
    best = torch.argmin(costs[:-1])
    c_best = costs[best]
    c_old = costs[-1]
    accept = c_best < c_old
    pick = best.reshape(1)
    out = tuple(torch.where(accept, torch.index_select(cs, 0, pick)[0], old)
                for cs, old in zip(cands, state))
    # LM damping: shrink after a clean full step, grow when the step had
    # to be shortened or was rejected
    lam_new = torch.where(accept, torch.where(best == 0, lam / 3.0, lam * 2.0),
                          lam * 10.0)
    lam_new = torch.clamp(lam_new, 1e-12, 1e8)
    return out, lam_new, torch.minimum(c_best, c_old)


def _gba_rounds(p: GBAProblem, graph: ObsGraph, n_gn: int, n_cg: int, lam0: float,
                visual_only: bool, huber_k: float = 0.0):
    """``n_gn`` steps from ``p``'s state, with its :class:`ReprojInputs`
    built once for them all."""
    state = (p.poses, p.vels, p.biases, p.lms)
    lam = torch.tensor(lam0, dtype=p.poses.dtype, device=p.poses.device)
    inputs = reproj_inputs(p)
    costs = []
    for _ in range(n_gn):
        state, lam, cost = _gn_schur_step(p, graph, state, lam, n_cg, visual_only,
                                          huber_k, inputs=inputs)
        costs.append(cost)
    return state, torch.stack(costs)


def _reproj_outlier_mask(p: GBAProblem, graph: ObsGraph, threshold: float):
    """Per-observation pruning at `th_gba_outlier_global` on the whitened
    pixel residual norm (`optimization_be.cpp:269-292`)."""
    norms, valid = reproj_blocks(p, graph, 0.0, "outlier")
    return p.obs_mask & valid & (norms < threshold)


def global_bundle_adjustment(p: GBAProblem, n_gn: int = 10, n_cg: int = 60,
                             lam0: float = 1e-4, visual_only: bool = False,
                             outlier_removal: bool = True, th_outlier: float = 0.92,
                             n_gn_round1: int = 5,
                             time_budget_s: Optional[float] = None,
                             th_huber: float = 2.447):
    """Two-round VI-GBA (`optimization_be.cpp:56-618`): a Huber-robust
    round 1 of ``n_gn_round1`` steps, pruning of reprojection outliers,
    then a clean round 2 of ``n_gn`` steps.  ``time_budget_s`` skips round
    2 when round 1 exhausted it (one host sync after round 1).

    Returns (problem with the optimised states and observation mask, info
    with ``costs``, ``round1_costs`` (device tensors), ``n_pruned`` and,
    when the budget cut the solve, ``time_budget_hit``)."""
    t0 = time.perf_counter()
    graph = obs_graph(p)
    info = {}
    if outlier_removal:
        st, costs1 = _gba_rounds(p, graph, n_gn_round1, n_cg, lam0, visual_only,
                                 th_huber)
        p = _with_state(p, st)
        new_mask = _reproj_outlier_mask(p, graph, th_outlier)
        info["n_pruned"] = int(torch.sum(p.obs_mask & ~new_mask))
        info["round1_costs"] = costs1
        p = dataclasses.replace(p, obs_mask=new_mask)
        if time_budget_s is not None:
            if p.poses.device.type == "cuda":
                torch.cuda.synchronize(p.poses.device)
            if time.perf_counter() - t0 > time_budget_s:
                info["costs"] = costs1
                info["time_budget_hit"] = True
                return p, info
    st, costs2 = _gba_rounds(p, graph, n_gn, n_cg, lam0, visual_only, 0.0)
    info["costs"] = costs2
    return _with_state(p, st), info


def imu_sqrt_info_from_cov(cov, jitter: float = 1e-10):
    """(..., 9, 9) covariance -> upper-Cholesky sqrt information."""
    eye = torch.eye(cov.shape[-1], dtype=cov.dtype, device=cov.device)
    info = linalg.inv_psd_small(cov + jitter * eye)
    return linalg.cholesky_small(info).transpose(-1, -2)


def bias_walk_sqrt_info(noise: imu_mod.ImuNoise, dt):
    """Random-walk sqrt-info (..., 6, 6) of the bias-difference residual."""
    dt = torch.clamp(dt, min=1e-6)
    sg = (noise.gyro_walk * torch.sqrt(dt))[..., None]
    sa = (noise.acc_walk * torch.sqrt(dt))[..., None]
    d = torch.cat([(1.0 / sg).expand(dt.shape + (3,)),
                   (1.0 / sa).expand(dt.shape + (3,))], dim=-1)
    return torch.diag_embed(d)
