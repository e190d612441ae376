"""On-manifold IMU preintegration (Forster et al., TRO'16).

Counterpart of `covins_tpu/ops/imu.py`: raw samples kept in fixed-capacity
padded arrays with a validity mask, propagated with a midpoint-attitude
scheme, the covariance of [phi, dv, dp] propagated in closed form, and the
bias Jacobians of the first-order bias correction taken by forward-mode
differentiation through the sample loop, as the reference takes them with
``jax.jacfwd``.

:func:`preintegrate` is batched over factors and is the K10 kernel on the
card (`csrc/imu_preintegrate.cu`): one warp per factor walks its samples
in order, every lane on the primal values and lane k < 6 also on tangent
k of the deltas (the gyro and accel biases), so its Jacobian is the same
forward-mode computation; the covariance's two 9x9 products are spread
over the warp's lanes.  :func:`preintegrate_plain` is its plain version: one batched
pass for the deltas and the covariance, then ``torch.func.vmap`` of
``torch.func.jacfwd`` for the Jacobian, as the reference.
"""

from __future__ import annotations

import dataclasses

import torch

from covins_tpu_torch import cuda_build
from covins_tpu_torch.device import check_cuda, is_cpu
from covins_tpu_torch.utils import geometry as geo

GRAVITY = 9.81


@dataclasses.dataclass(frozen=True)
class Preintegrated:
    dq: torch.Tensor  # (..., 4) delta rotation body_i -> body_j
    dv: torch.Tensor  # (..., 3)
    dp: torch.Tensor  # (..., 3)
    J_q_bg: torch.Tensor  # (..., 3, 3) d Log(dq_ref^-1 dq(bg)) / d bg
    J_v_bg: torch.Tensor  # (..., 3, 3)
    J_v_ba: torch.Tensor  # (..., 3, 3)
    J_p_bg: torch.Tensor  # (..., 3, 3)
    J_p_ba: torch.Tensor  # (..., 3, 3)
    cov: torch.Tensor  # (..., 9, 9) covariance of [phi, dv, dp]
    dt: torch.Tensor  # (...,) total integration time
    bg_ref: torch.Tensor  # (..., 3) gyro bias used for propagation
    ba_ref: torch.Tensor  # (..., 3) accel bias used for propagation


@dataclasses.dataclass(frozen=True)
class ImuNoise:
    """Continuous-time noise densities (EuRoC-style units)."""

    acc_noise: float  # m/s^2 / sqrt(Hz)
    gyro_noise: float  # rad/s / sqrt(Hz)
    acc_walk: float  # m/s^3 / sqrt(Hz)
    gyro_walk: float  # rad/s^2 / sqrt(Hz)


def default_noise() -> ImuNoise:
    # EuRoC MAV ADIS16448 datasheet values used across the reference configs
    return ImuNoise(acc_noise=2.0e-3, gyro_noise=1.7e-4, acc_walk=3.0e-3,
                    gyro_walk=2.0e-5)


def _right_jacobian(theta_vec):
    """Right Jacobian of SO(3)."""
    t = geo._safe_norm(theta_vec)[..., None]
    W = geo.so3_hat(theta_vec)
    W2 = W @ W
    eye = torch.eye(3, dtype=theta_vec.dtype, device=theta_vec.device)
    t2 = t * t
    small = t < 1e-5
    a = torch.where(small, 0.5 - t2 / 24.0,
                    (1.0 - torch.cos(t)) / torch.clamp(t2, min=1e-24))
    b = torch.where(small, 1.0 / 6.0 - t2 / 120.0,
                    (t - torch.sin(t)) / torch.clamp(t2 * t, min=1e-24))
    return eye - a * W + b * W2


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def _propagate(acc, gyro, dts, mask, bg, ba, noise: ImuNoise, with_cov: bool):
    """Loop over the samples (axis -2 of acc / gyro, -1 of dts / mask),
    batched over any leading dims.  Returns (dq, dv, dp, cov, dt_total);
    ``cov`` is None without ``with_cov``."""
    lead = acc.shape[:-2]
    kw = dict(dtype=acc.dtype, device=acc.device)
    dq = geo.pose_identity(**kw)[:4].expand(lead + (4,))
    dv = dp = torch.zeros(lead + (3,), **kw)
    T = torch.zeros(lead, **kw)
    cov = torch.zeros(lead + (9, 9), **kw) if with_cov else None
    eye = torch.eye(3, **kw).expand(lead + (3, 3))
    zero = torch.zeros(lead + (3, 3), **kw)
    for s in range(acc.shape[-2]):
        m = mask[..., s]
        dt = dts[..., s] * m  # masked samples integrate for 0 seconds
        dt1 = dt[..., None]
        a_hat = acc[..., s, :] - ba
        w_hat = gyro[..., s, :] - bg
        dtheta = w_hat * dt1
        dq_inc = geo.quat_exp(dtheta)
        # midpoint attitude for the specific-force rotation (2nd order)
        R = geo.quat_to_matrix(geo.quat_multiply(dq, geo.quat_exp(0.5 * dtheta)))
        Ra = _mv(R, a_hat)
        dp_new = dp + dv * dt1 + 0.5 * Ra * dt1 * dt1
        dv_new = dv + Ra * dt1
        dq_new = geo.quat_normalize(geo.quat_multiply(dq, dq_inc))
        if with_cov:
            dt2 = dt[..., None, None]
            A = geo.so3_hat(Ra)
            dR_inc_T = geo.quat_to_matrix(dq_inc).transpose(-1, -2)
            Jr = _right_jacobian(dtheta)
            F = torch.cat([
                torch.cat([dR_inc_T, zero, zero], -1),
                torch.cat([-A * dt2, eye, zero], -1),
                torch.cat([-0.5 * A * dt2 * dt2, eye * dt2, eye], -1)], -2)
            G = torch.cat([
                torch.cat([Jr * dt2, zero], -1),
                torch.cat([zero, R * dt2], -1),
                torch.cat([zero, 0.5 * R * dt2 * dt2], -1)], -2)
            dt_safe = torch.clamp(dt, min=1e-9)[..., None]
            qdiag = torch.cat([(noise.gyro_noise ** 2 / dt_safe).expand(lead + (3,)),
                               (noise.acc_noise ** 2 / dt_safe).expand(lead + (3,))], -1)
            cov_new = F @ cov @ F.transpose(-1, -2) \
                + (G * qdiag[..., None, :]) @ G.transpose(-1, -2)
            cov = torch.where(m[..., None, None] > 0, cov_new, cov)
        dq, dv, dp, T = dq_new, dv_new, dp_new, T + dt
    return dq, dv, dp, cov, T


def _from_jacobian(dq, dv, dp, J, cov, T, bg, ba) -> Preintegrated:
    return Preintegrated(
        dq=dq, dv=dv, dp=dp,
        J_q_bg=J[..., 0:3, 0:3],
        J_v_bg=J[..., 3:6, 0:3], J_v_ba=J[..., 3:6, 3:6],
        J_p_bg=J[..., 6:9, 0:3], J_p_ba=J[..., 6:9, 3:6],
        cov=cov, dt=T, bg_ref=bg, ba_ref=ba)


def preintegrate_plain(acc, gyro, dts, mask, bg, ba, noise: ImuNoise) -> Preintegrated:
    """Plain version of :func:`preintegrate` (any device): the batched
    propagation, then the (9, 6) bias Jacobian of [phi, dv, dp] by
    ``torch.func.jacfwd`` through a second propagation, per factor."""
    dq, dv, dp, cov, T = _propagate(acc, gyro, dts, mask, bg, ba, noise, True)

    def one(a, g, d, mk, b, dq_ref):
        dq_ref_conj = geo.quat_conjugate(dq_ref)

        def deltas(bb):
            dq2, dv2, dp2, _, _ = _propagate(a, g, d, mk, bb[:3], bb[3:], noise, False)
            phi = geo.quat_log(geo.quat_multiply(dq_ref_conj, dq2))
            return torch.cat([phi, dv2, dp2])

        return torch.func.jacfwd(deltas)(b)

    J = torch.func.vmap(one)(acc, gyro, dts, mask, torch.cat([bg, ba], -1), dq)
    return _from_jacobian(dq, dv, dp, J, cov, T, bg, ba)


def preintegrate(acc, gyro, dts, mask, bg, ba, noise: ImuNoise) -> Preintegrated:
    """Integrate raw IMU samples of F factors into relative motion
    constraints.

    acc, gyro: (F, S, 3) body-frame samples (accel includes gravity);
    dts: (F, S) per-sample intervals; mask: (F, S) 1.0 valid / 0.0 padding;
    bg, ba: (F, 3) biases at which to propagate; all float64.  Returns a
    batched `Preintegrated` with forward-mode bias Jacobians.  CPU tensors
    take the plain version; CUDA tensors launch K10, or raise."""
    ts = (acc, gyro, dts, mask, bg, ba)
    if all(is_cpu(t) for t in ts):
        return preintegrate_plain(acc, gyro, dts, mask, bg, ba, noise)
    dev = check_cuda("imu preintegrate", *ts)
    f, s = dts.shape
    for name, t, shape in (("acc", acc, (f, s, 3)), ("gyro", gyro, (f, s, 3)),
                           ("dts", dts, (f, s)), ("mask", mask, (f, s)),
                           ("bg", bg, (f, 3)), ("ba", ba, (f, 3))):
        if t.shape != shape or t.dtype != torch.float64 or not t.is_contiguous():
            raise ValueError(f"imu preintegrate: {name} must be a contiguous {shape} "
                             f"float64 tensor, got {tuple(t.shape)} {t.dtype}")
    kw = dict(dtype=torch.float64, device=dev)
    dq = torch.empty((f, 4), **kw)
    dv = torch.empty((f, 3), **kw)
    dp = torch.empty((f, 3), **kw)
    J = torch.empty((f, 9, 6), **kw)
    cov = torch.empty((f, 9, 9), **kw)
    T = torch.empty((f,), **kw)
    lib = cuda_build.library("imu_preintegrate")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.covins_imu_preintegrate(
            acc.data_ptr(), gyro.data_ptr(), dts.data_ptr(), mask.data_ptr(),
            bg.data_ptr(), ba.data_ptr(), f, s,
            float(noise.gyro_noise), float(noise.acc_noise),
            dq.data_ptr(), dv.data_ptr(), dp.data_ptr(), J.data_ptr(),
            cov.data_ptr(), T.data_ptr(), stream)
    cuda_build.check(rc, "imu preintegrate")
    preintegrate.launches += 1
    return _from_jacobian(dq, dv, dp, J, cov, T, bg, ba)


preintegrate.launches = 0


def bias_corrected_delta(pre: Preintegrated, bg, ba):
    """First-order-corrected (dq, dv, dp) at new biases (bg, ba)."""
    dbg = bg - pre.bg_ref
    dba = ba - pre.ba_ref
    dq = geo.quat_multiply(pre.dq, geo.quat_exp(_mv(pre.J_q_bg, dbg)))
    dv = pre.dv + _mv(pre.J_v_bg, dbg) + _mv(pre.J_v_ba, dba)
    dp = pre.dp + _mv(pre.J_p_bg, dbg) + _mv(pre.J_p_ba, dba)
    return dq, dv, dp


def imu_residual(pre: Preintegrated, pose_i, vel_i, bg_i, ba_i, pose_j, vel_j,
                 gravity=None):
    """9-vector residual [r_phi, r_v, r_p] of the preintegration factor;
    poses are T_w_s, gravity points down in the world (-z by default)."""
    if gravity is None:
        gravity = torch.tensor([0.0, 0.0, -GRAVITY], dtype=pose_i.dtype,
                               device=pose_i.device)
    dq, dv, dp = bias_corrected_delta(pre, bg_i, ba_i)
    q_i, p_i = geo.pose_q(pose_i), geo.pose_t(pose_i)
    q_j, p_j = geo.pose_q(pose_j), geo.pose_t(pose_j)
    q_i_inv = geo.quat_conjugate(q_i)
    dt = pre.dt[..., None]
    q_ij = geo.quat_multiply(q_i_inv, q_j)
    r_phi = geo.quat_log(geo.quat_multiply(geo.quat_conjugate(dq), q_ij))
    r_v = geo.quat_rotate(q_i_inv, vel_j - vel_i - gravity * dt) - dv
    r_p = geo.quat_rotate(q_i_inv, p_j - p_i - vel_i * dt - 0.5 * gravity * dt * dt) - dp
    return torch.cat([r_phi, r_v, r_p], dim=-1)


def fuse_samples(acc1, gyro1, dts1, mask1, acc2, gyro2, dts2, mask2):
    """Concatenate two raw sample windows along the sample axis (keyframe
    culling merges the removed KF's window into its successor's,
    `keyframe_be.cpp:413-440`); the caller re-propagates afterwards."""
    return (torch.cat([acc1, acc2], dim=-2), torch.cat([gyro1, gyro2], dim=-2),
            torch.cat([dts1, dts2], dim=-1), torch.cat([mask1, mask2], dim=-1))
