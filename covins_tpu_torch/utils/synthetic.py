"""Synthetic visual-inertial trajectory generator.

Counterpart of `covins_tpu/utils/synthetic.py`: the same analytic
figure-8 trajectory and orientation sweep, with exact body-frame IMU
samples from `torch.func.jacfwd` derivatives (float64, on the CPU: this is
test-data generation, not device work).  Landmarks are drawn with numpy
from a seed, so they differ from the JAX package's `jax.random` draws.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

GRAVITY = 9.81


@dataclasses.dataclass
class SyntheticTrajectory:
    times: np.ndarray  # (K,) keyframe timestamps
    poses: np.ndarray  # (K, 7) T_w_s ground truth
    vels: np.ndarray  # (K, 3) world-frame velocities
    imu_acc: np.ndarray  # (K-1, S, 3) body-frame accel samples between KFs
    imu_gyro: np.ndarray  # (K-1, S, 3)
    imu_dts: np.ndarray  # (K-1, S)
    imu_mask: np.ndarray  # (K-1, S)


def _quat_normalize(q):
    q = q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True),
                        min=1e-12)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def _quat_exp(w):
    theta = torch.sqrt(torch.clamp((w * w).sum(-1, keepdim=True), min=1e-24))
    half = 0.5 * theta
    sinc = torch.where(theta < 1e-6, 0.5 - theta**2 / 48.0,
                       torch.sin(half) / torch.clamp(theta, min=1e-24))
    return _quat_normalize(torch.cat([torch.cos(half), sinc * w], dim=-1))


def _quat_multiply(q1, q2):
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], dim=-1)


def _quat_to_matrix(q):
    w, x, y, z = q.unbind(-1)
    r = torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], dim=-1)
    return r.reshape(q.shape[:-1] + (3, 3))


def _position(t, radius=5.0, climb=0.15, freq=0.25):
    """Smooth figure-8-ish 3D curve."""
    w = 2.0 * math.pi * freq
    return torch.stack([
        radius * torch.sin(w * t),
        radius * 0.6 * torch.sin(2.0 * w * t),
        climb * t + 0.4 * torch.sin(0.7 * w * t),
    ], dim=-1)


def _orientation(t):
    """Smoothly varying body orientation (yaw sweep + gentle roll/pitch)."""
    w = 2.0 * math.pi * 0.25
    yaw = 0.6 * torch.sin(0.5 * w * t)
    pitch = 0.15 * torch.sin(0.9 * w * t + 0.3)
    roll = 0.1 * torch.sin(1.3 * w * t + 1.1)
    z = torch.zeros_like(t)
    qz = _quat_exp(torch.stack([z, z, yaw], -1))
    qy = _quat_exp(torch.stack([z, pitch, z], -1))
    qx = _quat_exp(torch.stack([roll, z, z], -1))
    return _quat_multiply(_quat_multiply(qz, qy), qx)


def imu_from_trajectory(t):
    """Exact body-frame IMU measurements at scalar time ``t``."""
    jac = torch.func.jacfwd
    acc_w = jac(jac(_position))(t)
    R = _quat_to_matrix(_orientation(t))
    dR = jac(lambda s: _quat_to_matrix(_orientation(s)))(t)
    Wb = R.T @ dR  # angular velocity: w = vee(R^T dR/dt)
    gyro = torch.stack([Wb[2, 1], Wb[0, 2], Wb[1, 0]])
    g_w = torch.tensor([0.0, 0.0, -GRAVITY], dtype=t.dtype)
    acc_body = R.T @ (acc_w - g_w)  # accelerometer measures f = a - g
    return acc_body, gyro


def generate(n_keyframes=20, kf_dt=0.5, imu_rate=200.0, t0=0.0
             ) -> SyntheticTrajectory:
    """Trajectory with exact IMU samples at interval midpoints between
    keyframes (second-order consistent with the preintegrator)."""
    times = t0 + torch.arange(n_keyframes, dtype=torch.float64) * kf_dt
    poses = torch.cat([_quat_normalize(_orientation(times)), _position(times)],
                      dim=-1)
    vels = torch.func.vmap(torch.func.jacfwd(_position))(times)
    samples_per_kf = int(round(kf_dt * imu_rate))
    dt_s = kf_dt / samples_per_kf
    offs = (torch.arange(samples_per_kf, dtype=torch.float64) + 0.5) * dt_s
    seg_t = (times[:-1, None] + offs[None, :]).reshape(-1)
    acc, gyro = torch.func.vmap(imu_from_trajectory)(seg_t)
    shape = (n_keyframes - 1, samples_per_kf)
    return SyntheticTrajectory(
        times.numpy(), poses.numpy(), vels.numpy(),
        acc.reshape(shape + (3,)).numpy(), gyro.reshape(shape + (3,)).numpy(),
        np.full(shape, dt_s), np.ones(shape))


def generate_landmarks(rng: np.random.Generator, n=500, radius=12.0):
    """Landmarks scattered around the trajectory volume."""
    pts = rng.uniform(-1.0, 1.0, (n, 3))
    return pts * np.asarray([radius, radius, radius * 0.4]) + np.asarray(
        [0.0, 0.0, 2.0])


# forward-looking camera of the GBA problems: optical axis = body x, i.e.
# R_s_c = [[0, 0, 1], [-1, 0, 0], [0, -1, 0]] as a quaternion
_T_S_C_FORWARD = (0.5, -0.5, 0.5, -0.5, 0.0, 0.0, 0.0)


def build_gba_problem(n_kf=12, n_lm=96, seed=0, max_obs=None, device=None):
    """Synthetic visual-inertial GBA problem, the counterpart of the JAX
    package's `__graft_entry__._build_problem` (bench.py's GBA leg): the
    figure-8 trajectory with exact IMU at 100 Hz, ``n_lm`` landmarks, a
    forward-looking pinhole-radtan camera (458, 457, 376, 240, zero
    distortion), every landmark seen by every keyframe that has it in
    front (z > 0.3) and inside the 752 x 480 image, the visibility list
    subsampled with a stride to at most ``max_obs``, padded to a multiple
    of 8; keyframe 0 fixed, the others' poses perturbed by 0.02 per tangent
    component.  The draws are numpy's (``seed``), not ``jax.random``'s, so
    landmarks, perturbations and the observation count differ from the
    reference's.  Returns (problem on ``device``, ground-truth poses
    (K, 7), ground-truth landmarks (n_lm, 3)), numpy for the ground truth."""
    from covins_tpu_torch.device import resolve_device
    from covins_tpu_torch.ops import gba, imu
    from covins_tpu_torch.utils import cameras as cam_mod
    from covins_tpu_torch.utils import geometry as geo

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    traj = generate(n_keyframes=n_kf, kf_dt=0.5, imu_rate=100.0)
    lms_gt = generate_landmarks(rng, n=n_lm)
    cam_cpu = cam_mod.Camera(
        intrinsics=torch.tensor([458.0, 457.0, 376.0, 240.0, 0.0], dtype=torch.float64),
        dist=torch.zeros(4, dtype=torch.float64),
        T_s_c=torch.tensor(_T_S_C_FORWARD, dtype=torch.float64),
        cam_model=cam_mod.PINHOLE, dist_model=cam_mod.RADTAN)
    poses_gt = torch.from_numpy(traj.poses)
    T_c_w = geo.pose_inverse(geo.pose_compose(poses_gt, cam_cpu.T_s_c))
    p_c = geo.pose_apply(T_c_w[:, None], torch.from_numpy(lms_gt)[None])  # (K, L, 3)
    uv, valid = cam_mod.project3(cam_cpu, p_c)
    uv, valid, p_c = uv.numpy(), valid.numpy(), p_c.numpy()
    ok = (valid & (p_c[..., 2] > 0.3) & (uv[..., 0] > 0) & (uv[..., 0] < 752)
          & (uv[..., 1] > 0) & (uv[..., 1] < 480))
    kk, ll = np.nonzero(ok)
    if max_obs is not None and len(kk) > max_obs:
        stride = len(kk) // max_obs + 1
        kk, ll = kk[::stride], ll[::stride]
    n_obs = len(kk)
    pad = (-n_obs) % 8
    obs_kf = np.concatenate([kk, np.zeros(pad, np.int64)])
    obs_lm = np.concatenate([ll, np.zeros(pad, np.int64)])
    obs_uv = np.concatenate([uv[kk, ll], np.zeros((pad, 2))])
    n_lm_pad = n_lm + (-n_lm) % 8

    def t(a, dtype=torch.float64):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    noise = imu.default_noise()
    zeros = torch.zeros((n_kf - 1, 3), dtype=torch.float64, device=dev)
    pre = imu.preintegrate(t(traj.imu_acc), t(traj.imu_gyro), t(traj.imu_dts),
                           t(traj.imu_mask), zeros, zeros, noise)
    xi = 0.02 * rng.normal(size=(n_kf, 6)) * (np.arange(n_kf) > 0)[:, None]
    poses = geo.pose_boxplus(poses_gt, torch.from_numpy(xi))
    fixed = np.zeros(n_kf, bool)
    fixed[0] = True
    problem = gba.GBAProblem(
        poses=t(poses), vels=t(traj.vels), biases=t(np.zeros((n_kf, 6))),
        kf_mask=t(np.ones(n_kf, bool), torch.bool), kf_fixed=t(fixed, torch.bool),
        cam=cam_mod.Camera(t(cam_cpu.intrinsics), t(cam_cpu.dist), t(cam_cpu.T_s_c),
                           cam_mod.PINHOLE, cam_mod.RADTAN),
        lms=t(np.concatenate([lms_gt, np.zeros((n_lm_pad - n_lm, 3))])),
        lm_mask=t(np.arange(n_lm_pad) < n_lm, torch.bool),
        obs_kf=t(obs_kf, torch.int64), obs_lm=t(obs_lm, torch.int64), obs_uv=t(obs_uv),
        obs_w=t(np.full(len(obs_kf), 0.5)),
        obs_mask=t(np.arange(n_obs + pad) < n_obs, torch.bool),
        imu_i=t(np.arange(n_kf - 1), torch.int64), imu_j=t(np.arange(1, n_kf), torch.int64),
        imu_pre=pre, imu_sqrt_info=gba.imu_sqrt_info_from_cov(pre.cov),
        bias_sqrt_info=gba.bias_walk_sqrt_info(noise, pre.dt),
        imu_mask=t(np.ones(n_kf - 1, bool), torch.bool),
        gravity=t([0.0, 0.0, -GRAVITY]),
        loop_i=t([0], torch.int64), loop_j=t([0], torch.int64),
        loop_T=t([[1.0, 0, 0, 0, 0, 0, 0]]), loop_sqrt_info=t(np.zeros((1, 6, 6))),
        loop_mask=t([False], torch.bool))
    return problem, traj.poses, lms_gt
