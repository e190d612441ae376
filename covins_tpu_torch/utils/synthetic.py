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

from covins_tpu_torch.utils import cameras as _cam

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


def build_gba_problem(n_kf=12, n_lm=96, seed=0, max_obs=None, device=None,
                      camera=None):
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
    reference's.  ``camera`` names one of :data:`SCENE_CAMERAS` (with xi
    0.6 for the unified model) in place of that camera.  Returns (problem
    on ``device``, ground-truth poses (K, 7), ground-truth landmarks
    (n_lm, 3)), numpy for the ground truth."""
    from covins_tpu_torch.device import resolve_device
    from covins_tpu_torch.ops import gba, imu
    from covins_tpu_torch.utils import cameras as cam_mod
    from covins_tpu_torch.utils import geometry as geo

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    traj = generate(n_keyframes=n_kf, kf_dt=0.5, imu_rate=100.0)
    lms_gt = generate_landmarks(rng, n=n_lm)
    model, dist_model, dist = ((cam_mod.PINHOLE, cam_mod.RADTAN, (0.0,) * 4)
                               if camera is None else SCENE_CAMERAS[camera])
    cam_cpu = cam_mod.Camera(
        intrinsics=torch.tensor([458.0, 457.0, 376.0, 240.0, 0.0 if camera is None else 0.6],
                                dtype=torch.float64),
        dist=torch.tensor(dist, dtype=torch.float64),
        T_s_c=torch.tensor(_T_S_C_FORWARD, dtype=torch.float64),
        cam_model=model, dist_model=dist_model)
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
                           model, dist_model),
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


def build_pose_graph(n_kf=256, n_neighbors=5, n_loops=5, seed=0, drift=0.01,
                     device=None):
    """Synthetic pose graph of the size a merged map's deferred solve has:
    the keyframes of :func:`generate`'s trajectory, an edge from each
    keyframe to each of its ``n_neighbors`` successors (odometry and
    covisibility), ``n_loops`` loop edges between keyframes at least ten
    apart, measurements the true relative poses with 0.005 of noise per
    tangent component, the start a random walk of ``drift`` per keyframe
    and component away from the truth; keyframe 0 fixed.  The weights are
    those `Map.to_pose_graph` gives with the default `Config`: rotation 100
    and translation 10 to the first successor, 50 and 5 to the second and
    third, 33.3 and 3.33 beyond, and loop edges 100 and 1e4.  At the
    default sizes, 256 poses and 1270 edges.  Returns (graph on ``device``,
    true poses (K, 7) numpy)."""
    from covins_tpu_torch.device import resolve_device
    from covins_tpu_torch.ops import pgo
    from covins_tpu_torch.utils import geometry as geo
    from covins_tpu_torch.utils.config import Config

    dev = resolve_device(device)
    cfg = Config()
    rng = np.random.default_rng(seed)
    gt = torch.from_numpy(generate(n_keyframes=n_kf, imu_rate=2.0).poses)
    pairs = [(i, i + k) for k in range(1, n_neighbors + 1) for i in range(n_kf - k)]
    loops = []
    while len(loops) < n_loops and n_kf > 10:
        i, j = sorted(int(x) for x in rng.integers(0, n_kf, 2))
        if j - i >= 10:
            loops.append((i, j))
    ei, ej = (torch.tensor([p[s] for p in pairs + loops], dtype=torch.int64)
              for s in (0, 1))
    e = ei.shape[0]
    T = geo.pose_boxplus(geo.pose_relative(gt[ei], gt[ej]),
                         torch.from_numpy(0.005 * rng.normal(size=(e, 6))))
    walk = torch.from_numpy(np.cumsum(drift * rng.normal(size=(n_kf, 6)), axis=0))
    walk[0] = 0.0
    hop = np.array([j - i for i, j in pairs])
    mult = np.where(hop == 1, cfg.wt_kf_n1,
                    cfg.wt_kf_n1 / np.where(hop <= 3, cfg.wt_kf_n23, cfg.wt_kf_n45))
    diag = np.concatenate([
        np.repeat(np.stack([cfg.wt_kf_R * mult, cfg.wt_kf_T * mult], 1), 3, 1),
        np.tile([100.0] * 3 + [1e4] * 3, (len(loops), 1))])
    g = pgo.PoseGraph(
        poses=geo.pose_boxplus(gt, walk), pose_mask=torch.ones(n_kf, dtype=torch.bool),
        fixed=torch.arange(n_kf) == 0, edge_i=ei, edge_j=ej, edge_T=T,
        edge_sqrt_info=torch.diag_embed(torch.from_numpy(diag)),
        edge_mask=torch.ones(e, dtype=torch.bool),
        edge_is_loop=torch.arange(e) >= len(pairs))
    return pgo.PoseGraph(**{f.name: getattr(g, f.name).to(dev)
                            for f in dataclasses.fields(g)}), gt.numpy()


def chain_pose_graph(n_poses=32, seed=0, device=None):
    """The pose chain of the JAX package's multi-device dry run
    (`__graft_entry__.py:214`): true poses 0.5 per tangent component from
    the identity, an edge from each pose to the next measuring the true
    relative pose, unit sqrt-information, the start 0.05 per component
    away from the truth except pose 0, which is fixed.  The draws are
    numpy's (``seed``).  Returns (graph on ``device``, true poses (N, 7)
    on ``device``)."""
    from covins_tpu_torch.device import resolve_device
    from covins_tpu_torch.ops import pgo
    from covins_tpu_torch.utils import geometry as geo

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    f64 = dict(dtype=torch.float64)
    ident = geo.pose_identity(torch.float64).expand(n_poses, 7)
    gt = geo.pose_boxplus(ident, torch.from_numpy(0.5 * rng.normal(size=(n_poses, 6))))
    start = geo.pose_boxplus(gt, torch.from_numpy(0.05 * rng.normal(size=(n_poses, 6)))
                             * (torch.arange(n_poses) > 0)[:, None])
    ei = torch.arange(n_poses - 1)
    g = pgo.PoseGraph(
        poses=start, pose_mask=torch.ones(n_poses, dtype=torch.bool),
        fixed=torch.arange(n_poses) == 0, edge_i=ei, edge_j=ei + 1,
        edge_T=geo.pose_relative(gt[ei], gt[ei + 1]),
        edge_sqrt_info=torch.eye(6, **f64).expand(n_poses - 1, 6, 6),
        edge_mask=torch.ones(n_poses - 1, dtype=torch.bool),
        edge_is_loop=torch.zeros(n_poses - 1, dtype=torch.bool))
    return pgo.PoseGraph(**{f.name: getattr(g, f.name).to(dev).contiguous()
                            for f in dataclasses.fields(g)}), gt.to(dev)


def knn_scene(rng: np.random.Generator, Q: int, N: int, nbits: int = 256):
    """A Hamming k-NN scene in {-1, +1} float32 (the form
    `parallel.sharding.sharded_hamming_knn` takes): ``N`` random database
    rows, an eighth of them copies of another row (tied distances), and
    ``Q`` queries, the first half copies of random rows with a few bits
    flipped.  Returns (db (N, nbits), queries (Q, nbits))."""
    db = rng.integers(0, 2, (N, nbits)).astype(np.float32) * 2 - 1
    dup = rng.choice(N, N // 8, replace=False)
    db[dup] = db[rng.integers(0, N, N // 8)]
    q = rng.integers(0, 2, (Q, nbits)).astype(np.float32) * 2 - 1
    near = Q // 2
    q[:near] = db[rng.integers(0, N, near)]
    flip = rng.random((near, nbits)) < 0.02
    q[:near][flip] *= -1
    return db, q


def stacked_states(p, S, seed=0):
    """S states of the GBA problem ``p``, the first unchanged and the
    others moved a little, each of (poses, vels, biases, lms) stacked on a
    leading dimension: the shape of the step ladder's cost evaluation."""
    from covins_tpu_torch.utils import geometry as geo

    rng = np.random.default_rng(seed)
    f64 = dict(dtype=torch.float64, device=p.poses.device)
    n, m = p.poses.shape[0], p.lms.shape[0]
    xi = torch.tensor(1e-3 * rng.normal(size=(S, n, 6)), **f64)
    dl = torch.tensor(1e-2 * rng.normal(size=(S, m, 3)), **f64)
    xi[0], dl[0] = 0.0, 0.0
    return (geo.pose_boxplus(p.poses.expand(S, n, 7), xi), p.vels.expand(S, n, 3).clone(),
            p.biases.expand(S, n, 6).clone(), p.lms + dl)


# the scenes' cameras: (camera model, distortion model, distortion
# parameters); "omni" is the unified model
SCENE_CAMERAS = {
    "pinhole": (_cam.PINHOLE, _cam.DIST_NONE, (0.0,) * 4),
    "radtan": (_cam.PINHOLE, _cam.RADTAN, (-0.28, 0.07, 2e-4, 2e-5)),
    "omni": (_cam.OMNI, _cam.RADTAN, (-0.1, 0.01, 1e-4, 1e-5)),
    "equidistant": (_cam.PINHOLE, _cam.EQUIDISTANT, (0.01, -0.002, 0.0, 0.0)),
}


def project_match_scene(rng: np.random.Generator, L, F, device, camera="radtan",
                        view_angle=False, fail=False, sift=False):
    """(args, kwargs) of `ops.projmatch.project_match_core` for a random
    scene of L landmarks and F features seen by a EuRoC-like camera (752 x
    480): landmarks in front of and behind it, features near some
    projections with their descriptors (a few bits flipped), duplicated
    features (ties in f) and landmarks (conflicts), normals and distance
    ranges, some zero (their gates skipped).  ``camera``: "pinhole" (no
    distortion) and "radtan", whose prologue K5 computes, or "omni" (the
    unified model) and "equidistant", whose prologue the wrapper computes
    in PyTorch and hands to the kernel; ``fail`` masks every landmark;
    ``sift`` gives (128) float32 descriptors (:func:`sift_descriptors`, a
    feature's with N(0, 8) added and the absolute value taken) and an L2
    gate of 150 in place of 50 bits."""
    from covins_tpu_torch.utils import cameras as cam
    from covins_tpu_torch.utils import geometry as geo

    model, dist_model, dist = SCENE_CAMERAS[camera]
    f64 = dict(dtype=torch.float64)
    c = cam.Camera(torch.tensor([458.0, 457.0, 376.0, 240.0, 0.6], **f64),
                   torch.tensor(dist, **f64), torch.tensor([1.0, 0, 0, 0, 0, 0, 0], **f64),
                   model, dist_model)
    q = np.array([0.995, 0.05, -0.06, 0.03])
    T_cw = np.concatenate([q / np.linalg.norm(q), [0.2, -0.1, 0.3]])
    p_w = np.stack([rng.uniform(-3, 3, L), rng.uniform(-2, 2, L), rng.uniform(-1, 9, L)], 1)
    p_c = geo.pose_apply(torch.tensor(T_cw)[None], torch.tensor(p_w))
    uv_l = cam.project3(c, torch.where(p_c[:, 2:] > 0.1, p_c, 1.0))[0].numpy()
    src = rng.choice(L, F)
    kp_uv = uv_l[src] + rng.normal(scale=3.0, size=(F, 2))
    if sift:
        lm_desc = sift_descriptors(rng, L)
        kp_desc = np.abs(lm_desc[src] + rng.normal(0.0, 8.0, (F, 128))).astype(np.float32)
    else:
        lm_desc = rng.integers(0, 256, (L, 32), dtype=np.uint8)
        kp_desc = lm_desc[src].copy()
        kp_desc[np.arange(F), rng.integers(0, 32, F)] ^= rng.integers(0, 256, F).astype(
            np.uint8)
    kp_desc[1::7] = kp_desc[0::7][: len(kp_desc[1::7])]
    kp_uv[1::7] = kp_uv[0::7][: len(kp_uv[1::7])]
    lm_desc[1::11] = lm_desc[0::11][: len(lm_desc[1::11])]
    normals = rng.normal(size=(L, 3))
    normals[::5] = 0.0
    d = np.linalg.norm(p_w - geo.pose_inverse(torch.tensor(T_cw))[4:].numpy(), axis=1)
    lm_rng = np.stack([d / 1.2 ** rng.integers(0, 8, L), d * rng.uniform(0.5, 2, L)], 1)
    lm_rng[::3] = 0.0
    lm_mask = rng.random(L) > (1.0 if fail else 0.1)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)  # noqa: E731
    c = cam.Camera(c.intrinsics.to(device), c.dist.to(device), c.T_s_c.to(device), model,
                   dist_model)
    args = [c, t(T_cw), t(p_w), t(lm_desc), t(normals), t(lm_mask), t(lm_rng), t(kp_uv),
            t(kp_desc), t(rng.integers(0, 4, F).astype(np.float64)), t(rng.random(F) > 0.1),
            6.0, 150.0 if sift else 50.0, 752.0, 480.0]
    return args, {"check_view_angle": view_angle}


def p3p_scene(rng: np.random.Generator, N, n_valid, H, device, sets="noise", case=None,
              threshold_rad=0.01):
    """(args, kwargs) of `ops.pnp.absolute_pose_ransac` in the form stage 2
    of the loop verification calls it: a table of N candidate landmarks
    (C = N) in front of a camera, N query bearings of which the first
    ``n_valid`` are matched (``rows`` >= 0, permuted rows of the table; a
    fifth of the matches have a random bearing, the rest the true one with
    noise) and the rest padded or unmatched (``mask`` False or ``rows``
    -1); ``H`` hypotheses from Gumbel ``noise`` (H, N) or random ``idx``
    (H, 3) over the matches.  ``case``: "few", two matches only (the
    minimal sets take unmatched rows), or "degenerate", every table point
    the same (every root invalid)."""
    from covins_tpu_torch.utils import geometry as geo

    q = rng.normal(size=4)
    T_c_w = torch.tensor(np.concatenate([q / np.linalg.norm(q), rng.normal(size=3)]))
    p_c = np.stack([rng.uniform(-2, 2, N), rng.uniform(-1.5, 1.5, N), rng.uniform(3, 9, N)], 1)
    table = geo.pose_apply(geo.pose_inverse(T_c_w), torch.tensor(p_c)).numpy()
    if case == "degenerate":
        table[:] = table[0]
    n_valid = 2 if case == "few" else n_valid
    perm = rng.permutation(N)
    rows = np.full(N, -1, np.int32)
    rows[:n_valid] = perm[:n_valid]
    bear = geo.pose_apply(T_c_w, torch.tensor(table[perm])).numpy() \
        + 0.002 * rng.normal(size=(N, 3))
    bad = rng.random(N) < 0.2
    bear[bad] = rng.normal(size=(int(bad.sum()), 3)) + [0.0, 0.0, 4.0]
    bear /= np.linalg.norm(bear, axis=1, keepdims=True)
    mask = np.arange(N) < min(N, n_valid + (N - n_valid) // 2)  # a padded tail
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)  # noqa: E731
    kw = {"n_hypotheses": H, "threshold_rad": threshold_rad, "rows": t(rows)}
    if sets == "noise":
        u = np.clip(rng.random((H, N)), np.finfo(np.float64).tiny, None)
        kw["noise"] = t(-np.log(-np.log(u)))
    else:
        kw["idx"] = t(rng.integers(0, max(n_valid, 3), (H, 3)).astype(np.int64))
    return [t(table), t(bear), t(mask)], kw



def refresh_scene(rng: np.random.Generator, L, P):
    """numpy inputs of the landmark-attribute refresh
    (`ops.landmark_ops.pack_refresh`) for L landmarks over P observation
    slots, with a map's edge cases: a landmark with no valid observation
    (row 0), one (row 1), all P (row 2), duplicated descriptors (tied
    medians), an observing camera centre on its landmark (row 3: the
    direction's norm clamps), octaves 0-7.  Returns (pos (L, 3), centers
    (L, P, 3), octaves (L, P), descs (L, P, 32) uint8, mask (L, P) bool)."""
    d = rng.integers(0, 256, (L, P, 32), dtype=np.uint8)
    if P > 3:
        d[:, 3] = d[:, 1]
    mask = rng.random((L, P)) > 0.4
    pos = rng.normal(size=(L, 3)) * 5
    centers = pos[:, None, :] + rng.normal(size=(L, P, 3)) * 5
    for row, valid in enumerate(([], [P - 1], list(range(P)))):
        if row < L:
            mask[row] = False
            mask[row, valid] = True
    if L > 3:
        centers[3, 0] = pos[3]
        mask[3, 0] = True
    octaves = rng.integers(0, 8, (L, P)).astype(np.float64)
    return pos, centers, octaves, d, mask


def sift_descriptors(rng: np.random.Generator, n: int) -> np.ndarray:
    """(n, 128) float32 SIFT-like descriptors, the synthetic agent's: |N(0,
    1)| entries scaled to norm 512."""
    d = np.abs(rng.standard_normal((n, 128))).astype(np.float32)
    return d * (512.0 / np.linalg.norm(d, axis=-1, keepdims=True))


def covins_g_scene(rng: np.random.Generator, F, nq_rig=2, nc_rig=3, n_points=100,
                   n_inliers=70, n_outliers=20, bit_flips=4, pixel_noise=0.1, spacing=0.6,
                   intrinsics=(458.0, 458.0, 376.0, 240.0), size=(752.0, 480.0),
                   sift=False):
    """numpy inputs of `ops.loopverify.covinsg_verify` for two rigs that
    see one scene: ``n_points`` points in front of the query anchor with
    random descriptors; each of the query rig's ``nq_rig`` and the
    candidate rig's ``nc_rig`` keyframe cameras (pinhole, no distortion,
    the candidate rig's anchor at ``T_true`` in the query anchor's frame,
    keyframes ``spacing`` metres apart) keeps ``n_inliers`` of its visible
    points (pixels with ``pixel_noise``, descriptors with ``bit_flips`` bits
    flipped; with ``sift`` (128) float32 descriptors with N(0, 8) added and
    the absolute value taken, as the synthetic agent observes them) and
    ``n_outliers`` random features, of ``F`` slots (the rest masked).
    Returns a dict with the rays ``qo, qd, co, cd`` in their anchor frames,
    descriptors ``q_desc, c_desc``, masks ``qmask, cmask``, camera-frame
    bearings ``qbear, cbear``, the keyframe cameras' poses ``q_T, c_T`` (R,
    7) in their anchor frames, distorted pixels ``q_uv, c_uv`` and
    ``T_true`` (7,)."""
    from covins_tpu_torch.utils import npgeo

    fx, fy, cx, cy = intrinsics
    pts = np.stack([rng.uniform(-4, 4, n_points), rng.uniform(-3, 3, n_points),
                    rng.uniform(5, 12, n_points)], 1)
    pdesc = (sift_descriptors(rng, n_points) if sift
             else rng.integers(0, 256, (n_points, 32), dtype=np.uint8))
    w = rng.normal(size=3) * 0.1
    q = np.concatenate([[np.cos(np.linalg.norm(w) / 2)],
                        np.sin(np.linalg.norm(w) / 2) * w / np.linalg.norm(w)])
    T_true = np.concatenate([q, rng.normal(size=3) * [0.4, 0.1, 0.3]])

    def rig(n_rig, T_world_anchor):
        out = {k: [] for k in ("o", "d", "desc", "mask", "bear", "T", "uv")}
        for i in range(n_rig):
            T_a_cam = np.asarray([1.0, 0.0, 0.0, 0.0, -spacing * i, 0.1 * spacing * i, -0.3 * spacing * i])
            T_w_cam = npgeo.pose_compose(T_world_anchor, T_a_cam)
            p_c = npgeo.pose_apply(npgeo.pose_inverse(T_w_cam), pts)
            z = np.clip(p_c[:, 2], 1e-9, None)
            uv = np.stack([fx * p_c[:, 0] / z + cx, fy * p_c[:, 1] / z + cy], 1)
            vis = np.where((p_c[:, 2] > 0.1) & (uv[:, 0] >= 0) & (uv[:, 0] < size[0])
                           & (uv[:, 1] >= 0) & (uv[:, 1] < size[1]))[0]
            keep = rng.permutation(vis)[:n_inliers]
            n_in = len(keep)
            n_feat = min(F, n_in + n_outliers)
            kp = np.zeros((F, 2))
            desc = np.zeros((F,) + pdesc.shape[1:], pdesc.dtype)
            kp[:n_in] = uv[keep] + pixel_noise * rng.normal(size=(n_in, 2))
            desc[:n_in] = pdesc[keep]
            if sift:
                desc[:n_in] = np.abs(desc[:n_in] + rng.normal(0.0, 8.0, (n_in, 128)))
            for r in range(0 if sift else n_in):  # flip some bits of each true descriptor
                bits = rng.choice(256, bit_flips, replace=False)
                desc[r, bits // 8] ^= (1 << (bits % 8)).astype(np.uint8)
            kp[n_in:n_feat] = rng.uniform([0, 0], size, (n_feat - n_in, 2))
            desc[n_in:n_feat] = (sift_descriptors(rng, n_feat - n_in) if sift else
                                 rng.integers(0, 256, (n_feat - n_in, 32), dtype=np.uint8))
            perm = rng.permutation(n_feat)
            kp[:n_feat], desc[:n_feat] = kp[perm], desc[perm]
            bear = np.stack([(kp[:, 0] - cx) / fx, (kp[:, 1] - cy) / fy, np.ones(F)], 1)
            bear /= np.linalg.norm(bear, axis=1, keepdims=True)
            out["o"].append(np.broadcast_to(T_a_cam[4:], (F, 3)))
            out["d"].append(npgeo.quat_rotate(np.broadcast_to(T_a_cam[:4], (F, 4)), bear))
            out["desc"].append(desc)
            out["mask"].append(np.arange(F) < n_feat)
            out["bear"].append(bear)
            out["T"].append(T_a_cam)
            out["uv"].append(kp)
        return {k: np.concatenate(v) if k != "T" else np.stack(v) for k, v in out.items()}

    qr = rig(nq_rig, np.asarray([1.0, 0, 0, 0, 0, 0, 0]))
    cr = rig(nc_rig, T_true)
    return {"qo": qr["o"], "qd": qr["d"], "co": cr["o"], "cd": cr["d"],
            "q_desc": qr["desc"], "c_desc": cr["desc"], "qmask": qr["mask"],
            "cmask": cr["mask"], "qbear": qr["bear"], "cbear": cr["bear"],
            "q_T": qr["T"], "c_T": cr["T"], "q_uv": qr["uv"], "c_uv": cr["uv"],
            "T_true": T_true}


def ratio_match_scene(rng: np.random.Generator, M, seg, n_seg, case=None):
    """numpy inputs ``(a, a_mask, b, b_mask)`` of
    `ops.descriptors.hamming_ratio_match`: M query and ``seg * n_seg``
    candidate descriptors, a third of the queries with a candidate a few
    bits away (some with a second one close by), a tenth of rows and
    columns masked.  ``case``: "ties", equal columns inside a segment,
    across a 1024-column tile and across segments; "all_masked", every row
    masked; "extremes", distances 0 and 256."""
    a = rng.integers(0, 256, (M, 32), dtype=np.uint8)
    N = seg * n_seg
    b = rng.integers(0, 256, (N, 32), dtype=np.uint8)
    a_mask = rng.random(M) > 0.1
    b_mask = rng.random(N) > 0.1

    def flip(x, k):
        y = x.copy()
        for bit in rng.choice(256, k, replace=False):
            y[bit // 8] ^= np.uint8(1 << (bit % 8))
        return y

    for r in range(0, M, 3):
        c = int(rng.integers(0, N))
        b[c] = flip(a[r], int(rng.integers(0, 30)))
        if r % 2:
            b[(c + 1) % N] = flip(a[r], int(rng.integers(0, 40)))
    if case == "ties":
        for r in range(min(M, 8)):
            c = int(rng.integers(0, seg))
            b[c] = flip(a[r], 3)
            for c2 in (c + seg // 2, c + min(1100, seg - 1 - c), c + seg):
                if c2 < N:
                    b[c2] = b[c]  # the same word later in the segment, tile and row
    elif case == "all_masked":
        a_mask[:] = False
    elif case == "extremes":
        b[0] = a[0]
        b[1] = ~a[1]
        b[seg - 1] = a[2]
        b[seg - 2] = ~a[2]
        a_mask[:3] = True
        b_mask[[0, 1, seg - 1, seg - 2]] = True
    return a, a_mask, b, b_mask


def central_5pt_scene(rng: np.random.Generator, B, H, N, sets="noise", case=None):
    """numpy inputs of `ops.epipolar.relpose_ransac_5pt`: B keyframe pairs'
    unit central bearings of N rays that see one scene a pair (a fifth of
    the rays outliers), the first ``n_valid[b]`` rays of pair b masked in
    (a different count a pair, about a fifth of N as the COVINS-G drain
    matches), and the minimal sets from Gumbel noise (B, H, N) or as idx
    (B, H, 5) of distinct masked-in rays.  ``case="degenerate"``: pair 0
    has 3 rays masked in, pair 1 none, pair 2 (if any) only 4 distinct
    rays, repeated (idx: pair 2's sets repeat a ray).  Returns (fa, fb,
    mask, noise, idx), None for the sets not asked for."""
    from covins_tpu_torch.utils import npgeo

    fa, fb = np.empty((B, N, 3)), np.empty((B, N, 3))
    for i in range(B):
        q = rng.normal(size=4) * [8.0, 1.0, 1.0, 1.0]
        t = rng.normal(size=3)
        Tt = np.concatenate([q / np.linalg.norm(q), t / np.linalg.norm(t)])
        pts = np.stack([rng.uniform(-5, 5, N), rng.uniform(-4, 4, N),
                        rng.uniform(4, 15, N)], 1)
        fa[i] = pts
        fb[i] = npgeo.pose_apply(npgeo.pose_inverse(Tt), pts)
        bad = rng.random(N) < 0.2
        fb[i][bad] = rng.normal(size=(int(bad.sum()), 3))
    fa /= np.linalg.norm(fa, axis=-1, keepdims=True)
    fb /= np.linalg.norm(fb, axis=-1, keepdims=True)
    n_valid = [max(5, min(N, N // 5 + (i * N) // (7 * B))) for i in range(B)]
    if case == "degenerate":
        n_valid[0] = 3
        if B > 1:
            n_valid[1] = 0
        if B > 2:
            fa[2] = fa[2, np.arange(N) % 4]
            fb[2] = fb[2, np.arange(N) % 4]
    mask = np.arange(N)[None, :] < np.asarray(n_valid)[:, None]
    if sets == "noise":
        u = np.clip(rng.random((B, H, N)), np.finfo(np.float64).tiny, None)
        return fa, fb, mask, -np.log(-np.log(u)), None
    idx = np.stack([np.stack([rng.choice(max(n, 5), 5, replace=False) for _ in range(H)])
                    for n in n_valid]).astype(np.int64)
    if case == "degenerate" and B > 2:
        idx[2, :, 1] = idx[2, :, 0]
    return fa, fb, mask, None, idx


def ray_score_scene(rng: np.random.Generator, B, H, N, central=False, n_valid=None,
                    with_valid=False, nan_every=7):
    """numpy inputs of `ops.epipolar.ray_ransac_score`: B RANSACs over N
    rays of two rigs (``central``: origins None) that see one scene, H
    hypotheses each near the true pose (every ``nan_every``-th NaN, a
    degenerate sample), a fifth of the rays outliers, the first
    ``n_valid[b]`` rays of batch b masked in (default: a different count
    per batch), ``with_valid`` a random hypothesis validity.  Returns
    (T, va, fa, vb, fb, mask, valid) with None for what is absent."""
    from covins_tpu_torch.utils import npgeo

    va = np.zeros((B, N, 3)) if central else rng.normal(size=(B, N, 3)) * 0.4
    vb = np.zeros((B, N, 3)) if central else rng.normal(size=(B, N, 3)) * 0.4
    fa, fb, T = np.empty((B, N, 3)), np.empty((B, N, 3)), np.empty((B, H, 7))
    for i in range(B):
        q = rng.normal(size=4) * [8.0, 1.0, 1.0, 1.0]
        Tt = np.concatenate([q / np.linalg.norm(q), rng.normal(size=3)])
        pts = np.stack([rng.uniform(-5, 5, N), rng.uniform(-4, 4, N),
                        rng.uniform(4, 15, N)], 1)
        fa[i] = pts - va[i]
        fb[i] = npgeo.pose_apply(npgeo.pose_inverse(Tt), pts) - vb[i]
        bad = rng.random(N) < 0.2
        fb[i][bad] = rng.normal(size=(int(bad.sum()), 3))
        dq = rng.normal(size=(H, 4)) * [1.0, 1e-3, 1e-3, 1e-3]
        dq[:, 0] = 1.0
        dT = np.concatenate([dq / np.linalg.norm(dq, axis=1, keepdims=True),
                             rng.normal(size=(H, 3)) * 1e-2], 1)
        T[i] = npgeo.pose_compose(np.broadcast_to(Tt, (H, 7)), dT)
        if nan_every:
            T[i, ::nan_every] = np.nan
    fa /= np.linalg.norm(fa, axis=-1, keepdims=True)
    fb /= np.linalg.norm(fb, axis=-1, keepdims=True)
    if n_valid is None:
        n_valid = [N - (i * N) // (2 * B) for i in range(B)]
    mask = np.arange(N)[None, :] < np.asarray(n_valid)[:, None]
    valid = rng.random((B, H)) > 0.3 if with_valid else None
    return (T, None if central else va, fa, None if central else vb, fb, mask, valid)


def l2_plain_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """`ops.descriptors.l2_distance_sq` in numpy float32 (running sums in
    order, every product and sum rounded on its own): (M, 128) x (N, 128)
    -> (M, N)."""
    a, b = a.astype(np.float32), b.astype(np.float32)
    aa = np.zeros(a.shape[0], np.float32)
    bb = np.zeros(b.shape[0], np.float32)
    ab = np.zeros((a.shape[0], b.shape[0]), np.float32)
    for k in range(a.shape[1]):
        aa = aa + a[:, k] * a[:, k]
        bb = bb + b[:, k] * b[:, k]
        ab = ab + a[:, k, None] * b[None, :, k]
    return np.maximum((aa[:, None] + bb[None, :]) - np.float32(2.0) * ab, np.float32(0.0))


def _ulp_words(rng: np.random.Generator, n: int):
    """A query q (norm 200, mostly on dimensions 0-63) and words whose
    plain distances to it are n consecutive float32 values, the nearest
    first: one word, then copies with dimension 64 nudged until the
    distance is 1, 2, ... ulps larger (q . b is small, so the distance's
    grid is its own ulp)."""
    q = np.zeros(128, np.float32)
    q[:64] = np.abs(rng.normal(size=64))
    q[:64] *= 200.0 / np.linalg.norm(q[:64])
    q[64:] = 0.1 * np.abs(rng.normal(size=64))
    w = np.zeros(128, np.float32)
    w[64:] = np.abs(rng.normal(size=64)) + 0.5
    d0 = l2_plain_np(q[None], w[None])[0, 0]
    step = np.spacing(d0) / (8.0 * w[64])
    tries = np.repeat(w[None], 4096, 0)
    tries[:, 64] = w[64] + step * np.arange(1, 4097, dtype=np.float32)
    d = l2_plain_np(q[None], tries)[0]
    words, want = [w], d0
    for _ in range(n - 1):
        want = np.nextafter(want, np.float32(np.inf))
        hit = np.flatnonzero(d == want)
        if hit.size == 0:
            raise RuntimeError("no word at the next float32 distance")
        words.append(tries[hit[0]])
    return q, np.stack(words)


def l2_match_scene(rng: np.random.Generator, M, seg, n_seg, case=None):
    """numpy inputs ``(a, a_mask, b, b_mask)`` of `ops.descriptors.l2_argmin`
    (``a``, ``b``, ``a_mask``) and `l2_ratio_match`: M query and ``seg *
    n_seg`` candidate (128) float32 SIFT descriptors (:func:`sift_descriptors`),
    half of the queries an observation of a candidate (N(0, 8) added, the
    absolute value taken), a tenth of rows and columns masked.  ``case``:
    "ties", a column repeated later in its segment, past a 64-column tile,
    past a 256-column part and in the next segment, and query rows near it
    (N(0, 4) added: equal distances to every copy, near 45); "all_masked",
    every row masked; "one_valid", one valid column in the first segment;
    "extremes", zero vectors and vectors of 1e4 (distances 0 and near
    1.6e10); "overflow", 12 permutations of one word at columns 2-13 and
    query rows all equal to 40 (equidistant but for rounding, more
    candidates than the kernels keep a row); "ulp", 4 words at
    distances d, d + 1, d + 2 and d + 3 float32 ulps from the first 8 query
    rows (:func:`_ulp_words`), the farther at the lower columns 2, 70, 300
    and 600 of the first segment; "mask_patterns" (n_seg >= 3), the first
    64 rows masked and segments 0, 1, 2 with 0, 1 and 2 valid columns."""
    N = seg * n_seg
    b = sift_descriptors(rng, N)
    a = sift_descriptors(rng, M)
    src = rng.integers(0, N, M // 2)
    a[: M // 2] = np.abs(b[src] + rng.normal(0.0, 8.0, (M // 2, 128)))
    a_mask = rng.random(M) > 0.1
    b_mask = rng.random(N) > 0.1
    if case == "ties":
        c = 3 % N
        for c2 in (seg - 1, c + 70, c + 300, c + seg):
            if c2 < N:
                b[c2] = b[c]
                b_mask[c2] = True
        b_mask[c] = True
        k = min(M, 8)
        a[:k] = np.abs(b[c] + rng.normal(0.0, 4.0, (k, 128)))
        a_mask[:k] = True
    elif case == "all_masked":
        a_mask[:] = False
    elif case == "one_valid":
        b_mask[:seg] = False
        b_mask[seg // 2] = True
    elif case == "extremes":
        b[0] = 0.0
        a[0] = 0.0
        b[min(1, N - 1)] = 1e4
        a[min(1, M - 1)] = 1e4
        a_mask[:2] = True
        b_mask[:2] = True
    elif case == "overflow":
        word = np.abs(40.0 + rng.normal(0.0, 3.0, 128))
        for c in range(2, 14):
            if c < seg:
                b[c] = rng.permutation(word)
                b_mask[c] = True
        k = min(M, 8)
        a[:k] = 40.0
        a_mask[:k] = True
    elif case == "ulp":
        q, words = _ulp_words(rng, 4)
        for c, w in zip((600, 300, 70, 2), words):
            if c < seg:
                b[c] = w
                b_mask[c] = True
        k = min(M, 8)
        a[:k] = q
        a_mask[:k] = True
    elif case == "mask_patterns":
        a_mask[:64] = False
        b_mask[:seg] = False
        b_mask[seg:3 * seg] = False
        b_mask[seg + seg // 2] = True
        b_mask[2 * seg + 1] = b_mask[3 * seg - 1] = True
    return a.astype(np.float32), a_mask, b.astype(np.float32), b_mask


def dbow_tree(rng: np.random.Generator, k: int, L: int, kind: str = "complete"):
    """A DBoW2 vocabulary tree (`ops.dbow_import.HierVocabulary`) built
    from a seed, nodes numbered level by level as a DBoW2 file numbers
    them.  ``kind``: ``"complete"``, a full k-ary tree of depth L (k = 10,
    L = 6 is ORBvoc.txt's shape, 1,111,111 nodes, built without a loop);
    ``"ragged"``, the root min(k, 6) children and every other node 1 to 3,
    in random slots of the k (the rest -1), leaves at depths 1 and 2 and
    inner nodes without children above depth L; ``"ties"``, a complete tree whose odd children repeat
    their first sibling's descriptor."""
    from covins_tpu_torch.ops.dbow_import import HierVocabulary

    if kind in ("complete", "ties"):
        sizes = [k ** lvl for lvl in range(L + 1)]
        starts = np.cumsum([0] + sizes)
        n_nodes = int(starts[-1])
        children = np.full((n_nodes, k), -1, np.int32)
        for lvl in range(L):
            j = np.arange(sizes[lvl])
            children[starts[lvl]:starts[lvl + 1]] = (
                starts[lvl + 1] + j[:, None] * k + np.arange(k)[None, :])
        depth = np.repeat(np.arange(L + 1, dtype=np.int32), sizes)
        node_desc = rng.integers(0, 256, (n_nodes, 32), dtype=np.uint8)
        if kind == "ties" and L > 0:
            inner = children[:starts[L]]
            node_desc[inner[:, 1::2]] = node_desc[inner[:, :1]]
        is_leaf = depth == L
    elif kind == "ragged":
        children_l, depth_l, leaf_l = [[-1] * k], [0], [False]
        level, lvl = [0], 0
        while level and lvl < L:
            nxt = []
            for p in level:
                n = min(k, 6) if lvl == 0 else int(rng.integers(1, min(3, k) + 1))
                for c, s in enumerate(np.sort(rng.choice(k, n, replace=False))):
                    nid = len(depth_l)
                    children_l[p][s] = nid
                    leaf = lvl == L - 1 or (c == 0 and (lvl == 0 or (lvl == 1 and n > 1)))
                    childless = not leaf and ((lvl, c) == (0, 1) or rng.random() < 0.05)
                    children_l.append([-1] * k)
                    depth_l.append(lvl + 1)
                    leaf_l.append(leaf)
                    if not leaf and not childless:
                        nxt.append(nid)
            level, lvl = nxt, lvl + 1
        children = np.asarray(children_l, np.int32)
        depth = np.asarray(depth_l, np.int32)
        is_leaf = np.asarray(leaf_l)
        node_desc = rng.integers(0, 256, (len(depth), 32), dtype=np.uint8)
    else:
        raise ValueError(f"unknown tree kind {kind!r}")
    n_nodes = len(depth)
    node_weight = np.where(is_leaf | ((children < 0).all(1) & (depth > 0)),
                           rng.uniform(0.1, 2.0, n_nodes), 0.0).astype(np.float32)
    leaf_word_id = np.full(n_nodes, -1, np.int32)
    leaf_word_id[is_leaf] = np.arange(int(is_leaf.sum()), dtype=np.int32)
    return HierVocabulary(k, L, children, node_desc, node_weight, leaf_word_id, depth)


def dbow_descriptors(rng: np.random.Generator, voc, n: int, near: float = 0.25):
    """(n, 32) uint8 descriptors for a tree descent: a share ``near`` of
    them copies of random nodes' descriptors with a few bits flipped (so
    distances of 0 and near-ties occur), the rest random."""
    d = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    m = int(n * near)
    if m and len(voc.node_desc) > 1:
        d[:m] = voc.node_desc[rng.integers(1, len(voc.node_desc), m)]
        flips = rng.integers(0, 256, (m, 32)) < 4  # about 1.5% of the bytes
        d[:m] ^= (flips * (1 << rng.integers(0, 8, (m, 32)))).astype(np.uint8)
    return d
