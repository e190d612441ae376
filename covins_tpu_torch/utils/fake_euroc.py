"""Synthetic EuRoC-ASL sequence writer for dataset-free end-to-end tests.

Renders the synthetic world as textured patches into real PNG images laid
out exactly like an EuRoC `mav0/` directory (cam0 images + data.csv,
imu0/data.csv, state_groundtruth_estimate0/data.csv), using the REAL
EuRoC cam0 calibration (intrinsics + radtan distortion + T_BS extrinsic)
so `EurocAgent` replays it unmodified: image loading, ORB extraction,
mutual-NN tracking, triangulation — the whole front-end stand-in runs on
actual pixels.  This removes the dataset dependency from the EuRoC code
path (the real sequences still plug in via scripts/fetch_euroc.sh).

Each world landmark gets a fixed random 11x11 texture patch, so its ORB
descriptor is stable across views and tracks survive like real features.

Counterpart of `covins_tpu/utils/fake_euroc.py`: the same draws from the
same seed, projected with the port's own `utils/cameras.py` and
`utils/geometry.py` on CPU tensors (agent-side data generation, asked for
explicitly: no device is involved) and the port's `utils/synthetic.py`
trajectory.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from covins_tpu_torch.agents.euroc_agent import EUROC_DIST, EUROC_INTRINSICS, EUROC_T_BS
from covins_tpu_torch.utils import cameras as cam_mod
from covins_tpu_torch.utils import geometry as geo, npgeo, synthetic


def _cpu(a):
    """A float64 CPU tensor of ``a``: the renderer's geometry runs on the
    CPU by request."""
    return torch.as_tensor(np.asarray(a, np.float64), device="cpu")


def _euroc_camera():
    """The EuRoC cam0 model (pinhole, radtan) on the CPU, and its
    extrinsic T_imu_cam as a 7-vector."""
    cam = cam_mod.Camera(
        intrinsics=_cpu(EUROC_INTRINSICS), dist=_cpu(EUROC_DIST),
        T_s_c=_cpu(npgeo.pose_identity()),
        cam_model=cam_mod.PINHOLE, dist_model=cam_mod.RADTAN,
    )
    return cam, geo.pose_from_matrix(_cpu(EUROC_T_BS)).numpy()


def sample_world(
    n_anchors: int = 30,
    kf_dt: float = 0.5,
    t0: float = 0.0,
    n_landmarks: int = 400,
    seed: int = 0,
):
    """Sample a renderable landmark world along the master trajectory.

    Landmarks sampled INSIDE the camera frusta: random pixels at random
    depths back-projected from poses along the trajectory (the real
    EuRoC cam0 extrinsic does not look at the synthetic agent's cloud
    volume — with EUROC_T_BS the optical axis is near body-z).  This
    guarantees dozens of visible landmarks per frame and multi-view
    tracks between temporal neighbors.  The landmark RNG is consumed
    deterministically (seed) so sequences are reproducible.

    Returns a dict to pass as `world=` to :func:`write_fake_sequence`;
    sharing one world across sequences is what makes inter-agent loop
    closure (and therefore map merges) possible.
    """
    rng = np.random.default_rng(seed)
    traj = synthetic.generate(n_keyframes=n_anchors, kf_dt=kf_dt, t0=t0)
    poses = np.asarray(traj.poses)
    cam, T_s_c = _euroc_camera()
    lms = []
    quad_u, quad_v = [], []  # in-plane world axes per landmark
    per_frame = max(2, n_landmarks // n_anchors)
    for k in range(n_anchors):
        T_w_cam_k = npgeo.pose_compose(poses[k], T_s_c)
        R_w_cam = npgeo.quat_to_matrix(T_w_cam_k[:4])
        px = rng.uniform([60, 60], [692, 420], (per_frame, 2))
        depth = rng.uniform(4.0, 14.0, per_frame)
        bear = cam_mod.back_project3(cam, _cpu(px)).numpy()
        p_cam = bear * (depth / bear[:, 2])[:, None]
        lms.append(npgeo.pose_apply(T_w_cam_k, p_cam))
        # quad plane: camera-facing at the anchor view, metric size such
        # that it appears ~P px there
        half = depth * (0.5 * 33) / float(EUROC_INTRINSICS[0])
        for h in half:
            quad_u.append(R_w_cam[:, 0] * h)
            quad_v.append(R_w_cam[:, 1] * h)
    lms = np.concatenate(lms)[:n_landmarks]
    quad_u = np.asarray(quad_u)[:n_landmarks]
    quad_v = np.asarray(quad_v)[:n_landmarks]

    # fixed texture per landmark (stable ORB descriptors across views).
    # Patch must EXCEED ORB's 31-px BRIEF sampling window, or every
    # descriptor is dominated by the patch-vs-background edge and all
    # landmarks collide (measured: 97/115 wrong matches at 11 px).
    P = 33
    patches = rng.integers(40, 255, (len(lms), P, P)).astype(np.uint8)
    return {"lms": lms, "quad_u": quad_u, "quad_v": quad_v,
            "patches": patches}


def write_fake_sequence(
    out_dir: str,
    n_keyframes: int = 30,
    n_landmarks: int = 400,
    kf_dt: float = 0.5,
    t0: float = 0.0,
    seed: int = 0,
    imu_rate: float = 200.0,
    world: dict | None = None,
):
    """Write `<out_dir>/mav0/...`; returns out_dir.

    `world` (from :func:`sample_world`) shares one landmark/texture set
    across sequences so multiple agents see the SAME scene — the
    precondition for inter-agent loop closure and map merges."""
    rng = np.random.default_rng(seed)
    traj = synthetic.generate(n_keyframes=n_keyframes, kf_dt=kf_dt, t0=t0,
                              imu_rate=imu_rate)
    poses = np.asarray(traj.poses)  # T_w_body
    vels = np.asarray(traj.vels)
    times_ns = (np.asarray(traj.times) * 1e9).astype(np.int64)
    cam, T_s_c = _euroc_camera()

    if world is None:
        world = sample_world(n_anchors=n_keyframes, kf_dt=kf_dt, t0=t0,
                             n_landmarks=n_landmarks, seed=seed)
    lms = world["lms"]
    quad_u, quad_v = world["quad_u"], world["quad_v"]
    patches = world["patches"]
    n_landmarks = len(lms)
    P = patches.shape[1]

    mav0 = os.path.join(out_dir, "mav0")
    img_dir = os.path.join(mav0, "cam0", "data")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(os.path.join(mav0, "imu0"), exist_ok=True)
    os.makedirs(os.path.join(mav0, "state_groundtruth_estimate0"),
                exist_ok=True)

    import cv2

    cam_rows = ["#timestamp [ns],filename"]
    src_quad = np.asarray(
        [[0, 0], [P - 1, 0], [P - 1, P - 1], [0, P - 1]], np.float32
    )
    for k in range(n_keyframes):
        T_w_cam = npgeo.pose_compose(poses[k], T_s_c)
        T_cam_w = npgeo.pose_inverse(T_w_cam)
        p_c = npgeo.pose_apply(T_cam_w, lms)
        uv, valid = cam_mod.project3(cam, _cpu(p_c))
        uv = uv.numpy()
        ok = (valid.numpy() & (p_c[:, 2] > 0.3) & (p_c[:, 2] < 25.0)
              & (uv[:, 0] > P) & (uv[:, 0] < 752 - P)
              & (uv[:, 1] > P) & (uv[:, 1] < 480 - P))
        img = np.full((480, 752), 15, np.uint8)
        # each landmark is a textured 3D QUAD: project its 4 world corners
        # (full distortion) and homography-warp the patch — every texture
        # pixel is then a geometrically consistent 3D point, so ORB
        # corners triangulate/reproject exactly across views
        for li in np.where(ok)[0]:
            corners_w = np.stack([
                lms[li] - quad_u[li] - quad_v[li],
                lms[li] + quad_u[li] - quad_v[li],
                lms[li] + quad_u[li] + quad_v[li],
                lms[li] - quad_u[li] + quad_v[li],
            ])
            cc = npgeo.pose_apply(T_cam_w, corners_w)
            if (cc[:, 2] <= 0.3).any():
                continue
            uvc, vc = cam_mod.project3(cam, _cpu(cc))
            uvc = uvc.numpy().astype(np.float32)
            if not bool(vc.all()):
                continue
            H, _ = cv2.findHomography(src_quad, uvc)
            if H is None:
                continue
            warped = cv2.warpPerspective(
                patches[li], H, (752, 480), flags=cv2.INTER_LINEAR,
                borderMode=cv2.BORDER_CONSTANT, borderValue=0,
            )
            img = np.maximum(img, warped)
        fname = f"{times_ns[k]}.png"
        cv2.imwrite(os.path.join(img_dir, fname), img)
        cam_rows.append(f"{times_ns[k]},{fname}")
    with open(os.path.join(mav0, "cam0", "data.csv"), "w") as f:
        f.write("\n".join(cam_rows) + "\n")

    # IMU between keyframes (exact synthetic samples)
    acc = np.asarray(traj.imu_acc)    # (K-1, S, 3)
    gyro = np.asarray(traj.imu_gyro)
    dts = np.asarray(traj.imu_dts)
    imu_rows = ["#timestamp [ns],w_RS_S_x [rad s^-1],w_RS_S_y,w_RS_S_z,"
                "a_RS_S_x [m s^-2],a_RS_S_y,a_RS_S_z"]
    for k in range(acc.shape[0]):
        # INTEGER stamp arithmetic anchored at the keyframe stamp: float
        # accumulation + int() truncation makes late-sequence boundary
        # samples swap keyframe windows after replay slicing, which
        # corrupts the preintegration intervals (measured up to 0.7 m of
        # forward-prediction error per 0.1 s interval near sequence end)
        t_ns = int(times_ns[k])
        n_s = acc.shape[1]
        for s in range(n_s):
            t_ns += int(round(float(dts[k, s]) * 1e9))
            if s == n_s - 1:
                # pin the boundary sample exactly onto the next keyframe
                # stamp so window slicing is exact
                t_ns = int(times_ns[k + 1])
            imu_rows.append(
                f"{t_ns},{gyro[k, s, 0]},{gyro[k, s, 1]},"
                f"{gyro[k, s, 2]},{acc[k, s, 0]},{acc[k, s, 1]},{acc[k, s, 2]}"
            )
    with open(os.path.join(mav0, "imu0", "data.csv"), "w") as f:
        f.write("\n".join(imu_rows) + "\n")

    # debug/eval ground truth for the fake world (not part of ASL layout)
    np.savez(os.path.join(mav0, "fake_truth.npz"),
             lms=lms, quad_u=quad_u, quad_v=quad_v, poses=poses,
             times_ns=times_ns)

    gt_rows = ["#timestamp,p_RS_R_x [m],p_RS_R_y,p_RS_R_z,q_RS_w,q_RS_x,"
               "q_RS_y,q_RS_z,v_RS_R_x,v_RS_R_y,v_RS_R_z,b_w_x,b_w_y,b_w_z,"
               "b_a_x,b_a_y,b_a_z"]
    for k in range(n_keyframes):
        q, p = poses[k, :4], poses[k, 4:7]
        v = vels[k]
        gt_rows.append(
            f"{times_ns[k]},{p[0]},{p[1]},{p[2]},{q[0]},{q[1]},{q[2]},{q[3]},"
            f"{v[0]},{v[1]},{v[2]},0,0,0,0,0,0"
        )
    with open(os.path.join(mav0, "state_groundtruth_estimate0", "data.csv"),
              "w") as f:
        f.write("\n".join(gt_rows) + "\n")
    return out_dir
