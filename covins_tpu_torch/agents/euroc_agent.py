"""EuRoC replay agent: streams schema-complete keyframes from an EuRoC ASL
sequence directory (`mav0/`).

Counterpart of `covins_tpu/agents/euroc_agent.py`: the same host numpy and
OpenCV (imported lazily, agent-side only), yielding the same messages in
the same order on the same sequence directory.

Functional stand-in for the ORB-SLAM3 front-end in the reference's
canonical workloads (`orb_slam3/covins_examples/euroc_examples_mh*.sh`,
`Examples/Monocular-Inertial/mono_inertial_euroc.cc:43`): reads cam0
images + IMU + ground-truth state, selects keyframes by motion threshold
(the `covins_frontend` t_min/r_min scheme, `frontend_wrapper.cpp:293-310`),
extracts ORB features (OpenCV), maintains landmark TRACKS —
projection-guided continuation (the role of ORB-SLAM3's TrackLocalMap:
project each live track into the new view, search a pixel radius, accept
the best descriptor under a Hamming gate) plus ratio-test minting with
batched midpoint triangulation and two-view reprojection verification —
and emits MsgKeyframe/MsgLandmark streams identical in shape to the
synthetic agent.  All per-frame math is vectorized host numpy: the agent
is the IO/front-end shell, the device is reserved for the back-end.

The odometry poses default to ground truth with optional synthetic drift —
this isolates the BACK-END under test from front-end VIO quality, while
producing real images/descriptors/IMU.  (Rebuilding ORB-SLAM3 itself is
explicitly out of scope, SURVEY.md §2.3.)
"""

from __future__ import annotations

import csv
import dataclasses
import os
from typing import Iterator, Optional

import numpy as np

from covins_tpu_torch.comm import messages as msgs
from covins_tpu_torch.utils import npgeo

# EuRoC MAV cam0 calibration (sensor.yaml of the public dataset)
EUROC_INTRINSICS = np.asarray([458.654, 457.296, 367.215, 248.375, 0.0])
EUROC_DIST = np.asarray([-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05])
EUROC_T_BS = np.asarray([  # cam0 extrinsic T_imu_cam (4x4)
    [0.0148655429818, -0.999880929698, 0.00414029679422, -0.0216401454975],
    [0.999557249008, 0.0149672133247, 0.025715529948, -0.064676986768],
    [-0.0257744366974, 0.00375618835797, 0.999660727178, 0.00981073058949],
    [0.0, 0.0, 0.0, 1.0],
])


def _pose_from_44(T):
    """4x4 transform -> [qw qx qy qz tx ty tz] (also the cereal bridge's
    conversion, `comm/cereal_bridge.py`)."""
    T = np.asarray(T, np.float64)
    R = T[:3, :3]
    # rotation matrix -> quaternion (Shepperd's method, w-positive branch)
    tr = np.trace(R)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        q = np.asarray([0.25 * s, (R[2, 1] - R[1, 2]) / s,
                        (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s])
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(R[i, i] - R[j, j] - R[k, k] + 1.0, 1e-12)) * 2
        q = np.empty(4)
        q[0] = (R[k, j] - R[j, k]) / s
        q[1 + i] = 0.25 * s
        q[1 + j] = (R[j, i] + R[i, j]) / s
        q[1 + k] = (R[k, i] + R[i, k]) / s
    return np.concatenate([npgeo.quat_normalize(q), T[:3, 3]])


# popcount LUT for packed-uint8 ORB descriptors (host-side matching)
_POP = np.unpackbits(np.arange(256, dtype=np.uint8)[:, None], axis=1).sum(
    1).astype(np.uint16)


def _hamming_np(a, b):
    """Packed Hamming distances (N, 32) x (M, 32) uint8 -> (N, M) int."""
    return _POP[a[:, None, :] ^ b[None, :, :]].sum(-1)


def _bearings(uv):
    """Undistorted pixels (N, 2) -> unit camera-frame bearings (N, 3)."""
    fx, fy, cx, cy = EUROC_INTRINSICS[:4]
    v = np.stack([(uv[:, 0] - cx) / fx, (uv[:, 1] - cy) / fy,
                  np.ones(len(uv))], 1)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _triangulate_midpoint_np(o1, d1, o2, d2):
    """Numpy twin of `ops/epipolar.triangulate_midpoint` (batched)."""
    w0 = np.asarray(o1, np.float64) - np.asarray(o2, np.float64)
    a = (d1 * d1).sum(-1)
    b = (d1 * d2).sum(-1)
    c = (d2 * d2).sum(-1)
    d = (d1 * w0).sum(-1)
    e = (d2 * w0).sum(-1)
    denom = a * c - b * b
    ok = np.abs(denom) > 1e-12
    denom_s = np.where(ok, denom, 1.0)
    s = (b * e - c * d) / denom_s
    t = (a * e - b * d) / denom_s
    ok &= (s > 0) & (t > 0)  # cheirality in both views
    X = 0.5 * ((o1 + s[..., None] * d1) + (o2 + t[..., None] * d2))
    return X, ok


@dataclasses.dataclass
class _Track:
    lm_id: int
    pos_w: Optional[np.ndarray]  # triangulated world position
    last_kf: int
    last_feat: int
    sent: bool


class EurocAgent:
    def __init__(
        self,
        seq_dir: str,
        client_id: int,
        max_keyframes: Optional[int] = None,
        n_features: int = 1000,
        kf_t_min: float = 0.12,
        kf_r_min: float = 0.15,
        pose_drift: float = 0.0,
        seed: int = 7,
    ):
        import cv2  # agent-side only (SURVEY §2.4: OpenCV stays agent-side)

        self.cv2 = cv2
        mav0 = os.path.join(seq_dir, "mav0")
        if not os.path.isdir(mav0):
            mav0 = seq_dir  # allow pointing directly at mav0
        self.cam_dir = os.path.join(mav0, "cam0")
        self.imu_csv = os.path.join(mav0, "imu0", "data.csv")
        self.gt_csv = os.path.join(
            mav0, "state_groundtruth_estimate0", "data.csv"
        )
        self.client_id = client_id
        self.max_keyframes = max_keyframes
        self.kf_t_min = kf_t_min
        self.kf_r_min = kf_r_min
        self.pose_drift = pose_drift
        self.rng = np.random.default_rng(seed + client_id)
        self.orb = cv2.ORB_create(nfeatures=n_features)
        self.tri_reproj_px = 2.0    # triangulation verification gate
        self.track_radius_px = 8.0  # projection-guided search radius
        self.match_max_dist = 64    # Hamming gate for guided continuation
        self.mint_max_dist = 50     # Hamming gate for new-track minting
        self.epi_px = 2.5           # epipolar-line gate for minting
        self.calib = msgs.VICalibration(
            T_s_c=_pose_from_44(EUROC_T_BS),
            cam_model=0, dist_model=1,
            intrinsics=EUROC_INTRINSICS.copy(), dist=EUROC_DIST.copy(),
            img_w=752, img_h=480,
        )
        self._next_lm_id = 0

    # ----------------------------------------------------------- data load
    def _load_frames(self):
        rows = []
        with open(os.path.join(self.cam_dir, "data.csv")) as fh:
            for row in csv.reader(fh):
                if row and row[0][0].isdigit():
                    rows.append((int(row[0]), row[1].strip()))
        return rows

    def _load_imu(self):
        data = np.loadtxt(self.imu_csv, delimiter=",", skiprows=1)
        return data  # [t_ns, wx, wy, wz, ax, ay, az]

    def _load_gt(self):
        data = np.loadtxt(self.gt_csv, delimiter=",", skiprows=1)
        # [t_ns, px, py, pz, qw, qx, qy, qz, v..., bw..., ba...]
        return data

    def _gt_pose_at(self, gt, t_ns):
        i = np.searchsorted(gt[:, 0], t_ns)
        i = np.clip(i, 0, len(gt) - 1)
        row = gt[i]
        q = row[4:8]
        p = row[1:4]
        v = row[8:11] if gt.shape[1] > 10 else np.zeros(3)
        pose = np.concatenate([q / np.linalg.norm(q), p])
        return pose, v

    # --------------------------------------------------------------- main
    def messages(self) -> Iterator[object]:
        cv2 = self.cv2
        frames = self._load_frames()
        imu = self._load_imu()
        gt = self._load_gt()
        t0_gt, t1_gt = gt[0, 0], gt[-1, 0]

        tracks: dict[int, _Track] = {}  # feature slot of prev KF -> track
        prev = None  # (kf_idx, kps, descs, pose, t_ns)
        k = 0
        last_pose = None
        drift_pose = None
        self._drift_bias = np.zeros(6)

        for t_ns, fname in frames:
            if not (t0_gt <= t_ns <= t1_gt):
                continue
            pose_gt, vel = self._gt_pose_at(gt, t_ns)
            if last_pose is not None:
                rel = npgeo.pose_relative(last_pose, pose_gt)
                ang = 2.0 * np.arccos(np.clip(abs(rel[0]), 0.0, 1.0))
                if (np.linalg.norm(rel[4:7]) < self.kf_t_min
                        and ang < self.kf_r_min):
                    continue  # not a keyframe (motion threshold)
            img_path = os.path.join(self.cam_dir, "data", fname)
            img = cv2.imread(img_path, cv2.IMREAD_GRAYSCALE)
            if img is None:
                continue
            kps, descs = self.orb.detectAndCompute(img, None)
            if descs is None or len(kps) < 30:
                continue
            last_pose = pose_gt

            # odometry pose: GT, optionally drifted (right-perturbed
            # relative pose re-chained onto the drifted trajectory).
            # The per-KF error is white noise PLUS a slowly-wandering
            # bias (a random walk on the bias itself): real VIO drift is
            # a slowly varying yaw/scale error, which neither cancels
            # over loops of a periodic trajectory (a CONSTANT bias does)
            # nor disappears under the evaluation's Sim(3) alignment (a
            # pure zero-mean walk largely does).
            if self.pose_drift > 0 and drift_pose is not None:
                rel = npgeo.pose_relative(prev[3], pose_gt)
                self._drift_bias += self.rng.normal(
                    0.0, 0.3 * self.pose_drift, 6)
                noise = self.rng.normal(0.0, 0.5 * self.pose_drift, 6) \
                    + self._drift_bias
                noise[:3] *= 0.2
                dq = npgeo.quat_exp(noise[:3])
                rel = np.concatenate([
                    npgeo.quat_normalize(npgeo.quat_multiply(rel[:4], dq)),
                    rel[4:7] + npgeo.quat_rotate(rel[:4], noise[3:]),
                ])
                pose_vio = npgeo.pose_compose(drift_pose, rel)
            else:
                pose_vio = pose_gt
            drift_pose = pose_vio

            uv = np.asarray([kp.pt for kp in kps], np.float32)
            aors = np.asarray(
                [[kp.angle, kp.octave, kp.response, kp.size] for kp in kps],
                np.float32,
            )
            undist = cv2.undistortPoints(
                uv.reshape(-1, 1, 2),
                np.asarray([[EUROC_INTRINSICS[0], 0, EUROC_INTRINSICS[2]],
                            [0, EUROC_INTRINSICS[1], EUROC_INTRINSICS[3]],
                            [0, 0, 1.0]]),
                EUROC_DIST,
                P=np.asarray([[EUROC_INTRINSICS[0], 0, EUROC_INTRINSICS[2]],
                              [0, EUROC_INTRINSICS[1], EUROC_INTRINSICS[3]],
                              [0, 0, 1.0]]),
            ).reshape(-1, 2).astype(np.float32)

            lm_ids = np.full(len(kps), -1, np.int64)
            # (lm_id, pos_w, feat, prev_feat) — both founding observations
            new_lms: list[tuple[int, np.ndarray, int, int]] = []

            if prev is not None:
                T_w_c_prev = npgeo.pose_compose(prev[3], self.calib.T_s_c)
                T_w_c_cur = npgeo.pose_compose(pose_vio, self.calib.T_s_c)
                new_tracks: dict[int, _Track] = {}
                bound_prev = np.zeros(len(prev[2]), bool)
                bound_cur = np.zeros(len(kps), bool)

                # 1) continuation: projection-guided matching.  Global
                #    mutual-NN between random-texture views is mostly
                #    collisions (measured: median 79 px reprojection error);
                #    a real front-end tracks by projecting the map into the
                #    new view (ORB-SLAM3 TrackLocalMap / SearchByProjection).
                slots = [s for s, tr in tracks.items() if tr.pos_w is not None]
                if slots and len(kps):
                    P = np.stack([tracks[s].pos_w for s in slots])
                    pc = npgeo.pose_apply(npgeo.pose_inverse(T_w_c_cur), P)
                    z = np.maximum(pc[:, 2], 1e-9)
                    fx, fy, cx, cy = EUROC_INTRINSICS[:4]
                    proj = np.stack([fx * pc[:, 0] / z + cx,
                                     fy * pc[:, 1] / z + cy], 1)
                    d2 = ((undist[None, :, :] - proj[:, None, :]) ** 2).sum(-1)
                    near = (d2 <= self.track_radius_px ** 2) & (
                        pc[:, 2:3] > 1e-6)
                    ham = _hamming_np(prev[2][np.asarray(slots)], descs)
                    cost = np.where(near & (ham <= self.match_max_dist),
                                    ham, 1 << 14).astype(np.int32)
                    best = cost.min(1)
                    for ti in np.argsort(best):  # best continuations first
                        if best[ti] >= (1 << 14):
                            break
                        j = int(cost[ti].argmin())
                        if bound_cur[j]:
                            continue
                        s = slots[ti]
                        tr = tracks[s]
                        tr.last_kf, tr.last_feat = k, j
                        lm_ids[j] = tr.lm_id
                        new_tracks[j] = tr
                        bound_cur[j] = True
                        bound_prev[s] = True

                # 2) minting: EPIPOLAR-GUIDED matching among still-unbound
                #    features (ORB-SLAM3 SearchForTriangulation: the known
                #    odometry relative pose constrains candidates to the
                #    epipolar line, which makes descriptor discrimination
                #    viable), then ONE batched midpoint triangulation +
                #    two-view reprojection verification (a wrong descriptor
                #    match must not mint a grossly wrong landmark).
                qi = np.where(~bound_prev)[0]
                tj = np.where(~bound_cur)[0]
                cand = []
                baseline = np.linalg.norm(T_w_c_cur[4:7] - T_w_c_prev[4:7])
                if len(qi) and len(tj) and baseline > 1e-3:
                    fx, fy, cx, cy = EUROC_INTRINSICS[:4]
                    K = np.asarray([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
                    T_21 = npgeo.pose_relative(T_w_c_cur, T_w_c_prev)
                    R = npgeo.quat_to_matrix(T_21[:4])
                    t = T_21[4:7]
                    tx = np.asarray([[0, -t[2], t[1]], [t[2], 0, -t[0]],
                                     [-t[1], t[0], 0]])
                    Kinv = np.linalg.inv(K)
                    F = Kinv.T @ tx @ R @ Kinv
                    p1 = np.concatenate(
                        [prev[5][qi], np.ones((len(qi), 1))], 1)
                    p2 = np.concatenate(
                        [undist[tj], np.ones((len(tj), 1))], 1)
                    lines = p1 @ F.T  # epipolar lines in the current image
                    ed = np.abs(lines @ p2.T) / np.maximum(
                        np.hypot(lines[:, :1], lines[:, 1:2]), 1e-12)
                    ham = _hamming_np(prev[2][qi], descs[tj])
                    big = 1 << 14
                    cost = np.where(
                        (ed <= self.epi_px) & (ham <= self.mint_max_dist),
                        ham, big).astype(np.int32)
                    rbest = cost.argmin(1)
                    cbest = cost.argmin(0)
                    rows = np.arange(len(qi))
                    mutual = (cbest[rbest] == rows) & (
                        cost[rows, rbest] < big)
                    cand = [(int(qi[r]), int(tj[rbest[r]]))
                            for r in np.where(mutual)[0]]
                if cand:
                    ca = np.asarray(cand)
                    uv1 = prev[5][ca[:, 0]]
                    uv2 = undist[ca[:, 1]]
                    d1 = npgeo.quat_rotate(T_w_c_prev[:4], _bearings(uv1))
                    d2w = npgeo.quat_rotate(T_w_c_cur[:4], _bearings(uv2))
                    X, ok = _triangulate_midpoint_np(
                        T_w_c_prev[4:7], d1, T_w_c_cur[4:7], d2w)
                    depth = np.linalg.norm(X - T_w_c_prev[4:7], axis=1)
                    ok &= (depth > 0.3) & (depth < 60.0)
                    ok &= self._reproj_errs(X, uv1, T_w_c_prev) \
                        <= self.tri_reproj_px
                    ok &= self._reproj_errs(X, uv2, T_w_c_cur) \
                        <= self.tri_reproj_px
                    for (qslot, jslot), pos, good in zip(cand, X, ok):
                        if not good:
                            continue
                        tr = _Track(self._next_lm_id, pos, k, int(jslot),
                                    False)
                        self._next_lm_id += 1
                        new_lms.append((tr.lm_id, pos, int(jslot),
                                        int(qslot)))
                        lm_ids[jslot] = tr.lm_id
                        new_tracks[int(jslot)] = tr
                tracks = new_tracks  # slots not re-bound are dropped

            # IMU window between previous KF and this one
            pre = None
            if prev is not None:
                sel = (imu[:, 0] > prev[4]) & (imu[:, 0] <= t_ns)
                win = imu[sel]
                if len(win) >= 2:
                    dts = np.diff(win[:, 0], prepend=prev[4]) * 1e-9
                    pre = msgs.PreintegrationData(
                        acc=win[:, 4:7].copy(), gyro=win[:, 1:4].copy(),
                        dts=dts,
                    )

            yield msgs.MsgKeyframe(
                id=(k, self.client_id),
                timestamp=t_ns * 1e-9,
                calibration=self.calib if k == 0 else None,
                keypoints=uv,
                keypoints_undist=undist,
                keypoints_aors=aors,
                descriptors=descs,
                id_reference=(k - 1, self.client_id) if k > 0 else (-1, -1),
                T_sref_s=(
                    npgeo.pose_relative(prev[3], pose_vio)
                    if prev is not None else npgeo.pose_identity()
                ),
                T_w_s_vio=pose_vio,
                velocity=vel,
                bias_gyro=np.zeros(3),
                bias_acc=np.zeros(3),
                preintegration=pre,
                landmark_ids=lm_ids,
                id_predecessor=(k - 1, self.client_id) if k > 0 else (-1, -1),
                id_successor=(-1, -1),
            )
            for lm_id, pos_w, feat, prev_feat in new_lms:
                pos_ref = npgeo.pose_apply(npgeo.pose_inverse(pose_vio),
                                           pos_w)
                yield msgs.MsgLandmark(
                    id=(lm_id, self.client_id),
                    id_reference=(k, self.client_id),
                    pos_ref=pos_ref,
                    # both founding views (the reference landmark message
                    # carries its full observation set, msgs.hpp MsgLandmark)
                    observations={(k - 1, self.client_id): int(prev_feat),
                                  (k, self.client_id): int(feat)},
                )

            prev = (k, kps, descs, pose_vio, t_ns, undist)
            k += 1
            if self.max_keyframes and k >= self.max_keyframes:
                break

    def _reproj_errs(self, X, uv, T_w_c):
        """Batched pinhole reprojection error in pixels; 1e9 behind camera."""
        fx, fy, cx, cy = EUROC_INTRINSICS[:4]
        pc = npgeo.pose_apply(npgeo.pose_inverse(T_w_c), X)
        z = np.maximum(pc[..., 2], 1e-9)
        err = np.hypot(fx * pc[..., 0] / z + cx - uv[..., 0],
                       fy * pc[..., 1] / z + cy - uv[..., 1])
        return np.where(pc[..., 2] < 1e-6, 1e9, err)
