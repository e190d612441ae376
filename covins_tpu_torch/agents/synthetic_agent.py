"""Synthetic agent: a schema-complete keyframe/landmark message stream from
the analytic trajectory generator.

Counterpart of `covins_tpu/agents/synthetic_agent.py`, with the same
message schema and world statistics: relative pose vs the previous
keyframe, raw IMU samples between keyframes, per-feature landmark ids with
track-loss semantics, per-landmark reference-frame positions.  Descriptors
are synthesised per landmark: one random 256-bit signature whose
observations flip a few bits (ORB), or with ``feat_type="SIFT"`` a
128-dimensional float32 vector of |N(0, 1)| entries scaled to norm 512
whose observations add N(0, 8) noise and take the absolute value.  The world's landmarks and signatures are
drawn with numpy here and with `jax.random` in the JAX package, so the two
streams are not bit-equal; parity tests feed the JAX package's streams to
both (`covins_tpu_torch.state.messages_from_reference`).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np
import torch

from covins_tpu_torch.comm import messages as msgs
from covins_tpu_torch.utils import cameras as cam_mod
from covins_tpu_torch.utils import npgeo, synthetic

# camera optical axis along body +x: R_s_c = [[0,0,1],[-1,0,0],[0,-1,0]]
# as the quaternion [qw qx qy qz] = [0.5, -0.5, 0.5, -0.5]
FORWARD_T_S_C = np.asarray([0.5, -0.5, 0.5, -0.5, 0.0, 0.0, 0.0])


def _se3_exp(xi):
    """se(3) tangent [rot, trans] -> pose, with the SO(3) left Jacobian."""
    w, v = xi[:3], xi[3:]
    theta = np.sqrt(max(float(w @ w), 1e-24))
    W = np.asarray([[0.0, -w[2], w[1]], [w[2], 0.0, -w[0]], [-w[1], w[0], 0.0]])
    if theta < 1e-5:
        a, b = 0.5 - theta**2 / 24.0, 1.0 / 6.0 - theta**2 / 120.0
    else:
        a = (1.0 - np.cos(theta)) / theta**2
        b = (theta - np.sin(theta)) / theta**3
    Jl = np.eye(3) + a * W + b * (W @ W)
    return np.concatenate([npgeo.quat_exp(w), Jl @ v])


@dataclasses.dataclass
class SyntheticWorld:
    """Shared ground truth for N agents flying through one scene."""

    landmarks: np.ndarray  # (M, 3)
    lm_descs: np.ndarray  # (M, B) uint8 signatures or (M, D) float32 SIFT
    calib: msgs.VICalibration

    @classmethod
    def create(cls, n_landmarks=800, desc_bytes=32, seed=0, feat_type="ORB"):
        rng = np.random.default_rng(seed)
        lms = synthetic.generate_landmarks(rng, n=n_landmarks)
        if feat_type == "SIFT":
            descs = np.abs(rng.standard_normal((n_landmarks, desc_bytes))).astype(np.float32)
            descs *= 512.0 / np.linalg.norm(descs, axis=-1, keepdims=True)
        else:
            descs = rng.integers(0, 256, (n_landmarks, desc_bytes), dtype=np.uint8)
        calib = msgs.VICalibration(
            T_s_c=FORWARD_T_S_C.copy(),
            cam_model=cam_mod.PINHOLE,
            dist_model=cam_mod.RADTAN,
            intrinsics=np.asarray([458.0, 457.0, 376.0, 240.0, 0.0]),
            dist=np.zeros(4),
            img_w=752, img_h=480,
        )
        return cls(lms, descs, calib)


class SyntheticAgent:
    """One agent streaming keyframes along a (time-shifted) trajectory."""

    def __init__(
        self,
        world: SyntheticWorld,
        client_id: int,
        n_keyframes: int = 40,
        kf_dt: float = 0.5,
        t0: float = 0.0,
        px_noise: float = 0.3,
        desc_bit_flips: int = 4,
        pose_drift: float = 0.0,
        seed: Optional[int] = None,
        max_features: Optional[int] = None,
    ):
        """``max_features`` caps the features per keyframe as a front-end's
        extractor does (ORB-SLAM3's ``ORBextractor.nFeatures``); None keeps
        every visible landmark, as the JAX package's agent does."""
        self.world = world
        self.client_id = client_id
        self.px_noise = px_noise
        self.desc_bit_flips = desc_bit_flips
        self.pose_drift = pose_drift
        self.max_features = max_features
        self.rng = np.random.default_rng(
            client_id * 1000 + (seed if seed is not None else 7)
        )
        self.traj = synthetic.generate(n_keyframes=n_keyframes, kf_dt=kf_dt, t0=t0)
        self.n_keyframes = n_keyframes
        # a world landmark keeps its client id only while tracked; after
        # `track_gap` keyframes unseen a revisit mints a NEW id (loop
        # closure, not tracking, must re-associate)
        self.track_gap = 3
        self._lm_client_id: dict[int, int] = {}  # world idx -> client lm id
        self._lm_last_seen: dict[int, int] = {}
        self.lm_world_idx: dict[int, int] = {}  # client lm id -> world idx
        self._next_lm_id = 0
        # drifted "VIO" poses: what the front-end believes
        self._vio_poses = self._make_vio_poses()
        calib = world.calib
        self._cam = cam_mod.Camera(
            intrinsics=torch.as_tensor(calib.intrinsics, dtype=torch.float64),
            dist=torch.as_tensor(calib.dist, dtype=torch.float64),
            T_s_c=torch.as_tensor(calib.T_s_c, dtype=torch.float64),
            cam_model=calib.cam_model, dist_model=calib.dist_model)

    def _make_vio_poses(self):
        gt = self.traj.poses
        if self.pose_drift <= 0:
            return gt.copy()
        rel = npgeo.pose_relative(gt[:-1], gt[1:])
        out = [gt[0]]
        for k in range(len(rel)):
            noise = self.rng.normal(0.0, self.pose_drift, 6)
            noise[:3] *= 0.2  # less rotational drift
            T = npgeo.pose_compose(rel[k], _se3_exp(noise))
            out.append(npgeo.pose_compose(out[-1], T))
        return np.stack(out)

    def visible_landmarks(self, k: int):
        """Indices + pixel obs of world landmarks visible from GT pose k."""
        T_w_c = npgeo.pose_compose(self.traj.poses[k], self.world.calib.T_s_c)
        p_c = npgeo.pose_apply(npgeo.pose_inverse(T_w_c)[None],
                               self.world.landmarks)
        uv, valid = cam_mod.project3(self._cam, torch.from_numpy(p_c))
        uv, valid = uv.numpy(), valid.numpy()
        calib = self.world.calib
        ok = (
            valid
            & (p_c[:, 2] > 0.3) & (p_c[:, 2] < 25.0)
            & (uv[:, 0] > 0) & (uv[:, 0] < calib.img_w)
            & (uv[:, 1] > 0) & (uv[:, 1] < calib.img_h)
        )
        idx = np.where(ok)[0]
        return idx, uv[idx]

    def _noisy_desc(self, lm_idx: int) -> np.ndarray:
        d = self.world.lm_descs[lm_idx].copy()
        if d.dtype != np.uint8:  # SIFT: additive noise, kept non-negative
            d = d + self.rng.normal(0.0, 8.0, d.shape).astype(np.float32)
            return np.abs(d).astype(np.float32)
        for _ in range(self.desc_bit_flips):
            bit = self.rng.integers(0, d.size * 8)
            d[bit // 8] ^= np.uint8(1 << (bit % 8))
        return d

    def messages(self) -> Iterator[object]:
        """Yield the full message stream (KFs interleaved with landmarks)."""
        traj = self.traj
        for k in range(self.n_keyframes):
            idx, uv = self.visible_landmarks(k)
            if self.max_features is not None:
                idx, uv = idx[: self.max_features], uv[: self.max_features]
            uv = uv + self.rng.normal(0.0, self.px_noise, uv.shape)
            descs = np.stack([self._noisy_desc(i) for i in idx]) if len(idx) else (
                np.zeros((0,) + self.world.lm_descs.shape[1:],
                         self.world.lm_descs.dtype))
            aors = np.zeros((len(idx), 4), np.float32)  # octave 0
            lm_ids = np.empty(len(idx), np.int64)
            new_world_idx = []
            for j, wi in enumerate(idx):
                wi = int(wi)
                last = self._lm_last_seen.get(wi, -(10**9))
                if k - last > self.track_gap:
                    self._lm_client_id[wi] = self._next_lm_id
                    self.lm_world_idx[self._next_lm_id] = wi
                    self._next_lm_id += 1
                    new_world_idx.append((j, wi))
                self._lm_last_seen[wi] = k
                lm_ids[j] = self._lm_client_id[wi]

            if k == 0:
                T_sref_s = npgeo.pose_identity()
                id_ref = (-1, -1)
                pre = None
            else:
                T_sref_s = npgeo.pose_relative(self._vio_poses[k - 1],
                                               self._vio_poses[k])
                id_ref = (k - 1, self.client_id)
                pre = msgs.PreintegrationData(
                    acc=traj.imu_acc[k - 1], gyro=traj.imu_gyro[k - 1],
                    dts=traj.imu_dts[k - 1])

            yield msgs.MsgKeyframe(
                id=(k, self.client_id),
                timestamp=float(traj.times[k]),
                calibration=self.world.calib if k == 0 else None,
                keypoints=uv.astype(np.float32),
                keypoints_undist=uv.astype(np.float32),
                keypoints_aors=aors,
                descriptors=descs,
                id_reference=id_ref,
                T_sref_s=T_sref_s,
                T_w_s_vio=self._vio_poses[k],
                velocity=np.asarray(traj.vels[k]),
                bias_gyro=np.zeros(3),
                bias_acc=np.zeros(3),
                preintegration=pre,
                landmark_ids=lm_ids,
                id_predecessor=(k - 1, self.client_id) if k > 0 else (-1, -1),
                id_successor=(-1, -1),
            )

            # newly minted landmarks: pos_ref is the GT BODY-RELATIVE
            # position, so the server's world placement inherits the anchor
            # keyframe's drift (loop closure then has drift to correct)
            if not new_world_idx:
                continue
            pos_ref = npgeo.pose_apply(
                npgeo.pose_inverse(traj.poses[k])[None],
                self.world.landmarks[[wi for _, wi in new_world_idx]])
            for (j, _), p in zip(new_world_idx, pos_ref):
                yield msgs.MsgLandmark(
                    id=(int(lm_ids[j]), self.client_id),
                    id_reference=(k, self.client_id),
                    pos_ref=p,
                    observations={(k, self.client_id): int(j)},
                )
