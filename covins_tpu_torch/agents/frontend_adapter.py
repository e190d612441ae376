"""Generic front-end adapter: any odometry+images (or odometry+features)
source -> schema-complete `MsgKeyframe` traffic.

The role of the reference's `covins_frontend` wrapper
(`covins_frontend/src/frontend_wrapper.cpp:16-32`): attach an arbitrary
VIO/odometry system — no ORB-SLAM3, no landmarks, no IMU required — to the
collaborative server.  COVINS-G's place recognition + non-central relative
pose solver close loops from descriptors and odometry alone, which is what
makes this thin attachment viable.

Mirrored reference behaviors:

* motion-threshold keyframing: a frame becomes a keyframe when the body
  moved more than `kf_t_min` meters or rotated more than `kf_r_min`
  radians since the last keyframe (`frontend_wrapper.cpp:293-310`);
* dual ORB extraction: a primary feature set for pose refinement /
  matching plus a denser `_add` set for place recognition
  (`frontend_wrapper.cpp:161-211`, the `*_add` message fields);
* keyframes ship the relative pose vs the previous keyframe (`T_sref_s`)
  and the odometry-frame pose, exactly like the reference messages.

Sources: a recorded CFS stream (`covins_tpu_torch.io.stream` — the
offline attachment path), or direct `process_frame` calls from a live
Python front-end.  Either way the output can be sent through
`covins_tpu_torch.comm.client.AgentClient` to a running server.

Counterpart of `covins_tpu/agents/frontend_adapter.py`, field for field;
OpenCV is imported only where an image is given or a keypoint is
undistorted (agent-side), so the keypoint branch runs without it.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np

from covins_tpu_torch.comm import messages as msgs
from covins_tpu_torch.io import stream as cfs
from covins_tpu_torch.utils import npgeo


class FrontendWrapper:
    def __init__(
        self,
        calib: msgs.VICalibration,
        client_id: int,
        kf_t_min: float = 0.1,
        kf_r_min: float = 0.1,
        n_features: int = 500,
        n_features_add: int = 1000,
    ):
        self.calib = calib
        self.client_id = client_id
        self.kf_t_min = kf_t_min
        self.kf_r_min = kf_r_min
        self.n_features = n_features
        self.n_features_add = n_features_add
        self._orb = None
        self._orb_add = None
        self._k = 0  # next keyframe index
        self._last_kf_pose: Optional[np.ndarray] = None
        self._prev: Optional[tuple] = None  # (pose_vio, t)
        self._imu_acc: list = []
        self._imu_gyro: list = []
        self._imu_dts: list = []

    # ------------------------------------------------------------ features
    def _ensure_orb(self):
        if self._orb is None:
            import cv2  # agent-side only (SURVEY §2.4)

            self._orb = cv2.ORB_create(nfeatures=self.n_features)
            self._orb_add = cv2.ORB_create(nfeatures=self.n_features_add)

    def _extract(self, orb, image):
        kps, descs = orb.detectAndCompute(image, None)
        if descs is None or len(kps) == 0:
            return (np.zeros((0, 2), np.float32),
                    np.zeros((0, 4), np.float32),
                    np.zeros((0, 32), np.uint8))
        uv = np.asarray([kp.pt for kp in kps], np.float32)
        aors = np.asarray(
            [[kp.angle, kp.octave, kp.response, kp.size] for kp in kps],
            np.float32,
        )
        return uv, aors, descs

    def _undistort(self, uv):
        if len(uv) == 0 or self.calib.dist_model == 0:
            return uv.copy()
        import cv2

        fx, fy, cx, cy = [float(x) for x in self.calib.intrinsics[:4]]
        K = np.asarray([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
        flat = uv.reshape(-1, 1, 2).astype(np.float64)
        dist = np.asarray(self.calib.dist, np.float64)
        if self.calib.dist_model == 2:  # equidistant / fisheye
            out = cv2.fisheye.undistortPoints(flat, K, dist, P=K)
        else:  # radtan
            out = cv2.undistortPoints(flat, K, dist, P=K)
        return out.reshape(-1, 2).astype(np.float32)

    # ---------------------------------------------------------------- main
    def feed_imu(self, acc, gyro, dts) -> None:
        """Buffer IMU samples since the last keyframe (optional)."""
        self._imu_acc.append(np.asarray(acc, np.float64).reshape(-1, 3))
        self._imu_gyro.append(np.asarray(gyro, np.float64).reshape(-1, 3))
        self._imu_dts.append(np.asarray(dts, np.float64).reshape(-1))

    def process_frame(
        self,
        timestamp: float,
        T_w_s: np.ndarray,
        image: Optional[np.ndarray] = None,
        keypoints: Optional[np.ndarray] = None,
        descriptors: Optional[np.ndarray] = None,
        keypoints_aors: Optional[np.ndarray] = None,
        velocity: Optional[np.ndarray] = None,
    ) -> Optional[msgs.MsgKeyframe]:
        """One odometry frame in; a keyframe message out iff the motion
        threshold fires (`frontend_wrapper.cpp:293-310`).  Supply either a
        grayscale `image` (ORB is extracted here) or pre-extracted
        `keypoints`+`descriptors`."""
        pose = np.asarray(T_w_s, np.float64)
        if self._last_kf_pose is not None:
            rel = npgeo.pose_relative(self._last_kf_pose, pose)
            ang = 2.0 * np.arccos(np.clip(abs(rel[0]), 0.0, 1.0))
            if (np.linalg.norm(rel[4:7]) < self.kf_t_min
                    and ang < self.kf_r_min):
                return None  # not enough motion: not a keyframe

        kp_add = aors_add = d_add = None
        if image is not None:
            self._ensure_orb()
            uv, aors, descs = self._extract(self._orb, image)
            kp_add, aors_add, d_add = self._extract(self._orb_add, image)
            if len(uv) < 8:
                return None  # texture-free frame: skip
        else:
            if keypoints is None or descriptors is None:
                raise ValueError(
                    "process_frame needs `image` or `keypoints`+`descriptors`"
                )
            uv = np.asarray(keypoints, np.float32).reshape(-1, 2)
            descs = np.ascontiguousarray(descriptors)
            aors = (np.asarray(keypoints_aors, np.float32)
                    if keypoints_aors is not None
                    else np.zeros((len(uv), 4), np.float32))

        undist = self._undistort(uv)
        pre = None
        if self._imu_dts:
            acc = np.concatenate(self._imu_acc)
            gyro = np.concatenate(self._imu_gyro)
            dts = np.concatenate(self._imu_dts)
            if len(dts) >= 2:
                pre = msgs.PreintegrationData(acc=acc, gyro=gyro, dts=dts)
        self._imu_acc, self._imu_gyro, self._imu_dts = [], [], []

        k = self._k
        msg = msgs.MsgKeyframe(
            id=(k, self.client_id),
            timestamp=float(timestamp),
            calibration=self.calib if k == 0 else None,
            keypoints=uv,
            keypoints_undist=undist,
            keypoints_aors=aors,
            descriptors=descs,
            keypoints_add=kp_add if kp_add is not None and len(kp_add) else None,
            keypoints_aors_add=aors_add if d_add is not None and len(d_add) else None,
            descriptors_add=d_add if d_add is not None and len(d_add) else None,
            id_reference=(k - 1, self.client_id) if k > 0 else (-1, -1),
            T_sref_s=(
                npgeo.pose_relative(self._prev[0], pose)
                if self._prev is not None else npgeo.pose_identity()
            ),
            T_w_s_vio=pose,
            velocity=(np.asarray(velocity, np.float64)
                      if velocity is not None else np.zeros(3)),
            bias_gyro=np.zeros(3),
            bias_acc=np.zeros(3),
            preintegration=pre,
            landmark_ids=np.full(len(uv), -1, np.int64),  # odometry-only
            id_predecessor=(k - 1, self.client_id) if k > 0 else (-1, -1),
            id_successor=(-1, -1),
        )
        self._last_kf_pose = pose
        self._prev = (pose, timestamp)
        self._k += 1
        return msg

    # ------------------------------------------------------------- streams
    def replay(self, path: str) -> Iterator[msgs.MsgKeyframe]:
        """Replay a recorded CFS stream into keyframe messages."""
        records = cfs.read_stream(path)
        first = next(records, None)
        if first is None:
            return
        if first.get("kind") == "calib":
            self.calib = cfs.read_calibration(first)
        else:
            if self.calib is None:
                raise ValueError(
                    "CFS stream does not start with a calib record and the "
                    "wrapper was constructed without a calibration — record "
                    "the stream with a calib header (scripts/port_record_cfs.py) "
                    "or pass calib= explicitly"
                )
            records = _chain(first, records)
        for rec in records:
            if rec.get("kind") != "frame":
                continue
            if "acc" in rec and "imu_dts" in rec:
                if rec.get("gyro") is None:
                    raise ValueError(
                        f"frame at t={rec.get('timestamp')} carries acc/"
                        "imu_dts but no gyro samples; IMU records need all "
                        "three"
                    )
                self.feed_imu(rec["acc"], rec["gyro"], rec["imu_dts"])
            msg = self.process_frame(
                timestamp=rec["timestamp"],
                T_w_s=rec["T_w_s"],
                image=rec.get("image"),
                keypoints=rec.get("keypoints"),
                descriptors=rec.get("descriptors"),
                keypoints_aors=rec.get("keypoints_aors"),
                velocity=rec.get("velocity"),
            )
            if msg is not None:
                yield msg


def _chain(first, rest):
    yield first
    yield from rest


def run_stream(path: str, host: str, port: int, **wrapper_kw) -> int:
    """Replay a CFS stream against a live server (the client id comes from
    the server handshake).  Returns #keyframes sent."""
    from covins_tpu_torch.comm.client import AgentClient

    client = AgentClient(host=host, port=port)
    wrapper = FrontendWrapper(
        calib=None, client_id=client.client_id, **wrapper_kw
    )
    n = 0
    try:
        for msg in wrapper.replay(path):
            client.send(msg)
            n += 1
    finally:
        client.finish()
    return n
