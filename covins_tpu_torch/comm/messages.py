"""Message schema: the agent->server data contract.

Field-compatible re-design of the reference's cereal-serialized messages
(`covins_comm/include/covins/covins_base/msgs/msg_keyframe.hpp:45-203`,
`msg_landmark.hpp:23-104`): same field inventory, same relative-pose
parameterization (keyframe pose ships as ``T_sref_s`` against a reference
keyframe; landmark position ships as ``pos_ref`` in its reference
keyframe's frame), same update-vs-full split.  Storage is flat numpy —
records batch directly into device arrays at ingest.

A copy of the JAX package's `comm/messages.py`; this module is
transport-neutral (the wire codec is not part of the port yet).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

# msg_type tags (reference: MsgKeyframe::msg_type vector semantics —
# size/is_update/id/client/kf-or-lm; here an explicit enum)
MSG_KEYFRAME = 0
MSG_KEYFRAME_UPDATE = 1
MSG_LANDMARK = 2
MSG_LANDMARK_UPDATE = 3
MSG_HANDSHAKE = 4
MSG_FINISH = 5


@dataclasses.dataclass
class VICalibration:
    """Camera + IMU calibration (reference `typedefs_base.hpp:279-381`)."""

    T_s_c: np.ndarray  # (7,) [qw qx qy qz tx ty tz] IMU->camera extrinsic
    cam_model: int  # 0 pinhole | 1 omni
    dist_model: int  # 0 none | 1 radtan | 2 equidistant | 3 fisheye
    intrinsics: np.ndarray  # (5,) fx fy cx cy xi
    dist: np.ndarray  # (4,)
    img_w: int
    img_h: int
    # IMU noise densities + rates (EuRoC-style)
    acc_noise: float = 2.0e-3
    gyro_noise: float = 1.7e-4
    acc_walk: float = 3.0e-3
    gyro_walk: float = 2.0e-5
    imu_rate: float = 200.0
    gravity_mag: float = 9.81


@dataclasses.dataclass
class PreintegrationData:
    """Raw IMU samples between this KF and its predecessor
    (reference `msg_keyframe.hpp:24-43` ships raw measurements so the
    server can re-propagate at new bias estimates)."""

    acc: np.ndarray  # (S, 3)
    gyro: np.ndarray  # (S, 3)
    dts: np.ndarray  # (S,)


@dataclasses.dataclass
class MsgKeyframe:
    """Full keyframe message (reference `msg_keyframe.hpp:45-203`)."""

    id: tuple[int, int]  # (kf_id, client_id) — the reference idpair
    timestamp: float
    calibration: Optional[VICalibration]
    # primary keypoints (used for pose estimation; COVINS place rec too)
    keypoints: np.ndarray  # (F, 2) distorted pixel coords
    keypoints_undist: np.ndarray  # (F, 2)
    keypoints_aors: np.ndarray  # (F, 4) [angle, octave, response, size]
    descriptors: np.ndarray  # (F, B) uint8 (B=32 ORB) or (F, 128) f32 SIFT
    # additional feature set (COVINS-G: separate PR vs pose-estimation
    # features, `msg_keyframe.hpp` `_add` fields); None -> same as primary
    keypoints_add: Optional[np.ndarray] = None
    keypoints_aors_add: Optional[np.ndarray] = None
    descriptors_add: Optional[np.ndarray] = None
    # relative pose vs reference (predecessor) KF: T_sref_s
    id_reference: tuple[int, int] = (-1, -1)
    T_sref_s: np.ndarray = None  # (7,)
    # odometry-frame pose (for PGO successor edges, GetPoseTws_vio)
    T_w_s_vio: np.ndarray = None  # (7,)
    velocity: np.ndarray = None  # (3,)
    bias_gyro: np.ndarray = None  # (3,)
    bias_acc: np.ndarray = None  # (3,)
    preintegration: Optional[PreintegrationData] = None
    # landmark index map: feature idx -> landmark id (own-client ids)
    landmark_ids: Optional[np.ndarray] = None  # (F,) int64, -1 = none
    id_predecessor: tuple[int, int] = (-1, -1)
    id_successor: tuple[int, int] = (-1, -1)
    is_update: bool = False
    img: Optional[np.ndarray] = None


@dataclasses.dataclass
class MsgKeyframeUpdate:
    """Pose-only update (the reference's update serialization layout,
    `msg_keyframe.hpp:128-202`: relative pose vs origin KF0 + vel/bias)."""

    id: tuple[int, int]
    id_reference: tuple[int, int]
    T_sref_s: np.ndarray  # (7,)
    velocity: np.ndarray
    bias_gyro: np.ndarray
    bias_acc: np.ndarray


@dataclasses.dataclass
class MsgLandmark:
    """Landmark message (reference `msg_landmark.hpp:23-104`)."""

    id: tuple[int, int]  # (lm_id, client_id)
    id_reference: tuple[int, int]  # reference KF
    pos_ref: np.ndarray  # (3,) position in reference-KF body frame
    observations: dict  # {(kf_id, client_id): feature_idx}
    is_update: bool = False


@dataclasses.dataclass
class MsgLandmarkUpdate:
    """Position-only landmark update (the reference's `is_update_msg`
    landmark path, `communicator_be.cpp:157-163` -> `UpdatePosFromMsg`,
    `landmark_be.cpp:222-238`); only processed when `comm.send_updates`."""

    id: tuple[int, int]
    id_reference: tuple[int, int]
    pos_ref: np.ndarray  # (3,)
