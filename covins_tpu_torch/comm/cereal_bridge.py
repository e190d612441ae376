"""Decode-only bridge for the reference's cereal/TCP agent protocol.

A stock COVINS front-end (ORB-SLAM3 + covins_comm) speaks:

* framed TCP with a 10x5 big-endian u32 header container — each entry is
  [payload_size, is_update, id.first, id.second, kind(0=KF,1=LM)] and up
  to 10 payloads follow back-to-back
  (`covins_comm/src/covins_base/communicator_base.cpp:276-315`
  RecvMsg/WriteToBuffer, `:127-138` packi32);
* an id-assignment container from the server whose first entry is
  [1, client_id, 0, 0, 0] (`communicator_base.cpp:288-292`);
* cereal BinaryArchive payloads — raw little-endian field concatenation
  in the exact member order of `msg_keyframe.hpp:128-203` /
  `msg_landmark.hpp:68-104`, with the repo's custom Eigen (i32 rows, i32
  cols, column-major data) and cv::Mat (i32 rows/cols/type, bool
  continuous, data) adapters (`msg_keyframe.hpp:210-287`).

Counterpart of `covins_tpu/comm/cereal_bridge.py`, byte for byte: this
module parses those bytes into `covins_tpu_torch.comm.messages` so an
UNMODIFIED C++ agent can attach to the port's back end.  The mirror-image
encoder exists for round-trip tests and for recording reference-protocol
streams without the C++ toolchain.
"""

from __future__ import annotations

import struct
from typing import Iterator, List

import numpy as np

from covins_tpu_torch.agents.euroc_agent import _pose_from_44
from covins_tpu_torch.comm import messages as msgs
from covins_tpu_torch.utils import npgeo

CONTAINER_ENTRIES = 10
HEADER_BYTES = CONTAINER_ENTRIES * 5 * 4  # 10 entries x 5 u32, big-endian

# reference enum -> our distortion codes (typedefs_base.hpp:247-253 vs
# covins_tpu_torch.utils.cameras: 0 none, 1 radtan, 2 equidistant, 3 fisheye)
_DIST_FROM_REF = {-1: 0, 0: 1, 1: 2, 2: 1}
_DIST_TO_REF = {0: -1, 1: 0, 2: 1, 3: 0}


def _pose_to_44(p: np.ndarray) -> np.ndarray:
    T = np.eye(4)
    T[:3, :3] = npgeo.quat_to_matrix(np.asarray(p[:4], np.float64))
    T[:3, 3] = p[4:7]
    return T


class Reader:
    """Sequential little-endian cereal BinaryArchive reader."""

    def __init__(self, buf: bytes):
        self.b = memoryview(buf)
        self.o = 0

    def raw(self, n: int) -> memoryview:
        v = self.b[self.o:self.o + n]
        if len(v) != n:
            raise ValueError(f"cereal payload truncated at {self.o}+{n}")
        self.o += n
        return v

    def f64(self) -> float:
        return struct.unpack_from("<d", self.b, self._adv(8))[0]

    def i32(self) -> int:
        return struct.unpack_from("<i", self.b, self._adv(4))[0]

    def u64(self) -> int:
        return struct.unpack_from("<Q", self.b, self._adv(8))[0]

    def boolean(self) -> bool:
        return bool(self.raw(1)[0])

    def _adv(self, n: int) -> int:
        o = self.o
        if o + n > len(self.b):
            raise ValueError(f"cereal payload truncated at {o}+{n}")
        self.o += n
        return o

    # ---- composite adapters (the repo's cereal customizations) ----------
    def idpair(self) -> tuple:
        return (self.u64(), self.u64())

    def eigen(self, dtype=np.float64) -> np.ndarray:
        rows, cols = self.i32(), self.i32()
        itemsize = np.dtype(dtype).itemsize
        data = np.frombuffer(self.raw(rows * cols * itemsize), dtype=dtype)
        return data.reshape((cols, rows)).T  # column-major storage

    def vec_f64(self) -> np.ndarray:
        n = self.u64()  # cereal size_tag
        return np.frombuffer(self.raw(8 * n), np.float64).copy()

    def vec_eigen(self, dtype=np.float32) -> np.ndarray:
        n = self.u64()
        return np.stack(
            [self.eigen(dtype).reshape(-1) for _ in range(n)]
        ) if n else np.zeros((0, 0), dtype)

    def cv_mat(self) -> np.ndarray:
        rows, cols, cv_type = self.i32(), self.i32(), self.i32()
        continuous = self.boolean()
        depth = cv_type & 7
        channels = (cv_type >> 3) + 1
        dtype = {0: np.uint8, 1: np.int8, 2: np.uint16, 3: np.int16,
                 4: np.int32, 5: np.float32, 6: np.float64}[depth]
        elem = np.dtype(dtype).itemsize * channels
        if not continuous:
            raise ValueError("non-continuous cv::Mat not supported")
        data = np.frombuffer(self.raw(rows * cols * elem), dtype=dtype)
        return data.reshape(rows, cols * channels).copy()

    def vicalibration(self) -> msgs.VICalibration:
        # typedefs_base.hpp:379-383 serialize order
        T_SC = self.eigen(np.float64)        # (4, 4)
        cam_model = self.i32()
        dist_model = self.i32()
        img_dims = self.eigen(np.float64).reshape(-1)
        dist_coeffs = self.eigen(np.float64).reshape(-1)
        intrinsics = self.eigen(np.float64).reshape(-1)
        _K = self.eigen(np.float64)
        a_max, g_max = self.f64(), self.f64()
        sigma_a_c, sigma_g_c = self.f64(), self.f64()
        _sigma_ba, _sigma_bg = self.f64(), self.f64()
        sigma_aw_c, sigma_gw_c = self.f64(), self.f64()
        _tau, g = self.f64(), self.f64()
        _a0 = self.eigen(np.float64)
        rate = self.i32()
        _d0, _d1 = self.f64(), self.f64()
        intr5 = np.zeros(5)
        intr5[:min(4, len(intrinsics))] = intrinsics[:4]
        dist4 = np.zeros(4)
        dist4[:min(4, len(dist_coeffs))] = dist_coeffs[:4]
        return msgs.VICalibration(
            T_s_c=_pose_from_44(T_SC),
            cam_model=max(cam_model, 0),
            dist_model=_DIST_FROM_REF.get(dist_model, 1),
            intrinsics=intr5, dist=dist4,
            img_w=int(img_dims[0]), img_h=int(img_dims[1]),
            acc_noise=sigma_a_c or 2.0e-3,
            gyro_noise=sigma_g_c or 1.7e-4,
            acc_walk=sigma_aw_c or 3.0e-3,
            gyro_walk=sigma_gw_c or 2.0e-5,
            imu_rate=float(rate) or 200.0,
            gravity_mag=g or 9.81,
        )

    def preintegration(self) -> msgs.PreintegrationData:
        _acc = self.eigen(np.float64)
        _gyr = self.eigen(np.float64)
        _ba = self.eigen(np.float64)
        _bg = self.eigen(np.float64)
        dt = self.vec_f64()
        ax, ay, az = self.vec_f64(), self.vec_f64(), self.vec_f64()
        gx, gy, gz = self.vec_f64(), self.vec_f64(), self.vec_f64()
        return msgs.PreintegrationData(
            acc=np.stack([ax, ay, az], axis=1) if len(ax)
            else np.zeros((0, 3)),
            gyro=np.stack([gx, gy, gz], axis=1) if len(gx)
            else np.zeros((0, 3)),
            dts=dt,
        )


def decode_keyframe(payload: bytes, is_update: bool):
    """cereal MsgKeyframe -> our message (msg_keyframe.hpp:168-203 load)."""
    r = Reader(payload)
    if is_update:
        _ts = r.f64()
        kid = r.idpair()
        T_sref_s = r.eigen(np.float64)
        id_ref = r.idpair()
        r.boolean()  # is_update_msg
        vel = r.eigen(np.float64).reshape(-1)
        ba = r.eigen(np.float64).reshape(-1)
        bg = r.eigen(np.float64).reshape(-1)
        return msgs.MsgKeyframeUpdate(
            id=kid, id_reference=id_ref, T_sref_s=_pose_from_44(T_sref_s),
            velocity=vel, bias_gyro=bg, bias_acc=ba,
        )
    ts = r.f64()
    kid = r.idpair()
    calib = r.vicalibration()
    for _ in range(4):
        r.i32()  # img_dim_{x,y}_{min,max}
    kp_dist = r.vec_eigen(np.float32)
    kp_undist = r.vec_eigen(np.float32)
    aors = r.vec_eigen(np.float32)
    desc = r.cv_mat()
    kp_dist_add = r.vec_eigen(np.float32)
    _kp_undist_add = r.vec_eigen(np.float32)
    aors_add = r.vec_eigen(np.float32)
    desc_add = r.cv_mat()
    _T_s_c = r.eigen(np.float64)
    T_sref_s = r.eigen(np.float64)
    vel = r.eigen(np.float64).reshape(-1)
    bg = r.eigen(np.float64).reshape(-1)
    ba = r.eigen(np.float64).reshape(-1)
    _lin_acc = r.eigen(np.float64)
    _ang_vel = r.eigen(np.float64)
    _lin_acc_init = r.eigen(np.float64)
    _ang_vel_init = r.eigen(np.float64)
    pre = r.preintegration()
    n_lm = r.u64()  # landmarks: std::map<int, idpair>
    lm_ids = np.full(max(len(kp_dist), 1), -1, np.int64)
    if len(kp_dist):
        lm_ids = np.full(len(kp_dist), -1, np.int64)
    for _ in range(n_lm):
        feat = r.i32()
        lm = r.idpair()
        if 0 <= feat < len(lm_ids):
            lm_ids[feat] = lm[0]
    id_pred = r.idpair()
    id_succ = r.idpair()
    id_ref = r.idpair()
    r.boolean()  # is_update_msg
    _img = r.cv_mat()

    def norm_pair(p):
        # defpair = (max_u64, max_u64) -> our (-1, -1)
        return tuple(-1 if x >= (1 << 63) else int(x) for x in p)

    F = len(kp_dist)
    return msgs.MsgKeyframe(
        id=norm_pair(kid), timestamp=ts, calibration=calib,
        keypoints=kp_dist.reshape(F, 2) if F else np.zeros((0, 2), np.float32),
        keypoints_undist=kp_undist.reshape(F, 2) if F
        else np.zeros((0, 2), np.float32),
        keypoints_aors=aors.reshape(F, 4) if F
        else np.zeros((0, 4), np.float32),
        descriptors=desc.astype(np.uint8) if desc.size
        else np.zeros((F, 32), np.uint8),
        keypoints_add=(kp_dist_add if kp_dist_add.size else None),
        keypoints_aors_add=(aors_add if aors_add.size else None),
        descriptors_add=(desc_add.astype(np.uint8)
                         if desc_add.size else None),
        id_reference=norm_pair(id_ref),
        T_sref_s=_pose_from_44(T_sref_s),
        velocity=vel, bias_gyro=bg, bias_acc=ba,
        preintegration=pre if len(pre.dts) else None,
        landmark_ids=lm_ids[:F] if F else None,
        id_predecessor=norm_pair(id_pred),
        id_successor=norm_pair(id_succ),
    )


def decode_landmark(payload: bytes, is_update: bool):
    """cereal MsgLandmark -> our message (msg_landmark.hpp:87-104 load)."""
    r = Reader(payload)
    lid = r.idpair()
    pos_ref = r.eigen(np.float64).reshape(-1)
    if is_update:
        id_ref = r.idpair()
        r.boolean()
        return msgs.MsgLandmarkUpdate(
            id=lid, id_reference=id_ref, pos_ref=pos_ref)
    n_obs = r.u64()  # observations: std::map<idpair, int>
    obs = {}
    for _ in range(n_obs):
        kf = r.idpair()
        feat = r.i32()
        obs[(int(kf[0]), int(kf[1]))] = int(feat)
    id_ref = r.idpair()
    r.boolean()
    return msgs.MsgLandmark(
        id=(int(lid[0]), int(lid[1])), id_reference=(int(id_ref[0]),
                                                     int(id_ref[1])),
        pos_ref=pos_ref, observations=obs,
    )


def decode_container(header: bytes, payload: bytes) -> list:
    """One framed transmission -> list of decoded messages."""
    entries = struct.unpack(f">{CONTAINER_ENTRIES * 5}I", header)
    out = []
    off = 0
    for i in range(CONTAINER_ENTRIES):
        size, is_update, _id0, _id1, kind = entries[i * 5:i * 5 + 5]
        if size == 0:
            break
        chunk = payload[off:off + size]
        off += size
        if kind == 0:
            out.append(decode_keyframe(chunk, bool(is_update)))
        elif kind == 1:
            out.append(decode_landmark(chunk, bool(is_update)))
        else:
            raise ValueError(f"unknown msg kind {kind}")
    return out


def header_total(header: bytes) -> int:
    entries = struct.unpack(f">{CONTAINER_ENTRIES * 5}I", header)
    return sum(entries[i * 5] for i in range(CONTAINER_ENTRIES))


def id_assignment(client_id: int) -> bytes:
    """The server->agent id handshake container
    (`communicator_base.cpp:288-292`)."""
    vals = [0] * (CONTAINER_ENTRIES * 5)
    vals[0] = 1
    vals[1] = client_id
    return struct.pack(f">{CONTAINER_ENTRIES * 5}I", *vals)


# --------------------------------------------------------------------------
# Encoder (mirror image; for tests and stream recording)
# --------------------------------------------------------------------------

class Writer:
    def __init__(self):
        self.parts: List[bytes] = []

    def f64(self, v):
        self.parts.append(struct.pack("<d", float(v)))

    def i32(self, v):
        self.parts.append(struct.pack("<i", int(v)))

    def u64(self, v):
        self.parts.append(struct.pack("<Q", int(v) & (2 ** 64 - 1)))

    def boolean(self, v):
        self.parts.append(b"\x01" if v else b"\x00")

    def idpair(self, p):
        a, b = p
        self.u64(2 ** 64 - 1 if a < 0 else a)
        self.u64(2 ** 64 - 1 if b < 0 else b)

    def eigen(self, a, dtype=np.float64):
        a = np.atleast_2d(np.asarray(a, dtype))
        if a.shape[0] == 1 and a.shape[1] > 1:
            a = a.T  # column vectors, like Eigen::Matrix<.., N, 1>
        self.i32(a.shape[0])
        self.i32(a.shape[1])
        self.parts.append(np.asfortranarray(a).tobytes(order="F"))

    def vec_f64(self, v):
        v = np.asarray(v, np.float64)
        self.u64(len(v))
        self.parts.append(v.tobytes())

    def vec_eigen(self, rows, dtype=np.float32):
        rows = np.asarray(rows, dtype)
        self.u64(len(rows))
        for r in rows:
            self.eigen(r.reshape(-1, 1), dtype)

    def cv_mat(self, a, cv_type=0):
        a = np.asarray(a)
        self.i32(a.shape[0] if a.ndim else 0)
        self.i32(a.shape[1] if a.ndim > 1 else 0)
        self.i32(cv_type)
        self.boolean(True)
        self.parts.append(np.ascontiguousarray(a).tobytes())

    def data(self) -> bytes:
        return b"".join(self.parts)


def encode_keyframe(m: msgs.MsgKeyframe) -> bytes:
    w = Writer()
    w.f64(m.timestamp)
    w.idpair(m.id)
    c = m.calibration or msgs.VICalibration(
        T_s_c=np.asarray([1.0, 0, 0, 0, 0, 0, 0]), cam_model=0,
        dist_model=1, intrinsics=np.zeros(5), dist=np.zeros(4),
        img_w=752, img_h=480)
    w.eigen(_pose_to_44(c.T_s_c))
    w.i32(c.cam_model)
    w.i32(_DIST_TO_REF.get(c.dist_model, 0))
    w.eigen(np.asarray([[c.img_w], [c.img_h]], np.float64))
    w.eigen(np.asarray(c.dist, np.float64).reshape(-1, 1))
    w.eigen(np.asarray(c.intrinsics[:4], np.float64).reshape(-1, 1))
    fx, fy, cx, cy = np.asarray(c.intrinsics[:4], np.float64)
    w.eigen(np.asarray([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]]))
    for v in (0.0, 0.0, c.acc_noise, c.gyro_noise, 0.0, 0.0,
              c.acc_walk, c.gyro_walk, 0.0, c.gravity_mag):
        w.f64(v)
    w.eigen(np.zeros((3, 1)))
    w.i32(int(c.imu_rate))
    w.f64(0.0)
    w.f64(0.0)
    for v in (0, 0, c.img_w, c.img_h):
        w.i32(v)
    F = len(m.keypoints)
    w.vec_eigen(np.asarray(m.keypoints, np.float32))
    w.vec_eigen(np.asarray(m.keypoints_undist, np.float32))
    w.vec_eigen(np.asarray(m.keypoints_aors, np.float32))
    w.cv_mat(np.asarray(m.descriptors, np.uint8), cv_type=0)
    ka = m.keypoints_add if m.keypoints_add is not None else \
        np.zeros((0, 2), np.float32)
    aa = m.keypoints_aors_add if m.keypoints_aors_add is not None else \
        np.zeros((0, 4), np.float32)
    da = m.descriptors_add if m.descriptors_add is not None else \
        np.zeros((0, 32), np.uint8)
    w.vec_eigen(np.asarray(ka, np.float32))
    w.vec_eigen(np.asarray(ka, np.float32))  # undistorted_add
    w.vec_eigen(np.asarray(aa, np.float32))
    w.cv_mat(np.asarray(da, np.uint8), cv_type=0)
    w.eigen(_pose_to_44(c.T_s_c))
    w.eigen(_pose_to_44(m.T_sref_s if m.T_sref_s is not None
                        else np.asarray([1.0, 0, 0, 0, 0, 0, 0])))
    for v3 in (m.velocity, m.bias_gyro, m.bias_acc):
        w.eigen(np.asarray(v3 if v3 is not None else np.zeros(3))
                .reshape(-1, 1))
    for _ in range(4):  # lin_acc, ang_vel, lin_acc_init, ang_vel_init
        w.eigen(np.zeros((3, 1)))
    pre = m.preintegration
    if pre is None:
        pre = msgs.PreintegrationData(acc=np.zeros((0, 3)),
                                      gyro=np.zeros((0, 3)),
                                      dts=np.zeros(0))
    for _ in range(4):  # acc, gyr, lin_bias_accel, lin_bias_gyro
        w.eigen(np.zeros((3, 1)))
    w.vec_f64(pre.dts)
    for col in range(3):
        w.vec_f64(np.asarray(pre.acc)[:, col] if len(pre.dts) else [])
    for col in range(3):
        w.vec_f64(np.asarray(pre.gyro)[:, col] if len(pre.dts) else [])
    lm = m.landmark_ids
    pairs = ([(int(i), (int(lm[i]), m.id[1])) for i in range(len(lm))
              if lm[i] >= 0] if lm is not None else [])
    w.u64(len(pairs))
    for feat, lid in pairs:
        w.i32(feat)
        w.idpair(lid)
    w.idpair(m.id_predecessor)
    w.idpair(m.id_successor)
    w.idpair(m.id_reference)
    w.boolean(False)
    w.cv_mat(np.zeros((0, 0), np.uint8), cv_type=0)
    return w.data()


def encode_landmark(m: msgs.MsgLandmark) -> bytes:
    w = Writer()
    w.idpair(m.id)
    w.eigen(np.asarray(m.pos_ref, np.float64).reshape(-1, 1))
    w.u64(len(m.observations))
    for kf, feat in sorted(m.observations.items()):
        w.idpair(kf)
        w.i32(feat)
    w.idpair(m.id_reference)
    w.boolean(False)
    return w.data()


def encode_container(messages: list) -> bytes:
    """Pack up to 10 messages into one reference-framed transmission."""
    assert len(messages) <= CONTAINER_ENTRIES
    vals = [0] * (CONTAINER_ENTRIES * 5)
    payloads = []
    for i, m in enumerate(messages):
        if isinstance(m, msgs.MsgKeyframe):
            data, kind, upd = encode_keyframe(m), 0, 0
        elif isinstance(m, msgs.MsgLandmark):
            data, kind, upd = encode_landmark(m), 1, 0
        else:
            raise TypeError(f"cannot encode {type(m)}")
        payloads.append(data)
        vals[i * 5:i * 5 + 5] = [len(data), upd, m.id[0], m.id[1], kind]
    return (struct.pack(f">{CONTAINER_ENTRIES * 5}I", *vals)
            + b"".join(payloads))


def record_stream(messages: list, path: str, batch: int = 10) -> int:
    """Write a reference-protocol byte stream (containers back-to-back)."""
    n = 0
    with open(path, "wb") as f:
        for i in range(0, len(messages), batch):
            f.write(encode_container(messages[i:i + batch]))
            n += 1
    return n


def iter_stream(path: str) -> Iterator[object]:
    """Decode a recorded reference-protocol stream."""
    with open(path, "rb") as f:
        data = f.read()
    off = 0
    while off < len(data):
        header = data[off:off + HEADER_BYTES]
        if len(header) < HEADER_BYTES:
            break
        total = header_total(header)
        payload = data[off + HEADER_BYTES: off + HEADER_BYTES + total]
        off += HEADER_BYTES + total
        yield from decode_container(header, payload)
