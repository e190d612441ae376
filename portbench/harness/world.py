"""The traffic's world and agents, made from seeds in numpy.

A frozen copy of the program's synthetic world and agent
(`covins_tpu_torch/agents/synthetic_agent.py`, `utils/synthetic.py`): the
same figure-8 trajectory and orientation sweep, the same camera, the same
message schema and track-loss semantics, with its draws vectorised and
split into one random stream per agent and purpose, so a stream's first
keyframes do not depend on how many are built.  The trajectory's shape is
fixed.  The world's seed sets the landmarks and their descriptors; the
agents' seed sets the pixel and descriptor noise and the odometry drift,
so runs of many seeds can share one scene.  The IMU samples are the
analytic derivatives of the trajectory (the program's generator takes
them by automatic differentiation).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from portbench.harness import geo

GRAVITY = 9.81
IMU_RATE = 200.0
# camera optical axis along body +x: R_s_c = [[0,0,1],[-1,0,0],[0,-1,0]]
FORWARD_T_S_C = np.asarray([0.5, -0.5, 0.5, -0.5, 0.0, 0.0, 0.0])
TRACK_GAP = 3  # keyframes unseen after which a revisit mints a new landmark id


def _seq(seed: int, *tags: int) -> np.random.Generator:
    """An independent generator for (seed, tags); any whole seed."""
    return np.random.default_rng([int(seed) & 0xFFFFFFFFFFFFFFFF, *tags])


@dataclasses.dataclass
class World:
    landmarks: np.ndarray  # (M, 3)
    signatures: np.ndarray  # (M, 32) uint8
    camera: dict  # intrinsics, dist, T_s_c, img_w, img_h

    @classmethod
    def create(cls, seed: int, n_landmarks: int, desc_bytes: int, camera: dict):
        rng = _seq(seed, 0)
        pts = rng.uniform(-1.0, 1.0, (n_landmarks, 3))
        lms = pts * np.asarray([12.0, 12.0, 4.8]) + np.asarray([0.0, 0.0, 2.0])
        sig = rng.integers(0, 256, (n_landmarks, desc_bytes), dtype=np.uint8)
        return cls(lms, sig, camera)


def _orientation(t):
    w = 2.0 * math.pi * 0.25
    yaw = 0.6 * np.sin(0.5 * w * t)
    pitch = 0.15 * np.sin(0.9 * w * t + 0.3)
    roll = 0.1 * np.sin(1.3 * w * t + 1.1)
    dyaw = 0.3 * w * np.cos(0.5 * w * t)
    dpitch = 0.135 * w * np.cos(0.9 * w * t + 0.3)
    droll = 0.13 * w * np.cos(1.3 * w * t + 1.1)
    z = np.zeros_like(t)
    q = geo.quat_multiply(geo.quat_multiply(geo.quat_exp(np.stack([z, z, yaw], -1)),
                                            geo.quat_exp(np.stack([z, pitch, z], -1))),
                          geo.quat_exp(np.stack([roll, z, z], -1)))
    # body angular velocity of R = Rz(yaw) Ry(pitch) Rx(roll)
    gyro = np.stack([droll - dyaw * np.sin(pitch),
                     dpitch * np.cos(roll) + dyaw * np.cos(pitch) * np.sin(roll),
                     -dpitch * np.sin(roll) + dyaw * np.cos(pitch) * np.cos(roll)], -1)
    return geo.quat_normalize(q), gyro


def _position(t, radius=5.0, climb=0.15, freq=0.25):
    w = 2.0 * math.pi * freq
    p = np.stack([radius * np.sin(w * t), radius * 0.6 * np.sin(2 * w * t),
                  climb * t + 0.4 * np.sin(0.7 * w * t)], -1)
    v = np.stack([radius * w * np.cos(w * t), 1.2 * radius * w * np.cos(2 * w * t),
                  climb + 0.28 * w * np.cos(0.7 * w * t)], -1)
    a = np.stack([-radius * w * w * np.sin(w * t), -2.4 * radius * w * w * np.sin(2 * w * t),
                  -0.196 * w * w * np.sin(0.7 * w * t)], -1)
    return p, v, a


def trajectory(n_kf: int, kf_dt: float, t0: float):
    """Keyframe times, ground-truth poses T_w_s, velocities, and the exact
    IMU samples at the midpoints of each keyframe interval."""
    times = t0 + np.arange(n_kf) * kf_dt
    q, _ = _orientation(times)
    p, v, _ = _position(times)
    s = int(round(kf_dt * IMU_RATE))
    dt_s = kf_dt / s
    seg_t = (times[:-1, None] + (np.arange(s) + 0.5)[None, :] * dt_s).reshape(-1)
    qs, gyro = _orientation(seg_t)
    _, _, acc_w = _position(seg_t)
    g_w = np.asarray([0.0, 0.0, -GRAVITY])
    acc = geo.quat_rotate(qs * np.asarray([1.0, -1.0, -1.0, -1.0]), acc_w - g_w)
    shape = (max(n_kf - 1, 0), s)
    return (times, np.concatenate([q, p], -1), v, acc.reshape(shape + (3,)),
            gyro.reshape(shape + (3,)), np.full(shape, dt_s))


class Agent:
    """One agent's keyframe bundles along its time-shifted trajectory."""

    def __init__(self, world: World, client_id: int, n_kf: int, t0: float, seed: int,
                 kf_dt: float, px_noise: float, desc_bit_flips: int, pose_drift: float,
                 max_features: int):
        self.world, self.cid, self.n_kf = world, client_id, n_kf
        self.px_noise, self.flips = px_noise, desc_bit_flips
        self.max_features = max_features
        (self.times, self.poses, self.vels, self.acc, self.gyro,
         self.dts) = trajectory(n_kf, kf_dt, t0)
        self.rng_obs = _seq(seed, 1, client_id)
        rng_vio = _seq(seed, 2, client_id)
        rel = geo.pose_relative(self.poses[:-1], self.poses[1:])
        vio = [self.poses[0]]
        for k in range(n_kf - 1):
            noise = rng_vio.normal(0.0, pose_drift, 6)
            noise[:3] *= 0.2  # less rotational drift
            vio.append(geo.pose_compose(vio[-1], geo.pose_compose(rel[k], geo.se3_exp(noise))))
        self.vio = np.stack(vio)
        cam = world.camera
        self.intr = np.asarray(cam["intrinsics"], np.float64)
        self.dist = np.asarray(cam["dist"], np.float64)
        self.T_s_c = np.asarray(cam["T_s_c"], np.float64)
        self._client_id_of: dict = {}
        self._last_seen: dict = {}
        self._next_id = 0

    def visible(self, k: int):
        T_w_c = geo.pose_compose(self.poses[k], self.T_s_c)
        p_c = geo.pose_apply(geo.pose_inverse(T_w_c)[None], self.world.landmarks)
        uv, valid = geo.project_radtan(self.intr, self.dist, p_c)
        w, h = self.world.camera["img_w"], self.world.camera["img_h"]
        ok = (valid & (p_c[:, 2] > 0.3) & (p_c[:, 2] < 25.0) & (uv[:, 0] > 0)
              & (uv[:, 0] < w) & (uv[:, 1] > 0) & (uv[:, 1] < h))
        idx = np.where(ok)[0][: self.max_features]
        return idx, uv[idx]

    def bundle(self, k: int, msgs) -> list:
        """Keyframe k's message and the landmark messages that follow it."""
        idx, uv = self.visible(k)
        n = len(idx)
        uv = uv + self.rng_obs.normal(0.0, self.px_noise, uv.shape)
        descs = self.world.signatures[idx].copy()
        if n:
            bits = self.rng_obs.integers(0, descs.shape[1] * 8, (n, self.flips))
            rows = np.repeat(np.arange(n), self.flips)
            np.bitwise_xor.at(descs, (rows, bits.reshape(-1) // 8),
                              (1 << (bits.reshape(-1) % 8)).astype(np.uint8))
        lm_ids = np.empty(n, np.int64)
        minted = []
        for j, wi in enumerate(idx.tolist()):
            if k - self._last_seen.get(wi, -(10**9)) > TRACK_GAP:
                self._client_id_of[wi] = self._next_id
                self._next_id += 1
                minted.append((j, wi))
            self._last_seen[wi] = k
            lm_ids[j] = self._client_id_of[wi]
        cid = self.cid
        if k == 0:
            T_ref, id_ref, pre = geo.pose_identity(), (-1, -1), None
        else:
            T_ref, id_ref = geo.pose_relative(self.vio[k - 1], self.vio[k]), (k - 1, cid)
            pre = msgs.PreintegrationData(acc=self.acc[k - 1], gyro=self.gyro[k - 1],
                                          dts=self.dts[k - 1])
        cam = self.world.camera
        calib = msgs.VICalibration(
            T_s_c=self.T_s_c.copy(), cam_model=0, dist_model=1, intrinsics=self.intr.copy(),
            dist=self.dist.copy(), img_w=cam["img_w"], img_h=cam["img_h"]) if k == 0 else None
        out = [msgs.MsgKeyframe(
            id=(k, cid), timestamp=float(self.times[k]), calibration=calib,
            keypoints=uv.astype(np.float32), keypoints_undist=uv.astype(np.float32),
            keypoints_aors=np.zeros((n, 4), np.float32), descriptors=descs,
            id_reference=id_ref, T_sref_s=T_ref, T_w_s_vio=self.vio[k],
            velocity=self.vels[k].copy(), bias_gyro=np.zeros(3), bias_acc=np.zeros(3),
            preintegration=pre, landmark_ids=lm_ids,
            id_predecessor=(k - 1, cid) if k > 0 else (-1, -1), id_successor=(-1, -1))]
        if minted:
            # the ground-truth body-relative position: the server's world
            # placement inherits the anchor keyframe's drift
            pos_ref = geo.pose_apply(geo.pose_inverse(self.poses[k])[None],
                                     self.world.landmarks[[wi for _, wi in minted]])
            out += [msgs.MsgLandmark(id=(int(lm_ids[j]), cid), id_reference=(k, cid),
                                     pos_ref=p, observations={(k, cid): int(j)})
                    for (j, _), p in zip(minted, pos_ref)]
        return out


def build_streams(world: World, agents: list, seed: int, traffic: dict, msgs):
    """Each agent's keyframe bundles, its whole stream, in order."""
    streams = []
    for cid, a in enumerate(agents):
        n = int(a["keyframes"])
        ag = Agent(world, cid, n, float(a["t0"]), seed, traffic["kf_dt"],
                   traffic["px_noise"], traffic["desc_bit_flips"], traffic["pose_drift"],
                   traffic["max_features"])
        streams.append([ag.bundle(k, msgs) for k in range(n)])
    return streams
