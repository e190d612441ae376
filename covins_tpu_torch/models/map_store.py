"""Structure-of-arrays map store: the server's central data structure.

Counterpart of `covins_tpu/models/map_store.py`: one `Map` per agent
(merged maps span agents) holds keyframes, landmarks and the observation
graph as flat capacity-doubling numpy arrays.  A keyframe/landmark IS a
row index; erasure is a mask flip.  Host numpy owns the bookkeeping, as in
the JAX package: ingest, culling, covisibility, landmark fusion, merging,
loop constraints and the pose-graph snapshot and write-back.  The batched
landmark-attribute refresh runs on the device in one launch
(`ops/landmark_ops.py`, kernel K2); the pose graph is handed to `ops/pgo.py` on the map's device.

The GBA snapshot (:meth:`Map.to_gba_problem`) re-propagates each stored
IMU window on the map's device (kernel K10) and hands the problem to
`ops/gba.py`.  Keyframe culling (`erase_keyframe`,
`remove_redundant_keyframes`) belongs to a later part of the port and is
not here yet.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from covins_tpu_torch.comm import messages as msgs
from covins_tpu_torch.device import DeviceLike, resolve_device
from covins_tpu_torch.ops import gba as gba_mod
from covins_tpu_torch.ops import imu as imu_mod
from covins_tpu_torch.ops import landmark_ops
from covins_tpu_torch.ops import pgo as pgo_mod
from covins_tpu_torch.ops import residuals as res_mod
from covins_tpu_torch.utils import cameras as cam_mod
from covins_tpu_torch.utils import npgeo

IdPair = Tuple[int, int]


def _grow(arr: np.ndarray, new_cap: int) -> np.ndarray:
    out = np.zeros((new_cap,) + arr.shape[1:], arr.dtype)
    out[: arr.shape[0]] = arr
    return out


class Map:
    """One collaborative map (single agent initially; grows by merging)."""

    def __init__(
        self,
        map_id: int,
        max_features: int = 1024,
        desc_bytes: int = 32,
        desc_dtype=np.uint8,
        kf_capacity: int = 256,
        lm_capacity: int = 4096,
        obs_capacity: int = 16384,
        device: DeviceLike = None,
    ):
        self.id = map_id
        # device of the batched landmark-attribute refresh
        self.device = resolve_device(device)
        self.associated_clients: set[int] = set()
        # lazily-dispatched landmark-attribute cohorts (see
        # update_landmark_attributes(lazy=True) / commit_landmark_attributes)
        self._pending_lm_attrs: list = []
        self.max_features = max_features
        self.desc_bytes = desc_bytes  # descriptor width (bytes for ORB, dims for SIFT)
        self.desc_dtype = np.dtype(desc_dtype)

        # --- keyframe SoA ---------------------------------------------------
        k = kf_capacity
        f = max_features
        self.n_kf = 0
        self.kf_ids = np.full((k, 2), -1, np.int64)  # (kf_id, client_id)
        self.kf_stamp = np.zeros(k, np.float64)
        self.kf_pose = np.zeros((k, 7), np.float64)  # T_w_s
        self.kf_pose_vio = np.zeros((k, 7), np.float64)
        self.kf_vel = np.zeros((k, 3), np.float64)
        self.kf_bias = np.zeros((k, 6), np.float64)  # [bg, ba]
        self.kf_pred = np.full(k, -1, np.int32)
        self.kf_succ = np.full(k, -1, np.int32)
        self.kf_mask = np.zeros(k, bool)
        self.kf_is_loop = np.zeros(k, bool)
        self.kf_pose_optimized = np.zeros(k, bool)
        self.kf_in_gba = np.zeros(k, bool)  # for opt.pgo_fix_kfs_after_gba
        self.kf_n_feat = np.zeros(k, np.int32)
        self.kp_uv = np.zeros((k, f, 2), np.float32)
        self.kp_undist = np.zeros((k, f, 2), np.float32)
        self.kp_aors = np.zeros((k, f, 4), np.float32)
        self.descriptors = np.zeros((k, f, desc_bytes), desc_dtype)
        self.kf_feat_lm = np.full((k, f), -1, np.int32)  # feature -> lm row
        # IMU raw samples (padded per KF window) for re-propagation
        self.imu_max_samples = 256
        self.imu_acc = np.zeros((k, self.imu_max_samples, 3), np.float64)
        self.imu_gyro = np.zeros((k, self.imu_max_samples, 3), np.float64)
        self.imu_dts = np.zeros((k, self.imu_max_samples), np.float64)
        self.imu_n = np.zeros(k, np.int32)
        self.calib: Dict[int, msgs.VICalibration] = {}  # per client

        # additional feature set (`msg_keyframe.hpp` `_add` fields): the
        # pose-estimation features of COVINS-G, distinct from the PR /
        # landmark-tied primary set (`placerec_gen_be.cpp:99` matches on
        # `descriptors_add_`; `keyframe_be.cpp:42-226` falls back to the
        # primary set when absent).  Allocated lazily on the first message
        # that carries them — their width/dtype may differ from the primary.
        self.kf_n_feat_add = np.zeros(k, np.int32)
        self.kp_undist_add: Optional[np.ndarray] = None
        self.kp_aors_add: Optional[np.ndarray] = None
        self.descriptors_add: Optional[np.ndarray] = None

        # --- landmark SoA ---------------------------------------------------
        m = lm_capacity
        self.n_lm = 0
        self.lm_ids = np.full((m, 2), -1, np.int64)  # (lm_id, client_id)
        self.lm_pos = np.zeros((m, 3), np.float64)  # world frame
        self.lm_ref = np.full(m, -1, np.int32)  # reference KF row
        self.lm_mask = np.zeros(m, bool)
        self.lm_desc = np.zeros((m, desc_bytes), desc_dtype)
        self.lm_normal = np.zeros((m, 3), np.float64)
        self.lm_first_kf = np.full(m, -1, np.int32)
        self.lm_optimized = np.zeros(m, bool)  # Landmark::IsOptimized gate
        # scale-invariance distance range [min, max] per landmark
        # (`landmark_base.cpp:68-133`); (0, 0) = unknown, no gating
        self.lm_dist_rng = np.zeros((m, 2), np.float64)

        # --- observation COO -------------------------------------------------
        o = obs_capacity
        self.n_obs = 0
        self.obs_kf = np.zeros(o, np.int32)
        self.obs_lm = np.zeros(o, np.int32)
        self.obs_feat = np.zeros(o, np.int32)
        self.obs_mask = np.zeros(o, bool)

        # --- loop constraints -------------------------------------------------
        self.loops: list[dict] = []  # {kf1, kf2, T_12, cov}

        # periodic trajectory write-out: every `traj_interval` keyframes
        # the map rewrites its trajectory CSVs (`Map::AddKeyframe`,
        # `map_be.cpp:391-395`); enabled when the server sets `traj_dir`
        self.traj_dir: Optional[str] = None
        self.traj_fmt: str = "TUM"
        self.traj_interval: int = 50

        # id lookup
        self._kf_index: Dict[IdPair, int] = {}
        self._lm_index: Dict[IdPair, int] = {}

    # ------------------------------------------------------------------ util
    def kf_row(self, idpair: IdPair) -> int:
        return self._kf_index.get(tuple(idpair), -1)

    def pr_descriptors(self, row: int) -> np.ndarray:
        """Place-recognition descriptor set (the primary set; landmark-tied
        in COVINS mode).  Sliced by the caller with `kf_n_feat[row]`."""
        return self.descriptors[row]

    def match_features(self, row: int):
        """Pose-estimation feature set for image matching (COVINS-G): the
        `_add` set when the agent sent one, else the primary set (the
        fallback of `keyframe_be.cpp:42-226`).  Returns (keypoints,
        descriptors, n).  The primary set's keypoints are distorted pixels;
        the `_add` set returns its stored `kp_undist_add`, as the
        reference does."""
        na = int(self.kf_n_feat_add[row])
        if na > 0 and self.descriptors_add is not None:
            return self.kp_undist_add[row], self.descriptors_add[row], na
        return self.kp_uv[row], self.descriptors[row], int(self.kf_n_feat[row])

    def lm_row(self, idpair: IdPair) -> int:
        return self._lm_index.get(tuple(idpair), -1)

    def _ensure_kf(self, n):
        cap = self.kf_ids.shape[0]
        if n <= cap:
            return
        new = max(2 * cap, n)
        for name in (
            "kf_ids", "kf_stamp", "kf_pose", "kf_pose_vio", "kf_vel",
            "kf_bias", "kf_pred", "kf_succ", "kf_mask", "kf_is_loop",
            "kf_pose_optimized", "kf_in_gba", "kf_n_feat", "kp_uv", "kp_undist",
            "kp_aors", "descriptors", "kf_feat_lm", "imu_acc", "imu_gyro",
            "imu_dts", "imu_n", "kf_n_feat_add",
        ):
            setattr(self, name, _grow(getattr(self, name), new))
        for name in ("kp_undist_add", "kp_aors_add", "descriptors_add"):
            if getattr(self, name) is not None:
                setattr(self, name, _grow(getattr(self, name), new))
        self.kf_ids[self.n_kf:] = -1
        self.kf_pred[self.n_kf:] = -1
        self.kf_succ[self.n_kf:] = -1
        self.kf_feat_lm[self.n_kf:] = -1

    def _ensure_lm(self, n):
        cap = self.lm_ids.shape[0]
        if n <= cap:
            return
        new = max(2 * cap, n)
        for name in (
            "lm_ids", "lm_pos", "lm_ref", "lm_mask", "lm_desc", "lm_normal",
            "lm_first_kf", "lm_optimized", "lm_dist_rng",
        ):
            setattr(self, name, _grow(getattr(self, name), new))
        self.lm_ids[self.n_lm:] = -1
        self.lm_ref[self.n_lm:] = -1
        self.lm_first_kf[self.n_lm:] = -1

    def _ensure_obs(self, n):
        cap = self.obs_kf.shape[0]
        if n <= cap:
            return
        new = max(2 * cap, n)
        for name in ("obs_kf", "obs_lm", "obs_feat", "obs_mask"):
            setattr(self, name, _grow(getattr(self, name), new))

    # --------------------------------------------------------------- ingest
    def add_keyframe(self, msg: msgs.MsgKeyframe) -> int:
        """Construct a keyframe row from a message (`Keyframe(msg, map, voc)`
        semantics, `keyframe_be.cpp:42-226`): resolve the relative pose
        against the reference KF, store features/descriptors/IMU samples,
        wire predecessor/successor."""
        key = tuple(msg.id)
        if key in self._kf_index:
            raise ValueError(f"duplicate keyframe id {key}")
        row = self.n_kf
        self._ensure_kf(row + 1)
        kf_id, client_id = msg.id
        self.kf_ids[row] = (kf_id, client_id)
        self.kf_stamp[row] = msg.timestamp
        self.associated_clients.add(client_id)
        if msg.calibration is not None and client_id not in self.calib:
            self.calib[client_id] = msg.calibration

        nf = min(len(msg.keypoints), self.max_features)
        self.kf_n_feat[row] = nf
        self.kp_uv[row, :nf] = msg.keypoints[:nf]
        und = msg.keypoints_undist if msg.keypoints_undist is not None else msg.keypoints
        self.kp_undist[row, :nf] = und[:nf]
        if msg.keypoints_aors is not None:
            self.kp_aors[row, :nf] = msg.keypoints_aors[:nf]
        self.descriptors[row, :nf] = msg.descriptors[:nf, : self.desc_bytes]

        # additional (pose-estimation) feature set
        if msg.descriptors_add is not None:
            if self.descriptors_add is None:
                cap = self.kf_ids.shape[0]
                fa = self.max_features
                self.kp_undist_add = np.zeros((cap, fa, 2), np.float32)
                self.kp_aors_add = np.zeros((cap, fa, 4), np.float32)
                self.descriptors_add = np.zeros(
                    (cap, fa, msg.descriptors_add.shape[1]),
                    msg.descriptors_add.dtype,
                )
            na = min(len(msg.descriptors_add), self.max_features)
            self.kf_n_feat_add[row] = na
            if msg.keypoints_add is not None:
                self.kp_undist_add[row, :na] = msg.keypoints_add[:na]
            if msg.keypoints_aors_add is not None:
                self.kp_aors_add[row, :na] = msg.keypoints_aors_add[:na]
            self.descriptors_add[row, :na] = msg.descriptors_add[
                :na, : self.descriptors_add.shape[2]
            ]

        # pose: compose relative pose onto reference KF
        # (`UpdatePoseFromMsg`, `keyframe_be.cpp:610-641`)
        ref_row = self.kf_row(msg.id_reference)
        if ref_row >= 0 and msg.T_sref_s is not None:
            T_w_s = npgeo.pose_compose(self.kf_pose[ref_row], msg.T_sref_s)
        elif msg.T_w_s_vio is not None:
            T_w_s = np.asarray(msg.T_w_s_vio, np.float64)
        else:
            T_w_s = npgeo.pose_identity()
        self.kf_pose[row] = T_w_s
        self.kf_pose_vio[row] = (
            np.asarray(msg.T_w_s_vio, np.float64)
            if msg.T_w_s_vio is not None else T_w_s
        )
        if msg.velocity is not None:
            self.kf_vel[row] = msg.velocity
        if msg.bias_gyro is not None:
            self.kf_bias[row, :3] = msg.bias_gyro
        if msg.bias_acc is not None:
            self.kf_bias[row, 3:] = msg.bias_acc

        # IMU raw samples
        if msg.preintegration is not None:
            s = min(len(msg.preintegration.dts), self.imu_max_samples)
            self.imu_acc[row, :s] = msg.preintegration.acc[:s]
            self.imu_gyro[row, :s] = msg.preintegration.gyro[:s]
            self.imu_dts[row, :s] = msg.preintegration.dts[:s]
            self.imu_n[row] = s

        # predecessor/successor (`EstablishConnections`, keyframe_be.cpp:350-383)
        pred_row = self.kf_row(msg.id_predecessor)
        if pred_row < 0 and msg.id_reference != (-1, -1):
            pred_row = ref_row
        if pred_row >= 0:
            self.kf_pred[row] = pred_row
            self.kf_succ[pred_row] = row

        self.kf_mask[row] = True
        self.n_kf = row + 1
        self._kf_index[key] = row

        # periodic trajectory write + count print every `traj_interval`
        # keyframes (`map_be.cpp:391-395`)
        if self.traj_dir and len(self._kf_index) % self.traj_interval == 0:
            print(f"Map {self.id} : {len(self._kf_index)} KFs | "
                  f"{len(self._lm_index)} LMs", flush=True)
            self.write_trajectories(self.traj_dir, fmt=self.traj_fmt)

        # landmark observations carried on the KF message (vectorized:
        # the old per-feature Python loop cost ~1 ms/KF at 500 features)
        if msg.landmark_ids is not None:
            lids = np.asarray(msg.landmark_ids[:nf], np.int64)
            feats = np.where(lids >= 0)[0]
            if len(feats):
                lrows = np.asarray(
                    [self._lm_index.get((int(l), client_id), -1)
                     for l in lids[feats]], np.int64)
                sel = lrows >= 0
                if sel.any():
                    self._add_observations_bulk(
                        np.full(int(sel.sum()), row, np.int64),
                        lrows[sel], feats[sel].astype(np.int64))
        return row

    def add_landmark(self, msg: msgs.MsgLandmark) -> int:
        """Landmark row from message (`Landmark` ctor + `EstablishConnections`
        + `UpdatePosFromMsg`, `landmark_be.cpp:124-239`): position arrives in
        the reference KF body frame and is lifted to world.  A re-sent
        landmark merges its new observations and refreshes its position
        (`communicator_be.cpp:172-176`)."""
        key = tuple(msg.id)
        if key in self._lm_index:
            row = self._lm_index[key]
            for (kf_id, client_id), feat_idx in msg.observations.items():
                krow = self.kf_row((kf_id, client_id))
                if krow >= 0:
                    # add_observation dedupes and retires a conflicting
                    # binding at the slot (see its slot-consistency guard)
                    self.add_observation(krow, row, int(feat_idx))
            self.update_landmark_pos(msg)
            return row
        ref_row = self.kf_row(msg.id_reference)
        if ref_row < 0:
            raise ValueError(f"landmark {key}: unknown reference KF {msg.id_reference}")
        row = self.n_lm
        self._ensure_lm(row + 1)
        self.lm_ids[row] = tuple(msg.id)
        self.lm_ref[row] = ref_row
        self.lm_first_kf[row] = ref_row
        pos_w = npgeo.pose_apply(self.kf_pose[ref_row], np.asarray(msg.pos_ref))
        self.lm_pos[row] = pos_w
        self.lm_mask[row] = True
        self.n_lm = row + 1
        self._lm_index[key] = row
        for (kf_id, client_id), feat_idx in msg.observations.items():
            krow = self.kf_row((kf_id, client_id))
            if krow >= 0:
                self.add_observation(krow, row, int(feat_idx))
        return row

    def add_landmarks_batch(self, msgs_list) -> None:
        """Bulk landmark insertion for one drained window.

        Semantics identical to per-message :meth:`add_landmark`, but the
        position lift (reference-KF frame -> world) runs as ONE batched
        quaternion rotation and the observation COO appends as slice
        writes — the profiler showed per-landmark `pose_apply` plus
        per-observation appends costing ~35% of the real ingest path
        (155k `np.asarray` calls per 256-KF bench pass).  Re-sent
        landmarks and conflicted feature slots fall back to the exact
        per-message path.
        """
        new = []
        seen: set = set()
        resends_after = []  # intra-batch duplicates: apply post-insert
        for m in msgs_list:
            key = tuple(m.id)
            if key in self._lm_index:
                self.add_landmark(m)  # resend: merge + refresh, exact path
            elif key in seen:
                resends_after.append(m)
            else:
                seen.add(key)
                new.append(m)
        if not new:
            for m in resends_after:
                self.add_landmark(m)
            return
        n0, n = self.n_lm, len(new)
        ref_rows = np.empty(n, np.int64)
        for i, m in enumerate(new):
            r = self.kf_row(m.id_reference)
            if r < 0:
                raise ValueError(
                    f"landmark {tuple(m.id)}: unknown reference KF "
                    f"{m.id_reference}")
            ref_rows[i] = r
        self._ensure_lm(n0 + n)
        pos_ref = np.stack([np.asarray(m.pos_ref, np.float64) for m in new])
        self.lm_ids[n0:n0 + n] = np.asarray([m.id for m in new], np.int64)
        self.lm_ref[n0:n0 + n] = ref_rows
        self.lm_first_kf[n0:n0 + n] = ref_rows
        self.lm_pos[n0:n0 + n] = npgeo.pose_apply(
            self.kf_pose[ref_rows], pos_ref)
        self.lm_mask[n0:n0 + n] = True
        self.n_lm = n0 + n
        self._lm_index.update(
            {tuple(m.id): n0 + i for i, m in enumerate(new)})

        obs_k, obs_l, obs_f = [], [], []
        for i, m in enumerate(new):
            for (kf_id, client_id), feat_idx in m.observations.items():
                kr = self.kf_row((kf_id, client_id))
                if kr >= 0:
                    obs_k.append(kr)
                    obs_l.append(n0 + i)
                    obs_f.append(int(feat_idx))
        if not obs_k:
            for m in resends_after:
                self.add_landmark(m)
            return
        self._add_observations_bulk(
            np.asarray(obs_k, np.int64), np.asarray(obs_l, np.int64),
            np.asarray(obs_f, np.int64))
        for m in resends_after:
            self.add_landmark(m)

    def _add_observations_bulk(self, ok, ol, of) -> None:
        """Append many (kf_row, lm_row, feat) observations at once.

        Fast path: feature slots that are unbound AND unique within the
        batch append as slice writes; everything else routes through
        :meth:`add_observation`'s conflict guard for identical semantics.
        """
        slot = ok * np.int64(self.kf_feat_lm.shape[1]) + of
        _, first, counts = np.unique(slot, return_index=True,
                                     return_counts=True)
        unique_in_batch = np.zeros(len(ok), bool)
        unique_in_batch[first[counts == 1]] = True
        clean = unique_in_batch & (self.kf_feat_lm[ok, of] < 0)
        nm = int(clean.sum())
        if nm:
            i0 = self.n_obs
            self._ensure_obs(i0 + nm)
            self.obs_kf[i0:i0 + nm] = ok[clean]
            self.obs_lm[i0:i0 + nm] = ol[clean]
            self.obs_feat[i0:i0 + nm] = of[clean]
            self.obs_mask[i0:i0 + nm] = True
            self.n_obs = i0 + nm
            self.kf_feat_lm[ok[clean], of[clean]] = ol[clean]
        for j in np.where(~clean)[0]:
            self.add_observation(int(ok[j]), int(ol[j]), int(of[j]))

    def update_landmark_pos(self, msg) -> bool:
        """`Landmark::UpdatePosFromMsg` (`landmark_be.cpp:222-238`):
        re-anchor to the message's reference KF and recompute the world
        position — unless the landmark was already optimized server-side."""
        row = self.lm_row(tuple(msg.id))
        if row < 0 or self.lm_optimized[row]:
            return False
        ref_row = self.kf_row(msg.id_reference)
        if ref_row < 0:
            return False
        self.lm_ref[row] = ref_row
        self.lm_pos[row] = npgeo.pose_apply(
            self.kf_pose[ref_row], np.asarray(msg.pos_ref)
        )
        return True

    def add_observation(self, kf_row: int, lm_row: int, feat_idx: int):
        old = self.kf_feat_lm[kf_row, feat_idx]
        if old == lm_row:
            return  # slot already bound to this landmark
        if old >= 0:
            # the (kf, feat) slot is owned by a DIFFERENT live landmark:
            # mask its COO observation so covisibility never double-counts
            # the slot and a later erase of the old landmark cannot clobber
            # the new binding
            o = self.n_obs
            sel = (
                (self.obs_kf[:o] == kf_row)
                & (self.obs_feat[:o] == feat_idx)
                & self.obs_mask[:o]
            )
            self.obs_mask[:o][sel] = False
        i = self.n_obs
        self._ensure_obs(i + 1)
        self.obs_kf[i] = kf_row
        self.obs_lm[i] = lm_row
        self.obs_feat[i] = feat_idx
        self.obs_mask[i] = True
        self.kf_feat_lm[kf_row, feat_idx] = lm_row
        self.n_obs = i + 1

    def update_keyframe_pose(self, msg: msgs.MsgKeyframeUpdate):
        """Pose update vs the origin KF (`UpdatePoseFromMsg` update path,
        `keyframe_be.cpp:610-641`: skip if already optimized server-side)."""
        row = self.kf_row(msg.id)
        if row < 0:
            return
        if self.kf_pose_optimized[row]:
            return
        ref_row = self.kf_row(msg.id_reference)
        if ref_row < 0:
            return
        self.kf_pose[row] = npgeo.pose_compose(self.kf_pose[ref_row], msg.T_sref_s)
        if msg.velocity is not None:
            self.kf_vel[row] = msg.velocity
        if msg.bias_gyro is not None:
            self.kf_bias[row, :3] = msg.bias_gyro
        if msg.bias_acc is not None:
            self.kf_bias[row, 3:] = msg.bias_acc

    # ------------------------------------------------------------ maintenance
    def landmark_culling(self, min_obs: int = 2, max_gap: int = 5):
        """Remove landmarks that never reached `min_obs` observations once
        their reference KF is `max_gap` keyframes old
        (`Communicator::LandmarkCulling`, `communicator_be.cpp:71-105`)."""
        if self.n_lm == 0:
            return 0
        counts = np.zeros(self.n_lm, np.int64)
        np.add.at(counts, self.obs_lm[: self.n_obs][self.obs_mask[: self.n_obs]], 1)
        age = self.n_kf - 1 - self.lm_first_kf[: self.n_lm]
        kill = self.lm_mask[: self.n_lm] & (counts < min_obs) & (age > max_gap)
        rows = np.where(kill)[0]
        for r in rows:
            self.erase_landmark(r)
        return len(rows)

    def erase_landmark(self, row: int):
        self.lm_mask[row] = False
        sel = self.obs_lm[: self.n_obs] == row
        self.obs_mask[: self.n_obs][sel] = False
        mask_idx = np.where(sel)[0]
        for i in mask_idx:
            # only release slots still bound to THIS landmark — a slot may
            # have been re-pointed (fusion / re-sent landmark merge)
            if self.kf_feat_lm[self.obs_kf[i], self.obs_feat[i]] == row:
                self.kf_feat_lm[self.obs_kf[i], self.obs_feat[i]] = -1
        key = tuple(self.lm_ids[row])
        self._lm_index.pop(key, None)

    def covis_weights(self, row: int) -> np.ndarray:
        """Covisibility weights of one keyframe vs all others (shared-
        landmark counts, `keyframe_be.cpp:559-608`), host numpy on the
        live observation prefix."""
        o = self.n_obs
        live = self.obs_mask[:o]
        n_lm = max(self.n_lm, 1)
        seen = np.zeros(n_lm, bool)
        mine = live & (self.obs_kf[:o] == row)
        seen[self.obs_lm[:o][mine]] = True
        contrib = live & seen[np.minimum(self.obs_lm[:o], n_lm - 1)]
        w = np.bincount(self.obs_kf[:o][contrib], minlength=self.n_kf)
        w = w[: self.n_kf].astype(np.int32)
        if row < self.n_kf:
            w[row] = 0
        return w

    def landmark_obs(self, lm_row: int) -> np.ndarray:
        """Indices into the observation COO of a landmark's live obs."""
        o = self.n_obs
        return np.where((self.obs_lm[:o] == lm_row) & self.obs_mask[:o])[0]

    def observing_kfs(self, lm_row: int) -> np.ndarray:
        return self.obs_kf[self.landmark_obs(lm_row)]

    def fuse_landmark(self, target: int, tofuse: int) -> bool:
        """Merge duplicated landmarks after a loop closure
        (`PlaceRecognition::FuseLandmark`, `placerec_be.cpp:465-501`):
        re-point `tofuse`'s observations at `target` wherever `target` has
        no observation in that keyframe yet; erase `tofuse` when fewer than
        2 observations could not be moved."""
        if target == tofuse:
            return False
        if not (self.lm_mask[target] and self.lm_mask[tofuse]):
            return False
        target_kfs = set(int(k) for k in self.observing_kfs(target))
        non_moved = 0
        for i in self.landmark_obs(tofuse):
            kf, ft = int(self.obs_kf[i]), int(self.obs_feat[i])
            if kf not in target_kfs:
                self.obs_lm[i] = target
                self.kf_feat_lm[kf, ft] = target
                target_kfs.add(kf)
            elif self.kf_feat_lm[kf, ft] == target:
                # duplicate of an observation target owns at this slot:
                # retire it so a later erase of tofuse leaves no live
                # entry pointing at target's slot
                self.obs_mask[i] = False
            else:
                non_moved += 1
        if non_moved < 2:
            self.erase_landmark(tofuse)
        return True

    # ------------------------------------------------------------------ merge
    def merge_from(self, other: "Map", T_wtarget_wtofuse: np.ndarray):
        """Union `other` into self, rigidly transforming the fused map's
        poses, velocities and landmarks by ``T_wtarget_wtofuse`` (the
        merged-map constructor, `map_be.cpp:334-381`)."""
        self.commit_landmark_attributes()
        other.commit_landmark_attributes()
        T = np.asarray(T_wtarget_wtofuse, np.float64)
        kf_off, lm_off = self.n_kf, self.n_lm
        nk, nl, no = other.n_kf, other.n_lm, other.n_obs
        self._ensure_kf(kf_off + nk)
        self._ensure_lm(lm_off + nl)
        self._ensure_obs(self.n_obs + no)

        R = npgeo.quat_to_matrix(T[:4])
        for name in (
            "kf_ids", "kf_stamp", "kf_vel", "kf_bias", "kf_mask",
            "kf_is_loop", "kf_pose_optimized", "kf_in_gba", "kf_n_feat", "kp_uv",
            "kp_undist", "kp_aors", "descriptors", "imu_acc", "imu_gyro",
            "imu_dts", "imu_n", "kf_pose_vio", "kf_n_feat_add",
        ):
            getattr(self, name)[kf_off: kf_off + nk] = getattr(other, name)[:nk]
        if other.descriptors_add is not None:
            if self.descriptors_add is None:
                cap = self.kf_ids.shape[0]
                fa = self.max_features
                self.kp_undist_add = np.zeros((cap, fa, 2), np.float32)
                self.kp_aors_add = np.zeros((cap, fa, 4), np.float32)
                self.descriptors_add = np.zeros(
                    (cap, fa, other.descriptors_add.shape[2]),
                    other.descriptors_add.dtype)
            for name in ("kp_undist_add", "kp_aors_add", "descriptors_add"):
                getattr(self, name)[kf_off: kf_off + nk] = getattr(other, name)[:nk]
        self.kf_pose[kf_off: kf_off + nk] = npgeo.pose_compose(
            T[None], other.kf_pose[:nk])
        self.kf_vel[kf_off: kf_off + nk] = other.kf_vel[:nk] @ R.T
        self.kf_pred[kf_off: kf_off + nk] = np.where(
            other.kf_pred[:nk] >= 0, other.kf_pred[:nk] + kf_off, -1)
        self.kf_succ[kf_off: kf_off + nk] = np.where(
            other.kf_succ[:nk] >= 0, other.kf_succ[:nk] + kf_off, -1)
        self.kf_feat_lm[kf_off: kf_off + nk] = np.where(
            other.kf_feat_lm[:nk] >= 0, other.kf_feat_lm[:nk] + lm_off, -1)

        # landmarks (distance ranges carry over: the transform is SE(3))
        for name in ("lm_ids", "lm_mask", "lm_desc", "lm_optimized",
                     "lm_dist_rng"):
            getattr(self, name)[lm_off: lm_off + nl] = getattr(other, name)[:nl]
        # sim3_apply with unit scale
        self.lm_pos[lm_off: lm_off + nl] = 1.0 * npgeo.quat_rotate(
            T[:4], other.lm_pos[:nl]) + T[4:7]
        self.lm_normal[lm_off: lm_off + nl] = other.lm_normal[:nl] @ R.T
        self.lm_ref[lm_off: lm_off + nl] = np.where(
            other.lm_ref[:nl] >= 0, other.lm_ref[:nl] + kf_off, -1)
        self.lm_first_kf[lm_off: lm_off + nl] = np.where(
            other.lm_first_kf[:nl] >= 0, other.lm_first_kf[:nl] + kf_off, -1)

        o0 = self.n_obs
        self.obs_kf[o0: o0 + no] = other.obs_kf[:no] + kf_off
        self.obs_lm[o0: o0 + no] = other.obs_lm[:no] + lm_off
        self.obs_feat[o0: o0 + no] = other.obs_feat[:no]
        self.obs_mask[o0: o0 + no] = other.obs_mask[:no]

        self.n_kf += nk
        self.n_lm += nl
        self.n_obs += no
        for key, row in other._kf_index.items():
            self._kf_index[key] = row + kf_off
        for key, row in other._lm_index.items():
            self._lm_index[key] = row + lm_off
        self.associated_clients |= other.associated_clients
        self.calib.update(other.calib)
        for lc in other.loops:
            self.loops.append(
                {**lc, "kf1": lc["kf1"] + kf_off, "kf2": lc["kf2"] + kf_off})

    def add_loop_constraint(self, kf1: int, kf2: int, T_12: np.ndarray, cov=None):
        """`Map::AddLoopConstraint` (`map_be.cpp:404-409`): records the
        constraint and flags both KFs as loop-KFs (protects from culling)."""
        self.loops.append(
            {"kf1": int(kf1), "kf2": int(kf2),
             "T_12": np.asarray(T_12, np.float64),
             "cov": None if cov is None else np.asarray(cov, np.float64)})
        self.kf_is_loop[kf1] = True
        self.kf_is_loop[kf2] = True

    def _on_device(self, a, dtype=torch.float64) -> torch.Tensor:
        """A copy of ``a`` on the map's device (never a view of the map's
        arrays, which the write-backs change in place)."""
        return torch.tensor(np.asarray(a), dtype=dtype, device=self.device)

    # ------------------------------------------------------------ pose graph
    def to_pose_graph(
        self,
        loop_default_rot_w=100.0,
        loop_default_trans_w=1e4,
        wt_kf_R=10.0,
        wt_kf_T=1.0,
        use_nbr_kfs=True,
        wt_kf_n1=10.0,
        wt_kf_n23=2.0,
        wt_kf_n45=3.0,
        fix_optimized_kfs=False,
        poses_init: Optional[np.ndarray] = None,
    ) -> pgo_mod.PoseGraph:
        """Pose-graph snapshot on the map's device: successor edges from
        VIO poses (`optimization_be.cpp:946-972`), optional decaying-weight
        edges to the 2nd..5th successors (`:974-1021`), loop edges weighted
        by their covariance when present, else by the fixed COVINS weights
        (`:889-944`); `fix_optimized_kfs` is `opt.pgo_fix_kfs_after_gba`
        (`:875-881`).  Unlike the reference, nothing is padded to a
        capacity: the graph has one pose per keyframe row and one edge per
        constraint (a padded edge carries zero information)."""
        n = self.n_kf
        odo_i, odo_j, odo_mult = [], [], []
        for r in range(n):
            s = self.kf_succ[r]
            if s < 0 or not (self.kf_mask[r] and self.kf_mask[s]):
                continue
            odo_i.append(r); odo_j.append(int(s)); odo_mult.append(wt_kf_n1)
            if use_nbr_kfs:
                t = int(s)
                for hop in (2, 3, 4, 5):
                    t = self.kf_succ[t]
                    if t < 0 or not self.kf_mask[t]:
                        break
                    div = wt_kf_n23 if hop <= 3 else wt_kf_n45
                    odo_i.append(r); odo_j.append(int(t))
                    odo_mult.append(wt_kf_n1 / max(div, 1e-6))
        ei, ej = list(odo_i), list(odo_j)
        eloop = [False] * len(odo_i)
        if odo_i:
            eT = list(npgeo.pose_relative(self.kf_pose_vio[np.asarray(odo_i)],
                                          self.kf_pose_vio[np.asarray(odo_j)]))
            mult = np.asarray(odo_mult)
            diag = np.concatenate([
                np.repeat((wt_kf_R * mult)[:, None], 3, 1),
                np.repeat((wt_kf_T * mult)[:, None], 3, 1),
            ], axis=1)
            eS = list(np.einsum("ei,ij->eij", diag, np.eye(6)))
        else:
            eT, eS = [], []
        for lc in self.loops:
            ei.append(lc["kf1"]); ej.append(lc["kf2"]); eT.append(lc["T_12"])
            if lc.get("cov") is not None:
                eS.append(res_mod.sqrt_info_from_covariance(
                    torch.as_tensor(lc["cov"], dtype=torch.float64)).numpy())
            else:
                eS.append(np.diag([loop_default_rot_w] * 3
                                  + [loop_default_trans_w] * 3))
            eloop.append(True)
        if not ei:
            ei, ej = [0], [0]
            eT = [npgeo.pose_identity()]
            eS = [np.zeros((6, 6))]
            eloop = [False]
        poses = (poses_init[:n] if poses_init is not None
                 else self.kf_pose[:n]).astype(np.float64, copy=True)
        pose_mask = self.kf_mask[:n].copy()
        fixed = np.zeros(n, bool)
        live = self.live_kf_rows()
        if len(live):
            fixed[live[0]] = True
        if fix_optimized_kfs:
            fixed |= self.kf_in_gba[:n]
        # gauge KFs keep their CURRENT pose even when a loop correction
        # touched them (else the whole map drifts with the gauge)
        poses[fixed] = self.kf_pose[:n][fixed]
        dev = self.device
        t = self._on_device
        return pgo_mod.PoseGraph(
            poses=t(poses, torch.float64), pose_mask=t(pose_mask, torch.bool),
            fixed=t(fixed, torch.bool), edge_i=t(ei, torch.int64),
            edge_j=t(ej, torch.int64), edge_T=t(np.stack(eT), torch.float64),
            edge_sqrt_info=t(np.stack(eS), torch.float64),
            edge_mask=torch.ones(len(ei), dtype=torch.bool, device=dev),
            edge_is_loop=t(eloop, torch.bool))

    def apply_pose_graph_result(self, poses_new: np.ndarray):
        """Write back PGO poses; rotate velocities and re-anchor landmarks
        through their reference KF's correction
        (`optimization_be.cpp:1033-1086`)."""
        poses_new = np.asarray(poses_new)
        n = self.n_kf
        old = self.kf_pose[:n].copy()
        corr = npgeo.pose_compose(poses_new[:n], npgeo.pose_inverse(old))
        live = self.kf_mask[:n]
        self.kf_pose[:n][live] = poses_new[:n][live]
        self.kf_pose_optimized[:n][live] = True
        Rc = npgeo.quat_to_matrix(corr[:, :4])
        self.kf_vel[:n][live] = np.einsum(
            "nij,nj->ni", Rc[live], self.kf_vel[:n][live])
        lrows = np.where(self.lm_mask[: self.n_lm])[0]
        if len(lrows):
            refs = self.lm_ref[lrows]
            ok = (refs >= 0) & (refs < n)
            ok[ok] &= live[refs[ok]]
            lrows, refs = lrows[ok], refs[ok]
            if len(lrows):
                p_ref = npgeo.pose_apply(npgeo.pose_inverse(old[refs]),
                                         self.lm_pos[lrows])
                self.lm_pos[lrows] = npgeo.pose_apply(self.kf_pose[refs], p_ref)

    # ------------------------------------------------------------------ GBA
    def to_gba_problem(self, octave_base_sigma: float = 2.0) -> gba_mod.GBAProblem:
        """GBA snapshot on the map's device: keyframe states, landmarks,
        the observation COO with octave sigma weights
        (`optimization_be.cpp:178-235`) on the DISTORTED pixels (`:183`),
        IMU factors re-propagated from the stored raw samples at the
        current bias (`:132-143`; kernel K10 on the card), loop edges, and
        the first live keyframe's pose as the gauge."""
        n, m, o = self.n_kf, self.n_lm, self.n_obs
        if not self.calib:
            raise ValueError("no calibration registered; cannot build GBA")
        calib = next(iter(self.calib.values()))
        cam = cam_mod.camera_from_calibration(calib, self.device)
        noise = imu_mod.ImuNoise(
            acc_noise=float(calib.acc_noise), gyro_noise=float(calib.gyro_noise),
            acc_walk=float(calib.acc_walk), gyro_walk=float(calib.gyro_walk))
        t = self._on_device

        # observation weights from the octave, in float32 as the reference
        octs = self.kp_aors[self.obs_kf[:o], self.obs_feat[:o], 1]
        obs_w = res_mod.reprojection_weight(torch.from_numpy(octs), octave_base_sigma)
        obs_uv = self.kp_uv[self.obs_kf[:o], self.obs_feat[:o]]

        # IMU factors: KF j's stored window covers (pred(j) -> j)
        fi, fj = [], []
        for r in range(n):
            pr = self.kf_pred[r]
            if pr >= 0 and self.imu_n[r] > 0 and self.kf_mask[r] and self.kf_mask[pr]:
                fi.append(int(pr))
                fj.append(r)
        if not fi:
            fi, fj = [0], [0]
        fi, fj = np.asarray(fi, np.int64), np.asarray(fj, np.int64)
        smask = (np.arange(self.imu_max_samples)[None, :]
                 < self.imu_n[fj][:, None]).astype(np.float64)
        pre = imu_mod.preintegrate(
            t(self.imu_acc[fj]), t(self.imu_gyro[fj]), t(self.imu_dts[fj]), t(smask),
            t(self.kf_bias[fi, :3]), t(self.kf_bias[fi, 3:]), noise)

        if self.loops:
            li = [lc["kf1"] for lc in self.loops]
            lj = [lc["kf2"] for lc in self.loops]
            lT = np.stack([lc["T_12"] for lc in self.loops])
            lS = np.stack([
                np.diag([100.0] * 3 + [1e4] * 3) if lc["cov"] is None
                else np.linalg.cholesky(np.linalg.inv(
                    np.asarray(lc["cov"]) + 1e-12 * np.eye(6))).T
                for lc in self.loops])
            lmask = np.ones(len(self.loops), bool)
        else:
            li = lj = [0]
            lT = npgeo.pose_identity()[None]
            lS = np.zeros((1, 6, 6))
            lmask = np.zeros(1, bool)

        fixed = np.zeros(n, bool)
        live = self.live_kf_rows()
        if len(live):
            fixed[live[0]] = True
        return gba_mod.GBAProblem(
            poses=t(self.kf_pose[:n]), vels=t(self.kf_vel[:n]),
            biases=t(self.kf_bias[:n]), kf_mask=t(self.kf_mask[:n], torch.bool),
            kf_fixed=t(fixed, torch.bool), cam=cam,
            lms=t(self.lm_pos[:m]), lm_mask=t(self.lm_mask[:m], torch.bool),
            obs_kf=t(self.obs_kf[:o], torch.int64), obs_lm=t(self.obs_lm[:o], torch.int64),
            obs_uv=t(obs_uv), obs_w=t(obs_w), obs_mask=t(self.obs_mask[:o], torch.bool),
            imu_i=t(fi, torch.int64), imu_j=t(fj, torch.int64), imu_pre=pre,
            imu_sqrt_info=gba_mod.imu_sqrt_info_from_cov(pre.cov),
            bias_sqrt_info=gba_mod.bias_walk_sqrt_info(noise, pre.dt),
            imu_mask=pre.dt > 1e-6,
            gravity=t([0.0, 0.0, -float(calib.gravity_mag)]),
            loop_i=t(li, torch.int64), loop_j=t(lj, torch.int64), loop_T=t(lT),
            loop_sqrt_info=t(lS), loop_mask=t(lmask, torch.bool))

    def apply_gba_result(self, problem: gba_mod.GBAProblem):
        """Write back optimised keyframe states, landmark positions and the
        pruned observation mask (`optimization_be.cpp:560-617`)."""
        n, m = self.n_kf, self.n_lm
        live = self.kf_mask[:n]
        self.kf_pose[:n][live] = problem.poses.cpu().numpy()[:n][live]
        self.kf_vel[:n][live] = problem.vels.cpu().numpy()[:n][live]
        self.kf_bias[:n][live] = problem.biases.cpu().numpy()[:n][live]
        self.kf_pose_optimized[:n][live] = True
        self.kf_in_gba[:n][live] = True
        lml = self.lm_mask[:m]
        self.lm_pos[:m][lml] = problem.lms.cpu().numpy()[:m][lml]
        self.lm_optimized[:m][lml] = True
        self.obs_mask[: self.n_obs] = problem.obs_mask.cpu().numpy()

    # ----------------------------------------------------------- persistence
    def save(self, path: str):
        """Columnar checkpoint (one npz instead of the reference's
        file-per-KF cereal dump, `map_be.cpp:813-922`)."""
        self.commit_landmark_attributes()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        arrays = {}
        for name in (
            "kf_ids", "kf_stamp", "kf_pose", "kf_pose_vio", "kf_vel",
            "kf_bias", "kf_pred", "kf_succ", "kf_mask", "kf_is_loop",
            "kf_pose_optimized", "kf_in_gba", "kf_n_feat", "kp_uv", "kp_undist",
            "kp_aors", "descriptors", "kf_feat_lm", "imu_acc", "imu_gyro",
            "imu_dts", "imu_n", "kf_n_feat_add",
        ):
            arrays[name] = getattr(self, name)[: self.n_kf]
        if self.descriptors_add is not None:
            for name in ("kp_undist_add", "kp_aors_add", "descriptors_add"):
                arrays[name] = getattr(self, name)[: self.n_kf]
        for name in (
            "lm_ids", "lm_pos", "lm_ref", "lm_mask", "lm_desc",
            "lm_normal", "lm_first_kf", "lm_optimized", "lm_dist_rng",
        ):
            arrays[name] = getattr(self, name)[: self.n_lm]
        for name in ("obs_kf", "obs_lm", "obs_feat", "obs_mask"):
            arrays[name] = getattr(self, name)[: self.n_obs]
        arrays["loop_kf1"] = np.asarray([l["kf1"] for l in self.loops], np.int32)
        arrays["loop_kf2"] = np.asarray([l["kf2"] for l in self.loops], np.int32)
        arrays["loop_T"] = (
            np.stack([l["T_12"] for l in self.loops])
            if self.loops else np.zeros((0, 7))
        )
        # COVINS-G loop covariances; NaN block = no covariance recorded
        arrays["loop_cov"] = (
            np.stack([np.full((6, 6), np.nan) if l.get("cov") is None
                      else np.asarray(l["cov"]) for l in self.loops])
            if self.loops else np.zeros((0, 6, 6))
        )
        # per-client calibration (the reference serializes VICalibration
        # with every keyframe, `msg_keyframe.hpp:128-202`; one per client
        # suffices for the columnar checkpoint)
        cids = sorted(self.calib)
        arrays["calib_client"] = np.asarray(cids, np.int64)
        arrays["calib_T_s_c"] = np.stack(
            [np.asarray(self.calib[c].T_s_c, np.float64) for c in cids]
        ) if cids else np.zeros((0, 7))
        arrays["calib_intrinsics"] = np.stack(
            [np.asarray(self.calib[c].intrinsics, np.float64) for c in cids]
        ) if cids else np.zeros((0, 5))
        arrays["calib_dist"] = np.stack(
            [np.asarray(self.calib[c].dist, np.float64) for c in cids]
        ) if cids else np.zeros((0, 4))
        arrays["calib_scalars"] = np.asarray(
            [[self.calib[c].cam_model, self.calib[c].dist_model,
              self.calib[c].img_w, self.calib[c].img_h,
              self.calib[c].acc_noise, self.calib[c].gyro_noise,
              self.calib[c].acc_walk, self.calib[c].gyro_walk,
              self.calib[c].imu_rate, self.calib[c].gravity_mag]
             for c in cids], np.float64,
        ) if cids else np.zeros((0, 10))
        arrays["map_id"] = np.asarray(self.id)
        np.savez_compressed(path, **arrays)

    @classmethod
    def load(cls, path: str, device: DeviceLike = None) -> "Map":
        """Read a checkpoint written by :meth:`save` (the same npz format
        as the JAX package's `Map.save`)."""
        z = np.load(path, allow_pickle=False)
        n_kf = z["kf_ids"].shape[0]
        n_lm = z["lm_ids"].shape[0]
        n_obs = z["obs_kf"].shape[0]
        mp = cls(
            int(z["map_id"]),
            max_features=z["descriptors"].shape[1] if n_kf else 1024,
            desc_bytes=z["descriptors"].shape[2] if n_kf else 32,
            desc_dtype=z["descriptors"].dtype if n_kf else np.uint8,
            kf_capacity=max(n_kf, 16),
            lm_capacity=max(n_lm, 16),
            obs_capacity=max(n_obs, 16),
            device=device,
        )
        mp.n_kf, mp.n_lm, mp.n_obs = n_kf, n_lm, n_obs
        if "descriptors_add" in z.files:
            cap = mp.kf_ids.shape[0]
            fa = z["descriptors_add"].shape[1]
            mp.kp_undist_add = np.zeros((cap, fa, 2), np.float32)
            mp.kp_aors_add = np.zeros((cap, fa, 4), np.float32)
            mp.descriptors_add = np.zeros(
                (cap, fa, z["descriptors_add"].shape[2]),
                z["descriptors_add"].dtype,
            )
        skip = ("loop_kf1", "loop_kf2", "loop_T", "loop_cov", "map_id",
                "calib_client", "calib_T_s_c", "calib_intrinsics",
                "calib_dist", "calib_scalars")
        for name in z.files:
            if name in skip:
                continue
            getattr(mp, name)[: z[name].shape[0]] = z[name]
        for i in range(n_kf):
            if mp.kf_mask[i]:
                mp._kf_index[tuple(mp.kf_ids[i])] = i
                mp.associated_clients.add(int(mp.kf_ids[i, 1]))
        for i in range(n_lm):
            if mp.lm_mask[i]:
                mp._lm_index[tuple(mp.lm_ids[i])] = i
        covs = (z["loop_cov"] if "loop_cov" in z.files
                else np.full((len(z["loop_kf1"]), 6, 6), np.nan))
        for k1, k2, T, C in zip(z["loop_kf1"], z["loop_kf2"], z["loop_T"],
                                covs):
            mp.loops.append({
                "kf1": int(k1), "kf2": int(k2), "T_12": np.asarray(T),
                "cov": None if np.isnan(C).any() else np.asarray(C),
            })
        if "calib_client" in z.files:
            for i, cid in enumerate(z["calib_client"]):
                s = z["calib_scalars"][i]
                mp.calib[int(cid)] = msgs.VICalibration(
                    T_s_c=z["calib_T_s_c"][i],
                    cam_model=int(s[0]), dist_model=int(s[1]),
                    intrinsics=z["calib_intrinsics"][i],
                    dist=z["calib_dist"][i],
                    img_w=int(s[2]), img_h=int(s[3]),
                    acc_noise=float(s[4]), gyro_noise=float(s[5]),
                    acc_walk=float(s[6]), gyro_walk=float(s[7]),
                    imu_rate=float(s[8]), gravity_mag=float(s[9]),
                )
        return mp

    # ------------------------------------------------------------- snapshots
    def live_kf_rows(self, client_id: Optional[int] = None) -> np.ndarray:
        rows = np.where(self.kf_mask[: self.n_kf])[0]
        if client_id is not None:
            rows = rows[self.kf_ids[rows, 1] == client_id]
        return rows

    def update_landmark_attributes(self, lm_rows=None, max_obs_pad: int = 16,
                                   lazy: bool = False):
        """Batched representative-descriptor + normal + distance-range
        refresh for a cohort of landmarks (the per-KF ingest loop of
        `communicator_be.cpp:181-205`).

        The cohort's padded observation window is gathered on the host
        into one packed buffer (pinned on a card), copied to the map's
        device at once and refreshed there in one launch of K2
        (`landmark_ops.landmark_attributes`).  With ``lazy=True`` the
        packed result stays on the device and the write-back waits for
        :meth:`commit_landmark_attributes`, so the ingest path does not
        wait for the device; consumers of lm_desc / lm_normal /
        lm_dist_rng (save, loop verification, merge) commit first."""
        if lm_rows is None:
            lm_rows = np.where(self.lm_mask[: self.n_lm])[0]
        if self.desc_dtype != np.uint8:
            # SIFT mode (COVINS-G only): landmark descriptors/normals are
            # not used by the 2D-only pipeline
            return
        lm_rows = np.asarray(lm_rows, np.int32)
        if len(lm_rows) == 0:
            return
        o = self.n_obs
        n_rows = len(lm_rows)
        dev = self.device
        buf = torch.empty(landmark_ops.refresh_layout(n_rows, max_obs_pad)[3],
                          dtype=torch.uint8, pin_memory=dev.type == "cuda")
        host = buf.numpy()
        host[:] = 0
        pos, centers, octaves, descs, mask = landmark_ops.refresh_views(
            host, n_rows, max_obs_pad)
        pos[...] = self.lm_pos[lm_rows]
        # vectorised cohort gather: one pass over the obs COO
        pos_of = np.full(self.lm_ids.shape[0], -1, np.int32)
        pos_of[lm_rows] = np.arange(n_rows, dtype=np.int32)
        ci = pos_of[self.obs_lm[:o]]
        idx = np.where(self.obs_mask[:o] & (ci >= 0))[0]
        if len(idx):
            ci = ci[idx]
            order = np.argsort(ci, kind="stable")
            idx, ci = idx[order], ci[order]
            # slot of each observation within its landmark's padded window
            grp_start = np.searchsorted(ci, np.arange(n_rows))
            slots = np.arange(len(ci)) - grp_start[ci]
            keep = slots < max_obs_pad
            idx, ci, slots = idx[keep], ci[keep], slots[keep]
            kr, ft = self.obs_kf[idx], self.obs_feat[idx]
            descs[ci, slots] = self.descriptors[kr, ft]
            centers[ci, slots] = self.kf_pose[kr, 4:7]
            octaves[ci, slots] = self.kp_aors[kr, ft, 1]
            mask[ci, slots] = True
        out = landmark_ops.landmark_attributes(buf.to(dev, non_blocking=True), n_rows,
                                               max_obs_pad)
        # the host buffer is kept until the write-back, past the copy
        self._pending_lm_attrs.append((lm_rows, mask.any(axis=1), out, buf))
        if not lazy:
            self.commit_landmark_attributes()

    def commit_landmark_attributes(self) -> None:
        """Write back every pending attribute cohort, in order (so the last
        write wins), with one device-to-host copy per cohort."""
        pending, self._pending_lm_attrs = self._pending_lm_attrs, []
        for lm_rows, any_obs, out, _ in pending:
            rep, nrm, rng = landmark_ops.unpack_attributes(out.cpu().numpy(), len(lm_rows))
            rows = lm_rows[any_obs]
            self.lm_desc[rows] = rep[any_obs]
            self.lm_normal[rows] = nrm[any_obs]
            self.lm_dist_rng[rows] = rng[any_obs]

    # ------------------------------------------------------------ trajectories
    def _trajectory_lines_tum(self, client_id: int) -> str:
        """TUM format: `stamp tx ty tz qx qy qz qw`
        (`Map::WriteStateToCsvTUM`, `map_be.cpp:1040-1076`)."""
        rows = self.live_kf_rows(client_id)
        rows = rows[np.argsort(self.kf_stamp[rows])]
        out = []
        for r in rows:
            q = self.kf_pose[r, :4]
            t = self.kf_pose[r, 4:7]
            out.append(
                f"{self.kf_stamp[r]:.25g} {t[0]:.17g} {t[1]:.17g} {t[2]:.17g} "
                f"{q[1]:.17g} {q[2]:.17g} {q[3]:.17g} {q[0]:.17g}\n"
            )
        return "".join(out)

    def _trajectory_lines_euroc(self, client_id: int) -> str:
        """EuRoC format: `stamp_ns,tx,ty,tz,qw,qx,qy,qz,vx,vy,vz,bgx..,bax..`
        (`Map::WriteStateToCsv`, `map_be.cpp:987-1038`)."""
        rows = self.live_kf_rows(client_id)
        rows = rows[np.argsort(self.kf_stamp[rows])]
        out = []
        for r in rows:
            q = self.kf_pose[r, :4]
            t = self.kf_pose[r, 4:7]
            v = self.kf_vel[r]
            bg = self.kf_bias[r, :3]
            ba = self.kf_bias[r, 3:]
            out.append(
                f"{self.kf_stamp[r] * 1e9:.25g},"
                f"{t[0]:.17g},{t[1]:.17g},{t[2]:.17g},"
                f"{q[0]:.17g},{q[1]:.17g},{q[2]:.17g},{q[3]:.17g},"
                f"{v[0]:.17g},{v[1]:.17g},{v[2]:.17g},"
                f"{bg[0]:.17g},{bg[1]:.17g},{bg[2]:.17g},"
                f"{ba[0]:.17g},{ba[1]:.17g},{ba[2]:.17g}\n"
            )
        return "".join(out)

    @staticmethod
    def _atomic_write(path: str, content: str):
        """Write-then-rename so readers never observe a partial file."""
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as fh:
            fh.write(content)
        os.replace(tmp, path)

    def write_trajectory_tum(self, path: str, client_id: int):
        content = self._trajectory_lines_tum(client_id)
        if content:
            self._atomic_write(path, content)

    def write_trajectory_euroc(self, path: str, client_id: int):
        content = self._trajectory_lines_euroc(client_id)
        if content:
            self._atomic_write(path, content)

    def write_trajectories(self, out_dir: str, fmt: str = "TUM", suffix: str = ""):
        """Per-client files + combined estimate (`WriteKFsToFile` /
        `WriteKFsToFileAllAg`, `map_be.cpp:944-985`).  All writes are
        atomic (tmp + rename)."""
        os.makedirs(out_dir, exist_ok=True)
        lines = self._trajectory_lines_tum if fmt == "TUM" else self._trajectory_lines_euroc
        ext = "ftum" if fmt == "TUM" else "feuroc"
        combined = []
        for cid in sorted(self.associated_clients):
            content = lines(cid)
            combined.append(content)
            if content:
                self._atomic_write(
                    os.path.join(out_dir, f"KF_{cid}{suffix}_{ext}.csv"), content
                )
        self._atomic_write(
            os.path.join(out_dir, f"stamped_traj_estimate{suffix}.txt"),
            "".join(combined),
        )
