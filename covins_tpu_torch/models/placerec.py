"""Place recognition: loop detection and loop verification in both of
the reference's modes.

Counterpart of `covins_tpu/models/placerec.py`: COVINS (`placerec_be.cpp`:
Run -> DetectLoop -> ComputeSE3, always AddToDatabase) and COVINS-G
(`placerec_gen_be.cpp`: the same skeleton with temporal-neighbour groups,
multi-keyframe 17-point relative pose with sampling covariance and the
yaw/translation gate; loop edges carry the covariance).  Detection is
host numpy over the retrieval scores (exclusions, group accumulation,
consistency groups); each surviving candidate is verified by
`ops/loopverify.py` in two phases, so a drained window dispatches all its
verifications before it fetches any.

The RANSAC draws come from one CPU `torch.Generator` per agent, seeded as
the reference seeds its key (``rng_seed + 1000 * client_id``), so the
card's run and the CPU's draw the same minimal sets.  SIFT descriptors
(`feat_type="SIFT"`, 128 float32 dimensions) run in COVINS-G, with L2
retrieval and L2 ratio matching, as in the reference; COVINS over SIFT is
refused, since the reference cannot run it either.

Pose convention: a loop result carries ``T_12 = T_sq_sc``, mapping
candidate-body coordinates into query-body coordinates.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from covins_tpu_torch.models.kf_database import KeyframeDatabase
from covins_tpu_torch.ops import loopverify, ransac
from covins_tpu_torch.utils import cameras as cam_mod
from covins_tpu_torch.utils import npgeo
from covins_tpu_torch.utils.config import Config

SIFT_NEEDS_COVINS_G = (
    "SIFT descriptors (feat_type='SIFT') run in COVINS-G only "
    "(placerec_type='COVINS_G'), as in the reference, whose COVINS "
    "verification matches binary descriptors; use ORB descriptors, COVINS-G "
    "or placerec_active=False")


@dataclasses.dataclass
class LoopResult:
    query_id: tuple
    candidate_id: tuple
    T_12: np.ndarray  # T_sq_sc: candidate body -> query body
    n_inliers: int
    cov: Optional[np.ndarray] = None
    # verified (query feature idx, candidate-map landmark row) pairs; the
    # landmark rows index the CANDIDATE map at detection time
    matches: Optional[np.ndarray] = None  # (M, 2) int32


def check_supported(cfg: Config) -> None:
    if cfg.placerec_active and cfg.feat_type == "SIFT" and cfg.placerec_type != "COVINS_G":
        raise NotImplementedError(SIFT_NEEDS_COVINS_G)


def _temporal_neighbors(mp, row: int, k: int = 10) -> np.ndarray:
    """Temporal predecessor/successor chain neighbours, COVINS-G's
    connectivity (`keyframe_be.cpp:385-410`)."""
    rows = []
    for link in (mp.kf_pred, mp.kf_succ):
        r = int(link[row])
        while r >= 0 and len(rows) < k:
            if mp.kf_mask[r]:
                rows.append(r)
            r = int(link[r])
    return np.asarray(rows, np.int64)


class PlaceRecognition:
    """One instance per agent (`handler_be.cpp:41-48`), sharing the global
    `KeyframeDatabase`.  ``resolve`` maps a keyframe id to (Map, row) in
    any map, so candidates in other maps drive merging."""

    def __init__(self, client_id: int, database: KeyframeDatabase,
                 resolve, config: Optional[Config] = None, rng_seed: int = 0):
        self.client_id = client_id
        self.db = database
        self.resolve = resolve
        self.cfg = config or Config()
        check_supported(self.cfg)
        self.generator = torch.Generator().manual_seed(rng_seed + 1000 * client_id)
        self.last_loop_kf_id = -(10**9)
        self.n_dispatched = 0  # candidate verifications queued on the device
        self._consistent_groups: list[tuple[set, int]] = []
        self._cameras: dict = {}  # id(calibration) -> (calibration, Camera)

    def next_gumbel(self, n_sets: int, n: int) -> torch.Tensor:
        """The stage-2 Gumbel noise of the next verification (CPU)."""
        return ransac.gumbel_noise(self.generator, n_sets, n)

    def next_covins_g_noise(self, n_pairs: int, n_hyp5: int, Fq: int,
                            n_hyp17: int, n_cov: int) -> dict:
        """The Gumbel noise of the next COVINS-G verification (numpy), in
        the reference's key order: each pair's central RANSAC, then the
        17-point RANSAC, then the covariance."""
        g = self.generator
        return {"noise5": torch.stack([ransac.gumbel_noise(g, n_hyp5, Fq)
                                       for _ in range(n_pairs)]).numpy(),
                "noise17": ransac.gumbel_noise(g, n_hyp17, n_pairs * Fq).numpy(),
                "noise_cov": ransac.gumbel_noise(g, n_cov, n_pairs * Fq).numpy()}

    def _camera_of(self, mp, client_id: int) -> cam_mod.Camera:
        """Device-resident camera per calibration object, cached so repeated
        verifications upload no calibration; the entry holds the
        calibration, so its id cannot be reused while the entry lives."""
        calib = mp.calib[client_id]
        hit = self._cameras.get(id(calib))
        if hit is not None and hit[0] is calib:
            return hit[1]
        cam = cam_mod.camera_from_calibration(calib, mp.device)
        self._cameras[id(calib)] = (calib, cam)
        return cam

    # ------------------------------------------------------------- detection
    def detect_loop(self, mp, kf_row: int, pre: Optional[dict] = None
                    ) -> list[tuple]:
        """BoW retrieval + exclusions + consistency grouping (`DetectLoop`,
        `placerec_be.cpp:346-463`).  Returns candidate keyframe ids
        (possibly in other maps).  ``pre`` carries the keyframe's raw
        retrieval data from `KeyframeDatabase.add_and_query_batch`."""
        cfg = self.cfg
        kf_id = tuple(mp.kf_ids[kf_row])
        if kf_id[0] < cfg.start_after_kf:
            return []
        if kf_id[0] - self.last_loop_kf_id < cfg.consecutive_loop_dist:
            return []
        n_feat = int(mp.kf_n_feat[kf_row])
        if n_feat == 0:
            return []
        descs = mp.descriptors[kf_row, :n_feat]

        covis = mp.covis_weights(kf_row)
        # exclusion mask over db rows (`kf_database.cpp:47-187` filters)
        n_db = self.db.n
        row_kf = self.db.row_kf[:n_db]
        row_client = self.db.row_client[:n_db]
        excl = row_kf < cfg.exclude_kfs_with_id_less_than
        excl |= (row_client == kf_id[1]) & (
            np.abs(row_kf - kf_id[0]) < cfg.min_loop_dist)
        covis_rows = np.where(covis > 0)[0]
        covis_dbr = np.full(len(covis_rows), -1, np.int64)
        for j, r in enumerate(covis_rows):
            dbr = self.db.row_of.get(tuple(int(x) for x in mp.kf_ids[r]), -1)
            if dbr >= 0:
                excl[dbr] = True
                covis_dbr[j] = dbr

        if pre is not None:
            # the 0.8 * max-common-words gate of `KeyframeDatabase.query`
            # over the insert-time snapshot, ANDed with the live mask
            n_pre = min(n_db, len(pre["scores"]))
            raw_s = pre["scores"][:n_pre]
            raw_c = pre["common"][:n_pre]
            m = pre["valid"][:n_pre] & self.db._mask[:n_pre] & ~excl[:n_pre]
            if not m.any():
                self._consistent_groups = []
                return []
            max_common = int((raw_c * m).max())
            keep = raw_c >= 0.8 * max_common
            scores = np.where(keep & m, raw_s, -1.0)
        else:
            scores, _ = self.db.query(descs, exclude_rows=np.where(excl)[0])
        if scores.size == 0:
            return []

        # min covisible BoW score (`placerec_be.cpp:372-385`)
        covis_sel = covis[covis_rows] >= cfg.covis_thres
        covis_db = [int(r) for r in covis_dbr[covis_sel] if r >= 0]
        if pre is not None:
            covis_db = [r for r in covis_db
                        if r < len(pre["valid"]) and pre["valid"][r]]
        if covis_db:
            if pre is not None:
                sims = pre["scores"][covis_db]
            else:
                qv = self.db.bow_vector(descs)
                sims = (self.db.db[torch.as_tensor(covis_db, device=qv.device)]
                        @ qv).cpu().numpy()
            min_score = max(float(sims.min()), 0.05)
        else:
            min_score = 0.05
        frac = 0.8 if cfg.placerec_type == "COVINS" else 0.7
        cand_rows = np.where(scores >= frac * min_score)[0]
        if len(cand_rows) == 0:
            self._consistent_groups = []
            return []

        # covisibility-group score accumulation (`kf_database.cpp:131-183`);
        # COVINS-G groups by temporal neighbours
        def group_rows(cmp_, crow):
            if cfg.placerec_type == "COVINS_G":
                return _temporal_neighbors(cmp_, crow, k=10)
            gw = cmp_.covis_weights(crow)
            nz = np.where(gw > 0)[0]
            return nz[np.argsort(-gw[nz])][:10]

        acc_list = []  # (acc_score, best_db_row, group id set)
        best_acc = frac * min_score
        for db_row in cand_rows:
            kid = self.db.row_ids[db_row]
            cmp_, crow = self.resolve(kid)
            if cmp_ is None:
                continue
            if cfg.inter_map_matches_only and cmp_ is mp:
                continue
            members = group_rows(cmp_, crow)
            group = {tuple(cmp_.kf_ids[r]) for r in members} | {kid}
            acc_score = float(scores[db_row])
            best_row, best_score = db_row, acc_score
            for r in members:
                dbr = self.db.row_of.get(tuple(int(x) for x in cmp_.kf_ids[r]), -1)
                if 0 <= dbr < len(scores) and scores[dbr] > 0:
                    acc_score += float(scores[dbr])
                    if scores[dbr] > best_score:
                        best_score = float(scores[dbr])
                        best_row = dbr
            acc_list.append((acc_score, best_row, group))
            best_acc = max(best_acc, acc_score)
        retain = 0.75 * best_acc
        acc_list = [a for a in acc_list if a[0] > retain or len(acc_list) == 1]
        acc_list.sort(key=lambda a: -a[0])
        seen_rows: set = set()
        winners = []
        for _, best_row, group in acc_list[: cfg.retrieval_topk]:
            if best_row in seen_rows:
                continue
            seen_rows.add(best_row)
            winners.append((best_row, group))

        # consistency groups (`placerec_be.cpp:408-453`), as id sets so
        # they survive map merges
        cands: list[tuple] = []
        new_groups: list[tuple[set, int]] = []
        for db_row, group in winners:
            kid = self.db.row_ids[db_row]
            cmp_, _ = self.resolve(kid)
            if cmp_ is None:
                continue
            group = group | {kid}
            best_count = 0
            for prev_group, count in self._consistent_groups:
                if group & prev_group:
                    best_count = max(best_count, count + 1)
            new_groups.append((group, best_count))
            if best_count + 1 >= cfg.cov_consistency_thres:
                cands.append(kid)
        self._consistent_groups = new_groups
        return cands

    # ---------------------------------------------------------- verification
    def dispatch_verify_covins(self, mp_q, q_row: int, mp_c, c_row: int):
        """Landmark-based loop verification (`ComputeSE3`,
        `placerec_be.cpp:63-220`): the five stages of
        `ops/loopverify.py`, queued with no host sync.  Returns an opaque
        job for `loopverify.finalize_covins_verify` (None if a host
        precondition fails)."""
        cam_q = self._camera_of(mp_q, int(mp_q.kf_ids[q_row, 1]))
        cam_c = self._camera_of(mp_c, int(mp_c.kf_ids[c_row, 1]))
        noise = self.next_gumbel(min(self.cfg.ransac_max_iterations, 512),
                                 mp_q.max_features)
        job = loopverify.dispatch_covins_verify(
            mp_q, q_row, mp_c, c_row, self.cfg, cam_q, cam_c,
            noise=noise.numpy())
        self.n_dispatched += job is not None
        return job

    def compute_se3_covins(self, mp_q, q_row: int, mp_c, c_row: int):
        """Dispatch + finalize in one call: (T_12, n_inliers, matches) or
        None."""
        return loopverify.finalize_covins_verify(
            self.dispatch_verify_covins(mp_q, q_row, mp_c, c_row))

    def dispatch_verify_covins_g(self, mp_q, q_row: int, mp_c, c_row: int):
        """2D-only loop verification (`placerec_gen_be.cpp:82-167` +
        `RelNonCentralPosSolver`): rig assembly on the host (the query and
        its predecessor, the candidate and its two predecessors; the
        pose-estimation `_add` features when present), then the queued
        device work of `loopverify.covinsg_verify` (no host sync), with the
        L2 metric for float (SIFT) descriptors.  Returns
        an opaque job for :meth:`finalize_covins_g`, or None when a rig
        has too few features."""
        cfg = self.cfg

        def rig_rows(mp, row, want):
            rows, r = [row], row
            while len(rows) < want:
                r = int(mp.kf_pred[r])
                if r < 0:
                    break
                rows.append(r)
            return rows

        def rig(mp, rows, anchor):
            F = mp.max_features
            T_s_c = np.asarray(mp.calib[int(mp.kf_ids[anchor, 1])].T_s_c, np.float64)
            uv, desc, mask, T = [], [], [], []
            for r in rows:
                kp, dsc, n = mp.match_features(r)
                uv.append(np.asarray(kp, np.float64))
                desc.append(dsc)
                mask.append(np.arange(F) < n)
                T.append(npgeo.pose_compose(
                    npgeo.pose_relative(mp.kf_pose[anchor], mp.kf_pose[r]), T_s_c))
            return {"uv": np.concatenate(uv), "T": np.stack(T),
                    "desc": np.concatenate(desc), "mask": np.concatenate(mask)}

        q_rig, c_rig = rig_rows(mp_q, q_row, 2), rig_rows(mp_c, c_row, 3)
        rq, rc = rig(mp_q, q_rig, q_row), rig(mp_c, c_rig, c_row)
        nq, nc = int(rq["mask"].sum()), int(rc["mask"].sum())
        if nq < cfg.rel_min_img_matches or nc < cfg.rel_min_img_matches:
            return None
        focal = float(mp_q.calib[int(mp_q.kf_ids[q_row, 1])].intrinsics[0])
        # a 5-point sample gives up to 10 essentials, so a quarter of the
        # 8-point budget scores as many poses
        if cfg.rel_minimal_solver == "5pt":
            n_hyp5 = min(max(cfg.rel_max_iters // 4, 16), 64)
        else:
            n_hyp5 = min(cfg.rel_max_iters, 256)
        params = dict(
            img_match_thres=float(cfg.img_match_thres), ratio_thres=float(cfg.ratio_thres),
            thr5=math.atan2(cfg.rel_error_thres, focal),
            rel_min_img_matches=cfg.rel_min_img_matches,
            rel_min_inliers=cfg.rel_min_inliers,
            thr17=math.atan2(cfg.nc_rp_error, focal), nc_min_inliers=cfg.nc_min_inliers,
            thr_cov_rad=math.atan2(cfg.nc_rp_error_cov, focal),
            nc_cov_thres=float(cfg.nc_cov_thres),
            nq_rig=len(q_rig), nc_rig=len(c_rig), Fq=mp_q.max_features,
            Fc=mp_c.max_features, n_hyp5=n_hyp5, n_hyp17=min(cfg.nc_max_iters, 512),
            n_cov=2 * cfg.nc_cov_iters, solver=cfg.rel_minimal_solver,
            # SIFT mode (`feat.type: SIFT`): L2 matching, thresholds linear L2
            metric="hamming" if rq["desc"].dtype == np.uint8 else "l2")
        noise = self.next_covins_g_noise(len(q_rig) * len(c_rig), n_hyp5,
                                         mp_q.max_features, params["n_hyp17"],
                                         params["n_cov"])
        cam_q = self._camera_of(mp_q, int(mp_q.kf_ids[q_row, 1]))
        cam_c = self._camera_of(mp_c, int(mp_c.kf_ids[c_row, 1]))
        job = loopverify.dispatch_covinsg_verify(rq, rc, cam_q, cam_c, params, noise)
        self.n_dispatched += 1
        # the candidate's pose, for the host's yaw/translation gate
        return {"T_w_s_cand": mp_c.kf_pose[c_row].copy()}, job

    def finalize_covins_g(self, job):
        """ONE fetch of a dispatched COVINS-G verification, then the yaw
        and translation gate (`placerec_gen_be.cpp:156-167`): the relative
        yaw between the candidate and the loop-corrected query, and the
        loop translation.  Returns (T_12, n_inliers, cov (6, 6)) or None."""
        cfg = self.cfg
        meta, dev_job = job
        out = loopverify.fetch_covinsg_verify(dev_job)
        if not out["ok"]:
            return None
        T_12, cov = out["T_12"], out["cov"]
        T_21 = npgeo.pose_inverse(T_12)  # T_smatch_squery
        T_w_s_cand = meta["T_w_s_cand"]

        def yaw_of(q):
            R = npgeo.quat_to_matrix(np.asarray(q))
            return math.atan2(R[1, 0], R[0, 0])  # ZYX yaw

        yaw_match = yaw_of(T_w_s_cand[:4])
        yaw_query = yaw_of(npgeo.pose_compose(T_w_s_cand, T_21)[:4])
        rel_yaw = math.degrees(
            (yaw_query - yaw_match + math.pi) % (2 * math.pi) - math.pi)
        trans = float(np.linalg.norm(T_21[4:7]))
        if abs(rel_yaw) > cfg.max_yaw or trans > cfg.max_trans:
            return None
        return T_12, out["n_inliers"], cov

    def compute_se3_covins_g(self, mp_q, q_row: int, mp_c, c_row: int):
        """Dispatch + finalize in one call: (T_12, n_inliers, cov) or
        None."""
        job = self.dispatch_verify_covins_g(mp_q, q_row, mp_c, c_row)
        return None if job is None else self.finalize_covins_g(job)

    def dispatch_verify(self, mp_q, q_row: int, mp_c, c_row: int):
        """Verification kickoff of the window-batched drain, in the
        configured mode; an opaque job or None."""
        if self.cfg.placerec_type == "COVINS_G":
            job = self.dispatch_verify_covins_g(mp_q, q_row, mp_c, c_row)
            return None if job is None else ("g", job)
        job = self.dispatch_verify_covins(mp_q, q_row, mp_c, c_row)
        return None if job is None else ("covins", job)

    def finalize_verify(self, tagged):
        """Fetch one dispatched verification: (T_12, n_inliers, cov,
        matches) or None."""
        kind, job = tagged
        if kind == "g":
            got = self.finalize_covins_g(job)
            return None if got is None else (*got, None)
        got = loopverify.finalize_covins_verify(job)
        if got is None:
            return None
        T_12, n_inl, pairs = got
        return T_12, n_inl, None, pairs

    # --------------------------------------------------------------- pipeline
    def process_keyframe(self, mp, kf_row: int,
                         pre: Optional[dict] = None) -> Optional[LoopResult]:
        """The Run() body (`placerec_be.cpp:508-537`): detect -> compute ->
        a LoopResult (applied by the MapManager), and ALWAYS add the query
        to the database (already done when ``pre`` is supplied)."""
        cfg = self.cfg
        kf_id = tuple(mp.kf_ids[kf_row])
        result = None
        if cfg.placerec_active:
            for cand_id in self.detect_loop(mp, kf_row, pre=pre):
                mp_c, c_row = self.resolve(cand_id)
                if mp_c is None:
                    continue
                if cfg.placerec_type == "COVINS_G":
                    got = self.compute_se3_covins_g(mp, kf_row, mp_c, c_row)
                    got = None if got is None else (*got, None)
                else:
                    got = self.compute_se3_covins(mp, kf_row, mp_c, c_row)
                    got = None if got is None else (got[0], got[1], None, got[2])
                if got is None:
                    continue
                T_12, n_inl, cov, matches = got
                self.last_loop_kf_id = kf_id[0]
                result = LoopResult(query_id=kf_id, candidate_id=cand_id,
                                    T_12=T_12, n_inliers=n_inl, cov=cov,
                                    matches=matches)
                break
        if pre is None:
            n_feat = int(mp.kf_n_feat[kf_row])
            if n_feat > 0:
                self.db.add_keyframe(kf_id, mp.pr_descriptors(kf_row)[:n_feat])
        return result
