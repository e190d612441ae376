"""Place recognition: loop detection and the COVINS loop verification.

Counterpart of the COVINS path of `covins_tpu/models/placerec.py`
(`placerec_be.cpp`: Run -> DetectLoop -> ComputeSE3, always
AddToDatabase).  Detection is host numpy over the retrieval scores
(exclusions, covisibility-group accumulation, consistency groups); each
surviving candidate is verified by `ops/loopverify.py` in two phases, so a
drained window dispatches all its verifications before it fetches any.

The stage-2 RANSAC draws come from one CPU `torch.Generator` per agent,
seeded as the reference seeds its key (``rng_seed + 1000 * client_id``),
so the card's run and the CPU's draw the same minimal sets.  COVINS-G
(`placerec_type="COVINS_G"`) belongs to a later slice of the port and
raises.

Pose convention: a loop result carries ``T_12 = T_sq_sc``, mapping
candidate-body coordinates into query-body coordinates.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from covins_tpu_torch.models.kf_database import KeyframeDatabase
from covins_tpu_torch.ops import loopverify, ransac
from covins_tpu_torch.utils import cameras as cam_mod
from covins_tpu_torch.utils.config import Config

COVINS_G_NOT_PORTED = (
    "COVINS-G place recognition (placerec_type='COVINS_G') belongs to the "
    "COVINS-G slice of covins_tpu_torch and is not ported yet; use "
    "placerec_type='COVINS' or placerec_active=False")


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
    if cfg.placerec_active and cfg.placerec_type != "COVINS":
        raise NotImplementedError(COVINS_G_NOT_PORTED)


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
        frac = 0.8  # COVINS (`placerec_be.cpp:386`)
        cand_rows = np.where(scores >= frac * min_score)[0]
        if len(cand_rows) == 0:
            self._consistent_groups = []
            return []

        # covisibility-group score accumulation (`kf_database.cpp:131-183`)
        def group_rows(cmp_, crow):
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

    def dispatch_verify(self, mp_q, q_row: int, mp_c, c_row: int):
        """Verification kickoff of the window-batched drain; an opaque job
        or None."""
        return self.dispatch_verify_covins(mp_q, q_row, mp_c, c_row)

    def finalize_verify(self, job):
        """Fetch one dispatched verification: (T_12, n_inliers, cov,
        matches) or None."""
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
                got = self.compute_se3_covins(mp, kf_row, mp_c, c_row)
                if got is None:
                    continue
                T_12, n_inl, matches = got
                self.last_loop_kf_id = kf_id[0]
                result = LoopResult(query_id=kf_id, candidate_id=cand_id,
                                    T_12=T_12, n_inliers=n_inl, matches=matches)
                break
        if pre is None:
            n_feat = int(mp.kf_n_feat[kf_row])
            if n_feat > 0:
                self.db.add_keyframe(kf_id, mp.pr_descriptors(kf_row)[:n_feat])
        return result
