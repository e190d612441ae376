"""Map manager: per-agent map registry, loop correction, map merging, the
pose-graph solve and global bundle adjustment.

Counterpart of `covins_tpu/models/map_manager.py` (`MapManager`,
`map_be.cpp:37-322`): one map per new agent, attachment of loaded maps, id
resolution across maps; an accepted loop inside one map fuses duplicated
landmarks, records the constraint and seeds the pose-graph solve with the
loop-corrected poses; a loop across maps merges the query's map into the
candidate's; :meth:`MapManager.run_gba` runs global visual-inertial
bundle adjustment on one map.  Host bookkeeping is numpy; the solves run
on the map's device (`ops/pgo.py`, `ops/gba.py`).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from covins_tpu_torch.device import DeviceLike, resolve_device
from covins_tpu_torch.models.kf_database import KeyframeDatabase
from covins_tpu_torch.models.map_store import Map
from covins_tpu_torch.models.placerec import LoopResult
from covins_tpu_torch.ops import gba as gba_mod
from covins_tpu_torch.ops import pgo as pgo_mod
from covins_tpu_torch.utils import npgeo
from covins_tpu_torch.utils.config import Config


class MapManager:
    def __init__(self, vocabulary: np.ndarray, config: Optional[Config] = None,
                 output_dir: Optional[str] = None, device: DeviceLike = None):
        self.cfg = config or Config()
        self.device = resolve_device(device)
        self.database = KeyframeDatabase(vocabulary, device=self.device)
        self.maps: Dict[int, Map] = {}
        self.map_of_client: Dict[int, int] = {}
        self._next_map_id = 0
        self.n_merges = 0
        self.n_loops = 0
        self.n_fused = 0  # landmarks deduplicated by loop fusion
        self.n_pgo = 0  # pose-graph solves run
        # map id -> PGO pose seed of loops applied with deferred PGO
        self.pending_pgo: Dict[int, Optional[np.ndarray]] = {}
        # when set, maps write trajectories every 50 KFs (`map_be.cpp:391-395`)
        self.output_dir = output_dir

    def _attach(self, mp: Map):
        if self.output_dir:
            mp.traj_dir = self.output_dir
            mp.traj_fmt = self.cfg.trajectory_format

    # ------------------------------------------------------------- registry
    def init_map(self, client_id: int) -> Map:
        """`MapManager::InitializeMap` — one fresh map per new agent."""
        mp = Map(
            self._next_map_id,
            desc_bytes=self.cfg.desc_length,
            desc_dtype=(np.float32 if self.cfg.feat_type == "SIFT" else np.uint8),
            device=self.device,
        )
        self._attach(mp)
        self.maps[mp.id] = mp
        self.map_of_client[client_id] = mp.id
        self._next_map_id += 1
        return mp

    def register_map(self, mp: Map):
        """`MapManager::RegisterMap` — attach a loaded map and index its
        keyframes into the retrieval database."""
        mp.id = self._next_map_id
        self._attach(mp)
        self._next_map_id += 1
        self.maps[mp.id] = mp
        for cid in mp.associated_clients:
            self.map_of_client[cid] = mp.id
        for row in mp.live_kf_rows():
            nf = int(mp.kf_n_feat[row])
            if nf > 0:
                kid = tuple(mp.kf_ids[row])
                self.database.add_keyframe(kid, mp.descriptors[row, :nf])

    def map_of(self, client_id: int) -> Map:
        return self.maps[self.map_of_client[client_id]]

    def resolve(self, kf_id: tuple) -> Tuple[Optional[Map], int]:
        """kf id -> (map, row) across all registered maps; the owning
        client's map is tried first."""
        mid = self.map_of_client.get(int(kf_id[1]))
        if mid is not None:
            mp = self.maps.get(mid)
            if mp is not None:
                row = mp.kf_row(kf_id)
                if row >= 0:
                    return mp, row
        for mp in self.maps.values():
            row = mp.kf_row(kf_id)
            if row >= 0:
                return mp, row
        return None, -1

    # ---------------------------------------------------------------- loops
    def handle_loop(self, loop: LoopResult, defer_pgo: bool = False) -> str:
        """`CorrectLoop` (`placerec_be.cpp:287-344`): same map -> fuse
        duplicated landmarks, add the constraint, seed PGO with corrected
        poses; different maps -> merge.  Returns 'loop' | 'merge' |
        'ignored'.  With ``defer_pgo`` the seed is kept in `pending_pgo`
        and :meth:`flush_pending_pgo` solves once per map at window end
        (the constraints accumulate in the map, so one solve over the final
        set replaces the intermediate ones)."""
        mp_q, q_row = self.resolve(loop.query_id)
        mp_c, c_row = self.resolve(loop.candidate_id)
        if mp_q is None or mp_c is None:
            return "ignored"
        if mp_q is mp_c:
            # duplicate-constraint guard (`placerec_be.cpp:295-305`)
            for lc in mp_q.loops:
                if {lc["kf1"], lc["kf2"]} == {q_row, c_row}:
                    return "ignored"
            # corrected poses BEFORE fusion so the deltas come from the
            # uncorrected state (`ConnectLoop`, `placerec_be.cpp:222-285`)
            corrected = self._corrected_poses(mp_q, q_row, c_row, loop.T_12)
            self._apply_fusion(mp_q, q_row, loop.matches)
            mp_q.add_loop_constraint(q_row, c_row, loop.T_12, cov=loop.cov)
            self.n_loops += 1
            if self.cfg.perform_pgo:
                if defer_pgo:
                    self.pending_pgo[mp_q.id] = corrected
                else:
                    self.run_pgo(mp_q, poses_init=corrected)
            return "loop"
        self.perform_merge(mp_q, q_row, mp_c, c_row, loop, defer_pgo=defer_pgo)
        return "merge"

    def flush_pending_pgo(self):
        """Run the deferred pose-graph solves, one per affected map."""
        pending, self.pending_pgo = self.pending_pgo, {}
        for mid, seed in pending.items():
            mp = self.maps.get(mid)
            if mp is None:
                continue  # merged away; the target map has its own entry
            if seed is not None and len(seed) != mp.n_kf:
                seed = None  # map grew or merged since the seed was taken
            self.run_pgo(mp, poses_init=seed)

    def _corrected_poses(self, mp: Map, q_row: int, c_row: int,
                         T_12: np.ndarray) -> np.ndarray:
        """Loop-corrected poses of the query, its covisible set and its
        successor chain (`ConnectLoop` + `Map::ApplyLoopCorrection`,
        `map_be.cpp:411-431`): the world-frame left delta the loop implies
        for the query, applied to all of them."""
        n = mp.n_kf
        poses = mp.kf_pose[:n].copy()
        T_w_sq_corr = npgeo.pose_compose(
            poses[c_row], npgeo.pose_inverse(np.asarray(T_12, np.float64)))
        delta = npgeo.pose_compose(T_w_sq_corr, npgeo.pose_inverse(poses[q_row]))
        rows = {int(q_row)}
        rows |= {int(r) for r in np.where(mp.covis_weights(q_row) > 0)[0]}
        r = int(mp.kf_succ[q_row])
        while r >= 0:
            rows.add(r)
            r = int(mp.kf_succ[r])
        rows = np.asarray(sorted(rows), np.int64)
        poses[rows] = npgeo.pose_compose(delta[None], poses[rows])
        return poses

    def _apply_fusion(self, mp: Map, q_row: int, matches: Optional[np.ndarray]):
        """Landmark fusion for the verified loop matches
        (`placerec_be.cpp:265-282`): the query's own landmark at a matched
        feature fuses into the loop landmark; a bare feature gains an
        observation of the loop landmark."""
        if matches is None or len(matches) == 0:
            return
        refreshed = []
        for feat, c_lm in np.asarray(matches, np.int64):
            feat, c_lm = int(feat), int(c_lm)
            if not mp.lm_mask[c_lm]:
                continue
            q_lm = int(mp.kf_feat_lm[q_row, feat])
            if q_lm == c_lm:
                continue
            if q_lm >= 0:
                if mp.fuse_landmark(target=c_lm, tofuse=q_lm):
                    self.n_fused += 1
            else:
                if q_row in set(int(k) for k in mp.observing_kfs(c_lm)):
                    continue
                mp.add_observation(q_row, c_lm, feat)
            refreshed.append(c_lm)
        if refreshed:
            mp.update_landmark_attributes(np.unique(np.asarray(refreshed)))

    def perform_merge(self, mp_q: Map, q_row: int, mp_c: Map, c_row: int,
                      loop: LoopResult, defer_pgo: bool = False):
        """`MapManager::PerformMerge` (`map_be.cpp:192-244`): fuse the
        query's map into the candidate's with
        ``T_wc_wq = T_wc_sc * T_12^-1 * T_sq_wq``."""
        T_wc_wq = npgeo.pose_compose(
            mp_c.kf_pose[c_row],
            npgeo.pose_compose(npgeo.pose_inverse(np.asarray(loop.T_12)),
                               npgeo.pose_inverse(mp_q.kf_pose[q_row])))
        kf_off = mp_c.n_kf
        mp_c.merge_from(mp_q, T_wc_wq)
        q_row_merged = q_row + kf_off
        # candidate-map landmark rows of the matches are unchanged by the
        # merge; the query's own moved with it (kf_feat_lm is re-indexed)
        self._apply_fusion(mp_c, q_row_merged, loop.matches)
        mp_c.add_loop_constraint(q_row_merged, c_row, loop.T_12, cov=loop.cov)
        for cid in list(mp_q.associated_clients):
            self.map_of_client[cid] = mp_c.id
        self.maps.pop(mp_q.id, None)
        self.pending_pgo.pop(mp_q.id, None)  # its seed no longer applies
        self.n_merges += 1
        self.n_loops += 1
        if self.cfg.perform_pgo:
            if defer_pgo:
                self.pending_pgo[mp_c.id] = None
            else:
                self.run_pgo(mp_c)

    # ------------------------------------------------------------------ PGO
    def run_pgo(self, mp: Map, poses_init: Optional[np.ndarray] = None):
        cfg = self.cfg
        g = mp.to_pose_graph(
            wt_kf_R=cfg.wt_kf_R, wt_kf_T=cfg.wt_kf_T,
            use_nbr_kfs=cfg.use_nbr_kfs,
            wt_kf_n1=cfg.wt_kf_n1, wt_kf_n23=cfg.wt_kf_n23,
            wt_kf_n45=cfg.wt_kf_n45,
            fix_optimized_kfs=cfg.pgo_fix_kfs_after_gba,
            poses_init=poses_init,
        )
        poses, _ = pgo_mod.optimize_pose_graph(
            g, n_gn=cfg.pgo_iteration_limit, n_cg=100,
            cauchy_scale=(cfg.robust_loss_threshold
                          if cfg.use_robust_loss else 0.0))
        mp.apply_pose_graph_result(poses.cpu().numpy())
        self.n_pgo += 1

    # ---------------------------------------------------------------- admin
    def run_gba(self, map_id: int, visual_only: bool = False,
                outlier_removal: bool = True,
                time_budget_s: Optional[float] = None) -> dict:
        """`CallbackGBA` (`backend.cpp:128-176`): global bundle adjustment
        of one map on its device, pruning whitened residuals above
        `th_gba_outlier_global` (`optimization_be.cpp:269-292`), then the
        write-back and, when observations were pruned, the landmark
        attribute refresh.  Returns the solver's info dict (``costs`` and
        ``round1_costs`` as numpy arrays, ``n_pruned``, ``time_budget_hit``
        when the budget cut the solve)."""
        mp = self.maps[map_id]
        p = mp.to_gba_problem()
        p2, info = gba_mod.global_bundle_adjustment(
            p, n_gn=self.cfg.gba_iteration_limit, n_cg=60,
            visual_only=visual_only, outlier_removal=outlier_removal,
            th_outlier=self.cfg.th_gba_outlier_global,
            time_budget_s=time_budget_s)
        mp.apply_gba_result(p2)
        if outlier_removal and info.get("n_pruned", 0) > 0:
            mp.update_landmark_attributes()
        return {k: (v.cpu().numpy() if hasattr(v, "cpu") else v)
                for k, v in info.items()}
