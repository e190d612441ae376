"""Typed configuration with the reference's parameter vocabulary.

Replaces the reference's static-init OpenCV-FileStorage globals
(`covins_backend/src/covins_base/config_backend.cpp`,
`covins_comm/src/covins_base/config_comm.cpp`): explicit construction, an
explicit file path, CLI overrides — but the SAME parameter names
(`config_backend.yaml`, `config_comm.yaml`) so reference configs carry
over.  The YAML subset used by those files is flat ``ns.key: value`` pairs,
parsed here without an external YAML dependency.
"""

from __future__ import annotations

import dataclasses
from typing import Any, ClassVar, Dict, Optional


def parse_flat_yaml(path: str) -> Dict[str, Any]:
    """Parse the flat `ns.key: value` YAML subset the reference uses."""
    out: Dict[str, Any] = {}
    with open(path) as fh:
        for line in fh:
            line = line.split("#", 1)[0].strip()
            if not line or line.startswith("%") or ":" not in line:
                continue
            key, val = line.split(":", 1)
            key, val = key.strip(), val.strip()
            if not val:
                continue
            if val.startswith(("'", '"')):
                out[key] = val.strip("'\"")
                continue
            try:
                out[key] = int(val)
            except ValueError:
                try:
                    out[key] = float(val)
                except ValueError:
                    out[key] = val
    return out


@dataclasses.dataclass
class Config:
    """Backend + comm configuration (defaults = reference defaults,
    `config_backend.yaml` / `config_comm.yaml`)."""

    # --- sys ---
    threads_server: int = 8
    covis_thres: int = 10
    trajectory_format: str = "TUM"
    output_dir: str = "output"
    map_path0: str = ""

    # --- features ---
    feat_type: str = "ORB"
    desc_length: int = 32

    # --- matcher (COVINS) ---
    desc_matching_th_low: float = 50.0
    desc_matching_th_high: float = 100.0
    search_radius_SE3: float = 9.5
    search_radius_proj: float = 10.0
    search_radius_fuse: float = 10.0

    # --- matcher (COVINS-G) ---
    img_match_thres: float = 40.0
    ratio_thres: float = 0.8

    # --- mapping ---
    activate_lm_culling: bool = True
    kf_culling_th_red: float = 0.95
    kf_culling_max_time_dist: float = 1.0

    # --- placerec ---
    placerec_active: bool = True
    placerec_type: str = "COVINS"  # {COVINS | COVINS_G}
    # run detection/verification deferred (drained when the server worker
    # is idle) instead of inline with ingest — the reference's dedicated
    # PlaceRecognition thread (`placerec_be.cpp:508-537`); inline default
    # keeps library/test call sites synchronous
    placerec_defer: bool = False
    start_after_kf: int = 7
    consecutive_loop_dist: int = 10
    min_loop_dist: int = 100
    cov_consistency_thres: int = 3
    matches_thres: int = 25
    matches_thres_merge: int = 25
    exclude_kfs_with_id_less_than: int = 7
    inter_map_matches_only: bool = False
    inliers_thres: int = 20
    total_matches_thres: int = 40
    # RANSAC (COVINS)
    ransac_min_inliers: int = 6
    ransac_probability: float = 0.99
    ransac_max_iterations: int = 300
    ransac_class_threshold: float = 25.0
    # 17pt (COVINS-G)
    nc_rp_error: float = 1.5
    nc_rp_error_cov: float = 10.0
    nc_min_inliers: int = 100
    nc_max_iters: int = 4000
    nc_cov_thres: float = 10.0
    nc_cov_iters: int = 30
    nc_cov_max_iters: int = 300
    # 5pt (COVINS-G)
    rel_error_thres: float = 16.0
    rel_min_inliers: int = 20
    rel_max_iters: int = 200
    rel_min_img_matches: int = 20
    # minimal solver for the per-pair central prefilter: "5pt" (Nister,
    # matches the reference's STEWENIUS minimal sample — more robust at
    # high outlier ratios) or "8pt" (linear — cheaper per hypothesis)
    rel_minimal_solver: str = "5pt"
    max_yaw: float = 50.0  # degrees
    max_trans: float = 2.0  # meters

    # --- opt ---
    gba_iteration_limit: int = 10
    th_outlier_align: float = 1.3
    th_gba_outlier_global: float = 0.92
    pgo_iteration_limit: int = 10
    perform_pgo: bool = True
    use_nbr_kfs: bool = True
    use_robust_loss: bool = True
    robust_loss_threshold: float = 0.5
    pgo_fix_kfs_after_gba: bool = True
    wt_kf_R: float = 10.0
    wt_kf_T: float = 1.0
    wt_kf_n1: float = 10.0
    wt_kf_n23: float = 2.0
    wt_kf_n45: float = 3.0

    # --- comm (config_comm.yaml) ---
    server_ip: str = "127.0.0.1"
    port: int = 9871
    send_updates: bool = False
    data_to_client: bool = False
    start_sending_after_kf: int = 50
    kf_buffer_withold: int = 5
    max_sent_kfs_per_iteration: int = 2
    update_window_size: int = 5
    to_agent_freq: float = 1.0

    # --- vocabulary / retrieval ---
    vocab_words: int = 512
    retrieval_topk: int = 10

    # --- vis (reference `vis.active`, `visualization_be.cpp:46-61`) ---
    vis_active: bool = False
    vis_snapshot_interval_kf: int = 50

    _YAML_MAP: ClassVar[Dict[str, Any]] = {
        "sys.threads_server": "threads_server",
        "sys.covis_thres": "covis_thres",
        "sys.trajectory_format": "trajectory_format",
        "sys.map_path0": "map_path0",
        "feat.type": "feat_type",
        "feat.desc_length": "desc_length",
        "extractor.img_match_thres": "img_match_thres",
        "extractor.ratio_thres": "ratio_thres",
        "matcher.desc_matching_th_low": "desc_matching_th_low",
        "matcher.desc_matching_th_high": "desc_matching_th_high",
        "matcher.search_radius_SE3": "search_radius_SE3",
        "matcher.search_radius_proj": "search_radius_proj",
        "matcher.search_radius_fuse": "search_radius_fuse",
        "mapping.activate_lm_culling": "activate_lm_culling",
        "mapping.kf_culling_th_red": "kf_culling_th_red",
        "mapping.kf_culling_max_time_dist": "kf_culling_max_time_dist",
        "vis.active": "vis_active",
        "vis.snapshot_interval_kf": "vis_snapshot_interval_kf",
        "placerec.active": "placerec_active",
        "placerec.type": "placerec_type",
        "placerec.defer": "placerec_defer",
        "placerec.start_after_kf": "start_after_kf",
        "placerec.consecutive_loop_dist": "consecutive_loop_dist",
        "placerec.min_loop_dist": "min_loop_dist",
        "placerec.cov_consistency_thres": "cov_consistency_thres",
        "placerec.matches_thres": "matches_thres",
        "placerec.matches_thres_merge": "matches_thres_merge",
        "placerec.exclude_kfs_with_id_less_than": "exclude_kfs_with_id_less_than",
        "placerec.inter_map_matches_only": "inter_map_matches_only",
        "placerec.inliers_thres": "inliers_thres",
        "placerec.total_matches_thres": "total_matches_thres",
        "placerec.ransac.min_inliers": "ransac_min_inliers",
        "placerec.ransac.probability": "ransac_probability",
        "placerec.ransac.max_iterations": "ransac_max_iterations",
        "placerec.ransac.class_threshold": "ransac_class_threshold",
        "placerec.nc_rel_pose.rp_error": "nc_rp_error",
        "placerec.nc_rel_pose.rp_error_cov": "nc_rp_error_cov",
        "placerec.nc_rel_pose.min_inliers": "nc_min_inliers",
        "placerec.nc_rel_pose.max_iters": "nc_max_iters",
        "placerec.nc_rel_pose.cov_thres": "nc_cov_thres",
        "placerec.nc_rel_pose.cov_iters": "nc_cov_iters",
        "placerec.nc_rel_pose.cov_max_iters": "nc_cov_max_iters",
        "placerec.rel_pose.error_thres": "rel_error_thres",
        "placerec.rel_pose.min_inliers": "rel_min_inliers",
        "placerec.rel_pose.max_iters": "rel_max_iters",
        "placerec.rel_pose.min_img_matches": "rel_min_img_matches",
        "placerec.rel_pose.minimal_solver": "rel_minimal_solver",
        "placerec.max_yaw": "max_yaw",
        "placerec.max_trans": "max_trans",
        "opt.gba_iteration_limit": "gba_iteration_limit",
        "opt.th_outlier_align": "th_outlier_align",
        "opt.th_gba_outlier_global": "th_gba_outlier_global",
        "opt.pgo_iteration_limit": "pgo_iteration_limit",
        "opt.perform_pgo": "perform_pgo",
        "opt.use_nbr_kfs": "use_nbr_kfs",
        "opt.use_robust_loss": "use_robust_loss",
        "opt.robust_loss_threshold": "robust_loss_threshold",
        "opt.pgo_fix_kfs_after_gba": "pgo_fix_kfs_after_gba",
        "opt.wt_kf_R": "wt_kf_R",
        "opt.wt_kf_T": "wt_kf_T",
        "opt.wt_kf_n1": "wt_kf_n1",
        "opt.wt_kf_n23": "wt_kf_n23",
        "opt.wt_kf_n45": "wt_kf_n45",
        "sys.server_ip": "server_ip",
        "sys.port": "port",
        "comm.send_updates": "send_updates",
        "comm.data_to_client": "data_to_client",
        "comm.start_sending_after_kf": "start_sending_after_kf",
        "comm.kf_buffer_withold": "kf_buffer_withold",
        "comm.max_sent_kfs_per_iteration": "max_sent_kfs_per_iteration",
        "comm.update_window_size": "update_window_size",
        "comm.to_agent_freq": "to_agent_freq",
        "orb.imu_stamp_max_diff": None,  # agent-side only
    }

    @classmethod
    def from_yaml(cls, *paths: str, **overrides) -> "Config":
        cfg = cls()
        for path in paths:
            raw = parse_flat_yaml(path)
            for yk, val in raw.items():
                attr = cls._YAML_MAP.get(yk)
                if attr is None:
                    continue
                cur = getattr(cfg, attr)
                if isinstance(cur, bool):
                    val = bool(val)
                setattr(cfg, attr, val)
        for k, v in overrides.items():
            if not hasattr(cfg, k):
                raise KeyError(f"unknown config key {k}")
            setattr(cfg, k, v)
        return cfg
