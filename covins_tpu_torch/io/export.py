"""Headless visualization export.

Replaces the reference's RViz visualizer (`Visualizer::DrawMap` +
`PubCovGraph/PubKeyframesAsFrusta/PubLandmarksAsCloud/PubTrajectories/
PubLoopEdges`, `covins_backend/src/covins_backend/visualization_be.cpp`)
with a JSON snapshot of the same content — per-agent trajectories,
covisibility edges above the weight threshold, loop edges (intra/inter),
and the landmark cloud — consumable by any plotting front-end (the
reference's 12 per-agent colors ride along, `config_backend.hpp:62-90`).
Counterpart of `covins_tpu/io/export.py`, writing the same JSON; the
covisibility edges are counted on the map's device
(`ops/covisibility.py`).
"""

from __future__ import annotations

import json

import numpy as np
import torch

from covins_tpu_torch.ops import covisibility as cov_ops

# the reference's 12 per-agent colors (config_backend.hpp:62-90 defaults)
AGENT_COLORS = [
    [0.00, 0.45, 0.74], [0.85, 0.33, 0.10], [0.93, 0.69, 0.13],
    [0.49, 0.18, 0.56], [0.47, 0.67, 0.19], [0.30, 0.75, 0.93],
    [0.64, 0.08, 0.18], [1.00, 0.00, 1.00], [0.00, 1.00, 0.00],
    [0.00, 0.00, 1.00], [1.00, 0.00, 0.00], [0.00, 1.00, 1.00],
]


def map_snapshot(mp, covis_thres: int = 10, max_landmarks: int = 20000) -> dict:
    """Build a serializable VisBundle-equivalent of one map."""
    snap: dict = {"map_id": mp.id, "agents": {}, "loops": [], "landmarks": []}
    for cid in sorted(mp.associated_clients):
        rows = mp.live_kf_rows(cid)
        rows = rows[np.argsort(mp.kf_stamp[rows])]
        snap["agents"][str(cid)] = {
            "color": AGENT_COLORS[cid % len(AGENT_COLORS)],
            "stamps": mp.kf_stamp[rows].tolist(),
            "poses": mp.kf_pose[rows].tolist(),
        }
    # covisibility edges above threshold
    edges = []
    live = mp.live_kf_rows()
    if mp.n_obs > 0 and len(live) > 1:
        o, dev = mp.n_obs, mp.device
        w = cov_ops.covis_weights_batch(
            torch.from_numpy(live.astype(np.int32)).to(dev),
            torch.from_numpy(mp.obs_kf[:o].copy()).to(dev),
            torch.from_numpy(mp.obs_lm[:o].copy()).to(dev),
            torch.from_numpy(mp.obs_mask[:o].copy()).to(dev),
            n_kf=mp.n_kf, n_lm=max(mp.n_lm, 1),
        ).cpu().numpy()
        for i, r in enumerate(live):
            for c in np.where(w[i] >= covis_thres)[0]:
                if c > r:
                    edges.append([int(r), int(c), int(w[i][c])])
    snap["covis_edges"] = edges
    for lc in mp.loops:
        inter = mp.kf_ids[lc["kf1"], 1] != mp.kf_ids[lc["kf2"], 1]
        snap["loops"].append({
            "kf1": int(lc["kf1"]), "kf2": int(lc["kf2"]),
            "inter_agent": bool(inter),
            # endpoint positions so plotters need no row->pose join
            "p1": mp.kf_pose[lc["kf1"], 4:7].round(4).tolist(),
            "p2": mp.kf_pose[lc["kf2"], 4:7].round(4).tolist(),
        })
    lms = np.where(mp.lm_mask[: mp.n_lm])[0][:max_landmarks]
    snap["landmarks"] = mp.lm_pos[lms].round(4).tolist()
    return snap


def write_snapshot(mp, path: str, covis_thres: int = 10):
    with open(path, "w") as fh:
        json.dump(map_snapshot(mp, covis_thres), fh)
