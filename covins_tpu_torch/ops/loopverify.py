"""Five-stage COVINS loop verification (`ComputeSE3`,
`placerec_be.cpp:63-220`) in two phases.

Counterpart of the COVINS path of `covins_tpu/ops/loopverify.py`:

1. stage 1, mutual-NN descriptor matching of the two keyframes'
   landmark-tied observations (K4);
2. stage 2, P3P RANSAC of the query bearings against the candidate's
   world points (batched solves + K6 scoring);
3. stage 3, `SearchBySE3` match extension through the estimate (K5);
4. stage 4, relative-pose GN refinement with the `inliers_thres` gate;
5. stage 5, projection of the candidate's loop neighbourhood into the
   query (K5) with the `total_matches_thres` gate.

Host protocol, as in the reference::

    job = dispatch_covins_verify(...)   # host gather, one upload per dtype,
                                        # every stage queued; no host sync
    out = finalize_covins_verify(job)   # ONE device-to-host copy

Stages 1-4 run at the map's feature capacity (the observation lists are
padded to ``max_features``), as in the reference; the reference's
power-of-two padding of the neighbourhood existed for XLA compile
stability and is dropped.  Row order of every list is kept: ties in stage
1 and in the conflict pass go to the lowest row.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from covins_tpu_torch.ops import descriptors as d_ops
from covins_tpu_torch.ops import pnp, relpose
from covins_tpu_torch.ops.projmatch import project_match_core
from covins_tpu_torch.utils import cameras as cam_mod
from covins_tpu_torch.utils import geometry as geo
from covins_tpu_torch.utils import npgeo


def covins_stage14(
    cam_q: cam_mod.Camera, cam_c: cam_mod.Camera,
    q_obs_desc, q_obs_uv, q_obs_feat, q_obs_lm_body, q_obs_valid,
    c_obs_desc, c_obs_valid,
    c_lm_w, c_lm_body, c_lm_desc, c_lm_normal, c_lm_rng, c_lm_alive, c_lm_row,
    kp_uv, kp_desc, kp_oct, kp_valid, q_feat_lm_body, q_feat_has_lm,
    T_wc_sc,
    min_matches, desc_max_dist, thr2_rad, ransac_min_inliers,
    radius_se3, img_w, img_h, inliers_thres, th_outlier_align,
    n_hyp: int = 256, noise=None, idx=None,
):
    """Stages 1-4 (`_covins_stage14_body`): matching, P3P RANSAC,
    SearchBySE3 extension, GN refinement.  The stage-2 minimal sets come
    from ``noise`` (n_hyp, Q) Gumbel noise, or from ``idx`` (n_hyp, 3)."""
    F = kp_uv.shape[0]
    C = c_lm_w.shape[0]

    # stage 1: brute-force matching over the two observation lists
    midx = d_ops.hamming_mutual_nn(q_obs_desc, q_obs_valid, c_obs_desc,
                                   c_obs_valid, desc_max_dist)  # (Q,)
    matched = (midx >= 0) & q_obs_valid
    n_matched = torch.sum(matched)
    midx_c = torch.clamp(midx, 0, C - 1).long()

    # stage 2: P3P RANSAC, query bearings vs candidate-world points
    bear_q = cam_mod.back_project3(cam_q, q_obs_uv)
    out2 = pnp.absolute_pose_ransac(c_lm_w[midx_c], bear_q, matched,
                                    n_hypotheses=n_hyp, threshold_rad=thr2_rad,
                                    noise=noise, idx=idx)
    n_inl2 = out2["n_inliers"]
    T_wc_cq = geo.pose_inverse(out2["T_c_w"])
    T_wc_sq = geo.pose_compose(T_wc_cq, geo.pose_inverse(cam_q.T_s_c))
    T_12_est = geo.pose_compose(geo.pose_inverse(T_wc_sq), T_wc_sc)

    # stage 3: SearchBySE3 match extension through the estimate
    m32 = matched.to(torch.int32)
    taken_q = torch.zeros(F, dtype=torch.int32, device=kp_uv.device).scatter_reduce(
        0, q_obs_feat, m32, reduce="amax") > 0
    c_already = torch.zeros(C, dtype=torch.int32, device=kp_uv.device).scatter_reduce(
        0, midx_c, m32, reduce="amax") > 0
    T_cqw = geo.pose_compose(geo.pose_inverse(cam_q.T_s_c),
                             geo.pose_inverse(T_wc_sq))
    mfeat, _ = project_match_core(
        cam_q, T_cqw, c_lm_w, c_lm_desc, c_lm_normal,
        c_obs_valid & ~c_already & c_lm_alive, c_lm_rng,
        kp_uv, kp_desc, kp_oct, kp_valid & ~taken_q,
        radius_se3, desc_max_dist, img_w, img_h, check_view_angle=False)
    ext = mfeat >= 0  # (C,)

    # stage 4: GN refinement on 3D-3D pairs with both-side landmarks
    mfeat_c = torch.clamp(mfeat, 0, F - 1).long()
    p1 = torch.cat([q_obs_lm_body, q_feat_lm_body[mfeat_c]])
    p2 = torch.cat([c_lm_body[midx_c], c_lm_body])
    m4 = torch.cat([matched, ext & q_feat_has_lm[mfeat_c]])
    T_12, _, n_inl4 = relpose.optimize_relative_pose(
        cam_q, cam_c, T_12_est, p1, p2, m4, th_outlier=th_outlier_align)

    # what stage 5 consumes: landmark rows already paired, features taken
    pair_crow = torch.cat([torch.where(matched, c_lm_row[midx_c], -1),
                           torch.where(ext, c_lm_row, -1)])
    taken_q5 = taken_q | (torch.zeros(F, dtype=torch.int32, device=kp_uv.device)
                          .scatter_reduce(0, mfeat_c, ext.to(torch.int32),
                                          reduce="amax") > 0)
    ok14 = ((n_matched >= min_matches) & (n_inl2 >= ransac_min_inliers)
            & (n_inl4 >= inliers_thres))
    return {
        "ok14": ok14, "T_12": T_12,
        "n_matched": n_matched, "n_inl2": n_inl2, "n_inl4": n_inl4,
        "n_ext": torch.sum(ext), "midx": midx, "mfeat": mfeat,
        "pair_crow": pair_crow, "taken_q5": taken_q5,
    }


def covins_stage5(
    cam_q: cam_mod.Camera, T_12, T_wc_sc, ok14, n_base, pair_crow, taken_q5,
    hood_lm_w, hood_desc, hood_normal, hood_rng, hood_alive, hood_lm_row,
    kp_uv, kp_desc, kp_oct, kp_valid,
    desc_max_dist, radius_proj, img_w, img_h, total_matches_thres,
):
    """Stage 5 (`_covins_stage5_body`): loop-neighbourhood projection and
    the total-match gate."""
    T_wc_sq_corr = geo.pose_compose(T_wc_sc, geo.pose_inverse(T_12))
    T_cqw_corr = geo.pose_compose(geo.pose_inverse(cam_q.T_s_c),
                                  geo.pose_inverse(T_wc_sq_corr))
    hood_in_pairs = torch.isin(hood_lm_row, pair_crow)
    hfeat, _ = project_match_core(
        cam_q, T_cqw_corr, hood_lm_w, hood_desc, hood_normal,
        hood_alive & ~hood_in_pairs, hood_rng,
        kp_uv, kp_desc, kp_oct, kp_valid & ~taken_q5,
        radius_proj, desc_max_dist, img_w, img_h, check_view_angle=True)
    n_total = n_base + torch.sum(hfeat >= 0)
    return {"ok": ok14 & (n_total >= total_matches_thres),
            "n_total": n_total, "hfeat": hfeat}


def _pad_rows(a: np.ndarray, n_rows: int):
    out = np.zeros((n_rows,) + a.shape[1:], a.dtype)
    out[: a.shape[0]] = a
    return out


def upload(arrays: dict, device: torch.device) -> dict:
    """numpy arrays -> tensors on ``device``.  For the card, the arrays of
    each dtype are packed into one pinned buffer and copied with
    ``non_blocking`` (one copy per dtype; a pageable copy would wait for
    the work already queued on the stream)."""
    if device.type == "cpu":
        return {k: torch.from_numpy(np.ascontiguousarray(a))
                for k, a in arrays.items()}
    groups: dict = {}
    for k, a in arrays.items():
        groups.setdefault(a.dtype, []).append((k, a))
    out = {}
    for items in groups.values():
        total = sum(a.size for _, a in items)
        host = torch.empty(total, dtype=torch.from_numpy(items[0][1][:0]).dtype,
                           pin_memory=True)
        view = host.numpy()
        o, spans = 0, []
        for k, a in items:
            view[o:o + a.size] = a.reshape(-1)
            spans.append((k, o, a.shape))
            o += a.size
        dev = host.to(device, non_blocking=True)
        for k, o, shape in spans:
            out[k] = dev[o:o + int(np.prod(shape, dtype=np.int64))].view(shape)
    return out


def dispatch_covins_verify(mp_q, q_row: int, mp_c, c_row: int, cfg,
                           cam_q: cam_mod.Camera, cam_c: cam_mod.Camera,
                           noise: Optional[np.ndarray] = None,
                           idx: Optional[np.ndarray] = None):
    """Host gather and the queued device work of the five stages (no host
    sync).  ``noise`` is the (n_hyp, max_features) stage-2 Gumbel draw;
    ``idx`` (n_hyp, 3) index sets replace it.

    Returns an opaque job, or None when a host precondition fails (fewer
    than 3 landmark observations on either side, `placerec_be.cpp:75-82`).
    Pass the job to :func:`finalize_covins_verify`.
    """
    def kf_landmarks(mp, row):
        o = mp.n_obs
        sel = (mp.obs_kf[:o] == row) & mp.obs_mask[:o]
        return mp.obs_lm[:o][sel], mp.obs_feat[:o][sel]

    q_lms, q_feats = kf_landmarks(mp_q, q_row)
    c_lms, c_feats = kf_landmarks(mp_c, c_row)
    if len(q_lms) < 3 or len(c_lms) < 3:
        return None
    thres = cfg.matches_thres if mp_q is mp_c else cfg.matches_thres_merge
    F, Fc = mp_q.max_features, mp_c.max_features
    calib_q = mp_q.calib[int(mp_q.kf_ids[q_row, 1])]
    focal = float(calib_q.intrinsics[0])

    # body-frame landmark coordinates (host numpy)
    T_sq_w = npgeo.pose_inverse(mp_q.kf_pose[q_row])
    T_sc_w = npgeo.pose_inverse(mp_c.kf_pose[c_row])
    q_lm_body = npgeo.pose_apply(T_sq_w, mp_q.lm_pos[q_lms])
    c_lm_body = npgeo.pose_apply(T_sc_w, mp_c.lm_pos[c_lms])
    q_feat_lm = mp_q.kf_feat_lm[q_row]
    q_feat_has_lm = q_feat_lm >= 0
    q_feat_lm_body = npgeo.pose_apply(
        T_sq_w, mp_q.lm_pos[np.clip(q_feat_lm, 0, None)])
    q_feat_lm_body[~q_feat_has_lm] = 0.0

    # loop-neighbourhood landmarks (candidate covisibles + itself)
    covis_c = mp_c.covis_weights(c_row)
    nbr_rows = np.append(np.where(covis_c > 0)[0], c_row)
    o = mp_c.n_obs
    sel = np.isin(mp_c.obs_kf[:o], nbr_rows) & mp_c.obs_mask[:o]
    hood = np.setdiff1d(np.unique(mp_c.obs_lm[:o][sel]), c_lms).astype(np.int64)

    nq, nc = len(q_feats), len(c_lms)
    qp = _pad_rows(q_feats.astype(np.int64), F)
    cp = _pad_rows(c_lms.astype(np.int64), Fc)
    cfp = _pad_rows(c_feats.astype(np.int64), Fc)
    q_valid = np.arange(F) < nq
    c_valid = np.arange(Fc) < nc
    n_hyp = min(cfg.ransac_max_iterations, 512)
    arrays = {
        "q_obs_uv": mp_q.kp_uv[q_row, qp].astype(np.float64),
        "q_obs_lm_body": _pad_rows(q_lm_body, F),
        "c_lm_w": mp_c.lm_pos[cp], "c_lm_body": _pad_rows(c_lm_body, Fc),
        "c_lm_normal": mp_c.lm_normal[cp], "c_lm_rng": mp_c.lm_dist_rng[cp],
        "kp_uv": mp_q.kp_uv[q_row].astype(np.float64),
        "kp_oct": mp_q.kp_aors[q_row, :, 1].astype(np.float64),
        "q_feat_lm_body": q_feat_lm_body, "T_wc_sc": mp_c.kf_pose[c_row].copy(),
        "hood_lm_w": mp_c.lm_pos[hood], "hood_normal": mp_c.lm_normal[hood],
        "hood_rng": mp_c.lm_dist_rng[hood],
        "q_obs_desc": mp_q.descriptors[q_row, qp],
        "c_obs_desc": mp_c.descriptors[c_row, cfp],
        "c_lm_desc": mp_c.lm_desc[cp], "kp_desc": mp_q.descriptors[q_row].copy(),
        "hood_desc": mp_c.lm_desc[hood],
        "q_obs_feat": qp, "c_lm_row": cp, "hood_lm_row": hood,
        "q_obs_valid": q_valid, "c_obs_valid": c_valid,
        "c_lm_alive": mp_c.lm_mask[cp] & c_valid,
        "kp_valid": np.arange(F) < int(mp_q.kf_n_feat[q_row]),
        "q_feat_has_lm": q_feat_has_lm.copy(), "hood_alive": mp_c.lm_mask[hood],
    }
    if idx is not None:
        arrays["idx"] = np.asarray(idx, np.int64)[:n_hyp]
    else:
        arrays["noise"] = np.asarray(noise, np.float64)[:n_hyp]
    t = upload(arrays, cam_q.intrinsics.device)
    img_w, img_h = float(calib_q.img_w), float(calib_q.img_h)
    desc_max_dist = float(cfg.desc_matching_th_low)

    out14 = covins_stage14(
        cam_q, cam_c,
        t["q_obs_desc"], t["q_obs_uv"], t["q_obs_feat"], t["q_obs_lm_body"],
        t["q_obs_valid"], t["c_obs_desc"], t["c_obs_valid"],
        t["c_lm_w"], t["c_lm_body"], t["c_lm_desc"], t["c_lm_normal"],
        t["c_lm_rng"], t["c_lm_alive"], t["c_lm_row"],
        t["kp_uv"], t["kp_desc"], t["kp_oct"], t["kp_valid"],
        t["q_feat_lm_body"], t["q_feat_has_lm"], t["T_wc_sc"],
        min_matches=min(thres, 8), desc_max_dist=desc_max_dist,
        thr2_rad=float(np.arctan2(cfg.ransac_class_threshold, focal)),
        ransac_min_inliers=cfg.ransac_min_inliers,
        radius_se3=float(cfg.search_radius_SE3), img_w=img_w, img_h=img_h,
        inliers_thres=cfg.inliers_thres,
        th_outlier_align=float(cfg.th_outlier_align),
        n_hyp=n_hyp, noise=t.get("noise"), idx=t.get("idx"))
    out5 = covins_stage5(
        cam_q, out14["T_12"], t["T_wc_sc"], out14["ok14"],
        out14["n_matched"] + out14["n_ext"], out14["pair_crow"],
        out14["taken_q5"], t["hood_lm_w"], t["hood_desc"], t["hood_normal"],
        t["hood_rng"], t["hood_alive"], t["hood_lm_row"],
        t["kp_uv"], t["kp_desc"], t["kp_oct"], t["kp_valid"],
        desc_max_dist=desc_max_dist, radius_proj=float(cfg.search_radius_proj),
        img_w=img_w, img_h=img_h, total_matches_thres=cfg.total_matches_thres)
    # one packed result (float64 holds every count and index exactly)
    f64 = torch.float64
    packed = torch.cat([
        out14["T_12"].to(f64),
        torch.stack([out5["ok"].to(f64), out14["n_matched"].to(f64),
                     out14["n_inl2"].to(f64), out14["n_inl4"].to(f64),
                     out5["n_total"].to(f64)]),
        out14["midx"].to(f64), out14["mfeat"].to(f64), out5["hfeat"].to(f64)])
    meta = {"q_feats": q_feats, "c_lms": c_lms, "hood": hood,
            "Q": F, "C": Fc, "nq": nq, "nc": nc}
    return meta, packed


def fetch_covins_verify(job) -> dict:
    """ONE device-to-host copy of a dispatched verification: ``ok``, the
    counts, ``T_12`` and the per-row results ``midx`` (Q,), ``mfeat`` (C,)
    and ``hfeat`` (H,) as numpy."""
    meta, packed = job
    vals = packed.cpu().numpy()
    Q, C = meta["Q"], meta["C"]
    ints = vals[12:].astype(np.int64)
    return {"T_12": vals[:7].copy(), "ok": bool(vals[7]),
            "n_matched": int(vals[8]), "n_inl2": int(vals[9]),
            "n_inl4": int(vals[10]), "n_total": int(vals[11]),
            "midx": ints[:Q], "mfeat": ints[Q:Q + C], "hfeat": ints[Q + C:]}


def finalize_covins_verify(job) -> Optional[tuple]:
    """Fetch one verification (:func:`fetch_covins_verify`); returns
    (T_12, n_inliers, pairs (M, 2) int32) or None.  Pair rows are (query
    feature, candidate-map landmark row), the reference's
    mvpCurrentMatchedPoints (`placerec_be.cpp:265-282`)."""
    if job is None:
        return None
    out = fetch_covins_verify(job)
    if not out["ok"]:
        return None
    meta = job[0]
    q_feats, c_lms, hood = meta["q_feats"], meta["c_lms"], meta["hood"]
    midx = out["midx"][: meta["nq"]]
    mfeat = out["mfeat"][: meta["nc"]]
    hfeat = out["hfeat"][: len(hood)]
    m = midx >= 0
    init_pairs = np.stack([q_feats[m], c_lms[np.clip(midx[m], 0, None)]], 1)
    e = np.where(mfeat >= 0)[0]
    ext_pairs = np.stack([mfeat[e], c_lms[e]], 1)
    h = np.where(hfeat >= 0)[0]
    hood_pairs = np.stack([hfeat[h], hood[h]], 1)
    pairs = np.concatenate([init_pairs, ext_pairs, hood_pairs]).astype(np.int32)
    return out["T_12"], out["n_inl4"], pairs
