"""COVINS-G's verification past its first stage, worked out again from the
two rigs the program gathered.

Each rig keyframe's pixels are undistorted (radtan, fixed-point) into
camera-frame bearings and turned into rays in the rig's anchor frame (the
keyframe camera's pose there: origin its centre, direction its rotation
of the bearing).  A ray pair's error under a relative pose T_a_b is the
larger angle between each ray and the midpoint of their common
perpendicular, pi where the two rays do not meet in front of both.

:func:`verify` scores the poses the program chose, in ``dtype``: each
keyframe pair's central 5-point pose on the pair's ratio matches (the
pair's inliers and their count), the pool of every pair's inliers, and
the 17-point pose on the pool (its inlier count); then the accept test:
every pair with enough matches and inliers, a pool of 17 or more, the
17-point inliers at least half the pool (17 to ``nc_min_inliers``), the
sampling covariance's trace under its gate, and the host's yaw and
translation gate against the candidate's pose.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.loops import _BIG, _quat_to_matrix, hamming
from portbench.reference.posegraph import inverse


def bearings(camera: dict, uv: np.ndarray, dtype) -> torch.Tensor:
    """(N, 2) pixels -> (N, 3) unit bearings in the camera frame."""
    uv = torch.from_numpy(np.asarray(uv, np.float64)).to(dtype)
    fx, fy, cx, cy = camera["intrinsics"][:4]
    k1, k2, p1, p2 = camera["dist"][:4]
    xd, yd = (uv[:, 0] - cx) / fx, (uv[:, 1] - cy) / fy
    x, y = xd.clone(), yd.clone()
    for _ in range(20):
        r2 = x * x + y * y
        rad = 1 + k1 * r2 + k2 * r2 * r2
        dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        x, y = (xd - dx) / rad, (yd - dy) / rad
    b = torch.stack([x, y, torch.ones_like(x)], -1)
    return b / torch.sqrt((b * b).sum(-1, keepdim=True))


def rig_rays(camera: dict, rig: dict, F: int, dtype):
    """(origins, directions, bearings), each (R * F, 3), in the anchor frame."""
    bear = bearings(camera, rig["uv"], dtype)
    T = torch.from_numpy(np.asarray(rig["T"], np.float64)).to(dtype)
    R = _quat_to_matrix(T[:, :4])
    n = T.shape[0]
    d = torch.einsum("rij,rfj->rfi", R, bear.view(n, F, 3)).reshape(n * F, 3)
    o = T[:, None, 4:7].expand(n, F, 3).reshape(n * F, 3)
    return o, d, bear


def ray_error(T, va, fa, vb, fb) -> torch.Tensor:
    """(N,) the larger angle of each ray pair against its triangulated
    midpoint; b's rays are moved into a's frame by T = T_a_b."""
    T = T.to(fa.dtype)
    R = _quat_to_matrix(T[:4])
    ob = vb @ R.T + T[4:7]
    db = fb @ R.T
    w0 = va - ob
    a, b, c = (fa * fa).sum(-1), (fa * db).sum(-1), (db * db).sum(-1)
    d, e = (fa * w0).sum(-1), (db * w0).sum(-1)
    den = a * c - b * b
    ok = torch.abs(den) > 1e-12
    dens = torch.where(ok, den, torch.ones_like(den))
    s = (b * e - c * d) / dens
    t = (a * e - b * d) / dens
    X = 0.5 * ((va + s[:, None] * fa) + (ob + t[:, None] * db))

    def angle(o, f, P):
        v = P - o
        cosang = (v * f).sum(-1) / torch.clamp(
            torch.sqrt((v * v).sum(-1)) * torch.sqrt((f * f).sum(-1)), min=1e-300)
        return torch.arccos(torch.clamp(cosang, -1.0, 1.0))

    err = torch.maximum(angle(va, fa, X), angle(ob, db, X))
    return torch.where(ok & (s > 0) & (t > 0), err, torch.full_like(err, np.pi))


def ratio_match(q_desc, q_mask, c_desc, c_mask, Fc: int, nc: int, max_dist: float,
                ratio: float) -> np.ndarray:
    """(rows, nc) each query row's match in candidate segment jc (a column
    of that segment), -1 for none."""
    dist = hamming(q_desc, c_desc)
    dist = torch.where(torch.from_numpy(np.asarray(q_mask))[:, None]
                       & torch.from_numpy(np.asarray(c_mask))[None, :], dist, _BIG)
    out = np.full((dist.shape[0], nc), -1, np.int64)
    for jc in range(nc):
        seg = dist[:, jc * Fc:(jc + 1) * Fc]
        top2 = torch.topk(seg, 2, dim=1, largest=False)
        d1, d2 = top2.values[:, 0], top2.values[:, 1]
        ok = (d1 < torch.tensor(max_dist, dtype=torch.float32)) & (
            d1 < torch.tensor(ratio, dtype=torch.float32) * d2)
        # the nearest column is unique wherever the ratio test holds
        col = torch.argmin(seg, dim=1)
        out[:, jc] = torch.where(ok, col, -1).numpy()
    return out


def _counts(err, thr: float, eps: float):
    """(inliers at thr, the count's least and greatest under a relative
    ``eps`` either way)."""
    return err < thr, int((err < thr * (1 - eps)).sum()), int((err < thr * (1 + eps)).sum())


def verify(camera: dict, rec: dict, cfg: dict, dtype=torch.float64, eps: float = 1e-6):
    """The reference's readings of one fetched COVINS-G verification: each
    pair's inlier count range, the 17-point count range, and the accept
    decision.  ``rec`` holds the rigs, the program's poses and its answer."""
    p, o = rec["params"], rec["out"]
    nq, nc, Fq, Fc = p["nq_rig"], p["nc_rig"], p["Fq"], p["Fc"]
    qo, qd, qb = rig_rays(camera, rec["q_rig"], Fq, dtype)
    co, cd, cb = rig_rays(camera, rec["c_rig"], Fc, dtype)
    m = ratio_match(rec["q_rig"]["desc"], rec["q_rig"]["mask"], rec["c_rig"]["desc"],
                    rec["c_rig"]["mask"], Fc, nc, p["img_match_thres"], p["ratio_thres"])
    T5 = torch.from_numpy(np.asarray(rec["T5"], np.float64))
    zero = torch.zeros((Fq, 3), dtype=dtype)
    pool_q, pool_c = [], []
    pair_n_match, pair_rng, pairs_ok = [], [], True
    for iq in range(nq):
        for jc in range(nc):
            k = iq * nc + jc
            rows = np.where(m[iq * Fq:(iq + 1) * Fq, jc] >= 0)[0]
            cols = jc * Fc + m[iq * Fq + rows, jc]
            err = ray_error(T5[k], zero[rows], qb[iq * Fq + rows], zero[rows], cb[cols])
            inl, lo, hi = _counts(err, p["thr5"], eps)
            pair_n_match.append(len(rows))
            pair_rng.append((lo, hi))
            pairs_ok &= len(rows) >= p["rel_min_img_matches"] and int(inl.sum()) >= p[
                "rel_min_inliers"]
            sel = rows[inl.numpy()]
            pool_q.append(iq * Fq + sel)
            pool_c.append(jc * Fc + m[iq * Fq + sel, jc])
    qi, ci = np.concatenate(pool_q), np.concatenate(pool_c)
    n_pool = len(qi)
    T12 = torch.from_numpy(np.asarray(o["T_12"], np.float64))
    err = ray_error(T12, qo[qi], qd[qi], co[ci], cd[ci])
    inl17, lo17, hi17 = _counts(err, p["thr17"], eps)
    n17 = int(inl17.sum())
    min_inl = min(max(n_pool // 2, 17), p["nc_min_inliers"])
    ok = (pairs_ok and n_pool >= 17 and n17 >= min_inl
          and float(np.trace(o["cov"])) <= p["nc_cov_thres"])
    if ok:
        ok = yaw_gate(o["T_12"], rec["T_w_s_cand"], cfg["max_yaw"], cfg["max_trans"])
    return {"pair_n_match": np.asarray(pair_n_match), "pair_rng": pair_rng,
            "n17_rng": (lo17, hi17), "n_pool": n_pool, "accept": bool(ok)}


def yaw_gate(T_12, T_w_s_cand, max_yaw_deg: float, max_trans: float) -> bool:
    """The relative yaw (ZYX) between the candidate and the query placed by
    the loop, and the loop's translation, under their limits."""
    T21 = inverse(torch.as_tensor(np.asarray(T_12, np.float64)))
    Tc = torch.as_tensor(np.asarray(T_w_s_cand, np.float64))
    Rc = _quat_to_matrix(Tc[:4])
    Rq = Rc @ _quat_to_matrix(T21[:4])
    yaw_c = np.arctan2(float(Rc[1, 0]), float(Rc[0, 0]))
    yaw_q = np.arctan2(float(Rq[1, 0]), float(Rq[0, 0]))
    rel = np.degrees((yaw_q - yaw_c + np.pi) % (2 * np.pi) - np.pi)
    trans = float(torch.sqrt((T21[4:7] ** 2).sum()))
    return abs(rel) <= max_yaw_deg and trans <= max_trans
