"""COVINS's projection searches, stages 3 and 5, worked out again.

SearchBySE3 (stage 3, through stage 2's pose) and SearchByProjection
(stage 5, through the refined loop transform): each landmark is projected
into the query camera; it is kept where its depth is positive, it falls in
the image, its distance lies within its scale-invariance range (0.8 x its
least to 1.2 x its greatest) and, in stage 5, it is seen within 60 degrees
of its normal.  Each free feature within ``radius * 2^octave`` pixels whose
octave lies within one of the landmark's predicted level (ceil of log1.2 of
its greatest distance over its distance, in 0..16) is a candidate; the
landmark takes the candidate of least Hamming distance (the lowest index
on a tie) when that is at most the descriptor gate.  A feature claimed by
several landmarks goes to the least score, distance + row x 1e-7 in
float32, every landmark whose score equals that least keeping it.

``slack`` moves every gate by a relative ``eps`` outwards (+1) or inwards
(-1), so that a landmark whose answer hangs on a rounding at a gate can be
told from one that differs.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.loops import Camera, _quat_to_matrix, hamming

_BIG = 1e9


def _gate(x, lim, slack: int, eps: float):
    """x <= lim, with the limit moved by slack * eps (relative)."""
    return x <= lim * (1.0 + slack * eps) + slack * eps


def search(camera: dict, T_cw, p_w, lm_desc, lm_normal, lm_rng, lm_free, kp_uv, kp_desc,
           kp_oct, kp_free, radius: float, max_dist: float, view_angle: bool,
           slack: int = 0, eps: float = 1e-9) -> np.ndarray:
    """(L,) the feature each landmark matches, -1 for none."""
    f64 = torch.float64
    cam = Camera(camera, f64)
    img_w, img_h = float(camera["img_w"]), float(camera["img_h"])
    T = torch.as_tensor(np.asarray(T_cw, np.float64))
    R = _quat_to_matrix(T[:4])
    pw = torch.from_numpy(np.asarray(p_w, np.float64)).reshape(-1, 3)
    L = pw.shape[0]
    F = kp_uv.shape[0]
    out = np.full(L, -1, np.int64)
    if L == 0 or F == 0:
        return out
    pc = pw @ R.T + T[4:7]
    uv, ok = cam.project(pc)
    ok = ok & (pc[:, 2] > -slack * eps)
    u, v = uv[:, 0], uv[:, 1]
    ok = ok & _gate(-u, 0.0, slack, eps) & (u < img_w * (1 + slack * eps))
    ok = ok & _gate(-v, 0.0, slack, eps) & (v < img_h * (1 + slack * eps))
    centre = -(R.T @ T[4:7])
    d = pw - centre
    dist = torch.sqrt((d * d).sum(-1))
    if view_angle:
        nrm = torch.from_numpy(np.asarray(lm_normal, np.float64)).reshape(-1, 3)
        has_n = torch.sqrt((nrm * nrm).sum(-1)) > 1e-6
        cosv = (d * nrm).sum(-1)
        ok = ok & (~has_n | _gate(0.5 * dist, cosv, slack, eps))
    rng = torch.from_numpy(np.asarray(lm_rng, np.float64)).reshape(-1, 2)
    has_rng = rng[:, 1] > 0
    in_rng = _gate(0.8 * rng[:, 0], dist, slack, eps) & _gate(dist, 1.2 * rng[:, 1], slack, eps)
    ok = ok & (~has_rng | in_rng) & torch.from_numpy(np.asarray(lm_free, bool))
    level = np.log(1.2)
    pred = torch.clamp(torch.ceil(torch.log(torch.clamp(rng[:, 1], min=1e-9)
                                            / torch.clamp(dist, min=1e-9)) / level
                                  - slack * eps), 0.0, 16.0)
    kuv = torch.from_numpy(np.asarray(kp_uv, np.float64))
    koct = torch.from_numpy(np.asarray(kp_oct, np.float64))
    kfree = torch.from_numpy(np.asarray(kp_free, bool))
    rows = torch.nonzero(ok).flatten().numpy()
    best_f = np.zeros(L, np.int64)
    best_d = np.full(L, _BIG, np.float32)
    if len(rows):
        dpx = torch.sqrt(((uv[rows, None, :] - kuv[None]) ** 2).sum(-1))
        oct_ok = (torch.abs(koct[None] - pred[rows, None]) <= 1.0) | ~has_rng[rows, None]
        near = _gate(dpx, radius * torch.pow(torch.tensor(2.0, dtype=f64), koct)[None],
                     slack, eps) & oct_ok & kfree[None]
        hd = hamming(np.asarray(lm_desc)[rows], np.asarray(kp_desc))
        hd = torch.where(near, hd, torch.tensor(_BIG, dtype=torch.float32))
        # the least distance, the lowest index among equals
        dmin = hd.min(1).values
        first = torch.argmax((hd == dmin[:, None]).to(torch.int8), dim=1)
        best_d[rows] = dmin.numpy()
        best_f[rows] = np.where(dmin.numpy() < _BIG, first.numpy(), 0)
    valid = best_d <= np.float32(max_dist)
    score = (best_d + np.arange(L, dtype=np.float32) * np.float32(1e-7)).astype(np.float32)
    score = np.where(valid, score, np.float32(_BIG))
    col_min = np.full(F, np.float32(_BIG), np.float32)
    np.minimum.at(col_min, best_f, score)
    win = valid & (score <= col_min[best_f])
    out[win] = best_f[win]
    return out


def mismatch(program: np.ndarray, answers) -> int:
    """Landmarks whose program answer is none of the reference's
    (``answers``: the exact search and its slack variants)."""
    program = np.asarray(program, np.int64)
    ok = np.zeros(len(program), bool)
    for a in answers:
        ok |= program == a
    return int((~ok).sum())
