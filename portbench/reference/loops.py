"""The verification's stages worked out again from the inputs the program
gathered for each verification.

COVINS: stage 1 (mutual nearest neighbours of the two keyframes'
landmark-tied descriptors under the absolute gate, ties to the lowest
index), stage 2's inlier count at its own answer, and stage 4 whole
(:func:`refine`) from stage 2's answer: the paired reprojection residual
of the 3D-3D matches (each side's landmark projected into the other
camera through T_12, against that camera's projection of its own point),
a Huber round, the outlier gate, a clean round.  Stages 3 and 5 are
`search.py`'s; COVINS-G is `rays.py`'s.
"""

from __future__ import annotations

import numpy as np
import torch

_BIG = float(1 << 30)


def _pm1(u8: torch.Tensor) -> torch.Tensor:
    shifts = torch.arange(7, -1, -1, device=u8.device, dtype=torch.uint8)
    bits = (u8[:, :, None] >> shifts) & 1
    return bits.reshape(u8.shape[0], -1).to(torch.float32) * 2.0 - 1.0


def hamming(a: np.ndarray, b: np.ndarray) -> torch.Tensor:
    """(M, N) exact Hamming distances, float32."""
    ta, tb = _pm1(torch.from_numpy(np.ascontiguousarray(a))), _pm1(
        torch.from_numpy(np.ascontiguousarray(b)))
    return (ta.shape[1] - ta @ tb.T) * 0.5


def mutual_nn(a, am, b, bm, max_dist: float) -> np.ndarray:
    dist = hamming(a, b)
    dist = torch.where(torch.from_numpy(am)[:, None] & torch.from_numpy(bm)[None, :],
                       dist, _BIG)
    fwd = torch.argmin(dist, dim=1)
    rows = torch.arange(dist.shape[0])
    ok = (torch.argmin(dist, dim=0)[fwd] == rows) & (dist[rows, fwd] < max_dist)
    return torch.where(ok, fwd, -1).numpy()


# ------------------------------------------------------------- stage 4
def _quat_to_matrix(q):
    w, x, y, z = q.unbind(-1)
    return torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
                        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
                        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
                       -1).reshape(q.shape[:-1] + (3, 3))


def _quat_exp(w):
    """Unit quaternion of the rotation vector w (no derivative taken)."""
    theta = float(torch.sqrt((w * w).sum()))
    if theta < 1e-8:
        return torch.cat([torch.ones(1, dtype=w.dtype), 0.5 * w])
    return torch.cat([torch.cos(torch.tensor([0.5 * theta], dtype=w.dtype)),
                      w * (np.sin(0.5 * theta) / theta)])


def _quat_lin(w):
    """[1, w / 2] normalised: Exp(w) to first order, smooth at 0 (the
    Jacobian's perturbation)."""
    q = torch.cat([torch.ones(1, dtype=w.dtype), 0.5 * w])
    return q / torch.sqrt((q * q).sum())


def _quat_mul(a, b):
    w1, x1, y1, z1 = a.unbind(-1)
    w2, x2, y2, z2 = b.unbind(-1)
    return torch.stack([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2], -1)


def _left_jacobian(w):
    """SO(3)'s left Jacobian (no derivative taken)."""
    theta = float(torch.sqrt((w * w).sum()))
    W = torch.zeros((3, 3), dtype=w.dtype)
    W[0, 1], W[0, 2], W[1, 0], W[1, 2], W[2, 0], W[2, 1] = -w[2], w[1], w[2], -w[0], -w[1], w[0]
    if theta < 1e-5:
        a, b = 0.5 - theta**2 / 24.0, 1.0 / 6.0 - theta**2 / 120.0
    else:
        a = (1.0 - np.cos(theta)) / theta**2
        b = (theta - np.sin(theta)) / theta**3
    return torch.eye(3, dtype=w.dtype) + a * W + b * (W @ W)


def boxplus(T, xi, exact: bool = True):
    """T o Exp(xi), xi = [w, v] in se(3).  ``exact=False`` takes Exp to
    first order ([1, w / 2] normalised, translation v), smooth at 0: the
    Jacobian's perturbation, equal to the exact one's derivative there."""
    R = _quat_to_matrix(T[:4])
    if exact:
        q = _quat_mul(T[:4], _quat_exp(xi[:3]))
        t = _left_jacobian(xi[:3]) @ xi[3:]
    else:
        q = _quat_mul(T[:4], _quat_lin(xi[:3]))
        t = xi[3:]
    q = q / torch.sqrt((q * q).sum())
    return torch.cat([q, R @ t + T[4:7]])


class Camera:
    def __init__(self, camera: dict, dtype):
        self.intr = torch.tensor(camera["intrinsics"][:4], dtype=dtype)
        self.dist = torch.tensor(camera["dist"][:4], dtype=dtype)
        T = torch.tensor(camera["T_s_c"], dtype=torch.float64)
        qi = T[:4] * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=torch.float64)
        R = _quat_to_matrix(qi)
        self.Rc = R.to(dtype)  # camera <- body
        self.tc = (-(R @ T[4:7])).to(dtype)

    def project(self, p_c):
        fx, fy, cx, cy = self.intr.unbind()
        k1, k2, p1, p2 = self.dist.unbind()
        z = p_c[:, 2]
        valid = z > 1e-6
        zs = torch.where(valid, z, torch.ones_like(z))
        x, y = p_c[:, 0] / zs, p_c[:, 1] / zs
        r2 = x * x + y * y
        rad = 1 + k1 * r2 + k2 * r2 * r2
        xd = x * rad + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        yd = y * rad + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        return torch.stack([fx * xd + cx, fy * yd + cy], -1), valid


class Stage4:
    """The paired residual of the stage's 3D-3D matches, in ``dtype``."""

    def __init__(self, arrays: dict, midx: np.ndarray, mfeat: np.ndarray, camera: dict,
                 dtype=torch.float64):
        t = {k: torch.from_numpy(np.asarray(arrays[k])) for k in
             ("q_obs_lm_body", "c_lm_body", "q_feat_lm_body", "q_feat_has_lm",
              "q_obs_valid")}
        F = t["q_feat_lm_body"].shape[0]
        C = t["c_lm_body"].shape[0]
        mi = torch.from_numpy(midx.astype(np.int64))
        mf = torch.from_numpy(mfeat.astype(np.int64))
        mfc = mf.clamp(0, F - 1)
        self.p1 = torch.cat([t["q_obs_lm_body"], t["q_feat_lm_body"][mfc]]).to(dtype)
        self.p2 = torch.cat([t["c_lm_body"][mi.clamp(0, C - 1)], t["c_lm_body"]]).to(dtype)
        self.m4 = torch.cat([(mi >= 0) & t["q_obs_valid"],
                             (mf >= 0) & t["q_feat_has_lm"][mfc]])
        self.cam = Camera(camera, dtype)
        self.dtype = dtype
        c = self.cam
        self.uv1, v1 = c.project(self.p1 @ c.Rc.T + c.tc)
        self.uv2, v2 = c.project(self.p2 @ c.Rc.T + c.tc)
        self.v12 = v1 & v2

    def residual(self, T):
        c = self.cam
        R, t = _quat_to_matrix(T[:4]), T[4:7]
        uv1, v3 = c.project((self.p2 @ R.T + t) @ c.Rc.T + c.tc)
        uv2, v4 = c.project(((self.p1 - t) @ R) @ c.Rc.T + c.tc)
        return torch.cat([uv1 - self.uv1, uv2 - self.uv2], -1), self.v12 & v3 & v4

    def inliers(self, T, th: float):
        r, valid = self.residual(T)
        n1 = torch.sqrt((r[:, :2] ** 2).sum(-1))
        n2 = torch.sqrt((r[:, 2:] ** 2).sum(-1))
        return self.m4 & valid & (n1 < th) & (n2 < th)

    def _normal_eqs(self, T, w, huber: float):
        def res(xi):
            return self.residual(boxplus(T, xi, exact=False))[0]
        xi0 = torch.zeros(6, dtype=self.dtype)
        J = torch.func.jacfwd(res)(xi0)  # (N, 4, 6)
        r, valid = self.residual(T)
        ww = w * valid.to(self.dtype)
        if huber > 0:
            rn = torch.sqrt((r * r).sum(-1))
            ww = ww * torch.clamp(huber / torch.clamp(rn, min=1e-12), max=1.0)
        Jw = J * ww[:, None, None]
        H = torch.einsum("nri,nrj->ij", Jw, J)
        b = -torch.einsum("nri,nr->i", Jw, r)
        return H, b

    def step(self, T, w, damping=1e-6, huber=0.0):
        H, b = self._normal_eqs(T, w, huber)
        return torch.linalg.solve(H + damping * torch.eye(6, dtype=self.dtype), b)

    def cost(self, T, w, huber=0.0):
        r, valid = self.residual(T)
        rn2 = (r * r).sum(-1)
        if huber > 0:
            rn = torch.sqrt(torch.clamp(rn2, min=1e-24))
            rn2 = torch.where(rn <= huber, rn2, huber * (2 * rn - huber))
        return (w * valid.to(self.dtype) * rn2).sum()


def _pose_inv(p):
    qi = p[:4] * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=p.dtype)
    return torch.cat([qi, -(_quat_to_matrix(qi) @ p[4:7])])


def _pose_mul(a, b):
    q = _quat_mul(a[:4], b[:4])
    return torch.cat([q / torch.sqrt((q * q).sum()), _quat_to_matrix(a[:4]) @ b[4:7] + a[4:7]])


def initial_T12(T_c_w, T_w_s_cand, T_s_c):
    """Stage 4's start from stage 2's pose of the query camera: T_12 =
    (T_w_cq o T_c_s)^-1 o T_w_s_cand."""
    t = [torch.as_tensor(np.asarray(x), dtype=torch.float64) for x in (T_c_w, T_w_s_cand, T_s_c)]
    T_wc_sq = _pose_mul(_pose_inv(t[0]), _pose_inv(t[2]))
    return _pose_mul(_pose_inv(T_wc_sq), t[1]).numpy()


def pose_gap(a, b) -> float:
    """Largest entry of a - b, the quaternions of one sign."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if float(a[:4] @ b[:4]) < 0:
        b = np.concatenate([-b[:4], b[4:]])
    return float(np.abs(a - b).max())


def p3p_inliers(arrays, midx, T_c_w, camera: dict, thr_rad: float) -> int:
    """Stage 2's inliers at its own answer: stage-1 matches whose query
    bearing lies within ``thr_rad`` of the candidate landmark seen from
    T_c_w (pinhole; radtan undistorted by fixed-point iteration)."""
    uv = torch.from_numpy(np.asarray(arrays["q_obs_uv"], np.float64))
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
    bear = torch.stack([x, y, torch.ones_like(x)], -1)
    bear = bear / torch.sqrt((bear * bear).sum(-1, keepdim=True))
    m = torch.from_numpy(midx.astype(np.int64))
    valid = torch.from_numpy(np.asarray(arrays["q_obs_valid"])) & (m >= 0)
    pts = torch.from_numpy(np.asarray(arrays["c_lm_w"], np.float64))[m.clamp(0)]
    T = torch.as_tensor(np.asarray(T_c_w), dtype=torch.float64)
    pc = pts @ _quat_to_matrix(T[:4]).T + T[4:7]
    n = torch.sqrt((pc * pc).sum(-1))
    cos = torch.clamp((pc / n[:, None] * bear).sum(-1), -1.0, 1.0)
    err = torch.where(n > 1e-9, torch.arccos(cos), torch.full_like(n, np.pi))
    return int(((err < thr_rad) & valid).sum())


def refine(arrays, out, camera, th: float, dtype, T_init, n_iters: int = 8):
    """Stage 4 whole in ``dtype`` from ``T_init``: a Huber round on every
    3D-3D match, the gate, a clean round on the inliers, each of
    ``n_iters`` damped Gauss-Newton steps kept where the cost falls.
    Returns (T_12, the inliers' count at it)."""
    s = Stage4(arrays, out["midx"], out["mfeat"], camera, dtype)

    def rounds(T, w, huber):
        for _ in range(n_iters):
            xi = s.step(T, w, huber=huber)
            T_new = boxplus(T, xi)
            if s.cost(T_new, w, huber) < s.cost(T, w, huber):
                T = T_new
        return T
    T = torch.as_tensor(np.asarray(T_init), dtype=dtype)
    T1 = rounds(T, s.m4.to(dtype), th)
    T2 = rounds(T1, s.inliers(T1, th).to(dtype), 0.0)
    return T2.double().numpy(), int(s.inliers(T2, th).sum())
