"""The pose graph worked out again: its edges from the agents' streams and
the loops the window accepted, its cost, and its optimum.

A map's graph (COVINS's `PoseGraphOptimization`): each keyframe tied to
its agent's next five keyframes in the map by the agents' own odometry
(the relative pose of their sent VIO poses), weighted [rotation 10,
translation 1] x 10 for the next, x 10 / 2 for the 2nd and 3rd, x 10 / 3
for the 4th and 5th; each accepted loop or merge an edge from query to
candidate with its measured T_12, weighted by the inverse of its
covariance where it has one (upper Cholesky factor) and by [100, 1e4]
otherwise; the map's first keyframe fixed.

The residual of an edge i -> j is Log(T_ij_meas^-1 T_w_i^-1 T_w_j) in
[rotation, translation] (the SE(3) logarithm), whitened by its weight.
An odometry edge costs |r|^2; a loop edge rho(|r|^2), the robust loss
whose IRLS weight is 1 / sqrt(1 + s / delta^2) (the configuration's
`robust_loss_threshold` delta): rho(s) = 2 delta^2 (sqrt(1 + s / delta^2)
- 1).  :func:`solve` minimises the cost by damped Gauss-Newton on the
iteratively reweighted normal equations, solved dense, every step kept
only where the cost falls, until it stops falling.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.loops import _quat_mul, _quat_to_matrix


# ------------------------------------------------------------ SE(3) in batch
def qmul(a, b):
    return _quat_mul(a, b)


def inverse(T):
    qi = T[..., :4] * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=T.dtype, device=T.device)
    t = -(_quat_to_matrix(qi) @ T[..., 4:7, None])[..., 0]
    return torch.cat([qi, t], -1)


def compose(a, b):
    q = qmul(a[..., :4], b[..., :4])
    t = (_quat_to_matrix(a[..., :4]) @ b[..., 4:7, None])[..., 0] + a[..., 4:7]
    return torch.cat([q / torch.sqrt((q * q).sum(-1, keepdim=True)), t], -1)


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def _series_below(dtype) -> float:
    """The squared angle below which the series replace the closed forms
    (whose 1 - cos cancels): their next term is then under the type's
    rounding."""
    return 1e-8 if dtype == torch.float64 else 1e-3


def log(T):
    """(..., 7) -> (..., 6) [w, V(w)^-1 t], the quaternion's sign made
    positive; series at small angles (no branch's derivative is used
    where it is not taken)."""
    q = T[..., :4] / torch.sqrt((T[..., :4] ** 2).sum(-1, keepdim=True))
    q = torch.where(q[..., :1] < 0, -q, q)
    qw, v = q[..., 0], q[..., 1:]
    n2 = (v * v).sum(-1)
    small = n2 < 1e-8
    n = torch.sqrt(torch.where(small, torch.ones_like(n2), n2))
    f = torch.where(small, 2.0 / qw * (1.0 - n2 / (3.0 * qw * qw)),
                    2.0 * torch.atan2(n, qw) / n)
    w = f[..., None] * v
    th2 = (w * w).sum(-1)
    sm = th2 < _series_below(T.dtype)
    th = torch.sqrt(torch.where(sm, torch.ones_like(th2), th2))
    c = torch.where(sm, 1.0 / 12.0 + th2 / 720.0 + th2 * th2 / 30240.0,
                    (1.0 - th * torch.sin(th) / (2.0 * (1.0 - torch.cos(th)))) / th2)
    t = T[..., 4:7]
    wt = _cross(w, t)
    return torch.cat([w, t - 0.5 * wt + c[..., None] * _cross(w, wt)], -1)


def exp(xi):
    """(..., 6) -> (..., 7), exact (no derivative taken)."""
    w, u = xi[..., :3], xi[..., 3:]
    th2 = (w * w).sum(-1)
    sm = th2 < _series_below(xi.dtype)
    th = torch.sqrt(torch.where(sm, torch.ones_like(th2), th2))
    t4 = th2 * th2
    half = torch.where(sm, 0.5 - th2 / 48.0 + t4 / 3840.0, torch.sin(0.5 * th) / th)
    q = torch.cat([torch.where(sm, 1.0 - th2 / 8.0 + t4 / 384.0,
                               torch.cos(0.5 * th))[..., None], half[..., None] * w], -1)
    a = torch.where(sm, 0.5 - th2 / 24.0 + t4 / 720.0, (1.0 - torch.cos(th)) / th2)
    b = torch.where(sm, 1.0 / 6.0 - th2 / 120.0 + t4 / 5040.0,
                    (th - torch.sin(th)) / (th2 * th))
    wu = _cross(w, u)
    t = u + a[..., None] * wu + b[..., None] * _cross(w, wu)
    return torch.cat([q / torch.sqrt((q * q).sum(-1, keepdim=True)), t], -1)


def exp_lin(xi):
    """Exp to first order ([1, w / 2] normalised, translation u): the
    perturbation the Jacobian takes, equal to Exp's derivative at 0."""
    q = torch.cat([torch.ones_like(xi[..., :1]), 0.5 * xi[..., :3]], -1)
    return torch.cat([q / torch.sqrt((q * q).sum(-1, keepdim=True)), xi[..., 3:]], -1)


# ------------------------------------------------------------------ the graph
def build(ids, vio: dict, loops, w: dict):
    """The reference's edges of a map whose row r holds keyframe ``ids[r]``
    ((k, agent)): (list of (row i, row j, T_meas (7,), S (6, 6), is_loop)).
    ``vio`` maps a keyframe id to its agent's sent VIO pose; ``loops`` are
    (query id, candidate id, T_12, cov or None)."""
    row = {tuple(int(x) for x in k): r for r, k in enumerate(ids)}
    edges = []
    n1, n23, n45 = w["wt_kf_n1"], w["wt_kf_n23"], w["wt_kf_n45"]
    for r, (k, a) in enumerate(tuple(int(x) for x in kid) for kid in ids):
        for hop in range(1, 6):
            s = row.get((k + hop, a))
            if s is None:
                break
            mult = n1 if hop == 1 else n1 / max(n23 if hop <= 3 else n45, 1e-6)
            S = np.diag([w["wt_kf_R"] * mult] * 3 + [w["wt_kf_T"] * mult] * 3)
            Ta, Tb = (torch.from_numpy(np.asarray(vio[x], np.float64)) for x in
                      ((k, a), (k + hop, a)))
            edges.append((r, s, compose(inverse(Ta), Tb).numpy(), S, False))
    for qid, cid, T12, cov in loops:
        if qid not in row or cid not in row:
            continue
        if cov is None:
            S = np.diag([w["loop_rot_w"]] * 3 + [w["loop_trans_w"]] * 3)
        else:
            info = np.linalg.inv(np.asarray(cov, np.float64) + 1e-12 * np.eye(6))
            S = np.linalg.cholesky(0.5 * (info + info.T)).T
        edges.append((row[qid], row[cid], np.asarray(T12, np.float64), S, True))
    return edges


class Problem:
    """A graph's edges as tensors, its cost and its solve, in ``dtype``."""

    def __init__(self, edges, n: int, fixed, delta: float, dtype=torch.float64,
                 device="cpu"):
        self.n, self.dtype, self.device, self.delta = n, dtype, device, delta
        t = lambda x, d=dtype: torch.as_tensor(np.asarray(x), dtype=d, device=device)  # noqa: E731
        self.i = t([e[0] for e in edges], torch.int64)
        self.j = t([e[1] for e in edges], torch.int64)
        self.M = t(np.stack([e[2] for e in edges]))
        self.S = t(np.stack([e[3] for e in edges]))
        self.loop = t([e[4] for e in edges], torch.bool)
        self.free = ~t(fixed, torch.bool)

    def residual(self, P):
        E = compose(inverse(self.M), compose(inverse(P[self.i]), P[self.j]))
        return (self.S @ log(E)[..., None])[..., 0]

    def _costs(self, s):
        d2 = self.delta * self.delta
        robust = 2.0 * d2 * (torch.sqrt(1.0 + s / d2) - 1.0) if self.delta > 0 else s
        return torch.where(self.loop, robust, s)

    def cost(self, P) -> float:
        r = self.residual(P.to(self.dtype))
        return float(self._costs((r * r).sum(-1)).sum())

    def step(self, P, damping: float):
        Pi, Pj, M, S = P[self.i], P[self.j], self.M, self.S

        def one(Ti, Tj, Mi, Si, xi):
            E = compose(inverse(Mi), compose(inverse(compose(Ti, exp_lin(xi[:6]))),
                                             compose(Tj, exp_lin(xi[6:]))))
            return Si @ log(E)

        # the Jacobian in float64 (forward AD of its float32 form promotes);
        # the residuals, the normal equations and the solve in dtype
        f64 = torch.float64
        zero = torch.zeros(12, dtype=f64, device=self.device)
        J = torch.func.vmap(torch.func.jacfwd(one, argnums=4), in_dims=(0, 0, 0, 0, None))(
            Pi.to(f64), Pj.to(f64), M.to(f64), S.to(f64), zero).to(self.dtype)  # (E, 6, 12)
        r = self.residual(P)
        s = (r * r).sum(-1)
        wgt = torch.ones_like(s)
        if self.delta > 0:
            wgt = torch.where(self.loop, 1.0 / torch.sqrt(1.0 + s / self.delta ** 2), wgt)
        n = self.n
        H = torch.zeros((n, n, 6, 6), dtype=self.dtype, device=self.device)
        g = torch.zeros((n, 6), dtype=self.dtype, device=self.device)
        Ji, Jj = J[..., :6], J[..., 6:]
        wJi, wJj = Ji * wgt[:, None, None], Jj * wgt[:, None, None]
        for a, Ja, wJa in ((self.i, Ji, wJi), (self.j, Jj, wJj)):
            g.index_add_(0, a, torch.einsum("eri,er->ei", wJa, r))
            for b, Jb in ((self.i, Ji), (self.j, Jj)):
                H.index_put_((a, b), torch.einsum("eri,erj->eij", wJa, Jb), accumulate=True)
        f = self.free
        H = H[f][:, f].permute(0, 2, 1, 3).reshape(int(f.sum()) * 6, -1)
        H = H + damping * torch.eye(H.shape[0], dtype=self.dtype, device=self.device)
        dx = torch.linalg.solve(H, -g[f].reshape(-1))
        xi = torch.zeros((n, 6), dtype=self.dtype, device=self.device)
        xi[f] = dx.view(-1, 6)
        return compose(P, exp(xi))

    def solve(self, P0, iters: int = 50):
        """The optimum from P0 (N, 7): steps kept where the cost falls, the
        damping raised tenfold where it does not, until the cost falls by
        less than 1e-10 of itself, the damping passes 1e8 or ``iters``
        steps have run."""
        P = torch.as_tensor(P0, dtype=self.dtype, device=self.device).clone()
        c, lam = self.cost(P), 1e-6
        for _ in range(iters):
            Pn = self.step(P, lam)
            cn = self.cost(Pn)
            if cn < c:
                done = c - cn <= 1e-10 * max(c, 1e-300)
                P, c, lam = Pn, cn, max(lam / 10, 1e-9)
                if done:
                    break
            else:
                lam *= 10
                if lam > 1e8:
                    break
        return P
