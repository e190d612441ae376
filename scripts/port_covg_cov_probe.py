"""Where the card's and the CPU's COVINS-G loop covariances part, and how far
rounding alone moves them: the evidence for the covariance bound of
`tests/test_torch_kernels_cuda.py::test_covinsg_verify_on_the_card_matches_the_cpu`
and `chip_smoke.COV_TOL`.

On that test's scene (rigs of 2 and 3 keyframes of 1024 features, the
same seed, draws and thresholds), for each central solver:

1. ``spread``: the CPU's covariance when the rays' directions of one rig
   move by one ulp (every element up, then down, ``np.nextafter``): how
   far rounding alone moves it, relative to its largest entry;
2. ``card_vs_cpu`` (on a card): the whole verification on the card
   against the CPU, the same measure;
3. ``ops`` (on a card): the covariance stage (`epipolar.sampling_covariance`
   with its 60 17-point re-solves) replayed operation by operation from
   the CPU run's recorded inputs.  ``isolated``: the operation on the card
   given the CPU's input of that operation; ``chain``: each device from
   its own results.  Each is the largest difference relative to the CPU
   output's largest entry (for integers and flags: elements that differ).
   The replay is checked against `sampling_covariance` bit for bit.

Usage: python scripts/port_covg_cov_probe.py [--cpu]
  (--cpu: part 1 alone, no card needed, a few minutes; without it parts 2
  and 3 on the card, part 1 left out)
"""

import argparse
import json
import math
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from covins_tpu_torch.ops import epipolar as epi  # noqa: E402
from covins_tpu_torch.ops import linalg as la  # noqa: E402
from covins_tpu_torch.ops import loopverify, ransac  # noqa: E402
from covins_tpu_torch.utils import geometry as geo  # noqa: E402
from covins_tpu_torch.utils.synthetic import covins_g_scene  # noqa: E402

KEYS = ("qo", "qd", "co", "cd", "q_desc", "c_desc", "qmask", "cmask", "qbear", "cbear")


def case(solver):
    """The card test's inputs and parameters, made as the test makes them."""
    rng = np.random.default_rng(5)
    F, nq, nc = 1024, 2, 3
    sc = covins_g_scene(rng, F, nq, nc, n_points=400, n_inliers=300, n_outliers=200)
    n_hyp5 = 50 if solver == "5pt" else 200

    def g(*shape):
        return -np.log(-np.log(np.clip(rng.random(shape), 1e-300, None)))

    noise = {"noise5": g(nq * nc, n_hyp5, F), "noise17": g(512, nq * nc * F),
             "noise_cov": g(60, nq * nc * F)}
    params = dict(img_match_thres=40.0, ratio_thres=0.8, thr5=float(np.arctan2(16.0, 458.0)),
                  rel_min_img_matches=20, rel_min_inliers=20,
                  thr17=float(np.arctan2(1.5, 458.0)), nc_min_inliers=100,
                  thr_cov_rad=float(np.arctan2(10.0, 458.0)), nc_cov_thres=10.0,
                  nq_rig=nq, nc_rig=nc, Fq=F, Fc=F, n_hyp5=n_hyp5, n_hyp17=512, n_cov=60,
                  solver=solver)
    return {**{k: sc[k] for k in KEYS}, **noise}, params


def verify(arrays, params, dev, record=None):
    """covinsg_verify on ``dev``; with ``record`` (a dict), the arguments of
    its sampling_covariance call are kept there."""
    t = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in arrays.items()}
    orig = epi.sampling_covariance

    def recording(*a, **kw):
        record.update(args=a, kw=kw)
        return orig(*a, **kw)

    if record is not None:
        epi.sampling_covariance = recording
    try:
        out = loopverify.covinsg_verify(*(t[k] for k in KEYS), **params,
                                        **{k: t[k] for k in ("noise5", "noise17", "noise_cov")})
    finally:
        epi.sampling_covariance = orig
    return {k: v.cpu() for k, v in out.items()}


def rel(a, b):
    """|a - b| largest, relative to b's largest entry (floats), or the
    number of elements that differ (integers and flags)."""
    a, b = a.cpu(), b.cpu()
    if not b.is_floating_point():
        return int((a != b).sum())
    scale = float(b.abs().max()) or 1.0
    return float((a - b).abs().max()) / scale


def gates_equal(a, b):
    return all(torch.equal(a[k].to(torch.int64), b[k].to(torch.int64))
               for k in ("ok", "pairs_ok", "n_inliers", "n_pool", "n_used", "pair_n_match",
                         "pair_n_inl"))


# -------------------------------------------------- the covariance, step by step
def steps(n_samples, thr, min_ratio):
    """`sampling_covariance` (with `gep_17pt`) as named steps, each a
    function of the state so far returning its new entries."""

    def minimal_sets(s):
        return {"idx": ransac.sample_minimal_sets(s["noise"][..., :n_samples, :],
                                                  s["inliers"], 17)}

    def rows(s):
        i = s["idx"]
        return {"A": epi._gec_rows(s["va"][i], s["fa"][i], s["vb"][i], s["fb"][i])}

    def normal(s):
        return {"M": s["A"].transpose(-1, -2) @ s["A"]}

    def eigvec(s):
        return {"x": la.min_eigvec_psd(s["M"])}

    def scale(s):
        x = s["x"]
        Rpart = x[..., 9:].reshape(x.shape[:-1] + (3, 3))
        lam = math.sqrt(3.0) / torch.clamp(la.norm_last(x[..., 9:]), min=1e-12)
        sign = torch.sign(la.det33(Rpart))
        sign = torch.where(sign == 0, 1.0, sign)
        return {"xs": x * (lam * sign)[..., None]}

    def svd(s):
        x = s["xs"]
        U, _, Vt2 = la.svd3x3(x[..., 9:].reshape(x.shape[:-1] + (3, 3)))
        return {"U": U, "Vt2": Vt2}

    def rotation(s):
        d = torch.sign(la.det33(s["U"] @ s["Vt2"]))
        D = torch.stack([torch.ones_like(d), torch.ones_like(d), d], dim=-1)
        return {"R": (s["U"] * D[..., None, :]) @ s["Vt2"]}

    def translation(s):
        x = s["xs"]
        E = x[..., :9].reshape(x.shape[:-1] + (3, 3))
        return {"t": epi._skew_vee(E @ s["R"].transpose(-1, -2))}

    def quaternion(s):
        return {"T": geo.pose_from_qt(geo.matrix_to_quat(s["R"]), s["t"])}

    def counts(s):
        c, _, _ = epi._score1(s["T"], s["va"], s["fa"], s["vb"], s["fb"], s["inliers"], thr,
                              want_inliers=False)
        return {"counts": c}

    def keep(s):
        f32 = torch.float32
        ratio = s["counts"].to(f32) / torch.clamp(s["inliers"].sum(), min=1).to(f32)
        return {"keep": ratio > min_ratio}

    def deviations(s):
        T, Tb = s["T"], s["T_best"]
        dq = geo.quat_multiply(geo.quat_conjugate(geo.pose_q(Tb))[None], geo.pose_q(T))
        return {"dev": torch.cat([geo.quat_log(dq), geo.pose_t(T) - geo.pose_t(Tb)[None]],
                                 dim=-1)}

    def covariance(s):
        w = s["keep"].to(s["dev"].dtype)[:, None]
        n_used = s["keep"].sum()
        denom = torch.clamp(n_used - 1, min=1).to(s["dev"].dtype)
        return {"cov": (w * s["dev"]).T @ (w * s["dev"]) / denom, "n_used": n_used}

    return [("minimal sets", minimal_sets), ("rows (_gec_rows)", rows),
            ("A^T A (matmul)", normal), ("min_eigvec_psd", eigvec),
            ("scale and sign (norm_last, det33)", scale), ("svd3x3", svd),
            ("R = U D Vt (matmul)", rotation), ("t = vee(E R^T) (matmul)", translation),
            ("matrix_to_quat", quaternion), ("counts (K12)", counts),
            ("keep (float32 ratio)", keep), ("deviations (quat_log)", deviations),
            ("covariance (matmul)", covariance)]


def replay(record, dev):
    """Part 3: the recorded CPU call replayed on the CPU and on ``dev``."""
    a, kw = record["args"], record["kw"]
    T_best, va, fa, vb, fb, inliers, n_samples = a
    state = {"T_best": T_best, "va": va, "fa": fa, "vb": vb, "fb": fb, "inliers": inliers,
             "noise": kw["noise"]}
    plan = steps(n_samples, kw["threshold_rad"], kw.get("min_inlier_ratio", 0.8))
    cpu = [dict(state)]
    for _, fn in plan:
        cpu.append({**cpu[-1], **fn(cpu[-1])})
    ref_cov, ref_n = epi.sampling_covariance(*a, **kw)
    assert torch.equal(cpu[-1]["cov"], ref_cov) and torch.equal(cpu[-1]["n_used"], ref_n), \
        "the replay does not reproduce sampling_covariance"
    card = {k: v.to(dev) for k, v in state.items()}
    rows = []
    for k, (name, fn) in enumerate(plan):
        iso = fn({n: v.to(dev) for n, v in cpu[k].items()})
        new = fn(card)
        card = {**card, **new}
        rows.append({"op": name,
                     "isolated": {n: rel(v, cpu[k + 1][n]) for n, v in iso.items()},
                     "chain": {n: rel(v, cpu[k + 1][n]) for n, v in new.items()}})
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true", help="part 1 only, on the CPU")
    opts = ap.parse_args()
    torch.set_num_threads(1)
    cpu = torch.device("cpu")
    if not opts.cpu:
        print(torch.cuda.get_device_name(0), flush=True)
        os.system("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader")
    for solver in ("5pt", "8pt"):
        arrays, params = case(solver)
        record = {}
        base = verify(arrays, params, cpu, record)
        row = {"solver": solver, "ok": bool(base["ok"]), "n_used": int(base["n_used"]),
               "cov_max": float(base["cov"].abs().max())}
        if opts.cpu:
            spread = []
            for side in ("qd", "cd"):
                for direction in (np.inf, -np.inf):
                    moved = dict(arrays)
                    moved[side] = np.nextafter(arrays[side], direction)
                    out = verify(moved, params, cpu)
                    spread.append({"moved": side, "up": direction > 0,
                                   "gates_equal": gates_equal(out, base),
                                   "cov": rel(out["cov"], base["cov"]),
                                   "T_12": rel(out["T_12"], base["T_12"])})
            row["spread"] = spread
            row["spread_cov_max"] = max(s["cov"] for s in spread)
        else:
            dev = torch.device("cuda")
            verify(arrays, params, dev)  # the solvers' constants on the card
            out = verify(arrays, params, dev)
            row["card_vs_cpu"] = {"gates_equal": gates_equal(out, base),
                                  "cov": rel(out["cov"], base["cov"]),
                                  "T_12": rel(out["T_12"], base["T_12"])}
            row["ops"] = replay(record, dev)
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
