"""The least time the card could take for the verification's kernel work.

Published peaks of one H100 SXM (dense): HBM bytes/s, +-1 int8 tensor
operations/s, float64 operations/s outside the tensor cores.  A call's
bound is the larger of its bytes over the HBM rate and its operations over
their peak, counted from the call's inputs (each input byte read once, each
output byte written once), so it reads the same work whichever kernel
implements it.  The counts are frozen copies of the program's smoke check
(`chip_smoke.py`: K4's pairs, `k6_bytes_ops`, K5's bytes, K11's pairs,
`FIVE_POINT_OPS`, `RAY_SCORE_OPS`), except K5, where the distances that
the function needs depend on the prologue's gates: it is counted by its
bytes and its per-landmark prologue alone, a lower bound.
"""

from __future__ import annotations

HBM_BYTES_S = 3.35e12
INT8_OPS_S = 1979e12
FP64_OPS_S = 34e12

P3P_QUARTIC_OPS = 70 + 120 + 60
P3P_ALIGN_OPS = 30 + 30 + 72 + 16 + 8 * 6 * (12 + 72) + 30
P3P_SCORE_OPS = 46
RAY_SCORE_OPS = {"central": 122, "noncentral": 164}
RAY_SCORE_OPS_PER_HYP = {"central": 3, "noncentral": 0}
FIVE_POINT_OPS = {
    "A": 45, "AtA": 81 * 9, "jacobi": 8 * 36 * (11 + 9 * 6 + 18 * 6), "order": 81,
    "minors": 3 * (2 * 32 + 10), "EEt": 9 * (3 * 32 + 2 * 10), "trace": 20,
    "det": 3 * 80 + 2 * 20, "constraints": 9 * (3 * 80 + 2 * 20 + 20 + 80 + 20),
    "gauss_jordan": 55 + 155 + 18 * 155, "p10": 39 + 88 + 88 + 71 + 220,
    "scale": 32 + 53, "grid": 256 * (2 + 54) + 255 * 4,
    "roots": 10 * (215 + (45 + 1560 + 110) + 322),
}
FIVE_POINT_OPS_PER_VALID_ROOT = 54 + 44 * 58 + 2 + 136


def bound_s(nbytes: float, *ops_at_rate) -> float:
    return max(nbytes / HBM_BYTES_S, sum(ops / rate for ops, rate in ops_at_rate))


def k4(s):
    return bound_s((s["m"] + s["n"]) * 33 + s["m"] * 4,
                   (2.0 * s["rows"] * s["cols"] * 256, INT8_OPS_S))


def k6(s):
    n, h, nv = s["n"], s["h"], s["valid"]
    read = n + (n * 4 if s["rows_given"] else 0) + nv * 48 + (h * nv * 8 if s["noise"] else h * 24)
    write = 7 * 8 + n + 4 + 4 + 4 * h * 4
    ops = (h * P3P_QUARTIC_OPS + 4 * h * P3P_ALIGN_OPS + s["valid_poses"] * nv * P3P_SCORE_OPS
           + (h * nv if s["noise"] else 0))
    return bound_s(read + write, (float(ops), FP64_OPS_S))


def k5(s):
    L, F = s["L"], s["F"]
    per_lm = 33 + 3 + 6 + 6 + 28 * s["radtan"] + 5 + 5 + 8 + 13 * s["view_angle"]
    db = s["desc_bytes"]
    return bound_s(L * (24 + 24 + 1 + 16 + db) + F * (16 + 8 + 1 + db) + L * 8,
                   (float(L * per_lm), FP64_OPS_S))


def k11(s):
    return bound_s((s["m"] + s["n"]) * 33 + 12 * s["m"] * (s["n"] // s["seg"]),
                   (2.0 * s["rows"] * s["cols"] * 256, INT8_OPS_S))


def k12_5pt(s):
    B, H, N = s["B"], s["H"], s["N"]
    ops = (B * H * sum(FIVE_POINT_OPS.values())
           + (s["hyps"] // 4) * FIVE_POINT_OPS_PER_VALID_ROOT
           + RAY_SCORE_OPS["central"] * s["hyp_rays"]
           + RAY_SCORE_OPS_PER_HYP["central"] * s["hyps"])
    P = 40 * H
    nbytes = (s["rays"] * 48 + B * N + (H * s["rays"] * 8 if s["noise"] else B * H * 40)
              + B * P * (56 + 1 + 4) + B * (56 + 8) + B * N)
    return bound_s(nbytes, (float(ops), FP64_OPS_S))


def k12_score(s):
    kind = "central" if s["central"] else "noncentral"
    B, H, N = s["B"], s["H"], s["N"]
    ops = RAY_SCORE_OPS[kind] * s["hyp_rays"] + RAY_SCORE_OPS_PER_HYP[kind] * s["hyps"]
    nbytes = (s["hyps"] * 56 + (B * H if s["has_valid"] else 0) + B * N
              + s["rays"] * 24 * (2 if s["central"] else 4)
              + B * H * 4 + (B * (4 + N) if s["inliers"] else 0))
    return bound_s(nbytes, (float(ops), FP64_OPS_S))


BOUNDS = {"K4": k4, "K5": k5, "K6": k6, "K11": k11, "K12_5pt": k12_5pt,
          "K12_score": k12_score}


def resolve(sizes: dict) -> dict:
    """Device counts read once the window has closed."""
    out = {}
    for k, v in sizes.items():
        out[k] = int(v.item()) if hasattr(v, "item") else v
    if "n_valid" in out:
        out["valid"] = out.pop("n_valid")
    return out


def least_seconds(records) -> float:
    """Sum of the bounds of the recorded kernel calls."""
    return sum(BOUNDS[k](resolve(s)) for k, s in records)
