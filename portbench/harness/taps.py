"""What the harness records around the program's calls.

A tap replaces a module-level name through which the program calls one of
its own functions with a shim that records and forwards; the function runs
unchanged.  Two sets:

- :class:`CheckTaps`, in every run: the inputs and outputs that the
  comparison with the reference needs (a seeded share of the landmark-
  attribute cohorts, each verification's gathered inputs, its fetched
  result and its accept decision, each loop or merge handled, and a
  sample of the pose-graph solves drawn from the seed).  They keep
  references and small host copies, and issue no device work.
- :class:`TraceTaps`, in the traced run only: spans around the calls into
  each layer (host clock; the pose graph synchronised at both ends), with
  a spin kernel launched at each span boundary, short and long in turn,
  so that the device trace can be cut into the spans that issued its
  work, and the sizes of the verification kernels' inputs for their
  roofline.
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch

# the kernel that marks span boundaries in the device trace: the k-th
# spins 1 cycle for even k, MARKER_LONG_CYCLES (some 10 us) for odd k, so
# that a marker the trace loses shows as two of one length in a row
MARKER_NAME = "spin_kernel"
MARKER_LONG_CYCLES = 20_000


class Patches:
    """Swap attributes for the life of the context; restore in reverse."""

    def __init__(self):
        self._saved = []

    def set(self, obj, name: str, value):
        self._saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def restore(self):
        while self._saved:
            obj, name, value = self._saved.pop()
            # a kernel wrapper counts launches on its module-level name
            if hasattr(value, "launches") and hasattr(getattr(obj, name), "launches"):
                value.launches += getattr(obj, name).launches
            setattr(obj, name, value)


def _counting(shim: Callable):
    shim.launches = 0
    return shim


class CheckTaps:
    """Inputs and outputs for the comparison with the reference."""

    def __init__(self, mode: str, seed: int, cohort_share: float, pgo_solves: int):
        self.mode = mode
        self.rng = np.random.default_rng([int(seed) & 0xFFFFFFFFFFFFFFFF, 77])
        self.pgo_rng = np.random.default_rng([int(seed) & 0xFFFFFFFFFFFFFFFF, 55])
        self.cohort_share = cohort_share
        self.cohorts: list = []  # (packed, L, P, out, scale_factor, n_levels)
        self.fetched: list = []  # verifications fetched, with their inputs
        self.handled: list = []  # (query id, candidate id, outcome, T_12, cov)
        self.pgo_kept: list = []  # a reservoir of pose-graph solves drawn from the seed
        self.pgo_last = None  # and the last solve
        self.pgo_k = pgo_solves
        self.n_solves = 0
        self._pgo_rec = None
        self._pending: dict = {}
        self._last_upload = self._last_p3p = self._last_T5 = None
        self.patches = Patches()

    def install(self):
        from covins_tpu_torch.models.map_manager import MapManager
        from covins_tpu_torch.models.placerec import PlaceRecognition
        from covins_tpu_torch.ops import epipolar, landmark_ops, loopverify, pgo

        self._install_loops(MapManager, PlaceRecognition, pgo)
        if self.mode != "COVINS":
            for name in ("relative_pose_ransac_central_5pt", "relative_pose_ransac_central"):
                self._tap_central(epipolar, name)

        attrs = landmark_ops.landmark_attributes

        def landmark_attributes(packed, L, P, scale_factor=1.2, n_levels=8):
            out = attrs(packed, L, P, scale_factor, n_levels)
            if self.rng.random() < self.cohort_share:
                self.cohorts.append((packed, L, P, out, scale_factor, n_levels))
            return out
        self.patches.set(landmark_ops, "landmark_attributes", _counting(landmark_attributes))

        upload = loopverify.upload

        def recording_upload(arrays, device):
            self._last_upload = arrays
            return upload(arrays, device)
        self.patches.set(loopverify, "upload", recording_upload)

        if self.mode == "COVINS":
            from covins_tpu_torch.ops import pnp

            dispatch, fetch = loopverify.dispatch_covins_verify, loopverify.fetch_covins_verify
            p3p = pnp.absolute_pose_ransac

            def recording_p3p(*args, **kwargs):
                out = p3p(*args, **kwargs)
                self._last_p3p = out["T_c_w"]
                return out
            self.patches.set(pnp, "absolute_pose_ransac", _counting(recording_p3p))

            def dispatch_covins(mp_q, q_row, mp_c, c_row, cfg, cam_q, cam_c, **kw):
                self._last_upload = self._last_p3p = None
                job = dispatch(mp_q, q_row, mp_c, c_row, cfg, cam_q, cam_c, **kw)
                if job is not None:
                    self._pending[id(job[1])] = {
                        "arrays": self._last_upload, "T_c_w": self._last_p3p,
                        "query": tuple(int(x) for x in mp_q.kf_ids[q_row]),
                        "candidate": tuple(int(x) for x in mp_c.kf_ids[c_row]),
                        "same_map": mp_q is mp_c}
                return job

            def fetch_covins(job):
                out = fetch(job)
                rec = self._pending.pop(id(job[1]), None)
                if rec is not None:
                    rec["out"] = out
                    self.fetched.append(rec)
                return out
            self.patches.set(loopverify, "dispatch_covins_verify", dispatch_covins)
            self.patches.set(loopverify, "fetch_covins_verify", fetch_covins)
        else:
            dispatch, fetch = loopverify.dispatch_covinsg_verify, loopverify.fetch_covinsg_verify

            def dispatch_g(rig_q, rig_c, cam_q, cam_c, params, noise):
                self._last_T5 = None
                job = dispatch(rig_q, rig_c, cam_q, cam_c, params, noise)
                self._pending[id(job[1])] = {
                    "q_desc": rig_q["desc"], "q_mask": rig_q["mask"],
                    "c_desc": rig_c["desc"], "c_mask": rig_c["mask"],
                    "q_rig": rig_q, "c_rig": rig_c, "T5": self._last_T5,
                    "params": dict(params)}
                return job

            def fetch_g(job):
                out = fetch(job)
                rec = self._pending.pop(id(job[1]), None)
                if rec is not None:
                    rec["out"] = out
                    self.fetched.append(rec)
                return out
            self.patches.set(loopverify, "dispatch_covinsg_verify", dispatch_g)
            self.patches.set(loopverify, "fetch_covinsg_verify", fetch_g)
        return self

    def _tap_central(self, epipolar, name: str):
        """Keep each keyframe pair's central pose (COVINS-G's stage 2)."""
        fn = getattr(epipolar, name)

        def central(*args, **kwargs):
            out = fn(*args, **kwargs)
            self._last_T5 = out["T_a_b"]
            return out
        self.patches.set(epipolar, name, central)

    def _install_loops(self, MapManager, PlaceRecognition, pgo):
        """Each fetched verification's accept decision, each loop or merge
        handled and its outcome, and the pose-graph solves: the map's
        keyframes and poses before each, and for a reservoir of solves
        drawn from the seed (and the last) the graph and the result."""
        fin = PlaceRecognition.finalize_verify

        def finalize_verify(pr, tagged):
            n0 = len(self.fetched)
            got = fin(pr, tagged)
            if len(self.fetched) > n0:
                rec = self.fetched[-1]
                rec["accepted"] = got is not None
                if tagged[0] == "g":
                    rec["T_w_s_cand"] = tagged[1][0]["T_w_s_cand"]
            return got
        self.patches.set(PlaceRecognition, "finalize_verify", finalize_verify)

        hl = MapManager.handle_loop

        def handle_loop(mgr, loop, defer_pgo=False):
            out = hl(mgr, loop, defer_pgo)
            self.handled.append((tuple(int(x) for x in loop.query_id),
                                 tuple(int(x) for x in loop.candidate_id), out,
                                 np.asarray(loop.T_12, np.float64),
                                 None if loop.cov is None else np.asarray(loop.cov)))
            return out
        self.patches.set(MapManager, "handle_loop", handle_loop)

        rp = MapManager.run_pgo

        def run_pgo(mgr, mp, poses_init=None):
            n = mp.n_kf
            rec = {"index": self.n_solves, "kf_ids": mp.kf_ids[:n].copy(),
                   "pose_before": mp.kf_pose[:n].copy(), "kf_mask": mp.kf_mask[:n].copy(),
                   "seeded": poses_init is not None, "handled": len(self.handled),
                   "last_loop": dict(mp.loops[-1]) if mp.loops else None}
            self.n_solves += 1
            self._pgo_rec = rec
            try:
                return rp(mgr, mp, poses_init)
            finally:
                self._pgo_rec = None
                self.pgo_last = rec
                i = rec["index"]
                if i < self.pgo_k:
                    self.pgo_kept.append(rec)
                else:
                    j = int(self.pgo_rng.integers(0, i + 1))
                    if j < self.pgo_k:
                        self.pgo_kept[j] = rec
        self.patches.set(MapManager, "run_pgo", run_pgo)

        opt = pgo.optimize_pose_graph

        def optimize_pose_graph(g, *args, **kwargs):
            out = opt(g, *args, **kwargs)
            if self._pgo_rec is not None:
                self._pgo_rec.update(graph=g, result=out[0])
            return out
        self.patches.set(pgo, "optimize_pose_graph", optimize_pose_graph)

    def pgo_solves(self) -> list:
        """The solves kept: the reservoir and the last, each once."""
        out = list(self.pgo_kept)
        if self.pgo_last is not None and all(r is not self.pgo_last for r in out):
            out.append(self.pgo_last)
        return out

    def remove(self):
        self.patches.restore()
        self._pending.clear()


class Spans:
    """Nested host spans; on a card each boundary launches a marker kernel
    and appends the label of the device segment that it opens."""

    def __init__(self, marker: bool):
        self.marker = marker
        self.stack: list = []
        self.closed: dict = {}  # label -> list of seconds
        self.self_s: dict = {}  # label -> host seconds as the innermost span
        self.labels = ["host"]  # segment k's label; k = 0 before the first marker
        self.counts: dict = {}
        self._t = time.perf_counter()

    def _switch(self):
        now = time.perf_counter()
        top = self.stack[-1][0] if self.stack else "host"
        self.self_s[top] = self.self_s.get(top, 0.0) + now - self._t
        self._t = now
        return now

    def _mark(self):
        if self.marker:
            torch.cuda._sleep(MARKER_LONG_CYCLES if len(self.labels) % 2 == 0 else 1)
            self.labels.append(self.stack[-1][0] if self.stack else "host")

    def open(self, label: str):
        now = self._switch()
        self.stack.append((label, now))
        self._mark()

    def close(self):
        now = self._switch()
        label, t0 = self.stack.pop()
        self.closed.setdefault(label, []).append(now - t0)
        self._mark()

    def wrap(self, label: str, fn: Callable, sync: bool = False, count: str = None):
        def spanned(*args, **kwargs):
            if count:
                self.counts[count] = self.counts.get(count, 0) + 1
            if sync:
                torch.cuda.synchronize()
            self.open(label)
            try:
                out = fn(*args, **kwargs)
                if sync:
                    torch.cuda.synchronize()
                return out
            finally:
                self.close()
        return spanned


class TraceTaps:
    """Spans around each layer's calls and the verification kernels' input
    sizes (device-side sums, read once the window has closed)."""

    def __init__(self, mode: str, card: bool):
        self.mode = mode
        self.spans = Spans(marker=card)
        self.work: list = []  # (kernel, dict of sizes: ints or 0-d tensors)
        self.patches = Patches()

    def install(self):
        from covins_tpu_torch.models.map_manager import MapManager
        from covins_tpu_torch.models.placerec import PlaceRecognition
        from covins_tpu_torch.ops import descriptors, epipolar, loopverify, pgo, pnp

        sp, p = self.spans, self.patches
        p.set(PlaceRecognition, "dispatch_verify",
              sp.wrap("verify", PlaceRecognition.dispatch_verify, count="dispatch"))
        p.set(PlaceRecognition, "finalize_verify",
              sp.wrap("verify", PlaceRecognition.finalize_verify, count="finalize"))
        p.set(MapManager, "handle_loop", sp.wrap("correct", MapManager.handle_loop))
        p.set(pgo, "optimize_pose_graph",
              sp.wrap("pgo", pgo.optimize_pose_graph, sync=torch.cuda.is_available()))
        if self.mode == "COVINS":
            self._tap(descriptors, "hamming_mutual_nn", "K4", _k4_sizes)
            self._tap(pnp, "absolute_pose_ransac", "K6", _k6_sizes)
            self._tap(loopverify, "project_match_core", "K5", _k5_sizes)
        else:
            self._tap(descriptors, "hamming_ratio_match", "K11", _k11_sizes)
            self._tap(epipolar, "relpose_ransac_5pt", "K12_5pt", _k12_5pt_sizes)
            self._tap(epipolar, "ray_ransac_score", "K12_score", _k12_score_sizes)
        return self

    def _tap(self, mod, name: str, kernel: str, sizes: Callable):
        fn = getattr(mod, name)

        def recording(*args, **kwargs):
            out = fn(*args, **kwargs)
            self.work.append((kernel, sizes(out, *args, **kwargs)))
            return out
        self.patches.set(mod, name, _counting(recording))

    def remove(self):
        self.patches.restore()


# ------------------------------------------------- verification kernel sizes
# Each returns what the frozen work functions of `work.py` need: shapes as
# ints, counts as 0-d device tensors (no host sync inside the window).

def _k4_sizes(out, a, am, b, bm, max_dist):
    return {"m": a.shape[0], "n": b.shape[0], "rows": am.sum(), "cols": bm.sum()}


def _k6_sizes(out, points_w, bearings, mask, n_hypotheses=256, threshold_rad=0.0,
              noise=None, idx=None, rows=None):
    valid = mask if rows is None else mask & (rows >= 0)
    return {"n": bearings.shape[0], "rows_given": rows is not None,
            "noise": idx is None, "h": out["counts"].shape[0] // 4,
            "n_valid": valid.sum(), "valid_poses": (out["counts"] >= 0).sum()}


def _k5_sizes(out, *args, **kwargs):
    cam, p_w, kp_uv = args[0], args[2], args[7]
    return {"L": p_w.shape[0], "F": kp_uv.shape[0], "radtan": int(cam.dist_model) == 1,
            "view_angle": bool(kwargs.get("check_view_angle", True)),
            "desc_bytes": args[3].shape[-1] * args[3].element_size()}


def _k11_sizes(out, a, am, b, bm, seg, max_dist, ratio):
    return {"m": a.shape[0], "n": b.shape[0], "seg": seg, "rows": am.sum(),
            "cols": bm.sum()}


def _k12_5pt_sizes(out, fa, fb, mask, n_hypotheses=64, threshold_rad=0.004,
                   noise=None, idx=None):
    valid = out["valid"]
    hyps = valid.sum(1)
    rays = mask.sum(1)
    return {"B": mask.shape[0], "N": mask.shape[1], "H": n_hypotheses,
            "noise": idx is None, "rays": rays.sum(), "hyps": hyps.sum(),
            "hyp_rays": (hyps * rays).sum()}


def _k12_score_sizes(out, T, va, fa, vb, fb, mask, threshold_rad, valid=None,
                     want_inliers=True):
    B, H, N = T.shape[0], T.shape[1], fa.shape[1]
    hyps = valid.sum(1) if valid is not None else None
    rays = mask.sum(1)
    return {"B": B, "H": H, "N": N, "central": va is None, "has_valid": valid is not None,
            "inliers": bool(want_inliers), "rays": rays.sum(),
            "hyps": hyps.sum() if hyps is not None else B * H,
            "hyp_rays": (hyps * rays).sum() if hyps is not None else rays.sum() * H}
