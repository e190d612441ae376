"""The comparison that decides `correct`.

After the window: :func:`capture` copies what the program produced (and,
for the stages followed step by step, what it gathered) to the host, so
that the program's state can be freed before the reference runs.
:func:`reference_answers` works the answers out again in a given
precision; :func:`numbers` reads the gap between a set of answers (the
program's, or the reference's own in a lower precision: the control) and
the float64 reference, one number each, every number beside its limit.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import attributes as ref_attr
from portbench.reference import bow as ref_bow
from portbench.reference import loops as ref_loops
from portbench.reference import posegraph as ref_pg
from portbench.reference import rays as ref_rays
from portbench.reference import search as ref_search

_SHARED = ("bow_vec_gap", "bow_score_gap", "bow_common_mismatch", "attr_input_mismatch",
           "attr_gap", "attr_desc_mismatch", "loop_match_mismatch", "loop_inlier_mismatch",
           "loop_decision_mismatch", "loop_count_mismatch", "pgo_graph_mismatch",
           "pgo_start_gap", "pgo_cost_excess")
# numbers compared and the cells that have them; an exact one has limit 0
NUMBERS = {
    "COVINS": _SHARED + ("loop_input_mismatch", "loop_p3p_mismatch", "loop_ext_mismatch",
                         "loop_hood_mismatch", "loop_T_gap"),
    "COVINS_G": _SHARED + ("loop_pair_inlier_mismatch",),
}


def _sample(rng, items, k):
    if len(items) <= k:
        return list(items)
    pick = rng.choice(len(items), size=k, replace=False)
    return [items[i] for i in sorted(pick)]


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


def capture(cell, seed, mgr, win, taps, streams):
    """The program's answers on the host, and the inputs the reference
    needs, drawn from the seed."""
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFFFFFFFFFF, 91])
    db = mgr.database
    inside = {k for k, _ in win.inside()}
    queued = [(tuple(int(x) for x in k), p) for k, p in win.queued
              if p is not None and tuple(int(x) for x in k) in inside]
    sample = _sample(rng, queued, cell.mix["check"]["bow_keyframes"])
    rows = list(range(db.n))
    ids = [tuple(int(x) for x in db.row_ids[r]) for r in rows]
    desc, vio = {}, {}
    for stream in streams:
        for bundle in stream:
            kf = bundle[0]
            desc[tuple(kf.id)] = kf.descriptors
            vio[tuple(kf.id)] = np.asarray(kf.T_w_s_vio, np.float64)
    cap = {
        "row_ids": ids,
        "row_desc": [desc[i] for i in ids],
        "db": db.db[: db.n].detach().cpu().numpy(),
        "queries": [{"id": k, "row": int(p["row"]), "scores": np.asarray(p["scores"]),
                     "common": np.asarray(p["common"]), "valid": np.asarray(p["valid"])}
                    for k, p in sample],
        "cohorts": [],
        "loops": [],
        "stream_desc": desc,
        "stream_vio": vio,
        "handled": list(taps.handled),
        "counters": {"loops": mgr.n_loops, "merges": mgr.n_merges, "pgo": mgr.n_pgo},
        "n_solves": taps.n_solves,
        "pgo": [],
    }
    for packed, L, P, out, sf, nl in _sample(rng, taps.cohorts,
                                             cell.mix["check"]["attr_cohorts"]):
        cap["cohorts"].append((packed.detach().cpu().numpy(), L, P,
                               out.detach().cpu().numpy(), sf, nl))
    for rec in taps.fetched:
        rec.setdefault("accepted", None)
        for k in ("T_c_w", "T5"):
            if k in rec:
                rec[k] = _host(rec[k])
        cap["loops"].append(rec)
    for rec in taps.pgo_solves():
        if "graph" not in rec:
            continue
        g = rec.pop("graph")
        rec["graph"] = {f: _host(getattr(g, f)) for f in (
            "poses", "pose_mask", "fixed", "edge_i", "edge_j", "edge_T", "edge_sqrt_info",
            "edge_mask", "edge_is_loop")}
        rec["result"] = _host(rec["result"])
        cap["pgo"].append(rec)
    return cap


def reference_answers(cell, cap, vocab: np.ndarray, dtype_bow, dtype_geo, device):
    """The answers worked out by the reference, the database in
    ``dtype_bow`` and the geometry in ``dtype_geo``."""
    voc = torch.from_numpy(vocab).to(device)
    V = vocab.shape[0]
    words = [ref_bow.words(d, voc) for d in cap["row_desc"]]
    vecs = ref_bow.vectors(words, V, dtype_bow, device)
    row_of = {k: r for r, k in enumerate(cap["row_ids"])}
    queries = []
    for q in cap["queries"]:
        r = row_of[q["id"]]
        n = len(q["scores"])
        queries.append({"scores": ref_bow.scores(vecs[:n], vecs[r]).double().cpu().numpy(),
                        "common": ref_bow.common(vecs[:n], vecs[r]).cpu().numpy()})
    cohorts = []
    for packed, L, P, _, sf, nl in cap["cohorts"]:
        pos, centers, octaves, descs, mask = ref_attr.unpack_input(packed, L, P)
        normal, rng = ref_attr.geometry(pos, centers, octaves, mask, dtype_geo, sf, nl)
        cohorts.append({"desc": ref_attr.representative(descs, mask), "normal": normal,
                        "range": rng, "any": mask.any(1)})
    return {"vecs": vecs.double().cpu().numpy(), "queries": queries, "cohorts": cohorts,
            "loops": loop_answers(cell, cap, dtype_geo),
            "pgo": pgo_answers(cell, cap, dtype_geo, device)}


def program_answers(cap):
    cohorts = []
    for packed, L, P, out, _, _ in cap["cohorts"]:
        desc, normal, rng = ref_attr.unpack_output(out, L)
        cohorts.append({"desc": desc, "normal": normal, "range": rng})
    return {"vecs": cap["db"].astype(np.float64), "queries": cap["queries"],
            "cohorts": cohorts}


def _finite(T) -> bool:
    return T is not None and bool(np.all(np.isfinite(np.asarray(T, np.float64))))


def numbers(cell, cap, ans, ref, loop_T=None, pgo_P=None) -> dict:
    """Each number's reading for the answers ``ans`` against the float64
    reference ``ref``.  ``loop_T`` ({index: T_12}) replaces the program's
    loop transforms and ``pgo_P`` ({index: poses}) its pose-graph results
    (the control's)."""
    mode = cell.mode
    th = cell.config["thresholds"]
    out = {}
    out["bow_vec_gap"] = float(np.abs(ans["vecs"] - ref["vecs"]).max()) if len(
        ref["vecs"]) else 0.0
    gap, mism = 0.0, 0
    for q, a, r in zip(cap["queries"], ans["queries"], ref["queries"]):
        v = q["valid"]
        s = np.asarray(a["scores"], np.float64)[v]
        gap = max(gap, float(np.abs(s - r["scores"][v]).max()) if v.any() else 0.0)
        mism += int((np.asarray(a["common"])[v] != r["common"][v]).sum())
    out["bow_score_gap"] = gap
    out["bow_common_mismatch"] = mism
    # the refresh's start: every gathered observation descriptor is one an
    # agent sent
    sent = {row.tobytes() for d in cap["stream_desc"].values() for row in d}
    bad = 0
    for packed, L, P, _, _, _ in cap["cohorts"]:
        _, _, _, descs, mask = ref_attr.unpack_input(packed, L, P)
        bad += sum(row.tobytes() not in sent for row in descs[mask])
    out["attr_input_mismatch"] = bad
    gap, mism = 0.0, 0
    for a, r in zip(ans["cohorts"], ref["cohorts"]):
        m = r["any"]
        if not m.any():
            continue
        gap = max(gap, float(np.abs(a["normal"][m] - r["normal"][m]).max()))
        rel = np.abs(a["range"][m] - r["range"][m]) / np.maximum(np.abs(r["range"][m]), 1e-12)
        gap = max(gap, float(rel.max()))
        mism += int((a["desc"][m] != r["desc"][m]).any(1).sum())
    out["attr_gap"] = gap
    out["attr_desc_mismatch"] = mism
    loops = cap["loops"]
    decision = 0
    if mode == "COVINS":
        inp = match = p3p = ext = hood = inl = 0
        gap = 0.0
        for i, rec in enumerate(loops):
            a, o, r = rec["arrays"], rec["out"], ref["loops"][i]
            v = a["q_obs_valid"]
            want = cap["stream_desc"][rec["query"]][a["q_obs_feat"][v]]
            inp += int((a["q_obs_desc"][v] != want).any(1).sum())
            match += int((r["midx"] != o["midx"]).sum())
            decision += int(r["accept"] != rec["accepted"])
            if r["n_inl2"] is not None:
                p3p += abs(r["n_inl2"] - int(o["n_inl2"]))
            if r["ext"] is not None:
                ext += ref_search.mismatch(o["mfeat"], r["ext"])
            if r["hood"] is not None:
                hood += ref_search.mismatch(o["hfeat"], r["hood"])
            if r["n_inl4"] is not None and loop_T is None:
                inl += abs(r["n_inl4"] - int(o["n_inl4"]))
            if o["ok"] and r["T_12"] is not None:
                T_ans = o["T_12"] if loop_T is None else loop_T.get(i, o["T_12"])
                gap = max(gap, ref_loops.pose_gap(T_ans, r["T_12"]))
        out.update(loop_input_mismatch=inp, loop_match_mismatch=match,
                   loop_p3p_mismatch=p3p, loop_ext_mismatch=ext, loop_hood_mismatch=hood,
                   loop_inlier_mismatch=inl, loop_T_gap=gap)
    else:
        match = pair = inl = 0
        for i, rec in enumerate(loops):
            o, r = rec["out"], ref["loops"][i]
            match += int(np.abs(r["pair_n_match"] - o["pair_n_match"]).sum())
            for n, (lo, hi) in zip(o["pair_n_inl"], r["pair_rng"]):
                pair += max(0, lo - int(n), int(n) - hi)
            lo, hi = r["n17_rng"]
            inl += max(0, lo - int(o["n_inliers"]), int(o["n_inliers"]) - hi)
            decision += int(r["accept"] != rec["accepted"])
        out.update(loop_match_mismatch=match, loop_pair_inlier_mismatch=pair,
                   loop_inlier_mismatch=inl)
    out["loop_decision_mismatch"] = decision
    out["loop_count_mismatch"] = count_mismatch(cap)
    out.update(pgo_numbers(cell, cap, ref["pgo"], pgo_P))
    return out


# ------------------------------------------------------------------ loops
def loop_answers(cell, cap, dtype) -> list:
    """Each fetched verification worked out again, one dict each.

    COVINS: stage 1 (mutual nearest neighbours); stage 2's inliers at its
    own pose; stage 3, the search through that pose for the candidate's
    landmarks stage 1 left; stage 4 whole in ``dtype`` from stage 2's pose
    on those matches; stage 5, the search of the loop neighbourhood
    through stage 4's transform; and the accept test on the counts, each
    stage worked out only where the gates before it hold.  COVINS-G:
    :func:`rays.verify`.  Counts and searches are float64 whatever
    ``dtype``: they are the program's exact answers."""
    c = cell.config
    th, cam = c["thresholds"], c["camera"]
    out = []
    for rec in cap["loops"]:
        if cell.mode != "COVINS":
            out.append(ref_rays.verify(cam, rec, th, dtype))
            continue
        a, o = rec["arrays"], rec["out"]
        r = {"n_inl2": None, "ext": None, "n_inl4": None, "hood": None, "T_12": None}
        midx = ref_loops.mutual_nn(a["q_obs_desc"], a["q_obs_valid"], a["c_obs_desc"],
                                   a["c_obs_valid"], th["desc_matching_th_low"])
        r["midx"] = midx
        matched = (midx >= 0) & a["q_obs_valid"]
        n_matched = int(matched.sum())
        thres = th["matches_thres"] if rec["same_map"] else th["matches_thres_merge"]
        ok = n_matched >= min(thres, 8)
        T_c_w = rec["T_c_w"]
        if _finite(T_c_w):
            thr2 = float(np.arctan2(th["ransac_class_threshold"], cam["intrinsics"][0]))
            # no minimal set below three matches: no inliers
            r["n_inl2"] = ref_loops.p3p_inliers(a, midx, T_c_w, cam, thr2) if (
                n_matched >= 3) else 0
            ok = ok and r["n_inl2"] >= th["ransac_min_inliers"]
            # stage 3: the candidate's landmarks stage 1 left, the query's
            # features no stage-1 match took
            F, C = len(a["kp_valid"]), len(a["c_obs_valid"])
            taken = np.zeros(F, bool)
            taken[a["q_obs_feat"][matched]] = True
            c_already = np.zeros(C, bool)
            c_already[midx[matched]] = True
            free_lm = a["c_obs_valid"] & ~c_already & a["c_lm_alive"]
            free_kp = a["kp_valid"] & ~taken
            r["ext"] = [ref_search.search(
                cam, T_c_w, a["c_lm_w"], a["c_lm_desc"], a["c_lm_normal"], a["c_lm_rng"],
                free_lm, a["kp_uv"], a["kp_desc"], a["kp_oct"], free_kp,
                th["search_radius_SE3"], th["desc_matching_th_low"], False, s)
                for s in (0, -1, 1)]
        else:
            ok = False
        if ok:
            T0 = ref_loops.initial_T12(T_c_w, a["T_wc_sc"], cam["T_s_c"])
            T12, n4 = ref_loops.refine(a, o, cam, th["th_outlier_align"], dtype, T0)
            r["T_12"], r["n_inl4"] = T12, n4
            ok = n4 >= th["inliers_thres"]
        if ok and _finite(o["T_12"]):
            # stage 5 through the program's T_12 (held to stage 4's above)
            ext = np.asarray(o["mfeat"]) >= 0
            pair_rows = np.concatenate([a["c_lm_row"][np.clip(midx, 0, None)][matched],
                                        a["c_lm_row"][ext]])
            free_h = a["hood_alive"] & ~np.isin(a["hood_lm_row"], pair_rows)
            taken5 = np.zeros(len(a["kp_valid"]), bool)
            taken5[a["q_obs_feat"][matched]] = True
            taken5[np.asarray(o["mfeat"])[ext]] = True
            T = torch.from_numpy(np.asarray(o["T_12"], np.float64))
            Tc = torch.from_numpy(np.asarray(a["T_wc_sc"], np.float64))
            Tsc = torch.tensor(cam["T_s_c"], dtype=torch.float64)
            # T_cq_w = T_s_c^-1 (T_wc_sc T_12^-1)^-1
            T_cqw = ref_pg.compose(ref_pg.inverse(Tsc),
                                   ref_pg.inverse(ref_pg.compose(Tc, ref_pg.inverse(T)))).numpy()
            r["hood"] = [ref_search.search(
                cam, T_cqw, a["hood_lm_w"], a["hood_desc"], a["hood_normal"], a["hood_rng"],
                free_h, a["kp_uv"], a["kp_desc"], a["kp_oct"], a["kp_valid"] & ~taken5,
                th["search_radius_proj"], th["desc_matching_th_low"], True, s)
                for s in (0, -1, 1)]
            n_ext = int((r["ext"][0] >= 0).sum())
            n_total = n_matched + n_ext + int((r["hood"][0] >= 0).sum())
            ok = n_total >= th["total_matches_thres"]
        r["accept"] = bool(ok)
        out.append(r)
    return out


def count_mismatch(cap) -> int:
    """Loops and merges against what the accepted verifications imply: each
    handled loop is a merge where its two keyframes' agents are in
    different maps (the maps joined thereafter), a loop where they share
    one, and ignored where the pair was handled before; the program's
    counters over the window against those counts, and as many handled
    as accepted."""
    root = {}

    def find(a):
        while root.get(a, a) != a:
            a = root[a]
        return a
    seen, bad = set(), 0
    n = {"loop": 0, "merge": 0}
    for qid, cid, outcome, _, _ in cap["handled"]:
        ra, rb = find(qid[1]), find(cid[1])
        pair = frozenset((qid, cid))
        if ra != rb:
            want = "merge"
            root[ra] = rb
        else:
            want = "ignored" if pair in seen else "loop"
        if want != "ignored":
            seen.add(pair)
            n[want] += 1
        bad += int(want != outcome)
    c = cap["counters"]
    bad += abs(c["merges"] - n["merge"]) + abs(c["loops"] - n["merge"] - n["loop"])
    bad += abs(sum(1 for r in cap["loops"] if r["accepted"]) - len(cap["handled"]))
    return bad


# ------------------------------------------------------------ pose graph
def _pgo_weights(cell) -> dict:
    return cell.config["thresholds"]["pose_graph"]


def _ref_graph(cell, cap, rec):
    """The reference's edges of a solve's map: odometry from the streams,
    each loop or merge handled before the solve between two of its
    keyframes."""
    loops = [(q, c, T, cov) for q, c, outcome, T, cov in cap["handled"][:rec["handled"]]
             if outcome in ("loop", "merge")]
    return ref_pg.build(rec["kf_ids"], cap["stream_vio"], loops, _pgo_weights(cell))


def ref_fixed(rec) -> np.ndarray:
    """The gauge: the map's first live keyframe."""
    live = np.where(np.asarray(rec["kf_mask"], bool))[0]
    fixed = np.zeros(len(rec["kf_ids"]), bool)
    fixed[live[:1]] = True
    return fixed


def graph_mismatch(edges, g, fixed) -> int:
    """Edges of the program's graph and the reference's that differ: by
    their two keyframe rows and kind, their measurement (1e-9 in any entry
    of the pose, the quaternions of one sign) and their weight (1e-6 of
    its largest entry); an edge of no weight (a graph of one keyframe)
    counts for nothing.  And each pose fixed in one and not the other."""
    mask = np.asarray(g["edge_mask"], bool) & (
        np.abs(np.asarray(g["edge_sqrt_info"])).reshape(len(g["edge_mask"]), -1).max(1) > 0)
    prog = {}
    for e in np.where(mask)[0]:
        key = (int(g["edge_i"][e]), int(g["edge_j"][e]), bool(g["edge_is_loop"][e]))
        prog.setdefault(key, []).append((g["edge_T"][e], g["edge_sqrt_info"][e]))
    bad = 0
    for i, j, T, S, loop in edges:
        got = prog.get((i, j, loop))
        if not got:
            bad += 1
            continue
        Tp, Sp = got.pop(0)
        if (ref_loops.pose_gap(Tp, T) > 1e-9
                or np.abs(Sp - S).max() > 1e-6 * max(np.abs(S).max(), 1e-300)):
            bad += 1
    bad += int((np.asarray(g["fixed"], bool) != fixed).sum())
    return bad + sum(len(v) for v in prog.values())


def start_gap(rec) -> float:
    """A solve that a loop seeds starts from the correction (`ConnectLoop`):
    the world-frame delta that puts the query where the candidate and the
    loop's T_12 place it, applied to the query and to a set of its
    neighbours, every other keyframe where it was.  The largest gap of a
    start pose from both; the query's from the corrected pose alone."""
    if not rec["seeded"] or rec["last_loop"] is None:
        return 0.0
    before = torch.from_numpy(np.asarray(rec["pose_before"], np.float64))
    start = np.asarray(rec["graph"]["poses"], np.float64)
    lc = rec["last_loop"]
    q, c = int(lc["kf1"]), int(lc["kf2"])
    T12 = torch.from_numpy(np.asarray(lc["T_12"], np.float64))
    corr = ref_pg.compose(before[c], ref_pg.inverse(T12))
    delta = ref_pg.compose(corr, ref_pg.inverse(before[q]))
    moved = ref_pg.compose(delta[None].expand(len(before), 7), before).numpy()
    fixed = np.asarray(rec["graph"]["fixed"], bool)
    gap = ref_loops.pose_gap(start[q], moved[q]) if not fixed[q] else 0.0
    for r in range(len(before)):
        gap = max(gap, min(ref_loops.pose_gap(start[r], before[r].numpy()),
                           ref_loops.pose_gap(start[r], moved[r])))
    return gap


def pgo_answers(cell, cap, dtype, device) -> list:
    """For each solve kept: the reference's optimum of its own graph from the
    program's start, in ``dtype``, and its cost at the start and there."""
    out = []
    delta = _pgo_weights(cell)["robust_loss_threshold"]
    for rec in cap["pgo"]:
        edges = _ref_graph(cell, cap, rec)
        fixed = ref_fixed(rec)
        r = {"edges": edges, "fixed": fixed, "problem": None}
        out.append(r)
        if not edges:
            continue
        n = len(rec["kf_ids"])
        prob = ref_pg.Problem(edges, n, fixed, delta, torch.float64, device)
        P0 = torch.from_numpy(np.asarray(rec["graph"]["poses"], np.float64)).to(device)
        if dtype != torch.float64:
            sol = ref_pg.Problem(edges, n, fixed, delta, dtype, device).solve(P0)
        else:
            sol = prob.solve(P0)
        r.update(poses=sol.double().cpu().numpy(), cost_start=prob.cost(P0),
                 cost_best=prob.cost(sol.double()), problem=prob)
    return out


def pgo_numbers(cell, cap, ref, pgo_P=None) -> dict:
    """The graphs, the starts and the share of the reference's cost
    reduction each solve left undone: (cost at the result - the
    reference's optimum) over (cost at the start - optimum); a solve that
    returns its start reads 1."""
    graph = 0
    start = excess = 0.0
    for i, (rec, r) in enumerate(zip(cap["pgo"], ref)):
        graph += graph_mismatch(r["edges"], rec["graph"], r["fixed"])
        start = max(start, start_gap(rec))
        if r["problem"] is None:
            continue
        P = rec["result"] if pgo_P is None else pgo_P[i]
        c0, c1 = r["cost_start"], r["cost_best"]
        if c0 - c1 <= 1e-12 * (1.0 + c0):
            continue  # nothing to reduce: the start is the optimum
        prob = r["problem"]
        c = prob.cost(torch.as_tensor(np.asarray(P, np.float64), device=prob.device))
        excess = max(excess, (c - c1) / (c0 - c1))
    return {"pgo_graph_mismatch": graph, "pgo_start_gap": start, "pgo_cost_excess": excess}


def verdict(readings: dict, limits: dict):
    """(correct, [(name, reading, limit)]): each reading at most its limit."""
    rows = [(k, readings[k], limits[k]) for k in readings]
    return all(r <= lim for _, r, lim in rows), rows
