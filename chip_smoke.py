#!/usr/bin/env python3
"""Chip check of the covins_tpu_torch port on one CUDA card.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It fails
(nonzero exit, no result line) without a CUDA card or without the
package beside it.  Phases:

0. the card's name and power limit, torch/CUDA versions, and the build of
   every kernel in ``covins_tpu_torch/csrc`` (one nvcc per source, in
   parallel);
1. each kernel against its plain PyTorch version on the card, on inputs
   made from a numpy seed at the main path's shapes and at ragged ones:
   K1, K2, K4 and K5 exactly, K3 to rtol 1e-6, K6 exactly up to
   correspondences within 1e-12 rad of the threshold, K7 to 1e-12
   relative and bit for bit across two launches;
2. the full main path at the workload of the JAX package's benchmark
   (2 agents x 128 KF over 2000 landmarks, 512-word vocabulary trained on
   the card, 1024-message windows, the default ``Config()`` with
   ``placerec_defer=True``): a warm-up on the stream's first windows, then
   the measured pass with every launch counter set to 0 just before it
   and read just after, timing the ingest and the place-recognition drain
   apart; traced runs (device busy time from torch.profiler over the
   ingest and the first agent's drain, host self time by layer from
   cProfile over the second agent's drain and an ingest); then the same
   streams through the port on the CPU (plain versions, 4 torch threads),
   compared with the card's run on loops, merges, accepted pairs, loop
   transforms and every map's poses; then each kernel replayed on the
   card on the largest input the CPU pass gave it, against its plain
   version, timed beside its bound;
3. a five-agent deployment (5 x 32 KF) with place recognition on, card
   only;
4. the ingest-only path (``placerec_active=False``) on the benchmark
   workload, card against CPU, every map array and database row compared;
5. one JSON line per the kernel table, the card line, and the result
   line ``{"ok": true, "device": {...}}``.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

# published peaks of one H100 SXM (dense): HBM bytes/s, int8 tensor ops/s,
# float32 and float64 ops/s outside the tensor cores
HBM_BYTES_S = 3.35e12
INT8_OPS_S = 1979e12
FP32_OPS_S = 67e12
FP64_OPS_S = 34e12

SEED = 0
WINDOW = 1024
# the warm-up's share of the bench stream: its first windows' drain already
# closes loops, merges the two agents' maps and solves a pose graph
WARM_WINDOWS = 4
# How far the card's run of the full path may differ from the CPU's.  Both
# take the same RANSAC draws (one seeded CPU generator per agent) and the
# same algorithms; they differ only where the card's transcendental
# functions, FMA contraction in library kernels and summation orders round
# differently from the CPU's (about 1e-15).  On the bench workload that
# reaches the refined loop transforms at about 1e-8: two CPU runs that
# differ only in their thread count end 3.6e-8 apart
# (scripts/port_pose_sensitivity.py), so loop transforms are held to
# LOOP_TOL.  The final poses come out of the pose-graph solves, whose
# 10 x 100 PCG steps are far from converged (300 steps move poses by 0.09)
# and amplify a change of their inputs about 2600-fold (a 1e-11 relative
# change of the edge measurements moves poses by 2.6e-8); the same two CPU
# runs end 1.8e-5 apart.  A pose bound consistent with LOOP_TOL is
# therefore POSE_TOL, still far below what a different loop or merge
# decision moves (centimetres).
LOOP_TOL = 1e-6
POSE_TOL = 1e-3
CPU_THREADS = 4  # the CPU passes' torch threads: more only add overhead
                 # on the plain versions' many small operations


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    """Mean device time of ``fn`` over ``reps`` launches (CUDA events)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(bytes_moved, *ops_at_rate):
    """Least time (ms) for the work: bytes over the HBM rate against the
    operations of each type over that type's peak, summed."""
    t_bytes = bytes_moved / HBM_BYTES_S * 1e3
    t_ops = sum(ops / rate for ops, rate in ops_at_rate) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --------------------------------------------------------------------- kernels
def pm1_bf16_argmin(a, b):
    """The JAX package's formulation as one PyTorch product: unpack to ±1,
    bf16 matmul, argmin (a yardstick only; the port never calls it)."""
    import torch

    from covins_tpu_torch.ops.descriptors import unpack_to_pm1

    dot = unpack_to_pm1(a, torch.bfloat16) @ unpack_to_pm1(b, torch.bfloat16).T
    return torch.argmin(dot.float().neg(), dim=1)


def k1_case(a, b, mask, reps):
    import torch

    from covins_tpu_torch.ops import descriptors as d

    idx, dmin = d.hamming_argmin(a, b, mask)
    idx_p, dmin_p = d.hamming_argmin_plain(a, b, mask)
    torch.cuda.synchronize()
    check(torch.equal(idx, idx_p) and torch.equal(dmin, dmin_p),
          f"K1 disagrees with its plain version at {tuple(a.shape)}x{tuple(b.shape)}")
    m, n = a.shape[0], b.shape[0]
    bnd, by = bound(m * 32 + n * 32 + m + 8 * m, (2.0 * m * n * 256, INT8_OPS_S))
    return {
        "kernel_ms": cuda_ms(lambda: d.hamming_argmin(a, b, mask), reps),
        "plain_ms": cuda_ms(lambda: d.hamming_argmin_plain(a, b, mask), reps),
        "library_ms": cuda_ms(lambda: pm1_bf16_argmin(a, b), reps),
        "bound_ms": bnd, "bound_by": by,
        "max_abs_err": int((idx - idx_p).abs().max().item()) if m else 0,
    }


def k2_case(descs, mask, reps):
    import torch

    from covins_tpu_torch.ops import landmark_ops as lo

    out = lo.representative_descriptors(descs, mask)
    ref = lo.representative_descriptors_plain(descs, mask)
    torch.cuda.synchronize()
    check(torch.equal(out, ref), f"K2 disagrees at {tuple(descs.shape)}")
    L, P, _ = descs.shape
    bnd, by = bound(L * P * 33 + L * 32, (2.0 * L * P * P * 256, INT8_OPS_S))
    return {
        "kernel_ms": cuda_ms(lambda: lo.representative_descriptors(descs, mask), reps),
        "plain_ms": cuda_ms(lambda: lo.representative_descriptors_plain(descs, mask), reps),
        "library_ms": None,
        "bound_ms": bnd, "bound_by": by,
        "max_abs_err": int((out.int() - ref.int()).abs().max().item()),
    }


def k3_case(words, dest, db, reps):
    import torch

    from covins_tpu_torch.ops import bow

    db_k, db_p = db.clone(), db.clone()
    vecs = bow.bow_insert(words, dest, db_k)
    ref = bow.bow_insert_plain(words, dest, db_p)
    torch.cuda.synchronize()
    # the word counts, recovered from the vectors with the exact norms
    V = db.shape[1]
    valid = (words >= 0) & (words < V)
    counts = torch.zeros((words.shape[0], V), device=words.device).scatter_add_(
        1, torch.where(valid, words, 0).long(), valid.float())
    norm = torch.clamp(counts.square().sum(1, keepdim=True).sqrt(), min=1e-12)
    check(torch.equal(torch.round(vecs * norm), counts), "K3 word counts disagree")
    check(torch.allclose(vecs, ref, rtol=1e-6, atol=0), "K3 vectors disagree")
    check(torch.allclose(db_k, db_p, rtol=1e-6, atol=0), "K3 database rows disagree")
    W, F = words.shape
    stored = int(((dest >= 0) & (dest < db.shape[0])).sum().item())
    bnd, by = bound(W * F * 4 + W * 8 + (W + stored) * V * 4,
                    (W * F + 3.0 * W * V, FP32_OPS_S))
    return {
        "kernel_ms": cuda_ms(lambda: bow.bow_insert(words, dest, db_k), reps),
        "plain_ms": cuda_ms(lambda: bow.bow_insert_plain(words, dest, db_p), reps),
        "library_ms": None,
        "bound_ms": bnd, "bound_by": by,
        "max_abs_err": float((vecs - ref).abs().max().item()),
    }


def k4_case(a, am, b, bm, max_dist, reps):
    import torch

    from covins_tpu_torch.ops import descriptors as d

    got = d.hamming_mutual_nn(a, am, b, bm, max_dist)
    ref = d.hamming_mutual_nn_plain(a, am, b, bm, max_dist)
    torch.cuda.synchronize()
    check(torch.equal(got, ref),
          f"K4 disagrees with its plain version at {tuple(a.shape)}x{tuple(b.shape)}")
    m, n = a.shape[0], b.shape[0]
    n_rows, n_cols = int(am.sum().item()), int(bm.sum().item())
    # every valid (row, column) pair is compared twice: row and column argmin
    bnd, by = bound((m + n) * 33 + m * 4,
                    (2 * 2.0 * n_rows * n_cols * 256, INT8_OPS_S))
    return {
        "kernel_ms": cuda_ms(lambda: d.hamming_mutual_nn(a, am, b, bm, max_dist), reps),
        "plain_ms": cuda_ms(lambda: d.hamming_mutual_nn_plain(a, am, b, bm, max_dist),
                            reps),
        "library_ms": None,
        "bound_ms": bnd, "bound_by": by,
        "max_abs_err": int((got - ref).abs().max().item()) if m else 0,
        "matches": int((got >= 0).sum().item()),
    }


def k5_case(args, max_dist, reps):
    import torch

    from covins_tpu_torch.ops import projmatch as pm

    feat, dist = pm.gated_match(*args, max_dist)
    rfeat, rdist = pm.gated_match_plain(*args, max_dist)
    torch.cuda.synchronize()
    L, F = args[0].shape[0], args[5].shape[0]
    check(torch.equal(feat, rfeat) and torch.equal(dist, rdist),
          f"K5 disagrees with its plain version at {L}x{F}")
    # the pairs this data needs: passing landmarks x free features, each a
    # float64 gate (about 10 operations) and a 256-bit Hamming distance
    pairs = float(args[1].sum().item()) * float(args[8].sum().item())
    bnd, by = bound(L * 58 + F * 65 + L * 8,
                    (pairs * 512, INT8_OPS_S), (pairs * 10, FP64_OPS_S))
    return {
        "kernel_ms": cuda_ms(lambda: pm.gated_match(*args, max_dist), reps),
        "plain_ms": cuda_ms(lambda: pm.gated_match_plain(*args, max_dist), reps),
        "library_ms": None,
        "bound_ms": bnd, "bound_by": by,
        "max_abs_err": int((feat - rfeat).abs().max().item()) if L else 0,
        "matches": int((feat >= 0).sum().item()),
    }


def k6_case(T, P, B, mask, valid, thr, reps):
    import torch

    from covins_tpu_torch.ops import pnp

    counts, best, inl, n_inl = pnp.p3p_score(T, P, B, mask, valid, thr)
    rcounts, rbest, rinl, rn = pnp.p3p_score_plain(T, P, B, mask, valid, thr)
    torch.cuda.synchronize()
    err = pnp.reprojection_angular_error(T, P, B)
    near = ((err - thr).abs() <= 1e-12) & mask[None, :] & valid[:, None]
    n_near = int(near.sum().item())
    same = (torch.equal(counts, rcounts) and int(best) == int(rbest)
            and torch.equal(inl, rinl) and int(n_inl) == int(rn))
    # the one allowed difference: a correspondence within 1e-12 rad of the
    # threshold may fall on either side, by at most one count per pose
    check(same or (n_near > 0 and bool(((counts - rcounts).abs()
                                        <= near.sum(1)).all())),
          f"K6 disagrees with its plain version at {tuple(T.shape)}x{P.shape[0]}")
    H, N = T.shape[0], P.shape[0]
    n_mask = int(mask.sum().item())
    bnd, by = bound(H * 56 + N * 48 + N + H + H * 4 + N + 12,
                    (45.0 * H * n_mask, FP64_OPS_S))
    return {
        "kernel_ms": cuda_ms(lambda: pnp.p3p_score(T, P, B, mask, valid, thr), reps),
        "plain_ms": cuda_ms(lambda: pnp.p3p_score_plain(T, P, B, mask, valid, thr),
                            reps),
        "library_ms": None,
        "bound_ms": bnd, "bound_by": by,
        "max_abs_err": int((counts - rcounts).abs().max().item()),
        "near_threshold": n_near, "best": int(best), "n_inliers": int(n_inl),
    }


def k7_case(v, free, Ji, Jj, graph, damping, reps):
    import torch

    from covins_tpu_torch.ops import pgo

    out = pgo.matvec(v, free, Ji, Jj, graph, damping)
    again = pgo.matvec(v, free, Ji, Jj, graph, damping)
    ref = pgo.matvec_plain(v, free, Ji, Jj, graph, damping)
    torch.cuda.synchronize()
    check(torch.equal(out, again), "K7 differs between two launches")
    rel = float(((out - ref).abs().max() / ref.abs().max().clamp(min=1e-300)).item())
    check(rel <= 1e-12, f"K7 relative error {rel} against its plain version")
    N, E = v.shape[0], Ji.shape[0]
    bnd, by = bound(2 * E * 36 * 8 + N * 6 * 8 * 2 + N * 8 + E * 8
                    + (N + 1) * 4 + 2 * E * 4, (300.0 * E, FP64_OPS_S))
    return {
        "kernel_ms": cuda_ms(lambda: pgo.matvec(v, free, Ji, Jj, graph, damping), reps),
        "plain_ms": cuda_ms(lambda: pgo.matvec_plain(v, free, Ji, Jj, graph, damping),
                            reps),
        "library_ms": None,
        "bound_ms": bnd, "bound_by": by,
        "max_abs_err": float((out - ref).abs().max().item()), "max_rel_err": rel,
    }


def _k4_inputs(rng, m, n, nq, nc, t):
    a = rng.integers(0, 256, (m, 32), dtype=np.uint8)
    b = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    k = min(nq, nc) // 2
    a[:k] = b[:k]  # true matches
    a[k:2 * k] = b[:k]  # a second row per column: ties to the lowest row
    a[: k // 2, 0] ^= 1  # ... at distance 1 for some
    return t(a), t(np.arange(m) < nq), t(b), t(np.arange(n) < nc)


def _k5_inputs(rng, L, F, t):
    uv = rng.uniform(0, 752, (L, 2))
    kp_uv = rng.uniform(0, 752, (F, 2))
    k = min(L, F)
    kp_uv[:k] = uv[:k] + rng.normal(scale=3.0, size=(k, 2))
    lm_desc = rng.integers(0, 256, (L, 32), dtype=np.uint8)
    kp_desc = rng.integers(0, 256, (F, 32), dtype=np.uint8)
    kp_desc[:k] = lm_desc[:k]
    kp_desc[: k // 3, 5] ^= 0xF0
    lm_desc[L // 2:] = lm_desc[: L - L // 2]  # duplicated landmarks: conflicts
    kp_oct = rng.integers(0, 8, F).astype(np.float64)
    arrays = (uv, rng.random(L) > 0.3, rng.integers(0, 8, L).astype(np.float64),
              rng.random(L) > 0.5, lm_desc, kp_uv, kp_oct,
              10.0 * 2.0 ** kp_oct, rng.random(F) > 0.2, kp_desc)
    return [t(np.ascontiguousarray(x)) for x in arrays]


def _k6_inputs(rng, H, N, t):
    import torch

    q = rng.normal(size=(H, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    T = np.concatenate([q, 0.1 * rng.normal(size=(H, 3))], 1)
    T[: H // 4] = T[H // 4: 2 * (H // 4)]  # tied counts: the first wins
    P = rng.normal(size=(N, 3)) + [0, 0, 5]
    # bearings of the points under pose 7, with noise: some poses score
    from covins_tpu_torch.utils import geometry as geo
    p_c = geo.pose_apply(torch.tensor(T[7 % H]), torch.tensor(P)).numpy()
    B = p_c + 0.01 * rng.normal(size=p_c.shape)
    B /= np.linalg.norm(B, axis=1, keepdims=True)
    return [t(x) for x in (T, P, B, rng.random(N) > 0.7, rng.random(H) > 0.2)]


def _k7_inputs(rng, N, E, dev):
    import torch

    from covins_tpu_torch.ops import pgo

    ei = rng.integers(0, N, E)
    ej = (ei + rng.integers(1, 6, E)) % N
    f64 = dict(dtype=torch.float64, device=dev)
    graph = pgo.matvec_graph(torch.tensor(ei, device=dev),
                             torch.tensor(ej, device=dev), N)
    return (torch.tensor(rng.normal(size=(N, 6)), **f64),
            torch.tensor((np.arange(N) > 0).astype(np.float64), **f64),
            torch.tensor(rng.normal(size=(E, 6, 6)), **f64),
            torch.tensor(rng.normal(size=(E, 6, 6)), **f64), graph)


def phase1(dev):
    """Kernels against their plain versions on the card, with edge cases."""
    import torch

    from covins_tpu_torch.ops import bow, descriptors, landmark_ops

    rng = np.random.default_rng(SEED)
    t = lambda x: torch.from_numpy(x).to(dev)  # noqa: E731
    for m, n in ((8192, 512), (65536, 1024)):
        a = rng.integers(0, 256, (m, 32), dtype=np.uint8)
        b = rng.integers(0, 256, (n, 32), dtype=np.uint8)
        b[9] = b[4]  # tied words
        a[:64] = b[4]
        mask = rng.random(m) > 0.1
        r = k1_case(t(a), t(b), t(mask), reps=20)
        ia, _ = descriptors.hamming_argmin(t(a[:64]), t(b))
        check(bool((ia == 4).all()), "K1 tie does not go to the lowest index")
        print(json.dumps({"phase": 1, "kernel": "hamming_argmin",
                          "shape": [m, n, 256], **r}))

    L, P = 8192, 16
    d = rng.integers(0, 256, (L, P, 32), dtype=np.uint8)
    d[:, 6] = d[:, 2]  # duplicate descriptors
    mask = rng.random((L, P)) > 0.5
    for i, nv in enumerate((0, 1, 2, 16)):
        mask[i] = False
        mask[i, :nv] = True
    r = k2_case(t(d), t(mask), reps=20)
    print(json.dumps({"phase": 1, "kernel": "representative_descriptors",
                      "shape": [L, P, 32], **r}))

    W, F, V, cap = 256, 1024, 512, 1024
    words = rng.integers(-1, V, (W, F)).astype(np.int32)
    words[7] = -1  # empty row
    dest = np.arange(W, dtype=np.int64) + 3
    dest[11] = cap  # dropped
    r = k3_case(t(words), t(dest), torch.zeros((cap, V), device=dev), reps=20)
    print(json.dumps({"phase": 1, "kernel": "bow_insert",
                      "shape": [W, F, V, cap], **r}))

    # K4 at the verification's padded 1024 x 1024 and ragged sizes
    for m, n, nq, nc in ((1024, 1024, 420, 390), (1, 1, 1, 1), (5, 70, 5, 61),
                         (300, 129, 300, 129)):
        r = k4_case(*_k4_inputs(rng, m, n, nq, nc, t), 50.0, reps=20)
        print(json.dumps({"phase": 1, "kernel": "hamming_mutual_nn",
                          "shape": [m, n], **r}))
    # K5 at stage 3's 1024 x 1024, stage 5's largest neighbourhood and
    # ragged sizes
    for L, F in ((1024, 1024), (10070, 1024), (1, 1), (37, 70), (3001, 257)):
        r = k5_case(_k5_inputs(rng, L, F, t), 50.0, reps=10)
        print(json.dumps({"phase": 1, "kernel": "project_match",
                          "shape": [L, F], **r}))
    # K6 at 300 hypotheses x 4 roots against 1024 correspondences, ragged
    for H, N in ((1200, 1024), (1, 3), (37, 100)):
        r = k6_case(*_k6_inputs(rng, H, N, t), 0.0545, reps=20)
        print(json.dumps({"phase": 1, "kernel": "p3p_score", "shape": [H, N], **r}))
    # K7 at the merged bench map's graph size, ragged
    for N, E in ((256, 1300), (1, 1), (9, 20)):
        r = k7_case(*_k7_inputs(rng, N, E, dev), 1e-6, reps=50)
        print(json.dumps({"phase": 1, "kernel": "pgo_matvec", "shape": [N, E], **r}))


# -------------------------------------------------------------------- main path
def make_windows(streams):
    """Interleave the agent streams into windows of WINDOW messages, the
    way the server worker drains them (per-client order preserved)."""
    windows = []
    cursors = [0] * len(streams)
    while any(c < len(s) for c, s in zip(cursors, streams)):
        window = {}
        budget = WINDOW
        while budget > 0:
            progressed = False
            for cid, s in enumerate(streams):
                if cursors[cid] < len(s) and budget > 0:
                    window.setdefault(cid, []).append(s[cursors[cid]])
                    cursors[cid] += 1
                    budget -= 1
                    progressed = True
            if not progressed:
                break
        windows.append(window)
    return windows


def build_streams(n_agents, n_kf, n_landmarks, max_features=None):
    from covins_tpu_torch.agents.synthetic_agent import SyntheticAgent, SyntheticWorld

    world = SyntheticWorld.create(n_landmarks=n_landmarks, seed=SEED)
    streams = [list(SyntheticAgent(world, cid, n_keyframes=n_kf, t0=5.0 * cid,
                                   pose_drift=0.02,
                                   max_features=max_features).messages())
               for cid in range(n_agents)]
    return world, streams


def run_slice(vocab, windows, n_agents, device, placerec=True):
    """Fresh manager + sessions; ingest every window, then flush (which
    drains the deferred place recognition).  Returns a dict with the
    manager, the sessions, the queued retrieval data and the ingest and
    flush wall times (device synchronised at both ends of each)."""
    import torch

    from covins_tpu_torch.models.map_manager import MapManager
    from covins_tpu_torch.models.session import AgentSession
    from covins_tpu_torch.utils.config import Config

    cfg = Config(placerec_defer=True) if placerec else \
        Config(placerec_active=False, placerec_defer=True)
    mgr = MapManager(vocab, cfg, device=device)
    sessions = {cid: AgentSession(cid, mgr, cfg) for cid in range(n_agents)}
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    for window in windows:
        for cid, ms in window.items():
            sessions[cid].ingest_many(ms)
    sync()
    t_ingest = time.perf_counter() - t0
    queued = [list(s._pr_queue) for s in sessions.values()]
    t0 = time.perf_counter()
    for s in sessions.values():
        s.flush()
    sync()
    return {"mgr": mgr, "sessions": sessions, "queued": queued,
            "ingest_s": t_ingest, "flush_s": time.perf_counter() - t0}


def run_cpu(vocab, windows, n_agents, placerec=True):
    """:func:`run_slice` on the CPU with CPU_THREADS torch threads."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(CPU_THREADS)
    try:
        return run_slice(vocab, windows, n_agents, "cpu", placerec)
    finally:
        torch.set_num_threads(threads)


def outcome(run):
    mgr, sessions = run["mgr"], run["sessions"]
    return {
        "loops": mgr.n_loops, "merges": mgr.n_merges, "fused": mgr.n_fused,
        "pgo_solves": mgr.n_pgo,
        "candidates": sum(s.placerec.n_dispatched for s in sessions.values()),
        "accepted": {cid: [list(map(list, p)) for p in s.accepted]
                     for cid, s in sessions.items()},
    }


def check_invariants(run, n_kf_total, tag):
    mgr, sessions = run["mgr"], run["sessions"]
    n_kf = sum(s.stats["keyframes"] for s in sessions.values())
    check(n_kf == n_kf_total, f"{tag}: {n_kf} keyframes, expected {n_kf_total}")
    with_feats = sum(int((mp.kf_n_feat[: mp.n_kf] > 0).sum())
                     for mp in mgr.maps.values())
    check(mgr.database.n == with_feats,
          f"{tag}: database holds {mgr.database.n} rows for {with_feats} KFs")
    for mp in mgr.maps.values():
        live = mp.lm_mask[: mp.n_lm]
        check(np.isfinite(mp.lm_normal[: mp.n_lm][live]).all(),
              f"{tag}: non-finite landmark normals")
        check(np.isfinite(mp.kf_pose[: mp.n_kf]).all(), f"{tag}: non-finite poses")
    return n_kf


def compare_full(gpu, cpu):
    """The card's and the CPU's runs of the full path: the same loops,
    merges, accepted pairs and maps, and every keyframe pose and landmark
    position within POSE_TOL."""
    go, co = outcome(gpu), outcome(cpu)
    for k in ("loops", "merges", "fused", "pgo_solves", "candidates", "accepted"):
        check(go[k] == co[k], f"card and CPU differ in {k}: {go[k]} vs {co[k]}")
    g_mgr, c_mgr = gpu["mgr"], cpu["mgr"]
    check(sorted(g_mgr.maps) == sorted(c_mgr.maps), "map ids differ")
    worst_loop, worst = 0.0, 0.0
    for mid, gm in g_mgr.maps.items():
        cm = c_mgr.maps[mid]
        check((gm.n_kf, gm.n_lm, gm.n_obs) == (cm.n_kf, cm.n_lm, cm.n_obs),
              f"map {mid} sizes differ")
        check(np.array_equal(gm.kf_ids, cm.kf_ids) and np.array_equal(gm.lm_mask, cm.lm_mask)
              and np.array_equal(gm.kf_feat_lm, cm.kf_feat_lm),
              f"map {mid} bookkeeping differs")
        check([(lc["kf1"], lc["kf2"]) for lc in gm.loops]
              == [(lc["kf1"], lc["kf2"]) for lc in cm.loops], f"map {mid} loops differ")
        for gl, cl in zip(gm.loops, cm.loops):
            worst_loop = max(worst_loop, float(np.abs(gl["T_12"] - cl["T_12"]).max()))
        for name in ("kf_pose", "lm_pos"):
            worst = max(worst, float(np.abs(getattr(gm, name) - getattr(cm, name)).max()))
    check(worst_loop <= LOOP_TOL, f"loop transforms differ by {worst_loop}")
    check(worst <= POSE_TOL, f"poses differ by {worst}")
    return go, worst_loop, worst


def compare_ingest(gpu, cpu):
    """Every map SoA array and the database of the card's ingest-only run
    against the CPU run: integers and descriptors exactly, float64 to
    1e-9, float32 database rows and scores to rtol 1e-5."""
    g_mgr, c_mgr = gpu["mgr"], cpu["mgr"]
    check(sorted(g_mgr.maps) == sorted(c_mgr.maps), "map ids differ")
    n_arrays = 0
    for mid, gm in g_mgr.maps.items():
        cm = c_mgr.maps[mid]
        for name, a in vars(gm).items():
            if not isinstance(a, np.ndarray):
                continue
            b = getattr(cm, name)
            check(a.shape == b.shape and a.dtype == b.dtype, f"{name} shape/type")
            if a.dtype.kind == "f":
                ok = np.allclose(a, b, rtol=0, atol=1e-9)
            else:
                ok = np.array_equal(a, b)
            check(ok, f"map {mid} array {name} differs between card and CPU")
            n_arrays += 1
    gdb, cdb = g_mgr.database, c_mgr.database
    check(gdb.row_ids == cdb.row_ids and np.array_equal(gdb._mask, cdb._mask),
          "database rows differ")
    check(np.allclose(gdb.db.cpu().numpy(), cdb.db.numpy(), rtol=1e-5, atol=1e-7),
          "database matrix differs")
    n_scores = 0
    for gq, cq in zip(gpu["queued"], cpu["queued"]):
        for (gk, gp), (ck, cp) in zip(gq, cq):
            check(gk == ck, "queued keyframes differ")
            if gp is None:
                continue
            # the drain fetched the queued scores to the host
            check(np.array_equal(gp["common"], cp["common"]),
                  "common-word counts differ")
            check(np.allclose(gp["scores"], cp["scores"], rtol=1e-5, atol=1e-6),
                  "scores differ")
            n_scores += 1
    return n_arrays, n_scores


class Recorder:
    """Keeps a copy of the largest input (by work) that the path gives each
    kernel wrapper.  While active, the module-level name through which the
    port calls each wrapper points at a shim that records the arguments and
    forwards to the wrapper, which runs unchanged.  Only the CPU pass of
    the main path is recorded: it gives each kernel the inputs the card's
    pass gives it, and the timed passes run without the shims."""

    def __init__(self, targets):
        self.targets = targets  # (module, wrapper name, size of the work)
        self.largest = {}

    def _shim(self, fn, name, size):
        def recording(*args, **kwargs):
            s = size(*args)
            if s > self.largest.get(name, (0,))[0]:
                self.largest[name] = (s, [x.clone() if hasattr(x, "clone") else x
                                          for x in args])
            return fn(*args, **kwargs)
        # a wrapper counts its launches on its module-level name, which is
        # this shim while recording (the counts are reset after the pass)
        recording.launches = 0
        return recording

    def __enter__(self):
        self._saved = []
        for mod, name, size in self.targets:
            fn = getattr(mod, name)
            self._saved.append((mod, name, fn))
            setattr(mod, name, self._shim(fn, name, size))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)

    def on(self, name, dev):
        """The recorded arguments of ``name`` moved to ``dev`` (tensors and
        the tensor fields of a dataclass; other values as they are)."""
        def move(x):
            if hasattr(x, "to"):
                return x.to(dev)
            if dataclasses.is_dataclass(x):
                return dataclasses.replace(x, **{f.name: move(getattr(x, f.name))
                                                 for f in dataclasses.fields(x)})
            return x
        return [move(x) for x in self.largest[name][1]]


def _layer(filename, funcname):
    """Layer of a profiled function: a module of the port, or the library
    whose native code it is."""
    if "covins_tpu_torch" in filename:
        return filename[filename.rindex("covins_tpu_torch"):]
    for lib in ("torch", "numpy"):
        if f"/{lib}/" in filename or lib in funcname:
            return lib
    return "python"


def _device_busy_ms(prof):
    """Sum of the card's kernel and copy intervals in a torch.profiler
    trace (one stream, so they do not overlap), read from the raw events."""
    import torch

    busy, by_kernel = 0.0, {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        ms = e.duration_ns() / 1e6
        busy += ms
        name = e.name()[:60]
        by_kernel[name] = by_kernel.get(name, 0.0) + ms
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    return busy, dict(top)


def trace_slice(vocab, windows, card):
    """Traced runs of the main path, after the measured one: the device's
    busy time from ``torch.profiler`` (kernel intervals on the card) and
    the host's self time by layer from ``cProfile``, for the ingest and the
    drain apart.  One run traces its ingest and the first agent's drain
    (its flush: about half the candidates and one pose-graph solve) with
    torch.profiler and the second agent's drain with cProfile; a second
    run's ingest is traced with cProfile.  Tracing each half of the drain
    once keeps the traces inside the chip check's time limit."""
    import cProfile
    import pstats

    import torch
    from torch.profiler import ProfilerActivity, profile

    from covins_tpu_torch.models.map_manager import MapManager
    from covins_tpu_torch.models.session import AgentSession
    from covins_tpu_torch.utils.config import Config

    def fresh():
        cfg = Config(placerec_defer=True)
        mgr = MapManager(vocab, cfg, device="cuda")
        sessions = [AgentSession(cid, mgr, cfg) for cid in range(2)]

        def ingest():
            for window in windows:
                for cid, ms in window.items():
                    sessions[cid].ingest_many(ms)
        return sessions, ingest

    def profiled(part, fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        busy, top = _device_busy_ms(prof)
        return {"trace": "torch.profiler", "part": part, "wall_ms_traced": wall,
                "device_busy_ms": busy, "device_idle_share": 1.0 - busy / wall,
                "device_ms_by_kernel": top}

    def cprofiled(part, fn):
        prof = cProfile.Profile()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prof.enable()
        fn()
        torch.cuda.synchronize()
        prof.disable()
        wall = (time.perf_counter() - t0) * 1e3
        layers, funcs = {}, {}
        for (filename, _, funcname), (_, _, tt, _, _) in pstats.Stats(prof).stats.items():
            name = _layer(filename, funcname)
            layers[name] = layers.get(name, 0.0) + tt
            funcs[f"{name}:{funcname}"] = funcs.get(f"{name}:{funcname}", 0.0) + tt
        return {"trace": "cProfile", "part": part, "wall_ms_traced": wall,
                "host_self_ms_by_layer": {
                    k: v * 1e3 for k, v in sorted(layers.items(), key=lambda kv: -kv[1])[:10]},
                "host_self_ms_by_function": {
                    k: v * 1e3 for k, v in sorted(funcs.items(), key=lambda kv: -kv[1])[:12]}}

    sessions, ingest = fresh()
    rows = [profiled("ingest", ingest),
            profiled("drain, agent 0", sessions[0].flush),
            cprofiled("drain, agent 1", sessions[1].flush)]
    _, ingest = fresh()
    rows.append(cprofiled("ingest", ingest))
    for row in rows:
        print(json.dumps({"phase": 2, "card": card, **row}))


def kernel_wrappers():
    from covins_tpu_torch.ops import bow, descriptors, landmark_ops, pgo, pnp, projmatch

    return {"hamming_argmin": descriptors.hamming_argmin,
            "representative_descriptors": landmark_ops.representative_descriptors,
            "bow_insert": bow.bow_insert,
            "hamming_mutual_nn": descriptors.hamming_mutual_nn,
            "project_match": projmatch.gated_match,
            "p3p_score": pnp.p3p_score,
            "pgo_matvec": pgo.matvec}


def reference_counts():
    """Loops and merges the JAX package recorded for the same workload on
    its own chip (`BENCH_r05.json`), printed beside the port's."""
    try:
        with open("BENCH_r05.json") as fh:
            detail = json.load(fh)["parsed"]["detail"]
        return {"loops": detail["loops_closed"], "merges": detail["merges"]}
    except (OSError, KeyError, ValueError):
        return None


def phase2(dev, card):
    import torch

    from covins_tpu_torch.ops import bow, descriptors, landmark_ops, pgo, pnp, projmatch

    n_agents, n_kf = 2, 128
    t_phase = t0 = time.perf_counter()
    world, streams = build_streams(n_agents, n_kf, 2000)
    windows = make_windows(streams)
    t_streams = time.perf_counter() - t0
    gen = torch.Generator(device=dev).manual_seed(SEED)
    vocab = bow.train_vocabulary(torch.from_numpy(world.lm_descs).to(dev),
                                 k=512, iters=4, generator=gen).cpu().numpy()
    wrappers = kernel_wrappers()
    rec = Recorder([
        (descriptors, "hamming_argmin", lambda a, b, m=None: a.shape[0] * b.shape[0]),
        (landmark_ops, "representative_descriptors", lambda d, m: d.shape[0]),
        (bow, "bow_insert", lambda w, d, db: w.numel()),
        (descriptors, "hamming_mutual_nn",
         lambda a, am, b, bm, md: a.shape[0] * b.shape[0]),
        (projmatch, "gated_match", lambda *a: a[0].shape[0] * a[5].shape[0]),
        (pnp, "p3p_score", lambda T, P, *a: T.shape[0] * P.shape[0]),
        (pgo, "matvec", lambda v, f, Ji, *a: Ji.shape[0]),
    ])
    t0 = time.perf_counter()
    # warm-up: the stream's first WARM_WINDOWS windows, ingested and drained,
    # run every kernel and code path of the measured pass once
    run_slice(vocab, windows[:WARM_WINDOWS], n_agents, "cuda")
    t_warm = time.perf_counter() - t0
    for k in wrappers.values():
        k.launches = 0
    gpu = run_slice(vocab, windows, n_agents, "cuda")
    launches = {name: k.launches for name, k in wrappers.items()}
    for name, n in launches.items():
        check(n > 0, f"main path never launched {name}")
    n_total = check_invariants(gpu, n_agents * n_kf, "card")
    out = outcome(gpu)
    check(out["loops"] >= 1 and out["merges"] >= 1,
          f"the card closed {out['loops']} loops and {out['merges']} merges")
    print(json.dumps({
        "phase": 2, "card": card, "n_agents": n_agents, "n_keyframes": n_total,
        "windows": len(windows), "db_rows": gpu["mgr"].database.n,
        "ingest_wall_s": gpu["ingest_s"], "ingest_kf_per_s": n_total / gpu["ingest_s"],
        "drain_wall_s": gpu["flush_s"],
        "kf_per_s_with_drain": n_total / (gpu["ingest_s"] + gpu["flush_s"]),
        "loops": out["loops"], "merges": out["merges"], "fused": out["fused"],
        "candidates": out["candidates"], "pgo_solves": out["pgo_solves"],
        "reference_bench_r05": reference_counts(),
        "stream_build_s": t_streams, "warmup_pass_s": t_warm, "launches": launches,
        "launches_per_candidate": {k: v / max(out["candidates"], 1)
                                   for k, v in launches.items()},
    }))
    print(json.dumps({"phase": 2, "accepted": out["accepted"]}))

    print(json.dumps({"phase": 2, "elapsed_s": time.perf_counter() - t_phase}))
    trace_slice(vocab, windows, card)

    print(json.dumps({"phase": 2, "elapsed_s": time.perf_counter() - t_phase}))
    with rec:  # the CPU pass, recording the kernels' largest inputs
        cpu = run_cpu(vocab, windows, n_agents)
    check_invariants(cpu, n_agents * n_kf, "cpu")
    _, worst_loop, worst = compare_full(gpu, cpu)
    print(json.dumps({"phase": 2, "card_vs_cpu": "agree", "loop_tol": LOOP_TOL,
                      "max_loop_T_diff": worst_loop, "pose_tol": POSE_TOL,
                      "max_pose_diff": worst, "cpu_threads": CPU_THREADS,
                      "cpu_ingest_wall_s": cpu["ingest_s"],
                      "cpu_drain_wall_s": cpu["flush_s"],
                      "elapsed_s": time.perf_counter() - t_phase}))

    # each kernel on the card, on the largest input the main path gave it
    table = {}
    a, b, mask = rec.on("hamming_argmin", dev)
    table["hamming_argmin"] = {**k1_case(a, b, mask, reps=50),
                               "shape": [a.shape[0], b.shape[0], 256]}
    d, m = rec.on("representative_descriptors", dev)
    table["representative_descriptors"] = {**k2_case(d, m, reps=50),
                                           "shape": list(d.shape)}
    w, dst, db = rec.on("bow_insert", dev)
    table["bow_insert"] = {**k3_case(w, dst, db, reps=50),
                           "shape": list(w.shape) + list(db.shape)}
    a, am, b, bm, md = rec.on("hamming_mutual_nn", dev)
    table["hamming_mutual_nn"] = {**k4_case(a, am, b, bm, md, reps=50),
                                  "shape": [a.shape[0], b.shape[0]]}
    args = rec.on("gated_match", dev)
    table["project_match"] = {**k5_case(args[:10], args[10], reps=20),
                              "shape": [args[0].shape[0], args[5].shape[0]]}
    T, P, B, msk, valid, thr = rec.on("p3p_score", dev)
    table["p3p_score"] = {**k6_case(T, P, B, msk, valid, thr, reps=50),
                          "shape": [T.shape[0], P.shape[0]]}
    v, free, Ji, Jj, graph, damping = rec.on("matvec", dev)
    table["pgo_matvec"] = {**k7_case(v, free, Ji, Jj, graph, damping, reps=200),
                           "shape": [v.shape[0], Ji.shape[0]]}
    for name, row in table.items():
        row["launches"] = launches[name]
    return table


def phase3(dev, card, n_kf):
    import torch

    from covins_tpu_torch.ops import bow

    # 4000 landmarks put up to ~1300 in view; the front-end keeps 1000
    # features per keyframe (ORB-SLAM3's EuRoC ORBextractor.nFeatures), and
    # the map holds at most 1024 (Map max_features)
    n_agents, n_lm, n_feat = 5, 4000, 1000
    t0 = time.perf_counter()
    world, streams = build_streams(n_agents, n_kf, n_lm, n_feat)
    windows = make_windows(streams)
    t_streams = time.perf_counter() - t0
    gen = torch.Generator(device=dev).manual_seed(SEED)
    vocab = bow.train_vocabulary(torch.from_numpy(world.lm_descs).to(dev),
                                 k=512, iters=4, generator=gen).cpu().numpy()
    wrappers = kernel_wrappers()
    for k in wrappers.values():
        k.launches = 0
    run = run_slice(vocab, windows, n_agents, "cuda")
    launches = {name: k.launches for name, k in wrappers.items()}
    n_total = check_invariants(run, n_agents * n_kf, "five agents")
    out = outcome(run)
    print(json.dumps({
        "phase": 3, "card": card, "n_agents": n_agents, "n_keyframes": n_total,
        "n_world_landmarks": n_lm, "max_features_per_kf": n_feat,
        "windows": len(windows), "db_rows": run["mgr"].database.n,
        "landmarks": sum(mp.n_lm for mp in run["mgr"].maps.values()),
        "ingest_wall_s": run["ingest_s"], "ingest_kf_per_s": n_total / run["ingest_s"],
        "drain_wall_s": run["flush_s"],
        "loops": out["loops"], "merges": out["merges"], "fused": out["fused"],
        "candidates": out["candidates"], "pgo_solves": out["pgo_solves"],
        "maps": len(run["mgr"].maps), "stream_build_s": t_streams,
        "launches": launches,
    }))
    return out


def phase4(dev, card):
    """The ingest-only path (place recognition off), card against CPU."""
    import torch

    from covins_tpu_torch.ops import bow

    n_agents, n_kf = 2, 128
    world, streams = build_streams(n_agents, n_kf, 2000)
    windows = make_windows(streams)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    vocab = bow.train_vocabulary(torch.from_numpy(world.lm_descs).to(dev),
                                 k=512, iters=4, generator=gen).cpu().numpy()
    wrappers = kernel_wrappers()
    for k in wrappers.values():
        k.launches = 0
    gpu = run_slice(vocab, windows, n_agents, "cuda", placerec=False)
    launches = {name: k.launches for name, k in wrappers.items()}
    for name in ("hamming_argmin", "representative_descriptors", "bow_insert"):
        check(launches[name] > 0, f"ingest path never launched {name}")
    n_total = check_invariants(gpu, n_agents * n_kf, "card, ingest only")
    cpu = run_cpu(vocab, windows, n_agents, placerec=False)
    n_arrays, n_scores = compare_ingest(gpu, cpu)
    print(json.dumps({
        "phase": 4, "card": card, "placerec_active": False, "n_keyframes": n_total,
        "ingest_wall_s": gpu["ingest_s"], "ingest_kf_per_s": n_total / gpu["ingest_s"],
        "flush_wall_s": gpu["flush_s"], "launches": launches,
        "card_vs_cpu": "agree", "arrays": n_arrays, "score_rows": n_scores,
        "cpu_ingest_wall_s": cpu["ingest_s"]}))


SOURCES = {
    # the Pallas kernel hamming_pallas.py::hamming_distance_packed_T was
    # removed from the JAX package; this is its live equivalent
    "hamming_argmin": ("covins_tpu_torch/csrc/hamming_argmin.cu",
                       "covins_tpu/ops/descriptors.py:58"),
    "representative_descriptors": ("covins_tpu_torch/csrc/representative_descriptors.cu",
                                   "covins_tpu/ops/landmark_ops.py:22"),
    "bow_insert": ("covins_tpu_torch/csrc/bow_insert.cu",
                   "covins_tpu/models/kf_database.py:30"),
    "hamming_mutual_nn": ("covins_tpu_torch/csrc/hamming_mutual_nn.cu",
                          "covins_tpu/ops/descriptors.py:138"),
    "project_match": ("covins_tpu_torch/csrc/project_match.cu",
                      "covins_tpu/ops/projmatch.py:43"),
    "p3p_score": ("covins_tpu_torch/csrc/p3p_score.cu",
                  "covins_tpu/ops/pnp.py:338"),
    "pgo_matvec": ("covins_tpu_torch/csrc/pgo_matvec.cu",
                   "covins_tpu/ops/pgo.py:187"),
}


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 2
    from covins_tpu_torch import cuda_build

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    card = card_line()
    print(card)
    print(json.dumps({"phase": 0, "torch": torch.__version__,
                      "cuda": torch.version.cuda, "python": sys.version.split()[0],
                      "cpu_threads": torch.get_num_threads(), "cpus": os.cpu_count()}))
    t0 = time.perf_counter()
    logs = cuda_build.build_all()
    t_build = time.perf_counter() - t0
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[ptxas {name}] {line.strip()}")
    print(json.dumps({"phase": 0, "build_s": t_build, "kernels": sorted(logs)}))
    check(sorted(logs) == sorted(SOURCES), "a kernel source was not built")

    phase1(dev)
    print(json.dumps({"phase": 1, "elapsed_s": time.perf_counter() - t_start}))
    table = phase2(dev, card)
    print(json.dumps({"phase": 2, "elapsed_s": time.perf_counter() - t_start}))
    phase3(dev, card, n_kf=32)
    print(json.dumps({"phase": 3, "elapsed_s": time.perf_counter() - t_start}))
    phase4(dev, card)
    print(json.dumps({"phase": 4, "elapsed_s": time.perf_counter() - t_start}))

    kernels = []
    for name, row in table.items():
        src, replaces = SOURCES[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": row["launches"], "max_abs_err": row["max_abs_err"],
            "ms": row["kernel_ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"], "shape": row["shape"],
        })
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
