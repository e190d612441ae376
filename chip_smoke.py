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
   relative, K8 and K10 to 1e-13 relative, K9 to 1e-13 of the sums of
   magnitudes behind each output, the two PCG kernels (pgo_pcg, 100
   iterations, at a 256-pose graph of 1270 edges with the default edge
   weights and with all weights 100, and at ragged ones; gba_pcg, 60
   iterations) within GBA_FACTOR times their plain loop's own rounding
   spread (:func:`pcg_check`), K7-K10 and both PCG kernels bit for bit
   across two launches (K8-K10 and gba_pcg at bench.py's GBA problem and
   at ragged problems down to two keyframes); K7 and K9 beside one
   torch.mv of their matrix assembled densely;
2. the full main path at the workload of the JAX package's benchmark
   (2 agents x 128 KF over 2000 landmarks, 512-word vocabulary trained on
   the card, 1024-message windows, the default ``Config()`` with
   ``placerec_defer=True``): a warm-up on the stream's first windows, then
   the measured pass with every launch counter set to 0 just before it
   and read just after (pgo_pcg once per pose-graph Gauss-Newton step,
   the standalone K7 never), timing the ingest, the place-recognition
   drain and its pose-graph solves apart, and those solves replayed with
   the PCG kernel and with the eager loop in turns, then once more with
   every Gauss-Newton step's pgo_pcg read against its plain loop (the
   rounding readings of phase 1, recorded, not held);
   traced runs (device busy time from torch.profiler over an
   ingest and the first agent's drain of the stream's first windows, host
   self time by layer from cProfile over the second agent's drain of
   those windows and an ingest); then the same streams through the port
   on the CPU (plain versions, 4 torch threads), compared with the card's
   run on loops, merges, accepted pairs, loop transforms and every map's
   poses; then each kernel replayed on the card on the largest input the
   CPU pass gave it, against its plain version, timed beside its bound;
3. a five-agent deployment (5 x 32 KF) with place recognition on, card
   only;
4. the ingest-only path (``placerec_active=False``) on the benchmark
   workload, card against CPU, every map array and database row compared;
5. bench.py's GBA problem (256 KF, 8192 landmarks, max_obs 61440) through
   ``global_bundle_adjustment(n_gn=10, n_cg=60)`` with the counters set to
   0 just before it (the problem's build, K10, included) and read just
   after (gba_pcg once per Gauss-Newton step, K9 seven times): ms per
   Gauss-Newton step with the PCG kernel and with the eager loop in turns,
   wall time of a solve with each, a torch.profiler trace of
   one solve, costs that never increase, the ATE to the ground truth
   falling; the same problem on the CPU, held within GBA_FACTOR times the
   CPU's own one-ulp spread, with the same pruned observations;
6. ``MapManager.run_gba`` on phase 2's merged map, on the card (counters
   set to 0 just before it) and on CPU copies of the map: the same outlier
   decisions on one round-1 state exactly, round 2 from that state within
   GBA_FACTOR times the CPU's own one-ulp spread, whole runs pruning no more
   observations differently than GBA_FACTOR times what one ulp of input
   changes on the CPU, the ATE to the agents' ground truth before and
   after;
7. one JSON line per the kernel table (K1-K7 and pgo_pcg timed on phase
   2's inputs with phase 2's launches, K8-K10 and gba_pcg on bench.py's
   GBA problem with phase 6's launches), the card line, and the result line
   ``{"ok": true, "device": {...}}``.
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
# How far the card's GBA may end from the CPU's, in units of how far the
# CPU's own GBA moves when its input moves by one ulp (measured in the same
# run): the reduced camera system is ill-conditioned and its 60 PCG steps
# stop far from convergence, so rounding differences of either kind are
# amplified alike (tests/test_torch_gba.py, scripts/port_gba_sensitivity.py)
GBA_FACTOR = 10.0
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


def busy_ms(fn, reps):
    """The card's time per call of ``fn`` without the host's cadence: the
    ``reps`` calls are queued behind a spin kernel (``torch.cuda._sleep``)
    that outlasts the host's issuing of them, and timed with CUDA events
    from the spin's end to the last call's end.  None if the host could
    not get ahead of the card (``fn`` waits for the card)."""
    import torch

    fn()
    torch.cuda.synchronize()
    cycles = 1 << 24
    for _ in range(8):
        spin, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        spin.record()
        torch.cuda._sleep(cycles)
        start.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        end.synchronize()
        if spin.elapsed_time(start) > 1.5 * host_ms:
            return start.elapsed_time(end) / reps
        cycles *= 4
    return None


def profiled_ms(fn, reps):
    """torch.profiler's reading of the same: the card's kernel and copy
    intervals per call over ``reps`` calls, and how many intervals it
    recorded."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == torch.autograd.DeviceType.CUDA]
    return sum(e.duration_ns() for e in events) / 1e6 / reps, len(events)


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


def dense_normal_matrix(free, Ji, Jj, graph, damping):
    """The pose graph's damped normal matrix assembled densely (6N x 6N):
    F J^T J F + damping I with J the (6E, 6N) whitened Jacobian and F the
    free mask.  Used only as K7's library yardstick (one torch.mv); the
    port never builds it."""
    import torch

    E, N = Ji.shape[0], free.shape[0]
    dev = Ji.device
    J = torch.zeros((E * 6, N * 6), dtype=torch.float64, device=dev)
    rows = torch.arange(E * 6, device=dev).reshape(E, 6, 1).expand(E, 6, 6)
    for ends, blocks in ((graph.edge_i, Ji), (graph.edge_j, Jj)):
        cols = (ends[:, None, None] * 6 + torch.arange(6, device=dev)[None, None, :]
                ).expand(E, 6, 6)
        J.index_put_((rows, cols), blocks * free[ends][:, None, None], accumulate=True)
    return J.T @ J + damping * torch.eye(N * 6, dtype=torch.float64, device=dev)


def k7_case(v, free, Ji, Jj, graph, damping, reps, library=False):
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
    lib_ms = None
    if library:
        H = dense_normal_matrix(free, Ji, Jj, graph, damping)
        vv = v.reshape(-1)
        check(_rel(torch.mv(H, vv).reshape(N, 6), out) <= 1e-9,
              "dense normal matrix disagrees with K7")
        lib_ms = cuda_ms(lambda: torch.mv(H, vv), reps)
        lib_busy = busy_ms(lambda: torch.mv(H, vv), reps)
        del H
    return {
        "kernel_ms": cuda_ms(lambda: pgo.matvec(v, free, Ji, Jj, graph, damping), reps),
        "busy_ms": busy_ms(lambda: pgo.matvec(v, free, Ji, Jj, graph, damping), reps),
        "library_busy_ms": lib_busy if library else None,
        "plain_ms": cuda_ms(lambda: pgo.matvec_plain(v, free, Ji, Jj, graph, damping),
                            reps),
        "library_ms": lib_ms,
        "bound_ms": bnd, "bound_by": by,
        "max_abs_err": float((out - ref).abs().max().item()), "max_rel_err": rel,
    }


def _rel(a, b):
    """Largest difference relative to the largest entry of ``b``."""
    if b.numel() == 0:
        return 0.0
    return float(((a.double() - b.double()).abs().max()
                  / b.double().abs().max().clamp(min=1e-300)).item())


def gba_bytes_ops(p, graph, valid_obs):
    """(bytes, float64 operations) of one K8 linearisation: each input read
    once and each output written once; about 600 operations per valid
    observation for the residual and the Jacobians and 216 for its terms of
    the keyframe and landmark blocks."""
    n, m, o = p.poses.shape[0], p.lms.shape[0], p.obs_kf.shape[0]
    read = n * 7 * 8 + m * 3 * 8 + o * (2 * 8 + 8 + 2 * 4 + 2 * 4) + (n + m) * 8 \
        + (n + m + 2) * 4
    write = o * (2 + 12 + 6) * 8 + o + n * (6 + 36) * 8 + m * (3 + 9) * 8
    return read + write, 816.0 * valid_obs


def k8_case(p, graph, huber, reps):
    import torch

    from covins_tpu_torch.ops import gba

    out = gba.reproj_blocks(p, graph, huber, "linearize")
    again = gba.reproj_blocks(p, graph, huber, "linearize")
    ref = gba.reproj_blocks_plain(p, graph, huber, "linearize")
    torch.cuda.synchronize()
    err = 0.0
    for name, a, b, c in zip(("r", "J_pose", "J_lm", "b6", "M6", "b_lm", "Hll"),
                             out, again, ref):
        check(torch.equal(a, b), f"K8 {name} differs between two launches")
        err = max(err, _rel(a, c))
    for mode in ("cost", "outlier"):
        val, valid = gba.reproj_blocks(p, graph, huber, mode)
        rval, rvalid = gba.reproj_blocks_plain(p, graph, huber, mode)
        check(torch.equal(valid, rvalid), f"K8 {mode} validity differs")
        err = max(err, _rel(val, rval))
    val, _ = gba.reproj_blocks(p, graph, 0.0, "outlier")
    rval, _ = gba.reproj_blocks_plain(p, graph, 0.0, "outlier")
    check(torch.equal(val < 0.92, rval < 0.92), "K8 outlier decisions differ")
    check(err <= 1e-13, f"K8 relative error {err} against its plain version")
    valid_obs = int((p.obs_mask & p.lm_mask[p.obs_lm] & p.kf_mask[p.obs_kf]).sum().item())
    nbytes, ops = gba_bytes_ops(p, graph, valid_obs)
    bnd, by = bound(nbytes, (ops, FP64_OPS_S))
    return {
        "kernel_ms": cuda_ms(lambda: gba.reproj_blocks(p, graph, huber, "linearize"), reps),
        "plain_ms": cuda_ms(lambda: gba.reproj_blocks_plain(p, graph, huber, "linearize"),
                            max(1, reps // 10)),
        "cost_mode_ms": cuda_ms(lambda: gba.reproj_blocks(p, graph, huber, "cost"), reps),
        "library_ms": None, "bound_ms": bnd, "bound_by": by,
        "max_abs_err": float((out[0] - ref[0]).abs().max().item()) if out[0].numel() else 0.0,
        "max_rel_err": err, "valid_obs": valid_obs,
    }


def dense_reduced_matrix(Jp, Jl, Hinv, graph, n):
    """The observation part of the reduced camera matrix, assembled densely
    (6N x 6N): sum_o Jp^T Jp - B Hll^-1 B^T with B the (6N, 3M) Hpl.  Used
    only as K9's library yardstick (one torch.mv); the port never builds
    it."""
    import torch

    kf, lm = graph.obs_kf32.long(), graph.obs_lm32.long()
    m = Hinv.shape[0]
    A = torch.zeros((n, 6, n, 6), dtype=torch.float64, device=Jp.device)
    pp = Jp.transpose(-1, -2) @ Jp  # (O, 6, 6)
    A = A.reshape(n * 6, n * 6)
    idx = (kf[:, None, None] * 6 + torch.arange(6, device=Jp.device)[None, :, None]) * (n * 6) \
        + kf[:, None, None] * 6 + torch.arange(6, device=Jp.device)[None, None, :]
    A.view(-1).index_add_(0, idx.reshape(-1), pp.reshape(-1))
    B = torch.zeros((n * 6, m * 3), dtype=torch.float64, device=Jp.device)
    pl = Jp.transpose(-1, -2) @ Jl  # (O, 6, 3)
    idx = (kf[:, None, None] * 6 + torch.arange(6, device=Jp.device)[None, :, None]) * (m * 3) \
        + lm[:, None, None] * 3 + torch.arange(3, device=Jp.device)[None, None, :]
    B.view(-1).index_add_(0, idx.reshape(-1), pl.reshape(-1))
    BH = torch.einsum("rmi,mij->rmj", B.reshape(n * 6, m, 3), Hinv).reshape(n * 6, m * 3)
    return A - BH @ B.T


def k9_case(v6, c, Jp, Jl, Hinv, graph, n, reps, library=False):
    import torch

    from covins_tpu_torch.ops import gba

    err = 0.0
    for vv, cc, t_only in ((v6, None, False), (None, c, False), (v6, c, False),
                           (v6, None, True)):
        out = gba.reduced_matvec(vv, cc, Jp, Jl, Hinv, graph, n, t_only)
        again = gba.reduced_matvec(vv, cc, Jp, Jl, Hinv, graph, n, t_only)
        ref = gba.reduced_matvec_plain(vv, cc, Jp, Jl, Hinv, graph, n, t_only)
        scale = gba.reduced_matvec_error_scale(vv, cc, Jp, Jl, Hinv, graph, n, t_only)
        torch.cuda.synchronize()
        check(torch.equal(out, again), "K9 differs between two launches")
        if out.numel():
            err = max(err, float(((out - ref).abs() / scale.clamp(min=1e-300)).max()))
    check(err <= 1e-13, f"K9 error {err} of its sums of magnitudes against its plain version")
    out = gba.reduced_matvec(v6, None, Jp, Jl, Hinv, graph, n)
    ref = gba.reduced_matvec_plain(v6, None, Jp, Jl, Hinv, graph, n)
    o, m = Jp.shape[0], Hinv.shape[0]
    nbytes = o * (18 * 8 + 2 * 4 + 2 * 4) + m * 9 * 8 + (n + m + 2) * 4 + n * 6 * 8 * 2
    bnd, by = bound(nbytes, (100.0 * o, FP64_OPS_S))
    lib_ms = None
    if library:
        S = dense_reduced_matrix(Jp, Jl, Hinv, graph, n)
        v = v6.reshape(-1)
        dense = torch.mv(S, v).reshape(n, 6)
        check(_rel(dense, out) <= 1e-9, "dense reduced matrix disagrees with K9")
        lib_ms = cuda_ms(lambda: torch.mv(S, v), reps)
        lib_busy = busy_ms(lambda: torch.mv(S, v), reps)
        del S
    return {
        "kernel_ms": cuda_ms(lambda: gba.reduced_matvec(v6, None, Jp, Jl, Hinv, graph, n),
                             reps),
        "busy_ms": busy_ms(lambda: gba.reduced_matvec(v6, None, Jp, Jl, Hinv, graph, n),
                           reps),
        "library_busy_ms": lib_busy if library else None,
        "plain_ms": cuda_ms(lambda: gba.reduced_matvec_plain(v6, None, Jp, Jl, Hinv, graph,
                                                             n), max(1, reps // 10)),
        "library_ms": lib_ms, "bound_ms": bnd, "bound_by": by,
        "max_abs_err": float((out - ref).abs().max().item()) if out.numel() else 0.0,
        "max_rel_err": err,
    }


def reversed_total(x):
    """One running float64 sum over the elements in reverse order: another
    summation order than torch.sum's."""
    import torch

    return torch.cumsum(x.reshape(-1).flip(0), 0)[-1]


def rounding_readings(plain, b):
    """The plain PCG loop ``plain(b, total)`` at b, and how far its result
    moves under three rounding differences of its own: one ulp added to
    every entry of b, one ulp taken off, and its two dot products per
    iteration summed by :func:`reversed_total` instead of torch.sum (the
    kind of difference a kernel with its own reduction order brings)."""
    import torch

    x0 = plain(b, torch.sum)
    moved = {"one_ulp_up": plain(torch.nextafter(b, torch.full_like(b, float("inf"))),
                                 torch.sum),
             "one_ulp_down": plain(torch.nextafter(b, torch.full_like(b, -float("inf"))),
                                   torch.sum),
             "reordered_sums": plain(b, reversed_total)}
    return x0, {k: float((x - x0).abs().max()) if x.numel() else 0.0
                for k, x in moved.items()}


def pcg_readings(name, kernel, plain, b):
    """Launch ``kernel(b)`` twice (equal bits, checked) and read how far it
    ends from the plain loop and the loop's rounding readings
    (:func:`rounding_readings`).  Returns (kernel result, {max_abs_err,
    rounding_spread (the largest reading), the readings})."""
    import torch

    x, again = kernel(b), kernel(b)
    x0, readings = rounding_readings(plain, b)
    torch.cuda.synchronize()
    check(torch.equal(x, again), f"{name} differs between two launches")
    diff = float((x - x0).abs().max()) if x.numel() else 0.0
    return x, {"max_abs_err": diff, "rounding_spread": max(readings.values()), **readings}


def pcg_check(name, kernel, plain, b):
    """:func:`pcg_readings`, the kernel held to the plain loop within
    GBA_FACTOR times the largest reading (one reading alone swings up to
    200-fold between +1 and -1 ulp of the same b)."""
    x, res = pcg_readings(name, kernel, plain, b)
    check(res["max_abs_err"] <= GBA_FACTOR * res["rounding_spread"],
          f"{name} differs from its plain loop by {res['max_abs_err']}; the loop's own "
          f"rounding readings are {res}")
    return x, res


def pgo_eager_pcg(b, Minv, free, Ji, Jj, graph, damping, n_iters):
    """The pose-graph PCG as the eager loop `_pcg` around K7, as a Gauss-
    Newton step ran it before the persistent kernel (timed only)."""
    from covins_tpu_torch.ops import pgo

    return pgo._pcg(lambda v: pgo.matvec(v, free, Ji, Jj, graph, damping), b, Minv, free,
                    n_iters)


def pgo_pcg_check(b, Minv, free, Ji, Jj, graph, damping, n_iters, wrapper=None,
                  hold=pcg_check):
    """``hold`` (:func:`pcg_check`, or :func:`pcg_readings` to read only)
    of pgo_pcg (``wrapper``, by default `pgo.pcg`) against `_pcg` around
    the plain matvec."""
    from covins_tpu_torch.ops import pgo

    def kernel(bb):
        return (wrapper or pgo.pcg)(bb, Minv, free, Ji, Jj, graph, damping, n_iters)

    def plain(bb, total):
        return pgo._pcg(lambda v: pgo.matvec_plain(v, free, Ji, Jj, graph, damping), bb,
                        Minv, free, n_iters, total)
    return hold("pgo_pcg", kernel, plain, b)


def pgo_pcg_case(b, Minv, free, Ji, Jj, graph, damping, n_iters, reps):
    import torch

    from covins_tpu_torch.ops import pgo

    def kernel():
        return pgo.pcg(b, Minv, free, Ji, Jj, graph, damping, n_iters)

    _, res = pgo_pcg_check(b, Minv, free, Ji, Jj, graph, damping, n_iters)
    N, E = b.shape[0], Ji.shape[0]
    # inputs read once, x written once; per iteration (and once more for the
    # initial product) about 300 float64 operations per edge (y_e and both
    # ends' J^T y_e, the node sums) and 150 per pose (M^-1 r, the vector
    # updates and dots), as the source's header counts
    nbytes = 2 * E * 36 * 8 + N * (6 + 36 + 1 + 6) * 8 + E * 8 + (N + 1 + 2 * E) * 4
    bnd, by = bound(nbytes, ((n_iters + 1) * (300.0 * E + 150.0 * N), FP64_OPS_S))
    prof_ms, prof_events = profiled_ms(kernel, reps)
    return {
        "kernel_ms": cuda_ms(kernel, reps), "busy_ms": busy_ms(kernel, reps),
        "profiler_ms": prof_ms, "profiler_intervals": prof_events,
        "plain_ms": cuda_ms(lambda: pgo._pcg(
            lambda v: pgo.matvec_plain(v, free, Ji, Jj, graph, damping), b, Minv, free,
            n_iters, torch.sum), max(1, reps // 5)),
        "eager_kernel_ms": cuda_ms(lambda: pgo_eager_pcg(b, Minv, free, Ji, Jj, graph,
                                                         damping, n_iters),
                                   max(1, reps // 5)),
        "library_ms": None, "bound_ms": bnd, "bound_by": by, "n_iters": n_iters, **res,
    }


def gba_pcg_case(s, graph, n_cg, reps):
    import dataclasses as dc

    import torch

    from covins_tpu_torch.ops import gba

    def kernel(b):
        return gba.pcg(dc.replace(s, b_red=b), graph, n_cg)

    def plain(b, total):
        return gba.pcg_plain(dc.replace(s, b_red=b), graph, n_cg, gba.reduced_matvec_plain,
                             total)

    _, res = pcg_check("gba_pcg", kernel, plain, s.b_red)
    n, o, m = s.b_red.shape[0], s.Jp.shape[0], s.Hll_inv.shape[0]
    L = s.fac.loop_i.shape[0]
    F = 0 if s.fac.Ji_f is None else s.fac.imu_i.shape[0]
    C = graph.n_chunks
    # inputs read once (observations' Jacobians and four indices, the chunk
    # layout, landmark and keyframe blocks and vectors, the loop and IMU
    # factors and their CSRs), x written once; per iteration (and once more
    # for the initial product) about 96 float64 operations per observation,
    # 18 per landmark, 288 per loop edge, 1800 per IMU factor, 700 per
    # keyframe
    nbytes = o * (144 + 16) + (2 * C + 1 + n + 1) * 4 + m * (72 + 4) + n * (15 * 4 + 225) * 8 \
        + L * (2 * 288 + 16) + F * (2 * 1800 + 16) + 2 * (n + 1) * 4 + 4 * (L + F) * 4 \
        + n * 15 * 8
    ops = (n_cg + 1) * (96.0 * o + 18.0 * m + 288.0 * L + 1800.0 * F + 700.0 * n)
    bnd, by = bound(nbytes, (ops, FP64_OPS_S))
    return {
        "kernel_ms": cuda_ms(lambda: kernel(s.b_red), reps),
        "busy_ms": busy_ms(lambda: kernel(s.b_red), reps),
        "plain_ms": cuda_ms(lambda: plain(s.b_red, torch.sum), max(1, reps // 5)),
        "eager_kernel_ms": cuda_ms(lambda: gba.pcg_plain(s, graph, n_cg), max(1, reps // 5)),
        "library_ms": None, "bound_ms": bnd, "bound_by": by, "n_cg": n_cg, **res,
    }


def k10_case(args, reps, time_plain=True):
    import torch

    from covins_tpu_torch.ops import imu

    noise = imu.default_noise()
    out = imu.preintegrate(*args, noise)
    again = imu.preintegrate(*args, noise)
    ref = imu.preintegrate_plain(*args, noise)
    torch.cuda.synchronize()
    err = 0.0
    for name in ("dq", "dv", "dp", "J_q_bg", "J_v_bg", "J_v_ba", "J_p_bg", "J_p_ba", "cov",
                 "dt"):
        a, b = getattr(out, name), getattr(again, name)
        check(torch.equal(a, b), f"K10 {name} differs between two launches")
        err = max(err, _rel(a, getattr(ref, name)))
    check(err <= 1e-13, f"K10 relative error {err} against its plain version")
    F, S = args[3].shape
    samples = float(args[3].sum().item())
    nbytes = F * S * 8 * 8 + F * 6 * 8 + F * (4 + 3 + 3 + 54 + 81 + 1) * 8
    # about 4300 float64 operations per valid sample: the covariance's two
    # 9x9 products and the deltas with six tangents
    bnd, by = bound(nbytes, (4300.0 * samples, FP64_OPS_S))
    return {
        "kernel_ms": cuda_ms(lambda: imu.preintegrate(*args, noise), reps),
        "plain_ms": (cuda_ms(lambda: imu.preintegrate_plain(*args, noise), 1)
                     if time_plain else None),
        "library_ms": None, "bound_ms": bnd, "bound_by": by,
        "max_abs_err": float((out.J_p_ba - ref.J_p_ba).abs().max().item()),
        "max_rel_err": err, "valid_samples": samples,
    }


def gba_kernel_inputs(n_kf, n_lm, max_obs, dev, seed=SEED):
    """A synthetic GBA problem on the card (bench.py's at 256 / 8192 /
    61440) with the ragged cases of a real map added: a dead keyframe, dead
    landmarks, masked, invalid and gross-outlier observations, octave
    weights.  Returns (problem, graph, K9's inputs, K10's inputs)."""
    import dataclasses as dc

    import torch

    from covins_tpu_torch.ops import gba, linalg
    from covins_tpu_torch.utils import synthetic

    p, _, _ = synthetic.build_gba_problem(n_kf=n_kf, n_lm=n_lm, seed=seed,
                                          max_obs=max_obs, device=dev)
    rng = np.random.default_rng(seed + n_kf)
    o = p.obs_kf.shape[0]
    t = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
    uv = p.obs_uv.clone()
    uv[: o // 20] += t(20.0 * rng.normal(size=(o // 20, 2)))
    lms = p.lms.clone()
    if o:
        lms[int(p.obs_lm[0])] = p.poses[int(p.obs_kf[0]), 4:7]  # invalid
    kf_mask = p.kf_mask.clone()
    if n_kf > 2:
        kf_mask[n_kf // 2] = False
    p = dc.replace(p, obs_uv=uv, lms=lms, kf_mask=kf_mask,
                   lm_mask=p.lm_mask & t(rng.random(p.lms.shape[0]) > 0.02),
                   obs_mask=p.obs_mask & t(rng.random(o) > 0.02),
                   obs_w=p.obs_w * t(1.0 / (1.0 + rng.integers(0, 4, o))))
    graph = gba.obs_graph(p)
    _, Jp, Jl, _, _, _, Hll = gba.reproj_blocks_plain(p, graph, 0.0, "linearize")
    eye = torch.eye(3, dtype=torch.float64, device=dev)
    Hinv = (linalg.inv33(Hll + 1e-4 * eye) * p.lm_mask[:, None, None]).contiguous()
    v6 = t(rng.normal(size=(n_kf, 6)))
    c = t(rng.normal(size=(p.lms.shape[0], 3)))
    F, S = n_kf - 1, 50
    acc = rng.normal(scale=0.5, size=(F, S, 3)) + [0.0, 0.0, 9.81]
    mask = (np.arange(S)[None, :] < rng.integers(1, S + 1, F)[:, None]).astype(np.float64)
    k10 = [t(x) for x in (acc, 0.3 * rng.normal(size=(F, S, 3)), np.full((F, S), 0.005),
                          mask, 0.01 * rng.normal(size=(F, 3)), 0.05 * rng.normal(size=(F, 3)))]
    return p, graph, (v6, c, Jp, Jl, Hinv), k10


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

    from covins_tpu_torch.ops import bow, descriptors, gba, landmark_ops, pgo
    from covins_tpu_torch.utils import synthetic

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
        r = k7_case(*_k7_inputs(rng, N, E, dev), 1e-6, reps=50, library=N == 256)
        print(json.dumps({"phase": 1, "kernel": "pgo_matvec", "shape": [N, E], **r}))
    # the pose-graph PCG kernel at the merged bench map's graph size (256
    # poses, 1270 edges, 100 iterations), with the default edge weights and
    # with all weights 100 (where the CG stagnates and one ulp of b moves
    # the loop least predictably), and ragged
    for n_kf, n_iters, weights in ((256, 100, "config"), (256, 100, "100"),
                                   (37, 100, "config"), (37, 1, "config"),
                                   (2, 1, "config")):
        g, _ = synthetic.build_pose_graph(n_kf=n_kf, seed=SEED, device=dev)
        if weights == "100":
            g = dataclasses.replace(g, edge_sqrt_info=pgo.make_sqrt_info(
                100.0, 100.0, g.edge_i.shape[0], device=dev).contiguous())
        free = (~g.fixed & g.pose_mask).to(torch.float64)
        graph = pgo.matvec_graph(g.edge_i, g.edge_j, n_kf)
        _, _, Ji, Jj, b, Minv = pgo.normal_equations(g.poses, g, free, 1e-6, 0.0)
        r = pgo_pcg_case(b, Minv, free, Ji, Jj, graph, 1e-6, n_iters,
                         reps=10 if n_kf == 256 else 2)
        print(json.dumps({"phase": 1, "kernel": "pgo_pcg", "shape": [n_kf, Ji.shape[0]],
                          "edge_weights": weights, **r}))
    # K8-K10 at bench.py's GBA problem and at ragged sizes (down to two
    # keyframes with no observation in common); the bench shape's rows go
    # into the kernel table
    table = {}
    for n_kf, n_lm, max_obs in ((256, 8192, 61440), (7, 60, None), (2, 8, 3)):
        p, graph, (v6, c, Jp, Jl, Hinv), k10 = gba_kernel_inputs(n_kf, n_lm, max_obs, dev)
        shape = [n_kf, p.lms.shape[0], p.obs_kf.shape[0]]
        bench = n_kf == 256
        for huber in (0.0, 2.447):
            r = k8_case(p, graph, huber, reps=20 if bench else 3)
            print(json.dumps({"phase": 1, "kernel": "gba_reproj_blocks", "huber": huber,
                              "shape": shape, **r}))
        table.setdefault("gba_reproj_blocks", {**r, "shape": shape})
        r = k9_case(v6, c, Jp, Jl, Hinv, graph, n_kf, reps=50 if bench else 3,
                    library=bench)
        print(json.dumps({"phase": 1, "kernel": "gba_reduced_matvec", "shape": shape, **r}))
        table.setdefault("gba_reduced_matvec", {**r, "shape": shape})
        s = gba.reduced_system(p, graph, (p.poses, p.vels, p.biases, p.lms),
                               torch.tensor(1e-4, dtype=torch.float64, device=dev), False)
        r = gba_pcg_case(s, graph, 60, reps=10 if bench else 2)
        print(json.dumps({"phase": 1, "kernel": "gba_pcg", "shape": shape, **r}))
        table.setdefault("gba_pcg", {**r, "shape": shape})
        r = k10_case(k10, reps=5 if bench else 2, time_plain=bench)
        print(json.dumps({"phase": 1, "kernel": "imu_preintegrate",
                          "shape": list(k10[0].shape[:2]), **r}))
        table.setdefault("imu_preintegrate", {**r, "shape": list(k10[0].shape[:2])})
    return table


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


class PgoTimer:
    """While active, times every pose-graph solve of the path (host clock,
    card synchronised before and after) and keeps its graph and options, so
    that the solves can be replayed with the PCG kernel and with the eager
    loop (:meth:`replay`)."""

    def __enter__(self):
        from covins_tpu_torch.ops import pgo

        self._fn = fn = pgo.optimize_pose_graph
        self.calls, self.seconds = [], 0.0

        def timed(g, **kw):
            import torch

            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(g, **kw)
            torch.cuda.synchronize()
            self.seconds += time.perf_counter() - t0
            self.calls.append((g, kw))
            return out
        pgo.optimize_pose_graph = timed
        return self

    def __exit__(self, *exc):
        from covins_tpu_torch.ops import pgo

        pgo.optimize_pose_graph = self._fn

    def step_readings(self):
        """The recorded solves once more, with each Gauss-Newton step's
        pgo_pcg read against its plain loop (:func:`pcg_readings`: equal
        bits on relaunch checked, the distance to the loop and the loop's
        rounding readings recorded); returns each step's readings."""
        from covins_tpu_torch.ops import pgo

        kernel, steps = pgo.pcg, []

        def read(b, Minv, free, Ji, Jj, graph, damping, n_iters):
            x, res = pgo_pcg_check(b, Minv, free, Ji, Jj, graph, damping, n_iters, kernel,
                                   pcg_readings)
            steps.append({"shape": [b.shape[0], Ji.shape[0]], **res})
            return x
        read.launches = 0  # the wrapper counts on its module-level name
        pgo.pcg = read
        try:
            for g, kw in self.calls:
                self._fn(g, **kw)
        finally:
            pgo.pcg = kernel
        return steps

    def replay(self):
        """Seconds of the recorded solves with the kernel and with the eager
        loop `_pcg` around K7, in turns (kernel, eager, eager, kernel), and
        the largest difference of the two routes' poses."""
        import torch

        from covins_tpu_torch.ops import pgo

        def run(eager):
            pgo.pcg = pgo_eager_pcg if eager else kernel
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                poses = [self._fn(g, **kw)[0] for g, kw in self.calls]
                torch.cuda.synchronize()
                return time.perf_counter() - t0, poses
            finally:
                pgo.pcg = kernel

        kernel = pgo.pcg
        times = {"kernel": [], "eager": []}
        for eager in (False, True, True, False):
            t, poses = run(eager)
            times["eager" if eager else "kernel"].append(t)
            if eager:
                eager_poses = poses
            else:
                kernel_poses = poses
        diff = max((float((a - b).abs().max()) for a, b in zip(kernel_poses, eager_poses)),
                   default=0.0)
        return times, diff


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
    drain apart.  The ingest of the whole stream is traced once with each
    tool; the drain is traced on a run of the stream's first WARM_WINDOWS
    windows (the warm-up's: its drain closes loops, merges the maps and
    solves pose graphs), the first agent's with torch.profiler and the
    second's with cProfile.  Tracing that short drain rather than the
    whole one keeps the traces inside the chip check's time limit."""
    import cProfile
    import pstats

    import torch
    from torch.profiler import ProfilerActivity, profile

    from covins_tpu_torch.models.map_manager import MapManager
    from covins_tpu_torch.models.session import AgentSession
    from covins_tpu_torch.utils.config import Config

    def fresh(windows):
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

    _, ingest = fresh(windows)
    rows = [profiled("ingest", ingest)]
    sessions, ingest = fresh(windows[:WARM_WINDOWS])
    ingest()
    rows += [profiled(f"drain of the first {WARM_WINDOWS} windows, agent 0",
                      sessions[0].flush),
             cprofiled(f"drain of the first {WARM_WINDOWS} windows, agent 1",
                       sessions[1].flush)]
    _, ingest = fresh(windows)
    rows.append(cprofiled("ingest", ingest))
    for row in rows:
        print(json.dumps({"phase": 2, "card": card, **row}))


def kernel_wrappers():
    from covins_tpu_torch.ops import (bow, descriptors, gba, imu, landmark_ops, pgo, pnp,
                                      projmatch)

    return {"hamming_argmin": descriptors.hamming_argmin,
            "representative_descriptors": landmark_ops.representative_descriptors,
            "bow_insert": bow.bow_insert,
            "hamming_mutual_nn": descriptors.hamming_mutual_nn,
            "project_match": projmatch.gated_match,
            "p3p_score": pnp.p3p_score,
            "pgo_matvec": pgo.matvec,
            "pgo_pcg": pgo.pcg,
            "gba_reproj_blocks": gba.reproj_blocks,
            "gba_reduced_matvec": gba.reduced_matvec,
            "gba_pcg": gba.pcg,
            "imu_preintegrate": imu.preintegrate}


# the kernels of the ingest and place-recognition drain (phase 2) and of GBA;
# the pose-graph solves launch pgo_pcg once per Gauss-Newton step and the
# standalone K7 matvec never, a GBA step gba_pcg once and K9 seven times
DRAIN_KERNELS = ("hamming_argmin", "representative_descriptors", "bow_insert",
                 "hamming_mutual_nn", "project_match", "p3p_score", "pgo_pcg")
GBA_KERNELS = ("gba_reproj_blocks", "gba_reduced_matvec", "gba_pcg", "imu_preintegrate")
K9_PER_STEP = 7  # b_red and the six ladder scales


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
        (pgo, "pcg", lambda b, M, f, Ji, *a: Ji.shape[0]),
    ])
    t0 = time.perf_counter()
    # warm-up: the stream's first WARM_WINDOWS windows, ingested and drained,
    # run every kernel and code path of the measured pass once
    run_slice(vocab, windows[:WARM_WINDOWS], n_agents, "cuda")
    t_warm = time.perf_counter() - t0
    for k in wrappers.values():
        k.launches = 0
    with PgoTimer() as pgo_timer:
        gpu = run_slice(vocab, windows, n_agents, "cuda")
    launches = {name: k.launches for name, k in wrappers.items()}
    for name in DRAIN_KERNELS:
        check(launches[name] > 0, f"main path never launched {name}")
    n_total = check_invariants(gpu, n_agents * n_kf, "card")
    out = outcome(gpu)
    check(out["loops"] >= 1 and out["merges"] >= 1,
          f"the card closed {out['loops']} loops and {out['merges']} merges")
    n_gn = gpu["mgr"].cfg.pgo_iteration_limit
    check(launches["pgo_matvec"] == 0
          and launches["pgo_pcg"] == n_gn * out["pgo_solves"] == n_gn * len(pgo_timer.calls),
          f"{out['pgo_solves']} pose-graph solves launched pgo_pcg {launches['pgo_pcg']} "
          f"times and pgo_matvec {launches['pgo_matvec']} times, expected {n_gn} per "
          f"solve and none")
    pgo_times, pgo_diff = pgo_timer.replay()
    check(pgo_diff <= POSE_TOL, f"the kernel's and the eager loop's PGO poses differ by "
                                f"{pgo_diff}")
    for step in pgo_timer.step_readings():
        print(json.dumps({"phase": 2, "drain_pgo_pcg_step": step}))
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
        "pgo_launches_per_solve": launches["pgo_pcg"] / max(out["pgo_solves"], 1),
        "drain_pgo_s": pgo_timer.seconds,
        "pgo_replay_s": pgo_times, "pgo_kernel_vs_eager_pose_diff": pgo_diff,
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
    table["pgo_matvec"] = {**k7_case(v, free, Ji, Jj, graph, damping, reps=200,
                                     library=True),
                           "shape": [v.shape[0], Ji.shape[0]]}
    args = rec.on("pcg", dev)
    table["pgo_pcg"] = {**pgo_pcg_case(*args, reps=10), "shape": [args[0].shape[0],
                                                                   args[3].shape[0]]}
    for name, row in table.items():
        row["launches"] = launches[name]
    return table, gpu, vocab, world


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


def ate(est, gt):
    """RMSE of positions after the rigid alignment (Umeyama without scale)
    of ``est`` (K, 3) onto ``gt`` (K, 3)."""
    mu_e, mu_g = est.mean(0), gt.mean(0)
    U, _, Vt = np.linalg.svd((gt - mu_g).T @ (est - mu_e))
    d = np.sign(np.linalg.det(U @ Vt))
    R = U @ np.diag([1.0, 1.0, d]) @ Vt
    aligned = (est - mu_e) @ R.T + mu_g
    return float(np.sqrt(np.mean(np.sum((aligned - gt) ** 2, axis=1))))


def _states(p):
    return [x.cpu().numpy() for x in (p.poses, p.vels, p.biases, p.lms)]


def _max_diff(a, b):
    return max(float(np.abs(x - y).max()) for x, y in zip(a, b))


def phase5(dev, card):
    """bench.py's GBA problem (256 KF, 8192 landmarks, max_obs 61440)
    through `global_bundle_adjustment(n_gn=10, n_cg=60)` on the card
    (round 1 of 5 Huber steps, pruning, round 2 of 10), then the same
    problem on the CPU (plain versions), and the CPU again with the
    landmarks and with the poses moved by one ulp: the card must end within
    GBA_FACTOR times that spread of the CPU's result."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from covins_tpu_torch.ops import gba
    from covins_tpu_torch.utils import synthetic

    t_phase = time.perf_counter()
    build = dict(n_kf=256, n_lm=8192, seed=SEED, max_obs=61440, device=dev)
    p, _, _ = synthetic.build_gba_problem(**build)
    gba.global_bundle_adjustment(p, n_gn=1, n_cg=2, outlier_removal=False)  # warm-up
    wrappers = kernel_wrappers()
    for k in wrappers.values():
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p, poses_gt, lms_gt = synthetic.build_gba_problem(**build)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    p_card, info = gba.global_bundle_adjustment(p, n_gn=10, n_cg=60)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: wrappers[name].launches for name in GBA_KERNELS}
    for name, n in launches.items():
        check(n > 0, f"GBA never launched {name}")
    costs1 = info["round1_costs"].cpu().numpy()
    costs = info["costs"].cpu().numpy()
    n_steps = len(costs1) + len(costs)
    check(launches["gba_pcg"] == n_steps
          and launches["gba_reduced_matvec"] == K9_PER_STEP * n_steps,
          f"{n_steps} GBA steps launched gba_pcg {launches['gba_pcg']} times and K9 "
          f"{launches['gba_reduced_matvec']} times")
    check(np.isfinite(costs1).all() and np.isfinite(costs).all(), "GBA costs not finite")
    check((np.diff(costs1) <= 0).all() and (np.diff(costs) <= 0).all(),
          f"GBA costs increase: {costs1} {costs}")
    n_valid = int(p.obs_mask.sum().item())
    ate0 = ate(p.poses[:, 4:7].cpu().numpy(), poses_gt[:, 4:7])
    ate1 = ate(p_card.poses[:, 4:7].cpu().numpy(), poses_gt[:, 4:7])
    check(ate1 < ate0, f"GBA did not lower the ATE: {ate0} -> {ate1}")

    # one GN step at a time (CUDA events), with the PCG kernel and with the
    # eager loop pcg_plain around K9, in turns; a whole solve with the eager
    # loop; and one traced solve
    graph = gba.obs_graph(p)
    state = (p.poses, p.vels, p.biases, p.lms)
    lam = torch.tensor(1e-4, dtype=torch.float64, device=dev)
    kernel_pcg = gba.pcg
    step_ms = {"kernel": [], "eager": []}
    try:
        for eager in (False, True, True, False):
            gba.pcg = gba.pcg_plain if eager else kernel_pcg
            step_ms["eager" if eager else "kernel"].append(
                cuda_ms(lambda: gba._gn_schur_step(p, graph, state, lam, 60, False), 3))
        gba.pcg = gba.pcg_plain
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p_eager, _ = gba.global_bundle_adjustment(p, n_gn=10, n_cg=60)
        torch.cuda.synchronize()
        wall_eager = time.perf_counter() - t0
    finally:
        gba.pcg = kernel_pcg
    eager_diff = _max_diff(_states(p_card), _states(p_eager))

    # a cost evaluation (eight per step: the ladder's seven and the old
    # state) with the residual-only IMU and loop factors, against one that
    # takes their residuals from the linearising functions
    def cost_from_r_J():
        val, _ = gba.reproj_blocks(p, graph, 0.0, "cost")
        r_l, r_f = gba._loop_r_J(p)[0], gba._imu_r_J(p)[0]
        return torch.sum(val) + torch.sum(r_l * r_l) + torch.sum(r_f * r_f)

    cost = gba.total_cost(p, graph, state, False)
    check(_rel(cost_from_r_J(), cost) <= 1e-12, "the two cost evaluations disagree")
    cost_ms = cuda_ms(lambda: gba.total_cost(p, graph, state, False), 5)
    cost_r_J_ms = cuda_ms(cost_from_r_J, 5)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        gba.global_bundle_adjustment(p, n_gn=10, n_cg=60)
        torch.cuda.synchronize()
        wall_traced = (time.perf_counter() - t0) * 1e3
    busy, top = _device_busy_ms(prof)

    # the CPU: the same problem, then moved by one ulp
    threads = torch.get_num_threads()
    torch.set_num_threads(CPU_THREADS)
    try:
        pc = gba.problem_to(p, "cpu")
        t0 = time.perf_counter()
        p_cpu, info_cpu = gba.global_bundle_adjustment(pc, n_gn=10, n_cg=60)
        cpu_wall = time.perf_counter() - t0
        spread = 0.0
        for name in ("lms", "poses"):
            x = getattr(pc, name)
            moved = dataclasses.replace(pc, **{name: torch.nextafter(
                x, torch.full_like(x, float("inf")))})
            p_ulp, _ = gba.global_bundle_adjustment(moved, n_gn=10, n_cg=60)
            spread = max(spread, _max_diff(_states(p_ulp), _states(p_cpu)))
    finally:
        torch.set_num_threads(threads)
    diff = _max_diff(_states(p_card), _states(p_cpu))
    cost_diff = float(np.abs(costs - info_cpu["costs"].numpy()).max() / np.abs(costs).max())
    check(info["n_pruned"] == info_cpu["n_pruned"],
          f"card pruned {info['n_pruned']}, CPU {info_cpu['n_pruned']}")
    check(torch.equal(p_card.obs_mask.cpu(), p_cpu.obs_mask), "pruned observations differ")
    check(diff <= GBA_FACTOR * spread,
          f"card and CPU GBA differ by {diff}, the CPU's one-ulp spread is {spread}")
    check(eager_diff <= GBA_FACTOR * spread,
          f"the PCG kernel's and the eager loop's solves differ by {eager_diff}, the "
          f"CPU's one-ulp spread is {spread}")
    print(json.dumps({
        "phase": 5, "card": card, "n_kf": p.poses.shape[0], "n_lm": p.lms.shape[0],
        "n_obs": n_valid, "reference_n_obs_bench_r05": 52647,
        "imu_factors": p.imu_i.shape[0], "n_gn": 10, "n_gn_round1": 5, "n_cg": 60,
        "build_s": t_build, "wall_s": wall, "wall_eager_pcg_s": wall_eager,
        "gn_step_ms": step_ms["kernel"], "gn_step_eager_pcg_ms": step_ms["eager"],
        "kernel_vs_eager_pcg_state_diff": eager_diff,
        "cost_eval_ms": cost_ms, "cost_eval_via_r_J_ms": cost_r_J_ms,
        "round1_costs": costs1.tolist(), "costs": costs.tolist(),
        "n_pruned": info["n_pruned"], "ate_before_m": ate0, "ate_after_m": ate1,
        "launches": launches, "wall_ms_traced": wall_traced, "device_busy_ms": busy,
        "device_idle_share": 1.0 - busy / wall_traced, "device_ms_by_kernel": top,
        "cpu_threads": CPU_THREADS, "cpu_wall_s": cpu_wall, "card_vs_cpu_state_diff": diff,
        "card_vs_cpu_cost_rel_diff": cost_diff, "cpu_one_ulp_spread": spread,
        "factor": GBA_FACTOR, "elapsed_s": time.perf_counter() - t_phase}))


def phase6(dev, card, gpu_run, vocab, world):
    """`MapManager.run_gba` on phase 2's merged bench map (2 agents x 128
    KF), on the card, and the CPU plain version on copies of the card run's
    map taken just before, so that the comparison isolates GBA from the
    pose-graph solves before it.

    The pruning between the rounds is checked two ways.  On one and the
    same round-1 state (solved on the card), the card's outlier decisions
    (K8) must equal the CPU plain version's exactly; round 2 from that
    state and mask, on the card and on the CPU, must end within GBA_FACTOR
    times the CPU's own spread of that round under a one-ulp change of its
    landmarks or poses (two more CPU runs).  Across whole runs,
    the decisions follow the round-1 state, which the Huber round's 5 x 60
    PCG steps leave far from converged: on this map one ulp of input moves
    the CPU's own round-1 state by about 3e-3 and flips 10-20 of its
    pruning decisions.  So the card's run may prune a few observations
    other than the CPU's, and is held to GBA_FACTOR times the number the
    CPU flips when its own landmarks or poses move by one ulp (two more CPU
    runs).  Whole runs that prune differently end in different problems, so
    their state differences are printed, not held.  Printed also: each
    run's pruned count, the ATE to the agents' ground truth before and
    after."""
    import copy

    import torch

    from covins_tpu_torch.agents.synthetic_agent import SyntheticAgent
    from covins_tpu_torch.models.map_manager import MapManager
    from covins_tpu_torch.ops import gba

    t_phase = time.perf_counter()
    mgr = gpu_run["mgr"]
    cfg = mgr.cfg
    mid = mgr.map_of_client[0]
    check(mgr.map_of_client[1] == mid, "the bench agents' maps were not merged")
    mp = mgr.maps[mid]
    mp.commit_landmark_attributes()
    cpu_maps = [copy.deepcopy(mp) for _ in range(3)]
    for m in cpu_maps:
        m.device = torch.device("cpu")
    cpu_maps[1].lm_pos[...] = np.nextafter(cpu_maps[1].lm_pos, np.inf)
    cpu_maps[2].kf_pose[...] = np.nextafter(cpu_maps[2].kf_pose, np.inf)
    gt = {cid: SyntheticAgent(world, cid, n_keyframes=128, t0=5.0 * cid).traj.poses
          for cid in (0, 1)}

    def map_ate(m):
        rows = m.live_kf_rows()
        est = m.kf_pose[rows, 4:7]
        ref = np.stack([gt[int(c)][int(k), 4:7] for k, c in m.kf_ids[rows]])
        return ate(est, ref)

    # the pruning decision on one round-1 state, card against CPU
    p = mp.to_gba_problem()
    graph = gba.obs_graph(p)
    st, _ = gba._gba_rounds(p, graph, 5, 60, 1e-4, False, 2.447)
    p1 = gba._with_state(p, st)
    keep_card = gba._reproj_outlier_mask(p1, graph, cfg.th_gba_outlier_global)
    p1_cpu = gba.problem_to(p1, "cpu")
    keep_cpu = gba._reproj_outlier_mask(p1_cpu, gba.obs_graph(p1_cpu),
                                        cfg.th_gba_outlier_global)
    check(torch.equal(keep_card.cpu(), keep_cpu),
          "card and CPU prune other observations of the same state")

    # round 2 from that state and its pruned mask, on the card and on the
    # CPU, held to GBA_FACTOR times the CPU's own spread of the same round
    # when its landmarks or poses move by one ulp
    n_gn = cfg.gba_iteration_limit
    p2 = dataclasses.replace(p1, obs_mask=keep_card)
    st2_card, _ = gba._gba_rounds(p2, graph, n_gn, 60, 1e-4, False)
    st2_card = [x.cpu().numpy() for x in st2_card]
    threads = torch.get_num_threads()
    torch.set_num_threads(CPU_THREADS)
    try:
        p2_cpu = gba.problem_to(p2, "cpu")
        graph_cpu = gba.obs_graph(p2_cpu)
        st2_cpu, _ = gba._gba_rounds(p2_cpu, graph_cpu, n_gn, 60, 1e-4, False)
        st2_cpu = [x.numpy() for x in st2_cpu]
        r2_spread = 0.0
        for name in ("lms", "poses"):
            x = getattr(p2_cpu, name)
            moved = dataclasses.replace(p2_cpu, **{name: torch.nextafter(
                x, torch.full_like(x, float("inf")))})
            st_ulp, _ = gba._gba_rounds(moved, graph_cpu, n_gn, 60, 1e-4, False)
            r2_spread = max(r2_spread, _max_diff([x.numpy() for x in st_ulp], st2_cpu))
    finally:
        torch.set_num_threads(threads)
    r2_diff = _max_diff(st2_card, st2_cpu)
    check(r2_diff <= GBA_FACTOR * r2_spread,
          f"round 2 from one state: card and CPU differ by {r2_diff}, the CPU's "
          f"one-ulp spread is {r2_spread}")

    ate0 = map_ate(mp)
    n_obs = int(mp.obs_mask[: mp.n_obs].sum())
    wrappers = kernel_wrappers()
    for k in wrappers.values():
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    info = mgr.run_gba(mid)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: k.launches for name, k in wrappers.items()}
    for name in GBA_KERNELS:
        check(launches[name] > 0, f"run_gba never launched {name}")
    check(np.isfinite(info["costs"]).all() and (np.diff(info["costs"]) <= 0).all(),
          f"run_gba costs: {info['costs']}")
    n_steps = len(info.get("round1_costs", ())) + (
        0 if info.get("time_budget_hit") else len(info["costs"]))
    check(launches["gba_pcg"] == n_steps
          and launches["gba_reduced_matvec"] == K9_PER_STEP * n_steps,
          f"run_gba's {n_steps} steps launched gba_pcg {launches['gba_pcg']} times and "
          f"K9 {launches['gba_reduced_matvec']} times")
    ate1 = map_ate(mp)

    torch.set_num_threads(CPU_THREADS)
    infos, cpu_walls = [], []
    try:
        cpu_mgr = MapManager(vocab, cfg, device="cpu")
        for m in cpu_maps:
            cpu_mgr.maps[mid] = m
            t0 = time.perf_counter()
            infos.append(cpu_mgr.run_gba(mid))
            cpu_walls.append(time.perf_counter() - t0)
    finally:
        torch.set_num_threads(threads)
    cpu_map = cpu_maps[0]
    flips = int((mp.obs_mask != cpu_map.obs_mask).sum())
    cpu_flips = [int((m.obs_mask != cpu_map.obs_mask).sum()) for m in cpu_maps[1:]]
    check(flips <= GBA_FACTOR * max(max(cpu_flips), 1),
          f"run_gba on the card pruned {flips} observations other than the CPU's; "
          f"one ulp moves the CPU's own decisions by {cpu_flips}")
    states = ("kf_pose", "kf_vel", "kf_bias", "lm_pos")
    diff = max(float(np.abs(getattr(mp, k) - getattr(cpu_map, k)).max()) for k in states)
    spread = max(float(np.abs(getattr(m, k) - getattr(cpu_map, k)).max())
                 for m in cpu_maps[1:] for k in states)
    print(json.dumps({
        "phase": 6, "card": card, "n_kf": int(mp.n_kf), "n_lm": int(mp.lm_mask.sum()),
        "n_obs": n_obs, "loops": len(mp.loops),
        "round1_pruned_same_state": int((p1.obs_mask & ~keep_card).sum()),
        "round2_same_state_card_vs_cpu_diff": r2_diff,
        "round2_same_state_cpu_one_ulp_spread": r2_spread,
        "n_pruned": info["n_pruned"], "cpu_n_pruned": [i["n_pruned"] for i in infos],
        "pruned_differently": flips, "cpu_one_ulp_pruned_differently": cpu_flips,
        "costs": info["costs"].tolist(), "round1_costs": info["round1_costs"].tolist(),
        "ate_before_m": ate0, "ate_after_m": ate1, "ate_after_cpu_m": map_ate(cpu_map),
        "wall_s": wall, "cpu_wall_s": cpu_walls[0], "whole_run_card_vs_cpu_diff": diff,
        "whole_run_cpu_one_ulp_spread": spread, "factor": GBA_FACTOR, "launches": launches,
        "elapsed_s": time.perf_counter() - t_phase}))
    return launches


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
    "pgo_pcg": ("covins_tpu_torch/csrc/pgo_matvec.cu",
                "covins_tpu/ops/pgo.py:124"),
    "gba_reproj_blocks": ("covins_tpu_torch/csrc/gba_reproj_blocks.cu",
                          "covins_tpu/ops/gba.py:115"),
    "gba_reduced_matvec": ("covins_tpu_torch/csrc/gba_reduced_matvec.cu",
                           "covins_tpu/ops/gba.py:214"),
    "gba_pcg": ("covins_tpu_torch/csrc/gba_reduced_matvec.cu",
                "covins_tpu/ops/gba.py:399"),
    "imu_preintegrate": ("covins_tpu_torch/csrc/imu_preintegrate.cu",
                         "covins_tpu/ops/imu.py:137"),
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
    check(sorted(f"covins_tpu_torch/csrc/{n}.cu" for n in logs)
          == sorted({src for src, _ in SOURCES.values()}), "a kernel source was not built")

    gba_table = phase1(dev)
    print(json.dumps({"phase": 1, "elapsed_s": time.perf_counter() - t_start}))
    table, gpu_run, vocab, world = phase2(dev, card)
    print(json.dumps({"phase": 2, "elapsed_s": time.perf_counter() - t_start}))
    phase3(dev, card, n_kf=32)
    print(json.dumps({"phase": 3, "elapsed_s": time.perf_counter() - t_start}))
    phase4(dev, card)
    print(json.dumps({"phase": 4, "elapsed_s": time.perf_counter() - t_start}))
    phase5(dev, card)
    print(json.dumps({"phase": 5, "elapsed_s": time.perf_counter() - t_start}))
    gba_launches = phase6(dev, card, gpu_run, vocab, world)
    print(json.dumps({"phase": 6, "elapsed_s": time.perf_counter() - t_start}))
    for name, row in gba_table.items():
        row["launches"] = gba_launches[name]
    table.update(gba_table)

    kernels = []
    for name, row in table.items():
        src, replaces = SOURCES[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": row["launches"], "max_abs_err": row["max_abs_err"],
            "ms": row["kernel_ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"], "shape": row["shape"],
            **{k: row[k] for k in ("busy_ms", "library_busy_ms", "eager_kernel_ms",
                                   "profiler_ms", "profiler_intervals") if k in row},
        })
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
