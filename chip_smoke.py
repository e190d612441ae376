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
   K2, the whole landmark-attribute refresh in one launch, its descriptors
   exactly and its normals and distance ranges bit for bit (also its
   descriptor part alone); K1, K4 and K5 exactly (K1, binary tensor-core
   products, at the window's 6480 x 512, 8192 x 512, 65536 x 1024 and
   ragged shapes, ties across vocabulary tiles, bit for bit across two
   launches; K4, stage 1 in one
   launch that forms each distance once; K5, the whole of project-and-match in one
   launch, also with every landmark failing, the unified camera whose
   prologue PyTorch computes, and more features than shared memory holds;
   with the PyTorch operations one call issues), K3 (a window's vectors,
   insertion, scores and common-word counts in one launch) its vectors,
   rows and counts exactly and its scores bit for bit, K6 (all
   of stage 2's P3P RANSAC in one launch, from Gumbel noise and from given
   index sets, with two matches only, every root invalid, and more
   correspondences than shared memory holds) its counts, best pose and
   inlier mask exactly and every root's pose bit for bit (else within
   1e-12 relative, printed), with at most 10 PyTorch operations a call, K7
   to 1e-12 relative, K8 and K10 to 1e-13 relative (K10, one warp per
   factor, also at 255 x 256, the shape `Map.to_gba_problem` gives it;
   K8's linearisation, and its cost of 1 and of 7 stacked states per state, each one launch and
   timed; also for the unified camera and equidistant distortion, whose
   projection PyTorch hands the kernel), K9 to 1e-13 of the sums of
   magnitudes behind each output, the two PCG kernels (pgo_pcg, 100
   iterations, at a 256-pose graph of 1270 edges with the default edge
   weights and with all weights 100, and at ragged ones; gba_pcg, 60
   iterations) within GBA_FACTOR times their plain loop's own rounding
   spread (:func:`pcg_check`), K7-K10 and both PCG kernels bit for bit
   across two launches (K8-K10 and gba_pcg at bench.py's GBA problem and
   at ragged problems down to two keyframes); K7 and K9 beside one
   torch.mv of their matrix assembled densely; K11 (COVINS-G's top-2
   ratio matching per column segment on K1's binary product, at the
   verification's 2048 x 3072 in segments of 1024, ragged, with ties
   inside a segment, across a tile and across segments, every row masked,
   distances 0 and 256, few rows over many segments; a block a row tile,
   segment and column part) exactly, beside the +-1 bf16 matmul and topk;
   K12's scoring (work items of hypothesis and chunk of masked-in rays, at
   the COVINS-G path's shapes: six central RANSACs of 2000 poses over 1024
   rays, one of 512 over 6144, the refine's one pose, the covariance's 60,
   counts only; ragged; NaN poses) its counts, best and inliers exactly;
   K12's central 5-point RANSAC whole (sampling, Nister's solve, the
   decompositions, scoring and the best in one launch, at the drain's six
   pairs of 50 samples over 1024 rays from noise and from given sets,
   ragged, degenerate) every pose, validity, count, best and inlier mask
   bit for bit, its bound from FIVE_POINT_OPS; all the same across two
   launches; K13 (the L2 word assignment over 128 float32 dimensions, at
   a SIFT window's 12 x 1024 rows against 512 words, at 65536 x 1024,
   ragged, ties, every row masked, zero and large vectors, more
   near-equidistant words than a row keeps candidates, distances one ulp
   apart) and K14 (the L2 top-2 ratio match per segment, at the
   verification's 2048 x 3072 in segments of 1024, ties, masked rows and
   columns, a segment with one valid column, the same two scenes, a
   masked row tile and segments of 0, 1 and 2 valid columns) bit for bit,
   beside one float32 ``torch.matmul`` and ``argmin`` or ``topk``, with
   their tensor-core filter's candidates a row, rescanned rows and error
   (:func:`l2_filter_error`: within its bound on every pair, the
   product's share at most C_TC / 8; also on the SIFT phase's replayed
   inputs); K5's L2 metric (float64 distances) at stage 3's
   1024 x 1024 and stage 5's 10,070 x 1,024 exactly; K16 (the DBoW2
   vocabulary-tree descent, a warp a descriptor) bit for bit at ORBvoc.txt's
   shape (k 10, L 6, 1,111,111 nodes from a seed) with 6,480 and 65,536
   descriptors, on a ragged tree, tied children, k 2 and 16, N 0 and 1,
   with and without masked rows, across two launches, beside its bound
   (the distinct bytes its descents touch, :func:`dbow_bytes`), and on
   nodes wider than one round of 16 slots (k 17 and 32, ties across
   rounds, a ragged tree in slots of 40);
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
   CPU pass gave it (K5: the largest of verification stage 3 and of stage
   5), against its plain version, timed beside its bound (K1, K2, K3 and
   K10 also their busy time; K2 also the PyTorch operations of one map
   refresh and of its write-back; K3 also those of one window's
   ``add_and_query_batch``, lazy and not, and its copies);
3. a five-agent deployment (5 x 32 KF) with place recognition on, card
   only, and K2 replayed at its largest refresh cohort;
server. the agent-facing product on the card with phase 3's streams and
   vocabulary: (a) a `CovinsServer` on the card (every kernel built before
   it listens) takes the five agents from five `AgentClient`s streaming
   concurrently over TCP (the launch counters set to 0 just before and
   read after the last finish: K1-K6 and pgo_pcg, no K11-K14); stats shows
   160 keyframes, each agent's trajectory file 32 lines, at least one loop
   and one merge; (b) the admin verbs over the socket on the merged map
   (stats, pgo, gba, gba visual-only with a time budget, prunemap down to
   the live keyframes less 8, snapshot, savemap), each answering ok, with
   their wall times and launches (K8-K10, gba_pcg, K15), prunemap removing
   keyframes and stats showing the count fall by as many (culling may
   leave a 2 s pred-succ gap, SERVER_CULL_GAP: the default 1 s blocks
   every keyframe of a stream 0.5 s apart); K15 replayed on prunemap's
   input, bit for bit with its plain version on the card and on the CPU;
   (c) agents 0 and 1 saved by savemap from a server with place
   recognition off, then loadmap of both into a fresh server on the card,
   the second with placerec replay and PGO, against the same replay on
   the CPU: loops, merges and accepted pairs exactly, loop transforms to
   LOOP_TOL, poses to POSE_TOL; (d) `python -m covins_tpu_torch server`
   on the card in a subprocess, one CLI agent of 8 keyframes and `admin
   stats` showing them, the startup line naming the card.  The worker's
   caught exceptions (`CovinsServer.errors`) fail the phase;
4. the ingest-only path (``placerec_active=False``) on the benchmark
   workload, card against CPU, every map array, database row and queued
   score compared (database rows, scores and counts exactly);
5. bench.py's GBA problem (256 KF, 8192 landmarks, max_obs 61440) through
   ``global_bundle_adjustment(n_gn=PHASE5_GN, n_cg=60)`` (5 steps in round 2,
   cut from bench.py's 10 for time) with the counters set to
   0 just before it (the problem's build, K10, included) and read just
   after (gba_pcg once per Gauss-Newton step, K9 seven times, K8 twice and
   once more for the pruning): ms per
   Gauss-Newton step with the PCG kernel and with the eager loop in turns,
   the step ladder's seven costs stacked in one evaluation and as seven,
   in turns,
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
7. COVINS-G (``placerec_type="COVINS_G"``, ``G_ORB``) on phase 2's
   trajectories cut to 2 x 32 keyframes (PHASE7_KF, to keep the smoke
   within its time; widths unchanged) with the default thresholds: the
   whole ingest and drain on the card with the launch counters set to 0
   just before it and read just after (K1 and K3 once a window, K11 once
   and K12 four times a verification: the central 5-point RANSACs whole,
   then three scorings; nothing of COVINS's K4-K6 or of SIFT), failed if
   it closes no loop, the drain's time and the host's time per Gumbel
   draw, upload and dispatch; then the first G_HEAD_WINDOWS windows on the
   card and on the CPU (failed if they verify no candidate), compared: the database and every queued score,
   candidates, every verification's gates, pair matches, central
   inliers, pool and 17-point inliers, loops and merges exactly, loop
   transforms to LOOP_TOL, covariances to COV_TOL, poses to POSE_TOL;
   then K11 and K12 replayed on the card on the largest inputs the CPU
   pass gave them, and the PyTorch operations of one verification's
   dispatch on the card (at most 20,000) beside the host's ms a dispatch;
SIFT. the same over SIFT descriptors (``G_SIFT``: ``feat_type="SIFT"``,
   128 float32 dimensions, ``img_match_thres=500``, else the defaults) on
   phase 7's 2 x 32 keyframes, with a 512-word L2 vocabulary trained on the
   card (k-means on K13): K13 and K3 once a window, K14 once and K12 four
   times a verification, no kernel of binary descriptors; K13 and K14
   replayed.  In phase 7 and here, poses that differ by more than POSE_TOL
   are held within GBA_FACTOR times the CPU pass's own one-ulp spread
   (two more CPU passes, their pose graphs' inputs one ulp up and down,
   which must take the same decisions);
frontend. the front-end attachment on the card (:func:`phase_frontend`):
   phase 2's trajectories cut to 2 x 32 keyframes written as CFS streams
   (keypoints, descriptors, odometry, velocity, IMU windows; no
   landmarks), a k 10, L 3 DBoW2 text vocabulary over 1000 centres trained
   on the card, loaded through the CLI's `.txt` path, a `CovinsServer` on
   the card in COVINS-G fed by two `run_stream` clients over TCP (counters
   set to 0 before, read after the last finish: K1 and K3 once a window,
   K11 once and K12 four times a verification, pgo_pcg once loops fired,
   nothing of COVINS or SIFT, and K16 on no server path), then the CLI's
   `frontend` in a
   subprocess as a third agent: every keyframe arrived, no worker error,
   every client finished; the adapter's keyframes through `AgentSession`
   on the card and on the CPU in windows of FRONTEND_WINDOW keyframes,
   compared as phase 7 compares; `HierVocabulary.assign` (K16, once per
   agent, those launches printed as `assign_launches`) on the card against
   the CPU, and K16 timed on its input;
sharding. `parallel/sharding.py` on the card at world 1 over NCCL
   (:func:`phase_sharding`): the landmark-sharded GBA step at phase 5's
   problem (2 steps of 60 CG iterations), the edge-sharded pose graph (256
   poses, 1270 edges), `parallel/dryrun.dryrun_multichip`, the row-sharded
   retrieval (B15, 1024 x 512, k 10) and Hamming k-NN (B14, 2048 x 3072,
   k 2 on K11's top-2 entry `hamming_knn2`, k 5 on K1), counted (launches
   and collectives against their numbers), then held bit for bit to their
   undivided forms on the card; knn2 against its plain version with ties
   and duplicated rows; times beside the undivided GBA step and pose graph;
8. one JSON line per the kernel table (K1-K7 and pgo_pcg timed on phase
   2's inputs with phase 2's launches, K8-K10 and gba_pcg on bench.py's
   GBA problem with phase 6's launches, K11 and K12 on phase 7's inputs
   with its launches, K13 and K14 on the SIFT phase's with its launches,
   K5's L2 metric on phase 1's stage-5 scene with the SIFT phase's launches
   of K5, none; K15 on the server phase's prunemap input with its
   launches; K16 on the phase "frontend"'s descriptors with the server
   path's launches of K16, 0; knn2 on phase "sharding"'s k-NN with its
   launches, and that phase's launches of K1, K7, K8 and K9 beside theirs
   as ``sharding_launches``), checked to hold every kernel of SOURCES,
   the card line, and the result line
   ``{"ok": true, "device": {...}}``.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

# published peaks of one H100 SXM (dense): HBM bytes/s, int8 and TF32
# tensor ops/s, float32 and float64 ops/s outside the tensor cores
HBM_BYTES_S = 3.35e12
INT8_OPS_S = 1979e12
TF32_OPS_S = 495e12
FP32_OPS_S = 67e12
FP64_OPS_S = 34e12

SEED = 0
WINDOW = 1024
# the warm-up's share of the bench stream: its first windows' drain already
# closes loops, merges the two agents' maps and solves a pose graph
WARM_WINDOWS = 4
# the COVINS-G cells' keyframes an agent (phase 7 and the SIFT phase): cut
# from the bench's 128 to keep the smoke well within its time limit, which
# the host's pace between calls (up to twofold in a drain) otherwise nears
PHASE7_KF = 32
# phase 5's round-2 Gauss-Newton steps: cut from bench.py's 10 to keep the
# smoke within its time limit (its three CPU solves are most of the phase)
PHASE5_GN = 5
# the windows of a COVINS-G cell compared card against CPU: the CPU's pass
# is most of the cell's time
G_HEAD_WINDOWS = 4
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
# decision moves (centimetres).  Some graphs amplify far more: in the SIFT
# phase's compared windows a loop edge of Cauchy weight near 0 leaves the
# second solve's preconditioned system a condition number of 3e5, where its
# first 100 PCG steps end wherever rounding sends them, so one ulp at the
# solves' input moves the CPU's own poses by 9.2e-4 and 1.0e-3 and its
# thread count by 9.7e-4 (scripts/port_sift_pose_spread.py).  Where the
# card's poses differ by more than POSE_TOL, a COVINS-G cell therefore
# reads that one-ulp spread of its CPU pass and holds them within
# GBA_FACTOR times it, as every PCG result is held (:func:`compare_full`).
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


# launches the host may queue behind busy_ms's spin kernel: a stream's
# queue holds about a thousand, and a host that fills it waits for the card
QUEUED_LAUNCHES = 800


def busy_ms(fn, reps):
    """The card's time per call of ``fn`` without the host's cadence: the
    ``reps`` calls are queued behind a spin kernel (``torch.cuda._sleep``)
    that outlasts the host's issuing of them, and timed with CUDA events
    from the spin's end to the last call's end.  ``reps`` is cut so that
    the calls' PyTorch operations stay within QUEUED_LAUNCHES.  None if the
    host could not get ahead of the card (``fn`` waits for the card, or
    one call alone fills the queue)."""
    import torch

    fn()
    torch.cuda.synchronize()
    ops = count_ops(fn)
    if ops > QUEUED_LAUNCHES:
        return None
    reps = max(1, min(reps, QUEUED_LAUNCHES // max(ops, 1)))
    cycles = 1 << 24
    for _ in range(5):
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


def k1_case(a, b, mask, reps, want_dist=False):
    import torch

    from covins_tpu_torch.ops import descriptors as d

    idx, dmin = d.hamming_argmin(a, b, mask)
    idx_p, dmin_p = d.hamming_argmin_plain(a, b, mask)
    idx2, dmin2 = d.hamming_argmin(a, b, mask)
    torch.cuda.synchronize()
    shape = f"{tuple(a.shape)}x{tuple(b.shape)}"
    check(torch.equal(idx, idx_p) and torch.equal(dmin, dmin_p),
          f"K1 disagrees with its plain version at {shape}")
    check(torch.equal(idx, idx2) and torch.equal(dmin, dmin2),
          f"K1 differs between two launches at {shape}")
    if want_dist:
        dist = d.hamming_argmin(a, b, mask, want_dist=True)[2]
        check(torch.equal(dist, d.hamming_distance(a, b)),
              f"K1's distance matrix disagrees at {shape}")
    m, n = a.shape[0], b.shape[0]
    bnd, by = bound(m * 32 + n * 32 + m + 8 * m, (2.0 * m * n * 256, INT8_OPS_S))
    return {
        "kernel_ms": cuda_ms(lambda: d.hamming_argmin(a, b, mask), reps),
        "busy_ms": busy_ms(lambda: d.hamming_argmin(a, b, mask), reps),
        "plain_ms": cuda_ms(lambda: d.hamming_argmin_plain(a, b, mask), reps),
        "library_ms": cuda_ms(lambda: pm1_bf16_argmin(a, b), reps),
        "bound_ms": bnd, "bound_by": by,
        "max_abs_err": int((idx - idx_p).abs().max().item()) if m else 0,
    }


def k2_descriptors_case(descs, mask, reps):
    """K2's descriptor part (`landmark_ops.representative_descriptors` on
    the card) against its plain version, exactly."""
    import torch

    from covins_tpu_torch.ops import landmark_ops as lo

    out = lo.representative_descriptors(descs, mask)
    ref = lo.representative_descriptors_plain(descs, mask)
    torch.cuda.synchronize()
    check(torch.equal(out, ref), f"K2's descriptors disagree at {tuple(descs.shape)}")
    return {"kernel_ms": cuda_ms(lambda: lo.representative_descriptors(descs, mask), reps),
            "max_abs_err": int((out.int() - ref.int()).abs().max().item())}


def refresh_bytes_ops(L, P):
    """Bytes and operations of the landmark-attribute refresh: the packed
    input read once ((3 + 4P) float64 and 33P bytes a landmark) and 72
    bytes a landmark written; each pair's Hamming distance as a +-1 int8
    dot product of 256 (512 operations), and about 40 float64 operations
    an observation (difference, norm, direction, power, sums) and 30 a
    landmark."""
    return (L * ((3 + 4 * P) * 8 + 33 * P) + 72 * L,
            [(2.0 * L * P * P * 256, INT8_OPS_S), (L * (40.0 * P + 30), FP64_OPS_S)])


def refresh_case(packed, L, P, reps):
    """K2, the whole landmark-attribute refresh in one launch, against its
    plain version on the card: descriptors exactly, normals and ranges bit
    for bit; one launch a call, bit for bit across two launches."""
    import torch

    from covins_tpu_torch.ops import landmark_ops as lo

    def kernel():
        return lo.landmark_attributes(packed, L, P)

    before = lo.landmark_attributes.launches
    out = kernel()
    check(lo.landmark_attributes.launches == before + 1, "K2 did not launch once per call")
    again = kernel()
    ref = lo.landmark_attributes_plain(packed, L, P)
    torch.cuda.synchronize()
    check(torch.equal(out, again), "K2 differs between two launches")
    got, want = lo.unpack_attributes(out, L), lo.unpack_attributes(ref, L)
    check(torch.equal(got[0], want[0]), f"K2's descriptors disagree at {L} x {P}")
    float_err = max(float((a - b).abs().max().item()) if L else 0.0
                    for a, b in zip(got[1:], want[1:]))
    check(float_err == 0.0, f"K2's normals or ranges differ from its plain version by "
                            f"{float_err} at {L} x {P}")
    nbytes, ops = refresh_bytes_ops(L, P)
    bnd, by = bound(nbytes, *ops)
    return {
        "kernel_ms": cuda_ms(kernel, reps), "busy_ms": busy_ms(kernel, reps),
        "ops_per_call": count_ops(kernel),
        "plain_ms": cuda_ms(lambda: lo.landmark_attributes_plain(packed, L, P), reps),
        "library_ms": None, "bound_ms": bnd, "bound_by": by,
        "max_abs_err": float_err,
    }


def k3_case(words, dest, db, n, reps):
    """K3 (`bow_insert_score`: a window's vectors, insertion, scores and
    common-word counts in one launch) against its plain version: vectors,
    rows and counts exactly, scores bit for bit, bit for bit across two
    launches."""
    import torch

    from covins_tpu_torch.ops import bow

    db_k, db_p, db_2 = db.clone(), db.clone(), db.clone()
    before = bow.bow_insert_score.launches
    vecs, out = bow.bow_insert_score(words, dest, db_k, n)
    check(bow.bow_insert_score.launches == before + 1, "K3 did not launch once per call")
    vecs_p, out_p = bow.bow_insert_score_plain(words, dest, db_p, n)
    vecs_2, out_2 = bow.bow_insert_score(words, dest, db_2, n)
    torch.cuda.synchronize()
    # the word counts, recovered from the vectors with the exact norms
    cap, V = db.shape
    valid = (words >= 0) & (words < V)
    counts = torch.zeros((words.shape[0], V), device=words.device).scatter_add_(
        1, torch.where(valid, words, 0).long(), valid.float())
    norm = torch.clamp(counts.square().sum(1, keepdim=True).sqrt(), min=1e-12)
    shape = f"{tuple(words.shape)}, db {tuple(db.shape)}, n {n}"
    check(torch.equal(torch.round(vecs * norm), counts), f"K3 word counts disagree at {shape}")
    check(torch.equal(vecs, vecs_p), f"K3 vectors disagree at {shape}")
    check(torch.equal(db_k, db_p), f"K3 database rows disagree at {shape}")
    check(torch.equal(out[:, 0], out_p[:, 0]), f"K3 scores are not the plain version's at {shape}")
    check(torch.equal(out[:, 1].view(torch.int32), out_p[:, 1].view(torch.int32)),
          f"K3 common-word counts disagree at {shape}")
    check(torch.equal(out_2, out) and torch.equal(vecs_2, vecs) and torch.equal(db_2, db_k),
          f"K3 differs between two launches at {shape}")
    W, F = words.shape
    stored = int(((dest >= 0) & (dest < cap)).sum().item())
    # bytes: the word ids and destinations, the n scored rows read; the
    # vectors, the inserted rows and the (W, 2, n) result written;
    # operations: an add a word, three a bin, and per scored row and
    # window row a product, a sum and a common-word test a bin
    bnd, by = bound(W * F * 4 + W * 8 + n * V * 4 + (W + stored) * V * 4 + W * 2 * n * 4,
                    (W * F + 3.0 * W * V + 3.0 * W * V * n, FP32_OPS_S))
    return {
        "kernel_ms": cuda_ms(lambda: bow.bow_insert_score(words, dest, db_k, n), reps),
        "busy_ms": busy_ms(lambda: bow.bow_insert_score(words, dest, db_k, n), reps),
        "plain_ms": cuda_ms(lambda: bow.bow_insert_score_plain(words, dest, db_p, n), reps),
        "library_ms": None,
        "bound_ms": bnd, "bound_by": by,
        "max_abs_err": float((out[:, 0] - out_p[:, 0]).abs().max().item()) if out.numel() else 0.0,
    }


def window_counts(vocab, W, F, dev, reps=20):
    """One window's `KeyframeDatabase.add_and_query_batch` on the card at W
    keyframes of F descriptors, its ids already inserted (the same scoring,
    no new rows), in a database of 1024 rows of which 1024 are scored:
    PyTorch operations, host-to-device and device-to-host copies, lazy and
    not, the mean host time of a call (the non-lazy one waits for its
    fetch) and the card's busy time of the lazy one."""
    import torch

    from covins_tpu_torch.models.kf_database import KeyframeDatabase

    rng = np.random.default_rng(SEED + W * F)
    db = KeyframeDatabase(vocab, capacity=1024, device=dev)
    fill = [rng.integers(0, 256, (64, 32), dtype=np.uint8) for _ in range(1024 - W)]
    for k in range(0, len(fill), 64):
        db.add_and_query_batch([(i, 1) for i in range(k, min(k + 64, len(fill)))],
                               fill[k:k + 64], lazy=True)
    ids = [(i, 0) for i in range(W)]
    descs = [rng.integers(0, 256, (F, 32), dtype=np.uint8) for _ in range(W)]
    db.add_and_query_batch(ids, descs, lazy=True)
    check(db.n == 1024, f"the database holds {db.n} rows, not 1024")
    row = {}
    for lazy, tag in ((True, "_lazy"), (False, "")):
        def call():
            return db.add_and_query_batch(ids, descs, lazy=lazy)

        call()
        torch.cuda.synchronize()
        ops, h2d, d2h = trace_ops(call)
        t0 = time.perf_counter()
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
        row.update({f"window_ops{tag}": ops, f"window_h2d{tag}": h2d, f"window_d2h{tag}": d2h,
                    f"window_ms{tag}": (time.perf_counter() - t0) * 1e3 / reps})
    row["window_busy_ms_lazy"] = busy_ms(lambda: db.add_and_query_batch(ids, descs, lazy=True),
                                         reps)
    return row


def k4_case(a, am, b, bm, max_dist, reps):
    import torch

    from covins_tpu_torch.ops import descriptors as d

    def kernel():
        return d.hamming_mutual_nn(a, am, b, bm, max_dist)

    before = d.hamming_mutual_nn.launches
    got = kernel()
    check(d.hamming_mutual_nn.launches == before + 1, "K4 did not launch once per call")
    again = kernel()
    ref = d.hamming_mutual_nn_plain(a, am, b, bm, max_dist)
    torch.cuda.synchronize()
    check(torch.equal(got, ref),
          f"K4 disagrees with its plain version at {tuple(a.shape)}x{tuple(b.shape)}")
    check(torch.equal(got, again), "K4 differs between two launches")
    m, n = a.shape[0], b.shape[0]
    n_rows, n_cols = int(am.sum().item()), int(bm.sum().item())
    # each valid (row, column) pair's distance once: a +-1 int8 dot
    # product of 256, 512 operations
    bnd, by = bound((m + n) * 33 + m * 4, (2.0 * n_rows * n_cols * 256, INT8_OPS_S))
    return {
        "kernel_ms": cuda_ms(kernel, reps), "busy_ms": busy_ms(kernel, reps),
        "ops_per_call": count_ops(kernel),
        "plain_ms": cuda_ms(lambda: d.hamming_mutual_nn_plain(a, am, b, bm, max_dist),
                            reps),
        "library_ms": None,
        "bound_ms": bnd, "bound_by": by,
        "max_abs_err": int((got - ref).abs().max().item()) if m else 0,
        "matches": int((got >= 0).sum().item()),
    }


def pm1_bf16_top2(a, b, seg):
    """K11's library form: the JAX package's +-1 bf16 product as one
    PyTorch matmul, then ``torch.topk`` of the two smallest distances of
    each segment (a yardstick only; the port never calls it)."""
    import torch

    from covins_tpu_torch.ops.descriptors import unpack_to_pm1

    dot = unpack_to_pm1(a, torch.bfloat16) @ unpack_to_pm1(b, torch.bfloat16).T
    dist = (256.0 - dot.float()) * 0.5
    return torch.topk(dist.view(a.shape[0], -1, seg), 2, dim=-1, largest=False)


def k11_case(a, am, b, bm, seg, reps, max_dist=40.0, ratio=0.8):
    """K11 (hamming_ratio_match) against its plain version: index, d1 and
    d2 exactly, the same across two launches, one launch a call."""
    import torch

    from covins_tpu_torch.ops import descriptors as d

    def kernel():
        return d.hamming_ratio_match(a, am, b, bm, seg, max_dist, ratio)

    before = d.hamming_ratio_match.launches
    got = kernel()
    check(d.hamming_ratio_match.launches == before + 1, "K11 did not launch once per call")
    again = kernel()
    ref = d.hamming_ratio_match_plain(a, am, b, bm, seg, max_dist, ratio)
    torch.cuda.synchronize()
    shape = f"{tuple(a.shape)}x{tuple(b.shape)} in segments of {seg}"
    for g, x, r in zip(got, again, ref):
        check(torch.equal(g, r), f"K11 disagrees with its plain version at {shape}")
        check(torch.equal(g, x), f"K11 differs between two launches at {shape}")
    m, n = a.shape[0], b.shape[0]
    n_rows, n_cols = int(am.sum().item()), int(bm.sum().item())
    # each valid (row, column) pair's distance: a +-1 int8 dot product of
    # 256, 512 operations; inputs once, 12 bytes a (row, segment) out
    bnd, by = bound((m + n) * 33 + 12 * m * (n // seg),
                    (2.0 * n_rows * n_cols * 256, INT8_OPS_S))
    return {
        "kernel_ms": cuda_ms(kernel, reps), "busy_ms": busy_ms(kernel, reps),
        "plain_ms": cuda_ms(lambda: d.hamming_ratio_match_plain(
            a, am, b, bm, seg, max_dist, ratio), reps),
        "library_ms": cuda_ms(lambda: pm1_bf16_top2(a, b, seg), reps),
        "bound_ms": bnd, "bound_by": by,
        "max_abs_err": int(max((g - r).abs().max().item() for g, r in zip(got, ref)))
        if m else 0,
        "matches": int((got[0] >= 0).sum().item()),
    }


def l2_library(a, b):
    """The squared L2 distances as the JAX package forms them, with one
    PyTorch product in full float32 (TF32 off, `covins_tpu_torch.device`):
    a yardstick only; the port never calls it."""
    import torch

    aa = (a * a).sum(1)
    bb = (b * b).sum(1)
    return torch.clamp((aa[:, None] + bb) - 2.0 * (a @ b.T), min=0.0)


def l2_bytes_ops(m, n, valid_rows, valid_cols, out_bytes):
    """Bytes and float32 operations of one K13 / K14 call: every input row
    and mask read once, ``out_bytes`` written; a multiply and an add per
    dimension of each valid (row, column) pair and of each valid row's and
    column's squares, three operations a pair for the distance (a square
    root for K14 counted as one more)."""
    nbytes = (m + n) * (512 + 1) + out_bytes
    ops = 256.0 * (valid_rows * valid_cols + valid_rows + valid_cols) \
        + 4.0 * valid_rows * valid_cols
    return nbytes, ops


def l2_filter_error(a, b):
    """The tensor-core filter of K13 and K14 on the card against its bound,
    over every pair of ``a`` and ``b``, from the real kernel's filter
    distance (`descriptors.l2_filter_values`): within
    ``l2_filter_threshold`` of the plain distance everywhere, and the
    product's share of the error, (|d~ - d| - 4u (aa + bb)) / (2 sqrt(aa
    bb)) (the two subtractions' rounding taken off), at most C_TC / 8.
    Returns the largest |d~ - d| / sqrt(aa bb) and that share, each over
    C_TC."""
    import torch

    from covins_tpu_torch.ops import descriptors as d

    aa, bb = d.sum_squares(a).double(), d.sum_squares(b).double()
    raw = product = 0.0
    for r0 in range(0, a.shape[0], 8192):
        rows = slice(r0, r0 + 8192)
        err = (d.l2_filter_values(a[rows], b).double()
               - d.l2_distance_sq(a[rows], b).double()).abs()
        check(bool((err <= d.l2_filter_threshold(aa[rows], bb)).all()),
              f"the L2 filter leaves its bound T at {tuple(a.shape)}x{tuple(b.shape)}")
        scale = torch.sqrt(aa[rows, None] * bb[None, :])
        safe = torch.where(scale > 0, scale, 1.0)
        rounding = 2.0 ** -22 * (aa[rows, None] + bb[None, :])
        raw = max(raw, float(torch.where(scale > 0, err / safe, 0.0).max().item()))
        share = torch.where(scale > 0, (err - rounding).clamp(min=0.0) / (2 * safe), 0.0)
        product = max(product, float(share.max().item()))
    raw, product = raw / d.L2_FILTER_REL_ERR, product / d.L2_FILTER_REL_ERR
    check(product <= 1 / 8, f"the L2 filter's product error is {product} C_TC "
                            "(at most 1/8 allowed)")
    return raw, product


def l2_filter_row(counts, nbytes, ops, pairs_tc, seg, errs):
    """The filter's readings of one K13 / K14 call (the kernel's counters
    after it) and this design's own floor: three TF32 products a computed
    pair, then 256 float32 operations a candidate and, for a rescanned
    row, a pair of its at most ``seg`` columns, beside the float32 work the
    exact answer needs (``ops``)."""
    lists, cands, most, over = (int(x) for x in counts.tolist())
    exact = 256.0 * (cands + over * seg)
    tc, by = bound(nbytes, (6.0 * 128 * pairs_tc, TF32_OPS_S), (ops - 256.0 * pairs_tc + exact,
                                                              FP32_OPS_S))
    return {"candidates_mean": cands / max(lists - over, 1), "candidates_max": most,
            "overflow_rows": over, "filtered_rows": lists, "filter_err_over_c_tc": errs[0],
            "filter_product_err_over_c_tc": errs[1], "design_bound_ms": tc,
            "design_bound_by": by}


def k13_case(a, b, mask, reps):
    """K13 (l2_argmin) against its plain version: word ids and minima bit
    for bit, the same across two launches, one launch a call; its filter's
    candidates and error (:func:`l2_filter_row`)."""
    import torch

    from covins_tpu_torch.ops import descriptors as d

    def kernel():
        return d.l2_argmin(a, b, mask)

    counts = d.l2_filter_counts(a.device)
    counts.zero_()
    before = d.l2_argmin.launches
    idx, dmin = kernel()
    check(d.l2_argmin.launches == before + 1, "K13 did not launch once per call")
    counts = counts.clone()
    idx2, dmin2 = kernel()
    idx_p, dmin_p = d.l2_argmin_plain(a, b, mask)
    torch.cuda.synchronize()
    shape = f"{tuple(a.shape)}x{tuple(b.shape)}"
    check(torch.equal(idx, idx_p) and torch.equal(dmin, dmin_p),
          f"K13 disagrees with its plain version at {shape}")
    check(torch.equal(idx, idx2) and torch.equal(dmin, dmin2),
          f"K13 differs between two launches at {shape}")
    m, n = a.shape[0], b.shape[0]
    rows = m if mask is None else int(mask.sum().item())
    nbytes, ops = l2_bytes_ops(m, n, rows, n, 8 * m)
    bnd, by = bound(nbytes, (ops, FP32_OPS_S))
    # the kernel computes masked rows too
    filt = l2_filter_row(counts, nbytes, l2_bytes_ops(m, n, m, n, 8 * m)[1], m * n, n,
                         l2_filter_error(a, b))
    return {
        **filt,
        "kernel_ms": cuda_ms(kernel, reps), "busy_ms": busy_ms(kernel, reps),
        "plain_ms": cuda_ms(lambda: d.l2_argmin_plain(a, b, mask), 3),
        "library_ms": cuda_ms(lambda: torch.argmin(l2_library(a, b), dim=1), reps),
        "bound_ms": bnd, "bound_by": by,
        "max_abs_err": float(max((idx - idx_p).abs().max().item(),
                                 (dmin - dmin_p).abs().max().item())) if m else 0.0,
    }


def k14_case(a, am, b, bm, seg, reps, max_dist=500.0, ratio=0.8):
    """K14 (l2_ratio_match) against its plain version: index, d1 and d2
    bit for bit, the same across two launches, one launch a call."""
    import torch

    from covins_tpu_torch.ops import descriptors as d

    def kernel():
        return d.l2_ratio_match(a, am, b, bm, seg, max_dist, ratio)

    def library():
        x = torch.sqrt(l2_library(a, b))
        return torch.topk(x.view(a.shape[0], -1, seg), 2, dim=-1, largest=False)

    counts = d.l2_filter_counts(a.device)
    counts.zero_()
    before = d.l2_ratio_match.launches
    got = kernel()
    check(d.l2_ratio_match.launches == before + 1, "K14 did not launch once per call")
    counts = counts.clone()
    again = kernel()
    ref = d.l2_ratio_match_plain(a, am, b, bm, seg, max_dist, ratio)
    torch.cuda.synchronize()
    shape = f"{tuple(a.shape)}x{tuple(b.shape)} in segments of {seg}"
    for g, x, r in zip(got, again, ref):
        check(torch.equal(g, r), f"K14 disagrees with its plain version at {shape}")
        check(torch.equal(g, x), f"K14 differs between two launches at {shape}")
    m, n = a.shape[0], b.shape[0]
    valid_rows, valid_cols = int(am.sum().item()), int(bm.sum().item())
    nbytes, ops = l2_bytes_ops(m, n, valid_rows, valid_cols, 12 * m * (n // seg))
    bnd, by = bound(nbytes, (ops, FP32_OPS_S))
    filt = l2_filter_row(counts, nbytes, ops, valid_rows * valid_cols, seg,
                         l2_filter_error(a, b))
    return {
        **filt,
        "kernel_ms": cuda_ms(kernel, reps), "busy_ms": busy_ms(kernel, reps),
        "plain_ms": cuda_ms(lambda: d.l2_ratio_match_plain(a, am, b, bm, seg, max_dist,
                                                           ratio), 3),
        "library_ms": cuda_ms(library, reps),
        "bound_ms": bnd, "bound_by": by,
        "max_abs_err": float(max((g.double() - r.double()).abs().max().item()
                                 for g, r in zip(got, ref))) if m else 0.0,
        "matches": int((got[0] >= 0).sum().item()),
    }


# K12's float64 operations per (valid hypothesis, masked-in ray), as the
# maths needs them (an add, multiply, comparison, quotient, square root or
# arccos counts one; integer and index work none).  Non-central: the
# origin rotated and translated (30 + 3) and the direction rotated (30),
# w0 = va - ob (3), five dot products (25), the denominator and its test
# (5), s and t with their signs (10), the midpoint (18), two angles (19
# each: difference, squared norm, sqrt, clamp, dot, quotient, clip,
# arccos), the maximum and the threshold (2): 164.  Central (zero
# origins, known to the kernel): ob = t and w0 = -t need no work a ray,
# the midpoint 15 and the first angle 16: 122, and w0's 3 a hypothesis.
RAY_SCORE_OPS = {"central": 122, "noncentral": 164}
RAY_SCORE_OPS_PER_HYP = {"central": 3, "noncentral": 0}


def k12_work(T, va, fa, vb, fb, mask, thr, valid=None, want_inliers=True):
    """A K12 call's size for the recorder: hypotheses x masked-in rays."""
    return T.shape[1] * int(mask.sum().item()), T.shape[0] * T.shape[1]


def k12_case(args, kw, reps):
    """K12 (ray_ransac_score) against its plain version: counts, best and
    inlier masks exactly, the same across two launches, one launch a
    call."""
    import torch

    from covins_tpu_torch.ops import epipolar as e

    def kernel():
        return e.ray_ransac_score(*args, **kw)

    before = e.ray_ransac_score.launches
    got = kernel()
    check(e.ray_ransac_score.launches == before + 1, "K12 did not launch once per call")
    again = kernel()
    ref = e.ray_ransac_score_plain(*args, **kw)
    torch.cuda.synchronize()
    T, va, fa, vb, fb, mask = args[:6]
    B, H, N = T.shape[0], T.shape[1], fa.shape[1]
    shape = f"{B} x {H} poses x {N} rays"
    for g, x, r in zip(got, again, ref):
        if r is None:
            check(g is None and x is None, "K12 returned what was not asked for")
            continue
        check(torch.equal(g, r), f"K12 disagrees with its plain version at {shape}")
        check(torch.equal(g, x), f"K12 differs between two launches at {shape}")
    valid = kw.get("valid")
    hyps = valid.sum(1) if valid is not None else torch.full((B,), H, device=T.device)
    rays = mask.sum(1)
    inl = kw.get("want_inliers", True)
    kind = "noncentral" if va is not None else "central"
    # every valid hypothesis on its batch entry's masked-in rays (the best
    # row's inlier mask is among them, so it needs no more work)
    ops = (RAY_SCORE_OPS[kind] * int((hyps * rays).sum().item())
           + RAY_SCORE_OPS_PER_HYP[kind] * int(hyps.sum().item()))
    # read once: the valid hypotheses' poses, the flags, the mask and the
    # masked-in rays (directions, and origins where non-central); written
    # once: the counts, and the best index and inlier mask if asked for
    n_rays, n_hyps = int(rays.sum().item()), int(hyps.sum().item())
    bnd, by = bound(n_hyps * 56 + (B * H if valid is not None else 0) + B * N
                    + n_rays * 24 * (4 if kind == "noncentral" else 2)
                    + B * H * 4 + (B * (4 + N) if inl else 0),
                    (ops, FP64_OPS_S))
    return {
        "kernel_ms": cuda_ms(kernel, reps), "busy_ms": busy_ms(kernel, reps),
        "plain_ms": cuda_ms(lambda: e.ray_ransac_score_plain(*args, **kw),
                            max(1, reps // 10)),
        "library_ms": None, "bound_ms": bnd, "bound_by": by,
        "max_abs_err": int((got[0] - ref[0]).abs().max().item()),
        "max_count": int(got[0].max().item()),
    }


# The 5-point solve's float64 operations a sample (K12's central RANSAC
# whole, `csrc/relpose_ransac.cu`), as the maths needs them (an add,
# multiply, comparison, quotient, square root or transcendental function
# counts one; integer, index and select work none; the polynomial products
# over the monomials that can be nonzero): the 5 x 9 A; A^T A (81 entries
# of 5 products and 4 sums; the emulated fused multiply-adds' extra
# operations not counted); 8 Jacobi sweeps of 36 rotations (the angle 11,
# the row update 9 x 6, the column update 18 x 6); the eigenvalue order;
# the minors, E E^T, its trace, det(E) and the 9 trace constraints at
# their 20 monomials (a linear times a linear form 16 products and 16
# sums, a linear times a quadratic 40 and 40); the 10 x 20 Gauss-Jordan
# on its remaining columns; Bx, By, Bz and the degree-10 determinant; the
# Fujiwara scale and the scaled coefficients; the 256-point grid (its
# angles, and the homogenised form: sin, cos, two chains of 10 products,
# 22 products and 10 sums) and its sign changes; then for each of the 10
# roots the back-substitution, the normalised E, the 3 x 3 SVD (24
# rotations of 65) and the 4 poses.  A valid root adds its bisection (45
# forms), tan and 3 Newton steps.
FIVE_POINT_OPS = {
    "A": 45, "AtA": 81 * 9, "jacobi": 8 * 36 * (11 + 9 * 6 + 18 * 6), "order": 81,
    "minors": 3 * (2 * 32 + 10), "EEt": 9 * (3 * 32 + 2 * 10), "trace": 20,
    "det": 3 * 80 + 2 * 20, "constraints": 9 * (3 * 80 + 2 * 20 + 20 + 80 + 20),
    "gauss_jordan": 55 + 155 + 18 * 155, "p10": 39 + 88 + 88 + 71 + 220,
    "scale": 32 + 53, "grid": 256 * (2 + 54) + 255 * 4,
    "roots": 10 * (215 + (45 + 1560 + 110) + 322),
}
FIVE_POINT_OPS_PER_VALID_ROOT = 54 + 44 * 58 + 2 + 136


def k12_5pt_work(fa, fb, mask, *args, **kw):
    """A 5-point call's size for the recorder: masked-in rays, pairs."""
    return int(mask.sum().item()), fa.shape[0]


def k12_5pt_case(args, kw, reps):
    """K12's central 5-point RANSAC whole (relpose_ransac_5pt) against its
    plain version: every pose bit for bit (NaN where both are), validity,
    counts, the best, its pose, count and inliers exactly, the same across
    two launches, one launch a call; call and busy times and the bound for
    this input (FIVE_POINT_OPS a sample and a valid root, RAY_SCORE_OPS
    central a valid pose and masked-in ray)."""
    import torch

    from covins_tpu_torch.ops import epipolar as e

    def kernel():
        return e.relpose_ransac_5pt(*args, **kw)

    before = e.relpose_ransac_5pt.launches
    got = kernel()
    check(e.relpose_ransac_5pt.launches == before + 1, "K12 (5-point) did not launch once")
    again = kernel()
    ref = e.relative_pose_ransac_central_5pt_plain(*args, **kw)
    torch.cuda.synchronize()
    fa, fb, mask, H = args[:4]
    B, N = mask.shape
    shape = f"{B} x {H} samples x {N} rays"
    for k in ref:
        check(_nan_equal(got[k], again[k]), f"K12 (5-point) {k} differs between two launches")
        if not _nan_equal(got[k], ref[k]):
            bad = ~((got[k] == ref[k]) | (got[k].isnan() & ref[k].isnan()))
            print(json.dumps({"k12_5pt_differs": shape, "output": k,
                              "entries": int(bad.sum().item())}))
        check(_nan_equal(got[k], ref[k]), f"K12 (5-point) {k} disagrees with its plain "
                                          f"version at {shape}")
    ops = count_ops(kernel)
    check(ops <= 20, f"a 5-point K12 call issues {ops} PyTorch operations")
    rays = mask.sum(1)
    hyps = ref["valid"].sum(1)
    n_rays, n_hyps = int(rays.sum().item()), int(hyps.sum().item())
    n_roots = n_hyps // 4
    nops = (B * H * sum(FIVE_POINT_OPS.values()) + n_roots * FIVE_POINT_OPS_PER_VALID_ROOT
            + RAY_SCORE_OPS["central"] * int((hyps * rays).sum().item())
            + RAY_SCORE_OPS_PER_HYP["central"] * n_hyps)
    # read once: the masked-in rays, the mask, the sets' noise at the
    # masked-in rays (or idx); written once: every pose, its validity and
    # count, the best pose, index and count, the inlier mask
    P = 40 * H
    nbytes = (n_rays * 48 + B * N + (H * n_rays * 8 if kw.get("idx") is None else B * H * 40)
              + B * P * (56 + 1 + 4) + B * (56 + 8) + B * N)
    bnd, by = bound(nbytes, (nops, FP64_OPS_S))
    return {
        "kernel_ms": cuda_ms(kernel, reps), "busy_ms": busy_ms(kernel, reps),
        "plain_ms": cuda_ms(lambda: e.relative_pose_ransac_central_5pt_plain(*args, **kw), 1),
        "library_ms": None, "bound_ms": bnd, "bound_by": by, "ops_per_call": ops,
        "max_abs_err": 0.0, "valid_poses": n_hyps, "masked_in_rays": n_rays,
        "n_inliers": got["n_inliers"].tolist(),
    }


def trace_ops(fn):
    """The PyTorch operations one call of ``fn`` issues, views included
    (a TorchDispatchMode sees every ATen operation), and among them the
    host-to-device and device-to-host copies."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = h2d = d2h = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            Count.n += 1
            name = func.overloadpacket.__name__
            if name in ("_to_copy", "copy_"):
                src, dst = ((args[0], out) if name == "_to_copy" else (args[1], args[0]))
                kinds = (src.device.type, dst.device.type)
                Count.h2d += kinds == ("cpu", "cuda")
                Count.d2h += kinds == ("cuda", "cpu")
            return out

    with Count():
        fn()
    return Count.n, Count.h2d, Count.d2h


def count_ops(fn):
    """The PyTorch operations one call of ``fn`` issues, views included."""
    return trace_ops(fn)[0]


def k5_pairs(args, kwargs):
    """The (landmark, feature) pairs one `project_match_core` call matches:
    its landmarks that pass their own gates (the plain prologue) times its
    free features."""
    from covins_tpu_torch.ops import projmatch as pm

    cam, T_cw, p_w, _, normal, mask, rng_ = args[:7]
    passing = int(pm._prologue(cam, T_cw, p_w, normal, mask, rng_, args[13], args[14],
                               kwargs.get("check_view_angle", True))[1].sum().item())
    return passing, passing * int(args[10].sum().item())


def k5_gated_pairs(args, kwargs):
    """The (landmark, feature) pairs inside all of K5's gates (the
    landmark's own, free feature, pixel radius, octave): those whose
    descriptor distance the function needs."""
    import torch

    from covins_tpu_torch.ops import projmatch as pm

    cam, T_cw, p_w, _, normal, mask, rng_ = args[:7]
    uv, ok, pred, has_rng = pm._prologue(cam, T_cw, p_w, normal, mask, rng_, args[13],
                                         args[14], kwargs.get("check_view_angle", True))
    kp_uv, kp_oct = args[7], args[9]
    radius = args[11] * torch.pow(kwargs.get("scale_factor", 2.0), kp_oct)
    rows, cols = ok.nonzero().flatten(), args[10].nonzero().flatten()
    n = 0
    for r0 in range(0, len(rows), 2048):
        r = rows[r0:r0 + 2048]
        d = torch.sqrt(((uv[r, None] - kp_uv[None, cols]) ** 2).sum(-1))
        oct_ok = ((kp_oct[None, cols] - pred[r, None]).abs() <= 1.0) | ~has_rng[r, None]
        n += int(((d <= radius[None, cols]) & oct_ok).sum().item())
    return n


def k5_work(*args, **kwargs):
    """A K5 call's size for the recorder: its pairs, then L x F."""
    return k5_pairs(args, kwargs)[1], args[2].shape[0] * args[7].shape[0]


def k5_case(args, kwargs, reps):
    """K5 (project_match_core, one launch per call) against its plain
    version on the same inputs, exactly; its call and busy times, the
    operations one call issues, and its bound for this input."""
    import torch

    from covins_tpu_torch.ops import projmatch as pm
    from covins_tpu_torch.utils import cameras as cm

    def kernel():
        return pm.project_match_core(*args, **kwargs)

    before = pm.project_match_core.launches
    feat, dist = kernel()
    check(pm.project_match_core.launches == before + 1, "K5 did not launch once per call")
    again = kernel()
    rfeat, rdist = pm.project_match_plain(*args, **kwargs)
    torch.cuda.synchronize()
    L, F = args[2].shape[0], args[7].shape[0]
    check(torch.equal(feat, rfeat) and torch.equal(dist, rdist),
          f"K5 disagrees with its plain version at {L}x{F}")
    check(torch.equal(feat, again[0]) and torch.equal(dist, again[1]),
          "K5 differs between two launches")
    ops = count_ops(kernel)
    fused = args[0].cam_model == cm.PINHOLE and args[0].dist_model in (cm.DIST_NONE,
                                                                       cm.RADTAN)
    check(not fused or ops <= 16, f"a K5 call issues {ops} PyTorch operations")
    # this input's work: per landmark the prologue's float64 operations
    # (rotation and translation 33, the offset from the camera centre 3
    # and its norm 6, projection 6 and radtan distortion 28, the depth and
    # image gates 5, the distance gate 5, the predicted octave 8, the view
    # angle 13 where checked), then per passing landmark x free feature a
    # float64 gate (10 operations) and a 256-bit Hamming distance (a +-1
    # int8 dot product, 512 operations); inputs read once, outputs written
    # once
    passing, pairs = k5_pairs(args, kwargs)
    per_lm = 33 + 3 + 6 + 6 + 28 * (args[0].dist_model == cm.RADTAN) + 5 + 5 + 8 \
        + 13 * bool(kwargs.get("check_view_angle", True))
    if args[3].dtype == torch.uint8:
        bnd, by = bound(L * (24 + 24 + 1 + 16 + 32) + F * (16 + 8 + 1 + 32) + L * 8,
                        (pairs * 512.0, INT8_OPS_S), (pairs * 10.0 + L * per_lm, FP64_OPS_S))
    else:
        # the L2 metric: the gates of every passing x free pair, then 261
        # float64 operations a pair inside them (the cross term's 256, the
        # rounding, doubling, sum, clamp and square root), 256 a passing
        # landmark's and a feature's squares; 512 descriptor bytes each
        gated = k5_gated_pairs(args, kwargs)
        bnd, by = bound(L * (24 + 24 + 1 + 16 + 512) + F * (16 + 8 + 1 + 512) + L * 12,
                        (pairs * 10.0 + gated * 261.0 + (passing + F) * 256.0
                         + L * per_lm, FP64_OPS_S))
    return {
        "kernel_ms": cuda_ms(kernel, reps), "busy_ms": busy_ms(kernel, reps),
        "plain_ms": cuda_ms(lambda: pm.project_match_plain(*args, **kwargs), reps),
        "library_ms": None, "bound_ms": bnd, "bound_by": by,
        "ops_per_call": ops,
        "max_abs_err": int((feat - rfeat).abs().max().item()) if L else 0,
        "matches": int((feat >= 0).sum().item()), "passing_landmarks": passing,
    }


# K6's float64 operations, counted as its function needs them (the plain
# version's formulas; a transcendental function counted as one): per
# hypothesis the quartic's coefficients, Ferrari's and the resolvent
# cubic's roots and three Newton steps of four roots (P3P_QUARTIC_OPS); per
# root the camera-frame triangle, the centroids, the 3x3 correlation, the
# 4x4 N-matrix and eight Jacobi sweeps of six rotations, the quaternion's
# norm and the translation (P3P_ALIGN_OPS); per valid pose and valid
# correspondence the rotation, translation, norm, division, dot product and
# acos (P3P_SCORE_OPS); with noise, one comparison per hypothesis and
# valid correspondence for the minimal sets
P3P_QUARTIC_OPS = 70 + 120 + 60
P3P_ALIGN_OPS = 30 + 30 + 72 + 16 + 8 * 6 * (12 + 72) + 30
P3P_SCORE_OPS = 46


def k6_bytes_ops(args, kw, counts):
    """(bytes, float64 operations) of one K6 call on this input: the mask
    and the rows read whole, the points, bearings and noise only where a
    correspondence is valid (a masked one's noise is -inf, whatever it
    holds), each output written once, and the operations above for the
    poses this input's solves call valid."""
    bear, mask = args[1:3]
    idx, rows = kw.get("idx"), kw.get("rows")
    n = bear.shape[0]
    h = counts.shape[0] // 4
    valid_c = mask if rows is None else mask & (rows >= 0)
    n_valid = int(valid_c.sum().item())
    read = n + (0 if rows is None else n * 4) + n_valid * (24 + 24) \
        + (h * n_valid * 8 if idx is None else h * 24)
    write = 7 * 8 + n + 4 + 4 + 4 * h * 4
    ops = h * P3P_QUARTIC_OPS + 4 * h * P3P_ALIGN_OPS \
        + int((counts >= 0).sum().item()) * n_valid * P3P_SCORE_OPS \
        + (h * n_valid if idx is None else 0)
    return read + write, float(ops), n_valid


def _nan_equal(a, b):
    return bool(((a == b) | (a.isnan() & b.isnan())).all().item())


def k6_work(points_w, bearings, mask, **kw):
    """A K6 call's size for the recorder: its valid correspondences, then
    its correspondences."""
    rows = kw.get("rows")
    valid = mask if rows is None else mask & (rows >= 0)
    return int(valid.sum().item()), bearings.shape[0]


def k6_case(args, kw, reps):
    """K6 (absolute_pose_ransac, the whole RANSAC in one launch) against
    its plain version on the same inputs: counts, best pose and inlier
    mask exactly, every root's pose bit for bit (NaN where both are), or
    within 1e-12 relative, recorded; one launch and at most 10 PyTorch
    operations a call; call and busy times and the bound for this input."""
    import torch

    from covins_tpu_torch.ops import pnp

    def kernel():
        return pnp.absolute_pose_ransac(*args, **kw)

    before = pnp.absolute_pose_ransac.launches
    got = kernel()
    check(pnp.absolute_pose_ransac.launches == before + 1, "K6 did not launch once per call")
    again = kernel()
    ref = pnp.absolute_pose_ransac_plain(*args, **kw)
    torch.cuda.synchronize()
    shape = f"{got['counts'].shape[0]} poses x {args[1].shape[0]}"
    check(torch.equal(got["counts"], ref["counts"]), f"K6 counts disagree at {shape}")
    check(int(got["best"]) == int(ref["best"])
          and int(got["n_inliers"]) == int(ref["n_inliers"]), f"K6 best disagrees at {shape}")
    check(torch.equal(got["inliers"], ref["inliers"]), f"K6 inliers disagree at {shape}")
    for k in ("counts", "best", "n_inliers", "inliers", "T_c_w", "poses"):
        check(_nan_equal(got[k], again[k]), f"K6 {k} differs between two launches")
    # every root's pose: bit for bit, or else within 1e-12 relative where
    # the root is valid, and where not
    pose_bits = _nan_equal(got["poses"], ref["poses"]) and _nan_equal(got["T_c_w"],
                                                                       ref["T_c_w"])
    ok = ref["counts"] >= 0
    diff = (got["poses"][ok] - ref["poses"][ok]).abs()
    rel = float((diff.max() / ref["poses"][ok].abs().max().clamp(min=1e-300)).item()) \
        if bool(ok.any()) else 0.0
    if not pose_bits:
        rows = torch.nonzero(~((got["poses"] == ref["poses"])
                               | (got["poses"].isnan() & ref["poses"].isnan())).all(1))
        print(json.dumps({"k6_pose_bits_differ": shape, "roots": rows[:8, 0].tolist(),
                          "valid_max_rel_diff": rel}))
    check(pose_bits or rel <= 1e-12, f"K6 poses differ by {rel} relative at {shape}")
    ops = count_ops(kernel)
    check(ops <= 10, f"a K6 call issues {ops} PyTorch operations")
    nbytes, nops, n_valid = k6_bytes_ops(args, kw, ref["counts"])
    bnd, by = bound(nbytes, (nops, FP64_OPS_S))
    return {
        "kernel_ms": cuda_ms(kernel, reps), "busy_ms": busy_ms(kernel, reps),
        "plain_ms": cuda_ms(lambda: pnp.absolute_pose_ransac_plain(*args, **kw),
                            max(1, reps // 5)),
        "library_ms": None, "bound_ms": bnd, "bound_by": by, "ops_per_call": ops,
        "max_abs_err": float(diff.max().item()) if diff.numel() else 0.0,
        "pose_bit_equal": pose_bits,
        "pose_max_rel_diff": rel, "valid_correspondences": n_valid,
        "valid_poses": int((ref["counts"] >= 0).sum().item()),
        "hypotheses": ref["counts"].shape[0] // 4,
        "best": int(got["best"]), "n_inliers": int(got["n_inliers"]),
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


# K8's float64 operations, counted as its function needs them
# (geometry.cuh's formulas), not as the kernel spends them: per keyframe
# and state the inverse of T_w_s (conjugate, normalise, rotate the
# translation: 54) and, for the Jacobians, its rotation matrix (36); the
# same once for T_s_c; per observation two rotations with their
# translations (66), the division (2), pixel and residual (6), radtan
# distortion (28, or 58 with its Jacobian; none without distortion), the
# weight (3, or 14 with Huber's)
POSE_INV_OPS, ROT_MAT_OPS = 54, 36
OBS_OPS = 66 + 2 + 6


def gba_bytes_ops(p, graph, valid_obs, mode="linearize", S=1, huber=0.0):
    """(bytes, float64 operations) of one K8 call on this input: each input
    read once and each output written once; the operations above, with the
    cost's square and sum (6 per valid observation and state), the outlier
    norm's norm and scale (5 per observation: it covers every one), and the
    linearisation's Jacobians (134), keyframe terms (114) and landmark terms
    (48) per valid observation.  ``valid_obs`` counts the observations whose
    observation, landmark and keyframe masks are set."""
    from covins_tpu_torch.utils import cameras as cam_mod

    n, m, o = p.poses.shape[0], p.lms.shape[0], p.obs_kf.shape[0]
    radtan = p.cam.dist_model == cam_mod.RADTAN
    weight = 3 + (11 if huber > 0.0 else 0)
    obs = o * (2 * 8 + 8 + 2 * 4)  # pixels, weight, keyframe and landmark
    if mode == "cost":
        ops = POSE_INV_OPS * (n * S + 1) + S * valid_obs * (OBS_OPS + 28 * radtan + weight + 6)
        return obs + S * (n * 7 + m * 3) * 8 + (n + m) * 8 + S * 8, float(ops)
    if mode == "outlier":
        ops = POSE_INV_OPS * (n + 1) + o * (OBS_OPS + 28 * radtan + 5)
        return obs + (n * 7 + m * 3) * 8 + o * 9, float(ops)
    read = n * 7 * 8 + m * 3 * 8 + obs + o * 2 * 4 + (n + m) * 8 \
        + (n + m + graph.n_chunks + 3) * 4
    write = o * (2 + 12 + 6) * 8 + n * (6 + 36) * 8 + m * (3 + 9) * 8
    ops = (POSE_INV_OPS + ROT_MAT_OPS) * (n + 1) \
        + valid_obs * (OBS_OPS + 58 * radtan + weight + 2 + 134 + 114 + 48)
    return read + write, float(ops)


def k8_case(p, graph, huber, reps):
    """K8 against its plain version: the linearisation to 1e-13 relative,
    the cost of S = 1 and S = 7 stacked states (one launch each) per state
    to 1e-13 relative, the outlier decisions exactly, each bit for bit
    across two launches; call and busy times and launches of each, every
    call given the problem's inputs built once, as a GBA round gives them."""
    import torch

    from covins_tpu_torch.ops import gba
    from covins_tpu_torch.utils import synthetic

    inputs = gba.reproj_inputs(p)

    def counted(fn):
        before = gba.reproj_blocks.launches
        out = fn()
        return out, gba.reproj_blocks.launches - before

    def lin():
        return gba.reproj_blocks(p, graph, huber, "linearize", inputs)

    out, launches = counted(lin)
    again = lin()
    ref = gba.reproj_blocks_plain(p, graph, huber, "linearize", inputs)
    torch.cuda.synchronize()
    check(launches == 1, f"K8 linearisation took {launches} launches")
    err = 0.0
    for name, a, b, c in zip(("r", "J_pose", "J_lm", "b6", "M6", "b_lm", "Hll"),
                             out, again, ref):
        check(torch.equal(a, b), f"K8 {name} differs between two launches")
        err = max(err, _rel(a, c))
    valid_obs = int((p.obs_mask & p.lm_mask[p.obs_lm] & p.kf_mask[p.obs_kf]).sum().item())
    row = {}
    for S in (1, 7):
        st = synthetic.stacked_states(p, S)
        ps = gba._with_state(p, st)

        def cost():
            return gba.reproj_blocks(ps, graph, huber, "cost", inputs)

        got, launches = counted(cost)
        check(launches == 1 and got.shape == (S,), f"K8 cost of {S} states")
        check(torch.equal(got, cost()), f"K8 cost of {S} states differs between two launches")
        for k in range(S):
            one = gba._with_state(p, tuple(x[k:k + 1] for x in st))
            rel = _rel(got[k:k + 1], gba.reproj_blocks_plain(one, graph, huber, "cost",
                                                               inputs))
            check(rel <= 1e-13, f"K8 cost of state {k} of {S}: relative error {rel}")
            err = max(err, rel)
        row[f"cost_s{S}_ms"] = cuda_ms(cost, reps)
        row[f"cost_s{S}_busy_ms"] = busy_ms(cost, reps)
        row[f"cost_s{S}_launches"] = launches
        nb, no = gba_bytes_ops(p, graph, valid_obs, "cost", S, huber)
        row[f"cost_s{S}_bound_ms"] = bound(nb, (no, FP64_OPS_S))[0]
    val, valid = gba.reproj_blocks(p, graph, huber, "outlier", inputs)
    rval, rvalid = gba.reproj_blocks_plain(p, graph, huber, "outlier")
    check(torch.equal(valid, rvalid), "K8 outlier validity differs")
    err = max(err, _rel(val, rval))
    val, _ = gba.reproj_blocks(p, graph, 0.0, "outlier", inputs)
    rval, _ = gba.reproj_blocks_plain(p, graph, 0.0, "outlier")
    check(torch.equal(val < 0.92, rval < 0.92), "K8 outlier decisions differ")

    def outlier():
        return gba.reproj_blocks(p, graph, 0.0, "outlier", inputs)

    row["outlier_ms"] = cuda_ms(outlier, reps)
    row["outlier_busy_ms"] = busy_ms(outlier, reps)
    nb, no = gba_bytes_ops(p, graph, valid_obs, "outlier")
    row["outlier_bound_ms"] = bound(nb, (no, FP64_OPS_S))[0]
    check(err <= 1e-13, f"K8 relative error {err} against its plain version")
    nbytes, ops = gba_bytes_ops(p, graph, valid_obs, huber=huber)
    bnd, by = bound(nbytes, (ops, FP64_OPS_S))
    return {
        "kernel_ms": cuda_ms(lin, reps), "busy_ms": busy_ms(lin, reps), "launches_per_call": 1,
        "plain_ms": cuda_ms(
            lambda: gba.reproj_blocks_plain(p, graph, huber, "linearize", inputs),
            max(1, reps // 10)),
        **row, "library_ms": None, "bound_ms": bnd, "bound_by": by,
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
        "busy_ms": busy_ms(lambda: imu.preintegrate(*args, noise), reps),
        "plain_ms": (cuda_ms(lambda: imu.preintegrate_plain(*args, noise), 1)
                     if time_plain else None),
        "library_ms": None, "bound_ms": bnd, "bound_by": by,
        "max_abs_err": float((out.J_p_ba - ref.J_p_ba).abs().max().item()),
        "max_rel_err": err, "valid_samples": samples,
    }


def gba_kernel_inputs(n_kf, n_lm, max_obs, dev, seed=SEED, camera=None):
    """A synthetic GBA problem on the card (bench.py's at 256 / 8192 /
    61440) with the ragged cases of a real map added: a dead keyframe, dead
    landmarks, masked, invalid and gross-outlier observations, octave
    weights; ``camera``: one of `synthetic.SCENE_CAMERAS` in place of
    bench.py's.  Returns (problem, graph, K9's inputs, K10's inputs)."""
    import dataclasses as dc

    import torch

    from covins_tpu_torch.ops import gba, linalg
    from covins_tpu_torch.utils import synthetic

    p, _, _ = synthetic.build_gba_problem(n_kf=n_kf, n_lm=n_lm, seed=seed,
                                          max_obs=max_obs, device=dev, camera=camera)
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
    return p, graph, (v6, c, Jp, Jl, Hinv), k10_inputs(rng, n_kf - 1, 50, dev)


def k10_inputs(rng, F, S, dev):
    """K10's arguments for F factors of S samples (bench.py's GBA problem:
    255 x 50; `Map.to_gba_problem` pads to 256): random specific force
    around gravity and angular rate, each factor valid for a random prefix
    of its samples."""
    import torch

    acc = rng.normal(scale=0.5, size=(F, S, 3)) + [0.0, 0.0, 9.81]
    mask = (np.arange(S)[None, :] < rng.integers(1, S + 1, F)[:, None]).astype(np.float64)
    return [torch.as_tensor(x, device=dev)
            for x in (acc, 0.3 * rng.normal(size=(F, S, 3)), np.full((F, S), 0.005), mask,
                      0.01 * rng.normal(size=(F, 3)), 0.05 * rng.normal(size=(F, 3)))]


def _k4_inputs(rng, m, n, nq, nc, t):
    a = rng.integers(0, 256, (m, 32), dtype=np.uint8)
    b = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    k = min(nq, nc) // 2
    a[:k] = b[:k]  # true matches
    a[k:2 * k] = b[:k]  # a second row per column: ties to the lowest row
    a[: k // 2, 0] ^= 1  # ... at distance 1 for some
    return t(a), t(np.arange(m) < nq), t(b), t(np.arange(n) < nc)


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


def dbow_bytes(descs, mask, children, node_desc, L):
    """The distinct bytes a descent of ``descs`` needs (the bound of K16):
    the descriptors (and mask) read once, the ids and weights written once,
    and for each node some live descent visits its children's ids and
    each child's 32-byte row, once, and each end node's id and weight."""
    import torch

    from covins_tpu_torch.ops import dbow_import as dbi

    N, (n_nodes, k) = descs.shape[0], children.shape
    ids = torch.arange(n_nodes, dtype=torch.int32, device=descs.device)
    zeros = torch.zeros(n_nodes, dtype=torch.float32, device=descs.device)
    live = descs if mask is None else descs[mask]
    visited = [dbi.dbow_descend_plain(live, None, children, node_desc, zeros, ids, level)[0]
               for level in range(L + 1)]
    inner = torch.unique(torch.cat(visited[:L])) if L and len(live) else visited[0][:0]
    reads = inner.numel() * k * 4 + int((children[inner.long()] >= 0).sum()) * 32
    ends = torch.unique(visited[L]).numel() * 8
    return N * 32 + (0 if mask is None else N) + N * 8 + reads + ends


def k16_case(tree, L, descs, mask, reps, cpu=True):
    """K16 (`dbow_import.dbow_descend`) against its plain version on the
    card and (``cpu``) on the CPU, bit for bit, one launch a call and the
    same across two launches; timed beside its bound (the distinct bytes
    its descents touch, :func:`dbow_bytes`).  No single PyTorch call
    descends a tree: no library time."""
    import torch

    from covins_tpu_torch.ops import dbow_import as dbi

    N = descs.shape[0]

    def kernel():
        return dbi.dbow_descend(descs, mask, *tree, L)

    def bits(t):
        return t.view(torch.int32) if t.dtype == torch.float32 else t

    before = dbi.dbow_descend.launches
    out, again = kernel(), kernel()
    check(dbi.dbow_descend.launches == before + (2 if N else 0),
          "K16 did not launch once per call")
    plain = dbi.dbow_descend_plain(descs, mask, *tree, L)
    wants = [plain]
    if cpu:
        wants.append(dbi.dbow_descend_plain(descs.cpu(), None if mask is None else mask.cpu(),
                                            *(t.cpu() for t in tree), L))
    torch.cuda.synchronize()
    for g, a, *ws in zip(out, again, *wants):
        check(torch.equal(bits(g), bits(a)), "K16 differs between two launches")
        check(all(torch.equal(bits(g).cpu(), bits(w).cpu()) for w in ws),
              f"K16 differs from its plain version at {N} x {tree[0].shape}")
    n_nodes, k = tree[0].shape
    live = torch.ones(N, dtype=torch.bool, device=descs.device) if mask is None else mask
    # descents that end on an inner node (id -1, as the JAX package's)
    row = {"max_abs_err": 0.0, "shape": [N, n_nodes, k, L], "library_ms": None,
           "inner_ends": int(((out[0] < 0) & live).sum())}
    if N < 2:
        return row
    nbytes = dbow_bytes(descs, mask, tree[0], tree[1], L)
    bnd, by = bound(nbytes)
    return {**row, "kernel_ms": cuda_ms(kernel, reps), "busy_ms": busy_ms(kernel, reps),
            "plain_ms": cuda_ms(lambda: dbi.dbow_descend_plain(descs, mask, *tree, L),
                                max(1, reps // 10)),
            "bound_ms": bnd, "bound_by": by, "bytes": nbytes}


def phase1(dev):
    """Kernels against their plain versions on the card, with edge cases."""
    import torch

    from covins_tpu_torch.ops import bow, descriptors, gba, landmark_ops, pgo
    from covins_tpu_torch.utils import synthetic

    rng = np.random.default_rng(SEED)
    t = lambda x: torch.from_numpy(x).to(dev)  # noqa: E731
    # K1 at the window's word assignment (phase 2: 12 x 540 descriptors
    # against 512 words), the vocabulary training's sizes and ragged ones
    for m, n in ((6480, 512), (8192, 512), (65536, 1024), (37, 13), (1, 300), (50, 4100)):
        a = rng.integers(0, 256, (m, 32), dtype=np.uint8)
        b = rng.integers(0, 256, (n, 32), dtype=np.uint8)
        b[n - 1] = b[min(4, n - 1)]  # tied words, in the first and the last tile
        k = min(64, m // 2 + 1)
        a[:k] = b[min(4, n - 1)]
        mask = rng.random(m) > 0.1
        r = k1_case(t(a), t(b), t(mask), reps=20, want_dist=m * n <= 1 << 20)
        ia, _ = descriptors.hamming_argmin(t(a[:k]), t(b))
        check(bool((ia == min(4, n - 1)).all()), "K1 tie does not go to the lowest index")
        print(json.dumps({"phase": 1, "kernel": "hamming_argmin",
                          "shape": [m, n, 256], **r}))

    # K2: its descriptor part alone, then the whole refresh at the bench
    # drain's largest cohort (1010 x 16), the whole merged map's (run_gba)
    # and ragged sizes
    L, P = 8192, 16
    d = rng.integers(0, 256, (L, P, 32), dtype=np.uint8)
    d[:, 6] = d[:, 2]  # duplicate descriptors
    mask = rng.random((L, P)) > 0.5
    for i, nv in enumerate((0, 1, 2, 16)):
        mask[i] = False
        mask[i, :nv] = True
    r = k2_descriptors_case(t(d), t(mask), reps=20)
    print(json.dumps({"phase": 1, "kernel": "landmark_attributes", "part": "descriptors",
                      "shape": [L, P, 32], **r}))
    for L, P in ((1010, 16), (9549, 16), (1, 1), (37, 1), (65, 32), (4, 7)):
        packed = landmark_ops.pack_refresh(*synthetic.refresh_scene(rng, L, P)).to(dev)
        r = refresh_case(packed, L, P, reps=20)
        print(json.dumps({"phase": 1, "kernel": "landmark_attributes", "shape": [L, P], **r}))

    # K3 at phase 2's largest window scored against a full database, at a
    # 256-row window, and ragged: V not a multiple of 32, n = cap, one
    # window row, more window rows than one group in shared memory
    for W, F, V, cap, n in ((12, 540, 512, 1024, 1024), (256, 1024, 512, 1024, 1024),
                            (5, 100, 37, 16, 16), (1, 1, 5, 1, 1), (40, 64, 512, 128, 100)):
        words = rng.integers(-1, V, (W, F)).astype(np.int32)
        words[W // 2] = -1  # empty row
        dest = (rng.permutation(n)[:W] if n >= W else np.arange(W)).astype(np.int64)
        dest[W - 1] = cap if W > 1 else dest[0]  # dropped
        db = (rng.random((cap, V)) * (rng.random((cap, V)) > 0.5)).astype(np.float32)
        r = k3_case(t(words), t(dest), t(db), n, reps=20)
        print(json.dumps({"phase": 1, "kernel": "bow_insert_score",
                          "shape": [W, F, V, cap, n], **r}))

    # K4 at the verification's padded 1024 x 1024 and ragged sizes
    for m, n, nq, nc in ((1024, 1024, 420, 390), (1, 1, 1, 1), (5, 70, 5, 61),
                         (300, 129, 300, 129)):
        r = k4_case(*_k4_inputs(rng, m, n, nq, nc, t), 50.0, reps=20)
        print(json.dumps({"phase": 1, "kernel": "hamming_mutual_nn",
                          "shape": [m, n], **r}))
    # K5 at stage 3's 1024 x 1024 (no view-angle gate), stage 5's largest
    # neighbourhood (with it), ragged sizes, every landmark failing, the
    # unified camera (prologue given), more features than a block's shared
    # memory holds
    for L, F, kw in ((1024, 1024, {}), (10070, 1024, dict(view_angle=True)),
                     (1, 1, {}), (37, 70, dict(view_angle=True)), (3001, 257, {}),
                     (300, 100, dict(fail=True)), (1024, 1024, dict(camera="omni")),
                     (64, 4000, {})):
        args, kwargs = synthetic.project_match_scene(rng, L, F, dev, **kw)
        r = k5_case(args, kwargs, reps=10)
        print(json.dumps({"phase": 1, "kernel": "project_match", "shape": [L, F],
                          **{k: str(v) for k, v in kw.items()}, **r}))
    # K6, the whole RANSAC: 300 hypotheses (1200 roots) against the
    # verification's 1024 padded correspondences from Gumbel noise and from
    # given index sets, ragged sizes, two matches only, every root invalid,
    # and more correspondences than a block's shared memory holds
    for N, n_valid, H, sets, case in ((1024, 195, 300, "noise", None),
                                      (1024, 195, 300, "idx", None),
                                      (3, 3, 1, "noise", None), (100, 37, 37, "noise", None),
                                      (1024, 195, 300, "noise", "few"),
                                      (1024, 195, 300, "idx", "few"),
                                      (1024, 195, 300, "noise", "degenerate"),
                                      (6000, 700, 64, "noise", None)):
        args, kw = synthetic.p3p_scene(rng, N, n_valid, H, dev, sets=sets, case=case)
        r = k6_case(args, kw, reps=10)
        print(json.dumps({"phase": 1, "kernel": "p3p_ransac", "shape": [4 * H, N],
                          "sets": sets, "case": case, **r}))
    # K11 at the COVINS-G verification's 2048 x 3072 (query rig 2 x 1024
    # against candidate rig 3 x 1024), ragged, ties inside a segment, across
    # a 1024-column tile and across segments, every row masked, distances 0
    # and 256, few rows over many segments
    for M, seg, n_seg, case in ((2048, 1024, 3, None), (37, 13, 3, None), (1, 2, 1, None),
                                (100, 1500, 2, "ties"), (50, 40, 3, "all_masked"),
                                (33, 300, 2, "extremes"), (6, 512, 40, None)):
        a, am, b, bm = (t(x) for x in synthetic.ratio_match_scene(rng, M, seg, n_seg, case))
        r = k11_case(a, am, b, bm, seg, reps=20 if M > 1000 else 3)
        print(json.dumps({"phase": 1, "kernel": "hamming_ratio_match",
                          "shape": [M, seg * n_seg, seg], "case": case, **r}))
    # K13 at a SIFT window's word assignment (12 keyframes of 1024 features
    # against 512 words), at 65536 x 1024, and ragged: ties inside and
    # across tiles and parts, every row masked, zero and large vectors,
    # more near-equidistant words than a row's candidates, distances one
    # ulp apart
    for M, N, case in ((12 * 1024, 512, None), (65536, 1024, None), (37, 13, None),
                       (3000, 1024, "ties"), (65, 1024, "all_masked"),
                       (50, 700, "extremes"), (3000, 1024, "overflow"),
                       (500, 1024, "ulp")):
        a, am, b, _ = synthetic.l2_match_scene(rng, M, N, 1, case)
        r = k13_case(t(a), t(b), t(am), reps=20 if M * N > 1e6 else 3)
        print(json.dumps({"phase": 1, "kernel": "l2_argmin", "shape": [M, N, 128],
                          "case": case, **r}))
    # K14 at the COVINS-G verification's 2048 x 3072 in segments of 1024,
    # with ties (ratio 1.5 lets a tie at the best pass and show its column),
    # masked rows, masked columns, a segment with one valid column, zero and
    # large vectors, few rows over many segments, near-equidistant columns
    # past a row's candidates, distances one ulp apart, a masked row tile
    # and segments of 0, 1 and 2 valid columns
    for M, seg, n_seg, case, ratio in ((2048, 1024, 3, None, 0.8),
                                       (100, 1500, 2, "ties", 1.5),
                                       (50, 40, 3, "all_masked", 0.8),
                                       (33, 300, 2, "one_valid", 0.8),
                                       (20, 100, 2, "extremes", 0.8), (6, 512, 40, None, 0.8),
                                       (100, 1500, 2, "overflow", 1.5),
                                       (64, 1030, 3, "ulp", 1.5),
                                       (300, 600, 4, "mask_patterns", 0.8)):
        a, am, b, bm = (t(x) for x in synthetic.l2_match_scene(rng, M, seg, n_seg, case))
        r = k14_case(a, am, b, bm, seg, reps=20 if M > 1000 else 3, ratio=ratio)
        print(json.dumps({"phase": 1, "kernel": "l2_ratio_match",
                          "shape": [M, seg * n_seg, seg], "case": case, "ratio": ratio, **r}))
    # K5's L2 metric at stage 3's 1024 x 1024 and stage 5's 10,070 x 1,024
    # (with the view-angle gate), every landmark failing, the unified camera
    for L, F, kw in ((1024, 1024, {}), (10070, 1024, dict(view_angle=True)),
                     (300, 100, dict(fail=True)), (1024, 1024, dict(camera="omni"))):
        args, kwargs = synthetic.project_match_scene(rng, L, F, dev, sift=True, **kw)
        r = k5_case(args, kwargs, reps=10)
        print(json.dumps({"phase": 1, "kernel": "project_match", "metric": "l2",
                          "shape": [L, F], **{k: str(v) for k, v in kw.items()}, **r}))
        if L == 10070:
            sift_k5 = {**r, "shape": [L, F]}
    # K12 at the COVINS-G path's four shapes (six central RANSACs of 2000
    # poses over 1024 rays with hypothesis validity, the 17-point RANSAC's
    # 512 over 6144, its refine's 1, the covariance's 60, counts only) and
    # ragged ones, with NaN poses and batch entries padded to other counts
    for B, H, N, kw in ((6, 2000, 1024, dict(central=True, with_valid=True)),
                        (1, 512, 6144, {}), (1, 1, 6144, dict(nan_every=0)),
                        (1, 60, 6144, dict(counts_only=True)),
                        (3, 7, 37, dict(with_valid=True)), (1, 1, 1, dict(nan_every=0))):
        kw = dict(kw)
        counts_only = kw.pop("counts_only", False)
        T, va, fa, vb, fb, mask, valid = (None if x is None else t(x) for x in
                                          synthetic.ray_score_scene(rng, B, H, N, **kw))
        r = k12_case((T, va, fa, vb, fb, mask, 0.004),
                     dict(valid=valid, want_inliers=not counts_only),
                     reps=20 if B * H * N > 1e5 else 3)
        print(json.dumps({"phase": 1, "kernel": "ray_ransac_score", "shape": [B, H, N],
                          "central": va is None, "counts_only": counts_only, **r}))
    # K12's central 5-point RANSAC whole at the COVINS-G drain's six pairs
    # of 50 samples over 1024 rays, from noise and from given sets, ragged,
    # and degenerate (3 rays masked in, none, 4 distinct rays repeated)
    for B, H, N, sets, case in ((6, 50, 1024, "noise", None), (6, 50, 1024, "idx", None),
                                (3, 7, 37, "noise", None), (3, 50, 1024, "noise", "degenerate")):
        fa, fb, mask, noise, idx = (None if x is None else t(x) for x in
                                    synthetic.central_5pt_scene(rng, B, H, N, sets, case))
        r = k12_5pt_case((fa, fb, mask, H, 0.004), dict(noise=noise, idx=idx),
                         reps=20 if B * H > 100 else 5)
        print(json.dumps({"phase": 1, "kernel": "relpose_ransac_5pt", "shape": [B, H, N],
                          "sets": sets, "case": case, **r}))
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
    # K10 at the shape `Map.to_gba_problem` gives it (every factor padded to
    # 256 samples, phase 6) and with a sample count not a multiple of 32
    for F, S in ((255, 256), (5, 33)):
        r = k10_case(k10_inputs(rng, F, S, dev), reps=5 if F > 5 else 2, time_plain=False)
        print(json.dumps({"phase": 1, "kernel": "imu_preintegrate", "shape": [F, S], **r}))
    # K8 for the cameras whose projection PyTorch hands it (the unified
    # model; equidistant distortion), at bench.py's problem and ragged
    for camera in ("omni", "equidistant"):
        for n_kf, n_lm, max_obs in ((256, 8192, 61440), (7, 60, None)):
            p, graph, _, _ = gba_kernel_inputs(n_kf, n_lm, max_obs, dev, camera=camera)
            r = k8_case(p, graph, 2.447, reps=5 if n_kf == 256 else 2)
            print(json.dumps({"phase": 1, "kernel": "gba_reproj_blocks", "camera": camera,
                              "huber": 2.447,
                              "shape": [n_kf, p.lms.shape[0], p.obs_kf.shape[0]], **r}))
    # K16 at ORBvoc.txt's shape (k = 10, L = 6: 1,111,111 nodes, built from
    # a seed) with a bench window's descriptors (12 KF x 540) and 65,536 (its
    # plain version held on the card only: the CPU's takes tens of seconds),
    # each also with masked rows; a ragged tree (1-3 children in random
    # slots, leaves at depths 1-2, inner nodes without children), tied
    # children, k = 2 and 16, N = 0 and 1, and nodes wider than one round of
    # 16 slots (k 17 and 32, ties across rounds, a ragged tree in slots of 40)
    card = card_line()
    rng16 = np.random.default_rng(SEED + 16)
    orb = synthetic.dbow_tree(rng16, 10, 6)
    for kind, k, L, N in (("complete", 10, 6, 6480), ("complete", 10, 6, 65536),
                          ("ragged", 10, 8, 3001), ("ties", 10, 3, 2000),
                          ("complete", 2, 8, 1000), ("complete", 16, 3, 5000),
                          ("complete", 10, 3, 0), ("complete", 10, 3, 1),
                          ("complete", 17, 3, 3000), ("complete", 32, 3, 4000),
                          ("ties", 32, 2, 2000), ("ragged", 40, 4, 1500)):
        voc = orb if (k, L) == (10, 6) else synthetic.dbow_tree(rng16, k, L, kind)
        descs = t(synthetic.dbow_descriptors(rng16, voc, N))
        for mask in (None, t(rng16.random(N) < 0.9)):
            r = k16_case(voc.tree_on(dev), L, descs, mask, reps=20 if N > 10000 else 50,
                         cpu=N < 10000)
            print(json.dumps({"phase": 1, "kernel": "dbow_descend", "card": card,
                              "tree": kind, "masked": mask is not None, **r}))
            if kind == "ragged":
                check(r["inner_ends"] > 0, "no ragged descent ended on an inner node")
    del orb
    return table, sift_k5


# -------------------------------------------------------------------- main path
def make_windows(streams, size=WINDOW):
    """Interleave the agent streams into windows of ``size`` messages, the
    way the server worker drains them (per-client order preserved)."""
    windows = []
    cursors = [0] * len(streams)
    while any(c < len(s) for c, s in zip(cursors, streams)):
        window = {}
        budget = size
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


def build_streams(n_agents, n_kf, n_landmarks, max_features=None, feat_type="ORB"):
    from covins_tpu_torch.agents.synthetic_agent import SyntheticAgent, SyntheticWorld

    world = SyntheticWorld.create(n_landmarks=n_landmarks, seed=SEED, feat_type=feat_type,
                                  desc_bytes=128 if feat_type == "SIFT" else 32)
    streams = [list(SyntheticAgent(world, cid, n_keyframes=n_kf, t0=5.0 * cid,
                                   pose_drift=0.02,
                                   max_features=max_features).messages())
               for cid in range(n_agents)]
    return world, streams


def run_slice(vocab, windows, n_agents, device, placerec=True, **cfg_kw):
    """Fresh manager + sessions; ingest every window, then flush (which
    drains the deferred place recognition).  ``cfg_kw`` go to the
    `Config`.  Returns a dict with the manager, the sessions, the queued
    retrieval data and the ingest and flush wall times (device
    synchronised at both ends of each)."""
    import torch

    from covins_tpu_torch.models.map_manager import MapManager
    from covins_tpu_torch.models.session import AgentSession
    from covins_tpu_torch.utils.config import Config

    cfg = Config(placerec_defer=True, **cfg_kw) if placerec else \
        Config(placerec_active=False, placerec_defer=True, **cfg_kw)
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


def run_cpu(vocab, windows, n_agents, placerec=True, **cfg_kw):
    """:func:`run_slice` on the CPU with CPU_THREADS torch threads."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(CPU_THREADS)
    try:
        return run_slice(vocab, windows, n_agents, "cpu", placerec, **cfg_kw)
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


def pose_diff(a, b):
    """The largest difference of two runs' keyframe poses and landmark
    positions, over every map."""
    worst = 0.0
    for mid, am in a["mgr"].maps.items():
        bm = b["mgr"].maps[mid]
        for name in ("kf_pose", "lm_pos"):
            worst = max(worst, float(np.abs(getattr(am, name) - getattr(bm, name)).max()))
    return worst


class MovedPoseGraphs:
    """Inside the block every `pgo.optimize_pose_graph` call solves its
    graph with each measured edge moved by one ulp (``sign`` 1 up, -1
    down): a rounding difference at the input of the pose-graph solves."""

    def __init__(self, sign):
        self.sign = sign

    def __enter__(self):
        import torch

        from covins_tpu_torch.ops import pgo

        self._pgo, self._fn = pgo, pgo.optimize_pose_graph
        fn, to = self._fn, float("inf") * self.sign

        def moved(g, *args, **kw):
            T = torch.nextafter(g.edge_T, torch.full_like(g.edge_T, to))
            return fn(dataclasses.replace(g, edge_T=T), *args, **kw)

        pgo.optimize_pose_graph = moved
        return self

    def __exit__(self, *exc):
        self._pgo.optimize_pose_graph = self._fn


def compare_full(gpu, cpu, spread=None):
    """The card's and the CPU's runs of the full path: the same loops,
    merges, accepted pairs and maps, and every keyframe pose and landmark
    position within POSE_TOL.  Where they differ by more and ``spread`` is
    given, ``spread()`` reads how far the CPU's own run moves under one
    ulp at the input of its pose-graph solves, and the poses are held
    within GBA_FACTOR times that reading, as the solves' PCG is held
    everywhere else.  Returns (outcome, loop transform difference, pose
    difference, {pose_bound, cpu_one_ulp_pose_spread (None unless read)})."""
    go, co = outcome(gpu), outcome(cpu)
    for k in ("loops", "merges", "fused", "pgo_solves", "candidates", "accepted"):
        check(go[k] == co[k], f"card and CPU differ in {k}: {go[k]} vs {co[k]}")
    g_mgr, c_mgr = gpu["mgr"], cpu["mgr"]
    check(sorted(g_mgr.maps) == sorted(c_mgr.maps), "map ids differ")
    worst_loop = 0.0
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
    worst = pose_diff(gpu, cpu)
    check(worst_loop <= LOOP_TOL, f"loop transforms differ by {worst_loop}")
    bound = {"pose_bound": POSE_TOL, "cpu_one_ulp_pose_spread": None}
    if worst > POSE_TOL and spread is not None:
        reading = spread()
        bound = {"pose_bound": max(POSE_TOL, GBA_FACTOR * reading),
                 "cpu_one_ulp_pose_spread": reading}
    check(worst <= bound["pose_bound"], f"poses differ by {worst} ({bound})")
    return go, worst_loop, worst, bound


def compare_ingest(gpu, cpu):
    """Every map SoA array and the database of the card's ingest-only run
    against the CPU run: integers and descriptors exactly, float64 to
    1e-9, float32 database rows and scores exactly (K3 and its plain
    version sum in one written order)."""
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
    return n_arrays, compare_database(gpu, cpu)


def compare_database(gpu, cpu):
    """The card's retrieval database against the CPU's: rows, the matrix
    and every queued score and common-word count exactly.  Returns the
    queued keyframes compared."""
    gdb, cdb = gpu["mgr"].database, cpu["mgr"].database
    check(gdb.row_ids == cdb.row_ids and np.array_equal(gdb._mask, cdb._mask),
          "database rows differ")
    check(np.array_equal(gdb.db.cpu().numpy(), cdb.db.numpy()), "database matrix differs")
    n_scores = 0
    for gq, cq in zip(gpu["queued"], cpu["queued"]):
        for (gk, gp), (ck, cp) in zip(gq, cq):
            check(gk == ck, "queued keyframes differ")
            if gp is None:
                continue
            # the drain fetched the queued scores to the host
            check(np.array_equal(gp["common"], cp["common"]),
                  "common-word counts differ")
            check(np.array_equal(gp["scores"], cp["scores"]), "scores differ")
            n_scores += 1
    return n_scores


def refresh_size(packed, L, P, *args, **kwargs):
    return L


def refresh_map_counts(mgr):
    """The PyTorch operations of one landmark-attribute refresh as a map
    issues it (the gather into one buffer, its upload, K2: at most 5) and
    of its write-back (one copy: at most 2), counted on the card's map of
    agent 0 with a cohort of all its live landmarks, and the refresh's
    wall time with the write-back (host clock, the write-back's copy waits
    for the card)."""
    import torch

    mp = mgr.maps[mgr.map_of_client[0]]
    mp.commit_landmark_attributes()
    rows = np.where(mp.lm_mask[: mp.n_lm])[0]
    ops = count_ops(lambda: mp.update_landmark_attributes(rows, lazy=True))
    commit_ops = count_ops(mp.commit_landmark_attributes)
    check(ops <= 5 and commit_ops <= 2, f"a map refresh issued {ops} PyTorch operations "
                                        f"and its write-back {commit_ops}")
    mp.update_landmark_attributes(rows)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        mp.update_landmark_attributes(rows)
    return {"map_refresh_rows": len(rows), "map_refresh_ops": ops,
            "map_commit_ops": commit_ops,
            "map_refresh_wall_ms": (time.perf_counter() - t0) * 100.0}


class Recorder:
    """Keeps a copy of the largest input (by work) that the path gives each
    kernel wrapper.  While active, the module-level name through which the
    port calls each wrapper points at a shim that records the arguments and
    forwards to the wrapper, which runs unchanged.  Only the CPU pass of
    the main path is recorded: it gives each kernel the inputs the card's
    pass gives it, and the timed passes run without the shims."""

    def __init__(self, targets):
        # (module, wrapper name, size of the work[, the call's kind]): the
        # largest input is kept per wrapper, or per wrapper and kind; a
        # size is a number or a tuple (ties broken by its later entries)
        self.targets = targets
        self.largest = {}
        self.calls = {}  # per key: [calls, calls whose work (first entry) > 0]

    def _shim(self, fn, name, size, kind=None):
        def recording(*args, **kwargs):
            s = size(*args, **kwargs)
            key = name if kind is None else f"{name} {kind(kwargs)}"
            n = self.calls.setdefault(key, [0, 0])
            n[0] += 1
            n[1] += (s[0] if isinstance(s, tuple) else s) > 0
            if key not in self.largest or s > self.largest[key][0]:
                self.largest[key] = (s, [x.clone() if hasattr(x, "clone") else x
                                         for x in args], dict(kwargs))
            return fn(*args, **kwargs)
        # a wrapper counts its launches on its module-level name, which is
        # this shim while recording; they go to the wrapper at the end
        recording.launches = 0
        return recording

    def __enter__(self):
        self._saved = []
        for mod, name, *how in self.targets:
            fn = getattr(mod, name)
            self._saved.append((mod, name, fn))
            setattr(mod, name, self._shim(fn, name, *how))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            fn.launches += getattr(mod, name).launches
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

    def kwargs(self, name):
        return self.largest[name][2]


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
    from covins_tpu_torch.ops import (bow, covisibility, dbow_import, descriptors, epipolar,
                                      gba, imu, landmark_ops, pgo, pnp, projmatch)

    return {"hamming_argmin": descriptors.hamming_argmin,
            "landmark_attributes": landmark_ops.landmark_attributes,
            "bow_insert_score": bow.bow_insert_score,
            "hamming_mutual_nn": descriptors.hamming_mutual_nn,
            "project_match": projmatch.project_match_core,
            "p3p_ransac": pnp.absolute_pose_ransac,
            "hamming_ratio_match": descriptors.hamming_ratio_match,
            "hamming_knn2": descriptors.hamming_knn2,
            "l2_argmin": descriptors.l2_argmin,
            "l2_ratio_match": descriptors.l2_ratio_match,
            "ray_ransac_score": epipolar.ray_ransac_score,
            "relpose_ransac_5pt": epipolar.relpose_ransac_5pt,
            "pgo_matvec": pgo.matvec,
            "pgo_pcg": pgo.pcg,
            "gba_reproj_blocks": gba.reproj_blocks,
            "gba_reduced_matvec": gba.reduced_matvec,
            "gba_pcg": gba.pcg,
            "imu_preintegrate": imu.preintegrate,
            "redundancy_values": covisibility.redundancy_values,
            "dbow_descend": dbow_import.dbow_descend}


# the kernels of the ingest and place-recognition drain (phase 2) and of GBA;
# the pose-graph solves launch pgo_pcg once per Gauss-Newton step and the
# standalone K7 matvec never, a GBA step gba_pcg once, K9 seven times and K8
# twice, and the pruning between the rounds K8 once more
DRAIN_KERNELS = ("hamming_argmin", "landmark_attributes", "bow_insert_score",
                 "hamming_mutual_nn", "project_match", "p3p_ransac", "pgo_pcg")
GBA_KERNELS = ("gba_reproj_blocks", "gba_reduced_matvec", "gba_pcg", "imu_preintegrate")
K9_PER_STEP = 7  # b_red and the six ladder scales
K8_PER_STEP = 2  # the linearisation, and the costs of the six ladder states and the current one


def check_gba_launches(launches, n_steps, pruned, what):
    """Each GBA kernel's launches for ``n_steps`` Gauss-Newton steps and,
    when ``pruned``, one outlier pass."""
    want = {"gba_pcg": n_steps, "gba_reduced_matvec": K9_PER_STEP * n_steps,
            "gba_reproj_blocks": K8_PER_STEP * n_steps + int(pruned)}
    got = {k: launches[k] for k in want}
    check(got == want, f"{what}'s {n_steps} steps launched {got}, expected {want}")


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

    from covins_tpu_torch.ops import bow, descriptors, landmark_ops, loopverify, pgo, pnp

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
        (landmark_ops, "landmark_attributes", refresh_size),
        (bow, "bow_insert_score", lambda w, d, db, n: (w.numel(), n)),
        (descriptors, "hamming_mutual_nn",
         lambda a, am, b, bm, md: a.shape[0] * b.shape[0]),
        # stage 3 matches without the view-angle gate, stage 5 with it; the
        # work is the matching the call holds, then its size
        (loopverify, "project_match_core", k5_work,
         lambda kw: f"stage {5 if kw['check_view_angle'] else 3}"),
        # stage 2: the call with the most valid correspondences
        (pnp, "absolute_pose_ransac", k6_work),
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
    _, worst_loop, worst, _ = compare_full(gpu, cpu)
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
    packed, L, P = rec.on("landmark_attributes", dev)
    table["landmark_attributes"] = {**refresh_case(packed, L, P, reps=50), "shape": [L, P],
                                    **refresh_map_counts(gpu["mgr"])}
    w, dst, db, n = rec.on("bow_insert_score", dev)
    table["bow_insert_score"] = {**k3_case(w, dst, db, n, reps=50),
                                 "shape": list(w.shape) + [db.shape[1], db.shape[0], n],
                                 **window_counts(vocab, *w.shape, dev)}
    a, am, b, bm, md = rec.on("hamming_mutual_nn", dev)
    table["hamming_mutual_nn"] = {**k4_case(a, am, b, bm, md, reps=50),
                                  "shape": [a.shape[0], b.shape[0]]}
    # each stage's call with the most matching work (passing landmarks x
    # free features, then L x F); the table takes the one with more pairs
    for stage in (3, 5):
        key = f"project_match_core stage {stage}"
        args = rec.on(key, dev)
        calls, with_pairs = rec.calls[key]
        row = {**k5_case(args, rec.kwargs(key), reps=20), "pairs": rec.largest[key][0][0],
               "shape": [args[2].shape[0], args[7].shape[0]], "stage": stage,
               "stage_calls": calls, "stage_calls_with_pairs": with_pairs}
        print(json.dumps({"phase": 2, "kernel": "project_match", **row}))
        if row["pairs"] >= table.get("project_match", {"pairs": 0})["pairs"]:
            table["project_match"] = row
    args = rec.on("absolute_pose_ransac", dev)
    kw = {k: v.to(dev) if hasattr(v, "to") else v
          for k, v in rec.kwargs("absolute_pose_ransac").items()}
    calls, _ = rec.calls["absolute_pose_ransac"]
    r = k6_case(args, kw, reps=50)
    table["p3p_ransac"] = {**r, "stage_calls": calls,
                           "shape": [4 * r["hypotheses"], args[1].shape[0]]}
    print(json.dumps({"phase": 2, "kernel": "p3p_ransac", **table["p3p_ransac"]}))
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

    from covins_tpu_torch.ops import bow, landmark_ops

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
    with Recorder([(landmark_ops, "landmark_attributes", refresh_size)]) as rec:
        run = run_slice(vocab, windows, n_agents, "cuda")
    launches = {name: k.launches for name, k in wrappers.items()}
    n_total = check_invariants(run, n_agents * n_kf, "five agents")
    # the refresh at the deployment's largest cohort
    packed, L, P = rec.on("landmark_attributes", dev)
    print(json.dumps({"phase": 3, "kernel": "landmark_attributes", "shape": [L, P],
                      **refresh_case(packed, L, P, reps=20)}))
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
    return streams, vocab


# the server phase's culling gap: the agents' keyframes are 0.5 s apart, so
# the default kf_culling_max_time_dist of 1 s (a pred-succ gap must stay
# below it) blocks every keyframe; 2 s lets prunemap erase every other one
SERVER_CULL_GAP = 2.0
SERVER_WAIT_S = 600.0  # a deadline for each wait on the server


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def wait_for(cond, what, deadline_s=SERVER_WAIT_S, period=0.05):
    t_end = time.perf_counter() + deadline_s
    while time.perf_counter() < t_end:
        out = cond()
        if out:
            return out
        time.sleep(period)
    raise RuntimeError(f"timed out after {deadline_s} s waiting for {what}")


def check_server(srv, what):
    """The server's worker caught no exception: a kernel that fails inside
    it fails the run."""
    caught = "; ".join(f"{w}: {tb.strip().splitlines()[-1]}" for w, tb in srv.errors)
    check(not srv.errors, f"{what}: the server's worker caught {caught}")


def k15_case(kf, lm, mask, n_kf, n_lm, reps):
    """K15 (`covisibility.redundancy_values`) against its plain version, on
    the card and on the CPU, bit for bit; one launch a call, bit for bit
    across two launches; beside one `index_add_` of the observations'
    scores into the keyframes (the library yardstick)."""
    import torch

    from covins_tpu_torch.ops import covisibility as cov

    def kernel():
        return cov.redundancy_values(kf, lm, mask, n_kf, n_lm)

    before = cov.redundancy_values.launches
    out = kernel()
    check(cov.redundancy_values.launches == before + 1, "K15 did not launch once per call")
    again = kernel()
    plain = cov.redundancy_values_plain(kf, lm, mask, n_kf, n_lm)
    cpu = cov.redundancy_values_plain(kf.cpu(), lm.cpu(), mask.cpu(), n_kf, n_lm)
    torch.cuda.synchronize()
    bits = out.view(torch.int32)
    check(torch.equal(bits, again.view(torch.int32)), "K15 differs between two launches")
    check(torch.equal(bits, plain.view(torch.int32))
          and torch.equal(bits.cpu(), cpu.view(torch.int32)),
          f"K15 differs from its plain version at {n_kf} x {kf.numel()}")
    scores = torch.rand(kf.numel(), device=kf.device)
    kf_long = kf.long()
    acc = torch.zeros(n_kf, device=kf.device)
    O = kf.numel()
    # each observation's keyframe, landmark and mask read once, the values
    # written once; a count, a table read, a product and two sums an
    # observation, a division a keyframe
    bnd, by = bound(12 * O + 4 * n_kf, (4.0 * O + n_kf, FP32_OPS_S))
    return {"kernel_ms": cuda_ms(kernel, reps), "busy_ms": busy_ms(kernel, reps),
            "plain_ms": cuda_ms(lambda: cov.redundancy_values_plain(kf, lm, mask, n_kf, n_lm),
                                max(1, reps // 10)),
            "library_ms": cuda_ms(lambda: acc.index_add_(0, kf_long, scores), reps),
            "library_busy_ms": busy_ms(lambda: acc.index_add_(0, kf_long, scores), reps),
            "bound_ms": bnd, "bound_by": by, "max_abs_err": 0.0,
            "shape": [n_kf, n_lm, O]}


def stream_agents(port, streams):
    """The agents' streams over TCP, one client each, concurrently: the
    clients connect in order (so client i gets id i, the id its messages
    carry), then stream in threads and finish.  Returns per agent the
    frames' bytes, and the times of the first send and the last."""
    import threading

    from covins_tpu_torch.comm import wire
    from covins_tpu_torch.comm.client import AgentClient

    clients = []
    for cid in range(len(streams)):
        c = AgentClient("127.0.0.1", port, timeout=SERVER_WAIT_S)
        check(c.client_id == cid, f"agent {cid} got client id {c.client_id}")
        clients.append(c)
    sent = {}

    def run(cid):
        n_bytes, t0 = 0, time.perf_counter()
        for m in streams[cid]:
            blob = wire.encode_message(m)
            clients[cid].sock.sendall(blob)
            n_bytes += len(blob)
        sent[cid] = (n_bytes, t0, time.perf_counter())
        clients[cid].finish()

    threads = [threading.Thread(target=run, args=(cid,)) for cid in range(len(streams))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(SERVER_WAIT_S)
        check(not t.is_alive(), "an agent did not finish sending")
    check(len(sent) == len(streams), "an agent's stream failed")
    return sent


def phase_server(dev, card, streams, vocab):
    """The agent-facing product on the card: phase 3's five agents over TCP
    into a `CovinsServer`, its admin verbs on the merged map, `loadmap`
    with place-recognition replay card against CPU, and the CLI."""
    import shutil
    import tempfile

    import torch

    from covins_tpu_torch.comm.client import AgentClient
    from covins_tpu_torch.comm.server import CovinsServer
    from covins_tpu_torch.models.map_manager import MapManager
    from covins_tpu_torch.models.map_store import Map
    from covins_tpu_torch.ops import covisibility
    from covins_tpu_torch.utils.config import Config

    t_phase = time.perf_counter()
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_server_")
    n_agents = len(streams)
    n_kf = sum(type(m).__name__ == "MsgKeyframe" for m in streams[0])
    wrappers = kernel_wrappers()

    # (a) the deployment through the product
    cfg = Config(placerec_defer=True, kf_culling_max_time_dist=SERVER_CULL_GAP)
    port = free_port()
    srv = CovinsServer(vocab, cfg, host="127.0.0.1", port=port,
                       output_dir=os.path.join(out_dir, "a"), device=dev)
    t0 = time.perf_counter()
    srv.start_background()
    t_start = time.perf_counter() - t0
    check(srv._server is not None, "the server did not start")
    admin = None
    try:
        for k in wrappers.values():
            k.launches = 0
        sent = stream_agents(port, streams)
        t_first = min(t for _, t, _ in sent.values())
        t_last_sent = max(t for _, _, t in sent.values())
        wait_for(lambda: sum(s.stats["keyframes"] for s in list(srv.sessions.values()))
                 == n_agents * n_kf, "every keyframe ingested", period=0.01)
        t_ingested = time.perf_counter()
        wait_for(lambda: len(srv.finished) == n_agents, "every agent's finish")
        t_finished = max(srv.finished.values())
        launches = {name: k.launches for name, k in wrappers.items()}
        check_server(srv, "phase server (a)")
        admin = AgentClient("127.0.0.1", port, timeout=SERVER_WAIT_S)
        stats = admin.admin("stats")["result"]
        n_total = sum(m["n_kf"] for m in stats["maps"].values())
        check(n_total == n_agents * n_kf, f"stats shows {n_total} keyframes")
        for cid in range(n_agents):
            with open(os.path.join(out_dir, "a", f"KF_{cid}_ftum.csv")) as fh:
                lines = len(fh.read().strip().splitlines())
            check(lines == n_kf, f"agent {cid}'s trajectory has {lines} lines")
        check(stats["n_loops"] >= 1 and stats["n_merges"] >= 1,
              f"the deployment closed {stats['n_loops']} loops, {stats['n_merges']} merges")
        for name in DRAIN_KERNELS:
            check(launches[name] > 0, f"the server never launched {name}")
        for name in ("hamming_ratio_match", "ray_ransac_score", "relpose_ransac_5pt",
                     "l2_argmin", "l2_ratio_match"):
            check(launches[name] == 0, f"the server launched {name} {launches[name]} times")
        print(json.dumps({
            "phase": "server", "part": "a", "card": card, "n_agents": n_agents,
            "n_keyframes": n_total, "wire_bytes_sent": sum(b for b, _, _ in sent.values()),
            "server_start_s": t_start, "ingest_kf_per_s": n_total / (t_ingested - t_first),
            "send_s": t_last_sent - t_first,
            "last_send_to_last_finish_s": t_finished - t_last_sent,
            "loops": stats["n_loops"], "merges": stats["n_merges"],
            "maps": len(stats["maps"]), "launches": launches}))

        # (b) the admin verbs over the socket, on the merged map
        mid = min(int(m) for m in stats["maps"])
        live = stats["maps"][str(mid)]["n_kf"]
        verbs = [("stats", {}), ("pgo", {}), ("gba", {}),
                 ("gba", {"visual_only": True, "time_budget_s": 30.0}),
                 ("prunemap", {"max_num_kfs": live - 8}),
                 ("snapshot", {"path": os.path.join(out_dir, "snapshot.json")}),
                 ("savemap", {"path": os.path.join(out_dir, "merged.npz")})]
        for k in wrappers.values():
            k.launches = 0
        replies, walls = [], []
        with Recorder([(covisibility, "redundancy_values", lambda kf, *a, **kw: kf.numel())]) \
                as rec:
            for verb, kw in verbs:
                t0 = time.perf_counter()
                reply = admin.admin(verb, **kw)
                walls.append(time.perf_counter() - t0)
                check(reply.get("result", {}).get("ok"), f"admin {verb} {kw} answered {reply}")
                replies.append(reply["result"])
        launches_b = {name: k.launches for name, k in wrappers.items()}
        check_server(srv, "phase server (b)")
        for name in GBA_KERNELS + ("redundancy_values",):
            check(launches_b[name] > 0, f"the admin verbs never launched {name}")
        removed = replies[4]["removed"]
        after = admin.admin("stats")["result"]["maps"][str(mid)]["n_kf"]
        check(removed >= 1 and after == live - removed,
              f"prunemap removed {removed} keyframes, live {live} -> {after}")
        print(json.dumps({
            "phase": "server", "part": "b", "card": card, "map_id": mid,
            "verbs": [{"verb": v, **kw, "wall_s": w,
                       **{k: r[k] for k in ("n_pruned", "time_budget_hit", "final_cost",
                                            "removed") if k in r}}
                      for (v, kw), w, r in zip(verbs, walls, replies)],
            "live_keyframes": [live, after], "launches": launches_b}))
        kf, lm, mask = rec.on("redundancy_values", dev)
        sizes = rec.kwargs("redundancy_values")
        k15 = k15_case(kf, lm, mask, sizes["n_kf"], sizes["n_lm"], reps=50)
        k15["launches"] = launches_b["redundancy_values"]
        print(json.dumps({"phase": "server", "kernel": "redundancy_values", **k15}))
    finally:
        if admin is not None:
            admin.finish()
        srv.stop()

    # (c) loadmap with placerec replay, card against CPU: agents 0 and 1
    # (trajectories overlapping from 5 s to 16 s), built with place
    # recognition off and saved with savemap
    t_c = time.perf_counter()
    off = CovinsServer(vocab, Config(placerec_active=False), host="127.0.0.1",
                       port=free_port(), output_dir=os.path.join(out_dir, "c"), device=dev)
    off.start_background()
    paths = [os.path.join(out_dir, f"single{cid}.npz") for cid in (0, 1)]
    try:
        stream_agents(off.port, streams[:2])
        wait_for(lambda: len(off.finished) == 2, "both single-agent maps")
        admin = AgentClient("127.0.0.1", off.port, timeout=SERVER_WAIT_S)
        for mid, path in enumerate(paths):
            check(admin.admin("savemap", map_id=mid, path=path)["result"]["ok"],
                  f"savemap of map {mid}")
        admin.finish()
    finally:
        off.stop()
    check_server(off, "phase server (c) build")
    rcfg = Config(placerec_defer=True)
    fresh = CovinsServer(vocab, rcfg, host="127.0.0.1", port=free_port(),
                         output_dir=os.path.join(out_dir, "c2"), device=dev)
    fresh.start_background()
    try:
        admin = AgentClient("127.0.0.1", fresh.port, timeout=SERVER_WAIT_S)
        first = admin.admin("loadmap", path=paths[0])["result"]
        t0 = time.perf_counter()
        second = admin.admin("loadmap", path=paths[1], placerec_replay=True,
                             run_pgo=True)["result"]
        card_s = time.perf_counter() - t0
        admin.finish()
    finally:
        fresh.stop()
    check_server(fresh, "phase server (c) replay")
    check(first["ok"] and second["ok"], f"loadmap answered {first}, {second}")
    check(second["replay"]["merges"] >= 1, f"the replay did not merge: {second['replay']}")
    threads = torch.get_num_threads()
    torch.set_num_threads(CPU_THREADS)
    try:
        cpu = MapManager(vocab, Config(placerec_defer=True), device="cpu")
        for path in paths:
            cpu.register_map(Map.load(path, device="cpu"))
        t0 = time.perf_counter()
        cpu_replay = cpu.replay_placerec(cpu.maps[1], perform_pgo=True)
        cpu_s = time.perf_counter() - t0
    finally:
        torch.set_num_threads(threads)
    check(cpu_replay == second["replay"],
          f"card and CPU replays differ: {second['replay']} vs {cpu_replay}")
    g_mgr, c_mgr = fresh.manager, cpu
    check(sorted(g_mgr.maps) == sorted(c_mgr.maps), "the replays left different maps")
    worst_loop = worst = 0.0
    pairs = []
    for mid, gm in g_mgr.maps.items():
        cm = c_mgr.maps[mid]
        got = [[list(map(int, gm.kf_ids[lc[k]])) for k in ("kf1", "kf2")] for lc in gm.loops]
        check(got == [[list(map(int, cm.kf_ids[lc[k]])) for k in ("kf1", "kf2")]
                      for lc in cm.loops], f"map {mid}'s accepted pairs differ")
        pairs += got
        for gl, cl in zip(gm.loops, cm.loops):
            worst_loop = max(worst_loop, float(np.abs(gl["T_12"] - cl["T_12"]).max()))
        for name in ("kf_pose", "lm_pos"):
            worst = max(worst, float(np.abs(getattr(gm, name) - getattr(cm, name)).max()))
    check(worst_loop <= LOOP_TOL, f"replayed loop transforms differ by {worst_loop}")
    check(worst <= POSE_TOL, f"replayed poses differ by {worst}")
    print(json.dumps({
        "phase": "server", "part": "c", "card": card, "replay": second["replay"],
        "accepted_pairs": pairs, "card_replay_s": card_s, "cpu_replay_s": cpu_s,
        "loop_tol": LOOP_TOL, "max_loop_T_diff": worst_loop, "pose_tol": POSE_TOL,
        "max_pose_diff": worst, "elapsed_s": time.perf_counter() - t_c}))

    # (d) the entry point itself
    t_d = time.perf_counter()
    vocab_path = os.path.join(out_dir, "vocab.npz")
    np.savez(vocab_path, vocab=vocab)
    port = free_port()
    cli = [sys.executable, "-m", "covins_tpu_torch"]
    root = os.path.dirname(os.path.abspath(__file__))
    server = subprocess.Popen(
        cli + ["server", "--device", dev.type, "--vocab", vocab_path, "--port", str(port),
               "--output-dir", os.path.join(out_dir, "d")],
        cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        def listening():
            import socket

            check(server.poll() is None, "the CLI server exited")
            try:
                socket.create_connection(("127.0.0.1", port), timeout=1).close()
                return True
            except OSError:
                return False
        wait_for(listening, "the CLI server", deadline_s=300.0, period=0.5)
        t_listening = time.perf_counter() - t_d
        agent = subprocess.run(cli + ["agent", "--keyframes", "8", "--port", str(port)],
                               cwd=root, capture_output=True, text=True, timeout=300)
        check(agent.returncode == 0, f"the CLI agent failed: {agent.stderr}")
        t_agent = time.perf_counter() - t_d

        def eight():
            out = subprocess.run(cli + ["admin", "stats", "--port", str(port)],
                                 cwd=root, capture_output=True, text=True, timeout=300)
            check(out.returncode == 0, f"the CLI admin failed: {out.stderr}")
            maps = json.loads(out.stdout)["result"]["maps"]
            return sum(m["n_kf"] for m in maps.values()) == 8
        # each admin call is a process of its own (a few seconds to start)
        wait_for(eight, "8 keyframes through the CLI", deadline_s=300.0, period=1.0)
    finally:
        server.terminate()
        try:
            log, _ = server.communicate(timeout=60)
        except subprocess.TimeoutExpired:
            server.kill()
            log, _ = server.communicate()
    startup = next((line for line in log.splitlines() if "listening" in line), "")
    check(torch.cuda.get_device_name(0) in startup,
          f"the CLI server's startup line does not name the card: {log[-2000:]!r}")
    print(json.dumps({"phase": "server", "part": "d", "startup_line": startup,
                      "keyframes": 8, "listening_s": t_listening, "agent_done_s": t_agent,
                      "elapsed_s": time.perf_counter() - t_d}))
    print(json.dumps({"phase": "server", "elapsed_s": time.perf_counter() - t_phase}))
    shutil.rmtree(out_dir, ignore_errors=True)
    return {"redundancy_values": k15}


# phase "frontend": phase 2's trajectories cut to 2 agents x FRONTEND_KF
# keyframes (widths unchanged), sent as the front-end adapter sends them (no
# landmarks), in windows of FRONTEND_WINDOW keyframes for the card-against-CPU
# replay (64 keyframes fill less than one of the server's 1024-message
# windows); the CLI's `frontend` sends the first FRONTEND_CLI_KF frames of
# agent 1's stream as a third agent
FRONTEND_KF = 32
FRONTEND_WINDOW = 8
FRONTEND_CLI_KF = 8


def cfs_frames(stream):
    """An agent's keyframes as CFS frame records: odometry pose, velocity,
    keypoints (the synthetic agent's, undistorted: the stream's
    calibration says so), descriptors, angles and the IMU window since the
    previous keyframe."""
    frames = []
    for m in stream:
        if type(m).__name__ != "MsgKeyframe":
            continue
        pre = m.preintegration
        imu = {} if pre is None else {"acc": pre.acc, "gyro": pre.gyro, "imu_dts": pre.dts}
        frames.append({"timestamp": m.timestamp, "T_w_s": m.T_w_s_vio,
                       "keypoints": m.keypoints_undist, "descriptors": m.descriptors,
                       "keypoints_aors": m.keypoints_aors, "velocity": m.velocity, **imu})
    return frames


def write_cfs(path, calib, frames):
    from covins_tpu_torch.io import stream as cfs

    with cfs.StreamWriter(path) as w:
        w.write_calibration(calib)
        for f in frames:
            w.write_frame(**f)


def tree_vocabulary(centres, rng):
    """A DBoW2 tree of k = 10, L = 3 whose 1000 leaves are ``centres``, in
    order, grouped ten under a parent; each inner node's descriptor is its
    children's bitwise majority, each leaf's weight drawn from ``rng``."""
    from covins_tpu_torch.utils import synthetic

    voc = synthetic.dbow_tree(rng, 10, 3)
    voc.node_desc[voc.leaf_word_id >= 0] = centres
    for lvl in (2, 1):
        rows = np.where(voc.depth == lvl)[0]
        bits = np.unpackbits(voc.node_desc[voc.children[rows]], axis=-1).sum(1)
        voc.node_desc[rows] = np.packbits(2 * bits > voc.k, axis=-1)
    return voc


def phase_frontend(dev, card):
    """The front-end attachment on the card: each agent's keyframes as a
    CFS stream, a DBoW2 text vocabulary loaded through the CLI's `.txt`
    path, a `CovinsServer` on the card in COVINS-G fed by two `run_stream`
    clients over TCP (the launch counters set to 0 just before and read
    after the last finish), then the CLI's `frontend` in a subprocess;
    every keyframe arrived, no worker error, every client finished.  Then
    the adapter's keyframes through `AgentSession` on the card and on the
    CPU, compared, and `HierVocabulary.assign` (K16) on the card against
    the CPU on the phase's descriptors."""
    import argparse
    import shutil
    import tempfile
    import threading

    import torch

    from covins_tpu_torch import cli
    from covins_tpu_torch.agents.frontend_adapter import FrontendWrapper, run_stream
    from covins_tpu_torch.comm.server import CovinsServer
    from covins_tpu_torch.ops import bow, dbow_import
    from covins_tpu_torch.utils.config import Config

    t_phase = time.perf_counter()
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_frontend_")
    world, streams = build_streams(2, FRONTEND_KF, 2000)
    calib = dataclasses.replace(world.calib, dist_model=0, dist=np.zeros(4))
    frames = [cfs_frames(st) for st in streams]
    paths = [os.path.join(out_dir, f"agent{cid}.cfs") for cid in range(2)]
    for path, fr in zip(paths, frames):
        write_cfs(path, calib, fr)
    cli_path = os.path.join(out_dir, "cli.cfs")
    write_cfs(cli_path, calib, frames[1][:FRONTEND_CLI_KF])
    n_kf = sum(len(fr) for fr in frames)

    # the vocabulary: 1000 centres trained on the card on the keyframes'
    # descriptors, as a DBoW2 text tree, through the CLI's loader
    descs = [np.concatenate([f["descriptors"] for f in fr]) for fr in frames]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    centres = bow.train_vocabulary(torch.from_numpy(np.concatenate(descs)).to(dev), k=1000,
                                   iters=4, generator=gen).cpu().numpy()
    voc = tree_vocabulary(centres, np.random.default_rng(SEED))
    voc_path = os.path.join(out_dir, "voc.txt")
    dbow_import.save_orb_vocabulary_text(voc, voc_path)
    vocab = cli._load_or_make_vocab(argparse.Namespace(vocab=voc_path, vocab_words=512), dev)
    check(np.array_equal(vocab, centres), "the CLI's flattened vocabulary is not the leaves")

    # the server on the card, two run_stream clients, then the CLI
    wrappers = kernel_wrappers()
    cfg = Config(placerec_type="COVINS_G", placerec_defer=True)
    port = free_port()
    srv = CovinsServer(vocab, cfg, host="127.0.0.1", port=port,
                       output_dir=os.path.join(out_dir, "server"), device=dev)
    srv.start_background()
    sent, errors = {}, []
    try:
        for k in wrappers.values():
            k.launches = 0
        t0 = time.perf_counter()
        with HostLog() as s_log:

            def client(cid):
                try:
                    sent[cid] = run_stream(paths[cid], "127.0.0.1", port)
                except Exception as e:  # reported below
                    errors.append(f"client {cid}: {e!r}")
            threads = [threading.Thread(target=client, args=(cid,)) for cid in range(2)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(SERVER_WAIT_S)
            check(not errors and sorted(sent.items()) == [(0, len(frames[0])), (1, len(frames[1]))],
                  f"the clients sent {sent}: {errors}")
            t_sent = time.perf_counter()
            wait_for(lambda: sum(x.stats["keyframes"] for x in list(srv.sessions.values())) == n_kf,
                     "every keyframe ingested", period=0.01)
            t_ingested = time.perf_counter()
            wait_for(lambda: len(srv.finished) == 2, "both clients' finish")
            t_finished = time.perf_counter()
            launches = {name: k.launches for name, k in wrappers.items()}
        check_server(srv, "phase frontend (server)")
        # phase 7's kernels, as phase_g checks them: K1 and K3 once a
        # window, K11 and the 5-point RANSAC once and the scoring three
        # times a verification, pgo_pcg once a loop or merge has fired;
        # nothing of COVINS, of SIFT or K16
        n_windows = s_log.calls.get("add_and_query_batch", 0)
        n_ver = sum(x.placerec.n_dispatched for x in srv.sessions.values())
        n_loops, n_merges = srv.manager.n_loops, srv.manager.n_merges
        check(n_windows > 0 and n_ver > 0 and n_loops > 0,
              f"the front-end path ran {n_windows} windows, {n_ver} verifications, "
              f"{n_loops} loops")
        for name in G_ORB.per_window:
            check(launches[name] == n_windows,
                  f"{n_windows} windows launched {name} {launches[name]} times, once each expected")
        for name in G_ORB.per_verification:
            check(launches[name] == n_ver,
                  f"{n_ver} verifications launched {name} {launches[name]} times, "
                  "once each expected")
        check(launches["ray_ransac_score"] == 3 * n_ver,
              f"{n_ver} verifications launched the scoring {launches['ray_ransac_score']} times, "
              "three each expected")
        check(srv.manager.n_pgo > 0 and launches["pgo_pcg"] > 0,
              f"{n_loops} loops ran {srv.manager.n_pgo} pose-graph solves, "
              f"{launches['pgo_pcg']} launches of pgo_pcg")
        for name in G_ORB.absent + ("dbow_descend",):
            check(launches[name] == 0, f"the front-end path launched {name} {launches[name]} times")
        # the entry point itself: `frontend` in a subprocess, a third agent
        t_cli = time.perf_counter()
        run = subprocess.run([sys.executable, "-m", "covins_tpu_torch", "frontend", "--stream",
                              cli_path, "--port", str(port)],
                             cwd=os.path.dirname(os.path.abspath(__file__)),
                             capture_output=True, text=True, timeout=300)
        check(run.returncode == 0 and f"sent {FRONTEND_CLI_KF} keyframes" in run.stdout,
              f"the CLI's frontend failed: {run.stdout[-2000:]} {run.stderr[-2000:]}")
        wait_for(lambda: len(srv.finished) == 3, "the CLI client's finish")
        t_cli = time.perf_counter() - t_cli
        got = sum(x.stats["keyframes"] for x in list(srv.sessions.values()))
        check(got == n_kf + FRONTEND_CLI_KF, f"{got} keyframes arrived")
        check_server(srv, "phase frontend (CLI)")
    finally:
        srv.stop()
    print(json.dumps({
        "phase": "frontend", "card": card, "agents": 2, "keyframes": n_kf,
        "windows": n_windows, "candidates": n_ver, "pgo_solves": srv.manager.n_pgo,
        "vocabulary": {"k": voc.k, "L": voc.L, "words": voc.n_words, "flat": len(vocab)},
        "loops": n_loops, "merges": n_merges, "wall_s": t_finished - t0,
        "send_s": t_sent - t0, "ingest_kf_per_s": n_kf / (t_ingested - t0),
        "launches": launches, "cli_keyframes": FRONTEND_CLI_KF, "cli_s": t_cli,
        "loops_with_cli": srv.manager.n_loops, "merges_with_cli": srv.manager.n_merges}))

    # the adapter's keyframes in process, card against CPU
    kfs = [list(FrontendWrapper(None, client_id=cid).replay(path))
           for cid, path in enumerate(paths)]
    check([len(k) for k in kfs] == [len(fr) for fr in frames], "the adapter dropped a frame")
    head = make_windows(kfs, FRONTEND_WINDOW)[:WARM_WINDOWS]
    with HostLog() as g_log:
        g_run = run_slice(vocab, head, 2, "cuda", placerec_type="COVINS_G")
    with HostLog() as c_log:
        c_run = run_cpu(vocab, head, 2, placerec_type="COVINS_G")
    n_scores = compare_database(g_run, c_run)
    g_out, worst_loop, worst, worst_cov, _ = compare_g(g_run, c_run, g_log, c_log)
    check(g_out["candidates"] > 0 and len(g_log.results) > 0,
          "the front-end phase's compared windows verified no candidate")
    print(json.dumps({
        "phase": "frontend", "card_vs_cpu": "agree", "windows": len(head),
        "window_keyframes": FRONTEND_WINDOW, "queued_scores_equal": n_scores,
        "candidates": g_out["candidates"], "verifications_fetched": len(g_log.results),
        "loops": g_out["loops"], "merges": g_out["merges"], "loop_tol": LOOP_TOL,
        "max_loop_T_diff": worst_loop, "cov_tol": COV_TOL, "max_cov_rel_diff": worst_cov,
        "pose_tol": POSE_TOL, "max_pose_diff": worst, "card_drain_wall_s": g_run["flush_s"],
        "cpu_drain_wall_s": c_run["flush_s"]}))

    # K16: the exact DBoW2 words of the phase's descriptors, card against CPU
    for k in wrappers.values():
        k.launches = 0
    words = [voc.assign(d, device=dev) for d in descs]
    assign_launches = wrappers["dbow_descend"].launches
    check(assign_launches == len(descs),
          f"{len(descs)} assignments launched K16 {assign_launches} times")
    for (w, wt), d in zip(words, descs):
        cw, cwt = voc.assign(d, device="cpu")
        check(w.device == dev and torch.equal(w.cpu(), cw)
              and torch.equal(wt.cpu().view(torch.int32), cwt.view(torch.int32)),
              "HierVocabulary.assign differs between the card and the CPU")
    row = k16_case(voc.tree_on(dev), voc.L, torch.from_numpy(descs[0]).to(dev), None, reps=50)
    # no entry point calls `assign` (the CLI flattens the tree): the row
    # carries the server path's launches of K16, 0, as K5's L2 metric's
    # carries the SIFT path's; the direct calls' launches stand beside it
    row["launches"] = launches["dbow_descend"]
    row["assign_launches"] = assign_launches
    print(json.dumps({"phase": "frontend", "kernel": "dbow_descend", "card": card, **row}))
    print(json.dumps({"phase": "frontend", "elapsed_s": time.perf_counter() - t_phase}))
    shutil.rmtree(out_dir, ignore_errors=True)
    return {"dbow_descend": row}


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
    for name in ("hamming_argmin", "landmark_attributes", "bow_insert_score"):
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
    through `global_bundle_adjustment(n_gn=PHASE5_GN, n_cg=60)` on the card
    (round 1 of 5 Huber steps, pruning, round 2 of PHASE5_GN), then the same
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
    p_card, info = gba.global_bundle_adjustment(p, n_gn=PHASE5_GN, n_cg=60)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: wrappers[name].launches for name in GBA_KERNELS}
    for name, n in launches.items():
        check(n > 0, f"GBA never launched {name}")
    costs1 = info["round1_costs"].cpu().numpy()
    costs = info["costs"].cpu().numpy()
    check_gba_launches(launches, len(costs1) + len(costs), True, "GBA")
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
    inputs = gba.reproj_inputs(p)  # built once, as a GBA round builds them
    state = (p.poses, p.vels, p.biases, p.lms)
    lam = torch.tensor(1e-4, dtype=torch.float64, device=dev)
    kernel_pcg = gba.pcg
    step_ms = {"kernel": [], "eager": []}
    try:
        for eager in (False, True, True, False):
            gba.pcg = gba.pcg_plain if eager else kernel_pcg
            step_ms["eager" if eager else "kernel"].append(
                cuda_ms(lambda: gba._gn_schur_step(p, graph, state, lam, 60, False,
                                                   inputs=inputs), 3))
        gba.pcg = gba.pcg_plain
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p_eager, _ = gba.global_bundle_adjustment(p, n_gn=PHASE5_GN, n_cg=60)
        torch.cuda.synchronize()
        wall_eager = time.perf_counter() - t0
    finally:
        gba.pcg = kernel_pcg
    eager_diff = _max_diff(_states(p_card), _states(p_eager))

    # a cost evaluation with the residual-only IMU and loop factors, against
    # one that takes their residuals from the linearising functions; and the
    # step ladder's seven costs (six scales and the current state) stacked
    # in one evaluation, against seven single ones
    def cost_from_r_J():
        reproj = gba.reproj_blocks(gba._with_state(p, tuple(x[None] for x in state)),
                                   graph, 0.0, "cost", inputs)[0]
        r_l, r_f = gba._loop_r_J(p)[0], gba._imu_r_J(p)[0]
        return reproj + torch.sum(r_l * r_l) + torch.sum(r_f * r_f)

    cost = gba.total_cost(p, graph, state, False, inputs=inputs)
    check(_rel(cost_from_r_J(), cost) <= 1e-12, "the two cost evaluations disagree")
    cost_ms = cuda_ms(lambda: gba.total_cost(p, graph, state, False, inputs=inputs), 5)
    cost_r_J_ms = cuda_ms(cost_from_r_J, 5)
    ladder = synthetic.stacked_states(p, 7)
    singles = [tuple(x[k] for x in ladder) for k in range(7)]
    ladder_costs = gba.total_cost(p, graph, ladder, False, inputs=inputs)
    check(_rel(ladder_costs, torch.stack([gba.total_cost(p, graph, st, False, inputs=inputs)
                                          for st in singles])) <= 1e-13,
          "the stacked and the single cost evaluations disagree")
    ladder_ms = {"stacked": [], "single": []}
    for stacked in (True, False, False, True):
        ladder_ms["stacked" if stacked else "single"].append(cuda_ms(
            (lambda: gba.total_cost(p, graph, ladder, False, inputs=inputs)) if stacked else
            (lambda: [gba.total_cost(p, graph, st, False, inputs=inputs) for st in singles]),
            5))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        gba.global_bundle_adjustment(p, n_gn=PHASE5_GN, n_cg=60)
        torch.cuda.synchronize()
        wall_traced = (time.perf_counter() - t0) * 1e3
    busy, top = _device_busy_ms(prof)

    # the CPU: the same problem, then moved by one ulp
    threads = torch.get_num_threads()
    torch.set_num_threads(CPU_THREADS)
    try:
        pc = gba.problem_to(p, "cpu")
        t0 = time.perf_counter()
        p_cpu, info_cpu = gba.global_bundle_adjustment(pc, n_gn=PHASE5_GN, n_cg=60)
        cpu_wall = time.perf_counter() - t0
        spread = 0.0
        for name in ("lms", "poses"):
            x = getattr(pc, name)
            moved = dataclasses.replace(pc, **{name: torch.nextafter(
                x, torch.full_like(x, float("inf")))})
            p_ulp, _ = gba.global_bundle_adjustment(moved, n_gn=PHASE5_GN, n_cg=60)
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
        "imu_factors": p.imu_i.shape[0], "n_gn": PHASE5_GN, "n_gn_round1": 5, "n_cg": 60,
        "build_s": t_build, "wall_s": wall, "wall_eager_pcg_s": wall_eager,
        "gn_step_ms": step_ms["kernel"], "gn_step_eager_pcg_ms": step_ms["eager"],
        "kernel_vs_eager_pcg_state_diff": eager_diff,
        "cost_eval_ms": cost_ms, "cost_eval_via_r_J_ms": cost_r_J_ms,
        "ladder_costs_stacked_ms": ladder_ms["stacked"],
        "ladder_costs_single_ms": ladder_ms["single"],
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
    check_gba_launches(launches, n_steps, "round1_costs" in info, "run_gba")
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


# ------------------------------------------------------------------ COVINS-G
# How far the card's loop covariances may differ from the CPU's, relative
# to their largest entry: as far as one ulp of the rays' directions moves
# the CPU's own 5-point covariance (9.9e-5) on the two-rig scene of
# scripts/port_covg_cov_probe.py.  The solvers are device-exact up to
# svd3x3, whose transcendental functions round apart on the card, and a
# near-singular 17-ray re-solve amplifies that: the probe read the card
# 1.7e-5 from the CPU there (NVIDIA H100 80GB HBM3, 700 W)
COV_TOL = 1e-4


class HostLog:
    """While active, records every COVINS-G verification's fetched result
    and the host time of the named calls (the Gumbel draw, the upload, the
    whole dispatch, a window's insert-and-score)."""

    def __init__(self):
        from covins_tpu_torch.models.kf_database import KeyframeDatabase
        from covins_tpu_torch.models.placerec import PlaceRecognition
        from covins_tpu_torch.ops import loopverify

        self.targets = [(loopverify, "fetch_covinsg_verify"), (loopverify, "upload"),
                        (loopverify, "dispatch_covinsg_verify"),
                        (PlaceRecognition, "next_covins_g_noise"),
                        (KeyframeDatabase, "add_and_query_batch")]
        self.results, self.seconds, self.calls = [], {}, {}
        self.first_dispatch = None

    def __enter__(self):
        self._saved = []
        for obj, name in self.targets:
            fn = getattr(obj, name)
            self._saved.append((obj, name, fn))

            def timed(*a, _fn=fn, _name=name, **kw):
                t0 = time.perf_counter()
                out = _fn(*a, **kw)
                self.seconds[_name] = self.seconds.get(_name, 0.0) + time.perf_counter() - t0
                self.calls[_name] = self.calls.get(_name, 0) + 1
                if _name == "fetch_covinsg_verify":
                    self.results.append(out)
                if _name == "dispatch_covinsg_verify" and self.first_dispatch is None:
                    self.first_dispatch = (a, kw)
                return out
            setattr(obj, name, timed)
        return self

    def __exit__(self, *exc):
        for obj, name, fn in self._saved:
            setattr(obj, name, fn)

    def per_call_ms(self):
        return {k: 1e3 * v / self.calls[k] for k, v in self.seconds.items()}


def compare_g(gpu, cpu, g_log, c_log, spread=None):
    """The card's and the CPU's COVINS-G runs: :func:`compare_full` (loops,
    merges, candidates, accepted pairs, loop transforms to LOOP_TOL, poses
    to POSE_TOL or the CPU's ``spread``), every verification's gates, pair
    matches and central inliers, pool and 17-point inliers exactly, and the
    accepted loops' covariances to COV_TOL."""
    out, worst_loop, worst, bound = compare_full(gpu, cpu, spread)
    check(len(g_log.results) == len(c_log.results),
          f"card and CPU fetched {len(g_log.results)} and {len(c_log.results)} verifications")
    for i, (g, c) in enumerate(zip(g_log.results, c_log.results)):
        for k in ("ok", "pairs_ok", "n_pool", "n_inliers"):
            check(g[k] == c[k], f"verification {i}: card and CPU differ in {k}: {g[k]} vs {c[k]}")
        for k in ("pair_n_match", "pair_n_inl"):
            check(np.array_equal(g[k], c[k]), f"verification {i}: {k} {g[k]} vs {c[k]}")
    worst_cov = 0.0
    for mid, gm in gpu["mgr"].maps.items():
        for gl, cl in zip(gm.loops, cpu["mgr"].maps[mid].loops):
            check((gl["cov"] is None) == (cl["cov"] is None), "a loop lost its covariance")
            if gl["cov"] is not None:
                worst_cov = max(worst_cov, float(np.abs(gl["cov"] - cl["cov"]).max()
                                                 / np.abs(cl["cov"]).max()))
    check(worst_cov <= COV_TOL, f"loop covariances differ by {worst_cov} relative")
    return out, worst_loop, worst, worst_cov, bound


@dataclasses.dataclass(frozen=True)
class GMode:
    """One COVINS-G cell of the smoke: its ``Config`` settings, the kernels
    its drain launches once a window (word assignment, then K3) and once a
    verification (descriptor matching, then the 5-point RANSAC; the scoring
    three times), the other kernels it must launch and those it must never
    launch, its maps' descriptor type, and the kernels replayed on the
    largest inputs the CPU pass gave them."""
    phase: object
    config: dict
    per_window: tuple
    per_verification: tuple
    present: tuple
    absent: tuple
    desc_dtype: type
    replay: tuple


# COVINS-G over ORB (phase 7): K1-K3 at ingest and retrieval, K11 and K12
# in every verification; nothing of COVINS (K4-K6) or of SIFT
G_ORB = GMode(7, {"placerec_type": "COVINS_G"},
              ("hamming_argmin", "bow_insert_score"),
              ("hamming_ratio_match", "relpose_ransac_5pt"), ("landmark_attributes",),
              ("hamming_mutual_nn", "project_match", "p3p_ransac", "l2_argmin",
               "l2_ratio_match"),
              np.uint8, ("hamming_ratio_match", "ray_ransac_score", "relpose_ransac_5pt"))
# COVINS-G over SIFT (phase "sift"): K13 and K3, then K14 and K12; SIFT maps
# skip the landmark refresh, so no K2, and nothing of binary descriptors;
# img_match_thres is the reference's SIFT setting (tests/test_sift_mode.py:
# 40), all else default
G_SIFT = GMode("sift", {"placerec_type": "COVINS_G", "feat_type": "SIFT",
                        "desc_length": 128, "img_match_thres": 500.0},
               ("l2_argmin", "bow_insert_score"),
               ("l2_ratio_match", "relpose_ransac_5pt"), (),
               ("hamming_argmin", "landmark_attributes", "hamming_mutual_nn",
                "project_match", "p3p_ransac", "hamming_ratio_match"),
               np.float32, ("l2_argmin", "l2_ratio_match"))


def g_recorder(names):
    """A :class:`Recorder` of the COVINS-G kernels ``names``."""
    from covins_tpu_torch.ops import descriptors, epipolar

    def pairs(a, am, b, bm, *rest):
        return a.shape[0] * b.shape[0]

    targets = {
        "l2_argmin": (descriptors, "l2_argmin", lambda a, b, m=None: a.shape[0] * b.shape[0]),
        "hamming_ratio_match": (descriptors, "hamming_ratio_match", pairs),
        "l2_ratio_match": (descriptors, "l2_ratio_match", pairs),
        "ray_ransac_score": (
            epipolar, "ray_ransac_score", k12_work,
            lambda kw: "central" if kw.get("valid") is not None
            else ("counts" if not kw.get("want_inliers", True) else "non-central")),
        "relpose_ransac_5pt": (epipolar, "relpose_ransac_5pt", k12_5pt_work),
    }
    return Recorder([targets[n] for n in names])


def g_replay(rec, dev, tag):
    """Each recorded COVINS-G kernel replayed on the card on the largest
    input the CPU pass gave it, against its plain version (one row a
    kernel; the scoring's later kinds printed beside it)."""
    table = {}
    if "l2_argmin" in rec.largest:
        a, b, mask = rec.on("l2_argmin", dev)
        table["l2_argmin"] = {**k13_case(a, b, mask, reps=50),
                              "shape": [a.shape[0], b.shape[0], a.shape[1]]}
    for name, case in (("hamming_ratio_match", k11_case), ("l2_ratio_match", k14_case)):
        if name in rec.largest:
            a, am, b, bm, seg, max_dist, ratio = rec.on(name, dev)
            table[name] = {**case(a, am, b, bm, seg, reps=50, max_dist=max_dist,
                                  ratio=ratio),
                           "shape": [a.shape[0], b.shape[0], seg]}
    for kind in ("central", "non-central", "counts"):
        key = f"ray_ransac_score {kind}"
        if key not in rec.largest:  # the 5-point solver scores its central RANSACs itself
            continue
        args = rec.on(key, dev)
        kw = {k: v.to(dev) if hasattr(v, "to") else v for k, v in rec.kwargs(key).items()}
        row = {**k12_case(args, kw, reps=20), "kind": kind,
               "shape": [args[0].shape[0], args[0].shape[1], args[2].shape[1]],
               "stage_calls": rec.calls[key][0]}
        if "ray_ransac_score" in table:
            print(json.dumps({"phase": tag, "kernel": "ray_ransac_score", **row}))
        table.setdefault("ray_ransac_score", row)
    if "relpose_ransac_5pt" in rec.largest:
        args = rec.on("relpose_ransac_5pt", dev)
        kw = {k: v.to(dev) if hasattr(v, "to") else v
              for k, v in rec.kwargs("relpose_ransac_5pt").items()}
        table["relpose_ransac_5pt"] = {
            **k12_5pt_case(args, kw, reps=20),
            "shape": [args[2].shape[0], args[3], args[2].shape[1]],
            "stage_calls": rec.calls["relpose_ransac_5pt"][0]}
    return table


def sift_inputs(dev, n_agents=2, n_kf=PHASE7_KF):
    """Phase 2's trajectories (n_agents x n_kf keyframes over 2000
    landmarks, up to 1024 features) seen through the port's SIFT world
    (128 float32 dimensions), and a 512-word L2 vocabulary trained on the
    card by k-means on K13."""
    import torch

    from covins_tpu_torch.ops import bow

    world, streams = build_streams(n_agents, n_kf, 2000, feat_type="SIFT")
    check(world.lm_descs.dtype == np.float32, "the SIFT world has no float descriptors")
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    vocab = bow.train_vocabulary_l2(torch.from_numpy(world.lm_descs).to(dev), k=512,
                                    iters=4, generator=gen).cpu().numpy()
    print(json.dumps({"phase": "sift", "vocabulary_words": vocab.shape[0],
                      "vocabulary_s": time.perf_counter() - t0}))
    return vocab, make_windows(streams)


def phase_g(dev, card, mode, vocab, windows, n_agents=2, n_kf=128):
    """One COVINS-G cell (``mode``, a :class:`GMode`) with the default
    thresholds: the whole ingest and drain on the card with the launch
    counters set to 0 just before it and read just after, checked against
    the mode's kernels (and failed if it closes no loop); then card against
    CPU on the first G_HEAD_WINDOWS windows (the database and every queued
    score exactly, then :func:`compare_g`); then the mode's kernels
    replayed on the largest inputs the CPU pass gave them, and the PyTorch
    operations of one verification's dispatch on the card.  Returns the
    replayed kernels' rows, each with its launches, and the launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from covins_tpu_torch.ops import loopverify

    t_phase = time.perf_counter()
    tag = mode.phase
    wrappers = kernel_wrappers()
    for k in wrappers.values():
        k.launches = 0
    with HostLog() as log:
        gpu = run_slice(vocab, windows, n_agents, "cuda", **mode.config)
    launches = {name: k.launches for name, k in wrappers.items()}
    out = outcome(gpu)
    n_windows, n_ver = log.calls.get("add_and_query_batch", 0), out["candidates"]
    for name in mode.present:
        check(launches[name] > 0, f"phase {tag} never launched {name}")
    for name in mode.absent:
        check(launches[name] == 0, f"phase {tag} launched {name} {launches[name]} times")
    for name in mode.per_window:
        check(launches[name] == n_windows,
              f"{n_windows} windows launched {name} {launches[name]} times, once each expected")
    for name in mode.per_verification:
        check(launches[name] == n_ver,
              f"{n_ver} verifications launched {name} {launches[name]} times, once each expected")
    check(n_ver > 0 and launches["ray_ransac_score"] == 3 * n_ver,
          f"{n_ver} verifications launched the scoring {launches['ray_ransac_score']} times, "
          "three each expected")
    check(out["loops"] + out["merges"] > 0, f"phase {tag} closed no loop")
    n_total = check_invariants(gpu, n_agents * n_kf, f"phase {tag} card")
    for mp in gpu["mgr"].maps.values():
        check(mp.descriptors.dtype == mode.desc_dtype,
              f"a map holds {mp.descriptors.dtype} descriptors, not {mode.desc_dtype}")
        check(all(lc["cov"] is not None for lc in mp.loops),
              "a COVINS-G loop edge carries no covariance")
    print(json.dumps({
        "phase": tag, "card": card, "config": mode.config, "n_keyframes": n_total,
        "windows": len(windows), "ingest_wall_s": gpu["ingest_s"],
        "drain_wall_s": gpu["flush_s"], "loops": out["loops"], "merges": out["merges"],
        "candidates": n_ver, "verifications_fetched": len(log.results),
        "accepted_verifications": sum(r["ok"] for r in log.results),
        "pgo_solves": out["pgo_solves"], "launches": launches,
        "host_ms_per_call": log.per_call_ms(), "host_calls": log.calls,
        "elapsed_s": time.perf_counter() - t_phase}))
    print(json.dumps({"phase": tag, "accepted": out["accepted"]}))

    # card against CPU on the stream's first windows
    rec = g_recorder(mode.replay)
    head = windows[:G_HEAD_WINDOWS]
    with HostLog() as g_log, profile(activities=[ProfilerActivity.CUDA]) as prof:
        g_run = run_slice(vocab, head, n_agents, "cuda", **mode.config)
    g_busy, g_top = _device_busy_ms(prof)
    g_wall = (g_run["ingest_s"] + g_run["flush_s"]) * 1e3
    with rec, HostLog() as c_log:
        c_run = run_cpu(vocab, head, n_agents, **mode.config)
    n_scores = compare_database(g_run, c_run)

    def cpu_spread():
        # the CPU pass again with its pose graphs' inputs one ulp up, then
        # down: the same decisions, poses moved by rounding alone
        readings = []
        for sign in (1, -1):
            with MovedPoseGraphs(sign):
                moved = run_cpu(vocab, head, n_agents, **mode.config)
            check(outcome(moved) == outcome(c_run),
                  f"phase {tag}: one ulp at the pose graphs' input changed the CPU's decisions")
            readings.append(pose_diff(moved, c_run))
        return max(readings)

    g_out, worst_loop, worst, worst_cov, bound = compare_g(g_run, c_run, g_log, c_log,
                                                           spread=cpu_spread)
    check(g_out["candidates"] > 0 and len(g_log.results) > 0,
          f"phase {tag}'s first {G_HEAD_WINDOWS} windows verified no candidate")
    print(json.dumps({
        "phase": tag, "card_vs_cpu": "agree", "windows": G_HEAD_WINDOWS,
        "queued_scores_equal": n_scores, "candidates": g_out["candidates"],
        "loops": g_out["loops"], "merges": g_out["merges"], "loop_tol": LOOP_TOL,
        "max_loop_T_diff": worst_loop, "cov_tol": COV_TOL, "max_cov_rel_diff": worst_cov,
        "pose_tol": POSE_TOL, "max_pose_diff": worst, **bound,
        "card_drain_wall_s": g_run["flush_s"], "card_traced_ingest_and_drain_ms": g_wall, "device_busy_ms": g_busy,
        "device_idle_share": 1.0 - g_busy / g_wall, "device_ms_by_kernel": g_top,
        "cpu_drain_wall_s": c_run["flush_s"], "cpu_threads": CPU_THREADS,
        "cpu_host_ms_per_call": c_log.per_call_ms(),
        "elapsed_s": time.perf_counter() - t_phase}))

    table = g_replay(rec, dev, tag)

    # the PyTorch operations and copies of one verification's dispatch on
    # the card (the first of the card's pass), beside the host's time a
    # dispatch
    a, kw = g_log.first_dispatch
    ops, h2d, d2h = trace_ops(lambda: loopverify.dispatch_covinsg_verify(*a, **kw))
    torch.cuda.synchronize()
    print(json.dumps({"phase": tag, "torch_ops_per_verification": ops, "h2d": h2d, "d2h": d2h,
                      "host_ms_per_dispatch": log.per_call_ms()["dispatch_covinsg_verify"],
                      "host_ms_per_dispatch_first_windows":
                          g_log.per_call_ms()["dispatch_covinsg_verify"]}))
    check(ops <= 20000, f"a COVINS-G verification issues {ops} PyTorch operations on the card")
    for name, row in table.items():
        row["launches"] = launches[name]
        print(json.dumps({"phase": tag, "kernel": name, **row}))
    print(json.dumps({"phase": tag, "elapsed_s": time.perf_counter() - t_phase}))
    return table, launches


# -------------------------------------------------------------------- sharding
SHARD_CG = 60  # the CG iterations of the sharded GBA steps, as phase 5's
SHARD_STEPS = 2


class HostTimer:
    """Host time spent inside ``torch.distributed.all_reduce`` while
    installed (the sharded paths' collectives, one call each), and a
    section's wall time with the card synchronised at both ends."""

    def __init__(self):
        import torch.distributed as dist

        self.dist, self.inner, self.s = dist, dist.all_reduce, 0.0

    def __enter__(self):
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return self.inner(*args, **kwargs)
            finally:
                self.s += time.perf_counter() - t0
        self.dist.all_reduce = timed
        return self

    def __exit__(self, *exc):
        self.dist.all_reduce = self.inner

    def section(self, fn):
        """(fn(), wall ms, ms inside all_reduce)."""
        import torch

        torch.cuda.synchronize()
        self.s, t0 = 0.0, time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3, self.s * 1e3


def knn2_case(q, db, reps):
    """K11's top-2 entry (`descriptors.hamming_knn2`) against its plain
    version on the card, both outputs bit for bit, one launch a call and
    the same across two launches; timed beside its bound (the +-1 int8
    product's operations) and the +-1 bf16 product with topk."""
    import torch

    from covins_tpu_torch.ops import descriptors as d

    def kernel():
        return d.hamming_knn2(q, db)

    before = d.hamming_knn2.launches
    got, again = kernel(), kernel()
    check(d.hamming_knn2.launches == before + 2, "knn2 did not launch once per call")
    plain = d.hamming_knn2_plain(q, db)
    torch.cuda.synchronize()
    for g, a, p in zip(got, again, plain):
        check(torch.equal(g, p), f"knn2 disagrees with its plain version at {tuple(q.shape)} "
              f"x {tuple(db.shape)}")
        check(torch.equal(g, a), "knn2 differs between two launches")
    m, n = q.shape[0], db.shape[0]
    bnd, by = bound((m + n) * 32 + 16 * m, (2.0 * m * n * 256, INT8_OPS_S))
    return {"kernel_ms": cuda_ms(kernel, reps), "busy_ms": busy_ms(kernel, reps),
            "plain_ms": cuda_ms(lambda: d.hamming_knn2_plain(q, db), reps),
            "library_ms": cuda_ms(lambda: pm1_bf16_top2(q, db, n), reps),
            "bound_ms": bnd, "bound_by": by, "shape": [m, n, 256],
            "max_abs_err": max(int((g - p).abs().max()) for g, p in zip(got, plain))}


def phase_sharding(dev, card):
    """`parallel/sharding.py` on the card at world 1 over NCCL (a group of
    one, `init_process_group` with ``device_id``, destroyed at the end):
    with the launch and collective counters set to 0 just before and read
    just after, (1) SHARD_STEPS sharded GBA steps of SHARD_CG iterations on
    phase 5's problem, (2) the sharded pose graph on
    `utils/synthetic.build_pose_graph` (256 poses, 1270 edges, n_gn 8,
    n_cg 100), (3) `dryrun_multichip`, (4) the sharded retrieval (B15) at
    (1024, 512) with k 10, (5) the sharded Hamming k-NN (B14) at 2048
    queries x 3072 rows with k 2 (K11's top-2 entry) and k 5 (K1); then
    each held to its undivided form on the card: the GBA steps and the pose
    graph bit for bit with `gba.pcg_plain` around K9 and `pgo._pcg` around
    K7, the retrieval and the k-NN bit for bit with their plain versions;
    (6) the launches and collectives against their expected numbers,
    `count_collectives` against its formula; (7) the times of the drive's
    sharded steps and solve beside the undivided ones (`gba_pcg`,
    `pgo_pcg`), with the host's time inside their all-reduces (at world 1
    NCCL launches no kernel), and B15's library calls beside its bound."""
    import torch
    import torch.distributed as dist

    from covins_tpu_torch.ops import bow, descriptors, gba, pgo
    from covins_tpu_torch.parallel import sharding as sh
    from covins_tpu_torch.parallel.dryrun import dryrun_multichip
    from covins_tpu_torch.utils import synthetic

    t_phase = time.perf_counter()
    dist.init_process_group("nccl", store=dist.HashStore(), world_size=1, rank=0,
                            device_id=dev)
    try:
        mesh = sh.make_mesh(1)
        check(mesh.backend == "nccl" and mesh.device == dev and mesh.world == 1,
              f"the mesh is {mesh}")
        p, _, _ = synthetic.build_gba_problem(n_kf=256, n_lm=8192, seed=SEED, max_obs=61440,
                                              device=dev)
        shard = sh.shard_gba_problem(mesh, sh.pad_to_multiple(p, 1))
        lam0 = torch.tensor(1e-4, dtype=torch.float64, device=dev)
        g, _ = synthetic.build_pose_graph(seed=SEED, device=dev)
        g_shard = sh.shard_pose_graph(mesh, g)
        rng = np.random.default_rng(SEED + 15)
        db = (rng.random((1024, 512)) * (rng.random((1024, 512)) < 0.1)).astype(np.float32)
        db /= np.maximum(np.linalg.norm(db, axis=-1, keepdims=True), 1e-12)
        db[[600, 900]] = db[17]  # rows tied with the query's own
        mask = rng.random(1024) > 0.05
        mask[[17, 600, 900]] = True
        db_t, q_t = sh.shard_rows(mesh, db), sh.replicate(mesh, db[17])
        mask_t = sh.shard_rows(mesh, mask)
        kdb, kq = synthetic.knn_scene(rng, 2048, 3072)
        kdb_t, kq_t = sh.shard_rows(mesh, kdb), sh.replicate(mesh, kq)
        sh.gba_step_sharded(mesh, shard, shard.state(), lam0, n_cg=2)  # warm-up
        torch.cuda.synchronize()

        # the sharded paths, counted
        wrappers = kernel_wrappers()
        for w in wrappers.values():
            w.launches = 0
        for k in sh.counts:
            sh.counts[k] = 0
        t0 = time.perf_counter()

        def gba_steps():
            st, lam, out = shard.state(), lam0, []
            for _ in range(SHARD_STEPS):
                st, lam, cost = sh.gba_step_sharded(mesh, shard, st, lam, n_cg=SHARD_CG)
                out.append((st, lam, cost))
            return out

        with HostTimer() as timer:
            steps, steps_ms, steps_nccl_ms = timer.section(gba_steps)
            (pgo_poses, pgo_cost), pgo_ms, pgo_nccl_ms = timer.section(
                lambda: sh.optimize_pose_graph_sharded(mesh, g_shard))
            dry = dryrun_multichip(mesh)
            ret = sh.sharded_topk_scores(mesh, db_t, q_t, mask_t, k=10)
            knn = {k: sh.sharded_hamming_knn(mesh, kdb_t, kq_t, k=k) for k in (2, 5)}
            torch.cuda.synchronize()
        drive_s = time.perf_counter() - t0
        launches = {name: w.launches for name, w in wrappers.items()}
        collectives = dict(sh.counts)
        # GBA: K8 twice a step, K9 once for b_red, n_cg + 1 times in the PCG
        # and six times in the ladder; the dry run's step (n_cg 10) and its
        # problem's K10; the pose graphs K7 n_cg + 1 times a Gauss-Newton
        # step (8 x 100 here, 5 x 200 in the dry run); the k-NN one knn2
        # for k 2 (and one in the dry run), K1 for k 5
        want = dict.fromkeys(wrappers, 0)
        want.update({"gba_reproj_blocks": 2 * (SHARD_STEPS + 1),
                     "gba_reduced_matvec": SHARD_STEPS * (SHARD_CG + 8) + 10 + 8,
                     "imu_preintegrate": 1, "pgo_matvec": 8 * 101 + 5 * 201,
                     "hamming_knn2": 2, "hamming_argmin": 1})
        check(launches == want, f"the sharded paths launched {launches}, expected {want}")
        # all-reduces: n_cg + 3 a GBA step, n_cg + 3 a pose-graph Gauss-
        # Newton step; gathers: the retrievals and k-NNs (the dry run's
        # included); broadcasts: the dry run's two replicas
        want_c = {"all_reduce": SHARD_STEPS * (SHARD_CG + 3) + 8 * 103 + 13 + 5 * 203,
                  "all_reduce_start": 0, "all_gather": 5, "reduce_scatter": 0,
                  "collective_permute": 0, "broadcast": 2}
        check(collectives == want_c, f"the sharded paths issued {collectives}, expected {want_c}")

        # (1) the GBA steps bit for bit with the undivided problem's, the
        # eager loop pcg_plain around K9
        graph, inputs = gba.obs_graph(p), gba.reproj_inputs(p)
        state0 = (p.poses, p.vels, p.biases, p.lms)
        kernel_pcg = gba.pcg
        try:
            gba.pcg = gba.pcg_plain
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ust, ulam = state0, lam0
            for st, lam, cost in steps:
                ust, ulam, ucost = gba._gn_schur_step(p, graph, ust, ulam, SHARD_CG, False,
                                                      inputs=inputs)
                check(all(torch.equal(a, b) for a, b in zip(st, ust))
                      and torch.equal(lam, ulam) and torch.equal(cost, ucost),
                      "the sharded GBA step differs from the undivided one")
            eager_ms = (time.perf_counter() - t0) * 1e3 / SHARD_STEPS
        finally:
            gba.pcg = kernel_pcg
        costs = [float(c) for _, _, c in steps]
        check(np.isfinite(costs).all() and costs[1] <= costs[0], f"sharded GBA costs {costs}")
        # (2) the pose graph bit for bit with the undivided graph's, `_pcg`
        # around K7, which runs twice: its node sums (`pgo.node_sums`) add
        # in a fixed order, so the card's pose graph gives the same bits on
        # every run
        kernel_pgo = pgo.pcg
        try:
            pgo.pcg = pgo_eager_pcg
            upo, ucost = pgo.optimize_pose_graph(g)
            upo2, _ = pgo.optimize_pose_graph(g)
        finally:
            pgo.pcg = kernel_pgo
        check(torch.equal(upo, upo2), "the undivided pose graph differs from itself by "
              f"{float((upo - upo2).abs().max())}")
        check(torch.equal(pgo_poses, upo) and torch.equal(pgo_cost, ucost),
              "the sharded pose graph differs from the undivided one: poses by "
              f"{float((pgo_poses - upo).abs().max())}, cost {float(pgo_cost)} against "
              f"{float(ucost)}")
        # (4) retrieval against its plain form on the card; ties to the
        # lower index
        want_r = bow.topk_candidates(bow.retrieval_scores(q_t, db_t, mask_t), 10)
        check(torch.equal(ret[0], want_r[0]) and torch.equal(ret[1], want_r[1]),
              "the sharded retrieval differs from its plain form")
        check(ret[1][:3].tolist() == [17, 600, 900], f"retrieval ties: {ret[1].tolist()}")
        # (5) the k-NN against the plain version and sort
        q8, d8 = descriptors.pack_pm1(kq_t), descriptors.pack_pm1(kdb_t)
        for k, (dk, ik) in knn.items():
            wd, wi = descriptors.hamming_knn_plain(q8, d8, k)
            check(torch.equal(dk, wd) and torch.equal(ik, wi.long()),
                  f"the sharded k-NN (k {k}) differs from its plain version")
        knn2 = {**knn2_case(q8, d8, reps=20), "launches": launches["hamming_knn2"]}
        print(json.dumps({"phase": "sharding", "kernel": "hamming_knn2", "card": card, **knn2}))
        k5 = {"ms": cuda_ms(lambda: descriptors.hamming_knn(q8, d8, 5), 20),
              "plain_ms": cuda_ms(lambda: descriptors.hamming_knn_plain(q8, d8, 5), 20)}
        # (6) count_collectives against its formula
        counted = sh.count_collectives(mesh, shard, shard.state(), lam0, SHARD_CG)
        check(counted == {"all_reduce": SHARD_CG + 3, "all_reduce_start": 0, "all_gather": 0,
                          "reduce_scatter": 0, "collective_permute": 0},
              f"count_collectives gave {counted}")
        # (7) times: B15's library calls beside its bound; the drive's
        # sharded steps and solve beside the undivided ones
        nbytes = 1024 * 512 * 4 + 512 * 4 + 1024 + 10 * 12
        b15_bound, b15_by = bound(nbytes, (2.0 * 1024 * 512, FP32_OPS_S))
        b15 = {"mv_ms": cuda_ms(lambda: torch.mv(db_t, q_t), 50),
               "mv_busy_ms": busy_ms(lambda: torch.mv(db_t, q_t), 50),
               "local_ms": cuda_ms(lambda: bow.topk_candidates(
                   bow.retrieval_scores(q_t, db_t, mask_t), 10), 50),
               "local_busy_ms": busy_ms(lambda: bow.topk_candidates(
                   bow.retrieval_scores(q_t, db_t, mask_t), 10), 50),
               "sharded_ms": cuda_ms(lambda: sh.sharded_topk_scores(mesh, db_t, q_t, mask_t,
                                                                    k=10), 50),
               "bound_ms": b15_bound, "bound_by": b15_by}

        times = {
            "gn_step_sharded_ms": steps_ms / SHARD_STEPS,
            "gn_step_sharded_all_reduce_host_ms": steps_nccl_ms / SHARD_STEPS,
            "gn_step_gba_pcg_ms": cuda_ms(lambda: gba._gn_schur_step(
                p, graph, state0, lam0, SHARD_CG, False, inputs=inputs), 2),
            "gn_step_eager_pcg_ms": eager_ms,
            "pgo_sharded_ms": pgo_ms, "pgo_sharded_all_reduce_host_ms": pgo_nccl_ms,
            "pgo_pgo_pcg_ms": cuda_ms(lambda: pgo.optimize_pose_graph(g), 1)}
        print(json.dumps({"phase": "sharding", "card": card, "world": mesh.world,
                          "backend": mesh.backend, "drive_s": drive_s, "launches": launches,
                          "collectives": collectives, "count_collectives": counted,
                          "gba_costs": costs, "pgo_cost": float(pgo_cost),
                          "dryrun": dry,
                          "retrieval_top": ret[1].tolist(), "b15": b15, "knn_k5": k5,
                          **times, "elapsed_s": time.perf_counter() - t_phase}))
    finally:
        dist.destroy_process_group()
    return {"hamming_knn2": knn2}, {k: launches[k] for k in (
        "pgo_matvec", "gba_reproj_blocks", "gba_reduced_matvec", "hamming_argmin")}


SOURCES = {
    # the Pallas kernel hamming_pallas.py::hamming_distance_packed_T was
    # removed from the JAX package; this is its live equivalent
    "hamming_argmin": ("covins_tpu_torch/csrc/hamming_argmin.cu",
                       "covins_tpu/ops/descriptors.py:58"),
    # with landmark_ops.py:54 distance_invariance and :82 landmark_normals
    "landmark_attributes": ("covins_tpu_torch/csrc/landmark_attributes.cu",
                            "covins_tpu/ops/landmark_ops.py:22"),
    "bow_insert_score": ("covins_tpu_torch/csrc/bow_insert_score.cu",
                         "covins_tpu/models/kf_database.py:30"),
    "hamming_mutual_nn": ("covins_tpu_torch/csrc/hamming_mutual_nn.cu",
                          "covins_tpu/ops/descriptors.py:138"),
    "project_match": ("covins_tpu_torch/csrc/project_match.cu",
                      "covins_tpu/ops/projmatch.py:43"),
    "p3p_ransac": ("covins_tpu_torch/csrc/p3p_ransac.cu",
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
    # with descriptors.py:103 masked_dist and :124 match_ratio per block
    # (loopverify.py:488-505)
    "hamming_ratio_match": ("covins_tpu_torch/csrc/hamming_ratio_match.cu",
                            "covins_tpu/ops/descriptors.py:114"),
    # with :46 triangulate_midpoint and the scoring of :131, :413, :453
    "ray_ransac_score": ("covins_tpu_torch/csrc/relpose_ransac.cu",
                         "covins_tpu/ops/epipolar.py:68"),
    # the whole central 5-point RANSAC (with ransac.py:18, :216
    # essential_5pt, :113 decompose_essential), loopverify.py:509-511
    "relpose_ransac_5pt": ("covins_tpu_torch/csrc/relpose_ransac.cu",
                           "covins_tpu/ops/epipolar.py:327"),
    # with the jnp.argmin of models/kf_database.py:60-61 and ops/bow.py:89
    "l2_argmin": ("covins_tpu_torch/csrc/l2_match.cu", "covins_tpu/ops/descriptors.py:89"),
    # sqrt(l2_distance_sq), masked_dist, knn2 and match_ratio per block
    # (loopverify.py:490-505)
    "l2_ratio_match": ("covins_tpu_torch/csrc/l2_match.cu",
                       "covins_tpu/ops/loopverify.py:491"),
    # the metric != "hamming" branch of _project_match_impl
    "project_match_l2": ("covins_tpu_torch/csrc/project_match.cu",
                         "covins_tpu/ops/projmatch.py:116"),
    # with _RED_TABLE (:52); prunemap's culling loop, map_store.py:665
    "redundancy_values": ("covins_tpu_torch/csrc/redundancy_values.cu",
                          "covins_tpu/ops/covisibility.py:58"),
    # the jax.vmap (:83) of the descent of :70-81
    "dbow_descend": ("covins_tpu_torch/csrc/dbow_descend.cu",
                     "covins_tpu/ops/dbow_import.py:54"),
    # the +-1 dot_general and lax.top_k of the row-sharded k-NN, k <= 2
    "hamming_knn2": ("covins_tpu_torch/csrc/hamming_ratio_match.cu",
                     "covins_tpu/parallel/sharding.py:67"),
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

    gba_table, sift_k5 = phase1(dev)
    print(json.dumps({"phase": 1, "elapsed_s": time.perf_counter() - t_start}))
    table, gpu_run, vocab, world = phase2(dev, card)
    print(json.dumps({"phase": 2, "elapsed_s": time.perf_counter() - t_start}))
    streams3, vocab3 = phase3(dev, card, n_kf=32)
    print(json.dumps({"phase": 3, "elapsed_s": time.perf_counter() - t_start}))
    server_table = phase_server(dev, card, streams3, vocab3)
    print(json.dumps({"phase": "server", "elapsed_s": time.perf_counter() - t_start}))
    phase4(dev, card)
    print(json.dumps({"phase": 4, "elapsed_s": time.perf_counter() - t_start}))
    phase5(dev, card)
    print(json.dumps({"phase": 5, "elapsed_s": time.perf_counter() - t_start}))
    gba_launches = phase6(dev, card, gpu_run, vocab, world)
    print(json.dumps({"phase": 6, "elapsed_s": time.perf_counter() - t_start}))
    orb_table, _ = phase_g(dev, card, G_ORB, vocab,
                           make_windows(build_streams(2, PHASE7_KF, 2000)[1]),
                           n_kf=PHASE7_KF)
    table.update(orb_table)
    print(json.dumps({"phase": 7, "elapsed_s": time.perf_counter() - t_start}))
    sift_table, sift_launches = phase_g(dev, card, G_SIFT, *sift_inputs(dev), n_kf=PHASE7_KF)
    print(json.dumps({"phase": "sift", "elapsed_s": time.perf_counter() - t_start}))
    table.update(sift_table)
    table.update(phase_frontend(dev, card))
    print(json.dumps({"phase": "frontend", "elapsed_s": time.perf_counter() - t_start}))
    shard_table, shard_launches = phase_sharding(dev, card)
    table.update(shard_table)
    print(json.dumps({"phase": "sharding", "elapsed_s": time.perf_counter() - t_start}))
    # K5's L2 metric is off the SIFT path (COVINS-G matches no landmarks):
    # its row carries the path's launches of K5, 0, and phase 1's timing
    table["project_match_l2"] = {**sift_k5, "launches": sift_launches["project_match"]}
    for name, row in gba_table.items():
        row["launches"] = gba_launches[name]
    table.update(gba_table)
    table.update(server_table)
    # the sharded paths' launches of the kernels they share with others
    for name, n in shard_launches.items():
        table[name]["sharding_launches"] = n

    missing = sorted(set(SOURCES) - set(table))
    check(not missing and set(table) == set(SOURCES), f"the kernel table lacks {missing}")
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
                                   "map_refresh_rows", "map_refresh_ops", "map_commit_ops",
                                   "map_refresh_wall_ms", "window_ops_lazy", "window_ops",
                                   "window_h2d_lazy", "window_h2d", "window_d2h_lazy",
                                   "window_d2h", "window_ms_lazy", "window_ms",
                                   "window_busy_ms_lazy", "candidates_mean",
                                   "candidates_max", "overflow_rows", "filter_err_over_c_tc",
                                   "filter_product_err_over_c_tc",
                                   "design_bound_ms", "design_bound_by",
                                   "profiler_ms", "profiler_intervals", "ops_per_call",
                                   "cost_s1_ms", "cost_s1_busy_ms", "cost_s1_bound_ms",
                                   "cost_s7_ms", "cost_s7_busy_ms", "cost_s7_bound_ms",
                                   "outlier_ms", "outlier_busy_ms", "outlier_bound_ms",
                                   "sharding_launches")
               if k in row},
        })
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
