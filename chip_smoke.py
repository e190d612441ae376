#!/usr/bin/env python3
"""Chip check of the covins_tpu_torch port on one CUDA card.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It fails
(nonzero exit, no result line) without a CUDA card or without the
package beside it.  Phases:

0. the card's name and power limit, torch/CUDA versions, and the build of
   every kernel in ``covins_tpu_torch/csrc`` (one nvcc per source, in
   parallel);
1. each kernel against its plain PyTorch version on the card, on inputs
   made from a numpy seed, with edge cases (ties, masks, empty rows,
   dropped rows): K1 and K2 exactly, K3 to rtol 1e-6;
2. the ingest slice at the workload of the JAX package's benchmark
   (2 agents x 128 KF over 2000 landmarks, 512-word vocabulary trained on
   the card, 1024-message windows, ``placerec_active=False``,
   ``placerec_defer=True``): a warm-up pass, then the measured pass with
   every launch counter set to 0 just before it and read just after; two
   traced passes (device busy time from torch.profiler, host self time by
   layer from cProfile); then the same streams through the port on the
   CPU (plain versions), and
   every map array and database row compared with the card's run;
   then each kernel replayed on the largest input the main path gave it,
   against its plain version, timed beside its bound;
3. a five-agent deployment (5 x 256 KF over 4000 landmarks), card only;
4. one JSON line per the kernel table, the card line, and the result
   line ``{"ok": true, "device": {...}}``.
"""

import json
import subprocess
import sys
import time

import numpy as np

# published peaks of one H100 SXM (dense): HBM bytes/s, int8 tensor ops/s,
# float32 (no tensor cores) ops/s
HBM_BYTES_S = 3.35e12
INT8_OPS_S = 1979e12
FP32_OPS_S = 67e12

SEED = 0
WINDOW = 1024


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


def bound(bytes_moved, ops, ops_rate):
    t_bytes = bytes_moved / HBM_BYTES_S * 1e3
    t_ops = ops / ops_rate * 1e3
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
    bnd, by = bound(m * 32 + n * 32 + m + 8 * m, 2.0 * m * n * 256, INT8_OPS_S)
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
    bnd, by = bound(L * P * 33 + L * 32, 2.0 * L * P * P * 256, INT8_OPS_S)
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
                    W * F + 3.0 * W * V, FP32_OPS_S)
    return {
        "kernel_ms": cuda_ms(lambda: bow.bow_insert(words, dest, db_k), reps),
        "plain_ms": cuda_ms(lambda: bow.bow_insert_plain(words, dest, db_p), reps),
        "library_ms": None,
        "bound_ms": bnd, "bound_by": by,
        "max_abs_err": float((vecs - ref).abs().max().item()),
    }


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
                          "shape": [m, n, 256], **r,
                          "launches": descriptors.hamming_argmin.launches}))

    L, P = 8192, 16
    d = rng.integers(0, 256, (L, P, 32), dtype=np.uint8)
    d[:, 6] = d[:, 2]  # duplicate descriptors
    mask = rng.random((L, P)) > 0.5
    for i, nv in enumerate((0, 1, 2, 16)):
        mask[i] = False
        mask[i, :nv] = True
    r = k2_case(t(d), t(mask), reps=20)
    print(json.dumps({"phase": 1, "kernel": "representative_descriptors",
                      "shape": [L, P, 32], **r,
                      "launches": landmark_ops.representative_descriptors.launches}))

    W, F, V, cap = 256, 1024, 512, 1024
    words = rng.integers(-1, V, (W, F)).astype(np.int32)
    words[7] = -1  # empty row
    dest = np.arange(W, dtype=np.int64) + 3
    dest[11] = cap  # dropped
    r = k3_case(t(words), t(dest), torch.zeros((cap, V), device=dev), reps=20)
    print(json.dumps({"phase": 1, "kernel": "bow_insert",
                      "shape": [W, F, V, cap], **r,
                      "launches": bow.bow_insert.launches}))


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


def run_slice(vocab, windows, n_agents, device):
    """Fresh manager + sessions; ingest every window, then flush.  Returns
    (manager, sessions, queued retrieval data, ingest s, flush s)."""
    import torch

    from covins_tpu_torch.models.map_manager import MapManager
    from covins_tpu_torch.models.session import AgentSession
    from covins_tpu_torch.utils.config import Config

    cfg = Config(placerec_active=False, placerec_defer=True)
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
    return mgr, sessions, queued, t_ingest, time.perf_counter() - t0


def check_invariants(mgr, sessions, n_kf_total, tag):
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
    return n_kf


def compare_runs(gpu, cpu):
    """Every map SoA array and the database of the card's run against the
    CPU run: integers and descriptors exactly, float64 to 1e-9, float32
    database rows and scores to rtol 1e-5."""
    g_mgr, _, g_q, _, _ = gpu
    c_mgr, _, c_q, _, _ = cpu
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
    for gq, cq in zip(g_q, c_q):
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
    kernel wrapper, read from the wrapper's arguments at call time through
    ``sys.setprofile``.  The wrappers run unchanged; only the unmeasured
    warm-up pass is recorded, since the profile hook slows every call."""

    def __init__(self, targets):
        # code object -> (name, argument names, size of the work)
        self.targets = {fn.__code__: (fn.__name__, argn, size)
                        for fn, argn, size in targets}
        self.largest = {}

    def _hook(self, frame, event, arg):
        if event != "call" or frame.f_code not in self.targets:
            return
        name, argn, size = self.targets[frame.f_code]
        args = [frame.f_locals[a] for a in argn]
        s = size(*args)
        if s > self.largest.get(name, (0,))[0]:
            self.largest[name] = (s, [None if x is None else x.clone()
                                      for x in args])

    def __enter__(self):
        sys.setprofile(self._hook)
        return self

    def __exit__(self, *exc):
        sys.setprofile(None)


def _layer(filename, funcname):
    """Layer of a profiled function: a module of the port, or the library
    whose native code it is."""
    if "covins_tpu_torch" in filename:
        return filename[filename.rindex("covins_tpu_torch"):]
    for lib in ("torch", "numpy"):
        if f"/{lib}/" in filename or lib in funcname:
            return lib
    return "python"


def trace_slice(vocab, windows, n_agents, card):
    """Two traced passes of the slice, after the measured one: the device's
    busy time from ``torch.profiler`` (kernel intervals on the card), and
    the host's self time by layer from ``cProfile``."""
    import cProfile
    import pstats

    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, _, _, t_ingest, t_flush = run_slice(vocab, windows, n_agents, "cuda")
    busy, by_kernel = 0.0, {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = e.time_range.elapsed_us()
            busy += us
            by_kernel[e.name[:60]] = by_kernel.get(e.name[:60], 0.0) + us
    wall_ms = (t_ingest + t_flush) * 1e3
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    print(json.dumps({
        "phase": 2, "trace": "torch.profiler", "card": card,
        "wall_ms_traced": wall_ms, "device_busy_ms": busy / 1e3,
        "device_idle_share": 1.0 - busy / 1e3 / wall_ms,
        "device_ms_by_kernel": {k: v / 1e3 for k, v in top}}))

    prof = cProfile.Profile()
    prof.enable()
    _, _, _, t_ingest, t_flush = run_slice(vocab, windows, n_agents, "cuda")
    prof.disable()
    layers, funcs = {}, {}
    for (filename, _, funcname), (_, _, tt, _, _) in pstats.Stats(prof).stats.items():
        name = _layer(filename, funcname)
        layers[name] = layers.get(name, 0.0) + tt
        funcs[f"{name}:{funcname}"] = funcs.get(f"{name}:{funcname}", 0.0) + tt
    print(json.dumps({
        "phase": 2, "trace": "cProfile", "card": card,
        "wall_ms_traced": (t_ingest + t_flush) * 1e3,
        "host_self_ms_by_layer": {
            k: v * 1e3 for k, v in sorted(layers.items(), key=lambda kv: -kv[1])[:10]},
        "host_self_ms_by_function": {
            k: v * 1e3 for k, v in sorted(funcs.items(), key=lambda kv: -kv[1])[:10]}}))


def phase2(dev, card):
    import torch

    from covins_tpu_torch.ops import bow, descriptors, landmark_ops

    n_agents, n_kf = 2, 128
    t0 = time.perf_counter()
    world, streams = build_streams(n_agents, n_kf, 2000)
    windows = make_windows(streams)
    t_streams = time.perf_counter() - t0
    gen = torch.Generator(device=dev).manual_seed(SEED)
    vocab = bow.train_vocabulary(torch.from_numpy(world.lm_descs).to(dev),
                                 k=512, iters=4, generator=gen).cpu().numpy()
    kernels = (descriptors.hamming_argmin, landmark_ops.representative_descriptors,
               bow.bow_insert)
    rec = Recorder([
        (descriptors.hamming_argmin, ("a_u8", "b_u8", "row_mask"),
         lambda a, b, m: a.shape[0] * b.shape[0]),
        (landmark_ops.representative_descriptors, ("descs_u8", "mask"),
         lambda d, m: d.shape[0]),
        (bow.bow_insert, ("words", "dest", "db"), lambda w, d, db: w.numel()),
    ])
    with rec:  # warm-up pass, recording the kernels' largest inputs
        run_slice(vocab, windows, n_agents, "cuda")
    for k in kernels:
        k.launches = 0
    gpu = run_slice(vocab, windows, n_agents, "cuda")
    launches = {k.__name__: k.launches for k in kernels}
    for name, n in launches.items():
        check(n > 0, f"main path never launched {name}")
    n_total = check_invariants(gpu[0], gpu[1], n_agents * n_kf, "card")
    t_ingest, t_flush = gpu[3], gpu[4]
    print(json.dumps({
        "phase": 2, "card": card, "n_agents": n_agents, "n_keyframes": n_total,
        "windows": len(windows), "db_rows": gpu[0].database.n,
        "landmarks": sum(mp.n_lm for mp in gpu[0].maps.values()),
        "observations": sum(mp.n_obs for mp in gpu[0].maps.values()),
        "ingest_wall_s": t_ingest, "ingest_kf_per_s": n_total / t_ingest,
        "flush_wall_s": t_flush, "kf_per_s_with_flush": n_total / (t_ingest + t_flush),
        "stream_build_s": t_streams, "launches": launches,
        "launches_per_window": {k: v / len(windows) for k, v in launches.items()},
    }))

    trace_slice(vocab, windows, n_agents, card)

    cpu = run_slice(vocab, windows, n_agents, "cpu")
    check_invariants(cpu[0], cpu[1], n_agents * n_kf, "cpu")
    n_arrays, n_scores = compare_runs(gpu, cpu)
    print(json.dumps({"phase": 2, "card_vs_cpu": "agree", "arrays": n_arrays,
                      "score_rows": n_scores, "cpu_ingest_wall_s": cpu[3]}))

    # each kernel on the largest input the main path gave it
    table = {}
    a, b, mask = rec.largest["hamming_argmin"][1]
    table["hamming_argmin"] = {**k1_case(a, b, mask, reps=50),
                               "shape": [a.shape[0], b.shape[0], 256]}
    d, m = rec.largest["representative_descriptors"][1]
    table["representative_descriptors"] = {**k2_case(d, m, reps=50),
                                           "shape": list(d.shape)}
    w, dst, db = rec.largest["bow_insert"][1]
    table["bow_insert"] = {**k3_case(w, dst, db, reps=50),
                           "shape": list(w.shape) + list(db.shape)}
    for name, row in table.items():
        row["launches"] = launches[name]
    return table


def phase3(dev, card):
    from covins_tpu_torch.ops import bow, descriptors, landmark_ops

    import torch

    # 4000 landmarks put up to ~1300 in view; the front-end keeps 1000
    # features per keyframe (ORB-SLAM3's EuRoC ORBextractor.nFeatures), and
    # the map holds at most 1024 (Map max_features)
    n_agents, n_kf, n_lm, n_feat = 5, 256, 4000, 1000
    t0 = time.perf_counter()
    world, streams = build_streams(n_agents, n_kf, n_lm, n_feat)
    windows = make_windows(streams)
    t_streams = time.perf_counter() - t0
    gen = torch.Generator(device=dev).manual_seed(SEED)
    vocab = bow.train_vocabulary(torch.from_numpy(world.lm_descs).to(dev),
                                 k=512, iters=4, generator=gen).cpu().numpy()
    kernels = (descriptors.hamming_argmin, landmark_ops.representative_descriptors,
               bow.bow_insert)
    for k in kernels:
        k.launches = 0
    mgr, sessions, _, t_ingest, t_flush = run_slice(vocab, windows, n_agents, "cuda")
    launches = {k.__name__: k.launches for k in kernels}
    for name, n in launches.items():
        check(n > 0, f"five-agent run never launched {name}")
    n_total = check_invariants(mgr, sessions, n_agents * n_kf, "five agents")
    print(json.dumps({
        "phase": 3, "card": card, "n_agents": n_agents, "n_keyframes": n_total,
        "n_world_landmarks": n_lm, "max_features_per_kf": n_feat,
        "windows": len(windows),
        "db_rows": mgr.database.n,
        "landmarks": sum(mp.n_lm for mp in mgr.maps.values()),
        "ingest_wall_s": t_ingest, "ingest_kf_per_s": n_total / t_ingest,
        "flush_wall_s": t_flush, "kf_per_s_with_flush": n_total / (t_ingest + t_flush),
        "stream_build_s": t_streams, "launches": launches,
    }))


SOURCES = {
    # the Pallas kernel hamming_pallas.py::hamming_distance_packed_T was
    # removed from the JAX package; this is its live equivalent
    "hamming_argmin": ("covins_tpu_torch/csrc/hamming_argmin.cu",
                       "covins_tpu/ops/descriptors.py:58"),
    "representative_descriptors": ("covins_tpu_torch/csrc/representative_descriptors.cu",
                                   "covins_tpu/ops/landmark_ops.py:22"),
    "bow_insert": ("covins_tpu_torch/csrc/bow_insert.cu",
                   "covins_tpu/models/kf_database.py:30"),
}


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 2
    from covins_tpu_torch import cuda_build

    dev = torch.device("cuda", 0)
    card = card_line()
    print(card)
    print(json.dumps({"phase": 0, "torch": torch.__version__,
                      "cuda": torch.version.cuda, "python": sys.version.split()[0]}))
    t0 = time.perf_counter()
    logs = cuda_build.build_all()
    t_build = time.perf_counter() - t0
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[ptxas {name}] {line.strip()}")
    print(json.dumps({"phase": 0, "build_s": t_build, "kernels": sorted(logs)}))

    phase1(dev)
    table = phase2(dev, card)
    phase3(dev, card)

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
