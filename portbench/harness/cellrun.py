"""One run of a cell: set-up, the measured window, the metrics, and the
comparison with the reference once the program's state is freed."""

from __future__ import annotations

import gc
import importlib.util
import json
import sys
import time

import numpy as np
import torch

from portbench.harness import check, devtrace, drive, taps, work
from portbench.harness.drive import PB

FORBIDDEN = {"jax", "jaxlib", "flax", "covins_tpu"}


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot, whole) is
    JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def read_metric(name: str, t: dict):
    """metrics/<name>.py's ``read(t)``: a number, or None where it finds
    nothing to read."""
    spec = importlib.util.spec_from_file_location("portbench_metric_" + name.replace(".", "_"),
                                                  PB / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(t)


def manifest():
    return json.loads((PB.parent / "BENCHMARK.json").read_text())


def cell_metrics(cell_name: str, kind: str) -> list:
    """The manifest's metrics of ``kind`` that this cell reports."""
    out = []
    for m in manifest()[kind]:
        if "workloads" not in m or cell_name in m["workloads"]:
            out.append(m)
    return out


def _sync(device):
    if torch.device(device).type == "cuda":
        return torch.cuda.synchronize
    return lambda: None


def warm_up(cell, streams, voc, device):
    """The cell's own paths once on a scratch manager (ingest, retrieval,
    a verification, a merge and its pose-graph solve), then thrown away."""
    mgr, sessions, _ = drive.new_system(cell, voc, device)
    w = cell.mix["warmup"]

    def done():
        return (mgr.n_merges >= 1 and mgr.n_pgo >= 1
                and sum(s.placerec.n_dispatched for s in sessions) >= 1)
    win = drive.drive(sessions, streams, _sync(device), max_units=w["max_units"], done=done)
    return {"units": win.units, "loops": mgr.n_loops - mgr.n_merges,
            "merges": mgr.n_merges, "pgo": mgr.n_pgo, "all_paths": done()}


def run(cell, seed: int, seconds: float, trace: bool, device, t_process: float,
        limits: dict = None, log=sys.stderr, warm: bool = True):
    """The run's result line (a dict), the readings compared, what was
    captured and the reference's answers.  ``cell`` is a cell's name or a
    loaded :class:`drive.Cell`."""
    if isinstance(cell, str):
        cell = drive.load_cell(cell)
    cell_name = cell.name
    card = torch.device(device).type == "cuda"
    laps = {"start": time.perf_counter() - t_process}
    if card:
        from covins_tpu_torch import cuda_build

        cuda_build.build_all()
        laps["build"] = time.perf_counter() - t_process
    world, streams, voc = drive.make_inputs(cell, seed, device)
    laps["inputs"] = time.perf_counter() - t_process
    if warm:
        print(json.dumps({"warm_up": warm_up(cell, streams, voc, device)}), file=log)
    laps["warm_up"] = time.perf_counter() - t_process
    mgr, sessions, metrics = drive.new_system(cell, voc, device)
    ctaps = taps.CheckTaps(cell.mode, seed, cell.mix["check"]["attr_share"],
                           cell.mix["check"]["pgo_solves"]).install()
    ttaps = taps.TraceTaps(cell.mode, card).install() if trace else None
    sync = _sync(device)
    sync()
    # the harness's own objects (the built streams above all) out of the
    # collector's scans: a server holds no such backlog
    gc.collect()
    gc.freeze()
    prof = None
    if trace and card:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.__enter__()
    setup_s = time.perf_counter() - t_process
    print(json.dumps({"setup_laps_s": laps, "setup_s": setup_s}), file=log)
    try:
        win = drive.drive(sessions, streams, sync, seconds=seconds,
                          spans=ttaps.spans if ttaps else None)
    finally:
        if prof is not None:
            sync()
            prof.__exit__(None, None, None)
        # in the reverse order of their install: the trace's shims wrap the check's
        if ttaps:
            ttaps.remove()
        ctaps.remove()
    window_traced = win.t_last - win.t_start
    peak = torch.cuda.max_memory_allocated() if card else 0
    inside = win.inside()
    lat = np.asarray([x for _, x in inside], np.float64)
    metrics_out = {}
    breakdown = None
    device_info = {"platform": "gpu" if card else "cpu",
                   "kind": torch.cuda.get_device_name(0) if card else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    if not trace:
        e2e = {"kf_per_s": len(inside) / seconds, "setup_s": setup_s}
        for m in cell_metrics(cell_name, "end_to_end"):
            if e2e.get(m["name"]) is not None:
                metrics_out[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    else:
        t = {"window_s": window_traced, "units": win.units, "resolved": len(win.resolved),
             "latencies_s": lat.tolist(),
             "spans": ttaps.spans.closed, "counts": ttaps.spans.counts,
             "timings": {k: list(v) for k, v in metrics.timings.items()},
             "dispatched": sum(s.placerec.n_dispatched for s in sessions),
             "device": None, "least_verify_s": None}
        if prof is not None:
            summ = devtrace.summarise(devtrace.device_events(prof), ttaps.spans.labels,
                                      taps.MARKER_NAME)
            t["device"] = summ
            t["least_verify_s"] = work.least_seconds(ttaps.work)
            device_info.update(busy_s=summ["busy_s"], window_s=window_traced)
            gaps = []
            for lab, host_s in ttaps.spans.self_s.items():
                if summ["by_label_s"] is None:  # a marker lost: no cut by span
                    gaps.append([f"{lab} (host self time)", host_s])
                    continue
                gaps.append([f"{lab} (host self time less its device time)",
                             max(host_s - summ["by_label_s"].get(lab, 0.0), 0.0)])
            breakdown = {"device_ops": [[n[:120], s] for n, s in summ["ops_s"][:10]],
                         "idle_gaps": sorted(gaps, key=lambda g: -g[1])[:10]}
            print(json.dumps({"markers": summ["markers"],
                              "markers_launched": summ["markers_launched"],
                              "unplaced_s": summ["unplaced_s"]}), file=log)
        for m in cell_metrics(cell_name, "per_layer"):
            v = read_metric(m["name"], t)
            if v is not None:
                metrics_out[m["name"]] = {"value": v, "unit": m["unit"]}
    # the comparison: the program's answers to the host, its state freed
    gc.unfreeze()
    cap = check.capture(cell, seed, mgr, win, ctaps, streams)
    cap["vocab"] = voc
    del mgr, sessions, metrics, ctaps, ttaps, prof
    if card:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = check.reference_answers(cell, cap, voc, torch.float64, torch.float64, device)
    readings = check.numbers(cell, cap, check.program_answers(cap), ref)
    t_ref = time.perf_counter() - t_ref
    limits = limits or cell.config["limits"]
    correct, rows = check.verdict(readings, limits)
    result = {"correct": bool(correct), "attempted": len(inside), "failed": 0,
              "metrics": metrics_out, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    q = np.percentile(lat, [50, 75, 90, 95]).tolist() if len(lat) else []
    extra = {"latency_p50_p75_p90_p95_s": q, "units": win.units, "delivered": win.units, "resolved_inside": len(inside),
             "loops_checked": sum(1 for r in cap["loops"] if r["out"]["ok"]),
             "verifications_checked": len(cap["loops"]), "cohorts_checked": len(cap["cohorts"]),
             "handled": [h[2] for h in cap["handled"]].count("loop"),
             "merges": [h[2] for h in cap["handled"]].count("merge"),
             "pgo_solves": cap["n_solves"], "pgo_checked": len(cap["pgo"]),
             "reference_s": t_ref,
             "handled_ids": [list(h[0]) for h in cap["handled"]],
             "queries_checked": len(cap["queries"]), "db_rows": len(cap["row_ids"])}
    print(json.dumps(extra), file=log)
    return result, readings, cap, ref
