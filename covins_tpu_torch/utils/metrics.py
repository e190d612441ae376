"""Structured metrics + timing: the observability layer.

The reference has no metrics registry — only colored stdout macros
(`COUTERROR/COUTWARN/...`, `typedefs_base.hpp:65-70`) and per-map count
prints every 50 keyframes (`map_be.cpp:391-392`).  SURVEY.md §5 calls for
per-step metrics (KF/s ingest, loop candidates, inlier rates, GN cost
curves, timings) to stdout/JSONL — this module provides that, plus a
`torch.profiler` trace context for the card's timeline.
"""

from __future__ import annotations

import contextlib
import json
import sys
import threading
import time
from collections import defaultdict
from typing import Optional, TextIO


class Metrics:
    """Thread-safe counters/timers flushed as JSONL."""

    def __init__(self, sink: Optional[TextIO] = None, jsonl_path: Optional[str] = None):
        self._lock = threading.Lock()
        self.counters: dict[str, float] = defaultdict(float)
        self.timings: dict[str, list[float]] = defaultdict(list)
        self._sink = sink
        self._fh = open(jsonl_path, "a") if jsonl_path else None
        self._t0 = time.perf_counter()

    def count(self, name: str, n: float = 1.0):
        with self._lock:
            self.counters[name] += n

    @contextlib.contextmanager
    def timer(self, name: str):
        t = time.perf_counter()
        try:
            yield
        finally:
            with self._lock:
                self.timings[name].append(time.perf_counter() - t)

    def event(self, name: str, **fields):
        rec = {"t": round(time.perf_counter() - self._t0, 4),
               "event": name, **fields}
        line = json.dumps(rec)
        if self._fh:
            self._fh.write(line + "\n")
            self._fh.flush()
        if self._sink:
            print(line, file=self._sink, flush=True)

    def snapshot(self) -> dict:
        with self._lock:
            out = {"counters": dict(self.counters), "timings": {}}
            for k, v in self.timings.items():
                if not v:
                    continue
                out["timings"][k] = {
                    "n": len(v),
                    "total_s": round(sum(v), 4),
                    "mean_ms": round(1e3 * sum(v) / len(v), 3),
                    "max_ms": round(1e3 * max(v), 3),
                }
            elapsed = time.perf_counter() - self._t0
            kfs = self.counters.get("keyframes", 0)
            if kfs and elapsed > 0:
                out["keyframes_per_s"] = round(kfs / elapsed, 2)
            return out

    def flush(self):
        self.event("snapshot", **self.snapshot())


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """torch.profiler trace of host and CUDA activity, written as a Chrome
    trace (`trace.json`) under ``log_dir``."""
    import os

    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


GLOBAL = Metrics(sink=None)
