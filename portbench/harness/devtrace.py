"""Reading the device trace of a traced window (torch.profiler, CUDA
activity): the device's busy time as the union of its kernel, copy and
set intervals, the same cut into the segments between the span markers
(short and long in turn, so that a marker the trace lost moves no
segment), and the operations that took the most time."""

from __future__ import annotations



def device_events(prof):
    """(name, start ns, end ns) of every device interval, by start."""
    import torch

    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        start = e.start_ns() if hasattr(e, "start_ns") else int(e.start_us() * 1000)
        out.append((e.name(), start, start + e.duration_ns()))
    out.sort(key=lambda x: x[1])
    return out


def union_ns(intervals) -> int:
    """Length of the union of sorted (start, end) intervals."""
    total, cur_s, cur_e = 0, None, None
    for s, e in intervals:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def summarise(events, labels, marker_name: str, long_ns: int = 4_000) -> dict:
    """Busy seconds in all, by segment label, the markers found against
    those launched, and the device operations by total time.  Segment k
    runs from marker k - 1 to marker k (k = 0 before the first), in the
    order the one stream ran them.  Even markers are short and odd ones
    long (``long_ns`` or more): two of one parity in a row mean that the
    trace lost the one between, so each marker found keeps its index, and
    the work between the two, whose span is not known, is left out of
    every label (``unplaced_s``); so is the work after the last marker
    found when the last one launched is lost.  ``by_label_s`` is None
    where the markers found and the losses do not add up to the markers
    launched."""
    n_launched = len(labels) - 1
    busy = union_ns([(s, e) for n, s, e in events if marker_name not in n])
    by_op: dict = {}
    by_label: dict = {}
    unplaced = 0
    k, cur = 0, []  # markers accounted for (found or lost); work since the last

    def flush(placed: bool):
        nonlocal unplaced
        if placed:
            by_label[labels[k]] = by_label.get(labels[k], 0) + union_ns(cur)
        else:
            unplaced += union_ns(cur)

    n_found = 0
    for name, s, e in events:
        if marker_name not in name:
            by_op[name] = by_op.get(name, 0) + (e - s)
            cur.append((s, e))
            continue
        n_found += 1
        lost = ((e - s) >= long_ns) != (k % 2 == 1)
        flush(not lost)
        k += 1 + lost
        cur = []
    ok = k in (n_launched, n_launched - 1)
    if ok:
        flush(k == n_launched)
    return {"busy_s": busy / 1e9,
            "by_label_s": {lab: v / 1e9 for lab, v in by_label.items()} if ok else None,
            "unplaced_s": unplaced / 1e9, "markers": n_found, "markers_launched": n_launched,
            "ops_s": sorted(((op, v / 1e9) for op, v in by_op.items()),
                            key=lambda kv: -kv[1])}
