"""Each per-layer metric's reader, the device trace's reduction and the
verification's work counts, on synthetic inputs."""

import pytest

from portbench.harness import cellrun, devtrace, work


def trace(**kw):
    t = {"window_s": 10.0, "units": 50, "resolved": 40,
         "spans": {"ingest": [0.01] * 50, "verify": [0.2, 0.1] * 20, "correct": [0.05, 0.07],
                   "pgo": [1.0, 2.0, 3.0]},
         "counts": {"dispatch": 40, "finalize": 30},
         "timings": {"placerec_detect": [0.001] * 40}, "dispatched": 40,
         "device": {"busy_s": 0.5, "by_label_s": {"verify": 0.2, "pgo": 0.3}},
         "least_verify_s": 0.002, "latencies_s": [0.1 * (k + 1) for k in range(11)]}
    t.update(kw)
    return t


@pytest.mark.parametrize("name, want", [
    ("ingest_ms_per_kf", 10.0), ("detect_ms_per_kf", 1.0), ("verify_ms_per_kf", 150.0),
    ("verify_used_pct", 75.0), ("correct_ms", 60.0), ("pgo_ms", 2000.0),
    ("verify_roofline", 1.0), ("device_idle_pct.stream", 95.0), ("kf_latency_p90_s", 1.0)])
def test_reader_arithmetic(name, want):
    assert cellrun.read_metric(name, trace()) == pytest.approx(want)


def test_roofline_without_a_cut_by_span_reads_nothing():
    t = trace(device={"busy_s": 0.5, "by_label_s": None})
    assert cellrun.read_metric("verify_roofline", t) is None


@pytest.mark.parametrize("name", ["correct_ms", "pgo_ms", "verify_roofline",
                                  "device_idle_pct.stream", "verify_used_pct",
                                  "kf_latency_p90_s"])
def test_reader_with_nothing_to_read_returns_none(name):
    t = trace(spans={"ingest": [0.01]}, device=None, dispatched=0, least_verify_s=None,
              latencies_s=[])
    assert cellrun.read_metric(name, t) is None


def test_union_and_segments():
    us = 1000
    ev = [("k1", 0, 10), ("spin_kernel", 12, 13), ("k2", 14, 20), ("k3", 18, 25),
          ("spin_kernel", 30, 30 + 10 * us), ("k4", 20 * us, 20 * us + 10)]
    s = devtrace.summarise(ev, ["host", "verify", "host"], "spin_kernel")
    assert s["busy_s"] == pytest.approx((10 + 11 + 10) / 1e9)
    assert s["by_label_s"] == {"host": pytest.approx(20e-9), "verify": pytest.approx(11e-9)}
    assert s["markers"] == 2 == s["markers_launched"] and s["unplaced_s"] == 0


def _marked(durations_us, lose=()):
    """Markers short and long in turn, each followed by 40 us of work."""
    ev, t = [("w", 0, 40_000)], 50_000
    for k, d in enumerate(durations_us):
        if k not in lose:
            ev.append(("spin_kernel", t, t + d * 1000))
        ev.append(("w", t + 20_000, t + 60_000))
        t += 100_000
    return ev


@pytest.mark.parametrize("lose, unplaced_us", [((), 0), ((2,), 80), ((3,), 80), ((4,), 80)])
def test_lost_marker_keeps_the_others_in_place(lose, unplaced_us):
    """Five markers, segment labels a b c d e f; a lost marker leaves the
    work of the two segments it parted unplaced and every other segment
    where it was; the last one lost leaves the work after it unplaced."""
    labels = ["a", "b", "c", "d", "e", "f"]
    s = devtrace.summarise(_marked([1, 10, 1, 10, 1], lose), labels, "spin_kernel")
    assert s["markers"] == 5 - len(lose) and s["markers_launched"] == 5
    assert s["unplaced_s"] == pytest.approx(unplaced_us * 1e-6)
    want = {lab: 40e-6 for lab in labels}
    for k in lose:
        want.pop(labels[k]), want.pop(labels[k + 1])
    assert s["by_label_s"] == pytest.approx(want)


def test_markers_that_do_not_add_up_cut_nothing():
    labels = ["a", "b", "c", "d", "e", "f"]
    # two lost in a row: the parity holds, the count does not
    s = devtrace.summarise(_marked([1, 10, 1, 10, 1], (1, 2)), labels, "spin_kernel")
    assert s["by_label_s"] is None


def test_work_bounds():
    k4 = work.k4({"m": 1024, "n": 1024, "rows": 500, "cols": 600})
    assert k4 == pytest.approx(max((2048 * 33 + 4096) / work.HBM_BYTES_S,
                                   2.0 * 500 * 600 * 256 / work.INT8_OPS_S))
    s = {"n": 1024, "rows_given": True, "noise": True, "h": 300, "valid": 400,
         "valid_poses": 700}
    assert work.k6(s) > 0
    rec = [("K4", {"m": 1024, "n": 1024, "rows": 500, "cols": 600})]
    assert work.least_seconds(rec) == pytest.approx(k4)
