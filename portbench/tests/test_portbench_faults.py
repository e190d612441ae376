"""The comparison that decides `correct`, on a small cell on the CPU: a
sound run passes; the control (the reference one precision lower in the
program's place) fails a limit; and a run with the timed path broken
underneath comes out not correct, for each fault the cells can have."""

import time

import numpy as np
import pytest
import torch

from portbench import control
from portbench.harness import cellrun, check, drive

SEED = 4_000_000_007


def tiny(name):
    """The cell at a size the CPU runs in seconds: three agents, a smaller
    world, 400 features, 256 words; every threshold and limit as the
    cell's."""
    cell = drive.load_cell(name)
    cell.config["agents"] = cell.config["agents"][:3]
    cell.config["world"]["landmarks"] = 1500
    cell.config["frontend"]["max_features"] = 400
    cell.config["vocabulary"]["words"] = 256
    return cell


def run(cell, seconds=8.0):
    torch.set_num_threads(2)
    return cellrun.run(cell, SEED, seconds, False, "cpu", time.perf_counter(), warm=False)


@pytest.mark.parametrize("name", ["covins5.stream", "covinsg5.stream"])
def test_sound_run_passes_and_control_fails(name):
    cell = tiny(name)
    result, readings, cap, ref = run(cell)
    assert result["correct"], result["checks"]
    assert any(r["out"]["ok"] for r in cap["loops"]), "no loop accepted: nothing judged"
    prog, ctrl = control.readings(cell, cap, ref, torch.bfloat16, torch.float32, "cpu")
    assert prog == readings
    ok, rows = check.verdict(ctrl, cell.config["limits"])
    assert not ok
    failed = {k for k, v, lim in rows if v > lim}
    assert {"bow_vec_gap", "bow_score_gap", "attr_gap"} <= failed
    if cell.mode == "COVINS":
        assert "loop_T_gap" in failed


def _no_insert(monkeypatch):
    """A step that leaves its state unchanged: the database keeps no row."""
    from covins_tpu_torch.ops import bow
    orig = bow.bow_insert_score

    def fault(words, dest, db, n):
        return orig(words, torch.full_like(dest, db.shape[0]), db, n)
    monkeypatch.setattr(bow, "bow_insert_score", fault)


def _stale_attributes(monkeypatch):
    """A step that leaves its state unchanged: the refresh writes back the
    landmarks' attributes unrefreshed (zeros)."""
    from covins_tpu_torch.ops import landmark_ops
    orig = landmark_ops.landmark_attributes

    def fault(packed, L, P, *a, **k):
        return torch.zeros_like(orig(packed, L, P, *a, **k))
    monkeypatch.setattr(landmark_ops, "landmark_attributes", fault)


def _half_batch(monkeypatch):
    """Half of the batch left out, the mean taken over the rest: each
    keyframe's vector made of every other feature."""
    from covins_tpu_torch.ops import bow
    orig = bow.bow_insert_score

    def fault(words, dest, db, n):
        words = words.clone()
        words[:, 1::2] = -1
        return orig(words, dest, db, n)
    monkeypatch.setattr(bow, "bow_insert_score", fault)


def _altered_score(monkeypatch):
    """An answer altered where it is produced: a retrieval score."""
    from covins_tpu_torch.models import kf_database
    orig = kf_database.insert_and_score

    def fault(*a):
        out = orig(*a)
        out[:, 0] += 1e-3
        return out
    monkeypatch.setattr(kf_database, "insert_and_score", fault)


def _altered_loop(monkeypatch):
    """An answer altered where it is produced: the verification's loop
    transform (COVINS) or a keyframe pair's match count (COVINS-G)."""
    from covins_tpu_torch.ops import loopverify
    f1, f2 = loopverify.fetch_covins_verify, loopverify.fetch_covinsg_verify

    def covins(job):
        out = f1(job)
        out["T_12"] = out["T_12"] + np.asarray([0, 0, 0, 0, 1e-4, 0, 0])
        return out

    def covinsg(job):
        out = f2(job)
        out["pair_n_match"] = out["pair_n_match"] + 1
        return out
    monkeypatch.setattr(loopverify, "fetch_covins_verify", covins)
    monkeypatch.setattr(loopverify, "fetch_covinsg_verify", covinsg)


def _unchanged_poses(monkeypatch):
    """A step that leaves its state unchanged: the pose-graph solve returns
    the poses it started from."""
    from covins_tpu_torch.ops import pgo
    orig = pgo.optimize_pose_graph

    def fault(g, *a, **k):
        _, cost = orig(g, *a, **k)
        return g.poses.clone(), cost
    monkeypatch.setattr(pgo, "optimize_pose_graph", fault)


def _uncorrected(monkeypatch):
    """A step that leaves its state unchanged: a loop's correction seeds the
    pose graph with the poses as they were."""
    from covins_tpu_torch.models.map_manager import MapManager

    def fault(mgr, mp, q_row, c_row, T_12):
        return mp.kf_pose[: mp.n_kf].copy()
    monkeypatch.setattr(MapManager, "_corrected_poses", fault)


def _never_accepts(monkeypatch):
    """An answer altered where it is produced: no verification accepts."""
    from covins_tpu_torch.models.placerec import PlaceRecognition
    orig = PlaceRecognition.finalize_verify

    def fault(pr, tagged):
        orig(pr, tagged)
        return None
    monkeypatch.setattr(PlaceRecognition, "finalize_verify", fault)


def _half_matches(monkeypatch):
    """Half of the batch left out: every other match of the projection
    searches (COVINS's stages 3 and 5; K5) dropped."""
    from covins_tpu_torch.ops import loopverify
    orig = loopverify.project_match_core

    def fault(*a, **k):
        feat, dist = orig(*a, **k)
        feat = feat.clone()
        feat[1::2] = -1
        return feat, dist
    monkeypatch.setattr(loopverify, "project_match_core", fault)


FAULTS = [_no_insert, _stale_attributes, _half_batch, _altered_score, _altered_loop,
          _unchanged_poses, _uncorrected, _never_accepts]


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("name", ["covins5.stream", "covinsg5.stream"])
def test_broken_path_is_not_correct(monkeypatch, name, fault):
    fault(monkeypatch)
    # with no row in the database nothing is verified, and the streams
    # would run out in a longer window
    result, _, _, _ = run(tiny(name), seconds=1.5 if fault is _no_insert else 5.0)
    assert not result["correct"], result["checks"]


def test_half_matches_is_not_correct(monkeypatch):
    """COVINS alone searches by projection."""
    _half_matches(monkeypatch)
    result, _, _, _ = run(tiny("covins5.stream"), seconds=5.0)
    assert not result["correct"], result["checks"]
