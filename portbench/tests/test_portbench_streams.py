"""The traffic: deterministic by seed, a prefix independent of the stream's
length, and independent of the program's own generator."""

import ast

import numpy as np

from covins_tpu_torch.comm import messages as msgs
from portbench.harness import world
from portbench.harness.drive import PB

CAMERA = {"intrinsics": [458.0, 457.0, 376.0, 240.0, 0.0], "dist": [0.0] * 4,
          "T_s_c": [0.5, -0.5, 0.5, -0.5, 0.0, 0.0, 0.0], "img_w": 752, "img_h": 480}
AGENTS = [{"keyframes": 20, "t0": 0.0}, {"keyframes": 20, "t0": 5.0}]
TRAFFIC = {"kf_dt": 0.5, "px_noise": 0.3, "desc_bit_flips": 4, "pose_drift": 0.02,
           "max_features": 300}


def build(seed, built):
    """Each agent's stream at ``built`` keyframes."""
    w = world.World.create(11, 800, 32, CAMERA)
    agents = [dict(a, keyframes=built) for a in AGENTS]
    return w, world.build_streams(w, agents, seed, TRAFFIC, msgs)


def same(a, b):
    return all(np.array_equal(getattr(a, f), getattr(b, f)) if isinstance(
        getattr(a, f), np.ndarray) else getattr(a, f) == getattr(b, f)
        for f in ("id", "descriptors", "keypoints", "landmark_ids", "T_w_s_vio"))


def test_deterministic_by_seed_and_prefix():
    big = 3_000_000_019
    _, s1 = build(big, 8)
    _, s2 = build(big, 8)
    _, s3 = build(big, 5)
    _, other = build(big + 1, 8)
    for a in range(2):
        assert all(same(x[0], y[0]) for x, y in zip(s1[a], s2[a]))
        assert all(same(x[0], y[0]) for x, y in zip(s1[a][:5], s3[a]))
        assert not same(s1[a][3][0], other[a][3][0])
    assert len(s1[0]) == 8 and len(s3[1]) == 5


def test_bundles_are_keyframe_then_its_landmarks():
    _, s = build(7, 6)
    for stream in s:
        for k, bundle in enumerate(stream):
            assert isinstance(bundle[0], msgs.MsgKeyframe) and bundle[0].id[0] == k
            assert all(isinstance(m, msgs.MsgLandmark) for m in bundle[1:])
            kf = bundle[0]
            assert kf.descriptors.shape == (len(kf.keypoints), 32)
            assert len(kf.keypoints) <= TRAFFIC["max_features"]
    assert len(s[0][0]) > 1  # the first keyframe mints landmarks


def test_generator_is_frozen_copy():
    """The generator imports nothing of the program but its message classes,
    which the caller hands it."""
    for name in ("world.py", "geo.py", "vocab.py"):
        tree = ast.parse((PB / "harness" / name).read_text())
        mods = {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
        mods |= {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
        assert not any(m and m.split(".")[0] in ("covins_tpu_torch", "covins_tpu", "jax")
                       for m in mods), (name, mods)


def test_trajectory_imu_matches_numerical_derivatives():
    t, poses, vels, acc, gyro, dts = world.trajectory(4, 0.5, 2.0)
    h = 1e-5
    p1 = world._position(np.asarray([2.0 + h]))[0]
    p0 = world._position(np.asarray([2.0 - h]))[0]
    assert np.allclose((p1 - p0) / (2 * h), vels[0][None], atol=1e-6)
    assert acc.shape == (3, 100, 3) and gyro.shape == (3, 100, 3)
    assert np.allclose(dts, 0.005)
