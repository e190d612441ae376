"""The port's project-and-match against the JAX package.

The three cases of the JAX package's own tests (exact self-matches with a
point behind the camera, the distance-invariance gate, feature conflicts)
and a random case with distortion, view-angle and octave gates, ties and
conflicts, each on the same numpy inputs.  Tolerance: `match_feat`
exactly, and the matched distances exactly (integer Hamming distances in
float32).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from covins_tpu.ops import projmatch as ref_pm
from covins_tpu.utils import cameras as ref_cam
from covins_tpu.utils import geometry as ref_geo
from covins_tpu_torch.ops import projmatch
from covins_tpu_torch.utils import cameras as cam

INTR = [458.0, 457.0, 376.0, 240.0, 0.0]


def _cams(dist=(0.0, 0.0, 0.0, 0.0), T_s_c=None):
    T_s_c = np.asarray([1.0, 0, 0, 0, 0, 0, 0] if T_s_c is None else T_s_c)
    rc = ref_cam.Camera(jnp.asarray(INTR), jnp.asarray(dist), jnp.asarray(T_s_c),
                        ref_cam.PINHOLE, ref_cam.RADTAN)
    pc = cam.Camera(torch.tensor(INTR, dtype=torch.float64),
                    torch.tensor(dist, dtype=torch.float64),
                    torch.tensor(T_s_c), cam.PINHOLE, cam.RADTAN)
    return rc, pc


def _both(T_cw, p_w, lm_desc, lm_normal, lm_mask, kp_uv, kp_desc, kp_oct,
          kp_free, radius, max_dist, check_view_angle, lm_dist_rng=None,
          dist=(0.0, 0.0, 0.0, 0.0)):
    rc, pc = _cams(dist)
    ref = ref_pm.project_match(
        rc, jnp.asarray(T_cw), jnp.asarray(p_w), jnp.asarray(lm_desc),
        jnp.asarray(lm_normal), jnp.asarray(lm_mask), jnp.asarray(kp_uv),
        jnp.asarray(kp_desc), jnp.asarray(kp_oct), jnp.asarray(kp_free),
        radius_px=radius, max_dist=max_dist, img_w=752, img_h=480,
        check_view_angle=check_view_angle,
        lm_dist_rng=None if lm_dist_rng is None else jnp.asarray(lm_dist_rng))
    got = projmatch.project_match(
        pc, torch.tensor(T_cw), torch.tensor(p_w), torch.tensor(lm_desc),
        torch.tensor(lm_normal), torch.tensor(lm_mask), torch.tensor(kp_uv),
        torch.tensor(kp_desc), torch.tensor(kp_oct), torch.tensor(kp_free),
        radius, max_dist, 752, 480, check_view_angle=check_view_angle,
        lm_dist_rng=None if lm_dist_rng is None else torch.tensor(lm_dist_rng))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    return got[0].numpy()


def _project(p_c):
    rc, _ = _cams()
    return np.asarray(ref_cam.project3(rc, jnp.asarray(p_c))[0])


def test_exact_matches_and_point_behind_camera():
    rng = np.random.default_rng(3)
    L = 32
    p_c = np.stack([rng.uniform(-1.5, 1.5, L), rng.uniform(-0.8, 0.8, L),
                    rng.uniform(2.0, 8.0, L)], axis=1)
    uv = _project(p_c)
    ok = (uv[:, 0] > 5) & (uv[:, 0] < 747) & (uv[:, 1] > 5) & (uv[:, 1] < 475)
    descs = rng.integers(0, 256, (L, 32)).astype(np.uint8)
    T_cw = np.asarray([1.0, 0, 0, 0, 0, 0, 0])
    args = (descs, np.zeros((L, 3)), ok, uv, descs, np.zeros(L), np.ones(L, bool),
            5.0, 20.0, False)
    match = _both(T_cw, p_c, *args)
    assert (match[ok] == np.arange(L)[ok]).all()
    p_bad = p_c.copy()
    p_bad[0, 2] = -3.0
    assert _both(T_cw, p_bad, *args)[0] == -1


def test_distance_invariance_gate():
    rng = np.random.default_rng(5)
    L = 8
    p_c = np.stack([rng.uniform(-0.5, 0.5, L), rng.uniform(-0.4, 0.4, L),
                    np.full(L, 5.0)], axis=1)
    uv = _project(p_c)
    descs = rng.integers(0, 256, (L, 32)).astype(np.uint8)
    T_cw = np.asarray([1.0, 0, 0, 0, 0, 0, 0])
    dists = np.linalg.norm(p_c, axis=1)
    for rng_arr, want in ((np.stack([dists / 1.2 ** 7, dists], 1), np.arange(L)),
                          (np.stack([dists / 100.0 / 1.2 ** 7, dists / 100.0], 1),
                           np.full(L, -1)),
                          (np.zeros((L, 2)), np.arange(L))):
        got = _both(T_cw, p_c, descs, np.zeros((L, 3)), np.ones(L, bool), uv, descs,
                    np.zeros(L), np.ones(L, bool), 5.0, 20.0, False,
                    lm_dist_rng=rng_arr)
        np.testing.assert_array_equal(got, want)


def test_conflict_resolution():
    p_c = np.asarray([[0.0, 0.0, 4.0], [0.001, 0.0, 4.0]])
    uv = _project(p_c[:1])
    d_lm = np.zeros((2, 32), np.uint8)
    d_lm[1, 0] = 0xFF  # 8 bits worse
    got = _both(np.asarray([1.0, 0, 0, 0, 0, 0, 0]), p_c, d_lm, np.zeros((2, 3)),
                np.ones(2, bool), uv, np.zeros((1, 32), np.uint8), np.zeros(1),
                np.ones(1, bool), 8.0, 50.0, False)
    np.testing.assert_array_equal(got, [0, -1])


@pytest.mark.parametrize("check_view_angle", [False, True])
def test_random_scene_with_every_gate(check_view_angle):
    rng = np.random.default_rng(9 + check_view_angle)
    L, F = 700, 300
    T_cw = np.concatenate([[0.995, 0.05, -0.06, 0.03], [0.2, -0.1, 0.3]])
    T_cw[:4] /= np.linalg.norm(T_cw[:4])
    p_w = np.stack([rng.uniform(-3, 3, L), rng.uniform(-2, 2, L),
                    rng.uniform(-1, 9, L)], axis=1)
    normals = rng.normal(size=(L, 3))
    normals[::5] = 0.0  # no normal: the view-angle gate is skipped
    lm_desc = rng.integers(0, 256, (L, 32)).astype(np.uint8)
    # features near some landmark projections, sharing their descriptors
    # (a few flipped bits), plus duplicates that tie
    p_c = np.asarray(ref_geo.pose_apply(jnp.asarray(T_cw), jnp.asarray(p_w)))
    uv_l = _project(np.where(p_c[:, 2:] > 0.1, p_c, 1.0))
    src = rng.choice(L, F)
    kp_uv = uv_l[src] + rng.normal(scale=3.0, size=(F, 2))
    kp_desc = lm_desc[src].copy()
    flip = rng.integers(0, 32, F)
    kp_desc[np.arange(F), flip] ^= rng.integers(0, 256, F).astype(np.uint8)
    kp_desc[1::7] = kp_desc[0::7][: len(kp_desc[1::7])]
    kp_uv[1::7] = kp_uv[0::7][: len(kp_uv[1::7])]
    lm_desc[1::11] = lm_desc[0::11][: len(lm_desc[1::11])]
    kp_oct = rng.integers(0, 4, F).astype(np.float64)
    d = np.linalg.norm(p_w - np.asarray(ref_geo.pose_inverse(jnp.asarray(T_cw)))[4:],
                       axis=1)
    rng_arr = np.stack([d / 1.2 ** rng.integers(0, 8, L), d * rng.uniform(0.5, 2, L)], 1)
    rng_arr[::3] = 0.0
    got = _both(T_cw, p_w, lm_desc, normals, rng.random(L) > 0.1, kp_uv, kp_desc,
                kp_oct, rng.random(F) > 0.1, 6.0, 50.0, check_view_angle,
                lm_dist_rng=rng_arr, dist=(-0.28, 0.07, 0.0002, 0.00002))
    assert (got >= 0).sum() > 10
