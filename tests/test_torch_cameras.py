"""The port's projection Jacobian against the JAX package's forward-mode AD.

`cameras.project3_jacobian` writes out the derivative of `project3` that
the reference takes with ``jax.jacfwd`` (relative-pose refinement, GBA).
Every camera model and distortion the port supports is held to the
reference's ``jacfwd`` of its own ``project3`` at the same points, to 1e-10
relative to the largest entry (both are exact derivatives; they round
apart where the two libraries order a short sum or the distortion's
formula differently), including points where the projection is invalid
(behind a pinhole camera, behind the unified model's mirror, at the
camera centre): there the reference divides by a constant 1.  Pixels and
validity are held to the reference's ``project3`` likewise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from covins_tpu.ops import residuals as ref_residuals
from covins_tpu.utils import cameras as ref_cam
from covins_tpu_torch.ops import residuals
from covins_tpu_torch.utils import cameras as cam

# (camera model, distortion model, distortion parameters): the scene
# cameras of `covins_tpu_torch.utils.synthetic.SCENE_CAMERAS` and the FOV
# model
CASES = {
    "omni_radtan": (cam.OMNI, cam.RADTAN, (-0.1, 0.01, 1e-4, 1e-5)),
    "omni_none": (cam.OMNI, cam.DIST_NONE, (0.0, 0.0, 0.0, 0.0)),
    "pinhole_equidistant": (cam.PINHOLE, cam.EQUIDISTANT, (0.01, -0.002, 0.0, 0.0)),
    "pinhole_fov": (cam.PINHOLE, cam.FISHEYE, (0.9, 0.0, 0.0, 0.0)),
    "pinhole_radtan": (cam.PINHOLE, cam.RADTAN, (-0.28, 0.07, 2e-4, 2e-5)),
}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _points(rng, n=400):
    p = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n), rng.uniform(0.5, 9, n)], 1)
    p[:20, 2] = -p[:20, 2]  # behind the camera: invalid for a pinhole camera
    p[20:25] = [[0.0, 0.0, -1.0], [0.1, 0.0, -2.0], [0.0, 0.05, -0.5],
                [0.0, 0.0, 0.0], [1e-9, 0.0, 0.0]]  # behind the mirror, at the centre
    return p


@pytest.mark.parametrize("case", list(CASES))
def test_project3_jacobian_matches_reference_jacfwd(case):
    model, dist_model, dist = CASES[case]
    intr = np.asarray([458.0, 457.0, 376.0, 240.0, 0.9])
    T_s_c = np.asarray([1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0])
    p = _points(np.random.default_rng(len(case)))
    rc = ref_cam.Camera(jnp.asarray(intr), jnp.asarray(dist, jnp.float64),
                        jnp.asarray(T_s_c), model, dist_model)
    pc = cam.Camera(torch.tensor(intr), torch.tensor(dist, dtype=torch.float64),
                    torch.tensor(T_s_c), model, dist_model)
    ref_uv, ref_valid = ref_cam.project3(rc, jnp.asarray(p))
    ref_J = jax.vmap(jax.jacfwd(lambda x: ref_cam.project3(rc, x)[0]))(jnp.asarray(p))
    uv, valid, J = cam.project3_jacobian(pc, torch.tensor(p))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(ref_valid))
    assert 0 < int(valid.sum()) < len(p)
    assert _rel(uv.numpy(), ref_uv) <= 1e-10
    assert _rel(J.numpy(), ref_J) <= 1e-10
    # the invalid points' derivative is the reference's, row by row
    inv = ~valid.numpy()
    assert _rel(J.numpy()[inv], np.asarray(ref_J)[inv]) <= 1e-10


@pytest.mark.parametrize("case", list(CASES))
def test_undistort_keypoints_and_project_world_match_reference(case):
    """`undistort_keypoints` and `project_world` of every camera model, and
    `make_pinhole_radtan` (and the fixed loop-edge weights of the
    residuals module), against the reference: 1e-10 relative."""
    model, dist_model, dist = CASES[case]
    intr = np.asarray([458.0, 457.0, 376.0, 240.0, 0.9])
    rng = np.random.default_rng(len(case) + 1)
    q = rng.normal(size=4)
    T_s_c = np.concatenate([q / np.linalg.norm(q), rng.normal(size=3) * 0.1])
    rc = ref_cam.Camera(jnp.asarray(intr), jnp.asarray(dist, jnp.float64),
                        jnp.asarray(T_s_c), model, dist_model)
    pc = cam.Camera(torch.tensor(intr), torch.tensor(dist, dtype=torch.float64),
                    torch.tensor(T_s_c), model, dist_model)
    uv = np.stack([rng.uniform(50, 700, 200), rng.uniform(40, 440, 200)], 1)
    assert _rel(cam.undistort_keypoints(pc, torch.tensor(uv)).numpy(),
                ref_cam.undistort_keypoints(rc, jnp.asarray(uv))) <= 1e-10
    T_w_s = np.concatenate([[1.0, 0.0, 0.0, 0.0], rng.normal(size=3)])
    p_w = T_w_s[4:] + _points(rng)
    uv_p, valid = cam.project_world(pc, torch.tensor(T_w_s), torch.tensor(p_w))
    ref_uv, ref_valid = ref_cam.project_world(rc, jnp.asarray(T_w_s), jnp.asarray(p_w))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(ref_valid))
    assert _rel(uv_p.numpy(), ref_uv) <= 1e-10
    made = cam.make_pinhole_radtan(458.0, 457.0, 376.0, 240.0, dist[:3])
    ref_made = ref_cam.make_pinhole_radtan(458.0, 457.0, 376.0, 240.0, dist[:3])
    for a, b in ((made.intrinsics, ref_made.intrinsics), (made.dist, ref_made.dist),
                 (made.T_s_c, ref_made.T_s_c)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert (made.cam_model, made.dist_model) == (ref_made.cam_model, ref_made.dist_model)
    np.testing.assert_array_equal(residuals.loop_sqrt_info_fixed().numpy(),
                                  np.asarray(ref_residuals.loop_sqrt_info_fixed()))
