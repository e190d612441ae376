"""The port's geometry, small linear algebra, polynomial roots and camera
model against the JAX package, on the same numpy inputs (float64, x64).

Tolerances: 1e-10 absolute for every float64 result (both packages run
the same formulas; only the rounding of library kernels such as norms and
transcendental functions differs, at the 1e-15 level).  Quartic roots are
compared where both packages call them real, on well-conditioned
polynomials.  Eigenvectors are compared up to nothing: the Jacobi solver
is the reference's, so even their signs agree.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from covins_tpu.ops import linalg as ref_la
from covins_tpu.ops import polynomial as ref_poly
from covins_tpu.utils import cameras as ref_cam
from covins_tpu.utils import geometry as ref_geo
from covins_tpu_torch.ops import linalg as la
from covins_tpu_torch.ops import polynomial as poly
from covins_tpu_torch.utils import cameras as cam
from covins_tpu_torch.utils import geometry as geo

TOL = 1e-10


def _poses(rng, n):
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return np.concatenate([q, rng.normal(size=(n, 3))], axis=1)


def _close(got, ref, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=0, atol=tol)


@pytest.mark.parametrize("name", ["pose_compose", "pose_relative"])
def test_pose_binary_ops(name):
    rng = np.random.default_rng(0)
    a, b = _poses(rng, 64), _poses(rng, 64)
    got = getattr(geo, name)(torch.tensor(a), torch.tensor(b))
    _close(got, getattr(ref_geo, name)(jnp.asarray(a), jnp.asarray(b)))


@pytest.mark.parametrize("name", ["pose_inverse", "quat_to_matrix_of_pose",
                                  "se3_log", "quat_log_of_pose"])
def test_pose_unary_ops(name):
    rng = np.random.default_rng(1)
    p = _poses(rng, 64)
    fn = {"quat_to_matrix_of_pose": lambda m, x: m.quat_to_matrix(x[..., :4]),
          "quat_log_of_pose": lambda m, x: m.quat_log(x[..., :4])}.get(
        name, lambda m, x: getattr(m, name)(x))
    _close(fn(geo, torch.tensor(p)), fn(ref_geo, jnp.asarray(p)))


def test_se3_exp_boxplus_boxminus_and_apply():
    rng = np.random.default_rng(2)
    p, q = _poses(rng, 32), _poses(rng, 32)
    xi = rng.normal(size=(32, 6)) * 0.3
    xi[0] = 0.0  # the small-angle branches
    xi[1, :3] = 1e-8
    x = rng.normal(size=(32, 3))
    _close(geo.se3_exp(torch.tensor(xi)), ref_geo.se3_exp(jnp.asarray(xi)))
    _close(geo.pose_boxplus(torch.tensor(p), torch.tensor(xi)),
           ref_geo.pose_boxplus(jnp.asarray(p), jnp.asarray(xi)))
    _close(geo.pose_boxminus(torch.tensor(p), torch.tensor(q)),
           ref_geo.pose_boxminus(jnp.asarray(p), jnp.asarray(q)))
    _close(geo.pose_apply(torch.tensor(p), torch.tensor(x)),
           ref_geo.pose_apply(jnp.asarray(p), jnp.asarray(x)))
    g = np.concatenate([p, rng.uniform(0.5, 2.0, (32, 1))], axis=1)
    _close(geo.sim3_apply(torch.tensor(g), torch.tensor(x)),
           ref_geo.sim3_apply(jnp.asarray(g), jnp.asarray(x)))


def test_jacobi_eigh_matches_reference():
    rng = np.random.default_rng(3)
    A = rng.normal(size=(50, 4, 4))
    A = A + np.swapaxes(A, -1, -2)
    w, V = la.jacobi_eigh(torch.tensor(A))
    rw, rV = ref_la.jacobi_eigh(jnp.asarray(A))
    _close(w, rw)
    _close(V, rV)


def test_small_spd_solves_match_reference():
    rng = np.random.default_rng(4)
    B = rng.normal(size=(20, 6, 6))
    A = B @ np.swapaxes(B, -1, -2) + 0.5 * np.eye(6)
    b = rng.normal(size=(20, 6))
    _close(la.cholesky_small(torch.tensor(A)), ref_la.cholesky_small(jnp.asarray(A)))
    _close(la.solve_psd_small(torch.tensor(A), torch.tensor(b)),
           ref_la.solve_psd_small(jnp.asarray(A), jnp.asarray(b)))
    _close(la.inv_psd_small(torch.tensor(A)), ref_la.inv_psd_small(jnp.asarray(A)))
    C = rng.normal(size=(20, 3, 3)) + 3 * np.eye(3)
    _close(la.inv33(torch.tensor(C)), ref_la.inv33(jnp.asarray(C)))


@pytest.mark.parametrize("with_scale", [False, True])
def test_umeyama_alignment_matches_reference(with_scale):
    rng = np.random.default_rng(5)
    src = rng.normal(size=(12, 3))
    g = np.concatenate([_poses(rng, 1)[0], [1.7 if with_scale else 1.0]])
    dst = np.array(ref_geo.sim3_apply(jnp.asarray(g), jnp.asarray(src)))
    dst += 1e-3 * rng.normal(size=dst.shape)
    got = geo.umeyama_alignment(torch.tensor(src), torch.tensor(dst),
                                with_scale=with_scale)
    ref = ref_geo.umeyama_alignment(jnp.asarray(src), jnp.asarray(dst),
                                    with_scale=with_scale)
    _close(got, ref)
    # batched over leading dims, as P3P calls it
    both = geo.umeyama_alignment(torch.tensor(np.stack([src, src])),
                                 torch.tensor(np.stack([dst, dst])),
                                 with_scale=with_scale)
    _close(both[1], ref)


def test_solve_quartic_matches_reference():
    rng = np.random.default_rng(6)
    # polynomials with known real roots, plus random ones
    r = rng.uniform(-3, 3, (40, 4))
    coeffs = np.stack([np.poly(x) for x in r]) * rng.uniform(0.5, 2, (40, 1))
    coeffs = np.concatenate([coeffs, rng.normal(size=(40, 5))])
    got, got_real = poly.solve_quartic(*(torch.tensor(coeffs[:, i]) for i in range(5)))
    ref, ref_real = ref_poly.solve_quartic(*(jnp.asarray(coeffs[:, i]) for i in range(5)))
    np.testing.assert_array_equal(got_real.numpy(), np.asarray(ref_real))
    polished = poly.polish_real_roots(torch.tensor(coeffs), got)
    ref_pol = ref_poly.polish_real_roots(jnp.asarray(coeffs), ref)
    ok = np.asarray(ref_real)
    _close(polished.numpy()[ok], np.asarray(ref_pol)[ok], tol=1e-9)
    _close(got.numpy()[:40], np.asarray(ref)[:40], tol=1e-9)


@pytest.mark.parametrize("dist_model", [ref_cam.DIST_NONE, ref_cam.RADTAN,
                                        ref_cam.EQUIDISTANT])
def test_undistort_and_back_project_match_reference(dist_model):
    rng = np.random.default_rng(7)
    intr = np.asarray([458.654, 457.296, 367.215, 248.375, 0.0])
    dist = {ref_cam.DIST_NONE: [0, 0, 0, 0],
            ref_cam.RADTAN: [-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05],
            ref_cam.EQUIDISTANT: [0.01, -0.002, 0.001, 0.0]}[dist_model]
    dist = np.asarray(dist, np.float64)
    T_s_c = _poses(rng, 1)[0]
    uv = np.stack([rng.uniform(0, 752, 200), rng.uniform(0, 480, 200)], 1)
    rc = ref_cam.Camera(jnp.asarray(intr), jnp.asarray(dist), jnp.asarray(T_s_c),
                        ref_cam.PINHOLE, dist_model)
    pc = cam.Camera(torch.tensor(intr), torch.tensor(dist), torch.tensor(T_s_c),
                    cam.PINHOLE, dist_model)
    xy = (uv - intr[2:4]) / intr[:2]
    _close(cam.undistort(dist_model, torch.tensor(dist), torch.tensor(xy)),
           ref_cam.undistort(dist_model, jnp.asarray(dist), jnp.asarray(xy)))
    b = cam.back_project3(pc, torch.tensor(uv))
    _close(b, ref_cam.back_project3(rc, jnp.asarray(uv)))
    # and projecting the bearings returns the pixels
    p_uv, valid = cam.project3(pc, b)
    r_uv, r_valid = ref_cam.project3(rc, jnp.asarray(b.numpy()))
    _close(p_uv, r_uv, tol=1e-8)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(r_valid))
