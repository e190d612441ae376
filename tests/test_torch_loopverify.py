"""The port's five-stage COVINS loop verification against the JAX package.

Both packages ingest the same synthetic stream (the JAX package's agent,
30 keyframes circling 500 landmarks, place recognition off), so their maps
are equal; then each verifies the same (query, candidate) keyframe pairs
with `dispatch_covins_verify`.  The stage-2 RANSAC draws of the JAX call
(`sample_minimal_sets` under the key the JAX call uses) are injected into
the port.  Tolerances: the accept flag, every count and the per-row
results of stages 1, 3 and 5 (`midx`, `mfeat`, `hfeat`) exactly; the
refined T_12 to 1e-9 (float64 GN with the same steps; the port's
Jacobian is written out where the reference differentiates, which moves
the last bits).  The relative-pose refinement alone is checked the same
way, to 1e-9, and the written-out Jacobian against torch.func's
forward-mode AD of the same residual, to 1e-12 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from covins_tpu.agents.synthetic_agent import SyntheticAgent, SyntheticWorld
from covins_tpu.models.map_manager import MapManager as RefManager
from covins_tpu.models.placerec import _camera_of as ref_camera_of
from covins_tpu.models.session import AgentSession as RefSession
from covins_tpu.ops import bow as ref_bow
from covins_tpu.ops import loopverify as ref_lv
from covins_tpu.ops import ransac as ref_ransac
from covins_tpu.ops import relpose as ref_relpose
from covins_tpu.ops import residuals as ref_residuals
from covins_tpu.utils import cameras as ref_cam
from covins_tpu.utils import geometry as ref_geo
from covins_tpu.utils.config import Config as RefConfig
from covins_tpu_torch.models.map_manager import MapManager
from covins_tpu_torch.models.session import AgentSession
from covins_tpu_torch.ops import loopverify, relpose, residuals
from covins_tpu_torch.state import messages_from_reference
from covins_tpu_torch.utils import cameras as cam
from covins_tpu_torch.utils import geometry as geo
from covins_tpu_torch.utils.config import Config

CFG = dict(placerec_type="COVINS", matches_thres=12, matches_thres_merge=12,
           inliers_thres=12, ransac_min_inliers=5, activate_lm_culling=False,
           placerec_active=False)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def maps():
    world = SyntheticWorld.create(n_landmarks=500, seed=1)
    vocab = np.asarray(ref_bow.train_vocabulary(jnp.asarray(world.lm_descs),
                                                k=128, iters=4))
    msgs = list(SyntheticAgent(world, client_id=0, n_keyframes=30).messages())
    ref_mgr = RefManager(vocab, RefConfig(**CFG))
    ref_s = RefSession(0, ref_mgr, RefConfig(**CFG))
    ref_s.ingest_many(msgs)
    ref_s.flush()
    mgr = MapManager(vocab, Config(**CFG), device="cpu")
    s = AgentSession(0, mgr, Config(**CFG))
    s.ingest_many(messages_from_reference(msgs))
    s.flush()
    return ref_mgr.map_of(0), mgr.map_of(0)


@pytest.mark.parametrize("q_row,c_row", [(19, 5), (21, 5), (13, 2), (25, 9)])
def test_verification_matches_reference(maps, q_row, c_row):
    ref_mp, mp = maps
    np.testing.assert_array_equal(mp.kf_pose, ref_mp.kf_pose)
    rcfg = RefConfig(**CFG)
    key = jax.random.PRNGKey(q_row * 100 + c_row)
    meta, ref_out = ref_lv.dispatch_covins_verify(
        key, ref_mp, q_row, ref_mp, c_row, rcfg, ref_camera_of(ref_mp, 0),
        ref_camera_of(ref_mp, 0))
    ref_out = jax.device_get(ref_out)
    # the stage-2 index sets the JAX call drew
    F = ref_mp.max_features
    matched = (ref_out["midx"] >= 0) & (np.arange(F) < meta["nq"])
    idx = ref_ransac.sample_minimal_sets(
        key, jnp.asarray(matched), min(rcfg.ransac_max_iterations, 512), 3)

    cam_q = cam.camera_from_calibration(mp.calib[0], "cpu")
    job = loopverify.dispatch_covins_verify(mp, q_row, mp, c_row, Config(**CFG),
                                            cam_q, cam_q, idx=np.asarray(idx))
    out = loopverify.fetch_covins_verify(job)
    for k in ("n_matched", "n_inl2", "n_inl4", "n_total"):
        assert out[k] == int(ref_out[k]), k
    assert out["ok"] == bool(ref_out["ok"])
    np.testing.assert_array_equal(out["midx"], ref_out["midx"])
    np.testing.assert_array_equal(out["mfeat"], ref_out["mfeat"])
    nh = meta["nh"]
    assert len(out["hfeat"]) == nh
    np.testing.assert_array_equal(out["hfeat"], ref_out["hfeat"][:nh])
    np.testing.assert_allclose(out["T_12"], ref_out["T_12"], rtol=0, atol=1e-9)
    if (q_row, c_row) == (19, 5):
        assert out["ok"]  # the loop the JAX package's session accepts
    ref_fin = ref_lv.finalize_covins_verify((meta, ref_out))
    fin = loopverify.finalize_covins_verify(job)
    assert (fin is None) == (ref_fin is None)
    if fin is not None:
        np.testing.assert_array_equal(fin[2], ref_fin[2])
        assert fin[1] == ref_fin[1]


def test_relative_pose_refinement_matches_reference():
    rng = np.random.default_rng(11)
    intr = np.asarray([458.654, 457.296, 367.215, 248.375, 0.0])
    dist = np.asarray([-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05])
    T_s_c = np.asarray([0.99, 0.05, -0.1, 0.02, 0.05, -0.02, 0.01])
    T_s_c[:4] /= np.linalg.norm(T_s_c[:4])
    T_true = np.asarray([0.98, 0.02, 0.15, -0.05, 0.3, -0.1, 0.2])
    T_true[:4] /= np.linalg.norm(T_true[:4])
    n = 200
    p2 = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                   rng.uniform(3, 8, n)], 1)
    p1 = np.asarray(ref_geo.pose_apply(jnp.asarray(T_true), jnp.asarray(p2)))
    p1 = p1 + 0.01 * rng.normal(size=p1.shape)
    p1[:20] += rng.normal(size=(20, 3))  # outliers
    mask = rng.random(n) > 0.1
    T0 = T_true + np.concatenate([0.02 * rng.normal(size=4), 0.05 * rng.normal(size=3)])
    T0[:4] /= np.linalg.norm(T0[:4])
    rc = ref_cam.Camera(jnp.asarray(intr), jnp.asarray(dist), jnp.asarray(T_s_c),
                        ref_cam.PINHOLE, ref_cam.RADTAN)
    pc = cam.Camera(torch.tensor(intr), torch.tensor(dist), torch.tensor(T_s_c),
                    cam.PINHOLE, cam.RADTAN)
    rT, rinl, rn = ref_relpose.optimize_relative_pose(
        rc, rc, jnp.asarray(T0), jnp.asarray(p1), jnp.asarray(p2),
        jnp.asarray(mask), th_outlier=1.3)
    T, inl, nn = relpose.optimize_relative_pose(
        pc, pc, torch.tensor(T0), torch.tensor(p1), torch.tensor(p2),
        torch.tensor(mask), th_outlier=1.3)
    assert int(nn) == int(rn) > 100
    np.testing.assert_array_equal(inl.numpy(), np.asarray(rinl))
    np.testing.assert_allclose(T.numpy(), np.asarray(rT), rtol=0, atol=1e-9)


@pytest.mark.parametrize("dist_model", [cam.DIST_NONE, cam.RADTAN])
def test_written_out_jacobian_matches_forward_mode_ad(dist_model):
    """The relative-pose Jacobian is written out where the reference uses
    jax.jacfwd; it must equal torch.func.jacfwd of the same residual to
    1e-12 relative (both are exact derivatives, rounded differently)."""
    rng = np.random.default_rng(3)
    T_s_c = torch.tensor([0.99, 0.05, -0.1, 0.02, 0.05, -0.02, 0.01])
    T_s_c = geo.pose_from_qt(T_s_c[:4], T_s_c[4:])
    c = cam.Camera(torch.tensor([458.0, 457.0, 376.0, 240.0, 0.0], dtype=torch.float64),
                   torch.tensor([-0.28, 0.07, 0.0002, 0.00002], dtype=torch.float64),
                   T_s_c.double(), cam.PINHOLE, dist_model)
    p1 = torch.tensor(rng.normal(size=(300, 3)) + [0, 0, 5])
    p2 = p1 + 0.05 * torch.tensor(rng.normal(size=(300, 3)))
    p1[0, 2] = -3.0  # an invalid point: its z column is zero
    T = geo.pose_from_qt(torch.tensor([0.98, 0.02, 0.15, -0.05], dtype=torch.float64),
                         torch.tensor([0.3, -0.1, 0.2], dtype=torch.float64))
    prob = residuals.RelativeProblem(c, c, p1, p2)
    r, valid, J = prob.residual(T, jac=True)
    J_ad = torch.func.jacfwd(
        lambda xi: residuals.RelativeProblem(c, c, p1, p2).residual(
            geo.pose_boxplus(T, xi))[0])(torch.zeros(6, dtype=torch.float64))
    rel = float((J - J_ad).abs().max() / J_ad.abs().max())
    assert rel < 1e-12
    assert not bool(valid[0]) and bool(valid[1:].all())


@pytest.mark.parametrize("dist_model", [cam.DIST_NONE, cam.RADTAN])
def test_relative_reprojection_residual_matches_reference(dist_model):
    """The paired residual of the relative-pose refinement against the
    reference's, to 1e-9 px (the port applies poses as rotation matrices
    where the reference rotates by quaternions), validity exactly."""
    rng = np.random.default_rng(12)
    intr = np.asarray([458.654, 457.296, 367.215, 248.375, 0.0])
    dist = np.asarray([-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05])
    T_s_c = np.asarray([0.99, 0.05, -0.1, 0.02, 0.05, -0.02, 0.01])
    T_s_c[:4] /= np.linalg.norm(T_s_c[:4])
    T_12 = np.asarray([0.98, 0.02, 0.15, -0.05, 0.3, -0.1, 0.2])
    T_12[:4] /= np.linalg.norm(T_12[:4])
    p2 = np.stack([rng.uniform(-2, 2, 150), rng.uniform(-1.5, 1.5, 150),
                   rng.uniform(2, 8, 150)], 1)
    p1 = p2 + 0.3 * rng.normal(size=p2.shape)
    p2[:10, 2] *= -1  # behind the cameras: invalid
    rc = ref_cam.Camera(jnp.asarray(intr), jnp.asarray(dist), jnp.asarray(T_s_c),
                        ref_cam.PINHOLE, dist_model)
    pc = cam.Camera(torch.tensor(intr), torch.tensor(dist), torch.tensor(T_s_c),
                    cam.PINHOLE, dist_model)
    r_ref, v_ref = ref_residuals.relative_reprojection_residual(
        rc, rc, jnp.asarray(T_12), jnp.asarray(p1), jnp.asarray(p2))
    r, v = residuals.relative_reprojection_residual(
        pc, pc, torch.tensor(T_12), torch.tensor(p1), torch.tensor(p2))
    v_ref = np.asarray(v_ref)
    np.testing.assert_array_equal(v.numpy(), v_ref)
    assert 0 < v_ref.sum() < len(v_ref)
    np.testing.assert_allclose(r.numpy()[v_ref], np.asarray(r_ref)[v_ref],
                               rtol=0, atol=1e-9)
