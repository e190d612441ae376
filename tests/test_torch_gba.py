"""The port's global visual-inertial bundle adjustment against the JAX
package's.

The problems are the JAX package's own: `tests/test_gba.py:_build_problem`
(12 keyframes, 150 landmarks, a perturbed start), handed to the port field
by field (`state.gba_problem_from_reference`), and maps that both packages
ingest from the same synthetic messages.

Bounds:
* the three factor types' residuals and Jacobians: 1e-12 relative to the
  largest entry (float64; they round apart only where the two libraries
  order a short sum differently);
* a Gauss-Newton step and whole solves: measured, the way
  `scripts/port_pose_sensitivity.py` measures, by running the reference
  against itself with its inputs moved by one ulp
  (`scripts/port_gba_sensitivity.py`, CPU).  The reduced camera system is
  ill-conditioned and its PCG is stopped far from convergence, so one ulp
  of input moves the reference's own step by up to STEP_SPREAD and its
  two-round solves by up to SOLVE_SPREAD; each bound below is that spread
  times a factor of 10.  Discrete outcomes (the damping, which encodes the
  step ladder's choice and the accept flag; the pruned observations) are
  held exactly.
"""

import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from covins_tpu.agents.synthetic_agent import SyntheticAgent, SyntheticWorld
from covins_tpu.models.map_manager import MapManager as RefManager
from covins_tpu.models.session import AgentSession as RefSession
from covins_tpu.ops import bow as ref_bow
from covins_tpu.ops import gba as ref_gba
from covins_tpu.utils.config import Config as RefConfig
from covins_tpu_torch.models.map_manager import MapManager
from covins_tpu_torch.models.session import AgentSession
from covins_tpu_torch.ops import gba, residuals
from covins_tpu_torch.state import gba_problem_from_reference, messages_from_reference
from covins_tpu_torch.utils import geometry as geo
from covins_tpu_torch.utils.config import Config
from covins_tpu_torch.utils.synthetic import stacked_states

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_gba import _build_problem  # noqa: E402

# measured spreads of the reference under a one-ulp input change
# (scripts/port_gba_sensitivity.py, CPU): (states, max abs; costs,
# relative), per scenario
STEP_SPREAD = {"fused": (6.94e-4, 1.73e-3), "classic": (5.08e-4, 5.22e-3)}
SOLVE_SPREAD = {"outliers": (4.01e-6, 7.72e-5), "no_outliers": (4.25e-6, 6.07e-6),
                "visual_only": (6.03e-5, 3.12e-3), "run_gba": (6.79e-5, 5.04e-6)}
FACTOR = 10.0


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


@pytest.fixture(scope="module")
def problems():
    rp, traj, _ = _build_problem()
    # one live loop edge between keyframes 2 and 9 (the ground truth's
    # relative pose), so the loop factor is exercised too
    from covins_tpu.utils import geometry as ref_geo
    T = ref_geo.pose_relative(traj.poses[2], traj.poses[9])
    rp = dataclasses.replace(
        rp, loop_i=jnp.asarray([2], jnp.int32), loop_j=jnp.asarray([9], jnp.int32),
        loop_T=T[None], loop_sqrt_info=jnp.diag(jnp.asarray([100.0] * 3 + [1e4] * 3))[None],
        loop_mask=jnp.asarray([True]))
    return rp, gba_problem_from_reference(rp, device="cpu")


def test_problem_from_reference(problems):
    rp, p = problems
    for f in dataclasses.fields(gba.GBAProblem):
        if f.name in ("cam", "imu_pre"):
            continue
        np.testing.assert_array_equal(getattr(p, f.name).numpy(),
                                      np.asarray(getattr(rp, f.name)), err_msg=f.name)


@pytest.mark.parametrize("huber", [0.0, 2.447])
def test_reprojection_factors_match_reference(problems, huber):
    rp, p = problems
    ref = ref_gba._reproj_r_J(rp, huber)
    got = gba.reproj_blocks(p, gba.obs_graph(p), huber, "linearize")[:3]
    for a, b in zip(got, ref):
        assert _rel(a.numpy(), b) <= 1e-12
    # the per-keyframe and per-landmark blocks are the scatter-adds of these
    r, Jp, Jl, b6, M6, b_l, Hll = gba.reproj_blocks(p, gba.obs_graph(p), huber, "linearize")
    want = torch.zeros_like(M6).index_add_(0, p.obs_kf, Jp.transpose(-1, -2) @ Jp)
    assert _rel(M6.numpy(), want.numpy()) <= 1e-12
    want = torch.zeros_like(b_l).index_add_(0, p.obs_lm, -(Jl.transpose(-1, -2) @ r[..., None])[..., 0])
    assert _rel(b_l.numpy(), want.numpy()) <= 1e-12


def test_written_out_reprojection_jacobian_matches_forward_mode_ad(problems):
    """The written-out Jacobians against ``torch.func.jacfwd`` of the
    port's own residual (both exact derivatives, rounded differently)."""
    _, p = problems
    pose, X, uv = p.poses[p.obs_kf], p.lms[p.obs_lm], p.obs_uv
    pose = pose.clone()
    pose[0, 4:7] = X[0]  # a point at the camera centre: invalid, z column zero
    r, valid, Jp, Jl = residuals.reprojection_jacobian(p.cam, pose, X, uv)

    def r_of(T, x, u, xi, d):
        return residuals.reprojection_residual(p.cam, geo.pose_boxplus(T, xi), x + d, u)[0]

    z6, z3 = torch.zeros(6, dtype=torch.float64), torch.zeros(3, dtype=torch.float64)
    Jp_ad = torch.func.vmap(lambda T, x, u: torch.func.jacfwd(
        lambda xi: r_of(T, x, u, xi, z3))(z6))(pose, X, uv)
    Jl_ad = torch.func.vmap(lambda T, x, u: torch.func.jacfwd(
        lambda d: r_of(T, x, u, z6, d))(z3))(pose, X, uv)
    r_ref, valid_ref = residuals.reprojection_residual(p.cam, pose, X, uv)
    np.testing.assert_array_equal(r.numpy(), r_ref.numpy())
    assert torch.equal(valid, valid_ref) and not bool(valid[0])
    assert _rel(Jp.numpy(), Jp_ad.numpy()) <= 1e-12
    assert _rel(Jl.numpy(), Jl_ad.numpy()) <= 1e-12


def test_imu_and_loop_factors_match_reference(problems):
    rp, p = problems
    rf, rJ = ref_gba._imu_r_J(rp)
    f, J = gba._imu_r_J(p)
    assert _rel(f.numpy(), rf) <= 1e-12 and _rel(J.numpy(), rJ) <= 1e-12
    assert _rel(gba._imu_r(p).numpy(), f.numpy()) <= 1e-12
    rl, rJi, rJj = ref_gba._loop_r_J(rp)
    l, Ji, Jj = gba._loop_r_J(p)
    assert float(np.abs(rl).max()) > 0
    for a, b in ((l, rl), (Ji, rJi), (Jj, rJj)):
        assert _rel(a.numpy(), b) <= 1e-12
    assert _rel(gba._loop_r(p).numpy(), l.numpy()) <= 1e-12


def test_sqrt_info_helpers_match_reference(problems):
    rp, p = problems
    got = gba.imu_sqrt_info_from_cov(p.imu_pre.cov)
    assert _rel(got.numpy(), ref_gba.imu_sqrt_info_from_cov(rp.imu_pre.cov)) <= 1e-12
    from covins_tpu.ops import imu as ref_imu
    from covins_tpu_torch.ops import imu
    got = gba.bias_walk_sqrt_info(imu.default_noise(), p.imu_pre.dt)
    ref = ref_gba.bias_walk_sqrt_info(ref_imu.default_noise(), rp.imu_pre.dt)
    assert _rel(got.numpy(), ref) <= 1e-12


@pytest.mark.parametrize("variant", ["fused", "classic"])
def test_gn_schur_step_matches_reference(problems, variant):
    """One LM step at 60 CG iterations from the perturbed start."""
    rp, p = problems
    step = jax.jit(lambda st, lam: ref_gba._gn_schur_step(
        rp, st, lam, 60, False, cg_variant=variant))
    rs, rlam, rc = step((rp.poses, rp.vels, rp.biases, rp.lms), jnp.asarray(1e-4))
    s, lam, c = gba._gn_schur_step(p, gba.obs_graph(p), (p.poses, p.vels, p.biases, p.lms),
                                   torch.tensor(1e-4, dtype=torch.float64), 60, False,
                                   cg_variant=variant)
    d_state, d_cost = STEP_SPREAD[variant]
    for a, b in zip(s, rs):
        assert float(np.abs(a.numpy() - np.asarray(b)).max()) <= FACTOR * d_state
    assert _rel(float(c), float(rc)) <= FACTOR * d_cost
    assert float(lam) == float(rlam)
    assert float(c) < float(gba.total_cost(p, gba.obs_graph(p),
                                           (p.poses, p.vels, p.biases, p.lms), False))


@pytest.mark.parametrize("camera", ["omni", "equidistant"])
def test_gn_schur_step_with_other_cameras_matches_reference(problems, camera):
    """One LM step (fused PCG, 60 iterations) on the reference's problem
    seen through the unified camera model or a pinhole camera with
    equidistant distortion (`synthetic.SCENE_CAMERAS`, xi 0.6): the same
    observations, their pixels the ground truth's projection through that
    camera plus the problem's own pixel noise.  The port writes the
    projection Jacobian out where the reference takes ``jax.jacfwd``; the
    step is held to the pinhole step's bound (10x the reference's one-ulp
    spread), the damping exactly."""
    from covins_tpu.utils import cameras as ref_cam
    from covins_tpu.utils import geometry as ref_geo
    from covins_tpu_torch.utils.synthetic import SCENE_CAMERAS

    rp, _ = problems
    _, traj, lms_gt = _build_problem()
    model, dist_model, dist = SCENE_CAMERAS[camera]
    rc = ref_cam.Camera(rp.cam.intrinsics.at[4].set(0.6), jnp.asarray(dist, jnp.float64),
                        rp.cam.T_s_c, model, dist_model)

    def pixels(c):
        T_c_w = ref_geo.pose_inverse(ref_geo.pose_compose(traj.poses[rp.obs_kf], c.T_s_c))
        uv, valid = ref_cam.project3(c, ref_geo.pose_apply(T_c_w, lms_gt[rp.obs_lm]))
        return np.asarray(uv), np.asarray(valid)

    uv_pin, _ = pixels(rp.cam)
    uv_new, valid = pixels(rc)
    assert valid.all()
    rq = dataclasses.replace(rp, cam=rc, obs_uv=jnp.asarray(uv_new + (np.asarray(rp.obs_uv)
                                                                       - uv_pin)))
    q = gba_problem_from_reference(rq, device="cpu")
    step = jax.jit(lambda st, lam: ref_gba._gn_schur_step(rq, st, lam, 60, False))
    rs, rlam, rc_ = step((rq.poses, rq.vels, rq.biases, rq.lms), jnp.asarray(1e-4))
    s, lam, c = gba._gn_schur_step(q, gba.obs_graph(q), (q.poses, q.vels, q.biases, q.lms),
                                   torch.tensor(1e-4, dtype=torch.float64), 60, False)
    d_state, d_cost = STEP_SPREAD["fused"]
    for a, b in zip(s, rs):
        assert float(np.abs(a.numpy() - np.asarray(b)).max()) <= FACTOR * d_state
    assert _rel(float(c), float(rc_)) <= FACTOR * d_cost
    assert float(lam) == float(rlam)
    assert float(c) < float(gba.total_cost(q, gba.obs_graph(q),
                                           (q.poses, q.vels, q.biases, q.lms), False))


@pytest.mark.parametrize("visual_only,huber", [(False, 0.0), (False, 2.447), (True, 0.0)])
def test_batched_total_cost_equals_single_evaluations(problems, visual_only, huber):
    """The step ladder's seven costs in one evaluation (the states stacked
    on a leading dimension, in place of the reference's jax.vmap: one K8
    cost launch on the card, the loop and IMU residuals batched) against
    seven single evaluations."""
    _, p = problems
    g = gba.obs_graph(p)
    stacked = stacked_states(p, 7)
    states = [tuple(x[k] for x in stacked) for k in range(7)]
    got = gba.total_cost(p, g, stacked, visual_only, huber)
    want = torch.stack([gba.total_cost(p, g, st, visual_only, huber) for st in states])
    assert got.shape == (7,)
    assert _rel(got.numpy(), want.numpy()) <= 1e-14
    assert len(set(want.tolist())) == 7


def test_reprojection_sees_a_new_obs_mask_on_the_same_graph(problems):
    """K8's per-problem inputs (the weights and masks as float64, the
    camera) are built from the problem they are asked for, once per round
    of a solve; after the pruning's new obs_mask the next linearisation and
    cost on the same graph use the new mask, whether given the inputs built
    for it or none, and a round runs the same with its inputs built once as
    with them built at every call."""
    _, p = problems
    g = gba.obs_graph(p)
    st = (p.poses, p.vels, p.biases, p.lms)
    lin0 = gba.reproj_blocks(p, g, 0.0, "linearize")
    c0 = gba.total_cost(p, g, st, True)
    mask = p.obs_mask.clone()
    mask[::3] = False
    q = dataclasses.replace(p, obs_mask=mask)
    inputs = gba.reproj_inputs(q)
    assert torch.equal(inputs.w, (q.obs_w * mask).double())
    lin1 = gba.reproj_blocks(q, g, 0.0, "linearize")
    c1 = gba.total_cost(q, g, st, True)
    assert not bool(lin1[0][~mask].any()) and bool(lin0[0][~mask].any())
    for a, b in zip(lin1, gba.reproj_blocks(q, g, 0.0, "linearize", inputs)):
        assert torch.equal(a, b)
    assert torch.equal(c1, gba.total_cost(q, g, st, True, inputs=inputs))
    assert float(c1) < float(c0)
    lam = torch.tensor(1e-4, dtype=torch.float64)
    once = gba._gn_schur_step(q, g, st, lam, 5, True, 2.447, inputs=inputs)
    each = gba._gn_schur_step(q, g, st, lam, 5, True, 2.447)
    for a, b in zip(once[0] + once[1:], each[0] + each[1:]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("scenario", ["outliers", "no_outliers", "visual_only"])
def test_global_bundle_adjustment_matches_reference(problems, scenario):
    rp, p = problems
    kw = dict(n_gn=4, n_cg=30, outlier_removal=scenario == "outliers",
              visual_only=scenario == "visual_only")
    rp2, rinfo = ref_gba.global_bundle_adjustment(rp, **kw)
    p2, info = gba.global_bundle_adjustment(p, **kw)
    d_state, d_cost = SOLVE_SPREAD[scenario]
    if scenario == "outliers":
        assert info["n_pruned"] == rinfo["n_pruned"] > 0
        assert _rel(info["round1_costs"].numpy(), rinfo["round1_costs"]) <= FACTOR * d_cost
    np.testing.assert_array_equal(p2.obs_mask.numpy(), np.asarray(rp2.obs_mask))
    costs = info["costs"].numpy()
    assert _rel(costs, rinfo["costs"]) <= FACTOR * d_cost
    assert (np.diff(costs) <= 0).all()
    for name in ("poses", "vels", "biases", "lms"):
        diff = float(np.abs(getattr(p2, name).numpy() - np.asarray(getattr(rp2, name))).max())
        assert diff <= FACTOR * d_state, (name, diff)
    # the gauge: the fixed keyframe's pose does not move
    np.testing.assert_array_equal(p2.poses[0].numpy(), p.poses[0].numpy())


# ---------------------------------------------------------------- the maps
CFG = dict(placerec_type="COVINS", start_after_kf=2, consecutive_loop_dist=6,
           min_loop_dist=6, exclude_kfs_with_id_less_than=2,
           cov_consistency_thres=2, matches_thres=12, matches_thres_merge=12,
           inliers_thres=12, ransac_min_inliers=5, perform_pgo=True,
           activate_lm_culling=False)


def _ingest(streams, vocab, ref, **cfg):
    conf = (RefConfig if ref else Config)(**cfg)
    mgr = RefManager(vocab, conf) if ref else MapManager(vocab, conf, device="cpu")
    sessions = [(RefSession if ref else AgentSession)(c, mgr, conf)
                for c in range(len(streams))]
    streams = streams if ref else [messages_from_reference(s) for s in streams]
    cursor = [0] * len(streams)
    while any(i < len(s) for i, s in zip(cursor, streams)):
        for c, s in enumerate(streams):
            if cursor[c] < len(s):
                sessions[c].ingest(s[cursor[c]])
                cursor[c] += 1
    for s in sessions:
        s.flush()
    return mgr


@pytest.fixture(scope="module")
def world_vocab():
    world = SyntheticWorld.create(n_landmarks=500, seed=1)
    vocab = np.asarray(ref_bow.train_vocabulary(jnp.asarray(world.lm_descs), k=128, iters=4))
    return world, vocab


def _compare_problems(p, rp):
    for f in dataclasses.fields(gba.GBAProblem):
        a, b = getattr(p, f.name), getattr(rp, f.name)
        if f.name == "cam":
            for g in ("intrinsics", "dist", "T_s_c"):
                np.testing.assert_array_equal(getattr(a, g).numpy(), np.asarray(getattr(b, g)))
            assert (a.cam_model, a.dist_model) == (b.cam_model, b.dist_model)
        elif f.name == "imu_pre":
            for g in ("dq", "dv", "dp", "J_q_bg", "J_v_bg", "J_v_ba", "J_p_bg", "J_p_ba",
                      "cov", "dt", "bg_ref", "ba_ref"):
                assert _rel(getattr(a, g).numpy(), getattr(b, g)) <= 1e-12, g
        elif f.name in ("imu_sqrt_info", "bias_sqrt_info"):
            assert _rel(a.numpy(), b) <= 1e-12, f.name
        else:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f.name)


def test_to_gba_problem_matches_reference(world_vocab):
    """One agent's map, ingested by both packages from the same messages:
    every array of the GBA snapshot (the re-propagated IMU factors and
    their weights to 1e-12 relative, everything else exactly)."""
    world, vocab = world_vocab
    stream = [list(SyntheticAgent(world, client_id=0, n_keyframes=8).messages())]
    cfg = dict(CFG, placerec_active=False)
    ref_mp = _ingest(stream, vocab, True, **cfg).map_of(0)
    mp = _ingest(stream, vocab, False, **cfg).map_of(0)
    _compare_problems(mp.to_gba_problem(), ref_mp.to_gba_problem())


def test_run_gba_matches_reference(world_vocab):
    """`MapManager.run_gba` on a two-agent merged session.  The sessions'
    RANSAC draws differ between the packages (see
    `tests/test_torch_placerec.py`), so the reference map's float state is
    copied into the port's map first; then both snapshots agree array for
    array, and run_gba prunes the same observations and ends within the
    measured bound."""
    world, vocab = world_vocab
    agents = [SyntheticAgent(world, client_id=0, n_keyframes=16),
              SyntheticAgent(world, client_id=1, n_keyframes=16, t0=1.0)]
    streams = [list(a.messages()) for a in agents]
    ref_mgr = _ingest(streams, vocab, True, **CFG)
    mgr = _ingest(streams, vocab, False, **CFG)
    assert mgr.n_merges == ref_mgr.n_merges == 1
    mid = mgr.map_of_client[0]
    ref_mp, mp = ref_mgr.maps[mid], mgr.maps[mid]
    for name in ("kf_pose", "kf_vel", "kf_bias", "lm_pos", "obs_mask"):
        getattr(mp, name)[...] = getattr(ref_mp, name)
    for lc, rlc in zip(mp.loops, ref_mp.loops):
        lc["T_12"] = np.asarray(rlc["T_12"]).copy()
    _compare_problems(mp.to_gba_problem(), ref_mp.to_gba_problem())

    rinfo = ref_mgr.run_gba(mid)
    info = mgr.run_gba(mid)
    assert info["n_pruned"] == rinfo["n_pruned"]
    np.testing.assert_array_equal(mp.obs_mask, ref_mp.obs_mask)
    d_state, d_cost = SOLVE_SPREAD["run_gba"]
    assert _rel(info["costs"], rinfo["costs"]) <= FACTOR * d_cost
    assert (np.diff(info["costs"]) <= 0).all()
    for name in ("kf_pose", "kf_vel", "kf_bias", "lm_pos"):
        diff = float(np.abs(getattr(mp, name) - getattr(ref_mp, name)).max())
        assert diff <= FACTOR * d_state, (name, diff)
    np.testing.assert_array_equal(mp.kf_in_gba, ref_mp.kf_in_gba)
    np.testing.assert_array_equal(mp.lm_desc, ref_mp.lm_desc)
