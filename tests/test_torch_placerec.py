"""The place-recognition slice as a whole: the JAX package's two
place-recognition scenarios (`tests/test_placerec.py`) through both
packages' `AgentSession`, with the reference's vocabulary and streams.

1. an intra-map loop: one agent, 30 keyframes on a trajectory that
   revisits its start;
2. a two-agent map merge: two agents, 16 keyframes each, interleaved
   message by message.

Both run with place recognition on (COVINS), PGO on, messages ingested one
at a time.  Expected: the same loop and merge outcomes, the same accepted
(query, candidate) pairs and loop constraints, and every map's final
keyframe poses and landmark positions within 1e-4.  The tolerance exists
because the stage-2 RANSAC draws differ between the packages (threefry in
the reference, a seeded torch generator in the port), so the minimal sets
that seed each loop's Gauss-Newton refinement differ; the refinement and
the pose-graph solve then converge to the same solution up to rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from covins_tpu.agents.synthetic_agent import SyntheticAgent, SyntheticWorld
from covins_tpu.models.map_manager import MapManager as RefManager
from covins_tpu.models.placerec import PlaceRecognition as RefPlaceRecognition
from covins_tpu.models.session import AgentSession as RefSession
from covins_tpu.ops import bow as ref_bow
from covins_tpu.utils.config import Config as RefConfig
from covins_tpu_torch.models.map_manager import MapManager
from covins_tpu_torch.models.placerec import PlaceRecognition
from covins_tpu_torch.models.session import AgentSession
from covins_tpu_torch.state import messages_from_reference
from covins_tpu_torch.utils.config import Config

# the JAX package's scenario settings (tests/test_placerec.py:_test_config)
CFG = dict(placerec_type="COVINS", start_after_kf=2, consecutive_loop_dist=6,
           min_loop_dist=6, exclude_kfs_with_id_less_than=2,
           cov_consistency_thres=2, matches_thres=12, matches_thres_merge=12,
           inliers_thres=12, ransac_min_inliers=5, perform_pgo=True,
           activate_lm_culling=False)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world_vocab():
    world = SyntheticWorld.create(n_landmarks=500, seed=1)
    vocab = np.asarray(ref_bow.train_vocabulary(jnp.asarray(world.lm_descs),
                                                k=128, iters=4))
    return world, vocab


def _run(streams, vocab, ref):
    cfg = (RefConfig if ref else Config)(**CFG)
    mgr = RefManager(vocab, cfg) if ref else MapManager(vocab, cfg, device="cpu")
    sessions = [(RefSession if ref else AgentSession)(c, mgr, cfg)
                for c in range(len(streams))]
    streams = streams if ref else [messages_from_reference(s) for s in streams]
    outcomes, cursor = [], [0] * len(streams)
    while any(i < len(s) for i, s in zip(cursor, streams)):
        for c, s in enumerate(streams):
            if cursor[c] < len(s):
                out = sessions[c].ingest(s[cursor[c]])
                cursor[c] += 1
                if out:
                    outcomes.append(out)
    for s in sessions:
        out = s.flush()
        if out:
            outcomes.append(out)
    return mgr, outcomes, sessions


def _loops(mp):
    return [(tuple(int(x) for x in mp.kf_ids[lc["kf1"]]),
             tuple(int(x) for x in mp.kf_ids[lc["kf2"]])) for lc in mp.loops]


@pytest.mark.parametrize("scenario", ["intra_map_loop", "two_agent_merge"])
def test_slice_matches_reference(world_vocab, scenario):
    world, vocab = world_vocab
    if scenario == "intra_map_loop":
        agents = [SyntheticAgent(world, client_id=0, n_keyframes=30)]
    else:
        agents = [SyntheticAgent(world, client_id=0, n_keyframes=16),
                  SyntheticAgent(world, client_id=1, n_keyframes=16, t0=1.0)]
    streams = [list(a.messages()) for a in agents]
    ref_mgr, ref_out, _ = _run(streams, vocab, ref=True)
    mgr, out, sessions = _run(streams, vocab, ref=False)

    assert out == ref_out
    assert (mgr.n_loops, mgr.n_merges, mgr.n_fused) == \
        (ref_mgr.n_loops, ref_mgr.n_merges, ref_mgr.n_fused)
    if scenario == "intra_map_loop":
        assert out.count("loop") >= 1
    else:
        assert "merge" in out
        assert mgr.map_of_client[0] == mgr.map_of_client[1]
    assert sorted(mgr.maps) == sorted(ref_mgr.maps)
    for mid, ref_mp in ref_mgr.maps.items():
        mp = mgr.maps[mid]
        assert _loops(mp) == _loops(ref_mp)
        assert (mp.n_kf, mp.n_lm, mp.n_obs) == (ref_mp.n_kf, ref_mp.n_lm, ref_mp.n_obs)
        np.testing.assert_array_equal(mp.kf_ids[:mp.n_kf], ref_mp.kf_ids[:mp.n_kf])
        np.testing.assert_array_equal(mp.lm_mask, ref_mp.lm_mask)
        np.testing.assert_array_equal(mp.kf_feat_lm, ref_mp.kf_feat_lm)
        np.testing.assert_allclose(mp.kf_pose, ref_mp.kf_pose, rtol=0, atol=1e-4)
        np.testing.assert_allclose(mp.lm_pos, ref_mp.lm_pos, rtol=0, atol=1e-4)
    # the accepted (query, candidate) pairs are the reference's constraints
    accepted = sorted(p for s in sessions for p in s.accepted)
    assert accepted == sorted(p for mp in ref_mgr.maps.values() for p in _loops(mp))


def test_covins_g_is_refused(world_vocab):
    """COVINS-G runs over ORB (test_covins_g_slice_matches_reference) and
    over SIFT descriptors (tests/test_torch_sift.py): both construct.  Only
    COVINS over SIFT is refused, which the reference cannot run either (its
    COVINS verification matches binary descriptors)."""
    _, vocab = world_vocab
    sift = dict(feat_type="SIFT", desc_length=128)
    cfg = Config(placerec_type="COVINS", **sift)
    mgr = MapManager(vocab, cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="COVINS-G"):
        AgentSession(0, mgr, cfg)
    AgentSession(0, mgr, Config(placerec_type="COVINS_G"))
    sift_vocab = np.abs(np.random.default_rng(0).normal(size=(16, 128))).astype(np.float32)
    g_cfg = Config(placerec_type="COVINS_G", **sift)
    g_mgr = MapManager(sift_vocab, g_cfg, device="cpu")
    AgentSession(0, g_mgr, g_cfg)
    assert g_mgr.database.metric == "l2"
    assert g_mgr.map_of(0).descriptors.dtype == np.float32


def test_process_keyframe_matches_reference(world_vocab):
    """`PlaceRecognition.process_keyframe`, the inline Run() body, over the
    intra-map loop scenario's finished map (ingested with place recognition
    off), keyframe by keyframe into an empty database it fills: the same
    keyframes find a loop, with the same candidate, inlier count and
    matches, and T_12 within 1e-6 (the RANSAC draws differ between the
    packages, see the module docstring)."""
    world, vocab = world_vocab
    stream = list(SyntheticAgent(world, client_id=0, n_keyframes=30).messages())
    results = []
    for ref in (True, False):
        Cfg = RefConfig if ref else Config
        off, on = Cfg(**dict(CFG, placerec_active=False)), Cfg(**CFG)
        if ref:
            mgr, empty = RefManager(vocab, off), RefManager(vocab, on)
            RefSession(0, mgr, off).ingest_many(stream)
        else:
            mgr = MapManager(vocab, off, device="cpu")
            empty = MapManager(vocab, on, device="cpu")
            AgentSession(0, mgr, off).ingest_many(messages_from_reference(stream))
        mp = mgr.map_of(0)
        pr = (RefPlaceRecognition if ref else PlaceRecognition)(
            0, empty.database, mgr.resolve, on)
        results.append([pr.process_keyframe(mp, row) for row in range(mp.n_kf)])
    ref_res, res = results
    assert [r is None for r in res] == [r is None for r in ref_res]
    assert sum(r is not None for r in res) >= 1
    for r, rr in zip(res, ref_res):
        if r is None:
            continue
        assert (r.query_id, r.candidate_id, r.n_inliers) == \
            (rr.query_id, rr.candidate_id, rr.n_inliers)
        np.testing.assert_array_equal(r.matches, np.asarray(rr.matches))
        np.testing.assert_allclose(r.T_12, np.asarray(rr.T_12), rtol=0, atol=1e-6)


# the JAX package's COVINS-G scenario (tests/test_placerec.py
# test_covins_g_mode), with the linear 8-point prefilter: the reference's
# fused 5-point program takes some 13 minutes to compile on the CPU
# (tests/test_torch_loopverify.py holds the 5-point verification)
G_CFG = dict(CFG, placerec_type="COVINS_G", nc_min_inliers=30, nc_cov_thres=100.0,
             rel_min_img_matches=17, rel_minimal_solver="8pt", perform_pgo=True)
G_FEATURES = 256  # the stream keeps at most 166 features a keyframe


def _jax_draws(monkeypatch):
    """Hand the port's COVINS-G verifications the reference's Gumbel
    draws: the agent's key (``rng_seed + 1000 * client_id``) split once per
    verification, then into one key per keyframe pair, the 17-point key and
    the covariance key (`_covinsg_verify_impl`)."""
    keys = {}

    def noise(self, n_pairs, n_hyp5, Fq, n_hyp17, n_cov):
        key = keys.get(id(self), jax.random.PRNGKey(1000 * self.client_id))
        keys[id(self)], k = jax.random.split(key)
        ks = jax.random.split(k, n_pairs + 2)
        g = lambda kk, shape: np.array(jax.random.gumbel(kk, shape))  # noqa: E731
        return {"noise5": np.stack([g(ks[i], (n_hyp5, Fq)) for i in range(n_pairs)]),
                "noise17": g(ks[-2], (n_hyp17, n_pairs * Fq)),
                "noise_cov": g(ks[-1], (n_cov, n_pairs * Fq))}
    monkeypatch.setattr(PlaceRecognition, "next_covins_g_noise", noise)


def test_covins_g_slice_matches_reference(world_vocab, monkeypatch):
    """COVINS-G through both packages' `AgentSession` (one agent, 30
    keyframes revisiting its start, pose-graph solves on), with the
    reference's draws injected and both packages' maps holding
    G_FEATURES features a keyframe.  Expected: the same loops with the
    same candidates (the accepted pairs), each loop edge carrying the
    sampling covariance into the pose graph and the GBA problem, loop
    transforms within 1e-6 (the weighted 17-point re-solve amplifies
    rounding, tests/test_torch_loopverify.py) and every final pose within
    1e-4 (the pose-graph solve amplifies that, as in
    test_slice_matches_reference)."""
    import functools

    from covins_tpu.models import map_manager as ref_mm
    from covins_tpu.ops import residuals as ref_res
    from covins_tpu_torch.models import map_manager as mm
    from covins_tpu_torch.ops import residuals

    world, vocab = world_vocab
    _jax_draws(monkeypatch)
    for mod in (ref_mm, mm):
        monkeypatch.setattr(mod, "Map", functools.partial(mod.Map, max_features=G_FEATURES))
    stream = list(SyntheticAgent(world, client_id=0, n_keyframes=30).messages())
    runs = []
    for ref in (True, False):
        cfg = (RefConfig if ref else Config)(**G_CFG)
        mgr = RefManager(vocab, cfg) if ref else MapManager(vocab, cfg, device="cpu")
        sess = (RefSession if ref else AgentSession)(0, mgr, cfg)
        s = stream if ref else messages_from_reference(stream)
        outs = [sess.ingest(m) for m in s] + [sess.flush()]
        runs.append((mgr, [o for o in outs if o], sess))
    (ref_mgr, ref_out, _), (mgr, out, sess) = runs
    assert out == ref_out and out.count("loop") >= 1
    ref_mp, mp = ref_mgr.map_of(0), mgr.map_of(0)
    assert _loops(mp) == _loops(ref_mp)
    # the accepted (query, candidate) pairs are the reference's loop edges
    assert sorted(sess.accepted) == sorted(_loops(ref_mp))
    graph = mp.to_pose_graph()
    problem = mp.to_gba_problem()
    n_loops = len(mp.loops)
    for i, (lc, rl) in enumerate(zip(mp.loops, ref_mp.loops)):
        np.testing.assert_allclose(lc["T_12"], np.asarray(rl["T_12"]), rtol=0, atol=1e-6)
        rc = np.asarray(rl["cov"])
        np.testing.assert_allclose(lc["cov"], rc, rtol=0, atol=1e-6 * np.abs(rc).max())
        S = residuals.sqrt_info_from_covariance(torch.as_tensor(lc["cov"]))
        np.testing.assert_allclose(
            S.numpy(), np.asarray(ref_res.sqrt_info_from_covariance(jnp.asarray(rc))),
            rtol=1e-6, atol=1e-6 * float(S.abs().max()))
        e = graph.edge_sqrt_info.shape[0] - n_loops + i
        assert bool(graph.edge_is_loop[e])
        np.testing.assert_allclose(graph.edge_sqrt_info[e].numpy(), S.numpy(), rtol=1e-12)
        np.testing.assert_allclose(problem.loop_sqrt_info[i].numpy(), S.numpy(), rtol=1e-6)
    np.testing.assert_allclose(mp.kf_pose, ref_mp.kf_pose, rtol=0, atol=1e-4)
