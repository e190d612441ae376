"""SIFT mode of the port against the JAX package, on the CPU: COVINS-G over
128-dimensional float32 descriptors, with L2 retrieval (the K13 plain
version), L2 ratio matching (the K14 plain version) and K5's L2 metric.

Tolerances, and where they come from:
- L2_TOL, 1.0 on a squared distance: the port sums aa, bb and ab in one
  written order (`descriptors.l2_distance_sq`, the arithmetic of K13 and
  K14), XLA in its blocked order; at SIFT's norm of 512, ``aa + bb`` is
  near 5.2e5, where a float32 ulp is 0.03-0.06, and the two differed by at
  most 0.44 (14 ulps) on this file's scene (`test_l2_distance_sq`, which
  asserts the bound).  A decision, an argmin or a gate, is held exactly
  wherever its margin exceeds 2 * L2_TOL, and the session test asserts that
  every decision of its run does, so that its exact comparisons are valid.
- The k-means vocabulary: centres within 1e-4 (the means of the same
  descriptors summed in another order; 1.5e-5 measured).
- K5's L2 metric: matches exactly, distances within 1e-9 (float64 sums in
  another order; the cross term rounds to float32 alike unless a float64
  sum lies within 1e-16 relative of a float32 rounding boundary).
- The session: loops, merges and accepted pairs exactly, loop transforms
  to 1e-6, covariances to 1e-6 of their largest entry and poses to 1e-4, as
  `tests/test_torch_placerec.py::test_covins_g_slice_matches_reference`
  holds the ORB COVINS-G session (its reasons hold here).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from covins_tpu.agents.synthetic_agent import SyntheticAgent, SyntheticWorld
from covins_tpu.models import map_manager as ref_mm
from covins_tpu.models.kf_database import KeyframeDatabase as RefDB
from covins_tpu.models.kf_database import \
    train_vocabulary_from_maps as ref_train_from_maps
from covins_tpu.models.map_manager import MapManager as RefManager
from covins_tpu.models.session import AgentSession as RefSession
from covins_tpu.ops import bow as ref_bow
from covins_tpu.ops import descriptors as ref_desc
from covins_tpu.ops import loopverify as ref_lv
from covins_tpu.ops import projmatch as ref_pm
from covins_tpu.utils import cameras as ref_cam
from covins_tpu.utils.config import Config as RefConfig
from covins_tpu_torch.models import kf_database
from covins_tpu_torch.models import map_manager as mm
from covins_tpu_torch.models.kf_database import KeyframeDatabase
from covins_tpu_torch.models.map_manager import MapManager
from covins_tpu_torch.models.map_store import Map
from covins_tpu_torch.models.placerec import PlaceRecognition
from covins_tpu_torch.models.session import AgentSession
from covins_tpu_torch.ops import bow, descriptors, loopverify, projmatch
from covins_tpu_torch.state import messages_from_reference, vocabulary_from_reference
from covins_tpu_torch.utils import synthetic
from covins_tpu_torch.utils.config import Config

L2_TOL = 1.0


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world_vocab():
    """The JAX package's SIFT world and vocabulary of
    `tests/test_sift_mode.py::test_sift_covins_g_loop`."""
    world = SyntheticWorld.create(n_landmarks=600, desc_bytes=128, seed=4, feat_type="SIFT")
    vocab = np.asarray(ref_bow.train_vocabulary_l2(jnp.asarray(world.lm_descs), k=128,
                                                   iters=4))
    return world, vocab


def _observed(rng, descs, n):
    """n noisy observations of the given descriptors, as the agent makes
    them: N(0, 8) added, the absolute value taken."""
    d = descs[rng.integers(0, len(descs), n)]
    return np.abs(d + rng.normal(0.0, 8.0, d.shape)).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _gap(dist):
    """Each row's margin between its best and second-best entry."""
    s = np.sort(np.asarray(dist), axis=1)
    return s[:, 1] - s[:, 0]


# ------------------------------------------------------------------ L2 forms
def test_l2_distance_sq(world_vocab):
    world, vocab = world_vocab
    a = _observed(np.random.default_rng(0), world.lm_descs, 700)
    ref = np.asarray(ref_desc.l2_distance_sq(jnp.asarray(a), jnp.asarray(vocab)))
    got = descriptors.l2_distance_sq(_t(a), _t(vocab))
    assert got.dtype == torch.float32
    assert np.abs(got.numpy() - ref).max() <= L2_TOL
    # the plain version's arithmetic: running float32 sums in order
    aa = np.zeros(len(a), np.float32)
    bb = np.zeros(len(vocab), np.float32)
    ab = np.zeros((len(a), len(vocab)), np.float32)
    for k in range(128):
        aa = aa + a[:, k] * a[:, k]
        bb = bb + vocab[:, k] * vocab[:, k]
        ab = ab + a[:, k, None] * vocab[None, :, k]
    np.testing.assert_array_equal(got.numpy(), np.maximum((aa[:, None] + bb) - 2 * ab, 0))


@pytest.mark.parametrize("masked", [False, True])
def test_assign_words_l2(world_vocab, masked):
    """Word ids equal the reference's wherever the best and second-best
    words lie further apart than 2 * L2_TOL (all but a handful); ties go to
    the lower word, as `jnp.argmin` gives them (duplicated words)."""
    world, vocab = world_vocab
    rng = np.random.default_rng(1)
    a = _observed(rng, world.lm_descs, 500)
    v = vocab.copy()
    v[100] = v[7]  # a duplicated word: its rows go to word 7
    a[:5] = v[7]
    mask = rng.random(len(a)) > 0.2 if masked else None
    ref = np.asarray(ref_bow.assign_words_l2(jnp.asarray(a), jnp.asarray(v),
                                             None if mask is None else jnp.asarray(mask)))
    got = bow.assign_words_l2(_t(a), _t(v), None if mask is None else _t(mask)).numpy()
    gap = _gap(descriptors.l2_distance_sq(_t(a), _t(np.delete(v, 100, 0))))
    clear = gap > 2 * L2_TOL
    assert clear.mean() > 0.99
    np.testing.assert_array_equal(got[clear], ref[clear])
    assert (got[:5] == np.where(mask[:5], 7, -1) if masked else got[:5] == 7).all()
    if masked:
        assert (got[~mask] == -1).all()


def test_train_vocabulary_l2(world_vocab):
    """k-means from the reference's initial draw (`jax.random.choice`),
    four steps: the same centres within 1e-4."""
    world, vocab = world_vocab
    n, k = len(world.lm_descs), 128
    idx = np.asarray(jax.random.choice(jax.random.PRNGKey(0), n, (k,), replace=n < k))
    got = bow.train_vocabulary_l2(_t(world.lm_descs), k=k, iters=4, idx=_t(idx))
    assert got.dtype == torch.float32 and got.shape == (k, 128)
    np.testing.assert_allclose(got.numpy(), vocab, rtol=0, atol=1e-4)


def test_compute_idf():
    rng = np.random.default_rng(2)
    binary = (rng.random((12, 40)) > 0.6).astype(np.float32)
    mask = rng.random(12) > 0.3
    ref = np.asarray(ref_bow.compute_idf(jnp.asarray(binary), jnp.asarray(mask)))
    got = bow.compute_idf(_t(binary), _t(mask)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    empty = bow.compute_idf(_t(binary), _t(np.zeros(12, bool))).numpy()
    np.testing.assert_allclose(empty, np.log(2.0), rtol=1e-6)


def test_train_vocabulary_from_maps():
    """Hamming k-medians over maps' descriptors from the reference's draw:
    the same words exactly (integer votes, ties to the lower word)."""
    rng = np.random.default_rng(3)
    batches = [rng.integers(0, 256, (n, 32), dtype=np.uint8) for n in (90, 130, 60)]
    ref = ref_train_from_maps(batches, k=64, iters=3, seed=5)
    idx = np.asarray(jax.random.choice(jax.random.PRNGKey(5), 280, (64,), replace=False))
    got = kf_database.train_vocabulary_from_maps(batches, k=64, iters=3, idx=_t(idx),
                                                 device="cpu")
    np.testing.assert_array_equal(got, ref)


# ------------------------------------------------------------ the database
def test_database_l2_matches_reference(world_vocab):
    """`KeyframeDatabase` with a float32 vocabulary (the L2 metric) against
    the reference's, window by window and keyframe by keyframe: rows,
    ``valid`` masks and common-word counts exactly, scores and rows to
    rtol 1e-6 (as tests/test_torch_kf_database.py), on windows whose every
    word assignment is clear by 2 * L2_TOL (asserted)."""
    world, vocab = world_vocab
    rng = np.random.default_rng(4)
    kfs = [_observed(rng, world.lm_descs[rng.permutation(600)[:80]], n)
           for n in (60, 45, 80, 30, 70, 55)]
    for d in kfs:
        assert (_gap(descriptors.l2_distance_sq(_t(d), _t(vocab))) > 2 * L2_TOL).all()
    wins = [[((0, 0), kfs[0]), ((1, 0), kfs[1]), ((0, 1), kfs[2])],
            [((2, 0), kfs[3]), ((1, 0), kfs[1]), ((1, 1), kfs[4]), ((3, 0), kfs[5])]]
    ref, db = RefDB(vocab, capacity=4), KeyframeDatabase(vocab, capacity=4, device="cpu")
    assert db.metric == "l2" and ref.metric == "l2"
    for win in wins:
        r_out = ref.add_and_query_batch([k for k, _ in win], [d for _, d in win])
        out = db.add_and_query_batch([k for k, _ in win], [d for _, d in win])
        for r, p in zip(r_out, out):
            assert r["row"] == p["row"]
            np.testing.assert_array_equal(p["valid"], r["valid"])
            np.testing.assert_array_equal(p["common"], np.asarray(r["common"]))
            np.testing.assert_allclose(p["scores"], np.asarray(r["scores"]), rtol=1e-6,
                                       atol=1e-7)
    np.testing.assert_allclose(db.db.numpy(), np.asarray(ref._db), rtol=1e-6, atol=0)
    # the single-keyframe paths
    ref1, db1 = RefDB(vocab, capacity=2), KeyframeDatabase(vocab, capacity=2, device="cpu")
    for i, d in enumerate(kfs):
        assert ref1.add_keyframe((i, 0), d) == db1.add_keyframe((i, 0), d)
    np.testing.assert_allclose(db1.db.numpy(), np.asarray(ref1._db), rtol=1e-6, atol=0)
    r_s, r_c = ref1.query(kfs[2], exclude_rows=np.asarray([0]))
    s, c = db1.query(kfs[2], exclude_rows=np.asarray([0]))
    np.testing.assert_array_equal(c, r_c)
    np.testing.assert_allclose(s, r_s, rtol=1e-6, atol=1e-7)
    assert vocabulary_from_reference(vocab).dtype == np.float32


def test_database_window_layout_l2():
    """The packed window of the L2 metric: (W, F, 128) float32 descriptors
    at offset 0, then the mask, then the int64 destinations on an 8-byte
    boundary; numpy and torch views of one buffer agree."""
    w, f = 3, 5
    nbytes = kf_database.DESC_BYTES["l2"]
    mask_at, dest_at, total = kf_database.window_layout(w, f, nbytes)
    assert (mask_at, dest_at, total) == (w * f * 512, w * f * 512 + 16, w * f * 512 + 40)
    buf = np.zeros(total, np.uint8)
    d, m, dst = kf_database.window_views(buf, w, f, nbytes)
    assert d.shape == (w, f, 128) and d.dtype == np.float32
    d[1, 2, 3], m[2, 4], dst[1] = 1.5, True, 7
    td, tm, tdst = kf_database.window_views(_t(buf), w, f, nbytes)
    assert float(td[1, 2, 3]) == 1.5 and bool(tm[2, 4]) and int(tdst[1]) == 7


# ------------------------------------------------------------ K14 and COVINS-G
def _ratio_scene(rng, world, M, seg, n_seg):
    """Query rows observing some candidate columns (true matches near
    d = 128, other pairs near 440), a tenth of rows and columns masked,
    duplicated columns (ties inside a segment and across segments)."""
    lm = world.lm_descs
    b = _observed(rng, lm[:300], seg * n_seg)
    a = _observed(rng, lm[:300], M)
    src = rng.integers(0, seg * n_seg, M // 2)
    a[: M // 2] = np.abs(b[src] + rng.normal(0.0, 8.0, (M // 2, 128))).astype(np.float32)
    b[seg - 1] = b[3]  # the same column twice in segment 0
    b[seg + 3] = b[3]  # and again in segment 1
    a[0] = b[3]
    am, bm = rng.random(M) > 0.1, rng.random(seg * n_seg) > 0.1
    am[0] = bm[3] = bm[seg - 1] = bm[seg + 3] = True
    return a, am, b, bm


def test_l2_ratio_match_plain_matches_reference(world_vocab):
    """K14's plain version against the reference's `jnp.sqrt(l2_distance_sq)`,
    `masked_dist`, `knn2` and `match_ratio` per segment: matches exactly
    wherever both gates clear by 2 * L2_TOL on the squared distances
    (asserted for all but a few rows), the distances within L2_TOL / (2 d)
    + 1 ulp; ties to the lower column."""
    world, _ = world_vocab
    rng = np.random.default_rng(6)
    M, seg, n_seg, max_dist, ratio = 300, 100, 3, 500.0, 0.8
    a, am, b, bm = _ratio_scene(rng, world, M, seg, n_seg)
    idx, d1, d2 = descriptors.l2_ratio_match(_t(a), _t(am), _t(b), _t(bm), seg, max_dist,
                                             ratio)
    dist = ref_desc.masked_dist(jnp.sqrt(ref_desc.l2_distance_sq(jnp.asarray(a),
                                                                 jnp.asarray(b))),
                                jnp.asarray(am), jnp.asarray(bm))
    x2 = descriptors.l2_distance_sq(_t(a), _t(b)).numpy()
    n_clear = 0
    for j in range(n_seg):
        block = dist[:, j * seg:(j + 1) * seg]
        r_idx = np.asarray(ref_desc.match_ratio(block, max_dist=max_dist, ratio=ratio))
        _, r1, r2 = (np.asarray(x) for x in ref_desc.knn2(block))
        # the squared distances of the decisions, valid rows and columns only
        xs = np.where(bm[None, j * seg:(j + 1) * seg], x2[:, j * seg:(j + 1) * seg], np.inf)
        s = np.sort(xs, axis=1)
        margin = np.minimum(np.abs(s[:, 0] - max_dist ** 2),
                            np.abs(s[:, 0] - ratio ** 2 * s[:, 1]))
        clear = am & (margin > 2 * L2_TOL)
        n_clear += clear.sum()
        np.testing.assert_array_equal(idx[:, j].numpy()[clear], r_idx[clear])
        np.testing.assert_array_equal(idx[:, j].numpy()[~am], -1)
        for got, want in ((d1, r1), (d2, r2)):
            g = got[:, j].numpy()
            tol = L2_TOL / (2 * np.maximum(want, 1.0)) + np.spacing(want)
            assert (np.abs(g - want) <= tol).all()
    assert n_clear >= 0.99 * am.sum() * n_seg
    # row 0 is column 3: twice in segment 0 (d1 = d2 = 0 fails the ratio
    # gate), once in segment 1
    assert int(idx[0, 0]) == -1 and float(d1[0, 0]) == 0.0 and float(d2[0, 0]) == 0.0
    assert int(idx[0, 1]) == 3 and float(d1[0, 1]) == 0.0 and float(d2[0, 1]) > 0.0
    assert (d1[~am] == 2**30).all() and (d2[~am] == 2**30).all()
    assert int((idx >= 0).sum()) > M // 3


# `_covinsg_verify_impl`'s thresholds at focal 458 px with the SIFT settings
# of tests/test_sift_mode.py (img_match_thres 500, nc_min_inliers 30,
# nc_cov_thres 100)
L2_G_PARAMS = dict(img_match_thres=500.0, ratio_thres=0.8,
                   thr5=float(np.arctan2(16.0, 458.0)), rel_min_img_matches=20,
                   rel_min_inliers=20, thr17=float(np.arctan2(1.5, 458.0)),
                   nc_min_inliers=30, thr_cov_rad=float(np.arctan2(10.0, 458.0)),
                   nc_cov_thres=100.0)
G_KEYS = ("qo", "qd", "co", "cd", "q_desc", "c_desc", "qmask", "cmask", "qbear", "cbear")
G_F, G_NQ, G_NC, G_HYP5, G_H17, G_COV = 256, 2, 3, 200, 512, 60


@pytest.mark.parametrize("case", ["loop", "no_overlap"])
def test_covinsg_verify_l2_matches_reference(case):
    """`covinsg_verify(metric="l2", solver="8pt")` (K14's and K12's plain
    versions) against `_covinsg_verify_impl(metric="l2")` on a two-rig
    SIFT scene with the reference's draws injected: the gates, every
    pair's matches and central inliers, the pool and the 17-point inliers
    exactly (every matching decision clear by 2 * L2_TOL, asserted), T_12
    to 1e-7 and the covariance to 1e-6 of its largest entry, as
    tests/test_torch_loopverify.py holds the ORB verification."""
    sc = synthetic.covins_g_scene(np.random.default_rng(1), G_F, G_NQ, G_NC, sift=True)
    if case == "no_overlap":  # the candidate rig sees another scene
        other = synthetic.covins_g_scene(np.random.default_rng(2), G_F, G_NQ, G_NC, sift=True)
        for k in ("co", "cd", "c_desc", "cmask", "cbear"):
            sc[k] = other[k]
    assert sc["q_desc"].dtype == np.float32
    x2 = descriptors.l2_distance_sq(_t(sc["q_desc"]), _t(sc["c_desc"])).numpy()
    for j in range(G_NC):
        xs = np.where(sc["cmask"][None, j * G_F:(j + 1) * G_F], x2[:, j * G_F:(j + 1) * G_F],
                      np.inf)
        s = np.sort(xs, axis=1)[sc["qmask"]]
        assert (np.abs(s[:, 0] - 0.64 * s[:, 1]) > 2 * L2_TOL).all()
    key = jax.random.PRNGKey(3)
    ref = jax.device_get(ref_lv._covinsg_verify_impl(
        key, *(jnp.asarray(sc[k]) for k in G_KEYS), *L2_G_PARAMS.values(), nq_rig=G_NQ,
        nc_rig=G_NC, Fq=G_F, Fc=G_F, n_hyp5=G_HYP5, n_hyp17=G_H17, n_cov=G_COV,
        solver="8pt", metric="l2"))
    keys = jax.random.split(key, G_NQ * G_NC + 2)
    n_pairs = G_NQ * G_NC
    g = lambda kk, shape: torch.from_numpy(np.array(jax.random.gumbel(kk, shape)))  # noqa: E731
    out = loopverify.covinsg_verify(
        *(_t(sc[k]) for k in G_KEYS), **L2_G_PARAMS, nq_rig=G_NQ, nc_rig=G_NC, Fq=G_F,
        Fc=G_F, n_hyp5=G_HYP5, n_hyp17=G_H17, n_cov=G_COV, solver="8pt", metric="l2",
        noise5=torch.stack([g(keys[i], (G_HYP5, G_F)) for i in range(n_pairs)]),
        noise17=g(keys[-2], (G_H17, n_pairs * G_F)),
        noise_cov=g(keys[-1], (G_COV, n_pairs * G_F)))
    for k in ("ok", "pairs_ok", "n_inliers", "n_pool"):
        assert int(out[k]) == int(ref[k]), k
    for k in ("pair_n_match", "pair_n_inl"):
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref[k]))
    if case == "loop":
        assert bool(out["ok"])
        np.testing.assert_allclose(out["T_12"].numpy(), np.asarray(ref["T_12"]), rtol=0,
                                   atol=1e-7)
        rc = np.asarray(ref["cov"])
        np.testing.assert_allclose(out["cov"].numpy(), rc, rtol=0,
                                   atol=1e-6 * np.abs(rc).max())
    else:
        assert not bool(out["pairs_ok"])


# ------------------------------------------------------------ K5's L2 metric
@pytest.mark.parametrize("view_angle", [False, True])
def test_project_match_l2_matches_reference(view_angle):
    """`project_match` on float32 descriptors (the plain version of K5's L2
    metric) against the reference's `metric="l2"`: matches exactly,
    distances within 1e-9, on a scene with duplicated features and
    landmarks (ties and conflicts) and gates of every kind."""
    rng = np.random.default_rng(11 + view_angle)
    args, kw = synthetic.project_match_scene(rng, 400, 300, "cpu", camera="radtan",
                                             view_angle=view_angle, sift=True)
    c, T_cw, p_w, lm_desc, normal, lm_mask, rng_, kp_uv, kp_desc, kp_oct, kp_free = args[:11]
    radius, max_dist, img_w, img_h = args[11:]
    rc = ref_cam.Camera(*(jnp.asarray(x.numpy()) for x in (c.intrinsics, c.dist, c.T_s_c)),
                        c.cam_model, c.dist_model)
    j = lambda x: jnp.asarray(x.numpy())  # noqa: E731
    ref = ref_pm.project_match(rc, j(T_cw), j(p_w), j(lm_desc), j(normal), j(lm_mask),
                               j(kp_uv), j(kp_desc), j(kp_oct), j(kp_free), radius_px=radius,
                               max_dist=max_dist, img_w=img_w, img_h=img_h,
                               check_view_angle=view_angle, lm_dist_rng=j(rng_))
    got = projmatch.project_match(c, T_cw, p_w, lm_desc, normal, lm_mask, kp_uv, kp_desc,
                                  kp_oct, kp_free, radius, max_dist, img_w, img_h,
                                  check_view_angle=view_angle, lm_dist_rng=rng_)
    assert got[1].dtype == torch.float64
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), rtol=0, atol=1e-9)
    assert int((got[0] >= 0).sum()) > 10
    core = projmatch.project_match_core(*args, **kw)
    plain = projmatch.project_match_plain(*args, **kw)
    assert all(torch.equal(x, y) for x, y in zip(core, plain))


# ------------------------------------------------------------ the session
G_CFG = dict(feat_type="SIFT", desc_length=128, placerec_type="COVINS_G",
             img_match_thres=500.0, start_after_kf=2, consecutive_loop_dist=6,
             min_loop_dist=6, exclude_kfs_with_id_less_than=2, cov_consistency_thres=2,
             nc_min_inliers=30, nc_cov_thres=100.0, rel_min_img_matches=10,
             rel_min_inliers=10, max_trans=8.0, perform_pgo=False,
             activate_lm_culling=False, rel_minimal_solver="8pt")
G_FEATURES = 256  # both packages' maps; the stream keeps fewer a keyframe


def _jax_draws(monkeypatch):
    """Hand the port's COVINS-G verifications the reference's Gumbel draws
    (as tests/test_torch_placerec.py does)."""
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


def _loops(mp):
    return [(tuple(int(x) for x in mp.kf_ids[lc["kf1"]]),
             tuple(int(x) for x in mp.kf_ids[lc["kf2"]])) for lc in mp.loops]


def test_sift_covins_g_session_matches_reference(world_vocab, monkeypatch, tmp_path):
    """The counterpart of `tests/test_sift_mode.py::test_sift_covins_g_loop`
    (slow-marked there) through both packages' `AgentSession`, one agent,
    30 keyframes revisiting their start, with the reference's world,
    vocabulary and draws and the 8-point prefilter (the reference's fused
    5-point program takes some 13 minutes to compile on the CPU).  Every
    word assignment and ratio-match gate of the port's run clears its
    margin by 2 * L2_TOL (recorded and asserted), so the exact comparisons
    hold: the same loops with the same candidates, the same accepted pairs,
    loop transforms and covariances within 1e-6 and every pose within
    1e-4."""
    world, vocab = world_vocab
    _jax_draws(monkeypatch)
    for mod in (ref_mm, mm):
        monkeypatch.setattr(mod, "Map", functools.partial(mod.Map, max_features=G_FEATURES))
    calls = {"argmin": [], "ratio": []}
    argmin, ratio_match = descriptors.l2_argmin, descriptors.l2_ratio_match

    def rec_argmin(a, b, row_mask=None):
        calls["argmin"].append((a.clone(), b, row_mask))
        return argmin(a, b, row_mask)

    def rec_ratio(a, am, b, bm, seg, max_dist, ratio):
        calls["ratio"].append((a, am, b, bm, seg, max_dist, ratio))
        return ratio_match(a, am, b, bm, seg, max_dist, ratio)
    monkeypatch.setattr(descriptors, "l2_argmin", rec_argmin)
    monkeypatch.setattr(descriptors, "l2_ratio_match", rec_ratio)

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

    # every decision of the port's run is clear of the rounding bound
    assert calls["argmin"] and calls["ratio"]
    for a, b, m in calls["argmin"]:
        gap = _gap(descriptors.l2_distance_sq(a, b))
        assert (gap[m.numpy() if m is not None else slice(None)] > 2 * L2_TOL).all()
    for a, am, b, bm, seg, max_dist, ratio in calls["ratio"]:
        x2 = descriptors.l2_distance_sq(a, b).numpy()
        for j in range(b.shape[0] // seg):
            xs = np.where(bm.numpy()[None, j * seg:(j + 1) * seg],
                          x2[:, j * seg:(j + 1) * seg], np.inf)
            s = np.sort(xs, axis=1)[am.numpy()]
            valid = np.isfinite(s[:, 1])
            assert (np.abs(s[valid, 0] - max_dist ** 2) > 2 * L2_TOL).all()
            assert (np.abs(s[valid, 0] - ratio ** 2 * s[valid, 1]) > 2 * L2_TOL).all()

    assert out == ref_out and out.count("loop") >= 1
    ref_mp, mp = ref_mgr.map_of(0), mgr.map_of(0)
    assert mp.descriptors.dtype == np.float32
    mp.save(str(tmp_path / "sift.npz"))  # a checkpoint keeps the float descriptors
    again = Map.load(str(tmp_path / "sift.npz"), device="cpu")
    assert again.descriptors.dtype == np.float32
    np.testing.assert_array_equal(again.descriptors[:mp.n_kf], mp.descriptors[:mp.n_kf])
    assert _loops(mp) == _loops(ref_mp)
    assert sorted(sess.accepted) == sorted(_loops(ref_mp))
    assert len(mp.loops) >= 1
    for lc, rl in zip(mp.loops, ref_mp.loops):
        assert lc["cov"] is not None
        np.testing.assert_allclose(lc["T_12"], np.asarray(rl["T_12"]), rtol=0, atol=1e-6)
        rc = np.asarray(rl["cov"])
        np.testing.assert_allclose(lc["cov"], rc, rtol=0, atol=1e-6 * np.abs(rc).max())
    np.testing.assert_allclose(mp.kf_pose, ref_mp.kf_pose, rtol=0, atol=1e-4)
