"""The port's P3P solver and P3P RANSAC against the JAX package.

The scene (landmarks seen by a camera, with outliers and a masked tail) is
made with numpy.  RANSAC draws differ between the packages (threefry
against torch), so the index sets of the JAX call are drawn with
`covins_tpu.ops.ransac.sample_minimal_sets` under the same key and
injected into the port.  Tolerances: P3P poses to 1e-9 where both call a
root valid (the solvers run the same float64 formulas; library rounding
differs at 1e-15, amplified by the quartic's conditioning); RANSAC inlier
counts and masks exactly; the best pose to 1e-9.  The Gumbel sampler is
checked to give the same sets as `jax.lax.top_k` when fed JAX's noise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from covins_tpu.ops import pnp as ref_pnp
from covins_tpu.ops import ransac as ref_ransac
from covins_tpu.utils import geometry as ref_geo
from covins_tpu_torch.ops import pnp, ransac


def _scene(seed, n=120, outliers=0.3, masked=10, noise=0.002):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    T_c_w = np.concatenate([q, rng.normal(size=3)])
    p_c = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                    rng.uniform(3, 9, n)], 1)
    p_w = np.asarray(ref_geo.pose_apply(ref_geo.pose_inverse(jnp.asarray(T_c_w)),
                                        jnp.asarray(p_c)))
    b = p_c + noise * rng.normal(size=p_c.shape)
    bad = rng.random(n) < outliers
    b[bad] = rng.normal(size=(int(bad.sum()), 3)) + [0, 0, 4]
    b /= np.linalg.norm(b, axis=1, keepdims=True)
    mask = np.ones(n, bool)
    mask[-masked:] = False
    return T_c_w, p_w, b, mask


def test_p3p_grunert_matches_reference():
    T, p_w, b, _ = _scene(0, n=3 * 64, outliers=0.0, noise=0.0)
    P = p_w.reshape(64, 3, 3)
    B = b.reshape(64, 3, 3)
    got_T, got_v = pnp.p3p_grunert(torch.tensor(P), torch.tensor(B))
    ref_T, ref_v = jax.vmap(ref_pnp.p3p_grunert)(jnp.asarray(P), jnp.asarray(B))
    ref_T, ref_v = np.asarray(ref_T), np.asarray(ref_v)
    np.testing.assert_array_equal(got_v.numpy(), ref_v)
    np.testing.assert_allclose(got_T.numpy()[ref_v], ref_T[ref_v], rtol=0, atol=1e-9)
    # some root of every triple recovers the true pose
    err = np.abs(got_T.numpy() - T).max(-1)
    assert (np.where(ref_v, err, 1.0).min(-1) < 1e-6).all()


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_absolute_pose_ransac_with_injected_draws(seed):
    T, p_w, b, mask = _scene(seed)
    key = jax.random.PRNGKey(seed)
    n_hyp, thr = 64, 0.006
    ref = ref_pnp.absolute_pose_ransac(key, jnp.asarray(p_w), jnp.asarray(b),
                                       jnp.asarray(mask), n_hypotheses=n_hyp,
                                       threshold_rad=thr)
    idx = ref_ransac.sample_minimal_sets(key, jnp.asarray(mask), n_hyp, 3)
    got = pnp.absolute_pose_ransac(torch.tensor(p_w), torch.tensor(b),
                                   torch.tensor(mask), n_hypotheses=n_hyp,
                                   threshold_rad=thr,
                                   idx=torch.tensor(np.asarray(idx)))
    assert int(got["n_inliers"]) == int(ref["n_inliers"]) > 40
    np.testing.assert_array_equal(got["inliers"].numpy(), np.asarray(ref["inliers"]))
    np.testing.assert_allclose(got["T_c_w"].numpy(), np.asarray(ref["T_c_w"]),
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose(got["T_c_w"].numpy(), T, atol=0.05)


def test_gumbel_sampler_matches_top_k_on_the_same_noise():
    _, _, _, mask = _scene(4)
    key = jax.random.PRNGKey(7)
    ref = ref_ransac.sample_minimal_sets(key, jnp.asarray(mask), 50, 3)
    noise = np.asarray(jax.random.gumbel(key, (50, len(mask)), jnp.float64))
    got = ransac.sample_minimal_sets(torch.tensor(noise), torch.tensor(mask), 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_gumbel_noise_is_seeded_and_standard():
    a = ransac.gumbel_noise(torch.Generator().manual_seed(3), 200, 500)
    b = ransac.gumbel_noise(torch.Generator().manual_seed(3), 200, 500)
    assert torch.equal(a, b) and a.dtype == torch.float64
    # standard Gumbel: mean = Euler-Mascheroni, var = pi^2 / 6
    assert abs(float(a.mean()) - 0.5772) < 0.02
    assert abs(float(a.var()) - np.pi ** 2 / 6) < 0.05


def test_p3p_score_plain_matches_reprojection_error():
    T, p_w, b, mask = _scene(5)
    rng = np.random.default_rng(5)
    Ts = np.repeat(T[None], 40, 0)
    Ts[1:, 4:] += 0.01 * rng.normal(size=(39, 3))
    valid = rng.random(40) > 0.2
    counts, best, inl, n_inl = pnp.p3p_score_plain(
        torch.tensor(Ts), torch.tensor(p_w), torch.tensor(b),
        torch.tensor(mask), torch.tensor(valid), 0.006)
    err = ref_pnp.reprojection_angular_error(jnp.asarray(Ts), jnp.asarray(p_w),
                                             jnp.asarray(b))
    got_err = pnp.reprojection_angular_error(torch.tensor(Ts), torch.tensor(p_w),
                                             torch.tensor(b))
    # acos amplifies a one-ulp cosine difference by 1 / sin(err): 1e-11
    # at the smallest errors here
    np.testing.assert_allclose(got_err.numpy(), np.asarray(err), rtol=0, atol=1e-10)
    ref_inl = (np.asarray(err) < 0.006) & mask[None]
    ref_counts = np.where(valid, ref_inl.sum(-1), -1)
    np.testing.assert_array_equal(counts.numpy(), ref_counts)
    assert int(best) == int(np.argmax(ref_counts))
    np.testing.assert_array_equal(inl.numpy(), ref_inl[int(best)])
    assert int(n_inl) == max(ref_counts.max(), 0)


@pytest.mark.parametrize("with_valid", [False, True])
def test_best_hypothesis_matches_reference(with_valid):
    rng = np.random.default_rng(6)
    counts = rng.integers(0, 30, 300).astype(np.int32)
    counts[[17, 120, 250]] = 40  # tied maxima: the first wins
    valid = rng.random(300) > 0.3
    valid[17] = False  # the first maximum invalid: the second wins
    v = valid if with_valid else None
    ref = ref_ransac.best_hypothesis(jnp.asarray(counts),
                                     None if v is None else jnp.asarray(v))
    got = ransac.best_hypothesis(torch.tensor(counts),
                                 None if v is None else torch.tensor(v))
    assert int(got) == int(ref) == (120 if with_valid else 17)


@pytest.mark.parametrize("sets", ["noise", "idx"])
def test_absolute_pose_ransac_from_stage1_matches_reference(sets):
    """Stage 2 as the verification calls it, from stage 1's matches: the
    candidate table, the query bearings, their validity and the matched
    rows (-1 = none).  The same as the gathered correspondences with the
    mask ``valid & rows >= 0``, and as the body of the JAX package's
    `absolute_pose_ransac` on those with the same minimal sets (for noise,
    `jax.lax.top_k`'s sets of the same masked noise): every root's count
    and the best index, the inliers exactly, the pose to 1e-9."""
    from covins_tpu_torch.utils.synthetic import p3p_scene

    (table, bear, mask), kw = p3p_scene(np.random.default_rng(21), 300, 80, 64, "cpu",
                                        sets=sets)
    rows = kw.pop("rows")
    got = pnp.absolute_pose_ransac(table, bear, mask, rows=rows, **kw)
    points = table[rows.clamp(min=0).long()]
    valid = mask & (rows >= 0)
    same = pnp.absolute_pose_ransac(points, bear, valid, **kw)
    for k in got:
        assert torch.equal(got[k], same[k]), k
    P, B, v = (jnp.asarray(x.numpy()) for x in (points, bear, valid))
    if sets == "noise":
        idx = jax.lax.top_k(jnp.where(v[None], jnp.asarray(kw["noise"].numpy()), -jnp.inf),
                            3)[1]
    else:
        idx = jnp.asarray(kw["idx"].numpy())
    T, ok = jax.vmap(lambda ix: ref_pnp.p3p_grunert(P[ix], B[ix]))(idx)
    T = T.reshape(-1, 7)
    inl = (ref_pnp.reprojection_angular_error(T, P, B) < kw["threshold_rad"]) & v[None]
    counts = np.asarray(jnp.where(ok.reshape(-1), inl.sum(-1), -1))
    best = int(np.argmax(counts))
    np.testing.assert_array_equal(got["counts"].numpy(), counts)
    assert int(got["best"]) == best and int(got["n_inliers"]) == counts[best] > 40
    np.testing.assert_array_equal(got["inliers"].numpy(), np.asarray(inl[best]))
    np.testing.assert_allclose(got["T_c_w"].numpy(), np.asarray(T[best]), rtol=0, atol=1e-9)


def test_minimal_sets_with_fewer_than_three_valid_match_top_k():
    """With fewer valid correspondences than a minimal set holds, the sets
    fill with invalid ones, the lowest indices first, as `jax.lax.top_k`
    orders ties."""
    rng = np.random.default_rng(8)
    noise = rng.gumbel(size=(40, 50))
    for n_valid in (0, 1, 2):
        mask = np.zeros(50, bool)
        mask[rng.choice(50, n_valid, replace=False)] = True
        g = jnp.where(jnp.asarray(mask)[None], jnp.asarray(noise), -jnp.inf)
        ref = np.asarray(jax.lax.top_k(g, 3)[1])
        got = ransac.sample_minimal_sets(torch.tensor(noise), torch.tensor(mask), 3)
        np.testing.assert_array_equal(got.numpy(), ref)


def _rig_scene(seed, n=60, rig_spread=0.6, outliers=0):
    """A non-central scene: rays from n distinct origins in the rig frame
    (the JAX package's `_random_rig_scene` with numpy draws)."""
    rng = np.random.default_rng(seed)
    points = rng.uniform(-5, 5, (n, 3)) + [0.0, 0.0, 12.0]
    T = np.array(ref_geo.pose_from_qt(ref_geo.quat_exp(jnp.asarray(rng.normal(size=3) * 0.3)),
                                      jnp.asarray(rng.normal(size=3) * 2.0)))
    origins = rng.normal(size=(n, 3)) * rig_spread
    d = np.array(ref_geo.pose_apply(jnp.asarray(T)[None], jnp.asarray(points))) - origins
    bearings = d / np.linalg.norm(d, axis=1, keepdims=True)
    bad = rng.normal(size=(outliers, 3))
    bearings[:outliers] = bad / np.linalg.norm(bad, axis=1, keepdims=True)
    return points, origins, bearings, T


@pytest.mark.parametrize("spread", [0.6, 0.0])
def test_gp3p_kneip_matches_reference(spread):
    """The generalized P3P on 24 triples, central (spread 0) and not:
    validity exactly, poses to 1e-7 where valid (relative above 1: the
    resultant's degree-8 coefficients come out of a chain of products, and
    its close roots amplify their rounding; measured 6.7e-9), and the true
    pose among the valid roots of most triples (the reference's bracketing
    root finder misses close roots: 18 of 24 here, in both packages)."""
    P, O, B, T = zip(*(_rig_scene(s, n=3, rig_spread=spread) for s in range(24)))
    P, O, B = (np.stack(x) for x in (P, O, B))
    got_T, got_v = pnp.gp3p_kneip(torch.tensor(P), torch.tensor(O), torch.tensor(B))
    ref_T, ref_v = jax.jit(jax.vmap(ref_pnp.gp3p_kneip))(*map(jnp.asarray, (P, O, B)))
    ref_T, ref_v = np.asarray(ref_T), np.asarray(ref_v)
    np.testing.assert_array_equal(got_v.numpy(), ref_v)
    np.testing.assert_allclose(got_T.numpy()[ref_v], ref_T[ref_v], rtol=1e-7, atol=1e-7)
    err = np.abs(got_T.numpy() - np.stack(T)[:, None]).max(-1)
    assert (np.where(ref_v, err, 1.0).min(-1) < 1e-5).mean() >= 0.5


def test_generalized_absolute_pose_ransac_matches_reference():
    points, origins, bearings, T = _rig_scene(21, n=60, outliers=18)
    mask = np.ones(60, bool)
    mask[-5:] = False
    key = jax.random.PRNGKey(4)
    ref = ref_pnp.generalized_absolute_pose_ransac(
        key, *map(jnp.asarray, (points, origins, bearings, mask)), n_hypotheses=64,
        threshold_rad=0.002)
    noise = np.array(jax.random.gumbel(key, (64, 60)))
    got = pnp.generalized_absolute_pose_ransac(
        *map(torch.tensor, (points, origins, bearings, mask)), 64, 0.002,
        noise=torch.tensor(noise))
    assert int(got["n_inliers"]) == int(ref["n_inliers"]) >= 30
    np.testing.assert_array_equal(got["inliers"].numpy(), np.asarray(ref["inliers"]))
    np.testing.assert_allclose(got["T_rig_w"].numpy(), np.asarray(ref["T_rig_w"]),
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose(
        pnp.generalized_reprojection_angular_error(
            got["T_rig_w"], *map(torch.tensor, (points, origins, bearings))).numpy(),
        np.asarray(ref_pnp.generalized_reprojection_angular_error(
            ref["T_rig_w"], *map(jnp.asarray, (points, origins, bearings)))),
        rtol=0, atol=5e-8)
    assert float(pnp.px_threshold_to_angular(1.5, 458.0)) == \
        float(ref_pnp.px_threshold_to_angular(1.5, 458.0))
