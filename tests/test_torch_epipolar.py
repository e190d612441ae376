"""The port's epipolar solvers and RANSACs (`ops/epipolar.py`, the plain
version of kernel K12) against the JAX package, on the same numpy inputs
and the JAX package's own Gumbel draws (`jax.random.gumbel` under the key
the reference's sampler uses), so both take the same minimal sets.

Tolerances: inlier counts, inlier masks, the best hypothesis and every
validity flag exactly (the two packages round the poses apart by about
1e-14, far from any ray's distance to the threshold on these scenes).
Poses from minimal samples to 1e-9 (the nullspace solvers amplify
rounding; measured 1e-11 to 1e-13), the 5-point RANSAC's pose to 1e-6
(its nullspace basis is rounding-defined: measured 5e-8), the
sampling covariance to 1e-6 relative to its largest entry (deviations of
about 1e-2 between re-solves that agree to 1e-9; measured 5.7e-8), the
triangulation to 1e-12 and the angular error to 5e-8 (arccos near 1: one
ulp of the cosine is 1.5e-8 of angle).  A NaN pose (a degenerate
17-point sample) counts 0 in both.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from covins_tpu.ops import align3d as ref_align3d
from covins_tpu.ops import epipolar as ref_epi
from covins_tpu.ops import linalg as ref_la
from covins_tpu.utils import geometry as ref_geo
from covins_tpu_torch.ops import align3d, epipolar as epi
from covins_tpu_torch.ops import linalg as la

POSE_TOL = 1e-9


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x))


def _unit(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _pose(rng, rot=0.2, trans=1.0, unit_t=False):
    w = rng.normal(size=3) * rot
    t = rng.normal(size=3) * trans
    if unit_t:
        t = _unit(t)
    return np.array(ref_geo.pose_from_qt(ref_geo.quat_exp(jnp.asarray(w)), jnp.asarray(t)))


def _central(rng, n=100, n_out=30):
    pts = rng.uniform(-4, 4, (n, 3)) + [0.0, 0.0, 10.0]
    T = _pose(rng, unit_t=True)
    fa = _unit(pts)
    fb = _unit(np.array(ref_geo.pose_apply(ref_geo.pose_inverse(jnp.asarray(T))[None],
                                             jnp.asarray(pts))))
    fb[:n_out] = _unit(rng.normal(size=(n_out, 3)))
    return fa, fb, T


def _noncentral(rng, n=120, n_out=20):
    pts = rng.uniform(-6, 6, (n, 3)) + [0.0, 0.0, 12.0]
    T = _pose(rng, rot=0.25, trans=2.0)
    va = (rng.normal(size=(3, 3)) * 0.8)[np.arange(n) % 3]
    vb = (rng.normal(size=(3, 3)) * 0.8)[np.arange(n) % 3]
    fa = _unit(pts - va)
    pb = np.array(ref_geo.pose_apply(ref_geo.pose_inverse(jnp.asarray(T))[None],
                                       jnp.asarray(pts)))
    fb = _unit(pb - vb)
    fb[:n_out] = _unit(rng.normal(size=(n_out, 3)))
    return va, fa, vb, fb, T


def _gumbel(key, shape):
    return np.asarray(jax.random.gumbel(key, shape))


def _assert_same(out, ref, tol=POSE_TOL):
    assert int(out["n_inliers"]) == int(ref["n_inliers"])
    np.testing.assert_array_equal(out["inliers"].numpy(), np.asarray(ref["inliers"]))
    np.testing.assert_allclose(out["T_a_b"].numpy(), np.asarray(ref["T_a_b"]),
                               rtol=0, atol=tol)


def test_triangulation_and_ray_error_match_reference():
    rng = np.random.default_rng(0)
    va, fa, vb, fb, T = _noncentral(rng, n=60)
    Ts = np.stack([T, _pose(rng), _pose(rng), np.full(7, np.nan)])
    X, ok = epi.triangulate_midpoint(_t(va), _t(fa), _t(vb), _t(fb))
    rX, rok = ref_epi.triangulate_midpoint(*map(jnp.asarray, (va, fa, vb, fb)))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(rok))
    np.testing.assert_allclose(X.numpy(), np.asarray(rX), rtol=0, atol=1e-12)
    err = epi.ray_angular_error(_t(Ts), _t(va), _t(fa), _t(vb), _t(fb))
    ref = np.asarray(ref_epi.ray_angular_error(*map(jnp.asarray, (Ts, va, fa, vb, fb))))
    np.testing.assert_array_equal(np.isnan(err.numpy()), np.isnan(ref))
    assert (ref[3] == np.pi).all()  # a NaN pose fails the triangulation
    # arccos near 1 turns one ulp of the cosine into sqrt(2 * 1.1e-16) =
    # 1.5e-8 of angle: the true pose's errors (~1e-8) agree to that
    np.testing.assert_allclose(err.numpy(), ref, rtol=0, atol=5e-8)


@pytest.mark.parametrize("with_valid", [False, True])
def test_ray_ransac_score_matches_reference_scoring(with_valid):
    """Three RANSACs in one batch with differing masks, central and
    non-central rays, NaN poses: the reference's err < thr & mask (&
    valid), its counts, first argmax and best row."""
    rng = np.random.default_rng(1)
    B, H, N, thr = 3, 40, 90, 0.004
    rays, T = [], []
    for b in range(B):
        va, fa, vb, fb, Tt = _noncentral(rng, n=N)
        if b == 1:  # a central batch entry
            va, vb = np.zeros_like(va), np.zeros_like(vb)
        rays.append((va, fa, vb, fb))
        Tb = np.stack([_pose(rng, 0.01, 0.05) for _ in range(H)])
        Tb = np.array(ref_geo.pose_compose(jnp.asarray(Tt)[None], jnp.asarray(Tb)))
        Tb[::7] = np.nan  # degenerate samples
        T.append(Tb)
    T = np.stack(T)
    va, fa, vb, fb = (np.stack([r[k] for r in rays]) for k in range(4))
    mask = rng.random((B, N)) > 0.2
    mask[2, :] = False  # an empty batch entry
    valid = rng.random((B, H)) > 0.3 if with_valid else None
    counts, best, inl = epi.ray_ransac_score(
        _t(T), _t(va), _t(fa), _t(vb), _t(fb), _t(mask), thr,
        valid=None if valid is None else _t(valid))
    for b in range(B):
        err = np.asarray(ref_epi.ray_angular_error(*map(jnp.asarray, (
            T[b], va[b], fa[b], vb[b], fb[b]))))
        ref_inl = (err < thr) & mask[b][None]
        if valid is not None:
            ref_inl &= valid[b][:, None]
        ref_counts = ref_inl.sum(-1)
        np.testing.assert_array_equal(counts[b].numpy(), ref_counts)
        assert int(best[b]) == int(np.argmax(ref_counts))
        np.testing.assert_array_equal(inl[b].numpy(), ref_inl[int(best[b])])
        assert (counts[b].numpy()[np.isnan(T[b, :, 0])] == 0).all()
    assert int(counts[:2].max()) > 40  # the true poses' neighbours score
    only = epi.ray_ransac_score(_t(T), _t(va), _t(fa), _t(vb), _t(fb), _t(mask), thr,
                                want_inliers=False)
    assert only[1] is None and only[2] is None
    if valid is None:
        assert torch.equal(only[0], counts)


def test_essential_8pt_and_decomposition_match_reference():
    rng = np.random.default_rng(2)
    fa, fb, _ = _central(rng, n=40, n_out=0)
    E = epi.essential_8pt(_t(fa), _t(fb))
    rE = np.asarray(ref_epi.essential_8pt(jnp.asarray(fa), jnp.asarray(fb)))
    np.testing.assert_allclose(E.numpy(), rE, rtol=0, atol=POSE_TOL)
    np.testing.assert_allclose(epi.decompose_essential(_t(rE)).numpy(),
                               np.asarray(ref_epi.decompose_essential(jnp.asarray(rE))),
                               rtol=0, atol=1e-12)


def _ref_essential_5pt_from_basis(fa, fb, V):
    """The reference's essential_5pt with its Jacobi eigenvectors replaced
    by the given V (9, 9): its polynomial and root stage on that basis."""
    saved = ref_epi.la_small
    ref_epi.la_small = types.SimpleNamespace(jacobi_eigh=lambda M: (None, V))
    try:
        return ref_epi.essential_5pt(fa, fb)
    finally:
        ref_epi.la_small = saved


def test_essential_5pt_matches_reference():
    """Five bearing pairs span a 4-dimensional nullspace whose Jacobi basis
    turns within itself under one ulp of A^T A, and the root finder misses
    close pairs of real roots of the degree-10 polynomial, so which true
    roots survive depends on the basis: on one host the port's own basis
    and the reference's jitted and eager ones found 4, 6, 6, 4, 4, 4; 4,
    2, 6, 4, 4, 4; 2, 4, 4, 4, 2, 2 real roots on these samples, and on
    another the port's 4, 4, 6, 4, 4, 4, its candidates on sample 1 all
    0.53-0.76 from the true matrix (the reference's jitted and eager runs
    missed it there too, and on samples 5 and 4).  The samples come
    through the JAX package's geometry, compiled for the host, so they
    move by an ulp between hosts.  Held, on each of two bases handed to
    both packages' polynomial and root stage, the reference's Jacobi basis
    and the port's own (`essential_5pt`'s): the same valid flags exactly,
    every valid essential matrix to 1e-7 (the degree-10 roots amplify the
    coefficients' rounding: measured 9.7e-9), and the true matrix among
    the port's candidates wherever it is among the reference's on that
    basis; and every valid candidate of the port's `essential_5pt` solves
    the five epipolar constraints to 1e-9."""
    rng = np.random.default_rng(3)
    samples = [_central(rng, n=5, n_out=0) for _ in range(6)]
    fa = np.stack([s[0] for s in samples])
    fb = np.stack([s[1] for s in samples])
    ref_from_basis = jax.jit(jax.vmap(_ref_essential_5pt_from_basis))

    def ref_basis(a, b):
        A = (a[:, :, None] * b[:, None, :]).reshape(5, 9)
        return ref_la.jacobi_eigh(A.T @ A)[1]

    def as_basis(V):
        return V[..., :, :4].transpose(-1, -2).reshape(6, 4, 3, 3)

    def held_on(V, E, valid, least_valid):
        rE, rvalid = ref_from_basis(jnp.asarray(fa), jnp.asarray(fb), jnp.asarray(V.numpy()))
        rE, rvalid = np.asarray(rE), np.asarray(rvalid)
        np.testing.assert_array_equal(valid.numpy(), rvalid)
        assert rvalid.sum() >= least_valid
        np.testing.assert_allclose(E.numpy()[rvalid], rE[rvalid], rtol=0, atol=1e-7)
        for i, T in enumerate(s[2] for s in samples):
            t, R = T[4:], np.asarray(ref_geo.quat_to_matrix(jnp.asarray(T[:4])))
            tx = np.asarray([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
            E_true = tx @ R / np.linalg.norm(tx @ R)

            def nearest(Es):
                return np.minimum(np.abs(Es - E_true).max((1, 2)),
                                  np.abs(Es + E_true).max((1, 2))).min(initial=np.inf)
            if nearest(rE[i][rvalid[i]]) < 1e-7:
                assert nearest(E.numpy()[i][valid.numpy()[i]]) < 1e-7, f"sample {i}"

    # the reference's basis
    V = _t(jax.jit(jax.vmap(ref_basis))(jnp.asarray(fa), jnp.asarray(fb)))
    held_on(V, *epi.essential_5pt_from_basis(as_basis(V)), least_valid=12)

    # the port's own basis, as essential_5pt computes it
    A = (_t(fa)[..., :, :, None] * _t(fb)[..., :, None, :]).reshape(6, 5, 9)
    _, V = la.jacobi_eigh(epi._gram(A))
    E, valid = epi.essential_5pt(_t(fa), _t(fb))
    E_b, valid_b = epi.essential_5pt_from_basis(as_basis(V))
    assert torch.equal(valid, valid_b) and torch.equal(E[valid], E_b[valid_b])
    held_on(V, E, valid, least_valid=12)
    for i in range(6):
        Es = E.numpy()[i][valid.numpy()[i]]
        res = np.einsum("ni,cij,nj->cn", fa[i], Es, fb[i])
        assert len(Es) and np.abs(res).max() < 1e-9


@pytest.mark.parametrize("solver", ["8pt", "5pt"])
def test_central_ransac_matches_reference(solver):
    """A batch of three central RANSACs against the reference's one at a
    time, each with its own key's draws and its own mask."""
    rng = np.random.default_rng(4)
    B, N, H = 3, 100, 32
    ref_fn, fn, k = ((ref_epi.relative_pose_ransac_central, epi.relative_pose_ransac_central, 8)
                     if solver == "8pt" else
                     (ref_epi.relative_pose_ransac_central_5pt,
                      epi.relative_pose_ransac_central_5pt, 5))
    scenes = [_central(rng, n=N, n_out=15) for _ in range(B)]
    fa = np.stack([s[0] for s in scenes])
    fb = np.stack([s[1] for s in scenes])
    mask = rng.random((B, N)) > 0.15
    keys = jax.random.split(jax.random.PRNGKey(5), B)
    noise = np.stack([_gumbel(keys[b], (H, N)) for b in range(B)])
    out = fn(_t(fa), _t(fb), _t(mask), H, 0.002, noise=_t(noise))
    for b in range(B):
        ref = ref_fn(keys[b], jnp.asarray(fa[b]), jnp.asarray(fb[b]), jnp.asarray(mask[b]),
                     n_hypotheses=H, threshold_rad=0.002)
        # a 5-point pose comes from a root in a nullspace basis each
        # package rounds its own way (test_essential_5pt...): 5e-8 apart
        _assert_same({k_: v[b] for k_, v in out.items()}, ref,
                     tol=POSE_TOL if solver == "8pt" else 1e-6)
        assert int(ref["n_inliers"]) >= 40
    # one RANSAC, unbatched
    one = fn(_t(fa[0]), _t(fb[0]), _t(mask[0]), H, 0.002, noise=_t(noise[0]))
    _assert_same(one, {k_: v[0] for k_, v in out.items()}, tol=0.0)


def test_gep_17pt_matches_reference():
    rng = np.random.default_rng(6)
    va, fa, vb, fb, T = _noncentral(rng, n=40, n_out=0)
    got = epi.gep_17pt(_t(va), _t(fa), _t(vb), _t(fb))
    ref = np.asarray(ref_epi.gep_17pt(*map(jnp.asarray, (va, fa, vb, fb))))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=POSE_TOL)
    np.testing.assert_allclose(got.numpy(), T, rtol=0, atol=1e-6)
    w = (rng.random(40) > 0.3).astype(np.float64)
    got = epi.gep_17pt(_t(va), _t(fa), _t(vb), _t(fb), weights=_t(w))
    ref = np.asarray(ref_epi.gep_17pt(*map(jnp.asarray, (va, fa, vb, fb)), weights=jnp.asarray(w)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=POSE_TOL)


def test_noncentral_ransac_and_covariance_match_reference():
    rng = np.random.default_rng(7)
    va, fa, vb, fb, _ = _noncentral(rng, n=120)
    va[:3] = va[3]  # three repeated rays: degenerate samples give NaN poses
    fa[:3], vb[:3], fb[:3] = fa[3], vb[3], fb[3]
    mask = rng.random(120) > 0.1
    key = jax.random.PRNGKey(9)
    k17, kc = jax.random.split(key)
    ref = ref_epi.relative_pose_ransac_noncentral(
        k17, *map(jnp.asarray, (va, fa, vb, fb, mask)), n_hypotheses=128,
        threshold_rad=0.002)
    out = epi.relative_pose_ransac_noncentral(
        *map(_t, (va, fa, vb, fb, mask)), 128, 0.002, noise=_t(_gumbel(k17, (128, 120))))
    _assert_same(out, ref)
    assert int(ref["n_inliers"]) >= 80
    # the sampling covariance of the reference's pose and inliers
    rc, rn = ref_epi.sampling_covariance(
        kc, ref["T_a_b"], *map(jnp.asarray, (va, fa, vb, fb)), ref["inliers"],
        n_samples=48, threshold_rad=0.05, min_inlier_ratio=0.5)
    c, n = epi.sampling_covariance(
        _t(ref["T_a_b"]), *map(_t, (va, fa, vb, fb)), _t(ref["inliers"]), 48,
        threshold_rad=0.05, min_inlier_ratio=0.5, noise=_t(_gumbel(kc, (48, 120))))
    assert int(n) == int(rn) and int(n) > 10
    rc = np.asarray(rc)
    np.testing.assert_allclose(c.numpy(), rc, rtol=0, atol=1e-6 * np.abs(rc).max())


def test_align_ransac_3d3d_matches_reference():
    rng = np.random.default_rng(10)
    p2 = rng.normal(size=(80, 3)) * 3
    T = _pose(rng, 0.3, 1.0)
    p1 = np.array(ref_geo.pose_apply(jnp.asarray(T)[None], jnp.asarray(p2)))
    p1 = p1 + 0.01 * rng.normal(size=p1.shape)
    p1[:15] += rng.normal(size=(15, 3)) * 2
    mask = rng.random(80) > 0.1
    key = jax.random.PRNGKey(11)
    ref = ref_align3d.align_ransac_3d3d(key, *map(jnp.asarray, (p1, p2, mask)),
                                        n_hypotheses=64, threshold=0.1)
    out = align3d.align_ransac_3d3d(*map(_t, (p1, p2, mask)), 64, 0.1,
                                    noise=_t(_gumbel(key, (64, 80))))
    assert int(out["n_inliers"]) == int(ref["n_inliers"]) >= 55
    np.testing.assert_array_equal(out["inliers"].numpy(), np.asarray(ref["inliers"]))
    np.testing.assert_allclose(out["T_12"].numpy(), np.asarray(ref["T_12"]), rtol=0,
                               atol=POSE_TOL)


@pytest.mark.parametrize("masks", ["random", "few", "none"])
def test_top5_sets_match_reference(masks):
    """The 5-point RANSAC's minimal sets (the top 5 of each noise row over
    the masked-in rays, ties to the lowest index; with fewer than five, the
    masked rays by index) against the reference's `sample_minimal_sets`
    under the same key, exactly."""
    from covins_tpu.ops import ransac as ref_ransac
    from covins_tpu_torch.ops import ransac

    rng = np.random.default_rng(11)
    N, H = 60, 40
    mask = {"random": rng.random(N) > 0.5, "few": np.arange(N) % 23 == 5,
            "none": np.zeros(N, bool)}[masks]
    key = jax.random.PRNGKey(12)
    ref = np.asarray(ref_ransac.sample_minimal_sets(key, jnp.asarray(mask), H, 5))
    got = ransac.sample_minimal_sets(_t(_gumbel(key, (H, N))), _t(mask), 5)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("case", ["few_masked", "all_masked", "duplicated"])
def test_central_5pt_degenerate_samples_match_reference(case):
    """Degenerate 5-point samples against the reference: a pair with 3 rays
    masked in (its sets take masked rays, as the reference's top_k does),
    a pair with none (every count 0, no inlier), and sets that repeat a ray
    (a nullspace of more than 4 dimensions: the reference's basis handed
    to both, the same validity exactly and every valid E to 1e-7)."""
    rng = np.random.default_rng(13)
    N, H = 60, 24
    fa, fb, _ = _central(rng, n=N, n_out=10)
    if case == "duplicated":
        idx = np.stack([rng.choice(N, 4, replace=False) for _ in range(H)])
        idx = np.concatenate([idx, idx[:, :1]], axis=1)  # ray 0 twice
        a, b = fa[idx], fb[idx]

        def ref_basis(x, y):
            A = (x[:, :, None] * y[:, None, :]).reshape(5, 9)
            return ref_la.jacobi_eigh(A.T @ A)[1]

        V = jax.jit(jax.vmap(ref_basis))(jnp.asarray(a), jnp.asarray(b))
        rE, rvalid = jax.jit(jax.vmap(_ref_essential_5pt_from_basis))(
            jnp.asarray(a), jnp.asarray(b), V)
        rE, rvalid = np.asarray(rE), np.asarray(rvalid)
        E, valid = epi.essential_5pt_from_basis(
            _t(V)[..., :, :4].transpose(-1, -2).reshape(H, 4, 3, 3))
        np.testing.assert_array_equal(valid.numpy(), rvalid)
        assert rvalid.any()
        np.testing.assert_allclose(E.numpy()[rvalid], rE[rvalid], rtol=0, atol=1e-7)
        return
    mask = np.zeros(N, bool)
    if case == "few_masked":
        mask[[7, 30, 44]] = True
    key = jax.random.PRNGKey(14)
    ref = ref_epi.relative_pose_ransac_central_5pt(
        key, jnp.asarray(fa), jnp.asarray(fb), jnp.asarray(mask), n_hypotheses=H,
        threshold_rad=0.002)
    noise = _t(_gumbel(key, (H, N)))
    out = epi.relative_pose_ransac_central_5pt_plain(
        _t(fa)[None], _t(fb)[None], _t(mask)[None], H, 0.002, noise=noise[None])
    assert int(out["n_inliers"][0]) == int(ref["n_inliers"])
    np.testing.assert_array_equal(out["inliers"][0].numpy(), np.asarray(ref["inliers"]))
    if case == "all_masked":
        assert int(out["counts"].max()) == 0 and not bool(out["inliers"].any())
    else:
        assert 0 < int(out["n_inliers"][0]) <= 3


def test_relpose_ransac_5pt_takes_the_plain_version_on_the_cpu():
    """On CPU tensors the 5-point RANSAC's wrapper is its plain version
    (nothing launches), from noise and from given sets, and the public
    RANSAC returns its best pose, inliers and count."""
    rng = np.random.default_rng(15)
    B, N, H = 2, 50, 6
    scenes = [_central(rng, n=N, n_out=8) for _ in range(B)]
    fa = _t(np.stack([s[0] for s in scenes]))
    fb = _t(np.stack([s[1] for s in scenes]))
    mask = _t(rng.random((B, N)) > 0.2)
    noise = _t(rng.gumbel(size=(B, H + 2, N)))
    idx = torch.from_numpy(np.stack([np.stack([rng.choice(N, 5, replace=False)
                                               for _ in range(H)]) for _ in range(B)]))
    before = epi.relpose_ransac_5pt.launches
    for sets in (dict(noise=noise), dict(idx=idx)):
        got = epi.relpose_ransac_5pt(fa, fb, mask, H, 0.004, **sets)
        plain = epi.relative_pose_ransac_central_5pt_plain(fa, fb, mask, H, 0.004, **sets)
        assert set(got) == {"T_a_b", "inliers", "n_inliers", "T", "valid", "counts", "best"}
        for k in plain:
            assert torch.equal(got[k].nan_to_num(7.0), plain[k].nan_to_num(7.0)), k
        assert got["T"].shape == (B, 40 * H, 7) and got["valid"].shape == (B, 40 * H)
        public = epi.relative_pose_ransac_central_5pt(fa, fb, mask, H, 0.004, **sets)
        assert set(public) == {"T_a_b", "inliers", "n_inliers"}
        for k in public:
            assert torch.equal(public[k], got[k]), k
    assert epi.relpose_ransac_5pt.launches == before
