"""Port's landmark ops (kernel K2's plain versions: the descriptors alone
and the whole attribute refresh from one packed buffer) and BoW vectors
(kernel K3's plain version) against the JAX package.

Tolerances: representative descriptors exactly (integer selection);
normals and distance ranges to 1e-12 in float64 (reductions in another
order); BoW vectors and database rows exactly, since both packages
compute count / sqrt(float32 sum of integer squares).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from covins_tpu.ops import bow as ref_bow
from covins_tpu.ops import landmark_ops as ref_lm
from covins_tpu_torch.ops import bow, landmark_ops
from covins_tpu_torch.utils.synthetic import refresh_scene


def _cohort(seed, L=300, P=16):
    rng = np.random.default_rng(seed)
    d = rng.integers(0, 256, (L, P, 32), dtype=np.uint8)
    d[:, 4] = d[:, 1]  # duplicate observations: tied medians
    d[:, 9] = d[:, 1]
    mask = rng.random((L, P)) > 0.5
    mask[0] = False  # no valid observation -> row 0
    mask[1] = False
    mask[1, 7] = True  # one valid observation
    mask[2] = False
    mask[2, [3, 11]] = True  # two
    mask[3] = True  # all sixteen
    return d, mask


def test_representative_descriptors_match_reference():
    for seed in (0, 1):
        d, mask = _cohort(seed)
        ref = np.asarray(ref_lm.representative_descriptors(jnp.asarray(d),
                                                           jnp.asarray(mask)))
        got = landmark_ops.representative_descriptors(torch.from_numpy(d),
                                                      torch.from_numpy(mask))
        np.testing.assert_array_equal(got.numpy(), ref)
        assert (got[0].numpy() == d[0, 0]).all()
        assert (got[1].numpy() == d[1, 7]).all()


def test_normals_and_distance_invariance_match_reference():
    rng = np.random.default_rng(2)
    L, P = 300, 16
    _, mask = _cohort(2, L, P)
    pos = rng.normal(size=(L, 3)) * 5
    centers = rng.normal(size=(L, P, 3)) * 5
    octaves = rng.integers(0, 8, (L, P)).astype(np.float64)
    ref_n = np.asarray(ref_lm.landmark_normals(
        jnp.asarray(pos), jnp.asarray(centers), jnp.asarray(mask, jnp.float64)))
    ref_r = np.asarray(ref_lm.distance_invariance(
        jnp.asarray(pos), jnp.asarray(centers), jnp.asarray(octaves),
        jnp.asarray(mask)))
    t = torch.from_numpy
    got_n = landmark_ops.landmark_normals(t(pos), t(centers), t(mask).double())
    got_r = landmark_ops.distance_invariance(t(pos), t(centers), t(octaves),
                                             t(mask))
    assert got_n.dtype == torch.float64 and got_r.dtype == torch.float64
    np.testing.assert_allclose(got_n.numpy(), ref_n, rtol=0, atol=1e-12)
    np.testing.assert_allclose(got_r.numpy(), ref_r, rtol=0, atol=1e-12)
    assert (got_r.numpy()[0] == 0).all()  # no observation: (0, 0)


@pytest.mark.parametrize("seed,L,P", [(0, 300, 16), (1, 37, 1), (2, 65, 32), (3, 4, 7)])
def test_attribute_refresh_matches_reference(seed, L, P):
    pos, centers, octaves, d, mask = refresh_scene(np.random.default_rng(seed), L, P)
    packed = landmark_ops.pack_refresh(pos, centers, octaves, d, mask)
    for view, x in zip(landmark_ops.refresh_views(packed, L, P),
                       (pos, centers, octaves, d, mask)):
        np.testing.assert_array_equal(view.numpy(), x)
    out = landmark_ops.landmark_attributes(packed, L, P)
    assert out.shape == (72 * L,) and out.dtype == torch.uint8
    rep, nrm, rng_ = landmark_ops.unpack_attributes(out.numpy(), L)
    ref_d = np.asarray(ref_lm.representative_descriptors(jnp.asarray(d), jnp.asarray(mask)))
    ref_n = np.asarray(ref_lm.landmark_normals(
        jnp.asarray(pos), jnp.asarray(centers), jnp.asarray(mask, jnp.float64)))
    ref_r = np.asarray(ref_lm.distance_invariance(
        jnp.asarray(pos), jnp.asarray(centers), jnp.asarray(octaves), jnp.asarray(mask)))
    np.testing.assert_array_equal(rep, ref_d)
    np.testing.assert_allclose(nrm, ref_n, rtol=0, atol=1e-12)
    np.testing.assert_allclose(rng_, ref_r, rtol=0, atol=1e-12)
    assert (rng_[0] == 0).all() and (nrm[0] == 0).all()  # no observation
    # the port's three public functions give the same
    t = torch.from_numpy
    np.testing.assert_array_equal(
        rep, landmark_ops.representative_descriptors(t(d), t(mask)).numpy())
    np.testing.assert_allclose(nrm, landmark_ops.landmark_normals(
        t(pos), t(centers), t(mask).double()).numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(rng_, landmark_ops.distance_invariance(
        t(pos), t(centers), t(octaves), t(mask)).numpy(), rtol=0, atol=1e-12)


def test_bow_insert_matches_reference_vectors_and_scatter():
    rng = np.random.default_rng(3)
    W, F, V, cap = 12, 200, 64, 16
    words = rng.integers(-1, V, (W, F)).astype(np.int32)
    words[4] = -1  # empty row -> zero vector
    dest = np.arange(W, dtype=np.int64)
    dest[2] = cap  # dropped, as mode="drop" drops it
    ref_vecs = np.asarray(ref_bow.bow_vectors_batch(jnp.asarray(words), V))
    ref_db = np.asarray(jnp.zeros((cap, V), jnp.float32).at[
        jnp.asarray(dest)].set(ref_vecs, mode="drop"))
    db = torch.zeros((cap, V))
    vecs = bow.bow_insert(torch.from_numpy(words), torch.from_numpy(dest), db)
    np.testing.assert_array_equal(vecs.numpy(), ref_vecs)
    np.testing.assert_array_equal(db.numpy(), ref_db)
    assert (vecs[4] == 0).all()
    single = bow.bow_vector(torch.from_numpy(words[0]), V)
    np.testing.assert_array_equal(
        single.numpy(), np.asarray(ref_bow.bow_vector(jnp.asarray(words[0]), V)))
