"""Port's Hamming ops (the plain versions of kernels K1 and K11) and the
matchers on a distance matrix against the JAX package.

Hamming distances are integers and the ratio gate is float32 in both
packages, so every comparison here is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from covins_tpu.ops import bow as ref_bow
from covins_tpu.ops import descriptors as ref_desc
from covins_tpu_torch import device as dev_mod
from covins_tpu_torch.ops import bow, descriptors


def _inputs(seed, m=400, n=96):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, (m, 32), dtype=np.uint8)
    b = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    b[17] = b[5]  # duplicate vocabulary rows: exact ties
    b[60] = b[5]
    a[:20] = b[5]  # queries sitting on the tied word
    a[20:30] = b[70] ^ np.uint8(1)  # near-ties one bit away
    mask = rng.random(m) > 0.25
    return a, b, mask


@pytest.mark.parametrize("seed", [0, 1])
def test_hamming_argmin_matches_reference(seed):
    a, b, mask = _inputs(seed)
    d_ref = ref_desc.hamming_distance_best(jnp.asarray(a), jnp.asarray(b))
    idx_ref = np.asarray(jnp.argmin(d_ref, axis=1))
    dmin_ref = np.asarray(jnp.min(d_ref, axis=1))
    idx, dmin, dist = descriptors.hamming_argmin(
        torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(mask),
        want_dist=True)
    np.testing.assert_array_equal(dist.numpy(), np.asarray(d_ref))
    np.testing.assert_array_equal(dmin.numpy(), dmin_ref)
    np.testing.assert_array_equal(idx.numpy(), np.where(mask, idx_ref, -1))
    assert (idx.numpy()[:20][mask[:20]] == 5).all()  # lowest index wins ties
    assert idx.dtype == torch.int32 and dmin.dtype == torch.int32


def test_hamming_distance_and_xor_oracle_match_reference():
    a, b, _ = _inputs(2, m=150)
    ref = np.asarray(ref_desc.hamming_distance(jnp.asarray(a), jnp.asarray(b)))
    ref_xor = np.asarray(ref_desc.hamming_distance_xor(jnp.asarray(a),
                                                       jnp.asarray(b)))
    np.testing.assert_array_equal(
        descriptors.hamming_distance(torch.from_numpy(a),
                                     torch.from_numpy(b)).numpy(), ref)
    np.testing.assert_array_equal(
        descriptors.hamming_distance_xor(torch.from_numpy(a),
                                         torch.from_numpy(b), chunk=64).numpy(),
        ref_xor)


def test_assign_words_matches_reference():
    a, b, mask = _inputs(3)
    ref = np.asarray(ref_bow.assign_words(jnp.asarray(a), jnp.asarray(b),
                                          mask=jnp.asarray(mask)))
    got = bow.assign_words(torch.from_numpy(a), torch.from_numpy(b),
                           torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_kmedians_matches_reference_from_same_initial_centres():
    import jax

    rng = np.random.default_rng(4)
    descs = rng.integers(0, 256, (500, 32), dtype=np.uint8)
    k, iters, seed = 24, 3, 5
    # the reference draws its initial centres with jax.random; hand the
    # same draw to the port's refinement
    init = np.asarray(jax.random.choice(jax.random.PRNGKey(seed), 500, (k,),
                                        replace=False))
    ref = np.asarray(ref_bow.train_vocabulary(jnp.asarray(descs), k=k,
                                              iters=iters, seed=seed))
    got = bow.kmedians(torch.from_numpy(descs), torch.from_numpy(descs[init]),
                       iters)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_train_vocabulary_is_seeded_and_shaped():
    rng = np.random.default_rng(6)
    descs = torch.from_numpy(rng.integers(0, 256, (300, 32), dtype=np.uint8))
    v1 = bow.train_vocabulary(descs, k=16, iters=2,
                              generator=torch.Generator().manual_seed(3))
    v2 = bow.train_vocabulary(descs, k=16, iters=2,
                              generator=torch.Generator().manual_seed(3))
    assert v1.shape == (16, 32) and v1.dtype == torch.uint8
    assert torch.equal(v1, v2)


def test_wrappers_refuse_other_devices():
    a = torch.zeros((4, 32), dtype=torch.uint8, device="meta")
    with pytest.raises(RuntimeError, match="CUDA"):
        descriptors.hamming_argmin(a, a)


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dev_mod.resolve_device(None)
    assert dev_mod.resolve_device("cpu") == torch.device("cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False


def _flip(x, bits):
    y = x.copy()
    for b in bits:
        y[b // 8] ^= np.uint8(1 << (b % 8))
    return y


def _ratio_inputs(case, m=48, seg=40, n_seg=3, seed=7):
    """Descriptors for the segment ratio match with the case's edge:
    ties inside a segment and across segments, masked rows and columns,
    a segment with one valid column (no second neighbour), every column of
    a segment masked, and d1 exactly at ratio * d2 (8 against 10 and 4
    against 5: f32(0.8) * d2 rounds to d1, so the float32 gate rejects
    what a float64 gate would accept)."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, (m, 32), dtype=np.uint8)
    b = rng.integers(0, 256, (seg * n_seg, 32), dtype=np.uint8)
    amask = np.ones(m, bool)
    bmask = np.ones(seg * n_seg, bool)
    perm = rng.permutation(256)
    for r in range(12):  # close matches so that some pass the gates
        b[(r * 7) % (seg * n_seg)] = _flip(a[r], perm[:r % 6])
    if case == "ties":
        b[seg + 7] = b[seg + 3]
        b[2 * seg + 1] = b[seg + 3]
        a[:6] = b[seg + 3]
        b[seg + 20] = _flip(b[seg + 3], perm[:2])  # a second neighbour at 2
    elif case == "masked":
        amask[rng.random(m) < 0.3] = False
        bmask[rng.random(seg * n_seg) < 0.3] = False
        bmask[2 * seg:] = False  # a whole segment masked
    elif case == "one_valid_column":
        bmask[seg:2 * seg] = False
        bmask[seg + 11] = True
        b[seg + 11] = _flip(a[3], perm[:5])
    elif case == "ratio_edge":
        for r, (d1, d2) in enumerate(((8, 10), (4, 5), (7, 10), (0, 1))):
            base = 2 * seg + 4 * r
            b[base] = _flip(a[20 + r], perm[:d1])
            b[base + 1] = _flip(a[20 + r], perm[100:100 + d2])
    return a, amask, b, bmask, seg


@pytest.mark.parametrize("case", ["ties", "masked", "one_valid_column", "ratio_edge"])
def test_ratio_match_matches_reference(case):
    a, amask, b, bmask, seg = _ratio_inputs(case)
    max_dist, ratio = 40.0, 0.8
    dist = ref_desc.masked_dist(
        ref_desc.hamming_distance_best(jnp.asarray(a), jnp.asarray(b)),
        jnp.asarray(amask), jnp.asarray(bmask))
    np.testing.assert_array_equal(
        descriptors.masked_dist(descriptors.hamming_distance_best(
            torch.from_numpy(a), torch.from_numpy(b)), torch.from_numpy(amask),
            torch.from_numpy(bmask)).numpy(), np.asarray(dist))
    idx, d1, d2 = descriptors.hamming_ratio_match(
        torch.from_numpy(a), torch.from_numpy(amask), torch.from_numpy(b),
        torch.from_numpy(bmask), seg, max_dist, ratio)
    assert idx.shape == (a.shape[0], b.shape[0] // seg) and idx.dtype == torch.int32
    for j in range(b.shape[0] // seg):
        block = dist[:, j * seg:(j + 1) * seg]
        ri, r1, r2 = ref_desc.knn2(block)
        np.testing.assert_array_equal(d1[:, j].numpy(), np.asarray(r1))
        np.testing.assert_array_equal(d2[:, j].numpy(), np.asarray(r2))
        ref = np.asarray(ref_desc.match_ratio(block, max_dist, ratio))
        np.testing.assert_array_equal(idx[:, j].numpy(), ref)
        tb = torch.from_numpy(np.array(block))
        np.testing.assert_array_equal(
            descriptors.match_ratio(tb, max_dist, ratio).numpy(), ref)
        ki, _, _ = descriptors.knn2(tb)
        np.testing.assert_array_equal(ki.numpy(), np.asarray(ri))
        if case == "ties" and j == 1:
            # the lowest tied column; a tie fails the ratio test
            assert (ki[:6].numpy() == 3).all() and (idx[:6, 1].numpy() == -1).all()
    if case == "ratio_edge":
        # 8 vs 10 and 4 vs 5 fail in float32, 7 vs 10 and 0 vs 1 pass
        assert idx[20:24, 2].tolist() == [-1, -1, 8, 12]
    if case == "one_valid_column":
        assert d2[3, 1] == 2**30 and idx[3, 1] == 11
    if case == "masked":
        assert (idx[~amask].numpy() == -1).all() and (d1[~amask].numpy() == 2**30).all()


@pytest.mark.parametrize("dtype", ["int32", "float32"])
def test_mutual_nn_ratio_matches_reference(dtype):
    rng = np.random.default_rng(8)
    if dtype == "int32":
        d = rng.integers(0, 60, (50, 70)).astype(np.int32)
        d[:, 40] = d[:, 10]  # column ties
        d[5] = d[6]  # row ties
    else:
        d = (rng.random((50, 70)) * 50).astype(np.float32)
    for fn in ("match_mutual_nn_ratio", "match_mutual_nn", "match_ratio"):
        args = (30.0, 0.8) if "ratio" in fn else (30.0,)
        ref = np.asarray(getattr(ref_desc, fn)(jnp.asarray(d), *args))
        got = getattr(descriptors, fn)(torch.from_numpy(d), *args)
        np.testing.assert_array_equal(got.numpy(), ref)
