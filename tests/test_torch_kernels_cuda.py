"""The three CUDA kernels against their plain versions, on the card.

These tests need a CUDA card and the CUDA toolkit (the kernels are built
with nvcc at first use); without a card they skip.  On the machine with the
card, from the root of a checkout:

    python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py

(``--noconftest``: the suite's conftest imports JAX, which that machine
does not have; this file imports neither JAX nor the JAX package.)

The shapes are small and ragged on purpose: row and column counts that do
not fill a block or a shared-memory tile, a single row, P = 1 and P = 32,
and a vocabulary large enough for the dynamic shared-memory path of K3.
Tolerances: K1 and K2 exactly (integer results); K3's word counts exactly
and its vectors bit for bit (integer counts, IEEE sqrt and division).
"""

import numpy as np
import pytest
import torch

from covins_tpu_torch.ops import bow, descriptors, landmark_ops


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _desc(rng, *shape):
    return rng.integers(0, 256, shape + (32,), dtype=np.uint8)


@pytest.mark.parametrize("m,n", [(1, 1), (63, 257), (130, 512), (700, 1000)])
def test_hamming_argmin_matches_plain(dev, m, n):
    rng = np.random.default_rng(m * 7 + n)
    a, b = _desc(rng, m), _desc(rng, n)
    if n > 3:
        b[n - 1] = b[2]  # a tie across tiles: the lower index wins
        a[0] = b[2]
    mask = rng.random(m) > 0.3
    ta, tb, tm = (torch.from_numpy(x).to(dev) for x in (a, b, mask))
    before = descriptors.hamming_argmin.launches
    idx, dmin, dist = descriptors.hamming_argmin(ta, tb, tm, want_dist=True)
    assert descriptors.hamming_argmin.launches == before + 1
    ridx, rdmin, rdist = descriptors.hamming_argmin_plain(ta, tb, tm,
                                                          want_dist=True)
    assert torch.equal(dist, rdist)
    assert torch.equal(dist.cpu(), descriptors.hamming_distance_xor(
        torch.from_numpy(a), torch.from_numpy(b)))
    assert torch.equal(dmin, rdmin) and torch.equal(idx, ridx)
    idx2, dmin2 = descriptors.hamming_argmin(ta, tb)  # no row mask
    ridx2, _ = descriptors.hamming_argmin_plain(ta, tb)
    assert torch.equal(idx2, ridx2) and torch.equal(dmin2, rdmin)
    if n > 3 and mask[0]:
        assert int(idx[0]) == 2


def test_hamming_argmin_refuses_bad_inputs(dev):
    a = torch.zeros((8, 32), dtype=torch.uint8, device=dev)
    shifted = torch.zeros(8 * 32 + 8, dtype=torch.uint8, device=dev)[8:]
    with pytest.raises(ValueError):
        descriptors.hamming_argmin(a[:, :16].contiguous(), a)  # not 32 bytes
    with pytest.raises(ValueError):
        descriptors.hamming_argmin(shifted.view(8, 32), a)  # not 16-byte aligned
    with pytest.raises(ValueError):
        descriptors.hamming_argmin(a, a, torch.ones(8, device=dev))
    with pytest.raises(RuntimeError):
        descriptors.hamming_argmin(a, a.cpu())


@pytest.mark.parametrize("L,P", [(1, 1), (37, 7), (300, 16), (65, 32)])
def test_representative_descriptors_match_plain(dev, L, P):
    rng = np.random.default_rng(L + P)
    d = _desc(rng, L, P)
    if P > 3:
        d[:, 3] = d[:, 1]  # duplicate observations: tied medians
    mask = rng.random((L, P)) > 0.4
    mask[0] = False  # no valid observation: row 0
    for i, nv in enumerate((1, 2, P), start=1):
        if i < L:
            mask[i] = False
            mask[i, :nv] = True
    td, tm = torch.from_numpy(d).to(dev), torch.from_numpy(mask).to(dev)
    before = landmark_ops.representative_descriptors.launches
    got = landmark_ops.representative_descriptors(td, tm)
    assert landmark_ops.representative_descriptors.launches == before + 1
    assert torch.equal(got, landmark_ops.representative_descriptors_plain(td, tm))
    assert torch.equal(got.cpu(), landmark_ops.representative_descriptors(
        torch.from_numpy(d), torch.from_numpy(mask)))


@pytest.mark.parametrize("W,F,V,cap", [(1, 1, 5, 1), (19, 300, 37, 8),
                                       (64, 1024, 512, 128),
                                       (3, 2000, 16384, 4)])
def test_bow_insert_matches_plain(dev, W, F, V, cap):
    rng = np.random.default_rng(W + F + V)
    words = rng.integers(-1, V, (W, F)).astype(np.int32)
    words[0, : F // 2] = V  # out of range: invalid, as -1 is
    if W > 2:
        words[2] = -1  # empty row: zero vector
    dest = rng.permutation(max(cap, W))[:W].astype(np.int64)
    dest[-1] = -1 if W > 1 else cap  # dropped
    tw, td = torch.from_numpy(words).to(dev), torch.from_numpy(dest).to(dev)
    db_k = torch.full((cap, V), 7.0, device=dev)
    db_p = db_k.clone()
    before = bow.bow_insert.launches
    vecs = bow.bow_insert(tw, td, db_k)
    assert bow.bow_insert.launches == before + 1
    ref = bow.bow_insert_plain(tw, td, db_p)
    valid = (words >= 0) & (words < V)
    counts = np.zeros((W, V), np.float32)
    np.add.at(counts, (np.nonzero(valid)[0], words[valid]), 1.0)
    norm = np.maximum(np.sqrt((counts * counts).sum(1)), 1e-12)[:, None]
    assert np.array_equal(np.rint(vecs.cpu().numpy() * norm), counts)
    assert torch.equal(vecs, ref)
    assert torch.equal(db_k, db_p)


def test_bow_insert_refuses_bad_inputs(dev):
    words = torch.zeros((2, 4), dtype=torch.int32, device=dev)
    db = torch.zeros((4, 8), device=dev)
    with pytest.raises(ValueError):
        bow.bow_insert(words, torch.zeros(2, dtype=torch.int32, device=dev), db)
    with pytest.raises(ValueError):
        bow.bow_insert(words, torch.zeros(2, dtype=torch.int64, device=dev),
                       db.double())
