"""The seven CUDA kernels against their plain versions, on the card.

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
and its vectors bit for bit (integer counts, IEEE sqrt and division); K4
exactly; K5's matches and distances exactly (its float64 gates are built
without FMA contraction, as the plain version's separate operations
round); K6's counts, best pose and inlier mask exactly, except for a
correspondence within 1e-12 rad of the threshold; K7 to 1e-12 relative
and bit for bit between two launches.
"""

import numpy as np
import pytest
import torch

from covins_tpu_torch.ops import bow, descriptors, landmark_ops, pgo, pnp, projmatch


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


@pytest.mark.parametrize("m,n", [(1, 1), (5, 70), (300, 129), (1024, 1024)])
def test_hamming_mutual_nn_matches_plain(dev, m, n):
    rng = np.random.default_rng(m + 3 * n)
    a, b = _desc(rng, m), _desc(rng, n)
    k = min(m, n)
    a[: k // 2] = b[: k // 2]  # mutual pairs at distance 0
    if n > 4:
        b[n - 1] = b[0]  # a tied column: the lower index wins
    am, bm = rng.random(m) > 0.2, rng.random(n) > 0.2
    ta, tb, tam, tbm = (torch.from_numpy(x).to(dev) for x in (a, b, am, bm))
    before = descriptors.hamming_mutual_nn.launches
    got = descriptors.hamming_mutual_nn(ta, tam, tb, tbm, 50.0)
    assert descriptors.hamming_mutual_nn.launches == before + 1
    ref = descriptors.hamming_mutual_nn_plain(ta, tam, tb, tbm, 50.0)
    assert torch.equal(got, ref)
    cpu = descriptors.hamming_mutual_nn(*(torch.from_numpy(x) for x in (a, am, b, bm)),
                                        50.0)
    assert torch.equal(got.cpu(), cpu)


def _gated_inputs(rng, L, F, dev):
    uv = rng.uniform(0, 100, (L, 2))
    kp_uv = rng.uniform(0, 100, (F, 2))
    kp_uv[: min(L, F)] = uv[: min(L, F)] + rng.normal(scale=2.0, size=(min(L, F), 2))
    kp_uv[F // 2:] = kp_uv[: F - F // 2]  # duplicated features: ties in f
    lm_desc, kp_desc = _desc(rng, L), _desc(rng, F)
    kp_desc[: min(L, F)] = lm_desc[: min(L, F)]
    lm_desc[L // 3:] = lm_desc[: L - L // 3]  # duplicated landmarks: conflicts
    kp_oct = rng.integers(0, 4, F).astype(np.float64)
    arrays = (uv, rng.random(L) > 0.1, rng.integers(0, 5, L).astype(np.float64),
              rng.random(L) > 0.5, lm_desc, kp_uv, kp_oct, 4.0 * 2.0 ** kp_oct,
              rng.random(F) > 0.1, kp_desc)
    return [torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in arrays]


@pytest.mark.parametrize("L,F", [(1, 1), (37, 70), (1024, 1024), (3001, 257)])
def test_project_match_kernel_matches_plain(dev, L, F):
    rng = np.random.default_rng(L + F)
    args = _gated_inputs(rng, L, F, dev)
    before = projmatch.gated_match.launches
    feat, dist = projmatch.gated_match(*args, 50.0)
    assert projmatch.gated_match.launches == before + 1
    rfeat, rdist = projmatch.gated_match_plain(*args, 50.0)
    assert torch.equal(feat, rfeat)
    assert torch.equal(dist, rdist)
    assert int((feat >= 0).sum()) > 0 or L < 4


@pytest.mark.parametrize("H,N", [(1, 3), (37, 100), (1200, 1024)])
def test_p3p_score_kernel_matches_plain(dev, H, N):
    rng = np.random.default_rng(H + N)
    q = rng.normal(size=(H, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    T = np.concatenate([q, 0.1 * rng.normal(size=(H, 3))], 1)
    T[H // 2:] = T[: H - H // 2]  # tied counts: the first maximum wins
    P = rng.normal(size=(N, 3)) + [0, 0, 5]
    B = rng.normal(size=(N, 3)) + [0, 0, 3]
    B /= np.linalg.norm(B, axis=1, keepdims=True)
    args = [torch.from_numpy(x).to(dev) for x in
            (T, P, B, rng.random(N) > 0.1, rng.random(H) > 0.2)]
    before = pnp.p3p_score.launches
    counts, best, inl, n_inl = pnp.p3p_score(*args, 0.6)
    assert pnp.p3p_score.launches == before + 1
    rcounts, rbest, rinl, rn = pnp.p3p_score_plain(*args, 0.6)
    assert torch.equal(counts, rcounts)
    assert int(best) == int(rbest) and int(n_inl) == int(rn)
    assert torch.equal(inl, rinl)


@pytest.mark.parametrize("N,E", [(1, 1), (9, 20), (256, 1300)])
def test_pgo_matvec_kernel_matches_plain(dev, N, E):
    rng = np.random.default_rng(N + E)
    ei = rng.integers(0, N, E)
    ej = (ei + rng.integers(0, max(N, 1), E)) % N
    f64 = dict(dtype=torch.float64, device=dev)
    v = torch.tensor(rng.normal(size=(N, 6)), **f64)
    free = torch.tensor((rng.random(N) > 0.1).astype(np.float64), **f64)
    Ji = torch.tensor(rng.normal(size=(E, 6, 6)), **f64)
    Jj = torch.tensor(rng.normal(size=(E, 6, 6)), **f64)
    graph = pgo.matvec_graph(torch.tensor(ei, device=dev),
                             torch.tensor(ej, device=dev), N)
    before = pgo.matvec.launches
    out = pgo.matvec(v, free, Ji, Jj, graph, 1e-6)
    again = pgo.matvec(v, free, Ji, Jj, graph, 1e-6)
    assert pgo.matvec.launches == before + 2
    assert torch.equal(out, again)
    ref = pgo.matvec_plain(v, free, Ji, Jj, graph, 1e-6)
    rel = (out - ref).abs().max() / ref.abs().max()
    assert float(rel) <= 1e-12
